"""The benchmark's frozen arithmetic: the generators' rules and the bytes a
kernel or a step needs.

These are copies, frozen here so that a change to the program cannot
change the yardstick it is measured with.  ``tests/test_paxbench_frozen.py``
holds each one equal to the program's function it was copied from, at
small sizes:

- :func:`default_workload`: ``tpu_paxos_torch/core/sim.default_workload``;
- :func:`assign_window`: the JAX bench's rule for the general engine's
  first-fit window (``bench.py``'s ``bench_sim_record``);
- :func:`simkern_bytes_needed`: ``tpu_paxos_torch/core/simkern.bytes_needed``
  with the plain versions of both kernels it evaluates;
- :func:`fastwin_bytes_per_launch`: ``tpu_paxos_torch/core/fastwin.bytes_per_launch``;
- :func:`bump_past`: the ballot rule of ``core/ballot.bump_past`` (the
  reference's ``UpdateProposalID``, ``multi/paxos.cpp:792-799``) in
  Python integers.

Rooflines are stated against the published 3.35 TB/s of one H100 SXM's
HBM3; no kernel here is bound by operations.
"""

from __future__ import annotations

import numpy as np
import torch

#: Published HBM3 bandwidth of one NVIDIA H100 SXM (bytes/s).
HBM_BYTES_PER_S = 3.35e12

NONE = -1  # the vid and ballot sentinel: no value / no ballot
NODE_BITS = 16  # a ballot is (count << 16) | node


# ---------------------------------------------------------------- generators


def assign_window(n_instances: int) -> int:
    """The general engine's first-fit window: ``max(256, min(2^20, I // 8))``."""
    return max(256, min(1 << 20, n_instances // 8))


def default_workload(n_instances: int, n_proposers: int) -> list[np.ndarray]:
    """``n_instances // 2`` values, split round-robin over the proposers;
    proposer ``p``'s values are ``p * max(I, 1024) + seq``."""
    stride = max(n_instances, 1024)
    total = max(n_instances // 2, 1)
    counts = [total // n_proposers + (1 if pi < total % n_proposers else 0)
              for pi in range(n_proposers)]
    return [
        (pi * stride + np.arange(counts[pi], dtype=np.int64)).astype(np.int32)
        for pi in range(n_proposers)
    ]


def bump_past(count: int, node: int, max_seen: int) -> int:
    """The smallest ballot ``(c << 16) | node`` with ``c > count`` that
    exceeds ``max_seen``."""
    floor_count = max(count + 1, max_seen >> NODE_BITS)
    cand = (floor_count << NODE_BITS) | node
    new_count = floor_count if cand > max_seen else floor_count + 1
    return (new_count << NODE_BITS) | node


# ---------------------------------------------------------------- fast path


def fastwin_bytes_per_launch(a: int, i: int, iota_vids: bool) -> int:
    """One steady-state window launch: the three ``[A, I]`` int32 state
    arrays written once, the ``[I]`` vids read once unless made in the
    kernel, the scalars read and the count written."""
    return 3 * 4 * a * i + (0 if iota_vids else 4 * i) + 4 * (4 + a) + 4


def takeover_bytes(a: int, i: int) -> int:
    """One whole-log takeover (phase 1 with adoption over every instance,
    accept, learn): ``acc_ballot``, ``acc_vid`` and ``vids`` read once
    (8A + 4 bytes an instance), ``acc_ballot``, ``acc_vid`` and
    ``learned`` written once (12A).  104 bytes an instance at A = 5."""
    return i * (8 * a + 4) + i * 12 * a


# ---------------------------------------------------------------- simkern

SECTOR = 32  # bytes: the unit in which the card's memory moves data


def _store_accepts_plain(acc_ballot, acc_vid, learned, abat, abal, elig):
    is_comm = learned != NONE
    best_b = torch.full_like(acc_ballot, NONE)
    best_v = torch.full_like(acc_vid, NONE)
    for pi in range(abat.shape[-2]):
        batp = abat[..., pi, None, :]
        abal_p = abal[..., pi, None, None]
        store_ok = torch.where(is_comm, batp == learned, abal_p >= acc_ballot)
        ackp = elig[..., pi, :, None] & (batp != NONE) & store_ok
        candp = torch.where(ackp & ~is_comm, abal_p, torch.full_like(best_b, NONE))
        take = candp > best_b
        best_b = torch.where(take, candp, best_b)
        best_v = torch.where(take, batp.expand_as(best_v), best_v)
    do_store = best_b != NONE
    return (
        torch.where(do_store, best_b, acc_ballot),
        torch.where(do_store, best_v, acc_vid),
    )


def _accum_acks_plain(acks, cur_batch, acc_ballot, acc_vid, learned, ballot, amatch_pa):
    hold = (acc_vid[..., None, :, :] == cur_batch[..., :, None, :]) & (
        acc_ballot[..., None, :, :] == ballot[..., :, None, None]
    )
    comm = (learned[..., None, :, :] == cur_batch[..., :, None, :]) & (
        learned[..., None, :, :] != NONE
    )
    new = (
        amatch_pa[..., :, :, None]
        & (cur_batch != NONE)[..., :, None, :]
        & (hold | comm)
    ).to(torch.int8)
    return acks | new


def _sector_bytes(mask: torch.Tensor, elem_bytes: int) -> int:
    per = SECTOR // elem_bytes
    flat = mask.reshape(-1)
    pad = -flat.numel() % per
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return int(flat.view(-1, per).any(dim=1).sum()) * SECTOR


def _all_sectors(t: torch.Tensor) -> int:
    return -(-t.numel() * t.element_size() // SECTOR) * SECTOR


def simkern_bytes_needed(kernel: str, *operands) -> int:
    """Bytes one ``simkern`` launch on these operands (as given to the
    kernel, before it updates them) needs at the least: the 32-byte
    sectors holding an element it must read, or one it must change, plus
    the scalars.  ``kernel`` is ``store_accepts`` or ``accum_acks``."""
    if kernel == "store_accepts":
        acc_ballot, acc_vid, learned, abat, abal, elig = operands
        has = elig[..., None] & (abat != NONE)[..., None, :]
        need = has.any(dim=-3)
        new_b, new_v = _store_accepts_plain(acc_ballot, acc_vid, learned, abat, abal, elig)
        return (
            _sector_bytes(need, 4)
            + _sector_bytes(need & (learned == NONE), 4)
            + _sector_bytes(elig.any(dim=-1)[..., None].expand_as(abat), 4)
            + _sector_bytes(new_b != acc_ballot, 4)
            + _sector_bytes(new_v != acc_vid, 4)
            + 4 * abal.numel() + elig.numel()
        )
    if kernel == "accum_acks":
        acks, cur_batch, acc_ballot, acc_vid, learned, ballot, amatch_pa = operands
        live = cur_batch != NONE
        unacked = (acks & 1) == 0
        need = (amatch_pa[..., None] & live[..., None, :] & unacked).any(dim=-3)
        new = _accum_acks_plain(acks, cur_batch, acc_ballot, acc_vid, learned, ballot, amatch_pa)
        return (
            3 * _sector_bytes(need, 4)
            + _all_sectors(cur_batch)
            + _all_sectors(acks)
            + _sector_bytes(new != acks, 1)
            + _all_sectors(cur_batch)
            + 4 * ballot.numel() + amatch_pa.numel()
        )
    raise ValueError(kernel)
