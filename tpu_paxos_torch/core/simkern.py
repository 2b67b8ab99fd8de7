"""The general engine's two hottest event blocks as CUDA kernels for
Hopper, with their plain PyTorch versions (port of
``tpu_paxos/core/simkern.py``).

- ``store_accepts`` replaces ``tpu_paxos/core/simkern.py::store_accepts``
  (Pallas ``_store_kernel``): per (a, i) the max-ballot eligible
  incoming accept across proposers is stored in place (ref
  multi/paxos.cpp:1359-1397 OnAccept, with the safe-acceptor deviation
  documented in core/sim.py).
- ``accum_acks`` replaces ``tpu_paxos/core/simkern.py::accum_acks``
  (Pallas ``_ack_kernel``): per (p, a, i) an accept reply is certified
  by store-or-match against the acceptor's state and folded into the
  int8 ack cube in place, with the per-instance ack count written in
  the same pass (ref multi/paxos.cpp:1407-1444 OnAcceptReply).

Both are bound by device-memory bytes; the source,
``tpu_paxos_torch/csrc/simkern.cu``, says what its design does about
that.  :func:`bytes_per_launch` counts the bytes of dense operands,
:func:`bytes_needed` the bytes that given operands need (a real round's
instances mostly carry no batch).  ``utils/kbuild.py`` compiles the
source at first use into a shared library with a plain C interface and
loads it with ``ctypes``.

Three functions per kernel:

- ``*_plain``: the plain PyTorch version (the JAX package's jnp
  formulation), functional, any device;
- ``*_cuda``: the kernel wrapper — checks device, dtype, shape and
  contiguity loudly, launches on the current stream, checks the launch
  error, counts the launch in :data:`LAUNCHES` (or, in a mesh rank's
  thread, in the rank's own counts: :func:`counting`); raises on CPU
  tensors;
- ``store_accepts`` / ``accum_acks``: pick the plain version for CPU
  tensors and the kernel for CUDA tensors.  A failed build or launch
  raises; nothing falls back to the plain version.

The last two have one contract on every device: they update
``acc_ballot``/``acc_vid`` (store) and ``acks`` (ack fold) in place and
return those same tensors, as the kernels do.  On the CPU the plain
version's result is written back into the inputs, so a caller that
reuses a state after a round sees the same thing on both devices.

Every operand may carry a leading lane axis (a fleet's ``L``
simulations, ``[L, A, I]``, ``[L, P]``, ...); the kernels then cover
every lane in one launch, and the plain versions compute each lane as
they compute one.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from tpu_paxos_torch.core import ballot as bal
from tpu_paxos_torch.core import values as val
from tpu_paxos_torch.utils import counters, kbuild

NAME = "simkern"

#: Kernel launches since the last :func:`reset_counts`, by kernel name.
LAUNCHES = {"store_accepts": 0, "accum_acks": 0}


_LOCAL = threading.local()


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def counting(counts: dict):
    """Launches this thread makes within the block go to ``counts`` (a
    mesh rank's own dict, ``parallel/mesh.Mesh.run``, or the audit's), not
    to :data:`LAUNCHES`: ranks running at once share no counter.  A mesh
    run started within the block adds its ranks' launches to ``counts``
    when it ends."""
    prev = getattr(_LOCAL, "counts", None)
    _LOCAL.counts = counts
    try:
        yield counts
    finally:
        _LOCAL.counts = prev


def held_counts() -> dict | None:
    """The ``counts`` of this thread's :func:`counting` block, or None."""
    return getattr(_LOCAL, "counts", None)


def _count(name: str) -> None:
    counts = held_counts()
    (LAUNCHES if counts is None else counts)[name] += 1


def load():
    """Build the kernels if needed and load them (once per process)."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return kbuild.load(NAME, {
        "simkern_store_accepts": ([vp] * 6 + [i32, i32, i32, i64, vp], i32),
        "simkern_accum_acks": ([vp] * 8 + [i32, i32, i32, i64, vp], i32),
    })


def _lanes(t: torch.Tensor, ndim: int):
    """``(lead, lanes)``: a leading lane axis if ``t`` has one more axis
    than an unbatched operand (``ndim``), and the lane count (1 without)."""
    lead = tuple(t.shape[:1]) if t.ndim == ndim + 1 else ()
    return lead, (lead[0] if lead else 1)


# ---------------------------------------------------------------- plain


def store_accepts_plain(acc_ballot, acc_vid, learned, abat, abal, elig):
    """The jnp block of ``tpu_paxos/core/sim.py``'s ``_store_accepts``
    in PyTorch: proposers unrolled into a running masked max over
    [A, I] (ballots are unique per proposer, so the max never ties).
    Any leading lane axes: ``[..., A, I]``, ``[..., P, I]``, ``[..., P]``,
    ``[..., P, A]``."""
    is_comm = learned != val.NONE
    best_b = torch.full_like(acc_ballot, bal.NONE)
    best_v = torch.full_like(acc_vid, val.NONE)
    for pi in range(abat.shape[-2]):
        batp = abat[..., pi, None, :]  # [..., 1, I]
        abal_p = abal[..., pi, None, None]  # [..., 1, 1]
        store_ok = torch.where(is_comm, batp == learned, abal_p >= acc_ballot)
        ackp = elig[..., pi, :, None] & (batp != val.NONE) & store_ok
        candp = torch.where(ackp & ~is_comm, abal_p, torch.full_like(best_b, bal.NONE))
        take = candp > best_b
        best_b = torch.where(take, candp, best_b)
        best_v = torch.where(take, batp.expand_as(best_v), best_v)
    do_store = best_b != bal.NONE
    return (
        torch.where(do_store, best_b, acc_ballot),
        torch.where(do_store, best_v, acc_vid),
    )


def accum_acks_plain(acks, cur_batch, acc_ballot, acc_vid, learned, ballot, amatch_pa):
    """The ack-accumulation head of ``tpu_paxos/core/sim.py``'s
    ``_accum_acks`` in PyTorch: returns (acks', n_ack [..., P, I] int32).
    Any leading lane axes: ``acks [..., P, A, I]``."""
    hold = (acc_vid[..., None, :, :] == cur_batch[..., :, None, :]) & (
        acc_ballot[..., None, :, :] == ballot[..., :, None, None]
    )
    comm = (learned[..., None, :, :] == cur_batch[..., :, None, :]) & (
        learned[..., None, :, :] != val.NONE
    )
    new = (
        amatch_pa[..., :, :, None]
        & (cur_batch != val.NONE)[..., :, None, :]
        & (hold | comm)
    ).to(torch.int8)
    acks = acks | new
    n_ack = acks.sum(dim=-2, dtype=torch.int32)
    return acks, n_ack


# ---------------------------------------------------------------- kernels


def store_accepts_cuda(acc_ballot, acc_vid, learned, abat, abal, elig):
    """Launch the store kernel (one device launch: it reads ``abal`` and
    ``elig`` as given): updates ``acc_ballot``/``acc_vid`` in place and
    returns them.  Operands may carry a leading lane axis, the same on
    all six; every lane is covered by the one launch."""
    dev = acc_ballot.device
    if dev.type != "cuda":
        raise ValueError("simkern.store_accepts_cuda needs CUDA tensors")
    lead, lanes = _lanes(acc_ballot, 2)
    a, i = acc_ballot.shape[-2:]
    p = abat.shape[-2]
    kbuild.require(acc_ballot, "acc_ballot", torch.int32, (*lead, a, i), dev)
    kbuild.require(acc_vid, "acc_vid", torch.int32, (*lead, a, i), dev)
    kbuild.require(learned, "learned", torch.int32, (*lead, a, i), dev)
    kbuild.require(abat, "abat", torch.int32, (*lead, p, i), dev)
    kbuild.require(abal, "abal", torch.int32, (*lead, p), dev)
    kbuild.require(elig, "elig", torch.bool, (*lead, p, a), dev)
    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.simkern_store_accepts(
            acc_ballot.data_ptr(), acc_vid.data_ptr(), learned.data_ptr(),
            abat.data_ptr(), abal.data_ptr(), elig.data_ptr(), lanes, a, p, i, stream,
        )
    kbuild.check_launch(lib, NAME, code, "simkern.store_accepts")
    _count("store_accepts")
    return acc_ballot, acc_vid


def accum_acks_cuda(acks, cur_batch, acc_ballot, acc_vid, learned, ballot, amatch_pa):
    """Launch the ack kernel (one device launch: it reads ``ballot`` and
    ``amatch_pa`` as given): updates ``acks`` in place; returns ``(acks,
    n_ack)``.  Operands may carry a leading lane axis, the same on all
    seven; every lane is covered by the one launch."""
    dev = acks.device
    if dev.type != "cuda":
        raise ValueError("simkern.accum_acks_cuda needs CUDA tensors")
    lead, lanes = _lanes(acks, 3)
    p, a, i = acks.shape[-3:]
    kbuild.require(acks, "acks", torch.int8, (*lead, p, a, i), dev)
    kbuild.require(cur_batch, "cur_batch", torch.int32, (*lead, p, i), dev)
    kbuild.require(acc_ballot, "acc_ballot", torch.int32, (*lead, a, i), dev)
    kbuild.require(acc_vid, "acc_vid", torch.int32, (*lead, a, i), dev)
    kbuild.require(learned, "learned", torch.int32, (*lead, a, i), dev)
    kbuild.require(ballot, "ballot", torch.int32, (*lead, p), dev)
    kbuild.require(amatch_pa, "amatch_pa", torch.bool, (*lead, p, a), dev)
    n_ack = torch.empty((*lead, p, i), dtype=torch.int32, device=dev)
    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.simkern_accum_acks(
            acks.data_ptr(), n_ack.data_ptr(), cur_batch.data_ptr(),
            acc_ballot.data_ptr(), acc_vid.data_ptr(), learned.data_ptr(),
            ballot.data_ptr(), amatch_pa.data_ptr(), lanes, a, p, i, stream,
        )
    kbuild.check_launch(lib, NAME, code, "simkern.accum_acks")
    _count("accum_acks")
    return acks, n_ack


# ---------------------------------------------------------------- dispatch


def store_accepts(acc_ballot, acc_vid, learned, abat, abal, elig):
    """Updates ``acc_ballot``/``acc_vid`` in place and returns them: the
    kernel on CUDA tensors, the plain version written back on CPU
    tensors.  Each call counts once in ``utils/counters``, on every
    device."""
    counters.add("store_accepts")
    if acc_ballot.device.type == "cpu":
        new_b, new_v = store_accepts_plain(acc_ballot, acc_vid, learned, abat, abal, elig)
        return acc_ballot.copy_(new_b), acc_vid.copy_(new_v)
    return store_accepts_cuda(acc_ballot, acc_vid, learned, abat, abal, elig)


def accum_acks(acks, cur_batch, acc_ballot, acc_vid, learned, ballot, amatch_pa):
    """Updates ``acks`` in place; returns ``(acks, n_ack)``: the kernel
    on CUDA tensors, the plain version written back on CPU tensors.
    Each call counts once in ``utils/counters``, on every device."""
    counters.add("accum_acks")
    if acks.device.type == "cpu":
        new, n_ack = accum_acks_plain(
            acks, cur_batch, acc_ballot, acc_vid, learned, ballot, amatch_pa
        )
        return acks.copy_(new), n_ack
    return accum_acks_cuda(
        acks, cur_batch, acc_ballot, acc_vid, learned, ballot, amatch_pa
    )


def bytes_per_launch(kernel: str, a: int, p: int, i: int, lanes: int = 1) -> int:
    """Bytes one launch over ``lanes`` lanes must move: each input read
    once, each output written once (the roofline count)."""
    if kernel == "store_accepts":
        # acc_ballot, learned, abat in; acc_ballot, acc_vid out (the
        # in-place store never reads acc_vid)
        return lanes * (i * (2 * 4 * a + 4 * p + 2 * 4 * a) + 4 * p + p * a)
    if kernel == "accum_acks":
        # acks, cur_batch, acc_* and learned in; acks, n_ack out
        return lanes * (i * (p * a + 4 * p + 3 * 4 * a + p * a + 4 * p) + 4 * p + p * a)
    raise ValueError(kernel)


SECTOR = 32  # bytes: the unit in which the card's memory moves data


def _sector_bytes(mask: torch.Tensor, elem_bytes: int) -> int:
    """Bytes of the 32-byte sectors that hold at least one element set in
    ``mask`` (the array's elements in memory order, its base aligned to
    a sector, as torch's allocations are)."""
    per = SECTOR // elem_bytes
    flat = mask.reshape(-1)
    pad = -flat.numel() % per
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return int(flat.view(-1, per).any(dim=1).sum()) * SECTOR


def _all_sectors(t: torch.Tensor) -> int:
    """Bytes of the sectors of a whole array, read or written in full."""
    return -(-t.numel() * t.element_size() // SECTOR) * SECTOR


def bytes_needed(kernel: str, *operands) -> int:
    """Bytes one launch on these operands (given as to the kernel, before
    it updates them, with or without a leading lane axis) needs at the
    least: the 32-byte sectors holding an element it must read, or one
    it must change, plus the scalars as :func:`bytes_per_launch` counts
    them, over every lane.  On fully dense operands it equals
    :func:`bytes_per_launch`; on a real round, whose instances mostly
    carry no batch, it is far less."""
    if kernel == "store_accepts":
        acc_ballot, acc_vid, learned, abat, abal, elig = operands
        has = elig[..., None] & (abat != val.NONE)[..., None, :]  # [.., P, A, I]
        need = has.any(dim=-3)  # [.., A, I]: some eligible proposer has a batch
        new_b, new_v = store_accepts_plain(acc_ballot, acc_vid, learned, abat, abal, elig)
        return (
            _sector_bytes(need, 4)  # learned
            + _sector_bytes(need & (learned == val.NONE), 4)  # acc_ballot
            + _sector_bytes(elig.any(dim=-1)[..., None].expand_as(abat), 4)  # abat rows
            + _sector_bytes(new_b != acc_ballot, 4)
            + _sector_bytes(new_v != acc_vid, 4)
            + 4 * abal.numel() + elig.numel()
        )
    if kernel == "accum_acks":
        acks, cur_batch, acc_ballot, acc_vid, learned, ballot, amatch_pa = operands
        # acceptor state matters only where a matched proposer has a
        # batch whose ack is not yet in the cube
        live = cur_batch != val.NONE  # [.., P, I]
        unacked = (acks & 1) == 0  # [.., P, A, I]
        need = (amatch_pa[..., None] & live[..., None, :] & unacked).any(dim=-3)  # [.., A, I]
        new, _ = accum_acks_plain(acks, cur_batch, acc_ballot, acc_vid, learned, ballot, amatch_pa)
        return (
            3 * _sector_bytes(need, 4)  # acc_ballot, acc_vid, learned
            + _all_sectors(cur_batch)
            + _all_sectors(acks)  # read in full: n_ack sums it
            + _sector_bytes(new != acks, 1)  # written where a bit changed
            + _all_sectors(cur_batch)  # n_ack, written in full
            + 4 * ballot.numel() + amatch_pa.numel()
        )
    raise ValueError(kernel)


#: The library build is covered by the dispatchers' entries.
AUDIT_EXEMPT = {
    "load": "builds and loads the kernels' library; every launch goes "
            "through store_accepts / accum_acks, which the entries cover",
}


def audit_entries():
    """The two kernels' registered entry points (``analysis/registry.py``),
    JAX's canonical one-tile calls: ``[A, I] = [3, 65536]`` acceptor
    arrays, two proposers, every proposer eligible with a zero batch
    (so both kernels do their full work), one dispatcher call each."""
    from tpu_paxos_torch.analysis.registry import AuditEntry
    from tpu_paxos_torch.utils import device as devm

    a, p, i = 3, 2, 65536

    def _acceptor_arrays(dev):
        acc_ballot = torch.full((a, i), bal.NONE, dtype=torch.int32, device=dev)
        acc_vid = torch.full((a, i), val.NONE, dtype=torch.int32, device=dev)
        learned = torch.full((a, i), val.NONE, dtype=torch.int32, device=dev)
        return acc_ballot, acc_vid, learned

    def build_store(device):
        dev = devm.resolve(device)
        acc_ballot, acc_vid, learned = _acceptor_arrays(dev)
        abat = torch.zeros((p, i), dtype=torch.int32, device=dev)
        abal = torch.zeros((p,), dtype=torch.int32, device=dev)
        elig = torch.ones((p, a), dtype=torch.bool, device=dev)
        return store_accepts, (acc_ballot, acc_vid, learned, abat, abal, elig)

    def build_ack(device):
        dev = devm.resolve(device)
        acc_ballot, acc_vid, learned = _acceptor_arrays(dev)
        acks = torch.zeros((p, a, i), dtype=torch.int8, device=dev)
        cur_batch = torch.zeros((p, i), dtype=torch.int32, device=dev)
        ballot = torch.zeros((p,), dtype=torch.int32, device=dev)
        amatch = torch.ones((p, a), dtype=torch.bool, device=dev)
        return accum_acks, (acks, cur_batch, acc_ballot, acc_vid, learned, ballot, amatch)

    return [
        AuditEntry("simkern.store_accepts", build_store, covers=("store_accepts",)),
        AuditEntry("simkern.accum_acks", build_ack, covers=("accum_acks",)),
    ]
