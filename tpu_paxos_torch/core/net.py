"""Bulk-synchronous network: edge-scalar ring calendars + fault masks
(port of ``tpu_paxos/core/net.py``).

Point-to-point messages are entries in fixed-size arrival calendars:
one ring per message type whose leading axis is "arrives in k rounds";
a message sent at round ``t`` with sampled delay ``d`` is written at
slot ``(t + 1 + d) % S``.  Calendars hold only a per-edge scalar (a
ballot or a presence bit); per-instance payloads are read from the
sender's state at delivery (see the JAX module for the legality
argument).

Fault semantics follow ``THNetWork::HijackSend`` (ref
multi/main.cpp:116-132): copy 0 is dropped with probability
drop_rate/1e4, up to three duplicates chain with probability
dup_rate/1e4 and are never dropped, and each copy samples a delay in
[min_delay, max_delay] rounds.

The copy plans are drawn on the host: their inputs are the seed and
the round number only, so the engine computes every plan of a round in
one batched threefry pass (:func:`copy_plans`) and moves the small
result to the device once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_paxos_torch.config import FaultConfig
from tpu_paxos_torch.core import ballot as bal
from tpu_paxos_torch.utils import prng

MAX_COPIES = 4  # original + up to 3 recursive duplicates, ref multi/main.cpp:120


class FaultKnobs(NamedTuple):
    """The i.i.d. fault knobs as runtime integers (scalar form).  With
    knobs, :func:`copy_plan` samples in always-on masked form, which is
    exact at zero: ``randint(.., 0, 10000) < 0`` is all false and a
    ``[0, 0]`` delay span samples 0.  The per-edge matrix form waits
    for the slice that ports ``FaultConfig.edges``."""

    drop_rate: int
    dup_rate: int
    min_delay: int
    max_delay: int
    crash_rate: int
    delay_bound: int


def knobs_from_faults(fc: FaultConfig) -> FaultKnobs:
    """Host-side encoding of a FaultConfig's i.i.d. knobs."""
    if fc.edges is not None:
        raise NotImplementedError(
            "cfg.faults.edges (matrix-form knobs) is not ported yet"
        )
    return FaultKnobs(
        drop_rate=int(fc.drop_rate),
        dup_rate=int(fc.dup_rate),
        min_delay=int(fc.min_delay),
        max_delay=int(fc.max_delay),
        crash_rate=int(fc.crash_rate),
        delay_bound=int(fc.max_delay),
    )


class NetBuffers(NamedTuple):
    """Arrival calendars, leading axis S = max_delay + 2 ring slots;
    P proposers, A nodes; NONE (-1) marks "no message"."""

    prep_req: torch.Tensor  # [S, P, A] int32 ballot
    prep_echo: torch.Tensor  # [S, A, P] int32 ballot echo
    rej: torch.Tensor  # [S, A, P] int32 max ballot (NONE = no reject)
    acc_req: torch.Tensor  # [S, P, A] int32 ballot (NONE = no message)
    acc_echo: torch.Tensor  # [S, A, P] int32 ballot echo
    com_pres: torch.Tensor  # [S, P, A] bool edge presence
    com_rep: torch.Tensor  # [S, A, P] bool


def init_buffers(s: int, p: int, a: int, device="cpu") -> NetBuffers:
    def none(*shape):
        return torch.full(shape, bal.NONE, dtype=torch.int32, device=device)

    def false(*shape):
        return torch.zeros(shape, dtype=torch.bool, device=device)

    return NetBuffers(
        prep_req=none(s, p, a),
        prep_echo=none(s, a, p),
        rej=none(s, a, p),
        acc_req=none(s, p, a),
        acc_echo=none(s, a, p),
        com_pres=false(s, p, a),
        com_rep=false(s, a, p),
    )


def clear_slot(buffers: NetBuffers, slot: int) -> NetBuffers:
    """Copies of the calendars with the just-popped slot cleared."""
    out = []
    for buf in buffers:
        buf = buf.clone()
        buf[slot] = False if buf.dtype == torch.bool else bal.NONE
        out.append(buf)
    return NetBuffers(*out)


def _plan_requests(key, edge_shape, fc: FaultConfig, knobs: FaultKnobs | None):
    """The randint draws of one plan, as ``(name, request)`` pairs; a
    draw the static path elides is absent."""
    k_drop, k_dup, k_delay = prng.split(key, 3)
    dup_shape = (MAX_COPIES - 1, *edge_shape)
    delay_shape = (MAX_COPIES, *edge_shape)
    if knobs is not None:
        return [
            ("drop", (k_drop, edge_shape, 0, 10_000)),
            ("dup", (k_dup, dup_shape, 0, 10_000)),
            ("delay", (k_delay, delay_shape, knobs.min_delay, knobs.max_delay + 1)),
        ]
    if fc.edges is not None:
        raise NotImplementedError("cfg.faults.edges is not ported yet")
    reqs = []
    if fc.drop_rate:
        reqs.append(("drop", (k_drop, edge_shape, 0, 10_000)))
    if fc.dup_rate:
        reqs.append(("dup", (k_dup, dup_shape, 0, 10_000)))
    if fc.max_delay:
        reqs.append(("delay", (k_delay, delay_shape, fc.min_delay, fc.max_delay + 1)))
    return reqs


def copy_plans(sites, fc: FaultConfig, knobs: FaultKnobs | None = None):
    """Fault plans for several sends in one hash pass.  ``sites`` is a
    list of ``(key, edge_shape)``; returns a list of ``(alive, delay)``
    pairs as :func:`copy_plan` gives them."""
    per_site = [_plan_requests(k, tuple(shape), fc, knobs) for k, shape in sites]
    flat = [req for reqs in per_site for _, req in reqs]
    draws = iter(prng.randint_many(flat))
    drop_rate = fc.drop_rate if knobs is None else knobs.drop_rate
    dup_rate = fc.dup_rate if knobs is None else knobs.dup_rate
    out = []
    for (_, shape), reqs in zip(sites, per_site):
        got = {name: next(draws) for name, _ in reqs}
        shape = tuple(shape)
        if "drop" in got:
            drop = got["drop"] < drop_rate
        else:
            drop = torch.zeros(shape, dtype=torch.bool)
        if "dup" in got:
            coins = got["dup"] < dup_rate
            dup1 = coins[0]
            dup2 = dup1 & coins[1]
            dup3 = dup2 & coins[2]
            dups = torch.stack([dup1, dup2, dup3])
        else:
            dups = torch.zeros((MAX_COPIES - 1, *shape), dtype=torch.bool)
        alive = torch.cat([(~drop)[None], dups], dim=0)
        if "delay" in got:
            delay = got["delay"]
        else:
            delay = torch.zeros((MAX_COPIES, *shape), dtype=torch.int32)
        out.append((alive, delay))
    return out


def copy_plan(key, edge_shape, fc: FaultConfig, knobs: FaultKnobs | None = None):
    """Sample the THNetWork fault plan for one send: ``(alive
    [MAX_COPIES, *edge] bool, delay [MAX_COPIES, *edge] int32)`` on the
    CPU.  ``knobs`` selects the always-on masked form (scalar knobs)."""
    return copy_plans([(key, edge_shape)], fc, knobs)[0]


def _slot_onehot(t: int, s: int, alive: torch.Tensor, delay: torch.Tensor) -> torch.Tensor:
    """[MAX_COPIES, *edge] arrival slots -> [S, *edge] bool write mask."""
    slots = torch.remainder(t + 1 + delay, s)
    oh = torch.arange(s, dtype=torch.int32, device=slots.device)
    oh = oh.reshape((s,) + (1,) * slots.ndim)
    return ((slots[None] == oh) & alive[None]).any(dim=1)


def write_ballot(buf, t: int, alive, delay, value, send_mask):
    """Coalesce-max write of a ballot-valued message into its calendar;
    ``value``/``send_mask`` are per-edge."""
    s = buf.shape[0]
    mask = _slot_onehot(t, s, alive, delay) & send_mask[None]
    fill = torch.full_like(buf, bal.NONE)
    return torch.maximum(buf, torch.where(mask, value[None].expand_as(buf), fill))


def write_flag(buf, t: int, alive, delay, send_mask):
    """Coalesce-or write of a presence-bit message into its calendar."""
    s = buf.shape[0]
    return buf | (_slot_onehot(t, s, alive, delay) & send_mask[None])
