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

The copy plans are drawn on the host: their inputs are the seed, the
round number and the fault knobs and schedule rows of that round, so
the engine computes every plan of a round in one batched threefry pass
(:func:`copy_plans`) and moves the small result to the device once.
Per-edge ``[A, A]`` knob matrices (``FaultConfig.edges``), the
schedule's burst-loss addition and its gray delay inflation all apply
at that step; the reachability cuts apply to the send masks in the
engine and, with ``delivery_cut``, to arrivals (:func:`delivery_mask`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_paxos_torch.config import FaultConfig
from tpu_paxos_torch.core import ballot as bal
from tpu_paxos_torch.utils import prng

MAX_COPIES = 4  # original + up to 3 recursive duplicates, ref multi/main.cpp:120


class FaultKnobs(NamedTuple):
    """The i.i.d. fault knobs as runtime values.  With knobs,
    :func:`copy_plan` samples in always-on masked form, which is exact
    at zero: ``randint(.., 0, 10000) < 0`` is all false and a ``[0, 0]``
    delay span samples 0.

    The first four fields may also be per-edge ``[A, A]`` int32
    MATRICES (entry ``[s, d]`` governs node ``s`` -> node ``d``
    messages): the drawn bits depend only on key and shape, and the
    rates and spans apply elementwise, so a UNIFORM matrix draws exactly
    what the scalar knob draws.  Matrix knobs are sliced to an edge
    shape (:func:`edge_knobs`) before they reach :func:`copy_plan`.
    ``crash_rate`` stays a scalar (crashes are per node), and
    ``delay_bound`` is the config's declared ring bound, the gray
    inflation clamp."""

    drop_rate: object  # int or [A, A] int32, per 1e4
    dup_rate: object  # int or [A, A] int32, per 1e4
    min_delay: object  # int or [A, A] int32 rounds
    max_delay: object  # int or [A, A] int32 rounds
    crash_rate: int  # per 1e6
    delay_bound: int  # the config's max_delay


def knobs_from_faults(fc: FaultConfig) -> FaultKnobs:
    """Host-side encoding of a FaultConfig's i.i.d. knobs; an
    ``edges``-bearing config encodes to matrix-form knobs."""
    if fc.edges is not None:
        return matrix_knobs(fc)
    return FaultKnobs(
        drop_rate=int(fc.drop_rate),
        dup_rate=int(fc.dup_rate),
        min_delay=int(fc.min_delay),
        max_delay=int(fc.max_delay),
        crash_rate=int(fc.crash_rate),
        delay_bound=int(fc.max_delay),
    )


def matrix_knobs(fc: FaultConfig, n_nodes: int | None = None) -> FaultKnobs:
    """Matrix-form host knobs for ``fc``: its ``edges`` tables when
    present, else the scalar knobs broadcast to a uniform ``[A, A]``
    matrix (``n_nodes`` is then required)."""
    e = fc.edges
    if e is not None:
        return FaultKnobs(
            drop_rate=np.asarray(e.drop_rate, np.int32),
            dup_rate=np.asarray(e.dup_rate, np.int32),
            min_delay=np.asarray(e.min_delay, np.int32),
            max_delay=np.asarray(e.max_delay, np.int32),
            crash_rate=int(fc.crash_rate),
            delay_bound=int(fc.max_delay),
        )
    if n_nodes is None:
        raise ValueError("matrix_knobs needs n_nodes for an edge-free config")

    def full(v):
        return np.full((n_nodes, n_nodes), v, np.int32)

    return FaultKnobs(
        drop_rate=full(fc.drop_rate),
        dup_rate=full(fc.dup_rate),
        min_delay=full(fc.min_delay),
        max_delay=full(fc.max_delay),
        crash_rate=int(fc.crash_rate),
        delay_bound=int(fc.max_delay),
    )


def edge_knobs(knobs: FaultKnobs, rows, cols) -> FaultKnobs:
    """Slice matrix-form knob fields to one edge shape: ``rows`` are the
    source node ids of the edge shape's leading axis, ``cols`` the
    destination ids of its trailing axis (proposer->node sends slice
    ``[pn, :]``, node->proposer replies ``[:, pn]``).  Scalar fields
    pass through."""
    rows, cols = np.asarray(rows), np.asarray(cols)

    def sl(x):
        x = np.asarray(x)
        return x if x.ndim < 2 else x[rows][:, cols]

    return knobs._replace(
        drop_rate=sl(knobs.drop_rate),
        dup_rate=sl(knobs.dup_rate),
        min_delay=sl(knobs.min_delay),
        max_delay=sl(knobs.max_delay),
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


def _i64(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.int64)


def _plan_requests(key, edge_shape, fc: FaultConfig, knobs, extra_drop):
    """The randint draws of one plan, as ``(name, request)`` pairs; a
    draw the static path elides is absent."""
    k_drop, k_dup, k_delay = prng.split(key, 3)
    dup_shape = (MAX_COPIES - 1, *edge_shape)
    delay_shape = (MAX_COPIES, *edge_shape)
    if knobs is not None:
        return [
            ("drop", (k_drop, edge_shape, 0, 10_000)),
            ("dup", (k_dup, dup_shape, 0, 10_000)),
            ("delay", (k_delay, delay_shape, _i64(knobs.min_delay),
                       _i64(knobs.max_delay) + 1)),
        ]
    if fc.edges is not None:
        # an edges-bearing config must arrive with its matrix knobs:
        # the static scalar path would sample its zeroed scalar knobs
        raise ValueError(
            "copy_plan with per-edge tables needs knobs= "
            "(net.matrix_knobs); the static scalar path would drop "
            "the matrix"
        )
    reqs = []
    if extra_drop is not None or fc.drop_rate:
        reqs.append(("drop", (k_drop, edge_shape, 0, 10_000)))
    if fc.dup_rate:
        reqs.append(("dup", (k_dup, dup_shape, 0, 10_000)))
    if fc.max_delay:
        reqs.append(("delay", (k_delay, delay_shape, fc.min_delay, fc.max_delay + 1)))
    return reqs


def copy_plans(sites, fc: FaultConfig, extra_drop: int | None = None,
               delay_bound: int | None = None):
    """Fault plans for several sends in one hash pass.  Each site is
    ``(key, edge_shape, knobs, gray)`` with ``knobs`` and ``gray`` as
    :func:`copy_plan` takes them (either may be None); returns a list of
    ``(alive, delay)`` pairs as :func:`copy_plan` gives them."""
    sites = [(key, tuple(shape), kn, gray) for key, shape, kn, gray in sites]
    per_site = [
        _plan_requests(key, shape, fc, kn, extra_drop) for key, shape, kn, _ in sites
    ]
    flat = [req for reqs in per_site for _, req in reqs]
    draws = iter(prng.randint_many(flat))
    out = []
    for (_, shape, kn, gray), reqs in zip(sites, per_site):
        got = {name: next(draws) for name, _ in reqs}
        if "drop" in got:
            rate = _i64(fc.drop_rate if kn is None else kn.drop_rate)
            if extra_drop is not None:
                rate = torch.clamp(rate + extra_drop, max=10_000)
            drop = got["drop"] < rate
        else:
            drop = torch.zeros(shape, dtype=torch.bool)
        if "dup" in got:
            coins = got["dup"] < _i64(fc.dup_rate if kn is None else kn.dup_rate)
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
        if gray is not None:
            # gray inflation, clamped at the config's declared ring
            # bound: it slows copies, never drops them
            bound = kn.delay_bound if kn is not None else delay_bound
            delay = torch.clamp(delay + _i64(gray)[None], max=int(bound)).to(torch.int32)
        out.append((alive, delay))
    return out


def copy_plan(key, edge_shape, fc: FaultConfig, extra_drop=None,
              knobs: FaultKnobs | None = None, gray=None, delay_bound=None):
    """Sample the THNetWork fault plan for one send: ``(alive
    [MAX_COPIES, *edge] bool, delay [MAX_COPIES, *edge] int32)`` on the
    CPU.  ``extra_drop`` is the schedule's burst-loss addition to the
    drop rate this round (clamped to 1e4); ``knobs`` selects the
    always-on masked form (scalar or edge-sliced matrix knobs); ``gray``
    (``[*edge]`` ints) adds extra delay rounds to every copy, clamped at
    ``knobs.delay_bound`` or else ``delay_bound`` (``fc.max_delay``)."""
    return copy_plans(
        [(key, edge_shape, knobs, gray)], fc, extra_drop=extra_drop,
        delay_bound=delay_bound,
    )[0]


def delivery_mask(ar: NetBuffers, reach_pa, reach_ap) -> NetBuffers:
    """Delivery-time partition cut: void the popped arrival slot's
    entries on edges severed at the ARRIVAL round (``reach_pa`` is the
    [P, A] proposer->node reachability, ``reach_ap`` the [A, P]
    node->proposer one).  An all-true reach round is the identity."""
    return NetBuffers(
        prep_req=torch.where(reach_pa, ar.prep_req, bal.NONE),
        prep_echo=torch.where(reach_ap, ar.prep_echo, bal.NONE),
        rej=torch.where(reach_ap, ar.rej, bal.NONE),
        acc_req=torch.where(reach_pa, ar.acc_req, bal.NONE),
        acc_echo=torch.where(reach_ap, ar.acc_echo, bal.NONE),
        com_pres=ar.com_pres & reach_pa,
        com_rep=ar.com_rep & reach_ap,
    )


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
