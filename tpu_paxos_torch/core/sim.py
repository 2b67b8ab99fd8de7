"""The general multi-round engine in PyTorch (port of
``tpu_paxos/core/sim.py``, the unpadded, unsharded build).

Fault-tolerant multi-Paxos as a bulk-synchronous round loop: every
node's proposer/acceptor/learner state lives in SoA tensors, one call
of the round function is one network round, and all asynchrony
(retries, randomized backoff, drops, duplicates, delays, crashes) is
per-round masks, counters and the arrival calendars of ``core/net.py``.
The protocol semantics and their reference anchors are documented in
the JAX module; this port computes the same function round for round,
so the same (config, workload, seed) gives the same decision log.

How the port runs what JAX compiles:

- ``lax.cond`` blocks gated on global predicates become host branches:
  the predicate is read to the host (one sync each) and the block runs
  only on the rounds where JAX runs it.  Both are exact: a skipped
  block passes its inputs through unchanged.
- ``lax.while_loop`` becomes a host loop with the same stop,
  ``~done & t < round_budget`` (:func:`run_lanes`, a single run being
  one lane).
- ``dynamic_slice``/``dynamic_update_slice`` clamp their start as XLA
  does (:func:`_window_read`, :func:`_window_write`).
- The multi-operand ``lax.sort`` becomes a stable ``torch.sort`` of the
  keys plus a gather; its keys are unique where the result is used.
- Every PRNG draw of a round comes from one batched threefry pass
  (``utils/prng.py``): the keys are derived on the host, the words
  hashed on the engine's device, so only the keys and the round's
  schedule rows cross to a card.
- On a CUDA device the accept store and the ack fold run the
  hand-written kernels of ``core/simkern.py``; on the CPU their plain
  versions.  On both they update the acceptor arrays and the ack cube
  IN PLACE, so the round function consumes the state it is given (as
  a donated JAX loop state is consumed) on every device alike.  A
  caller that needs a state again keeps a copy
  (``interop.sim_state_to_numpy``) before the round.
- Correlated faults run on the constant path: the schedule
  (``cfg.faults.schedule``) is lowered once to per-round numpy tables
  (``faults.compile_schedule``) and each round reads its rows at
  ``min(t, horizon)`` on the host; per-edge ``[A, A]`` fault tables
  (``cfg.faults.edges``) are matrix knobs sliced per send direction;
  burst loss, gray inflation and the knob matrices shape the copy
  plans, and the pause, reachability and crash rows ride the round's
  one host-to-device copy of rows.
- The runtime-schedule and runtime-knob builds take the schedule as a
  ``fleet.schedule_table.ScheduleTable`` and the i.i.d. knobs as a
  ``net.FaultKnobs`` per call, in the JAX engine's always-on masked
  forms, for the fleet runner.
- The round runs over a leading LANE axis (:func:`_lane_round`): a
  fleet's ``L`` simulations in one round function, one hash pass and one
  launch per kernel; a single run is one lane of it.  How each
  ``lax.cond`` block stays exact per lane, and how a finished lane stays
  as it was, is documented there and at :func:`run_lanes`.
- The flight recorder (``telemetry=True``, :func:`_record`) rides the
  lane-axis round beside the state: it reads values the round computed,
  including the identity values of the blocks the host skipped, makes
  no host read of its own, and is frozen with a lane's state.
  :func:`run_with_telemetry` reduces it on the device after the loop.

- The geometry-padded build (``geometry=``, a
  ``core.geom.GeometryEnvelope``) pads the node and proposer axes to the
  menu's bound and takes the TRUE geometry per call
  (``round_fn(..., geom=Geometry)``); the runtime-protocol build takes the
  protocol constants per call (``pknobs=ProtocolKnobs``).  A dispatch
  has one true geometry, so the host picks its menu entry per call, as
  it runs the ``lax.cond`` blocks: every draw whose shape depends on the
  geometry is made at the entry's true shape and padded, as JAX's
  ``lax.switch`` branches draw (:func:`_draws`).

- The instance-sharded build (``axis_name=``, a rank's
  ``parallel.mesh.Collectives``, and ``n_shards``) holds one rank's block
  of ``n_instances / n_shards`` instances with global instance ids, as
  JAX's ``shard_map`` body does.  Every host branch JAX takes on a global
  predicate (its ``gany``/``gall``/``gmax``/``gsum`` sites) branches on
  the value reduced over the mesh, read to the host with the local
  values JAX reduces in the same place, in one collective
  (:func:`_global_max`, :func:`_global_counts`); the replicated
  predicates (JAX's ``rany``) stay local.  See ``parallel/sharded_sim``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import types
from typing import NamedTuple

import numpy as np
import torch

from tpu_paxos_torch.config import FaultConfig, SimConfig
from tpu_paxos_torch.core import ballot as bal
from tpu_paxos_torch.core import faults as fltm
from tpu_paxos_torch.core import geom as geo
from tpu_paxos_torch.core import net as netm
from tpu_paxos_torch.core import simkern as sk
from tpu_paxos_torch.core import values as val
from tpu_paxos_torch.fleet import schedule_table as stm
from tpu_paxos_torch.utils import counters
from tpu_paxos_torch.utils import device as devm
from tpu_paxos_torch.utils import prng

# Proposer modes
DELAY = 0  # waiting out the randomized prepare delay
PREPARING = 1  # prepare broadcast in flight
PREPARED = 2  # phase-1 quorum held; accepts in flight

# Ballot reported for committed values in prepare-reply snapshots so
# adoption always prefers them.
COMMITTED_BALLOT = 2**30

_NEG = -(2**31)  # -inf sentinel for masked max (int32 min)
_I32_MAX = 2**31 - 1

# Idle-liveness patience: a PREPARED proposer with nothing in flight
# while the log still has holes restarts its prepare after this many
# rounds (see the JAX module).
IDLE_RESTART_ROUNDS = 8

_I32 = torch.int32


def seeded_wedge() -> str:
    """``TPU_PAXOS_SEEDED_WEDGE=takeover`` re-introduces the commit
    TAKEOVER wedge (the takeover is left out and survivors never
    re-commit an already-chosen instance) for checker-recall pins.
    Read when the engine is built."""
    return os.environ.get("TPU_PAXOS_SEEDED_WEDGE", "")


class AcceptorState(NamedTuple):
    promised: torch.Tensor  # [A] int32 scalar promised ballot per acceptor
    max_seen: torch.Tensor  # [A] int32 max ballot ever seen
    acc_ballot: torch.Tensor  # [A, I] int32 accepted ballot (NONE none)
    acc_vid: torch.Tensor  # [A, I] int32 accepted vid


class ProposerState(NamedTuple):
    mode: torch.Tensor  # [P] int32 DELAY / PREPARING / PREPARED
    count: torch.Tensor  # [P] int32 ballot count
    ballot: torch.Tensor  # [P] int32 current ballot
    pmax_seen: torch.Tensor  # [P] int32 max ballot seen via rejects
    delay_until: torch.Tensor  # [P] int32 round to start the next prepare
    prep_deadline: torch.Tensor  # [P] int32
    prep_retries: torch.Tensor  # [P] int32
    promises: torch.Tensor  # [P, A] bool promises for current ballot
    adopted_b: torch.Tensor  # [P, I] int32 adopted pre-accepted ballot
    adopted_v: torch.Tensor  # [P, I] int32 adopted pre-accepted vid
    cur_batch: torch.Tensor  # [P, I] int32 vids being accepted at ballot
    acks: torch.Tensor  # [P, A, I] int8 0/1 per-instance accept acks
    acc_deadline: torch.Tensor  # [P] int32
    acc_retries: torch.Tensor  # [P] int32
    own_assign: torch.Tensor  # [P, I] int32 own initial proposals by instance
    pend: torch.Tensor  # [P, C+W] int32 pending-value ring (W-padded)
    gate: torch.Tensor  # [P, C+W] int32 vid that must be chosen first
    head: torch.Tensor  # [P] int32 ring head (absolute)
    tail: torch.Tensor  # [P] int32 ring tail (absolute)
    commit_vid: torch.Tensor  # [P, I] int32 values this proposer is committing
    commit_acked: torch.Tensor  # [P, A, I] bool
    commit_deadline: torch.Tensor  # [P] int32
    stall: torch.Tensor  # [P] int32 rounds spent idle while the log has holes
    commit_wait: torch.Tensor  # [P] bool cached "not fully acked" flag


class Metrics(NamedTuple):
    chosen_vid: torch.Tensor  # [I] int32 decided value (NONE undecided)
    chosen_round: torch.Tensor  # [I] int32 round of decision
    chosen_ballot: torch.Tensor  # [I] int32 deciding ballot
    msgs: torch.Tensor  # [7] int32 logical sends per message type


class SimState(NamedTuple):
    t: torch.Tensor  # int32 round counter (the virtual clock)
    acc: AcceptorState
    learned: torch.Tensor  # [A, I] int32 learner state per node
    prop: ProposerState
    net: netm.NetBuffers
    met: Metrics
    crashed: torch.Tensor  # [A] bool fail-stop crash mask
    done: torch.Tensor  # bool quiescence predicate
    qsums: torch.Tensor  # [1 + A + 3P] int32 cached quiescence counts
    qhmax: torch.Tensor  # int32 cached chosen high-water mark


@dataclasses.dataclass(frozen=True)
class SimResult:
    learned: np.ndarray  # [I, A]
    chosen_vid: np.ndarray  # [I]
    chosen_round: np.ndarray  # [I]
    chosen_ballot: np.ndarray  # [I]
    rounds: int
    done: bool
    crashed: np.ndarray  # [A] bool
    msgs: np.ndarray  # [7] logical send counts
    expected_vids: np.ndarray  # union of workload vids (all proposers)

    @property
    def rounds_to_chosen(self) -> np.ndarray:
        """Per decided instance, rounds from t=0 to decision."""
        return self.chosen_round[self.chosen_vid != val.NONE]

    def value_status(self, vid: int) -> dict:
        """Per-proposal completion status, the Callback SPI surface (ref
        multi/paxos.h:241-246 ``Run``; member/paxos.h:142-163
        ``Accepted``/``Applied``):

        - ``pending``: never chosen (still queued, lost with a crashed
          proposer, or displaced and re-proposed after this snapshot);
        - ``accepted``: chosen, i.e. accepted by a majority of acceptors;
        - ``applied``: also learned by a majority of nodes (the Applied
          quorum that sequences membership changes).
        """
        if vid < 0:
            # NONE and no-op sentinels are not proposals
            return {"status": "pending"}
        where = np.flatnonzero(self.chosen_vid == vid)
        if not where.size:
            return {"status": "pending"}
        i = int(where[0])
        n_nodes = self.learned.shape[1]
        learners = int((self.learned[i] != val.NONE).sum())
        applied = learners >= n_nodes // 2 + 1
        return {
            "status": "applied" if applied else "accepted",
            "instance": i,
            "round": int(self.chosen_round[i]),
            "ballot": int(self.chosen_ballot[i]),
            "learners": learners,
        }


def rounds_to_chosen_digest(rounds) -> dict:
    """A ``rounds_to_chosen`` array (either package's) as goldens hold it:
    its length, sum, max (``None`` when empty) and the sha256 of its
    little-endian int32 bytes."""
    r = np.asarray(rounds)
    return {"length": int(r.size), "sum": int(r.astype(np.int64).sum()),
            "max": int(r.max()) if r.size else None,
            "sha256": hashlib.sha256(np.ascontiguousarray(r, dtype="<i4").tobytes()).hexdigest()}


def _init_lanes(cfg: SimConfig, pend, gate, tail, roots, device,
                geometry=None, geom=None, pknobs=None) -> SimState:
    """The initial state of ``L`` lanes, every leaf with a leading lane
    axis: ``pend``/``gate`` ``[L, P, C+W]`` and ``tail`` ``[L, P]``
    (numpy), ``roots`` ``[L, 2]`` lane keys.  Under a ``geometry`` the
    initial backoff is drawn at ``geom``'s true proposer count and
    padded; ``pknobs`` replaces the config's backoff span."""
    a, i = cfg.n_nodes, cfg.n_instances
    p = len(cfg.proposers)
    lanes = roots.shape[0]
    s = cfg.faults.max_delay + 2
    pc = cfg.protocol if pknobs is None else pknobs
    lo, hi = int(pc.prepare_delay_min), int(pc.prepare_delay_max) + 1
    k0 = prng.stream_keys(roots, prng.STREAM_PREPARE_DELAY, 0)
    if geometry is None:
        delay0 = prng.randint_lanes([(k0, (p,), lo, hi)])[0]
    else:
        delay0 = geo.menu_randint(geometry, geom.geom_idx, k0, "proposers", lo, hi, pad_value=0)
    delay0 = delay0.to(device)

    def none(*sh):
        return torch.full((lanes, *sh), bal.NONE, dtype=_I32, device=device)

    def zeros(*sh, dtype=_I32):
        return torch.zeros((lanes, *sh), dtype=dtype, device=device)

    def rows(x):
        # a copy: a one-lane block of a broadcast template is a read-only
        # view the state must not share
        return torch.from_numpy(np.array(x, np.int32, order="C")).to(device)

    return SimState(
        t=zeros(),
        acc=AcceptorState(
            promised=zeros(a), max_seen=zeros(a),
            acc_ballot=none(a, i), acc_vid=none(a, i),
        ),
        learned=none(a, i),
        prop=ProposerState(
            mode=torch.full((lanes, p), DELAY, dtype=_I32, device=device),
            count=zeros(p),
            ballot=zeros(p),
            pmax_seen=zeros(p),
            delay_until=delay0,
            prep_deadline=zeros(p),
            prep_retries=zeros(p),
            promises=zeros(p, a, dtype=torch.bool),
            adopted_b=none(p, i),
            adopted_v=none(p, i),
            cur_batch=none(p, i),
            acks=zeros(p, a, i, dtype=torch.int8),
            acc_deadline=zeros(p),
            acc_retries=zeros(p),
            own_assign=none(p, i),
            pend=rows(pend),
            gate=rows(gate),
            head=zeros(p),
            tail=rows(tail),
            commit_vid=none(p, i),
            commit_acked=zeros(p, a, i, dtype=torch.bool),
            commit_deadline=zeros(p),
            stall=zeros(p),
            commit_wait=zeros(p, dtype=torch.bool),
        ),
        net=netm.init_buffers(s, p, a, device, lanes=lanes),
        met=Metrics(
            chosen_vid=none(i), chosen_round=none(i), chosen_ballot=none(i),
            msgs=zeros(7),
        ),
        crashed=zeros(a, dtype=torch.bool),
        done=zeros(dtype=torch.bool),
        qsums=zeros(1 + a + 3 * p),
        qhmax=torch.full((lanes,), -1, dtype=_I32, device=device),
    )


def _rebuild(tree, items):
    """A tree of the kind of ``tree`` (a NamedTuple or a plain tuple)
    holding ``items``."""
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)


def lanes_view(state):
    """``state`` (or any tree of tensors) as one lane: every leaf gains a
    leading lane axis of 1, as a view of the same storage."""
    if isinstance(state, torch.Tensor):
        return state[None]
    return _rebuild(state, [lanes_view(x) for x in state])


def lane_of(state, i: int):
    """Lane ``i`` of a lane-stacked tree, as views."""
    if isinstance(state, torch.Tensor):
        return state[i]
    return _rebuild(state, [lane_of(x, i) for x in state])


def _freeze(old, new, keep: torch.Tensor):
    """``new`` with the lanes where ``keep`` is false taken from ``old``
    (a finished lane's carry stays as it was); leaves the round left as
    they were are passed through."""
    if isinstance(new, torch.Tensor):
        if new is old:
            return new
        k = keep.reshape((-1,) + (1,) * (new.ndim - 1))
        return torch.where(k, new, old)
    return _rebuild(new, [_freeze(o, n, keep) for o, n in zip(old, new)])


def _window_read(rows: torch.Tensor, starts: torch.Tensor, w: int) -> torch.Tensor:
    """Per-row ``lax.dynamic_slice(row, (h,), (w,))`` over the last axis
    of ``rows`` (any leading axes, one start each): the start is clamped
    into ``[0, len - w]`` as XLA clamps it."""
    lead, n = rows.shape[:-1], rows.shape[-1]
    st = starts.reshape(-1).to(torch.int64).clamp(0, n - w)
    pos = st[:, None] + torch.arange(w, device=rows.device)
    return rows.reshape(-1, n).gather(1, pos).reshape(*lead, w)


def _window_write(rows: torch.Tensor, vals: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Per-row ``lax.dynamic_update_slice(row, vals, (h,))`` over the last
    axis with XLA's start clamp; returns a new tensor."""
    lead, n = rows.shape[:-1], rows.shape[-1]
    w = vals.shape[-1]
    st = starts.reshape(-1).to(torch.int64).clamp(0, n - w)
    pos = st[:, None] + torch.arange(w, device=rows.device)
    return rows.reshape(-1, n).scatter(1, pos, vals.reshape(-1, w)).reshape(*lead, n)


def _gate_satisfied(g: torch.Tensor, chosen_mask: torch.Tensor) -> torch.Tensor:
    """An entry is proposable when ungated or its gate vid is in its
    lane's chosen-membership bitmap (``chosen_mask [L, V]``, ``g [L,
    ...]``); gates on out-of-workload vids never satisfy."""
    lanes, v_cap = chosen_mask.shape
    at = g.clamp(0, v_cap - 1).reshape(lanes, -1).long()
    g_chosen = chosen_mask.gather(1, at).reshape(g.shape) & (g != val.NONE) & (g < v_cap)
    return (g == val.NONE) | g_chosen


def _assignable_window(pend, gate, head, tail, chosen_mask, w):
    """First-fit view of the head window: which of the next W queue
    entries are live (and, with a bitmap, gate-satisfied).  Returns
    (qvid [L, P, W], ok [L, P, W])."""
    offs = torch.arange(w, dtype=_I32, device=pend.device)
    qvid = _window_read(pend, head, w)
    live = ((head[..., None] + offs) < tail[..., None]) & (qvid != val.NONE)
    if chosen_mask is None:
        return qvid, live
    g = _window_read(gate, head, w)
    return qvid, live & _gate_satisfied(g, chosen_mask)


def _any(x: torch.Tensor) -> bool:
    """A predicate over every lane read to the host (one sync)."""
    counters.add("host_reads")
    return bool(x.any())


def _lane_any(x: torch.Tensor) -> torch.Tensor:
    """``[L]``: whether each lane's slice of ``x`` has a true element."""
    return x.reshape(x.shape[0], -1).any(dim=1)


def _sum32(x: torch.Tensor, dim=None) -> torch.Tensor:
    """``jnp.sum`` of bools/ints as int32 (torch sums to int64)."""
    return (x.sum() if dim is None else x.sum(dim=dim)).to(_I32)


def _one_lane(table):
    """One run's host table (a ScheduleTable or FaultKnobs) with a lane
    axis of 1 on every field."""
    return type(table)(*[np.asarray(x)[None] for x in table])


def _to_dev(b, x: np.ndarray) -> torch.Tensor:
    return devm.to_device(torch.from_numpy(np.ascontiguousarray(x)), b.dev)


def _global_max(b, parts: dict) -> dict:
    """The max over every shard of each named local value (``[L, ...]``
    bool or integer tensors), read to the host in one copy and, on a
    sharded build, reduced in one collective; host numpy of the same
    shapes, bools as bool.  On an unsharded build the one read gives the
    local values.  JAX's ``gany`` and ``gmax`` sites, and ``gall(x)`` as
    ``not max(not x)``."""
    names = list(parts)
    xs = [parts[n].reshape(-1) for n in names]
    if any(x.dtype != torch.bool for x in xs):
        xs = [x.to(torch.int64) for x in xs]
    counters.add("host_reads")
    flat = torch.cat(xs).cpu().numpy()
    g = flat if b.comm is None else b.comm.gmax(flat)
    out, k = {}, 0
    for n in names:
        x = parts[n]
        v = g[k:k + x.numel()].reshape(tuple(x.shape))
        out[n] = v.astype(bool) if x.dtype == torch.bool else v
        k += x.numel()
    return out


def _on_dev(b, local: torch.Tensor, reduced: np.ndarray) -> torch.Tensor:
    """A :func:`_global_max` value on the device: ``local`` itself on an
    unsharded build, where the two are equal."""
    return local if b.comm is None else _to_dev(b, reduced)


def _global_counts(b, sums: torch.Tensor, hmax: torch.Tensor):
    """JAX's packed quiescence reduction (:1946), the ``gsum`` of the
    counts and the ``gmax`` of the chosen high-water mark, in one
    collective on a sharded build; both back on the device as int32.  An
    unsharded build's are its own."""
    if b.comm is None:
        return sums, hmax
    n = sums.numel()
    counters.add("host_reads")
    local = torch.cat([sums.reshape(-1), hmax.reshape(-1)]).to(torch.int64).cpu().numpy()
    every = b.comm.exchange(local)  # [D, n + L]
    s = every[:, :n].sum(axis=0).reshape(tuple(sums.shape))
    h = every[:, n:].max(axis=0).reshape(tuple(hmax.shape))
    return _to_dev(b, s.astype(np.int32)), _to_dev(b, h.astype(np.int32))


def _pad_edges(x: torch.Tensor, shape) -> torch.Tensor:
    """``[..., r, c]`` padded with zeros (False) to ``[..., *shape]``."""
    if tuple(x.shape[-2:]) == tuple(shape):
        return x
    out = x.new_zeros((*x.shape[:-2], *shape))
    out[..., :x.shape[-2], :x.shape[-1]] = x
    return out


def _draws(b, roots, t: int, tab, knobs, running):
    """Every coin of round ``t`` for every lane, hashed in one pass on the
    engine's device from keys derived on the host, and the schedule's rows
    for round ``t``, moved to the device in one copy: the seven copy
    plans, the restart backoff, the crash coins (``u < crash_rate``), the
    pause / reachability / crash rows, the heal gate of a runtime table
    and the running-lane mask.  Returns ``(plans, rnd_delay, crash_coin,
    rows)`` with ``rows`` a dict of what this build has.

    The draws are made at the shapes of ``b.draw_nodes`` nodes and the
    proposers ``b.draw_props``: the build's own, or under a geometry the
    dispatch's true menu entry (knob matrices and gray rows sliced to its
    node prefix and proposers), then padded to the bound with dead copies
    (alive False, delay 0), backoff 0 and crash coins False, as JAX's
    menu branches pad them."""
    a, p, fc, dev = b.a, b.p, b.fc, b.dev
    n_m, props = b.draw_nodes, b.draw_props
    p_m = len(props)
    lanes = roots.shape[0]
    gray = xdrop = None
    rows = {}
    if b.runtime_schedule:
        reach, paused, xdrop, gray = stm.masks_at(tab, t)
        rows = {"pause": paused, "reach": reach,
                "crash": stm.crashes_at(tab, t), "heal": t >= tab.horizon}
    elif b.comp is not None:
        comp, tt = b.comp, min(t, b.horizon)
        if b.has["gray"]:
            gray = np.broadcast_to(comp.gray[tt], (lanes, a))
        if b.has["burst"]:
            xdrop = np.full((lanes,), comp.extra_drop[tt])
        for name, table in (("pause", "paused"), ("reach", "reach"), ("crash", "crashed")):
            if b.has[name]:
                row = getattr(comp, table)[tt]
                rows[name] = np.broadcast_to(row, (lanes, *row.shape))
    if running is not None:
        rows["run"] = running
    gray_pa = gray_ap = None
    if gray is not None:
        g = np.asarray(gray, np.int64)
        gray_pa = g[:, props][:, :, None] + g[:, None, :n_m]  # [L, P, A] src + dst
        gray_ap = g[:, :n_m, None] + g[:, props][:, None, :]  # [L, A, P]
    if b.runtime_knobs:
        kn_pa = netm.edge_knobs(knobs, props, range(n_m))
        kn_ap = netm.edge_knobs(knobs, range(n_m), props)
    else:
        kn_pa, kn_ap = b.kn_pa0, b.kn_ap0
    keys = prng.split_keys(prng.stream_keys(roots, prng.STREAM_NET_DROP, t), 8)
    sites = [
        ((p_m, n_m), kn_pa, gray_pa) if pa else ((n_m, p_m), kn_ap, gray_ap)
        for pa in b.site_pa
    ]
    pk = b.pk
    extra = [(
        prng.stream_keys(roots, prng.STREAM_PREPARE_DELAY, t + 1), (p_m,),
        pk.prepare_delay_min, pk.prepare_delay_max + 1,
    )]
    if b.draw_crash:
        extra.append((prng.stream_keys(roots, prng.STREAM_CRASH, t), (n_m,), 0, 1_000_000))
    plans, coins = netm.lane_copy_plans(
        keys[:, :7], sites, fc, extra_drop=xdrop, delay_bound=fc.max_delay,
        extra=extra, device=dev,
    )
    rnd_delay = coins[0]
    crash_coin = None
    if b.draw_crash:
        rate = knobs.crash_rate if b.runtime_knobs else fc.crash_rate
        rate = devm.to_device(torch.from_numpy(np.asarray(rate, np.int64).reshape(-1, 1)), dev)
        crash_coin = coins[1] < rate
    if b.geometry is not None:
        plans = [
            (_pad_edges(al, (p, a) if pa else (a, p)), _pad_edges(dl, (p, a) if pa else (a, p)))
            for (al, dl), pa in zip(plans, b.site_pa)
        ]
        rnd_delay = geo.menu_pad(b.geometry, b.geom_idx, "proposers", rnd_delay, 0)
        if crash_coin is not None:
            crash_coin = geo.menu_pad(b.geometry, b.geom_idx, "nodes", crash_coin, False)
    rows_d = {}
    if rows:
        parts = [np.asarray(x, np.int32).reshape(-1) for x in rows.values()]
        flat = devm.to_device(torch.from_numpy(np.concatenate(parts)), dev)
        for (name, x), part in zip(rows.items(), torch.split(flat, [len(q) for q in parts])):
            rows_d[name] = part.reshape(np.shape(x)).bool()
    return plans, rnd_delay, crash_coin, rows_d


def _round_draws(b, roots, t: int, tab, knobs, running):
    """:func:`_draws`, or on a sharded build the coins every rank draws
    alike (replicated shapes from the replicated round): the first rank on
    a device to reach round ``t`` draws them, the others read them from
    the mesh's shared dict.

    The ranks share these tensors, so the round must never write one in
    place (no ``scatter_``, ``masked_fill_`` or ``copy_`` into a plan, a
    coin or a row): a write would change the coins of every rank that
    reads them after it.  ``tests/test_torch_sharded_sim.py`` hashes every
    shared draw when it is made and again after the run."""
    if b.comm is None:
        return _draws(b, roots, t, tab, knobs, running)
    key = ("draws", str(b.dev))
    hit = b.comm.shared.get(key)
    if hit is not None and hit[0] == t:
        return hit[1]
    out = _draws(b, roots, t, tab, knobs, running)
    b.comm.shared[key] = (t, out)
    return out


def build_engine(
    cfg: SimConfig,
    n_pend_cap: int,
    vid_cap: int = 0,
    use_kernels: bool | None = None,
    device="cuda",
    runtime_schedule: bool = False,
    runtime_knobs: bool = False,
    telemetry: bool = False,
    window_rounds: int = 0,
    geometry: geo.GeometryEnvelope | None = None,
    runtime_protocol: bool = False,
    axis_name=None,
    n_shards: int = 1,
):
    """Returns ``round_fn(root, state, tab=None, knobs=None, tele=None,
    geom=None, pknobs=None) -> state``, the unsharded round of the JAX
    engine with i.i.d. drop/dup/delay and crash faults, per-edge fault
    tables, the correlated-fault schedule (``delivery_cut`` included),
    gates (``vid_cap``) and the seeded takeover wedge.  ``round_fn.lanes``
    is the same round over a leading lane axis, which ``round_fn`` runs
    at one lane (see :func:`_lane_round`).
    ``round_fn`` consumes its ``state``: the acceptor arrays and the ack
    cube are updated in place, on the CPU as on a card.

    ``runtime_schedule=True`` takes the schedule per call as a
    ``fleet.schedule_table.ScheduleTable`` (``cfg.faults.schedule`` must
    be None) with every mask dimension live; ``runtime_knobs=True`` takes
    the i.i.d. knobs per call as a ``net.FaultKnobs`` (``cfg.faults.edges``
    must be None), draws every coin in its always-on masked form and
    refreshes the crash-coupled caches every round; ``cfg.faults.max_delay``
    then only sizes the ring.  Both are exact against the constant build
    for the same schedule and knobs, as in the JAX engine.

    ``telemetry=True`` arms the flight recorder
    (``telemetry/recorder.py``): ``round_fn(..., tele=Telemetry)``
    returns ``(state, telemetry)``, and a nonzero ``window_rounds`` adds
    the windowed plane, ``tele`` then being a ``(Telemetry,
    TelemetryWindows)`` pair, bucketed ``window_rounds`` rounds wide.
    The recorder reads the round's values and never writes into the
    state, so an armed run's decisions equal the plain run's.  Not with
    ``axis_name``; ``window_rounds`` needs ``telemetry``.

    With ``geometry`` (a ``core.geom.GeometryEnvelope``) ``cfg`` must be
    the envelope's bound (``geometry.bound_cfg``): every [A]/[P]-shaped
    array pads to the bound and the TRUE geometry arrives per call as a
    ``core.geom.Geometry`` (``geom=``).  Absent nodes are masked out of
    all I/O, timers, quorums, crash room and obligations, and every draw
    whose shape depends on the geometry is made at the true shape, so a
    padded run makes the unpadded run's decisions.  With
    ``runtime_protocol=True`` the protocol constants (retry ladders,
    backoff spans, stall patience) arrive per call as a
    ``core.geom.ProtocolKnobs`` (``pknobs=``).

    The accept store and the ack fold run the simkern CUDA kernels on a
    CUDA device and their plain versions on the CPU; ``use_kernels``
    may only confirm that (``True`` on the CPU raises: there is no CUDA
    kernel to run there).

    The sharded build: ``axis_name`` is one rank's
    ``parallel.mesh.Collectives`` and ``n_shards`` the mesh size; the
    round then runs the rank's ``[.., n_instances / n_shards]`` block at
    one lane, its instance ids global (``rank * i_loc`` on), and reduces
    JAX's global predicates over the mesh (``parallel/sharded_sim.py``
    drives it)."""
    if telemetry and axis_name is not None:
        raise ValueError(
            "telemetry is not supported on the sharded engine yet "
            "(the recorder's per-instance ledger is unsharded)"
        )
    if window_rounds and not telemetry:
        raise ValueError(
            "window_rounds arms the recorder's windowed plane; it "
            "requires telemetry=True"
        )
    dev = devm.resolve(device)
    if use_kernels is not None and use_kernels != (dev.type == "cuda"):
        raise ValueError(
            f"use_kernels={use_kernels} on {dev}: the kernels run on every "
            "CUDA device and only there; the CPU runs their plain versions"
        )

    a, i_cap = cfg.n_nodes, cfg.n_instances
    p = len(cfg.proposers)
    c = n_pend_cap
    w = cfg.assign_window
    fc = cfg.faults
    if i_cap % n_shards:
        raise ValueError(f"n_instances {i_cap} not divisible by {n_shards}")
    i_loc = i_cap // n_shards  # instances per shard ([I]-axis array size)
    if axis_name is not None:
        from tpu_paxos_torch.parallel import mesh as pmesh

        if not isinstance(axis_name, pmesh.Collectives):
            raise TypeError("axis_name must be a rank's parallel.mesh.Collectives")
        if axis_name.size != n_shards:
            raise ValueError(f"n_shards {n_shards} differs from the mesh's {axis_name.size} ranks")
    elif n_shards != 1:
        raise ValueError("n_shards > 1 needs axis_name (a rank's mesh collectives)")
    off = 0 if axis_name is None else axis_name.rank * i_loc
    if geometry is not None:
        if not isinstance(geometry, geo.GeometryEnvelope):
            raise TypeError("geometry must be a GeometryEnvelope or None")
        if a != geometry.bound_nodes or p != geometry.bound_proposers:
            raise ValueError(
                f"a geometry-padded engine must be built at the "
                f"envelope bound ({geometry.bound_nodes} nodes, "
                f"{geometry.bound_proposers} proposers); cfg has "
                f"({a}, {p}) — use geometry.bound_cfg(cfg)"
            )
    if runtime_schedule and fc.schedule is not None:
        raise ValueError(
            "runtime_schedule engines take their schedule per call "
            "(ScheduleTable); cfg.faults.schedule must be None"
        )
    if runtime_knobs and fc.edges is not None:
        raise ValueError(
            "runtime_knobs engines take their knobs per call (matrix "
            "or scalar FaultKnobs); cfg.faults.edges must be None"
        )
    pk = geo.static_protocol(cfg.protocol, stall_patience=IDLE_RESTART_ROUNDS)
    wedge_no_takeover = seeded_wedge() == "takeover"
    # Correlated-fault schedule as per-round host tables; a dimension
    # the schedule lacks is never read.  A runtime table has them all.
    comp = fltm.compile_schedule(fc.schedule, a)
    horizon = comp.horizon if comp is not None else 0
    has = {
        k: runtime_schedule or (comp is not None and getattr(comp, f"has_{k}"))
        for k in ("reach", "pause", "burst", "crash", "gray")
    }
    # Per-edge [A, A] fault tables: matrix knobs, sliced per send
    # direction (proposer->node rows pn, node->proposer columns pn) to
    # the shapes a call draws at.
    mknobs = netm.matrix_knobs(fc) if fc.edges is not None else None

    def sliced(props, n):
        if mknobs is None:
            return None, None
        return netm.edge_knobs(mknobs, props, range(n)), netm.edge_knobs(mknobs, range(n), props)

    # delivery_cut only acts where reachability masks exist.
    delivery_cut = bool(fc.delivery_cut) and has["reach"]
    draw_crash = runtime_knobs or bool(fc.crash_rate)
    # Runtime knobs or schedules (and scheduled crash points) can change
    # `crashed` without an i.i.d. draw: the crash-coupled cached blocks
    # then refresh every round.
    crash_faults = draw_crash or has["crash"]
    r_cap = min(w, i_loc)
    span = min(2 * r_cap, i_loc)
    # the seven send sites in message order: True = proposer->node [P, A]
    site_pa = [True, False, False, True, False, True, False]

    def geometry_fields(pn_np, prop_mask, node_mask):
        """The round's constants that follow the proposer -> node map:
        ``pn`` (device int64 and int32), the recorder's node -> proposer
        row gather (node a takes proposer row pn_inv[a], or the zero row
        P if no true proposer sits on it) and the broadcast fan-out."""
        pn = torch.tensor(pn_np, dtype=torch.int64, device=dev)
        pn_inv = np.full((a,), p, np.int64)
        true = np.flatnonzero(np.ones(p, bool) if prop_mask is None else prop_mask)
        pn_inv[np.asarray(pn_np)[true]] = true
        bcast = torch.ones((p, a), dtype=torch.bool, device=dev)
        if node_mask is not None:
            bcast = bcast & node_mask[None, :]
        return dict(pn=pn, pn32=pn.to(_I32), pn_inv=torch.from_numpy(pn_inv).to(dev),
                    bcast_a=bcast)

    kn_pa0, kn_ap0 = sliced(cfg.proposers, a)
    # The round shares the build's constants through this namespace.
    ctx = types.SimpleNamespace(
        a=a, p=p, i_cap=i_cap, w=w, quorum=cfg.quorum, n_true=a,
        max_crash=(a - 1) // 2, pk=pk, wedge=wedge_no_takeover,
        crash_faults=crash_faults, draw_crash=draw_crash, horizon=horizon,
        runtime_schedule=runtime_schedule, runtime_knobs=runtime_knobs,
        delivery_cut=delivery_cut, comp=comp, has=has, fc=fc,
        r_cap=r_cap, span=span,
        # global instance ids of this shard (noop encoding, high-water
        # marks, conflict spans and the decision log use global ids)
        i_loc=i_loc, off=off, comm=axis_name,
        idx=torch.arange(off, off + i_loc, dtype=_I32, device=dev),
        lidx=torch.arange(i_loc, dtype=_I32, device=dev),
        offs_w=torch.arange(w, dtype=_I32, device=dev),
        vid_cap=vid_cap, dev=dev,
        telemetry=telemetry, window_rounds=int(window_rounds),
        site_pa=site_pa,
        # the sites of each direction, as device indices: a Python list as
        # an index would copy it to the card from pageable memory, a sync
        site_dirs=[torch.tensor([k for k, pa in enumerate(site_pa) if pa == d], device=dev)
                   for d in (True, False)],
        geometry=None, geom_idx=None, node_mask=None, prop_mask=None,
        draw_nodes=a, draw_props=np.asarray(cfg.proposers), kn_pa0=kn_pa0, kn_ap0=kn_ap0,
        **geometry_fields(np.asarray(cfg.proposers), None, None),
    )
    views = {}

    def view(geom, pknobs):
        """The round's constants for one call: the build's, or under a
        geometry the dispatch's true geometry (proposer map, quorum,
        crash room, masks, the menu entry it draws at), with the call's
        protocol knobs.  Built once per distinct call."""
        if geom is None and pknobs is None:
            return ctx
        key = (
            None if geom is None else tuple(tuple(np.asarray(x).reshape(-1).tolist()) for x in geom),
            None if pknobs is None else tuple(int(x) for x in pknobs),
        )
        v = views.get(key)
        if v is not None:
            return v
        v = types.SimpleNamespace(**vars(ctx))
        if pknobs is not None:
            v.pk = geo.ProtocolKnobs(*(int(x) for x in pknobs))
        if geom is not None:
            idx = int(geom.geom_idx)
            n_m, props = geometry.menu[idx]
            node_mask = np.asarray(geom.node_mask, bool).reshape(a)
            prop_mask = np.asarray(geom.prop_mask, bool).reshape(p)
            v.geometry, v.geom_idx = geometry, idx
            v.n_true, v.quorum, v.max_crash = int(geom.n_true), int(geom.quorum), int(geom.max_crash)
            v.node_mask = torch.from_numpy(node_mask).to(dev)
            v.prop_mask = torch.from_numpy(prop_mask).to(dev)
            v.draw_nodes, v.draw_props = n_m, np.asarray(props)
            v.kn_pa0, v.kn_ap0 = sliced(props, n_m)
            vars(v).update(geometry_fields(np.asarray(geom.pn, np.int64).reshape(p), prop_mask,
                                           v.node_mask))
        views[key] = v
        return v

    def check_call(tab, knobs, tele, geom, pknobs):
        if runtime_schedule and tab is None:
            raise TypeError(
                "this engine was built with runtime_schedule=True; "
                "round_fn needs a ScheduleTable argument"
            )
        if runtime_knobs and knobs is None:
            raise TypeError(
                "this engine was built with runtime_knobs=True; "
                "round_fn needs a FaultKnobs argument"
            )
        if telemetry and tele is None:
            raise TypeError(
                "this engine was built with telemetry=True; round_fn "
                "needs a Telemetry accumulator argument"
            )
        if (geometry is not None) != (geom is not None):
            raise TypeError(
                "a GeometryEnvelope engine takes its Geometry per "
                "call (round_fn geom=); a bound-free engine takes "
                "none"
            )
        if runtime_protocol and pknobs is None:
            raise TypeError(
                "this engine was built with runtime_protocol=True; "
                "round_fn needs a ProtocolKnobs argument"
            )

    def lanes_fn(roots, st: SimState, t: int, tab=None, knobs=None, running=None, tele=None,
                 geom=None, pknobs=None):
        """One round of ``L`` lanes: every leaf of ``st`` has a leading
        lane axis, ``roots`` is ``[L, 2]`` (``prng.root_keys``), ``t`` the
        round every running lane is at, ``tab``/``knobs`` the lane-stacked
        schedule tables and knobs of a runtime build, ``running`` an
        ``[L]`` bool array (None: every lane runs), ``tele`` the
        lane-stacked recorder of an armed build, and ``geom``/``pknobs``
        the one geometry and protocol of every lane (padded and
        runtime-protocol builds).  A lane that is not running comes back
        exactly as it was given, as a finished lane's carry stays in a
        batched ``while_loop``.  Returns the state, or ``(state, tele)``
        when armed."""
        check_call(tab, knobs, tele, geom, pknobs)
        if axis_name is not None and (st.t.shape[0] != 1 or running is not None):
            raise ValueError("a sharded engine runs one lane, every round")
        for name in ("pend", "gate"):
            width = getattr(st.prop, name).shape[-1]
            if width != c + w:
                raise ValueError(
                    f"{name} rows are {width} wide; expected {c} + "
                    f"assign_window {w} padding"
                )
        counters.add("rounds")
        return _lane_round(view(geom, pknobs), roots, st, t, tab, knobs, running,
                           tele if telemetry else None)

    def round_fn(root, st: SimState, tab=None, knobs=None, tele=None, geom=None, pknobs=None):
        """One round of one run: :func:`_lane_round` at one lane."""
        if tab is not None:
            tab = _one_lane(tab)
        if knobs is not None:
            knobs = _one_lane(knobs)
        roots = np.asarray([root], np.uint64)
        tl = None if tele is None else lanes_view(tele)
        return lane_of(lanes_fn(roots, lanes_view(st), int(st.t), tab, knobs, tele=tl,
                                geom=geom, pknobs=pknobs), 0)

    def dormant(st: SimState, t: int, tab=None, knobs=None, running=None, geom=None, pknobs=None):
        """``[L]`` bool on the device, or None where no lane qualifies:
        the running lanes on which round ``t`` and every later round can
        depend on nothing but the state.  Every true proposer has crashed
        (so no timer, send or decision acts), the calendars are empty (so
        nothing arrives, whatever the slot), no crash can come (the
        lane's crash rate is 0 or its crash room is spent) and the
        schedule is past its horizon.  Where one such round changes
        nothing, no later round does.  Never on a sharded build: its loop
        stops on the global ``done`` alone, as JAX's."""
        if axis_name is not None:
            return None
        b = view(geom, pknobs)
        lanes = st.t.shape[0]
        healed = t >= (np.asarray(tab.horizon) if runtime_schedule else np.full(lanes, horizon))
        if running is not None:
            healed = healed & running
        if not healed.any():
            return None
        gone = st.crashed[:, b.pn]
        if b.prop_mask is not None:
            gone = gone | ~b.prop_mask
        out = gone.all(dim=1) & devm.to_device(torch.from_numpy(healed), dev)
        for buf in st.net:
            empty = ~buf if buf.dtype == torch.bool else buf == bal.NONE
            out &= empty.reshape(lanes, -1).all(dim=1)
        if draw_crash:
            rate = knobs.crash_rate if runtime_knobs else fc.crash_rate
            no_rate = torch.from_numpy(np.broadcast_to(np.asarray(rate) == 0, (lanes,)).copy())
            out &= devm.to_device(no_rate, dev) | (_sum32(st.crashed, dim=1) >= b.max_crash)
        return out

    round_fn.lanes = lanes_fn
    round_fn.dormant = dormant
    round_fn.window_rounds = int(window_rounds) if telemetry else None
    return round_fn


def _lane_round(b, roots, st: SimState, t: int, tab, knobs, running, tele=None):
    """The round over a leading lane axis ``L``.  The JAX engine's
    ``lax.cond`` blocks are host branches here, as in a single run; under
    ``jax.vmap`` each is a per-lane select of both branches, so the port
    takes a block when any lane's predicate holds and leaves every lane
    whose own predicate is false as the false branch would: each block
    below is the identity on such a lane by its masks (stated at the
    block), or selects per lane.  Where JAX picks a fast or a general
    form by a predicate (``_assign``'s prefix test, ``_requeue``'s
    contiguity and width tests) the fast form runs only if every lane's
    (on a sharded build, every shard's) predicate holds; the general form
    equals it wherever it does.  A sharded build runs one lane and takes
    each block JAX takes on a global predicate on the value reduced over
    the mesh (:func:`_global_max`), so every shard runs the same blocks.

    With ``tele`` (an armed build) the round also returns the recorder
    updated by :func:`_record`, frozen with the state on lanes that are
    not running."""
    a, p, pn = b.a, b.p, b.pn
    lanes = st.t.shape[0]
    s = st.net.prep_req.shape[1]
    slot = t % s
    ar = netm.NetBuffers(*[x[:, slot] for x in st.net])
    net = netm.clear_slot(st.net, slot)
    plans, rnd_delay, crash_coin, rows = _round_draws(b, roots, t, tab, knobs, running)
    run_d = rows.get("run")  # [L] bool, None when every lane runs

    # I/O-alive mask: crashed or currently paused nodes neither
    # send, receive nor act on timers this round; excusals stay on
    # `crashed` alone (a paused node's obligations are deferred).
    alive_a = ~st.crashed  # [L, A]
    if b.node_mask is not None:
        # absent nodes: dead for all I/O and timers, and excused from
        # every obligation (the round's `dead` masks below)
        alive_a = alive_a & b.node_mask
    if "pause" in rows:
        alive_a = alive_a & ~rows["pause"]
    prop_alive = alive_a[:, pn]  # [L, P]
    if b.prop_mask is not None:
        # pad proposer slots read node 0 through pn's padding: masked out
        # so they never start, resend, restart or take over
        prop_alive = prop_alive & b.prop_mask
    # Per-edge reachability cuts, ANDed into every send mask (and,
    # with delivery_cut, into this round's arrivals).
    reach = rows.get("reach")
    cut_pa = reach[:, pn] if reach is not None else None  # [L, P, A]
    cut_ap = reach[:, :, pn] if reach is not None else None  # [L, A, P]
    if b.delivery_cut:
        ar = netm.delivery_mask(ar, cut_pa, cut_ap)

    # ---------------- acceptor side ----------------
    acc = st.acc
    learned = st.learned

    # PREPARE arrivals (crashed acceptors ignore everything).
    preq = torch.where(alive_a[:, None, :], ar.prep_req, bal.NONE)  # [L, P, A]
    grant = preq > acc.promised[:, None, :]  # strict >, ref :866
    rej_prep = (preq != bal.NONE) & (preq < acc.promised[:, None, :])
    max_seen = torch.maximum(acc.max_seen, preq.amax(dim=1))
    promised = torch.maximum(
        acc.promised, torch.where(grant, preq, bal.NONE).amax(dim=1)
    )

    # ACCEPT arrivals: batch content is the sending proposer's
    # cur_batch, valid iff its ballot still equals the edge ballot.
    apres = torch.where(alive_a[:, None, :], ar.acc_req, bal.NONE)  # [L, P, A]
    abal = st.prop.ballot  # [L, P]
    abat = st.prop.cur_batch  # [L, P, I]
    has_acc = (
        (apres != bal.NONE) & (apres == abal[:, :, None])
        & (st.prop.mode == PREPARED)[:, :, None]
    )
    max_seen = torch.maximum(max_seen, apres.amax(dim=1))
    elig = has_acc & (abal[:, :, None] >= promised[:, None, :])  # >=, ref :1366
    rej_acc = has_acc & ~elig
    # the in-place store never touches a lane that is not running; on a
    # lane with no eligible accept it stores nothing
    elig_k = elig if run_d is None else elig & run_d[:, None, None]
    any_acc_arr = _any(elig_k)
    acc_ballot, acc_vid = acc.acc_ballot, acc.acc_vid
    if any_acc_arr:
        acc_ballot, acc_vid = sk.store_accepts(
            acc_ballot, acc_vid, learned, abat, abal, elig_k
        )

    # COMMIT arrivals -> learner state (ref OnCommit); the identity on a
    # lane with no arrival (every increment is masked).
    cpres = ar.com_pres & alive_a[:, None, :]  # [L, P, A]
    cbat = st.prop.commit_vid  # [L, P, I]
    any_com_arr = _any(cpres)
    if any_com_arr:
        inc_v = torch.full_like(learned, _NEG)
        for pi in range(p):
            incp = cpres[:, pi, :, None] & (cbat[:, pi] != val.NONE)[:, None, :]
            inc_v = torch.maximum(
                inc_v, torch.where(incp, cbat[:, pi, None, :], _NEG)
            )
        learned = torch.where(
            (inc_v != _NEG) & (learned == val.NONE), inc_v, learned
        )

    acc = AcceptorState(promised, max_seen, acc_ballot, acc_vid)
    rec = {} if tele is not None else None
    new = _proposer_round(
        b, st, t, net, ar, plans, rnd_delay, crash_coin, alive_a,
        prop_alive, acc, learned, preq, grant, rej_prep, rej_acc,
        abal, elig, cpres, any_com_arr, cut_pa, cut_ap, rows, run_d, rec,
    )
    if tele is not None:
        new_tele = _record(b, st, new, rec, tele, t)
    if run_d is not None:
        new = _freeze(st, new, run_d)
        if tele is not None:
            new_tele = _freeze(tele, new_tele, run_d)
    return new if tele is None else (new, new_tele)


def _assign(b, pr, st, learned, cur_batch, live, qvid, can_assign, lane_pred):
    """New-value assignment for every PREPARED proposer: gate-ready
    queue entries (first-fit) onto the lowest free instances of the
    open tail (ref unproposed_instance_ids_.Next).  ``lane_pred [L]`` is
    the block's predicate per lane; a lane where it is false takes
    nothing and keeps its queue and head.  Returns (cur_batch,
    own_assign, pend, head, added) with ``added [L, P]`` the proposers
    that took a value (on a sharded build, on any shard)."""
    p, w, idx = b.p, b.w, b.idx
    own_assign, pend, head = pr.own_assign, pr.pend, pr.head
    lanes = head.shape[0]
    if b.vid_cap:
        # chosen-vid membership bitmap per lane for the gate test;
        # invalid indices land in a spill slot that is cut off
        cv = st.met.chosen_vid
        slot = torch.where((cv >= 0) & (cv < b.vid_cap), cv, b.vid_cap).long()
        chosen_mask = torch.zeros((lanes, b.vid_cap + 1), dtype=torch.bool, device=cv.device)
        chosen_mask.scatter_(1, slot, torch.ones_like(slot, dtype=torch.bool))
        g = _window_read(pr.gate, head, w)
        ok = live & _gate_satisfied(g, chosen_mask[:, : b.vid_cap])
    else:
        ok = live
    activity = (
        (learned[:, b.pn] != val.NONE) | (cur_batch != val.NONE)
        | (own_assign != val.NONE)
    )
    # Free instances are the contiguous suffix above the activity
    # high-water mark, so ranks are closed-form.  The frontier is
    # shard-local: each shard first-fits its queue onto its own lowest
    # free instances.
    hi2 = torch.where(activity, idx, -1).amax(dim=2)  # [L, P]
    hi2l = torch.clamp(hi2, min=b.off - 1)  # the sentinel clamped into the shard
    free = idx > hi2l[..., None]
    free_rank = idx - hi2l[..., None] - 1
    n_free = (b.off + b.i_loc - 1) - hi2l
    ok_rank = torch.cumsum(ok.to(_I32), dim=2, dtype=_I32) - 1
    k = torch.minimum(_sum32(ok, dim=2), n_free)
    k = torch.where(can_assign & lane_pred[:, None], k, 0)
    take_q = ok & (ok_rank < k[..., None])
    takev = free & (free_rank < k[..., None])
    start = torch.clamp(hi2l + 1 - b.off, 0, b.i_loc)
    added = k > 0
    # JAX's any_assign and added (gany of k > 0, :1227 and :1301) and its
    # prefix vote (gall, :1241) in one read: the O(W) rank scatter equals
    # the prefix read wherever the taken entries are a prefix, so one
    # lane (or shard) off the prefix sends every lane through it
    scatter = (take_q != (b.offs_w < k[..., None])).any(dim=2)
    g = _global_max(b, {"added": added, "scatter": scatter})
    added = _on_dev(b, added, g["added"])
    if g["added"].any():
        if not g["scatter"].any():
            by_rank = torch.where(take_q, qvid, val.NONE)
        else:
            # untaken slots go to a spill column
            rank_pos = torch.where(take_q, ok_rank, w).long()
            by_rank = torch.full((lanes, p, w + 1), val.NONE, dtype=_I32, device=qvid.device)
            by_rank.scatter_(2, rank_pos, qvid)
            by_rank = by_rank[..., :w]
        # place the ranked vids at the contiguous free window starting
        # at `start` (in [0, i_loc], so nothing clamps)
        rel = b.lidx - start[..., None]
        inside = (rel >= 0) & (rel < w)
        newv = torch.where(
            inside, by_rank.gather(2, rel.clamp(0, w - 1).long()), val.NONE
        )
        cur_batch = torch.where(takev, newv, cur_batch)
        own_assign = torch.where(takev, newv, own_assign)
    # consume taken entries in place (a masked window write-back), then
    # advance head over the leading consumed run
    new_win = torch.where(take_q, val.NONE, qvid)
    pend = _window_write(pend, new_win, head)
    lead_dead = (
        (head[..., None] + b.offs_w) < pr.tail[..., None]
    ) & (new_win == val.NONE)
    adv = torch.cumprod(lead_dead.to(_I32), dim=2).sum(dim=2).to(_I32)
    head = head + torch.where(lane_pred[:, None], adv, 0)
    return cur_batch, own_assign, pend, head, added


def _requeue(b, pend, own_assign, ptail, conflict, lane_pred):
    """Conflict re-proposal: append up to ``r_cap`` conflicted own
    values per proposer, in instance order, at the queue tail.  A lane
    whose ``lane_pred`` is false keeps its queue.  Returns (pend, nreq,
    own_assign)."""
    p, i_cap, r_cap, span, idx = b.p, b.i_cap, b.r_cap, b.span, b.idx
    lanes = conflict.shape[0]
    idxb = idx.expand(conflict.shape)
    has_c = conflict.any(dim=2)
    ncf = _sum32(conflict, dim=2)
    cmin = torch.where(conflict, idxb, _I32_MAX).amin(dim=2)
    cmax = torch.where(conflict, idxb, -1).amax(dim=2)
    nreq = torch.clamp(ncf, max=r_cap)
    # Each form below gives the first nreq conflicted values in instance
    # order; the padded slice and the windowed sort only where every
    # lane's (on a sharded build, every shard's) conflicts fit them:
    # JAX's two ``gall`` votes (:1541 and :1566), read in one go.
    spread = cmax - cmin
    g = _global_max(b, {"split": has_c & (ncf != spread + 1), "wide": has_c & (spread >= span)})
    contig, narrow = not g["split"].any(), not g["wide"].any()
    if contig:
        # fully-conflicted contiguous runs: a padded slice at cmin
        startc = torch.where(has_c, cmin - b.off, 0)
        rowpad = torch.cat(
            [own_assign, torch.full((lanes, p, r_cap), val.NONE, dtype=_I32, device=own_assign.device)],
            dim=2,
        )
        block = _window_read(rowpad, startc, r_cap)
        take_req = conflict & (idxb < (cmin + nreq)[..., None])
    else:
        req_rank = torch.cumsum(conflict.to(_I32), dim=2, dtype=_I32) - 1
        take_req = conflict & (req_rank < r_cap)
        if narrow:
            startn = torch.clamp(torch.where(has_c, cmin - b.off, 0), 0, b.i_loc - span)
            win_conf = _window_read(conflict, startn, span)
            win_vids = _window_read(own_assign, startn, span)
            keys = torch.where(
                win_conf, torch.arange(span, dtype=_I32, device=idx.device), span
            )
        else:
            keys = torch.where(conflict, idxb, i_cap)
            win_vids = own_assign
        # conflict keys are unique and sort ahead of the sentinel, so
        # the first nreq positions equal JAX's unstable sort
        order = torch.sort(keys, dim=2, stable=True).indices
        block = win_vids.gather(2, order)[..., :r_cap]
    ar_r = torch.arange(r_cap, dtype=_I32, device=idx.device)
    req_block = torch.where(ar_r < nreq[..., None], block, val.NONE)
    req_block = torch.where(lane_pred[:, None, None], req_block, _window_read(pend, ptail, r_cap))
    pend = _window_write(pend, req_block, ptail)
    own_assign = torch.where(take_req, val.NONE, own_assign)
    return pend, nreq, own_assign


def _proposer_round(
    b, st, t, net, ar, plans, rnd_delay, crash_coin, alive_a, prop_alive,
    acc, learned, preq, grant, rej_prep, rej_acc, abal, elig, cpres,
    any_com_arr, cut_pa, cut_ap, rows, run_d, rec=None,
):
    """The proposer half of the round, the network writes, crash
    injection and quiescence (``tpu_paxos/core/sim.py:1022-2039``), over
    the lane axis.  ``cut_pa``/``cut_ap`` are the round's reachability
    masks (None without them) and ``rows`` its schedule rows.  An armed
    build passes a dict ``rec`` that collects what the recorder reads
    beyond the new state (:func:`_record`)."""
    a, p, pn, pk, quorum = b.a, b.p, b.pn, b.pk, b.quorum
    lanes = st.t.shape[0]
    pr = st.prop
    # A->P arrivals are masked on both ends.
    rx_p = alive_a[:, :, None] & prop_alive[:, None, :]  # [L, A, P]
    # REJECT arrivals only update max-ballot-seen (ref OnReject).
    rejs = torch.where(rx_p, ar.rej, bal.NONE)
    pmax_seen = torch.maximum(pr.pmax_seen, rejs.amax(dim=1))

    # PREPARE_REPLY arrivals: promises + adoption merge.
    pecho = torch.where(rx_p, ar.prep_echo, bal.NONE)  # [L, A, P]
    match = (pecho == pr.ballot[:, None, :]) & (pr.mode[:, None, :] == PREPARING)
    match_pa = match.transpose(1, 2)  # [L, P, A]
    promises2 = pr.promises | match_pa
    adopted_b, adopted_v = pr.adopted_b, pr.adopted_v
    any_match = _any(match)
    if any_match:
        # accepted-state snapshot at delivery, committed values at
        # COMMITTED_BALLOT (ref FilterAcceptedValues); a lane with no
        # reply takes nothing
        is_l = learned != val.NONE
        snap_b = torch.where(is_l, COMMITTED_BALLOT, acc.acc_ballot)
        snap_v = torch.where(is_l, learned, acc.acc_vid)
        rep_mask = match_pa[..., None]  # [L, P, A, 1]
        best_b = torch.where(rep_mask, snap_b[:, None], bal.NONE).amax(dim=2)
        best_v = torch.where(
            rep_mask & (snap_b[:, None] == best_b[:, :, None, :]), snap_v[:, None], _NEG
        ).amax(dim=2)
        take = (best_b != bal.NONE) & (best_b > adopted_b)
        adopted_b = torch.where(take, best_b, adopted_b)
        adopted_v = torch.where(take, best_v, adopted_v)

    # Phase-1 quorum -> PREPARED; build the accept batch skeleton
    # (masked per proposer by now_prepared).
    n_prom = promises2.sum(dim=2)
    now_prepared = (pr.mode == PREPARING) & (n_prom >= quorum) & prop_alive
    any_p1 = _any(now_prepared)
    mode = torch.where(now_prepared, PREPARED, pr.mode)
    # New-value assignment (only on rounds with a live window entry).
    can_assign = (mode == PREPARED) & prop_alive
    qvid, live = _assignable_window(pr.pend, pr.gate, pr.head, pr.tail, None, b.w)
    win_l = _lane_any(live & can_assign[..., None])
    cur_batch, acks = pr.cur_batch, pr.acks
    if any_p1:
        idx = b.idx
        committed_p = learned[:, pn] != val.NONE  # [L, P, I]
        use_adopt = ~committed_p & (adopted_b != bal.NONE)
        covered0 = committed_p | use_adopt
        hi_cov = torch.where(covered0, idx, -1).amax(dim=2)
    # JAX's window predicate (gany, :1182) and, on a phase-1 round, its
    # hole-fill frontier (gmax, :1136) in one read
    parts = {"win": win_l}
    if any_p1:
        parts["hi"] = hi_cov
    g = _global_max(b, parts)
    any_window = bool(g["win"].any())
    win_l = _on_dev(b, win_l, g["win"])
    if any_p1:
        # the frontier is the global one once every proposer's queue on
        # this shard is drained (crashed proposers excused): until then
        # the space below it is this shard's capacity, not holes
        drained = (
            (pr.head >= pr.tail) & (pr.own_assign == val.NONE).all(dim=2)
        ) | st.crashed[:, pn]
        hi_cov = torch.where(drained.all(dim=1, keepdim=True),
                             _on_dev(b, hi_cov, g["hi"]).to(_I32), hi_cov)
    if any_p1:
        below = idx <= hi_cov[..., None]
        noop_fill = below & ~covered0
        use_own = ~below & (pr.own_assign != val.NONE)
        batch0 = torch.where(
            use_adopt,
            adopted_v,
            torch.where(
                noop_fill,
                val.noop_vid(idx[None], b.pn32[:, None], b.i_cap),
                torch.where(use_own, pr.own_assign, val.NONE),
            ),
        )
        batch0 = torch.where(committed_p, val.NONE, batch0)
        cur_batch = torch.where(now_prepared[..., None], batch0, cur_batch)
        acks = torch.where(
            now_prepared[..., None, None], torch.zeros((), dtype=torch.int8, device=acks.device), acks
        )
    acc_retries = torch.where(now_prepared, pk.accept_retry_count, pr.acc_retries)
    acc_deadline = torch.where(
        now_prepared, t + 1 + pk.accept_retry_timeout, pr.acc_deadline
    )

    own_assign, pend, head = pr.own_assign, pr.pend, pr.head
    added = torch.zeros((lanes, p), dtype=torch.bool, device=mode.device)
    if any_window:
        # added [L, P] -> (re)send accepts
        cur_batch, own_assign, pend, head, added = _assign(
            b, pr, st, learned, cur_batch, live, qvid, can_assign, win_l
        )

    # ACCEPT_REPLY arrivals: per-instance acks derived at delivery.
    aecho = torch.where(rx_p, ar.acc_echo, bal.NONE)  # [L, A, P]
    amatch = (aecho == pr.ballot[:, None, :]) & (mode[:, None, :] == PREPARED)
    if run_d is not None:
        amatch = amatch & run_d[:, None, None]  # the fold never touches a finished lane
    echo_l = _lane_any(amatch)
    any_echo = _any(echo_l)
    commit_vid = pr.commit_vid
    mvid, mround, mballot = st.met.chosen_vid, st.met.chosen_round, st.met.chosen_ballot
    newly = None
    if any_echo:
        acks, n_ack = sk.accum_acks(
            acks, cur_batch, acc.acc_ballot, acc.acc_vid, learned, pr.ballot,
            amatch.transpose(1, 2).contiguous(),
        )
        # a lane with no echo decides nothing this round
        inst_chosen = (cur_batch != val.NONE) & (n_ack >= quorum)
        newly = (
            inst_chosen & (commit_vid == val.NONE) & prop_alive[..., None]
            & echo_l[:, None, None]
        )
        if b.wedge:
            # seeded-wedge build: an already-chosen instance is never
            # re-committed
            newly = newly & (mvid == val.NONE)[:, None]
        commit_vid = torch.where(newly, cur_batch, commit_vid)
        any_new = newly.any(dim=1) & (mvid == val.NONE)  # [L, I]
        new_v = torch.where(newly, cur_batch, _NEG).amax(dim=1)
        new_b = torch.where(newly, pr.ballot[..., None], _NEG).amax(dim=1)
        mvid = torch.where(any_new, new_v, mvid)
        mround = torch.where(any_new, t, mround)
        mballot = torch.where(any_new, new_b, mballot)
    met = st.met._replace(chosen_vid=mvid, chosen_round=mround, chosen_ballot=mballot)
    if rec is not None:
        # the admission stamp reads the batch the ack fold judged, before
        # the mode ladder below clears it
        rec["adm_any"] = (cur_batch != val.NONE).any(dim=1)  # [L, I]

    # COMMIT_REPLY arrivals: presence; per-instance ack by learned match.
    crep = ar.com_rep & rx_p  # [L, A, P]
    commit_acked, commit_wait = pr.commit_acked, pr.commit_wait
    crep_l = None if b.crash_faults else _lane_any(crep)
    fresh = None
    if b.crash_faults or _any(crep_l):
        commit_acked = commit_acked | (
            crep.transpose(1, 2)[..., None]
            & (commit_vid != val.NONE)[:, :, None, :]
            & (learned[:, None] == commit_vid[:, :, None, :])
        )
        excused = st.crashed if b.node_mask is None else st.crashed | ~b.node_mask
        fresh = (
            (commit_vid != val.NONE)
            & ~(commit_acked | excused[:, None, :, None]).all(dim=2)
        ).any(dim=2)  # [L, P]

    # Commit TAKEOVER on stall-threshold rounds (see the JAX module);
    # masked per proposer.
    take_commit = (pr.mode == PREPARED) & (pr.stall >= pk.stall_patience) & prop_alive
    if b.wedge:
        take_commit = torch.zeros_like(take_commit)
    took = None
    if _any(take_commit):
        learned_pn = learned[:, pn]
        taken = (
            take_commit[..., None] & (learned_pn != val.NONE) & (commit_vid == val.NONE)
        )
        commit_vid = torch.where(taken, learned_pn, commit_vid)
        took = taken.any(dim=2)
    # A fresh decision is by construction not fully acked yet.
    if newly is not None:
        any_newly = newly.any(dim=2)
    else:
        any_newly = torch.zeros((lanes, p), dtype=torch.bool, device=mode.device)

    # Conflict re-proposal + own-value completion (ref OnCommit), and the
    # accept deadline's outstanding scan (its inputs are final here).
    learned_p = learned[:, pn]
    own_has2 = own_assign != val.NONE
    conflict = own_has2 & (learned_p != val.NONE) & (learned_p != own_assign)
    own_done = own_has2 & (learned_p == own_assign)
    ddl_hit = (mode == PREPARED) & (t >= acc_deadline) & prop_alive
    any_ddl = _any(ddl_hit)
    outstanding = None
    if any_ddl:
        outstanding = (
            (cur_batch != val.NONE) & (commit_vid == val.NONE)
            & (learned[:, pn] == val.NONE)
        ).any(dim=2)  # [L, P]
    # one read (on a sharded build, one collective) for JAX's gany sites
    # at :1406 (the commit-ack flag), :1462 (the takeover), :1475 (fresh
    # decisions), :1492 (completions), :1514 (conflicts), :1664
    # (outstanding accepts) and :1752 (the accept send's batch test,
    # taken before the restart clears: a cleared proposer sends nothing)
    conf_l = _lane_any(conflict)
    batch_l = (cur_batch != val.NONE).any(dim=2)
    parts = {
        "newly": any_newly, "own_done": _lane_any(own_done), "conflict": conf_l,
        "batch": batch_l,
    }
    for name, x in (("fresh", fresh), ("took", took), ("outstanding", outstanding)):
        if x is not None:
            parts[name] = x
    g = _global_max(b, parts)
    if fresh is not None:
        fresh = _on_dev(b, fresh, g["fresh"])
        # a lane without a reply keeps its cached flag
        commit_wait = fresh if crep_l is None else torch.where(crep_l[:, None], fresh, commit_wait)
    if took is not None:
        commit_wait = commit_wait | _on_dev(b, took, g["took"])
    any_newly = _on_dev(b, any_newly, g["newly"])
    any_own_done = bool(g["own_done"].any())
    any_conflict = bool(g["conflict"].any())
    conf_l = _on_dev(b, conf_l, g["conflict"])
    if outstanding is not None:
        outstanding = _on_dev(b, outstanding, g["outstanding"])
    batch_l = _on_dev(b, batch_l, g["batch"])
    commit_wait = commit_wait | any_newly
    resend_c = (t >= pr.commit_deadline) & commit_wait
    send_commit = (any_newly | resend_c | (take_commit & commit_wait)) & prop_alive
    commit_deadline = torch.where(
        send_commit, t + 1 + pk.commit_retry_timeout, pr.commit_deadline
    )

    if any_own_done:
        own_assign = torch.where(own_done, val.NONE, own_assign)
    nreq = torch.zeros((lanes, p), dtype=_I32, device=mode.device)
    if any_conflict:
        pend, nreq, own_assign = _requeue(b, pend, own_assign, pr.tail, conflict, conf_l)
    gate = pr.gate
    tail = pr.tail + nreq

    # ---------------- timers / mode ladder ----------------
    pdl = (mode == PREPARING) & (t >= pr.prep_deadline) & prop_alive
    resend_prep = pdl & (pr.prep_retries > 1)
    restart_p = pdl & (pr.prep_retries <= 1)
    prep_retries = torch.where(resend_prep, pr.prep_retries - 1, pr.prep_retries)
    prep_deadline = torch.where(
        resend_prep, t + 1 + pk.prepare_retry_timeout, pr.prep_deadline
    )
    adl = ddl_hit & outstanding if any_ddl else ddl_hit
    resend_acc = adl & (acc_retries > 1)
    acc_fail = adl & (acc_retries <= 1)
    acc_retries = torch.where(resend_acc, acc_retries - 1, acc_retries)
    idle_restart = (mode == PREPARED) & (pr.stall >= pk.stall_patience) & prop_alive
    do_restart = restart_p | acc_fail | idle_restart
    delay_until = torch.where(do_restart, t + 1 + rnd_delay, pr.delay_until)
    mode = torch.where(do_restart, DELAY, mode)
    promises2 = promises2 & ~do_restart[..., None]

    # DELAY -> send prepare with a ballot bumped past everything seen.
    start_prep = (mode == DELAY) & (t >= delay_until) & prop_alive
    ncount, nballot = bal.bump_past(
        pr.count, b.pn32, torch.maximum(pmax_seen, pr.ballot)
    )
    count = torch.where(start_prep, ncount, pr.count)
    ballot = torch.where(start_prep, nballot, pr.ballot)
    mode = torch.where(start_prep, PREPARING, mode)
    prep_retries = torch.where(start_prep, pk.prepare_retry_count, prep_retries)
    prep_deadline = torch.where(
        start_prep, t + 1 + pk.prepare_retry_timeout, prep_deadline
    )
    promises2 = promises2 & ~start_prep[..., None]
    any_reset = _any(do_restart | start_prep)
    if any_reset:
        both = (do_restart | start_prep)[..., None]
        adopted_b = torch.where(both, bal.NONE, adopted_b)
        adopted_v = torch.where(both, val.NONE, adopted_v)
        cur_batch = torch.where(do_restart[..., None], val.NONE, cur_batch)
        acks = torch.where(
            do_restart[..., None, None], torch.zeros((), dtype=torch.int8, device=acks.device), acks
        )

    send_prep = start_prep | resend_prep
    want_acc_send = now_prepared | added | resend_acc
    send_accept = want_acc_send & ~do_restart & batch_l

    # ---------------- network writes ----------------
    # Every send mask passes through the reachability cut; the message
    # counters below stay pre-fault.
    def cpa(m):  # [L, P, A] proposer->node send mask through the cuts
        return m if cut_pa is None else m & cut_pa

    def cap(m):  # [L, A, P] node->proposer send mask through the cuts
        return m if cut_ap is None else m & cut_ap

    bcast_a = b.bcast_a
    (al0, dl0), (al1, dl1), (al2, dl2), (al3, dl3), (al4, dl4), (al5, dl5), (al6, dl6) = plans
    send_rep = grant.transpose(1, 2)  # [L, A, P]
    send_rej = (rej_prep | rej_acc).transpose(1, 2)
    send_arep = elig.transpose(1, 2)  # [L, A, P] reply whenever ballot >= promised
    send_crep = cpres.transpose(1, 2)  # [L, A, P]
    # the seven send masks in message order, before and after the cuts
    pre = [
        send_prep[..., None] & bcast_a, send_rep, send_rej,
        send_accept[..., None] & bcast_a, send_arep,
        send_commit[..., None] & bcast_a, send_crep,
    ]
    post = [cpa(m) if pa else cap(m) for m, pa in zip(pre, b.site_pa)]
    if rec is not None:
        rec["sites"] = [(al_, dl_, m, m0) for (al_, dl_), m, m0 in zip(plans, post, pre)]
    net = netm.NetBuffers(
        prep_req=netm.write_ballot(net.prep_req, t, al0, dl0, ballot[..., None], post[0]),
        prep_echo=netm.write_ballot(net.prep_echo, t, al1, dl1, preq.transpose(1, 2), post[1]),
        rej=netm.write_ballot(
            net.rej, t, al2, dl2, acc.max_seen[..., None].expand(lanes, a, p), post[2]
        ),
        acc_req=netm.write_ballot(net.acc_req, t, al3, dl3, ballot[..., None], post[3]),
        acc_echo=netm.write_ballot(
            net.acc_echo, t, al4, dl4, abal[:, None, :].expand(lanes, a, p), post[4]
        ),
        com_pres=netm.write_flag(net.com_pres, t, al5, dl5, post[5]),
        com_rep=netm.write_flag(net.com_rep, t, al6, dl6, post[6]),
    )
    # broadcast fan-out counts the TRUE node set under a geometry
    na = b.n_true
    msgs = met.msgs + torch.stack([
        send_prep.sum(dim=1) * na, send_rep.sum(dim=(1, 2)), send_rej.sum(dim=(1, 2)),
        send_accept.sum(dim=1) * na, send_arep.sum(dim=(1, 2)), send_commit.sum(dim=1) * na,
        send_crep.sum(dim=(1, 2)),
    ], dim=1).to(_I32)
    met = met._replace(msgs=msgs)

    # ---------------- crash injection ----------------
    crashed = st.crashed
    if "crash" in rows:
        # scheduled crash points apply before the i.i.d. draw, so its
        # minority-cap room accounts for them
        crashed = crashed | rows["crash"]
    if b.draw_crash:
        want = crash_coin & ~crashed
        room = b.max_crash - _sum32(crashed, dim=1)
        allow = torch.cumsum(want.to(_I32), dim=1, dtype=_I32) <= room[:, None]
        crashed = crashed | (want & allow)

    # ---------------- quiescence ----------------
    # The cached counts are recomputed on a round where any lane's may
    # have changed: on the others they equal the cache.
    palive2 = (~crashed)[:, pn]
    if b.prop_mask is not None:
        palive2 = palive2 & b.prop_mask
    # obligation excusal: crashed nodes and, under a geometry, absent ones
    dead2 = crashed if b.node_mask is None else crashed | ~b.node_mask
    q_change = (
        any_com_arr or any_echo or any_p1 or any_window or any_reset
        or any_own_done or any_conflict or t == 0
    )
    if b.crash_faults or q_change:
        inflight = (cur_batch != val.NONE) & (met.chosen_vid[:, None] == val.NONE)
        sums = torch.cat([
            _sum32(met.chosen_vid != val.NONE, dim=1)[:, None],
            _sum32(learned != val.NONE, dim=2),  # [L, A]
            _sum32(inflight, dim=2),  # [L, P]
            (head != tail).to(_I32),  # [L, P]
            _sum32(own_assign != val.NONE, dim=2),  # [L, P]
        ], dim=1)
        hmax = torch.where(met.chosen_vid != val.NONE, b.idx, -1).amax(dim=1)
        sums, hmax = _global_counts(b, sums, hmax)
    else:
        sums, hmax = st.qsums, st.qhmax
    n_chosen = sums[:, 0]
    n_learned = sums[:, 1:1 + a]
    inflight_n = sums[:, 1 + a:1 + a + p]
    q_pending = sums[:, 1 + a + p:1 + a + 2 * p]
    own_n = sums[:, 1 + a + 2 * p:1 + a + 3 * p]
    q_empty = ~(palive2 & (q_pending > 0)).any(dim=1)
    own_none = ~(palive2 & (own_n > 0)).any(dim=1)
    contiguous = n_chosen == hmax + 1
    learned_ok = ((n_learned == hmax[:, None] + 1) | dead2).all(dim=1)
    done = q_empty & own_none & contiguous & learned_ok & (t > 0)
    if b.runtime_schedule:
        # heal-then-converge with each lane's own horizon
        done = done & rows["heal"]
    elif b.horizon:
        # heal-then-converge: never quiescent before the last heal
        done = done & (t >= b.horizon)
    unresolved = ~(contiguous & learned_ok)
    idle_now = (
        (mode == PREPARED) & (inflight_n == 0) & ~commit_wait
        & (q_pending == 0) & (own_n == 0) & palive2
    )
    stall = torch.where(idle_now & (unresolved & ~done)[:, None], pr.stall + 1, 0)
    if rec is not None:
        rec.update(newly=newly, nreq=nreq, do_restart=do_restart, crep=crep)

    return SimState(
        t=st.t + 1,
        acc=acc,
        learned=learned,
        prop=ProposerState(
            mode=mode,
            count=count,
            ballot=ballot,
            pmax_seen=pmax_seen,
            delay_until=delay_until,
            prep_deadline=prep_deadline,
            prep_retries=prep_retries,
            promises=promises2,
            adopted_b=adopted_b,
            adopted_v=adopted_v,
            cur_batch=cur_batch,
            acks=acks,
            acc_deadline=torch.where(
                resend_acc, t + 1 + pk.accept_retry_timeout, acc_deadline
            ),
            acc_retries=acc_retries,
            own_assign=own_assign,
            pend=pend,
            gate=gate,
            head=head,
            tail=tail,
            commit_vid=commit_vid,
            commit_acked=commit_acked,
            commit_deadline=commit_deadline,
            stall=stall,
            commit_wait=commit_wait,
        ),
        net=net,
        met=met,
        crashed=crashed,
        done=done,
        qsums=sums,
        qhmax=hmax,
    )


def _record(b, st: SimState, new: SimState, rec: dict, tele, t: int):
    """The flight recorder's round (``tpu_paxos/core/sim.py:2040-2181``):
    every field reduces values the round already computed (``new``, the
    round's output, and ``rec`` from :func:`_proposer_round`), with no
    host read, so an armed round makes the plain round's syncs.  Where
    the host skipped a block the recorder reads that block's identity
    values: ``newly`` None is all-false, ``nreq`` zeros.  ``tele`` is a
    :class:`~tpu_paxos_torch.telemetry.recorder.Telemetry` or, windowed,
    a ``(Telemetry, TelemetryWindows)`` pair; returns the same kind."""
    from tpu_paxos_torch.telemetry import recorder as rc

    none = val.NONE
    ww = b.window_rounds
    base, wins = tele if ww else (tele, None)

    # The seven sites stacked proposer-row first ([L, 7, (4,) P, A]:
    # node->proposer sites transposed), so each counter is one reduction.
    def orient(x, pa):
        return x if pa else x.transpose(-1, -2)

    al, dl, post, pre = (
        torch.stack([orient(s[k], pa) for s, pa in zip(rec["sites"], b.site_pa)], dim=1)
        for k in range(4)
    )
    surv = post[:, :, None] & al  # [L, 7, 4, P, A] surviving copies
    drop = post & ~al[:, :, 0]
    per_type = torch.stack([
        post.sum(dim=(2, 3)), drop.sum(dim=(2, 3)), surv[:, :, 1:].sum(dim=(2, 3, 4)),
        (surv & (dl > 0)).sum(dim=(2, 3, 4)),
    ]).to(_I32)  # [4, L, 7]: offered, dropped, duped, delayed
    # Per-edge increments [L, 4, A, A] (offered, dropped, cut, summed
    # delay): each direction's sites summed, proposer rows placed on their
    # nodes, node->proposer sums transposed back.
    per_edge = torch.stack([
        post.to(_I32), drop.to(_I32), (pre & ~post).to(_I32),
        torch.where(surv, dl, 0).sum(dim=2).to(_I32),
    ], dim=1)  # [L, 4, 7, P, A]

    def rows(sites):  # the sites' sum [L, 4, P, A] -> [L, 4, A, A] by proposer node
        q = per_edge.index_select(2, sites).sum(dim=2)
        pad = torch.cat([q, torch.zeros_like(q[:, :, :1])], dim=2)
        return pad.index_select(2, b.pn_inv)

    pa_sites, ap_sites = b.site_dirs
    inc = (rows(pa_sites) + rows(ap_sites).transpose(-1, -2)).to(_I32)

    pr, pr0 = new.prop, st.prop
    restarts = _sum32(rec["do_restart"], dim=1)
    cv_new = (pr.commit_vid != none) & (pr0.commit_vid == none)
    newly = rec["newly"]
    took = cv_new if newly is None else cv_new & ~newly  # [L, P, I]
    takeovers = _sum32(took, dim=(1, 2))
    learned = new.learned
    learned_any = learned != none
    # phase-ledger stamps: learned by a majority of nodes; commit ladder
    # complete (some commitment acked by every node not crashed)
    learn_ok = learned_any.sum(dim=1) >= b.quorum  # [L, I]
    dead = new.crashed if b.node_mask is None else new.crashed | ~b.node_mask
    full_ack = (
        (pr.commit_vid != none)
        & (pr.commit_acked | dead[:, None, :, None]).all(dim=2)
    ).any(dim=1)  # [L, I]
    stall_now = pr.stall.amax(dim=1)

    def stamp(old, cond):
        return torch.where((old == none) & cond, t, old)

    new_base = rc.Telemetry(
        offered=base.offered + per_type[0],
        dropped=base.dropped + per_type[1],
        duped=base.duped + per_type[2],
        delayed=base.delayed + per_type[3],
        learns=base.learns + _sum32(learned_any & (st.learned == none), dim=(1, 2)),
        commit_acks=base.commit_acks + _sum32(rec["crep"], dim=(1, 2)),
        takeovers=base.takeovers + takeovers,
        requeues=base.requeues + _sum32(rec["nreq"], dim=1),
        restarts=base.restarts + restarts,
        admit_round=stamp(base.admit_round, rec["adm_any"]),
        learned_round=stamp(base.learned_round, learn_ok),
        committed_round=stamp(base.committed_round, full_ack),
        takeover_round=stamp(base.takeover_round, took.any(dim=2)),
        stall_max=torch.maximum(base.stall_max, stall_now),
        edge_offered=base.edge_offered + inc[:, 0],
        edge_dropped=base.edge_dropped + inc[:, 1],
        edge_cut=base.edge_cut + inc[:, 2],
    )
    if not ww:
        return new_base
    # Windowed plane: the same values in the bucket of round t (one
    # bucket for every running lane: they share the round).
    wb = rc.window_bucket(t, ww)
    totals = per_type.sum(dim=2)  # [4, L]

    def add(series, v):
        out = series.clone()
        out[:, wb] += v
        return out

    def top(series, v):
        out = series.clone()
        out[:, wb] = torch.maximum(out[:, wb], v)
        return out

    node = inc.sum(dim=2) + inc.sum(dim=3)  # [L, 4, A] both endpoints
    new_wins = rc.TelemetryWindows(
        offered=add(wins.offered, totals[0]),
        dropped=add(wins.dropped, totals[1]),
        duped=add(wins.duped, totals[2]),
        delayed=add(wins.delayed, totals[3]),
        stall_max=top(wins.stall_max, stall_now),
        takeovers=add(wins.takeovers, takeovers),
        restarts=add(wins.restarts, restarts),
        cut=add(wins.cut, _sum32(inc[:, 2], dim=(1, 2))),
        backlog_max=top(wins.backlog_max, _sum32(pr.tail - pr.head, dim=1)),
        node_offered=add(wins.node_offered, node[:, 0]),
        node_delay=add(wins.node_delay, node[:, 3]),
    )
    return new_base, new_wins


def admit_block(st: SimState, admit, keep=None) -> SimState:
    """Open-loop admission: append one NONE-padded block of fresh vids
    per proposer at the queue tail (the serve driver's per-window
    upload, between windows of rounds; ``tpu_paxos/core/sim.py:2186``).

    ``admit`` is ``[..., P, K]`` int32 with the state's leading axes (a
    lane-stacked state takes ``[L, P, K]``), each row a value PREFIX
    padded with NONE.  ``keep`` (same shape, bool, or None) is the
    admission controller's shed mask: masked values become NONE, and a
    stable sort by "not kept" compacts the survivors to the front in
    plan order, so the row stays a prefix.

    Slots at and past the tail are NONE invariantly, so the block's
    padding overwrites NONE with NONE.  The write goes through a
    K-padded row, so its start never clamps, for any block width (a
    clamped start would rewrite live entries below the tail); real
    values never pass the row end by the capacity proof of
    :func:`prepare_queues`, so only padding is cut off.  Gates are
    untouched (serve traffic is ungated)."""
    pr = st.prop
    dev = pr.pend.device
    if not isinstance(admit, torch.Tensor):
        admit = torch.from_numpy(np.ascontiguousarray(admit, np.int32))
    admit = admit.to(device=dev, dtype=_I32)
    if keep is not None:
        if not isinstance(keep, torch.Tensor):
            keep = torch.from_numpy(np.ascontiguousarray(keep, bool))
        kept = keep.to(dev).bool() & (admit != val.NONE)
        # stable: survivors keep their plan order ahead of the dropped
        order = torch.sort((~kept).to(torch.int8), dim=-1, stable=True).indices
        admit = torch.where(kept.gather(-1, order), admit.gather(-1, order), val.NONE)
    k = admit.shape[-1]
    width = pr.pend.shape[-1]
    pad = torch.full((*pr.pend.shape[:-1], k), val.NONE, dtype=_I32, device=dev)
    pend = _window_write(torch.cat([pr.pend, pad], dim=-1), admit, pr.tail)[..., :width]
    counts = _sum32(admit != val.NONE, dim=-1)
    return st._replace(prop=pr._replace(pend=pend, tail=pr.tail + counts))


def default_workload(cfg: SimConfig) -> list[np.ndarray]:
    """``n_instances // 2`` values split round-robin over the
    proposers, leaving instance headroom for no-op fills."""
    p = len(cfg.proposers)
    stride = max(cfg.n_instances, 1024)
    total = max(cfg.n_instances // 2, 1)
    counts = [total // p + (1 if pi < total % p else 0) for pi in range(p)]
    return [
        (pi * stride + np.arange(counts[pi], dtype=np.int64)).astype(np.int32)
        for pi in range(p)
    ]


def prepare_queues(cfg: SimConfig, workload, gates=None):
    """Build the (pend, gate, tail) queue arrays (numpy) from
    per-proposer value sequences; returns (pend, gate, tail, capacity).
    Rows are over-allocated by ``assign_window`` so window reads and
    writes never clamp (the pad holds NONE invariantly)."""
    p = len(cfg.proposers)
    c = max(len(wl) for wl in workload) + cfg.n_instances + 8
    width = c + cfg.assign_window
    pend = np.full((p, width), val.NONE, np.int32)
    gate = np.full((p, width), val.NONE, np.int32)
    tail = np.zeros((p,), np.int32)
    for pi, wl in enumerate(workload):
        wl = np.asarray(wl, np.int32)
        if len(wl) > c:
            raise ValueError(f"workload for proposer {pi} exceeds queue cap")
        pend[pi, : len(wl)] = wl
        tail[pi] = len(wl)
        if gates is not None and len(gates[pi]):
            g = np.asarray(gates[pi], np.int32)
            if len(g) > len(wl):
                raise ValueError(
                    f"gates for proposer {pi} ({len(g)}) exceed its "
                    f"workload ({len(wl)})"
                )
            gate[pi, : len(g)] = g
    return pend, gate, tail, c


def gates_vid_cap(workload, gates) -> int:
    """Vid-space bound for the gate-membership bitmap: 0 when the run
    has no gates, else one past the largest workload vid."""
    if gates is None or all(
        g is None or not len(g) or (np.asarray(g) == val.NONE).all()
        for g in gates
    ):
        return 0
    return max(int(np.max(w)) for w in workload if len(w)) + 1


def init_state(cfg: SimConfig, pend, gate, tail, root, device="cuda",
               geometry=None, geom=None, pknobs=None) -> SimState:
    """Initial state on ``device`` (queue arrays as numpy or tensors).
    With ``geometry``/``geom``/``pknobs`` (a padded build; ``cfg`` is
    then the envelope's bound) the initial backoff is drawn as the
    engine's in-round backoff is."""
    dev = devm.resolve(device)

    def lane(x):
        return (x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x))[None]

    roots = np.asarray([root], np.uint64)
    return lane_of(_init_lanes(cfg, lane(pend), lane(gate), lane(tail), roots, dev,
                               geometry=geometry, geom=geom, pknobs=pknobs), 0)


def init_lanes(cfg: SimConfig, pend, gate, tail, roots, device="cuda",
               geometry=None, geom=None, pknobs=None) -> SimState:
    """Initial states of ``L`` lanes on ``device``, stacked on a leading
    lane axis: ``pend``/``gate`` ``[L, P, C+W]``, ``tail`` ``[L, P]``
    (numpy) and ``roots`` ``[L, 2]`` (``prng.root_keys``); ``geometry``,
    ``geom`` and ``pknobs`` as :func:`init_state` takes them."""
    return _init_lanes(cfg, pend, gate, tail, roots, devm.resolve(device),
                       geometry=geometry, geom=geom, pknobs=pknobs)


def _unchanged(old, new, lanes: int) -> torch.Tensor:
    """``[L]``: lanes on which every leaf of ``new`` but the round
    counter equals ``old``'s."""
    changed = torch.zeros((lanes,), dtype=torch.bool, device=new.t.device)
    for name in SimState._fields:
        if name == "t":
            continue
        a, b = getattr(old, name), getattr(new, name)
        for x, y in zip(
            (a,) if isinstance(a, torch.Tensor) else a,
            (b,) if isinstance(b, torch.Tensor) else b,
        ):
            if x is not y:
                changed |= (x != y).reshape(lanes, -1).any(dim=1)
    return ~changed


def run_lanes(round_fn, roots, state: SimState, budgets, tab=None, knobs=None, tele=None,
              geom=None, pknobs=None):
    """The whole-run loop of ``L`` lanes (a batched ``while_loop``):
    lane ``l`` runs while ``~done[l] & t[l] < budgets[l]``, and a lane
    that stops keeps its state while the others run on.  Every running
    lane is at the same round, the host's count.  ``round_fn`` comes
    from :func:`build_engine`; ``state`` is consumed.

    A lane that reaches a fixed point of the round (``round_fn.dormant``
    says no later round depends on ``t`` there, and one round changed
    nothing) would only count rounds up to its budget: it is parked and
    its counter set to the budget at the end, as the JAX loop leaves it.
    Returns the final states and the number of round calls.
    ``geom``/``pknobs`` are a padded or runtime-protocol build's
    per-call geometry and protocol knobs, shared by every lane.

    An armed engine takes the lane-stacked recorder as ``tele`` and the
    loop returns ``(states, tele, round calls)``.  The rounds a parked
    lane skips would add nothing to its counters (no node that could
    send is alive, nothing is in flight, every stamp already holds), but
    their window buckets would each take the lane's constant stall depth
    and backlog: :func:`_fill_parked` writes those at the end."""
    budgets = np.asarray(budgets, np.int64)
    lanes = budgets.shape[0]
    parked = np.zeros((lanes,), bool)
    park_t = np.zeros((lanes,), np.int64)
    t = calls = None
    prev = check = None
    while True:
        # one read a round: each lane's done flag and round, and which
        # lanes the last round left at a fixed point
        reads = [state.done.to(_I32), state.t]
        if check is not None:
            reads.append((check & _unchanged(prev, state, lanes)).to(_I32))
        counters.add("host_reads")
        # paxlint: allow[JAX103] the loop's one designed read a round (done flags, rounds, parked lanes); analysis/audit.py pins it
        host = torch.stack(reads).cpu().numpy()
        done, t_l = host[0].astype(bool), host[1]
        if check is not None:
            now = host[2].astype(bool) & ~parked
            park_t[now] = t_l[now]
            parked |= now
        prev = check = None
        running = ~done & (t_l < budgets) & ~parked
        if not running.any():
            break
        if t is None:  # a state handed over mid-run starts where it is
            t, calls = int(t_l[running][0]), 0
        if (t_l[running] != t).any():
            raise AssertionError(f"running lanes are at rounds {t_l[running]}, not {t}")
        check = round_fn.dormant(state, t, tab, knobs, running, geom=geom, pknobs=pknobs)
        if check is not None:
            prev = state
        run = None if running.all() else running
        kw = dict(geom=geom, pknobs=pknobs)
        if tele is None:
            state = round_fn.lanes(roots, state, t, tab, knobs, run, **kw)
        else:
            state, tele = round_fn.lanes(roots, state, t, tab, knobs, run, tele=tele, **kw)
        t += 1
        calls += 1
    if parked.any():
        dev = state.t.device
        state = state._replace(t=torch.where(
            torch.from_numpy(parked).to(dev),
            torch.from_numpy(budgets.astype(np.int32)).to(dev), state.t,
        ))
        if tele is not None and round_fn.window_rounds:
            tele = (tele[0], _fill_parked(tele[1], state, parked, park_t, budgets,
                                          round_fn.window_rounds))
    if tele is None:
        return state, calls or 0
    return state, tele, calls or 0


def _fill_parked(wins, state: SimState, parked, park_t, budgets, window_rounds: int):
    """The window buckets of the rounds a parked lane skipped (from the
    round it was parked at to its budget) take its stall depth and
    backlog as running those rounds would have: the state no longer
    changes, so each round writes the same values."""
    from tpu_paxos_torch.telemetry import recorder as rc

    span = np.zeros((len(parked), rc.NUM_WINDOWS), bool)
    for lane in np.flatnonzero(parked & (park_t < budgets)):
        lo = rc.window_bucket(int(park_t[lane]), window_rounds)
        hi = rc.window_bucket(int(budgets[lane]) - 1, window_rounds)
        span[lane, lo:hi + 1] = True
    span = devm.to_device(torch.from_numpy(span), state.t.device)
    stall = state.prop.stall.amax(dim=1)[:, None]
    backlog = _sum32(state.prop.tail - state.prop.head, dim=1)[:, None]
    return wins._replace(
        stall_max=torch.where(span, torch.maximum(wins.stall_max, stall), wins.stall_max),
        backlog_max=torch.where(span, torch.maximum(wins.backlog_max, backlog), wins.backlog_max),
    )


def run_state(
    cfg: SimConfig,
    state: SimState,
    root,
    expected_vids: np.ndarray,
    queue_cap: int,
    vid_cap: int | None = None,
) -> SimResult:
    """Drive a prepared SimState to quiescence (or the round budget) on
    the state's device; ``state`` is consumed.  ``vid_cap=None`` derives the gate bitmap size
    from the state's own gate/pend arrays."""
    if vid_cap is None:
        gate_np = state.prop.gate.cpu().numpy()
        if (gate_np != val.NONE).any():
            pend_np = state.prop.pend.cpu().numpy()
            vid_cap = int(max(pend_np.max(), gate_np.max())) + 1
        else:
            vid_cap = 0
    round_fn = build_engine(cfg, queue_cap, vid_cap=vid_cap, device=state.learned.device)
    roots = np.asarray([root], np.uint64)
    final, _ = run_lanes(round_fn, roots, lanes_view(state), [cfg.round_budget])
    return to_result(lane_of(final, 0), expected_vids)


def to_result(final: SimState, expected_vids: np.ndarray) -> SimResult:
    """Marshal a final state into the host-convention result."""
    def host(x):
        return x.cpu().numpy()

    return SimResult(
        learned=host(final.learned).T,  # host convention [I, A]
        chosen_vid=host(final.met.chosen_vid),
        chosen_round=host(final.met.chosen_round),
        chosen_ballot=host(final.met.chosen_ballot),
        rounds=int(final.t),
        done=bool(final.done),
        crashed=host(final.crashed),
        msgs=host(final.met.msgs),
        expected_vids=expected_vids,
    )


def run_with_telemetry(
    cfg: SimConfig,
    workload=None,
    gates=None,
    window_rounds: int | None = None,
    region_map=None,
    return_ledger: bool = False,
    device="cuda",
):
    """:func:`run` with the flight recorder armed: returns ``(SimResult,
    TelemetrySummary, WindowSummary | None)`` with the summaries as host
    numpy, reduced on the device after the loop and moved in one copy.
    The decisions equal :func:`run`'s for the same (cfg, workload,
    gates).  ``window_rounds`` is the windowed plane's bucket width
    (default ``recorder.WINDOW_ROUNDS``; 0 leaves the plane out and its
    slot None); ``region_map`` the ``[A]`` node->region map of the
    per-region-pair counters (None: every node in region 0).
    ``return_ledger=True`` appends the per-instance phase ledger (admit,
    batch, learned and committed rounds, host numpy) for offline export."""
    from tpu_paxos_torch.telemetry import recorder as telem

    if window_rounds is None:
        window_rounds = telem.WINDOW_ROUNDS
    ww = int(window_rounds)
    if workload is None:
        workload = default_workload(cfg)
    dev = devm.resolve(device)
    pend, gate, tail, c = prepare_queues(cfg, workload, gates)
    root = prng.root_key(cfg.seed)
    state = init_state(cfg, pend, gate, tail, root, device=dev)
    expected = np.unique(
        np.concatenate([np.asarray(w, np.int32).reshape(-1) for w in workload])
    )
    round_fn = build_engine(
        cfg, c, vid_cap=gates_vid_cap(workload, gates), device=dev,
        telemetry=True, window_rounds=ww,
    )
    tele0 = telem.init_telemetry(cfg.n_instances, len(cfg.proposers), cfg.n_nodes, device=dev)
    if ww:
        tele0 = (tele0, telem.init_windows(cfg.n_nodes, device=dev))
    roots = np.asarray([root], np.uint64)
    final, tl, _ = run_lanes(round_fn, roots, lanes_view(state), [cfg.round_budget], tele=tele0)
    base = tl[0] if ww else tl
    sched = cfg.faults.schedule
    trees = telem.close(tl, final, sched.horizon if sched is not None else 0, region_map, ww)
    if return_ledger:
        trees.append(_Ledger(base.admit_round, base.admit_round, base.learned_round,
                             base.committed_round))
    host = [telem.lane(x, 0) for x in devm.to_host(*trees)]
    ret = (to_result(lane_of(final, 0), expected), host[0], host[1] if ww else None)
    if return_ledger:
        ret = ret + (dict(sorted(host[-1]._asdict().items())),)  # JAX's pytree order
    return ret


class _Ledger(NamedTuple):
    """The per-instance phase ledger of :func:`run_with_telemetry`."""

    admit_round: torch.Tensor
    batch_round: torch.Tensor
    learned_round: torch.Tensor
    committed_round: torch.Tensor


def run(
    cfg: SimConfig,
    workload=None,
    gates=None,
    device="cuda",
) -> SimResult:
    """Run the engine to quiescence (or the round budget) on ``device``.

    ``workload[p]`` is the vid sequence proposer ``p`` proposes;
    ``gates[p][k]`` (optional) is the vid that must be chosen before
    entry ``k`` becomes proposable, or NONE."""
    if workload is None:
        workload = default_workload(cfg)
    pend, gate, tail, c = prepare_queues(cfg, workload, gates)
    root = prng.root_key(cfg.seed)
    state = init_state(cfg, pend, gate, tail, root, device=device)
    expected = np.unique(
        np.concatenate([np.asarray(w, np.int32).reshape(-1) for w in workload])
    )
    return run_state(
        cfg, state, root, expected, c, vid_cap=gates_vid_cap(workload, gates)
    )


def audit_canonical_cfg() -> SimConfig:
    """The JAX package's canonical small config for this engine:
    multi-proposer with i.i.d. drop and crash faults on."""
    return SimConfig(
        n_nodes=3,
        n_instances=16,
        proposers=(0, 1),
        seed=0,
        max_rounds=64,
        faults=FaultConfig(drop_rate=500, crash_rate=1000),
    )


def audit_entries():
    """The registered entry points of the general engine
    (``analysis/registry.py``), under the JAX package's names: the
    whole-run loop of :func:`audit_canonical_cfg` on its compile-time
    build and on the episode-schedule, runtime-knob, recorder-armed,
    windowed, geometry-padded and gate-bearing builds, each one canonical
    small run (``run_lanes`` at one lane).  The kernels launch through
    ``core/simkern``'s dispatchers, which the audit counts; this module
    has no launching surface of its own."""
    import dataclasses as dc

    from tpu_paxos_torch.analysis.registry import AuditEntry

    def _loop(round_fn, budget: int, tele=None):
        def fn(root, state, tab=None, knobs=None, geom=None, pknobs=None):
            roots = np.asarray([root], np.uint64)
            return run_lanes(
                round_fn, roots, lanes_view(state), [budget],
                tab=None if tab is None else _one_lane(tab),
                knobs=None if knobs is None else _one_lane(knobs),
                tele=tele, geom=geom, pknobs=pknobs,
            )

        return fn

    def _state(cfg, workload, gates, device, **geom_kw):
        pend, gate, tail, c = prepare_queues(cfg, workload, gates)
        root = prng.root_key(cfg.seed)
        return root, init_state(cfg, pend, gate, tail, root, device=device, **geom_kw), c

    def _sched_cfg(*episodes):
        return dc.replace(
            audit_canonical_cfg(),
            faults=FaultConfig(drop_rate=500, crash_rate=1000,
                               schedule=fltm.FaultSchedule(episodes)),
        )

    def build(device):
        cfg = audit_canonical_cfg()
        root, state, c = _state(cfg, default_workload(cfg), None, device)
        rf = build_engine(cfg, c, vid_cap=0, device=device)
        return _loop(rf, cfg.round_budget), (root, state)

    def build_episodes(device):
        # the compile-time schedule tables (reach/pause/drop rows)
        cfg = _sched_cfg(
            fltm.partition(2, 10, (0,), (1, 2)),
            fltm.one_way(4, 14, (1,), (2,)),
            fltm.pause(6, 12, 2),
            fltm.burst(3, 9, 1500),
        )
        root, state, c = _state(cfg, default_workload(cfg), None, device)
        rf = build_engine(cfg, c, vid_cap=0, device=device)
        return _loop(rf, cfg.round_budget), (root, state)

    def build_knobs(device):
        # schedule AND i.i.d. knobs as runtime inputs (the stress envelope)
        cfg = dc.replace(audit_canonical_cfg(),
                         faults=FaultConfig(drop_rate=500, crash_rate=1000, max_delay=2))
        root, state, c = _state(cfg, default_workload(cfg), None, device)
        sched = fltm.FaultSchedule((
            fltm.partition(2, 10, (0,), (1, 2)),
            fltm.pause(3, 8, 2),
        ))
        tab = stm.encode_schedule(sched, cfg.n_nodes, 4)
        knobs = netm.knobs_from_faults(cfg.faults)
        rf = build_engine(cfg, c, vid_cap=0, runtime_schedule=True, runtime_knobs=True,
                          device=device)
        return _loop(rf, cfg.max_rounds + int(tab.horizon)), (root, state, tab, knobs)

    def _armed(device, window_rounds: int):
        from tpu_paxos_torch.telemetry import recorder as telem

        cfg = _sched_cfg(
            fltm.partition(2, 10, (0,), (1, 2)),
            fltm.pause(3, 8, 2),
            fltm.burst(4, 9, 1500),
        )
        root, state, c = _state(cfg, default_workload(cfg), None, device)
        rf = build_engine(cfg, c, vid_cap=0, telemetry=True, window_rounds=window_rounds,
                          device=device)
        tele0 = telem.init_telemetry(cfg.n_instances, len(cfg.proposers), cfg.n_nodes,
                                     device=device)
        if window_rounds:
            tele0 = (tele0, telem.init_windows(cfg.n_nodes, device=device))
        return _loop(rf, cfg.round_budget, tele=tele0), (root, state)

    def build_telemetry(device):
        # the flight recorder armed, window-free
        return _armed(device, 0)

    def build_timeseries(device):
        # the recorder's windowed time-series plane on top
        from tpu_paxos_torch.telemetry import recorder as telem

        return _armed(device, telem.WINDOW_ROUNDS)

    def build_envelope(device):
        # the geometry-padded build: the true geometry and protocol as
        # runtime inputs on top of the runtime schedule and knobs
        genv = geo.GeometryEnvelope(menu=((3, (0, 1)), (5, (0, 1, 2))))
        cfg = dc.replace(audit_canonical_cfg(),
                         faults=FaultConfig(drop_rate=500, crash_rate=1000, max_delay=2))
        bcfg = genv.bound_cfg(cfg)
        workload = default_workload(cfg) + [np.zeros((0,), np.int32)]
        gm = geo.geometry_for(genv, cfg.n_nodes, cfg.proposers)
        pkn = geo.protocol_knobs(cfg.protocol, stall_patience=IDLE_RESTART_ROUNDS)
        root, state, c = _state(bcfg, workload, None, device, geometry=genv, geom=gm,
                                pknobs=pkn)
        sched = fltm.FaultSchedule((
            fltm.partition(2, 10, (0,), (1, 2)),
            fltm.pause(3, 8, 2),
        ))
        tab = stm.encode_schedule(sched, bcfg.n_nodes, 4)
        knobs = netm.pad_matrix_knobs(netm.matrix_knobs(cfg.faults, cfg.n_nodes), bcfg.n_nodes)
        rf = build_engine(bcfg, c, vid_cap=0, runtime_schedule=True, runtime_knobs=True,
                          geometry=genv, runtime_protocol=True, device=device)
        return (_loop(rf, bcfg.max_rounds + int(tab.horizon)),
                (root, state, tab, knobs, gm, pkn))

    def build_gates(device):
        # a nonzero vid_cap puts the gate-membership bitmap in the round
        cfg = audit_canonical_cfg()
        workload = default_workload(cfg)
        gates = [
            np.asarray([val.NONE, int(workload[1][0])], np.int32),
            np.asarray([int(workload[0][0])], np.int32),
        ]
        root, state, c = _state(cfg, workload, gates, device)
        rf = build_engine(cfg, c, vid_cap=gates_vid_cap(workload, gates), device=device)
        return _loop(rf, cfg.round_budget), (root, state)

    return [
        AuditEntry("sim.run_rounds", build),
        AuditEntry("sim.run_rounds_episodes", build_episodes),
        AuditEntry("sim.run_rounds_knobs", build_knobs),
        AuditEntry("sim.run_rounds_telemetry", build_telemetry),
        AuditEntry("sim.run_rounds_timeseries", build_timeseries),
        AuditEntry("sim.run_rounds_envelope", build_envelope),
        AuditEntry("sim.run_rounds_gates", build_gates),
    ]
