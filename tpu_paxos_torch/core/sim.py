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
  ``~done & t < round_budget``.
- ``dynamic_slice``/``dynamic_update_slice`` clamp their start as XLA
  does (:func:`_window_read`, :func:`_window_write`).
- The multi-operand ``lax.sort`` becomes a stable ``torch.sort`` of the
  keys plus a gather; its keys are unique where the result is used.
- Every PRNG draw of a round is made on the host in one batched
  threefry pass (``utils/prng.py``) and moved to the device once.
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
  burst loss, gray inflation and the knob matrices shape the host-drawn
  copy plans, and the pause, reachability and crash rows ride the
  round's one host-to-device copy.

Not ported yet (each raises ``NotImplementedError`` naming itself):
``admit_block``, and the sharded, runtime-knob, runtime-schedule,
telemetry, geometry and runtime-protocol builds.
"""

from __future__ import annotations

import dataclasses
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


def _init_state(cfg: SimConfig, pend, gate, tail, root, device) -> SimState:
    a, i = cfg.n_nodes, cfg.n_instances
    p = len(cfg.proposers)
    s = cfg.faults.max_delay + 2
    pc = cfg.protocol
    delay0 = prng.randint(
        prng.stream(root, prng.STREAM_PREPARE_DELAY, 0), (p,),
        pc.prepare_delay_min, pc.prepare_delay_max + 1,
    ).to(device)

    def none(*sh):
        return torch.full(sh, bal.NONE, dtype=_I32, device=device)

    def zeros(*sh, dtype=_I32):
        return torch.zeros(sh, dtype=dtype, device=device)

    return SimState(
        t=torch.tensor(0, dtype=_I32, device=device),
        acc=AcceptorState(
            promised=zeros(a), max_seen=zeros(a),
            acc_ballot=none(a, i), acc_vid=none(a, i),
        ),
        learned=none(a, i),
        prop=ProposerState(
            mode=torch.full((p,), DELAY, dtype=_I32, device=device),
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
            pend=torch.as_tensor(np.asarray(pend, np.int32)).to(device),
            gate=torch.as_tensor(np.asarray(gate, np.int32)).to(device),
            head=zeros(p),
            tail=torch.as_tensor(np.asarray(tail, np.int32)).to(device),
            commit_vid=none(p, i),
            commit_acked=zeros(p, a, i, dtype=torch.bool),
            commit_deadline=zeros(p),
            stall=zeros(p),
            commit_wait=zeros(p, dtype=torch.bool),
        ),
        net=netm.init_buffers(s, p, a, device),
        met=Metrics(
            chosen_vid=none(i), chosen_round=none(i), chosen_ballot=none(i),
            msgs=zeros(7),
        ),
        crashed=zeros(a, dtype=torch.bool),
        done=torch.tensor(False, device=device),
        qsums=zeros(1 + a + 3 * p),
        qhmax=torch.tensor(-1, dtype=_I32, device=device),
    )


def _window_read(rows: torch.Tensor, starts: torch.Tensor, w: int) -> torch.Tensor:
    """Per-row ``lax.dynamic_slice(row, (h,), (w,))``: the start is
    clamped into ``[0, len - w]`` as XLA clamps it."""
    st = starts.to(torch.int64).clamp(0, rows.shape[1] - w)
    pos = st[:, None] + torch.arange(w, device=rows.device)
    return rows.gather(1, pos)


def _window_write(rows: torch.Tensor, vals: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Per-row ``lax.dynamic_update_slice(row, vals, (h,))`` with XLA's
    start clamp; returns a new tensor."""
    w = vals.shape[1]
    st = starts.to(torch.int64).clamp(0, rows.shape[1] - w)
    pos = st[:, None] + torch.arange(w, device=rows.device)
    return rows.scatter(1, pos, vals)


def _gate_satisfied(g: torch.Tensor, chosen_mask: torch.Tensor) -> torch.Tensor:
    """An entry is proposable when ungated or its gate vid is in the
    chosen-membership bitmap; gates on out-of-workload vids never
    satisfy."""
    v_cap = chosen_mask.shape[0]
    g_chosen = chosen_mask[g.clamp(0, v_cap - 1).long()] & (g != val.NONE) & (g < v_cap)
    return (g == val.NONE) | g_chosen


def _assignable_window(pend, gate, head, tail, chosen_mask, w):
    """First-fit view of the head window: which of the next W queue
    entries are live (and, with a bitmap, gate-satisfied).  Returns
    (qvid [P, W], ok [P, W])."""
    offs = torch.arange(w, dtype=_I32, device=pend.device)
    qvid = _window_read(pend, head, w)
    live = ((head[:, None] + offs[None]) < tail[:, None]) & (qvid != val.NONE)
    if chosen_mask is None:
        return qvid, live
    g = _window_read(gate, head, w)
    return qvid, live & _gate_satisfied(g, chosen_mask)


def _any(x: torch.Tensor) -> bool:
    """A global predicate read to the host (one sync)."""
    return bool(x.any())


def _sum32(x: torch.Tensor, dim=None) -> torch.Tensor:
    """``jnp.sum`` of bools/ints as int32 (torch sums to int64)."""
    return (x.sum() if dim is None else x.sum(dim=dim)).to(_I32)


_UNPORTED_FLAGS = (
    "axis_name", "runtime_schedule", "runtime_knobs", "telemetry",
    "window_rounds", "geometry", "runtime_protocol",
)


def build_engine(
    cfg: SimConfig,
    n_pend_cap: int,
    vid_cap: int = 0,
    use_kernels: bool | None = None,
    device="cuda",
    **flags,
):
    """Returns ``round_fn(root, state) -> state``, the unpadded,
    unsharded round of the JAX engine with i.i.d. drop/dup/delay and
    crash faults, per-edge fault tables, the correlated-fault schedule
    (``delivery_cut`` included), gates (``vid_cap``) and the seeded
    takeover wedge.
    ``round_fn`` consumes its ``state``: the acceptor arrays and the ack
    cube are updated in place, on the CPU as on a card.

    The accept store and the ack fold run the simkern CUDA kernels on a
    CUDA device and their plain versions on the CPU; ``use_kernels``
    may only confirm that (``True`` on the CPU raises: there is no CUDA
    kernel to run there).  ``flags`` are the JAX engine's
    other build options, none ported yet: any set to a non-default
    value raises naming it."""
    for name in _UNPORTED_FLAGS:
        if flags.pop(name, None):
            raise NotImplementedError(f"build_engine {name} is not ported yet")
    if flags.pop("n_shards", 1) != 1:
        raise NotImplementedError("build_engine n_shards is not ported yet")
    if flags:
        raise TypeError(f"unknown build_engine options {sorted(flags)}")
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
    quorum = cfg.quorum
    max_crash = (a - 1) // 2
    pk = geo.static_protocol(cfg.protocol, stall_patience=IDLE_RESTART_ROUNDS)
    wedge_no_takeover = seeded_wedge() == "takeover"
    # Correlated-fault schedule as per-round host tables; a dimension
    # the schedule lacks is never read.
    comp = fltm.compile_schedule(fc.schedule, a)
    horizon = comp.horizon if comp is not None else 0
    has = {
        k: comp is not None and getattr(comp, f"has_{k}")
        for k in ("reach", "pause", "burst", "crash", "gray")
    }
    # Per-edge [A, A] fault tables: matrix knobs sliced once per send
    # direction (proposer->node rows pn, node->proposer columns pn).
    if fc.edges is not None:
        mknobs = netm.matrix_knobs(fc)
        kn_pa = netm.edge_knobs(mknobs, cfg.proposers, range(a))
        kn_ap = netm.edge_knobs(mknobs, range(a), cfg.proposers)
    else:
        kn_pa = kn_ap = None
    # delivery_cut only acts where reachability masks exist.
    delivery_cut = bool(fc.delivery_cut) and has["reach"]
    iid_crash = bool(fc.crash_rate)
    # Scheduled crash points change `crashed` without an i.i.d. draw:
    # the crash-coupled cached blocks then refresh every round too.
    crash_faults = iid_crash or has["crash"]
    r_cap = min(w, i_cap)
    span = min(2 * r_cap, i_cap)

    pn = torch.tensor(cfg.proposers, dtype=torch.int64, device=dev)  # [P] proposer -> node
    pn32 = pn.to(_I32)
    idx = torch.arange(i_cap, dtype=_I32, device=dev)
    offs_w = torch.arange(w, dtype=_I32, device=dev)
    none_pi = torch.full((p, i_cap), val.NONE, dtype=_I32, device=dev)
    bcast_a = torch.ones((p, a), dtype=torch.bool, device=dev)
    # the seven send sites in message order: True = proposer->node [P, A]
    site_pa = [True, False, False, True, False, True, False]
    pn_np = np.asarray(cfg.proposers)

    def draws(root, t: int):
        """Every coin of round ``t``, drawn on the host in one batched
        pass per kind, and the schedule's rows for round ``t``, moved to
        the device in one copy: the seven copy plans, the restart
        backoff, the crash coins, and the pause / reachability / crash
        rows.  Returns ``(plans, rnd_delay, crash_u, rows)`` with
        ``rows`` a dict of the rows the schedule has."""
        tt = min(t, horizon)
        gray_pa = gray_ap = None
        if has["gray"]:
            g = comp.gray[tt].astype(np.int64)
            gray_pa = g[pn_np][:, None] + g[None, :]  # [P, A] src + dst
            gray_ap = g[:, None] + g[pn_np][None, :]  # [A, P]
        keys = prng.split(prng.stream(root, prng.STREAM_NET_DROP, t), 8)
        sites = [
            (key, (p, a), kn_pa, gray_pa) if pa else (key, (a, p), kn_ap, gray_ap)
            for key, pa in zip(keys, site_pa)
        ]
        plans = netm.copy_plans(
            sites, fc, extra_drop=int(comp.extra_drop[tt]) if has["burst"] else None,
            delay_bound=fc.max_delay,
        )
        extra = [(
            prng.stream(root, prng.STREAM_PREPARE_DELAY, t + 1), (p,),
            pk.prepare_delay_min, pk.prepare_delay_max + 1,
        )]
        if iid_crash:
            extra.append((prng.stream(root, prng.STREAM_CRASH, t), (a,), 0, 1_000_000))
        coins = prng.randint_many(extra)
        rows = {
            name: torch.from_numpy(getattr(comp, table)[tt].astype(np.int32))
            for name, table in (("pause", "paused"), ("reach", "reach"), ("crash", "crashed"))
            if has[name]
        }
        parts = [x for al, dl in plans for x in (al.to(_I32), dl)] + coins + list(rows.values())
        flat = torch.cat([x.reshape(-1) for x in parts]).to(dev)
        out = list(torch.split(flat, [x.numel() for x in parts]))
        out = [o.reshape(x.shape) for o, x in zip(out, parts)]
        plans_d = [(out[2 * k].bool(), out[2 * k + 1]) for k in range(len(plans))]
        rest = out[2 * len(plans):]
        crash_u = rest[1] if iid_crash else None
        rows_d = dict(zip(rows, (x.bool() for x in rest[1 + iid_crash:])))
        return plans_d, rest[0], crash_u, rows_d

    def round_fn(root, st: SimState) -> SimState:
        for name in ("pend", "gate"):
            width = getattr(st.prop, name).shape[-1]
            if width != c + w:
                raise ValueError(
                    f"{name} rows are {width} wide; expected {c} + "
                    f"assign_window {w} padding"
                )
        t = int(st.t)
        s = st.net.prep_req.shape[0]
        slot = t % s
        ar = netm.NetBuffers(*[b[slot] for b in st.net])
        net = netm.clear_slot(st.net, slot)
        plans, rnd_delay, crash_u, rows = draws(root, t)

        # I/O-alive mask: crashed or currently paused nodes neither
        # send, receive nor act on timers this round; excusals stay on
        # `crashed` alone (a paused node's obligations are deferred).
        alive_a = ~st.crashed  # [A]
        if "pause" in rows:
            alive_a = alive_a & ~rows["pause"]
        prop_alive = alive_a[pn]  # [P]
        # Per-edge reachability cuts, ANDed into every send mask (and,
        # with delivery_cut, into this round's arrivals).
        reach = rows.get("reach")
        cut_pa = reach[pn] if reach is not None else None  # [P, A]
        cut_ap = reach[:, pn] if reach is not None else None  # [A, P]
        if delivery_cut:
            ar = netm.delivery_mask(ar, cut_pa, cut_ap)

        # ---------------- acceptor side ----------------
        acc = st.acc
        learned = st.learned

        # PREPARE arrivals (crashed acceptors ignore everything).
        preq = torch.where(alive_a[None, :], ar.prep_req, bal.NONE)  # [P, A]
        grant = preq > acc.promised[None, :]  # strict >, ref :866
        rej_prep = (preq != bal.NONE) & (preq < acc.promised[None, :])
        max_seen = torch.maximum(acc.max_seen, preq.amax(dim=0))
        promised = torch.maximum(
            acc.promised, torch.where(grant, preq, bal.NONE).amax(dim=0)
        )

        # ACCEPT arrivals: batch content is the sending proposer's
        # cur_batch, valid iff its ballot still equals the edge ballot.
        apres = torch.where(alive_a[None, :], ar.acc_req, bal.NONE)  # [P, A]
        abal = st.prop.ballot  # [P]
        abat = st.prop.cur_batch  # [P, I]
        has_acc = (
            (apres != bal.NONE) & (apres == abal[:, None])
            & (st.prop.mode == PREPARED)[:, None]
        )
        max_seen = torch.maximum(max_seen, apres.amax(dim=0))
        elig = has_acc & (abal[:, None] >= promised[None, :])  # >=, ref :1366
        rej_acc = has_acc & ~elig
        any_acc_arr = _any(elig)
        acc_ballot, acc_vid = acc.acc_ballot, acc.acc_vid
        if any_acc_arr:
            acc_ballot, acc_vid = sk.store_accepts(
                acc_ballot, acc_vid, learned, abat, abal, elig
            )

        # COMMIT arrivals -> learner state (ref OnCommit).
        cpres = ar.com_pres & alive_a[None, :]  # [P, A]
        cbat = st.prop.commit_vid  # [P, I]
        any_com_arr = _any(cpres)
        if any_com_arr:
            inc_v = torch.full_like(learned, _NEG)
            for pi in range(p):
                incp = cpres[pi][:, None] & (cbat[pi] != val.NONE)[None, :]
                inc_v = torch.maximum(
                    inc_v, torch.where(incp, cbat[pi][None, :], _NEG)
                )
            learned = torch.where(
                (inc_v != _NEG) & (learned == val.NONE), inc_v, learned
            )

        acc = AcceptorState(promised, max_seen, acc_ballot, acc_vid)
        return _proposer_round(
            ctx, st, t, net, ar, plans, rnd_delay, crash_u, alive_a,
            prop_alive, acc, learned, preq, grant, rej_prep, rej_acc,
            abal, elig, cpres, any_com_arr, cut_pa, cut_ap, rows.get("crash"),
        )

    # The proposer half of the round is below; it shares the build's
    # constants through this namespace.
    ctx = types.SimpleNamespace(
        a=a, p=p, i_cap=i_cap, w=w, quorum=quorum,
        max_crash=max_crash, pk=pk, wedge=wedge_no_takeover,
        crash_faults=crash_faults, iid_crash=iid_crash, horizon=horizon,
        r_cap=r_cap, span=span, pn=pn, pn32=pn32,
        idx=idx, offs_w=offs_w, none_pi=none_pi, bcast_a=bcast_a,
        vid_cap=vid_cap, crash_rate=fc.crash_rate,
    )

    return round_fn


def _assign(b, pr, st, learned, cur_batch, live, qvid, can_assign):
    """New-value assignment for every PREPARED proposer: gate-ready
    queue entries (first-fit) onto the lowest free instances of the
    open tail (ref unproposed_instance_ids_.Next).  Returns
    (cur_batch, own_assign, pend, head, k)."""
    p, w, i_cap, idx = b.p, b.w, b.i_cap, b.idx
    own_assign, pend, head = pr.own_assign, pr.pend, pr.head
    if b.vid_cap:
        # chosen-vid membership bitmap for the gate test; invalid
        # indices land in a spill slot that is cut off
        cv = st.met.chosen_vid
        slot = torch.where((cv >= 0) & (cv < b.vid_cap), cv, b.vid_cap).long()
        chosen_mask = torch.zeros(b.vid_cap + 1, dtype=torch.bool, device=cv.device)
        chosen_mask[slot] = True
        g = _window_read(pr.gate, head, w)
        ok = live & _gate_satisfied(g, chosen_mask[: b.vid_cap])
    else:
        ok = live
    activity = (
        (learned[b.pn] != val.NONE) | (cur_batch != val.NONE)
        | (own_assign != val.NONE)
    )
    # Free instances are the contiguous suffix above the activity
    # high-water mark, so ranks are closed-form.
    hi2 = torch.where(activity, idx[None], -1).amax(dim=1)
    hi2l = torch.clamp(hi2, min=-1)
    free = idx[None] > hi2l[:, None]
    free_rank = idx[None] - hi2l[:, None] - 1
    n_free = (i_cap - 1) - hi2l
    ok_rank = torch.cumsum(ok.to(_I32), dim=1, dtype=_I32) - 1
    k = torch.minimum(_sum32(ok, dim=1), n_free)
    k = torch.where(can_assign, k, 0)
    take_q = ok & (ok_rank < k[:, None])
    takev = free & (free_rank < k[:, None])
    start = torch.clamp(hi2l + 1, 0, i_cap)
    if _any(k > 0):
        is_prefix = bool((take_q == (b.offs_w[None] < k[:, None])).all())
        if is_prefix:
            by_rank = torch.where(take_q, qvid, val.NONE)
        else:
            # O(W) rank scatter; untaken slots go to a spill column
            rank_pos = torch.where(take_q, ok_rank, w).long()
            by_rank = torch.full((p, w + 1), val.NONE, dtype=_I32, device=qvid.device)
            by_rank.scatter_(1, rank_pos, qvid)
            by_rank = by_rank[:, :w]
        # place the ranked vids at the contiguous free window starting
        # at `start` (in [0, i_cap], so nothing clamps)
        rel = idx[None] - start[:, None]
        inside = (rel >= 0) & (rel < w)
        newv = torch.where(
            inside, by_rank.gather(1, rel.clamp(0, w - 1).long()), val.NONE
        )
    else:
        newv = b.none_pi
    cur_batch = torch.where(takev, newv, cur_batch)
    own_assign = torch.where(takev, newv, own_assign)
    # consume taken entries in place (a masked window write-back), then
    # advance head over the leading consumed run
    new_win = torch.where(take_q, val.NONE, qvid)
    pend = _window_write(pend, new_win, head)
    lead_dead = (
        (head[:, None] + b.offs_w[None]) < pr.tail[:, None]
    ) & (new_win == val.NONE)
    head = head + torch.cumprod(lead_dead.to(_I32), dim=1).sum(dim=1).to(_I32)
    return cur_batch, own_assign, pend, head, k


def _requeue(b, pend, own_assign, ptail, conflict):
    """Conflict re-proposal: append up to ``r_cap`` conflicted own
    values per proposer, in instance order, at the queue tail.
    Returns (pend, nreq, own_assign)."""
    p, i_cap, r_cap, span, idx = b.p, b.i_cap, b.r_cap, b.span, b.idx
    idxb = idx[None].expand(p, i_cap)
    has_c = conflict.any(dim=1)
    ncf = _sum32(conflict, dim=1)
    cmin = torch.where(conflict, idxb, _I32_MAX).amin(dim=1)
    cmax = torch.where(conflict, idxb, -1).amax(dim=1)
    nreq = torch.clamp(ncf, max=r_cap)
    contig = bool((~has_c | (ncf == cmax - cmin + 1)).all())
    if contig:
        # fully-conflicted contiguous runs: a padded slice at cmin
        startc = torch.where(has_c, cmin, 0)
        rowpad = torch.cat(
            [own_assign, torch.full((p, r_cap), val.NONE, dtype=_I32, device=own_assign.device)],
            dim=1,
        )
        block = _window_read(rowpad, startc, r_cap)
        take_req = conflict & (idxb < (cmin + nreq)[:, None])
    else:
        req_rank = torch.cumsum(conflict.to(_I32), dim=1, dtype=_I32) - 1
        take_req = conflict & (req_rank < r_cap)
        narrow = bool((~has_c | (cmax - cmin < span)).all())
        if narrow:
            startn = torch.clamp(torch.where(has_c, cmin, 0), 0, i_cap - span)
            win_conf = _window_read(conflict, startn, span)
            win_vids = _window_read(own_assign, startn, span)
            keys = torch.where(
                win_conf, torch.arange(span, dtype=_I32, device=idx.device)[None], span
            )
        else:
            keys = torch.where(conflict, idxb, i_cap)
            win_vids = own_assign
        # conflict keys are unique and sort ahead of the sentinel, so
        # the first nreq positions equal JAX's unstable sort
        order = torch.sort(keys, dim=1, stable=True).indices
        block = win_vids.gather(1, order)[:, :r_cap]
    ar_r = torch.arange(r_cap, dtype=_I32, device=idx.device)
    req_block = torch.where(ar_r[None] < nreq[:, None], block, val.NONE)
    pend = _window_write(pend, req_block, ptail)
    own_assign = torch.where(take_req, val.NONE, own_assign)
    return pend, nreq, own_assign


def _proposer_round(
    b, st, t, net, ar, plans, rnd_delay, crash_u, alive_a, prop_alive,
    acc, learned, preq, grant, rej_prep, rej_acc, abal, elig, cpres,
    any_com_arr, cut_pa, cut_ap, crash_t,
):
    """The proposer half of the round, the network writes, crash
    injection and quiescence (``tpu_paxos/core/sim.py:1022-2039``).
    ``cut_pa``/``cut_ap`` are the round's reachability masks and
    ``crash_t`` its cumulative scheduled crashes (None without them)."""
    a, p, pn, pk, quorum = b.a, b.p, b.pn, b.pk, b.quorum
    pr = st.prop
    # A->P arrivals are masked on both ends.
    rx_p = alive_a[:, None] & prop_alive[None, :]  # [A, P]
    # REJECT arrivals only update max-ballot-seen (ref OnReject).
    rejs = torch.where(rx_p, ar.rej, bal.NONE)
    pmax_seen = torch.maximum(pr.pmax_seen, rejs.amax(dim=0))

    # PREPARE_REPLY arrivals: promises + adoption merge.
    pecho = torch.where(rx_p, ar.prep_echo, bal.NONE)  # [A, P]
    match = (pecho == pr.ballot[None, :]) & (pr.mode[None, :] == PREPARING)
    promises2 = pr.promises | match.T  # [P, A]
    adopted_b, adopted_v = pr.adopted_b, pr.adopted_v
    if _any(match):
        # accepted-state snapshot at delivery, committed values at
        # COMMITTED_BALLOT (ref FilterAcceptedValues)
        is_l = learned != val.NONE
        snap_b = torch.where(is_l, COMMITTED_BALLOT, acc.acc_ballot)
        snap_v = torch.where(is_l, learned, acc.acc_vid)
        rep_mask = match.T[:, :, None]  # [P, A, 1]
        best_b = torch.where(rep_mask, snap_b[None], bal.NONE).amax(dim=1)
        best_v = torch.where(
            rep_mask & (snap_b[None] == best_b[:, None, :]), snap_v[None], _NEG
        ).amax(dim=1)
        take = (best_b != bal.NONE) & (best_b > adopted_b)
        adopted_b = torch.where(take, best_b, adopted_b)
        adopted_v = torch.where(take, best_v, adopted_v)

    # Phase-1 quorum -> PREPARED; build the accept batch skeleton.
    n_prom = promises2.sum(dim=1)
    now_prepared = (pr.mode == PREPARING) & (n_prom >= quorum) & prop_alive
    any_p1 = _any(now_prepared)
    cur_batch, acks = pr.cur_batch, pr.acks
    if any_p1:
        idx = b.idx
        committed_p = learned[pn] != val.NONE  # [P, I]
        use_adopt = ~committed_p & (adopted_b != bal.NONE)
        covered0 = committed_p | use_adopt
        hi_cov = torch.where(covered0, idx[None], -1).amax(dim=1)
        below = idx[None] <= hi_cov[:, None]
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
        cur_batch = torch.where(now_prepared[:, None], batch0, cur_batch)
        acks = torch.where(
            now_prepared[:, None, None], torch.zeros((), dtype=torch.int8, device=acks.device), acks
        )
    mode = torch.where(now_prepared, PREPARED, pr.mode)
    acc_retries = torch.where(now_prepared, pk.accept_retry_count, pr.acc_retries)
    acc_deadline = torch.where(
        now_prepared, t + 1 + pk.accept_retry_timeout, pr.acc_deadline
    )

    # New-value assignment (only on rounds with a live window entry).
    can_assign = (mode == PREPARED) & prop_alive
    qvid, live = _assignable_window(pr.pend, pr.gate, pr.head, pr.tail, None, b.w)
    any_window = _any(live & can_assign[:, None])
    own_assign, pend, head = pr.own_assign, pr.pend, pr.head
    k = torch.zeros((p,), dtype=_I32, device=mode.device)
    if any_window:
        cur_batch, own_assign, pend, head, k = _assign(
            b, pr, st, learned, cur_batch, live, qvid, can_assign
        )
    added = k > 0  # [P] -> (re)send accepts

    # ACCEPT_REPLY arrivals: per-instance acks derived at delivery.
    aecho = torch.where(rx_p, ar.acc_echo, bal.NONE)  # [A, P]
    amatch = (aecho == pr.ballot[None, :]) & (mode[None, :] == PREPARED)
    any_echo = _any(amatch)
    commit_vid = pr.commit_vid
    mvid, mround, mballot = st.met.chosen_vid, st.met.chosen_round, st.met.chosen_ballot
    newly = None
    if any_echo:
        acks, n_ack = sk.accum_acks(
            acks, cur_batch, acc.acc_ballot, acc.acc_vid, learned, pr.ballot,
            amatch.T.contiguous(),
        )
        inst_chosen = (cur_batch != val.NONE) & (n_ack >= quorum)
        newly = inst_chosen & (commit_vid == val.NONE) & prop_alive[:, None]
        if b.wedge:
            # seeded-wedge build: an already-chosen instance is never
            # re-committed
            newly = newly & (mvid == val.NONE)[None]
        commit_vid = torch.where(newly, cur_batch, commit_vid)
        any_new = newly.any(dim=0) & (mvid == val.NONE)
        new_v = torch.where(newly, cur_batch, _NEG).amax(dim=0)
        new_b = torch.where(newly, pr.ballot[:, None], _NEG).amax(dim=0)
        mvid = torch.where(any_new, new_v, mvid)
        mround = torch.where(any_new, t, mround)
        mballot = torch.where(any_new, new_b, mballot)
    met = st.met._replace(chosen_vid=mvid, chosen_round=mround, chosen_ballot=mballot)

    # COMMIT_REPLY arrivals: presence; per-instance ack by learned match.
    crep = ar.com_rep & rx_p  # [A, P]
    commit_acked, commit_wait = pr.commit_acked, pr.commit_wait
    if b.crash_faults or _any(crep):
        commit_acked = commit_acked | (
            crep.T[:, :, None]
            & (commit_vid != val.NONE)[:, None, :]
            & (learned[None] == commit_vid[:, None, :])
        )
        commit_wait = (
            (commit_vid != val.NONE)
            & ~(commit_acked | st.crashed[None, :, None]).all(dim=1)
        ).any(dim=1)  # [P]

    # Commit TAKEOVER on stall-threshold rounds (see the JAX module).
    take_commit = (pr.mode == PREPARED) & (pr.stall >= pk.stall_patience) & prop_alive
    if b.wedge:
        take_commit = torch.zeros_like(take_commit)
    if _any(take_commit):
        learned_pn = learned[pn]
        taken = (
            take_commit[:, None] & (learned_pn != val.NONE) & (commit_vid == val.NONE)
        )
        commit_vid = torch.where(taken, learned_pn, commit_vid)
        commit_wait = commit_wait | taken.any(dim=1)
    # A fresh decision is by construction not fully acked yet.
    if newly is not None:
        any_newly = newly.any(dim=1)
    else:
        any_newly = torch.zeros((p,), dtype=torch.bool, device=mode.device)
    commit_wait = commit_wait | any_newly
    resend_c = (t >= pr.commit_deadline) & commit_wait
    send_commit = (any_newly | resend_c | (take_commit & commit_wait)) & prop_alive
    commit_deadline = torch.where(
        send_commit, t + 1 + pk.commit_retry_timeout, pr.commit_deadline
    )

    # Conflict re-proposal + own-value completion (ref OnCommit).
    learned_p = learned[pn]
    own_has2 = own_assign != val.NONE
    conflict = own_has2 & (learned_p != val.NONE) & (learned_p != own_assign)
    own_done = own_has2 & (learned_p == own_assign)
    any_own_done = _any(own_done)
    if any_own_done:
        own_assign = torch.where(own_done, val.NONE, own_assign)
    any_conflict = _any(conflict)
    nreq = torch.zeros((p,), dtype=_I32, device=mode.device)
    if any_conflict:
        pend, nreq, own_assign = _requeue(b, pend, own_assign, pr.tail, conflict)
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
    ddl_hit = (mode == PREPARED) & (t >= acc_deadline) & prop_alive
    if _any(ddl_hit):
        outstanding = (
            (cur_batch != val.NONE) & (commit_vid == val.NONE)
            & (learned[pn] == val.NONE)
        )
        adl = ddl_hit & outstanding.any(dim=1)
    else:
        adl = ddl_hit
    resend_acc = adl & (acc_retries > 1)
    acc_fail = adl & (acc_retries <= 1)
    acc_retries = torch.where(resend_acc, acc_retries - 1, acc_retries)
    idle_restart = (mode == PREPARED) & (pr.stall >= pk.stall_patience) & prop_alive
    do_restart = restart_p | acc_fail | idle_restart
    delay_until = torch.where(do_restart, t + 1 + rnd_delay, pr.delay_until)
    mode = torch.where(do_restart, DELAY, mode)
    promises2 = promises2 & ~do_restart[:, None]

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
    promises2 = promises2 & ~start_prep[:, None]
    any_reset = _any(do_restart | start_prep)
    if any_reset:
        both = (do_restart | start_prep)[:, None]
        adopted_b = torch.where(both, bal.NONE, adopted_b)
        adopted_v = torch.where(both, val.NONE, adopted_v)
        cur_batch = torch.where(do_restart[:, None], val.NONE, cur_batch)
        acks = torch.where(
            do_restart[:, None, None], torch.zeros((), dtype=torch.int8, device=acks.device), acks
        )

    send_prep = start_prep | resend_prep
    want_acc_send = now_prepared | added | resend_acc
    if _any(want_acc_send):
        send_accept = want_acc_send & (cur_batch != val.NONE).any(dim=1)
    else:
        send_accept = want_acc_send

    # ---------------- network writes ----------------
    # Every send mask passes through the reachability cut; the message
    # counters below stay pre-fault.
    def cpa(m):  # [P, A] proposer->node send mask through the cuts
        return m if cut_pa is None else m & cut_pa

    def cap(m):  # [A, P] node->proposer send mask through the cuts
        return m if cut_ap is None else m & cut_ap

    bcast_a = b.bcast_a
    (al0, dl0), (al1, dl1), (al2, dl2), (al3, dl3), (al4, dl4), (al5, dl5), (al6, dl6) = plans
    send_rep = grant.T  # [A, P]
    send_rej = (rej_prep | rej_acc).T
    send_arep = elig.T  # [A, P] reply whenever ballot >= promised
    send_crep = cpres.T  # [A, P]
    net = netm.NetBuffers(
        prep_req=netm.write_ballot(
            net.prep_req, t, al0, dl0, ballot[:, None], cpa(send_prep[:, None] & bcast_a)
        ),
        prep_echo=netm.write_ballot(net.prep_echo, t, al1, dl1, preq.T, cap(send_rep)),
        rej=netm.write_ballot(
            net.rej, t, al2, dl2, acc.max_seen[:, None].expand(a, p), cap(send_rej)
        ),
        acc_req=netm.write_ballot(
            net.acc_req, t, al3, dl3, ballot[:, None], cpa(send_accept[:, None] & bcast_a)
        ),
        acc_echo=netm.write_ballot(
            net.acc_echo, t, al4, dl4, abal[None, :].expand(a, p), cap(send_arep)
        ),
        com_pres=netm.write_flag(
            net.com_pres, t, al5, dl5, cpa(send_commit[:, None] & bcast_a)
        ),
        com_rep=netm.write_flag(net.com_rep, t, al6, dl6, cap(send_crep)),
    )
    msgs = met.msgs + torch.stack([
        send_prep.sum() * a, send_rep.sum(), send_rej.sum(),
        send_accept.sum() * a, send_arep.sum(), send_commit.sum() * a,
        send_crep.sum(),
    ]).to(_I32)
    met = met._replace(msgs=msgs)

    # ---------------- crash injection ----------------
    crashed = st.crashed
    if crash_t is not None:
        # scheduled crash points apply before the i.i.d. draw, so its
        # minority-cap room accounts for them
        crashed = crashed | crash_t
    if b.iid_crash:
        want = (crash_u < b.crash_rate) & ~crashed
        room = b.max_crash - _sum32(crashed)
        allow = torch.cumsum(want.to(_I32), dim=0, dtype=_I32) <= room
        crashed = crashed | (want & allow)

    # ---------------- quiescence ----------------
    palive2 = (~crashed)[pn]
    q_change = (
        any_com_arr or any_echo or any_p1 or any_window or any_reset
        or any_own_done or any_conflict or t == 0
    )
    if b.crash_faults or q_change:
        inflight = (cur_batch != val.NONE) & (met.chosen_vid[None] == val.NONE)
        sums = torch.cat([
            _sum32(met.chosen_vid != val.NONE)[None],
            _sum32(learned != val.NONE, dim=1),  # [A]
            _sum32(inflight, dim=1),  # [P]
            (head != tail).to(_I32),  # [P]
            _sum32(own_assign != val.NONE, dim=1),  # [P]
        ])
        hmax = torch.where(met.chosen_vid != val.NONE, b.idx, -1).amax()
    else:
        sums, hmax = st.qsums, st.qhmax
    n_chosen = sums[0]
    n_learned = sums[1:1 + a]
    inflight_n = sums[1 + a:1 + a + p]
    q_pending = sums[1 + a + p:1 + a + 2 * p]
    own_n = sums[1 + a + 2 * p:1 + a + 3 * p]
    q_empty = ~(palive2 & (q_pending > 0)).any()
    own_none = ~(palive2 & (own_n > 0)).any()
    contiguous = n_chosen == hmax + 1
    learned_ok = ((n_learned == hmax + 1) | crashed).all()
    done = q_empty & own_none & contiguous & learned_ok & (t > 0)
    if b.horizon:
        # heal-then-converge: never quiescent before the last heal
        done = done & (t >= b.horizon)
    unresolved = ~(contiguous & learned_ok)
    idle_now = (
        (mode == PREPARED) & (inflight_n == 0) & ~commit_wait
        & (q_pending == 0) & (own_n == 0) & palive2
    )
    stall = torch.where(idle_now & unresolved & ~done, pr.stall + 1, 0)

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


def admit_block(st: SimState, admit, keep=None) -> SimState:
    """Open-loop admission (the serve harness's per-window upload)."""
    raise NotImplementedError("admit_block is not ported yet")


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


def init_state(cfg: SimConfig, pend, gate, tail, root, device="cuda") -> SimState:
    """Initial state on ``device`` (queue arrays as numpy or tensors)."""
    dev = devm.resolve(device)
    to_np = lambda x: x.cpu().numpy() if torch.is_tensor(x) else x  # noqa: E731
    return _init_state(cfg, to_np(pend), to_np(gate), to_np(tail), root, dev)


def run_loop(cfg: SimConfig, round_fn, root, state: SimState) -> SimState:
    """The whole-run driver: ``while ~done and t < round_budget``, the
    exact stop of the JAX engine's ``lax.while_loop``.  Consumes
    ``state`` (see :func:`build_engine`)."""
    budget = cfg.round_budget
    while not bool(state.done) and int(state.t) < budget:
        state = round_fn(root, state)
    return state


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
    return to_result(run_loop(cfg, round_fn, root, state), expected_vids)


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
