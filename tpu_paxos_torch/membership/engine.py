"""Synchronous-round membership engine in PyTorch (port of
``tpu_paxos/membership/engine.py``).

One call of the round function is one synchronous message exchange,
faithful to member/'s network, which delivers by calling the peer's
``OnReceive`` inline (ref member/main.cpp:65-79).  The protocol, the
crash model (per-node fail-stop crashes, admission-capped so every live
view keeps a live majority; node 0 never crashes), the version gate, the
Applied predicate and the composite change values are documented in the
JAX module; this port computes the same function round for round, so the
same (seed, injections, schedule) gives the same decision log.

How the port runs what JAX compiles:

- The round runs over a leading LANE axis (:func:`_lane_round`): a single
  run is lane 0, the member fleet (``fleet/member_runner.py``) runs ``L``
  lanes in the same round, and every lane's two coins of a round (the
  prepare backoff and the crash draw) come from one threefry pass.  A
  lane that is not running comes back exactly as it was given, as a
  finished lane's carry stays in a batched ``while_loop``.
- The JAX round has seven ``lax.cond`` sites.  Their predicates are read
  to the host in TWO packed reads a round: at the round's start which
  proposers have an open accept batch (the accept phase's outer cond and
  its per-proposer cond; a driver that read them with its own per-round
  read passes them in as ``acc_gate`` and this read goes away), and after
  the prepare phase which lanes requeue conflicts, which proposers
  prepare (the adoption phase's outer and per-proposer conds) and which
  take new values (the assignment cond).  The own-assignment clear runs
  unconditionally (one masked pass, the identity where its predicate is
  false).  A block runs when any lane needs it; on every other lane it
  is the identity by its masks, as ``vmap``'s select of both branches is.
- The requeue and injection scatters (``mode="drop"``) write only where
  they are in range: a dropped write never reaches the tensor.
- ``lax.while_loop`` becomes a host loop (:func:`_run_churn_lanes`), with
  the same stop, ``~done & t < max_rounds + horizon`` per lane, and the
  round number a host int.  ``ChurnEngine.run`` decides injection and
  termination from the tensors (one packed read a round, which also
  carries the next round's accept gate); ``ChurnEngine.run_host`` decides
  them from numpy reads, as the JAX host-stepped twin does.
- The geometry-padded round (``geometry=``, fleet data only) draws its
  two node-shaped coins at the dispatch's TRUE node count and pads them
  (backoff 0, crash coin 1e6), as JAX's ``lax.switch`` branches do.

State tensors carry an explicit device (``"cuda"`` unless the caller
names the CPU); asking for CUDA without a card raises.
"""

from __future__ import annotations

import hashlib
import json
import os
import types
from typing import NamedTuple

import numpy as np
import torch

from tpu_paxos_torch.core import ballot as bal
from tpu_paxos_torch.core import faults as fltm
from tpu_paxos_torch.core import geom as geo
from tpu_paxos_torch.core import values as val
from tpu_paxos_torch.core.sim import _freeze, _one_lane, _sum32, lane_of, lanes_view
from tpu_paxos_torch.fleet import schedule_table as stm
from tpu_paxos_torch.membership import churn_table as ctm
from tpu_paxos_torch.utils import counters
from tpu_paxos_torch.utils import device as devm
from tpu_paxos_torch.utils import prng

# Change kinds (ref member/paxos.cpp:61-69 enum MembershipChangeType)
ADD_LEARNER = 0
LEARNER_TO_PROPOSER = 1
PROPOSER_TO_ACCEPTOR = 2
DEL_LEARNER = 3
PROPOSER_TO_LEARNER = 4
ACCEPTOR_TO_PROPOSER = 5
# Composites (one log entry each, ref member/paxos.cpp:650-657, 706-714)
ADD_ACCEPTOR = 6
DEL_ACCEPTOR = 7

CHANGE_BASE = 2**28
COMMITTED_BALLOT = 2**30
_NEG = -(2**31)  # int32 min

ACCEPT_STALE_ROUNDS = 4  # restart prepare if a batch stalls this long

# Idle-liveness patience: an idle live proposer re-prepares after this
# many rounds whenever the log is unresolved (a hole below the chosen
# high-water mark, or an orphaned accepted value).
REPAIR_STALL_ROUNDS = 8

_I32 = torch.int32


def _file_sha256(path) -> str:
    """Content hash of a checkpoint artifact — pins a rejoin's input file
    in the injection log so replay can detect a swapped file."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def change_vid(node: int, kind: int) -> int:
    """Encode a membership change as a value id."""
    return CHANGE_BASE + node * 8 + kind


def is_change_vid(vid) -> bool:
    return np.asarray(vid) >= CHANGE_BASE


def decode_change(vid: int) -> tuple[int, int]:
    """-> (target node, kind)."""
    k = int(vid) - CHANGE_BASE
    return k // 8, k % 8


def membership_suffix(vid: int) -> str | None:
    """Decision-log suffix in the reference grammar (ref
    multi/paxos.cpp:20-22): ``m+id=ip:port`` for additive changes,
    ``m-id`` for removals; None for non-change vids."""
    if vid < CHANGE_BASE:
        return None
    node, kind = decode_change(vid)
    additive = kind in (
        ADD_LEARNER,
        LEARNER_TO_PROPOSER,
        PROPOSER_TO_ACCEPTOR,
        ADD_ACCEPTOR,
    )
    return f"m+{node}=node:{node}" if additive else f"m-{node}"


class MemberState(NamedTuple):
    t: torch.Tensor  # int32 round counter (0-d; [L] lane-stacked)
    crashed: torch.Tensor  # [N] bool fail-stop crash mask
    # per-viewing-node role masks: row v = node v's view
    learners: torch.Tensor  # [N, N] bool
    proposers: torch.Tensor  # [N, N] bool
    acceptors: torch.Tensor  # [N, N] bool
    version: torch.Tensor  # [N] int32
    # acceptor state
    promised: torch.Tensor  # [N] int32
    max_seen: torch.Tensor  # [N] int32
    acc_ballot: torch.Tensor  # [I, N] int32
    acc_vid: torch.Tensor  # [I, N] int32
    # learner state
    learned: torch.Tensor  # [I, N] int32
    applied_upto: torch.Tensor  # [N] int32 apply frontier
    # proposer state
    count: torch.Tensor  # [N] int32
    ballot: torch.Tensor  # [N] int32
    pmax: torch.Tensor  # [N] int32 max ballot seen via rejects
    prepared: torch.Tensor  # [N] bool
    delay_until: torch.Tensor  # [N] int32 prepare backoff
    adopted_b: torch.Tensor  # [N, I] int32
    adopted_v: torch.Tensor  # [N, I] int32
    cur_batch: torch.Tensor  # [N, I] int32
    acks: torch.Tensor  # [N, I, N] bool
    batch_age: torch.Tensor  # [N] int32 rounds since batch progress
    own_assign: torch.Tensor  # [N, I] int32
    pend: torch.Tensor  # [N, C] int32
    head: torch.Tensor  # [N] int32
    tail: torch.Tensor  # [N] int32
    stall: torch.Tensor  # [N] int32 idle rounds while the log is unresolved
    # decisions
    chosen_vid: torch.Tensor  # [I] int32
    chosen_round: torch.Tensor  # [I] int32
    chosen_ballot: torch.Tensor  # [I] int32


def _init_lanes(n: int, i: int, c: int, lanes: int, device) -> MemberState:
    """The initial state of ``lanes`` lanes, every leaf lane-leading:
    every node's view starts as {0} in all three role sets."""
    dev = devm.resolve(device)

    def none(*sh):
        return torch.full((lanes, *sh), bal.NONE, dtype=_I32, device=dev)

    def zero(*sh, dtype=_I32):
        return torch.zeros((lanes, *sh), dtype=dtype, device=dev)

    seed_view = zero(n, n, dtype=torch.bool)
    seed_view[:, :, 0] = True
    return MemberState(
        t=zero(),
        crashed=zero(n, dtype=torch.bool),
        learners=seed_view,
        proposers=seed_view.clone(),
        acceptors=seed_view.clone(),
        version=zero(n),
        promised=zero(n),
        max_seen=zero(n),
        acc_ballot=none(i, n),
        acc_vid=none(i, n),
        learned=none(i, n),
        applied_upto=zero(n),
        count=zero(n),
        ballot=zero(n),
        pmax=zero(n),
        prepared=zero(n, dtype=torch.bool),
        delay_until=zero(n),
        adopted_b=none(n, i),
        adopted_v=none(n, i),
        cur_batch=none(n, i),
        acks=zero(n, i, n, dtype=torch.bool),
        batch_age=zero(n),
        own_assign=none(n, i),
        pend=none(n, c),
        head=zero(n),
        tail=zero(n),
        stall=zero(n),
        chosen_vid=none(i),
        chosen_round=none(i),
        chosen_ballot=none(i),
    )


def _init(n: int, i: int, c: int, device="cuda") -> MemberState:
    """The initial single-run state on ``device``."""
    return lane_of(_init_lanes(n, i, c, 1, device), 0)


def _first(mask: torch.Tensor, width: int) -> torch.Tensor:
    """Index of the first true element along the last axis, ``width``
    where there is none (``argmax`` of the mask's first max, with the
    fallback the JAX engine gives a mask with no true element)."""
    idx = torch.arange(width, dtype=_I32, device=mask.device)
    return torch.where(mask, idx, width).amin(dim=-1)


def _host(*parts: torch.Tensor) -> np.ndarray:
    """Lane-leading ``[L, ...]`` predicates read to the host in ONE copy
    (one sync), as an int32 ``[L, sum of widths]`` array."""
    lanes = parts[0].shape[0]
    counters.add("host_reads")
    return torch.cat([p.reshape(lanes, -1).to(_I32) for p in parts], dim=1).cpu().numpy()


def _build_round(
    n: int,
    i_cap: int,
    c: int,
    crash_rate: int = 0,
    comp=None,
    runtime_schedule: bool = False,
    geometry=None,
    device="cuda",
):
    """Returns ``round_fn(root, st, tab=None, gidx=None, t=None)``: one
    round of one run (``tab`` the runtime ``ScheduleTable`` of a
    ``runtime_schedule`` build, ``gidx`` the menu index of a
    ``geometry``-padded build, ``t`` the state's round when the caller
    knows it, else it is read).  ``round_fn.lanes(roots, st, t, tab=None,
    running=None, gidx=None, acc_gate=None)`` is the same round over a
    leading lane axis (see :func:`_lane_round`).

    ``comp`` is a compiled fault schedule (``core/faults.compile_schedule``)
    or None; ``runtime_schedule=True`` takes the schedule per call as a
    lane-stacked ``fleet/schedule_table.ScheduleTable`` instead, exact
    against the compiled path.  member/'s network is synchronous, so an
    edge works only when reachability holds in BOTH directions.  Pauses
    subtract from the alive mask; ``crash(t0, nodes)`` episodes fail-stop
    at the END of round ``t0`` and land before the i.i.d. admission cap.

    ``geometry`` (a ``core.geom.GeometryEnvelope``) builds the padded
    round at the envelope's node bound; it needs ``runtime_schedule``."""
    if geometry is not None:
        if not runtime_schedule:
            raise ValueError(
                "a geometry-padded member round needs "
                "runtime_schedule=True (the padded engine is fleet "
                "data, not a compiled constant)"
            )
        if n != geometry.bound_nodes:
            raise ValueError(
                "a geometry-padded member round must be built at the "
                f"envelope node bound ({geometry.bound_nodes}), got "
                f"n={n}"
            )
    dev = devm.resolve(device)
    b = types.SimpleNamespace(
        n=n, i_cap=i_cap, c=c, crash_rate=int(crash_rate), comp=comp,
        runtime_schedule=runtime_schedule, geometry=geometry, dev=dev,
        horizon=comp.horizon if comp is not None else 0,
        has={k: runtime_schedule or (comp is not None and getattr(comp, f"has_{k}"))
             for k in ("reach", "pause", "crash")},
        idx=torch.arange(i_cap, dtype=_I32, device=dev),
        nodes=torch.arange(n, dtype=_I32, device=dev),
    )

    def lanes_fn(roots, st: MemberState, t: int, tab=None, running=None, gidx=None,
                 acc_gate=None) -> MemberState:
        """One round of ``L`` lanes: every leaf of ``st`` lane-leading,
        ``roots`` ``[L, 2]`` (``prng.root_keys``), ``t`` the round every
        running lane is at, ``tab`` the lane-stacked schedule tables of a
        runtime build, ``running`` an ``[L]`` bool array (None: every lane
        runs), ``gidx`` the padded build's menu index, ``acc_gate`` an
        optional host ``[L, N]`` bool array of ``prepared & any(cur_batch
        != NONE) & ~crashed`` at the round's start."""
        if runtime_schedule and tab is None:
            raise TypeError(
                "this member round was built with runtime_schedule=True; "
                "it needs a ScheduleTable argument"
            )
        if (geometry is not None) != (gidx is not None):
            raise TypeError(
                "a geometry-padded member round takes its menu index per "
                "call (gidx=); a bound-free round takes none"
            )
        counters.add("rounds")
        return _lane_round(b, roots, st, int(t), tab, running, gidx, acc_gate)

    def round_fn(root, st: MemberState, tab=None, gidx=None, t=None) -> MemberState:
        """One round of one run: :func:`_lane_round` at one lane."""
        if tab is not None:
            tab = _one_lane(tab)
        roots = np.asarray([root], np.uint64)
        t = int(st.t) if t is None else int(t)
        return lane_of(lanes_fn(roots, lanes_view(st), t, tab, gidx=gidx), 0)

    round_fn.lanes = lanes_fn
    return round_fn


def _lane_round(b, roots, st: MemberState, t: int, tab, running, gidx, acc_gate) -> MemberState:
    """The round over a leading lane axis ``L`` (one synchronous exchange:
    accept, anti-entropy pull, apply frontier, staleness, conflict
    requeue, idle repair, prepare with adoption, assignment, crash
    injection).  The JAX round's ``lax.cond`` blocks run here when any
    lane needs them; each is the identity by its masks on every other
    lane (see the module doc)."""
    n, i_cap, c, dev = b.n, b.i_cap, b.c, b.dev
    lanes = st.t.shape[0]
    idx = b.idx
    NONE = val.NONE

    # ---- the round's host rows (schedule masks, running lanes) and coins
    rows = {}
    if b.runtime_schedule:
        reach, paused, _extra, _gray = stm.masks_at(tab, t)
        rows = {"reach": reach, "pause": paused, "crash": stm.crashes_at(tab, t)}
    elif b.comp is not None:
        tt = min(t, b.horizon)
        for name, table in (("pause", "paused"), ("reach", "reach"), ("crash", "crashed")):
            if b.has[name]:
                row = getattr(b.comp, table)[tt]
                rows[name] = np.broadcast_to(row, (lanes, *row.shape))
    if running is not None:
        rows["run"] = running
    rows_d = {}
    if rows:
        parts = [np.asarray(x, np.int32).reshape(-1) for x in rows.values()]
        flat = devm.to_device(torch.from_numpy(np.concatenate(parts)), dev)
        for (name, x), part in zip(rows.items(), torch.split(flat, [len(q) for q in parts])):
            rows_d[name] = part.reshape(np.shape(x)).bool()
    kd = prng.stream_keys(roots, prng.STREAM_PREPARE_DELAY, t)
    ku = prng.stream_keys(roots, prng.STREAM_CRASH, t)
    coins = None
    if b.geometry is None:
        reqs = [(kd, (n,), 0, 4)] + ([(ku, (n,), 0, 1_000_000)] if b.crash_rate else [])
        drawn = prng.randint_lanes(reqs, dev)
        backoff = drawn[0]
        if b.crash_rate:
            coins = drawn[1]
    else:
        # menu-switched draws at the TRUE node count (pad nodes never
        # prepare; a pad coin of 1e6 never crashes: the test is strict)
        backoff = geo.menu_randint(b.geometry, gidx, kd, "nodes", 0, 4, pad_value=0, device=dev)
        if b.crash_rate:
            coins = geo.menu_randint(b.geometry, gidx, ku, "nodes", 0, 1_000_000,
                                     pad_value=1_000_000, device=dev)

    exist = ~st.crashed  # [L, N] not-crashed (excusals key off this)
    alive = exist
    if "pause" in rows_d:
        alive = alive & ~rows_d["pause"]
    reach_t = rows_d.get("reach")  # [L, N, N]
    reach2 = reach_t & reach_t.transpose(1, 2) if reach_t is not None else None
    sched_crash = rows_d.get("crash")
    run_d = rows_d.get("run")

    # node-local roles (a node acts on its OWN view of itself)
    is_prop = st.proposers.diagonal(dim1=1, dim2=2) & alive  # [L, N]
    is_accp = st.acceptors.diagonal(dim1=1, dim2=2) & alive
    quorum_v = _sum32(st.acceptors, dim=2) // 2 + 1  # [L, N] (crashes do NOT shrink it)
    same_version = st.version[:, :, None] == st.version[:, None, :]

    # ---------- ACCEPT phase (batches from previously prepared) ----------
    has_batch = (st.cur_batch != NONE).any(dim=2)  # [L, V]
    send_acc = st.prepared & has_batch & alive
    if acc_gate is None:
        host_send = _host(send_acc).astype(bool)  # read 1 of the round
    else:
        host_send = np.asarray(acc_gate, bool)
        if "pause" in rows:
            host_send = host_send & ~np.asarray(rows["pause"], bool)
    if running is not None:
        host_send = host_send & np.asarray(running, bool)[:, None]
    edge = send_acc[:, :, None] & st.acceptors & is_accp[:, None, :] & same_version  # [L, V, A]
    if reach2 is not None:
        edge = edge & reach2
    ballot0 = st.ballot
    elig = edge & (ballot0[:, :, None] >= st.promised[:, None, :])
    max_seen = torch.maximum(
        st.max_seen, torch.where(edge, ballot0[:, :, None], bal.NONE).amax(dim=1))
    rejed = edge & ~elig
    pmax = torch.maximum(
        st.pmax, torch.where(rejed, max_seen[:, None, :], bal.NONE).amax(dim=2))

    acc_ballot, acc_vid, acks = st.acc_ballot, st.acc_vid, st.acks
    chosen_vid, chosen_round, chosen_ballot = st.chosen_vid, st.chosen_round, st.chosen_ballot
    learned = st.learned
    newly_any = torch.zeros((lanes, n), dtype=torch.bool, device=dev)
    active = [v for v in range(n) if host_send[:, v].any()]
    if active:
        is_comm = learned != NONE  # [L, I, A]
        best_b = torch.full_like(learned, bal.NONE)
        best_v = torch.full_like(learned, NONE)
        lbest = torch.full_like(learned, _NEG)
        any_new = torch.zeros_like(chosen_vid, dtype=torch.bool)
        new_v = torch.full_like(chosen_vid, _NEG)
        new_b = torch.full_like(chosen_vid, _NEG)
        none_yet = chosen_vid == NONE  # [L, I]
        new_acks = list(acks.unbind(dim=1))
        newly_rows = list(newly_any.unbind(dim=1))
        for v in active:
            batv = st.cur_batch[:, v]  # [L, I]
            w_has = batv != NONE
            bv = ballot0[:, v, None, None]
            ackv = (
                elig[:, v, None, :] & w_has[:, :, None]
                & torch.where(is_comm, batv[:, :, None] == learned, bv >= acc_ballot)
            )  # [L, I, A]
            candv = torch.where(ackv & ~is_comm, bv, bal.NONE)
            take = candv > best_b
            best_b = torch.where(take, candv, best_b)
            best_v = torch.where(take, batv[:, :, None], best_v)
            av_new = acks[:, v] | ackv
            n_ack = _sum32(av_new & st.acceptors[:, v, None, :], dim=2)  # [L, I]
            # per-instance quorum over the proposer's view; a crashed
            # proposer detects nothing; send_acc keeps an idle lane idle
            chosen_v = (
                w_has & (n_ack >= quorum_v[:, v, None])
                & (alive[:, v] & send_acc[:, v])[:, None]
            )
            newly_v = chosen_v & none_yet
            any_new = any_new | newly_v
            new_v = torch.maximum(new_v, torch.where(newly_v, batv, _NEG))
            new_b = torch.maximum(new_b, torch.where(newly_v, ballot0[:, v, None], _NEG))
            # LEARN broadcast to the chooser's view-learners
            le_v = chosen_v[:, :, None] & (st.learners[:, v] & alive)[:, None, :]
            if reach_t is not None:
                le_v = le_v & reach_t[:, v, None, :]
            lbest = torch.maximum(lbest, torch.where(le_v, batv[:, :, None], _NEG))
            new_acks[v] = av_new
            newly_rows[v] = newly_v.any(dim=1)
        acks = torch.stack(new_acks, dim=1)
        newly_any = torch.stack(newly_rows, dim=1)
        do_store = best_b != bal.NONE
        acc_ballot = torch.where(do_store, best_b, acc_ballot)
        acc_vid = torch.where(do_store, best_v, acc_vid)
        chosen_vid = torch.where(any_new, new_v, chosen_vid)
        chosen_round = torch.where(any_new, t, chosen_round)
        chosen_ballot = torch.where(any_new, new_b, chosen_ballot)
        learned = torch.where((lbest != _NEG) & (learned == NONE), lbest, learned)

    # ---------- anti-entropy pull at each node's first learned gap ----------
    gap = learned.transpose(1, 2) == NONE  # [L, N, I]
    f = _first(gap, i_cap).clamp(0, i_cap - 1).long()  # [L, N]
    mine = learned.gather(1, f[:, None, :]).squeeze(1)  # [L, N] own copy at the frontier
    l_at_f = learned.gather(1, f[:, :, None].expand(lanes, n, n))  # [L, nn, m]
    donor_ok = (l_at_f != NONE) & st.learners.transpose(1, 2) & alive[:, None, :]
    if reach_t is not None:
        donor_ok = donor_ok & reach_t.transpose(1, 2)  # pull rides an m -> nn send
    can_pull = donor_ok.any(dim=2) & (mine == NONE) & alive
    pulled = torch.where(donor_ok, l_at_f, _NEG).amax(dim=2)
    learned = learned.scatter(1, f[:, None, :], torch.where(can_pull, pulled, mine)[:, None, :])

    # ---------- apply frontier ----------
    fa = st.applied_upto  # [L, N]
    lme = learned.transpose(1, 2)  # [L, N, I]
    nonchg = (lme != NONE) & (lme < CHANGE_BASE)
    pre = idx < fa[:, :, None]
    run_total = _first(~(nonchg | pre), i_cap)
    run = torch.where(alive, torch.clamp(run_total - fa, min=0), 0)  # crashed logs freeze
    f2 = (fa + run).clamp(0, i_cap - 1).long()
    head_v = learned.gather(1, f2[:, None, :]).squeeze(1)  # entry right after the run
    can_apply = (head_v != NONE) & (fa + run < i_cap) & (head_v >= CHANGE_BASE) & alive
    k = torch.where(can_apply, head_v - CHANGE_BASE, 0)
    tgt = (k // 8).long()
    kind = k % 8

    def setrole(roles, add, rem):
        cur = roles.gather(2, tgt[:, :, None]).squeeze(2)
        new = torch.where(add, True, torch.where(rem, False, cur))
        return roles.scatter(2, tgt[:, :, None], new[:, :, None])

    learners_v = setrole(
        st.learners, can_apply & ((kind == ADD_LEARNER) | (kind == ADD_ACCEPTOR)),
        can_apply & ((kind == DEL_LEARNER) | (kind == DEL_ACCEPTOR)))
    proposers_v = setrole(
        st.proposers, can_apply & ((kind == LEARNER_TO_PROPOSER) | (kind == ADD_ACCEPTOR)),
        can_apply & ((kind == PROPOSER_TO_LEARNER) | (kind == DEL_ACCEPTOR)))
    adda = can_apply & ((kind == PROPOSER_TO_ACCEPTOR) | (kind == ADD_ACCEPTOR))
    dela = can_apply & ((kind == ACCEPTOR_TO_PROPOSER) | (kind == DEL_ACCEPTOR))
    acceptors_v = setrole(st.acceptors, adda, dela)
    acc_changed = adda | dela
    version = st.version + acc_changed.to(_I32)
    applied_upto = fa + run + can_apply.to(_I32)
    # AcceptorsChanged -> proposer restarts its prepare
    prepared = st.prepared & ~acc_changed

    # batch staleness: no progress for too long -> restart prepare
    outstanding = ((st.cur_batch != NONE) & (chosen_vid[:, None, :] == NONE)).any(dim=2)
    batch_age = torch.where(newly_any | ~outstanding, 0, st.batch_age + 1)
    stale = outstanding & (batch_age >= ACCEPT_STALE_ROUNDS)
    prepared = prepared & ~stale
    delay_until = torch.where(stale, t + 1 + backoff, st.delay_until)
    batch_age = torch.where(stale, 0, batch_age)

    # conflict re-proposal / own completion
    learned_me = learned.transpose(1, 2)  # [L, N, I]
    committed_me = learned_me != NONE
    own_has = (st.own_assign != NONE) & alive[:, :, None]
    conflict = own_has & committed_me & (learned_me != st.own_assign)
    own_done = own_has & (learned_me == st.own_assign)
    tail = st.tail + _sum32(conflict, dim=2)  # the requeue's tail, exact without its cond
    own_assign = torch.where(conflict | own_done, NONE, st.own_assign)

    # drop chosen instances from batches (quiesce bookkeeping)
    cur_batch = torch.where(chosen_vid[:, None, :] != NONE, NONE, st.cur_batch)
    cur_batch = torch.where(prepared[:, :, None], cur_batch, NONE)
    acks = torch.where(prepared[:, :, None, None], acks, False)

    # ---------- idle-liveness repair ----------
    hw = torch.where(chosen_vid != NONE, idx, -1).amax(dim=1)  # [L]
    undecided = chosen_vid == NONE
    hole = (undecided & (idx <= hw[:, None])).any(dim=1)
    # an orphan held only outside every live node's view is unresolvable
    in_view = (acceptors_v & alive[:, :, None]).any(dim=1)  # [L, N]
    held = ((acc_vid != NONE) & (alive & in_view)[:, None, :]).any(dim=2)  # [L, I]
    orphan = (undecided & held).any(dim=1)
    unresolved = hole | orphan
    no_work = (st.head >= tail) & (own_assign == NONE).all(dim=2)
    idle = is_prop & no_work & ~outstanding
    stall = torch.where(idle & unresolved[:, None], st.stall + 1, 0)
    repair_kick = is_prop & (stall >= REPAIR_STALL_ROUNDS) & (t >= delay_until)
    stall = torch.where(repair_kick, 0, stall)
    prepared = prepared & ~repair_kick

    # ---------- PREPARE phase ----------
    has_work = (st.head < tail) | (own_assign != NONE).any(dim=2)
    want_prep = is_prop & ~prepared & (has_work | repair_kick) & (t >= delay_until)
    ncnt, nbal = bal.bump_past(st.count, b.nodes, torch.maximum(pmax, ballot0))
    count = torch.where(want_prep, ncnt, st.count)
    ballot = torch.where(want_prep, nbal, ballot0)
    pedge = (
        want_prep[:, :, None] & acceptors_v & is_accp[:, None, :]
        & (version[:, :, None] == version[:, None, :])
    )
    if reach2 is not None:
        pedge = pedge & reach2
    grant = pedge & (ballot[:, :, None] > st.promised[:, None, :])
    promised = torch.maximum(
        st.promised, torch.where(grant, ballot[:, :, None], bal.NONE).amax(dim=1))
    max_seen = torch.maximum(
        max_seen, torch.where(pedge, ballot[:, :, None], bal.NONE).amax(dim=1))
    pmax = torch.maximum(
        pmax, torch.where(pedge & ~grant, max_seen[:, None, :], bal.NONE).amax(dim=2))
    n_prom = _sum32(grant & acceptors_v, dim=2)
    now_prep = want_prep & (n_prom >= quorum_v)
    prepared = prepared | now_prep
    delay_until = torch.where(want_prep & ~now_prep, t + 1 + backoff, delay_until)
    any_conf = conflict.any(dim=2).any(dim=1)  # [L]
    has_q = prepared & alive & (tail > st.head)

    # read 2 of the round: requeue, adoption and assignment predicates
    host = _host(any_conf, want_prep, has_q).astype(bool)
    if running is not None:
        host = host & np.asarray(running, bool)[:, None]
    h_conf, h_prep, h_q = host[:, 0], host[:, 1:1 + n], host[:, 1 + n:]

    # requeue: conflicted own values back at the ring's tail (positions
    # unique per row: tail + rank); out-of-ring writes are dropped
    pend = st.pend
    if h_conf.any():
        rr = torch.cumsum(conflict.to(_I32), dim=2) - 1
        pos = st.tail[:, :, None] + rr
        pos = torch.where(conflict & (pos < c), pos, c).long()
        ext = torch.cat([pend, pend.new_full((lanes, n, 1), NONE)], dim=2)
        pend = ext.scatter(2, pos, st.own_assign)[:, :, :c]

    # snapshot reply + adoption + batch skeleton per preparing proposer
    adopted_b = adopted_v = None
    if h_prep.any():
        snap_b = torch.where(learned != NONE, COMMITTED_BALLOT, acc_ballot)  # [L, I, A]
        snap_v = torch.where(learned != NONE, learned, acc_vid)
        nones = torch.full_like(cur_batch[:, 0], bal.NONE)
        ab_rows, av_rows = [nones] * n, [nones] * n
        cb_rows, ak_rows = list(cur_batch.unbind(dim=1)), list(acks.unbind(dim=1))
        for v in range(n):
            if not h_prep[:, v].any():
                continue
            np_v = now_prep[:, v, None]  # [L, 1]
            repb = torch.where(grant[:, v, None, :], snap_b, bal.NONE)  # [L, I, A]
            best_ab = repb.amax(dim=2)  # [L, I]
            sel = (repb == best_ab[:, :, None]) & (repb != bal.NONE)
            best_av = torch.where(sel, snap_v, _NEG).amax(dim=2)
            ab_v = torch.where(np_v & (best_ab > 0), best_ab, bal.NONE)
            av_v = torch.where(np_v & (best_ab > 0), best_av, NONE)
            comm_v = committed_me[:, v]
            use_adopt = ~comm_v & (ab_v != bal.NONE)
            covered0 = comm_v | use_adopt
            hi = torch.where(covered0, idx, -1).amax(dim=1)  # [L]
            below = idx <= hi[:, None]
            noop_fill = below & ~covered0
            own_v = own_assign[:, v]
            use_own = ~below & (own_v != NONE)
            noop = val.noop_vid(idx, b.nodes[v], i_cap)
            batch0 = torch.where(
                use_adopt, av_v,
                torch.where(noop_fill, noop, torch.where(use_own, own_v, NONE)))
            batch0 = torch.where(comm_v, NONE, batch0)
            ab_rows[v], av_rows[v] = ab_v, av_v
            cb_rows[v] = torch.where(np_v, batch0, cur_batch[:, v])
            ak_rows[v] = torch.where(np_v[:, :, None], False, acks[:, v])
        adopted_b, adopted_v = torch.stack(ab_rows, dim=1), torch.stack(av_rows, dim=1)
        cur_batch, acks = torch.stack(cb_rows, dim=1), torch.stack(ak_rows, dim=1)
    else:
        adopted_b = torch.full_like(cur_batch, bal.NONE)
        adopted_v = torch.full_like(cur_batch, NONE)
    batch_age = torch.where(now_prep, 0, batch_age)

    # new-value assignment for prepared proposers (first fit over the
    # open tail)
    head = st.head
    if h_q.any():
        can_assign = prepared & alive
        activity = committed_me | (cur_batch != NONE) | (own_assign != NONE)
        hi2 = torch.where(activity, idx, -1).amax(dim=2)  # [L, N]
        free = idx > hi2[:, :, None]
        qn = torch.clamp(tail - head, max=i_cap)
        # the free instances are the suffix past hi2, so JAX's running
        # count of them (cumsum - 1) is idx - hi2 - 1 there, -1 before
        free_rank = torch.where(free, idx - hi2[:, :, None] - 1, -1)
        kk = torch.minimum(qn, i_cap - 1 - hi2)
        kk = torch.where(can_assign, kk, 0)
        takev = free & (free_rank < kk[:, :, None])
        qpos = (head[:, :, None] + free_rank).clamp(0, c - 1).long()
        newv = pend.gather(2, qpos)
        cur_batch = torch.where(takev, newv, cur_batch)
        own_assign = torch.where(takev, newv, own_assign)
        head = head + kk

    # ---------- crash injection ----------
    # scheduled crash points land first (not admission-capped); then
    # Bernoulli(crash_rate/1e6) per live node, admitted one candidate at
    # a time only if every node left alive keeps a live majority of its
    # own view's acceptors; node 0 never crashes
    base = exist if sched_crash is None else exist & ~sched_crash
    if b.crash_rate:
        want = (coins < b.crash_rate) & base
        qv_new = _sum32(acceptors_v, dim=2) // 2 + 1
        alive_c = base
        for x in range(1, n):
            still = alive_c & (b.nodes != x)
            live_acc = _sum32(acceptors_v & still[:, None, :], dim=2)
            ok = (~still | (live_acc >= qv_new)).all(dim=1)
            alive_c = torch.where((want[:, x] & ok)[:, None], still, alive_c)
        crashed = ~alive_c
    else:
        crashed = ~base

    new = MemberState(
        t=st.t + 1,
        crashed=crashed,
        learners=learners_v,
        proposers=proposers_v,
        acceptors=acceptors_v,
        version=version,
        promised=promised,
        max_seen=max_seen,
        acc_ballot=acc_ballot,
        acc_vid=acc_vid,
        learned=learned,
        applied_upto=applied_upto,
        count=count,
        ballot=ballot,
        pmax=pmax,
        prepared=prepared,
        delay_until=delay_until,
        adopted_b=adopted_b,
        adopted_v=adopted_v,
        cur_batch=cur_batch,
        acks=acks,
        batch_age=batch_age,
        own_assign=own_assign,
        pend=pend,
        head=head,
        tail=tail,
        stall=stall,
        chosen_vid=chosen_vid,
        chosen_round=chosen_round,
        chosen_ballot=chosen_ballot,
    )
    if run_d is not None:
        new = _freeze(st, new, run_d)
    return new


def _check_member_schedule(schedule) -> None:
    """Membership-engine schedule constraints: deterministic crash
    episodes are accepted, never of node 0 (the harness driver); ``gray``
    episodes are rejected by name (member/'s network is synchronous: no
    arrival calendar to inflate)."""
    if schedule is None:
        return
    for e in schedule.episodes:
        if e.kind == "crash" and 0 in e.nodes:
            raise ValueError(
                "node 0 is the harness driver; it stays up (crash "
                f"episode at t0={e.t0} names node 0)"
            )
        if e.kind == "gray":
            raise ValueError(
                "the membership engine does not support gray episodes "
                "(synchronous network — no arrival calendar to "
                f"inflate; gray episode at [{e.t0},{e.t1}))"
            )


# ---------------- decision-log surface ----------------------------------

def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def applied_log_of(state: MemberState, node: int) -> np.ndarray:
    """Real (non-noop, non-change) values ``node`` has applied, in order
    — what the reference's checking StateMachine collects (ref
    member/main.cpp:223-233)."""
    upto = int(state.applied_upto[node])
    col = _np(state.learned[:upto, node])
    return col[(col >= 0) & (col < CHANGE_BASE)]


def decision_log_of(state: MemberState, n_nodes: int | None = None) -> str:
    """Canonical decision-log text — chosen (vid, round, ballot) per
    instance plus each node's applied log — the byte-compare surface for
    record-vs-replay and for the two drivers' parity.  A geometry-padded
    caller passes its TRUE ``n_nodes``."""
    cv, cr, cb = _np(state.chosen_vid), _np(state.chosen_round), _np(state.chosen_ballot)
    lines = [f"[{i}] = <{cv[i]}>@{cr[i]}#{cb[i]}" for i in np.flatnonzero(cv != val.NONE)]
    # the two fields the applied logs read, copied to the host once
    host = types.SimpleNamespace(applied_upto=_np(state.applied_upto), learned=_np(state.learned))
    n = state.crashed.shape[0] if n_nodes is None else int(n_nodes)
    for node in range(n):
        seq = " ".join(map(str, applied_log_of(host, node).tolist()))
        lines.append(f"applied[{node}] = {seq}")
    return "\n".join(lines) + "\n"


# ---------------- the churn drivers' predicates --------------------------

def _chosen_applied(st: MemberState, vid: torch.Tensor):
    """``(chosen, applied)`` ``[L]`` for one vid a lane (``vid [L]``), as
    ``MemberSim.chosen`` / ``MemberSim.applied(viewer=0)`` read them:
    Applied = a majority of node 0's CURRENT acceptor view has learned
    the instance where ``vid`` was chosen."""
    inst = st.chosen_vid == vid[:, None]  # [L, I]
    chosen = inst.any(dim=1)
    k = torch.where(chosen, _first(inst, inst.shape[1]), 0).long()  # first hit
    row = st.learned.gather(1, k[:, None, None].expand(-1, 1, st.learned.shape[2])).squeeze(1)
    acc0 = st.acceptors[:, 0]  # [L, N]
    quorum = _sum32(acc0, dim=1) // 2 + 1
    n_learned = _sum32(acc0 & (row != val.NONE), dim=1)
    return chosen, chosen & (n_learned >= quorum)


def _pick(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """``x[l, e[l]]`` for ``[L, E]`` tables."""
    return x.gather(1, e[:, None].long()).squeeze(1)


def _churn_inject(ctab, cursor, st: MemberState, c: int, running=None):
    """One driver decision a lane: if the cursor's event is ready (``t >=
    t0`` and the wait gate on the previous event holds), push its vid
    into ``via``'s pending ring at the tail and advance the cursor.  At
    most one injection a round.  ``ctab`` is lane-stacked tensors,
    ``cursor`` ``[L]``; a lane where ``running`` is false injects nothing.
    Returns ``(st, cursor)``."""
    lanes, e_cap = ctab.vid.shape
    n = st.tail.shape[1]
    e = torch.clamp(cursor, max=e_cap - 1)
    valid = cursor < ctab.n_events
    w = _pick(ctab.wait, e)
    prev_chosen, prev_applied = _chosen_applied(st, _pick(ctab.vid, torch.clamp(e - 1, min=0)))
    gate = (
        (w == ctm.WAIT_NONE)
        | ((w == ctm.WAIT_CHOSEN) & prev_chosen)
        | ((w == ctm.WAIT_APPLIED) & prev_applied)
    )
    ready = valid & (st.t >= _pick(ctab.t0, e)) & gate
    if running is not None:
        ready = ready & running
    via = _pick(ctab.via, e).long()
    pos = st.tail.gather(1, via[:, None]).squeeze(1)
    # guarded write: a not-ready lane (or an out-of-ring slot) keeps its cell
    flat = st.pend.reshape(lanes, -1)
    lin = (via * c + torch.clamp(pos, max=c - 1).long())[:, None]
    cell = torch.where(ready & (pos < c), _pick(ctab.vid, e), flat.gather(1, lin).squeeze(1))
    pend = flat.scatter(1, lin, cell[:, None]).view(st.pend.shape)
    onehot = torch.arange(n, device=via.device) == via[:, None]
    tail = st.tail + (onehot & ready[:, None]).to(_I32)
    return st._replace(pend=pend, tail=tail), cursor + ready.to(_I32)


def _churn_done(ctab, cursor, st: MemberState) -> torch.Tensor:
    """Run-complete predicate ``[L]``: every event injected, every event
    vid chosen, the LAST change event Applied, and every live learner in
    node 0's final view caught up to the chosen log."""
    lanes, e_cap = ctab.vid.shape
    eix = torch.arange(e_cap, dtype=_I32, device=cursor.device)
    evalid = eix < ctab.n_events[:, None]
    hit = (ctab.vid[:, :, None] == st.chosen_vid[:, None, :]).any(dim=2)  # [L, E]
    chosen_all = (hit | ~evalid).all(dim=1)
    last = torch.where(ctab.is_change & evalid, eix, -1).amax(dim=1)
    _, last_applied = _chosen_applied(st, _pick(ctab.vid, torch.clamp(last, min=0)))
    changes_ok = (last < 0) | last_applied
    chosen_i = st.chosen_vid != val.NONE  # [L, I]
    owed = ~st.crashed & st.learners[:, 0]  # [L, N]
    caught_up = (~chosen_i[:, :, None] | (st.learned != val.NONE) | ~owed[:, None, :]).reshape(
        lanes, -1).all(dim=1)
    return (cursor >= ctab.n_events) & chosen_all & changes_ok & caught_up


def _accept_gate(st: MemberState) -> torch.Tensor:
    """``[L, N]``: ``prepared & any(cur_batch != NONE) & ~crashed``, the
    part of a round's accept predicate that the state alone decides."""
    return st.prepared & (st.cur_batch != val.NONE).any(dim=2) & ~st.crashed


def _applied_host(st: MemberState, vid: int) -> bool:
    """Host mirror of the Applied predicate over numpy reads."""
    cv = _np(st.chosen_vid)
    hits = np.flatnonzero(cv == vid)
    if not hits.size:
        return False
    row = _np(st.learned[int(hits[0])])
    acc0 = _np(st.acceptors[0])
    return int((acc0 & (row != int(val.NONE))).sum()) >= int(acc0.sum()) // 2 + 1


def _ready_host(ctab, cur: int, st: MemberState, t: int) -> bool:
    """Host mirror of the injection gate of :func:`_churn_inject` (``t``:
    the state's round)."""
    if cur >= int(ctab.n_events) or t < int(ctab.t0[cur]):
        return False
    w = int(ctab.wait[cur])
    if w == ctm.WAIT_NONE:
        return True
    prev_vid = int(ctab.vid[max(cur - 1, 0)])
    chosen = bool((_np(st.chosen_vid) == prev_vid).any())
    if w == ctm.WAIT_CHOSEN:
        return chosen
    return chosen and _applied_host(st, prev_vid)


def _done_host(ctab, cur: int, st: MemberState) -> bool:
    """Host mirror of the run-complete predicate :func:`_churn_done`."""
    n_events = int(ctab.n_events)
    if cur < n_events:
        return False
    cv = _np(st.chosen_vid)
    vids = np.asarray(ctab.vid)[:n_events]
    if not np.isin(vids, cv).all():
        return False
    chg = np.flatnonzero(np.asarray(ctab.is_change)[:n_events])
    if chg.size and not _applied_host(st, int(vids[int(chg[-1])])):
        return False
    learned = _np(st.learned)  # [I, N]
    owed = ~_np(st.crashed) & _np(st.learners[0])
    chosen_i = cv != int(val.NONE)
    return not (chosen_i[:, None] & (learned == int(val.NONE)) & owed[None, :]).any()


def _check_churn_capacity(ctab, i_cap: int, c: int, lane: int | None = None) -> None:
    """The pending-ring capacity proof for both drivers and the fleet:
    ``i_cap`` slots stay reserved for conflict requeues, so all of a
    node's injected events must fit below ``c - i_cap``."""
    per_via = np.bincount(np.asarray(ctab.via)[: int(ctab.n_events)], minlength=1)
    if per_via.size and int(per_via.max()) > c - i_cap:
        where = f"lane {lane}'s churn schedule" if lane is not None else "churn schedule"
        raise ValueError(
            f"{where} injects {int(per_via.max())} events via one "
            f"node; the pending ring holds {c - i_cap} (requeue "
            "headroom reserved)"
        )


def _device_table(ctab, dev) -> ctm.ChurnTable:
    """A host ``ChurnTable`` as tensors on ``dev``."""
    return ctm.ChurnTable(*[devm.to_device(torch.from_numpy(np.ascontiguousarray(x)), dev)
                            for x in ctab])


def _run_churn_lanes(round_fn, roots, st: MemberState, ctab, ftab, budgets, gidx=None):
    """The whole-run churn loop of ``L`` lanes — inject -> round ->
    run-complete? — a batched ``while_loop``: lane ``l`` runs while
    ``~done[l] & t < budgets[l]`` and a lane that stops keeps its state,
    round counter and cursor while the others run on.  ``ctab`` is the
    lane-stacked host ``ChurnTable``, ``ftab`` the lane-stacked host
    ``ScheduleTable`` of a runtime build (None for a compiled-constant
    one), ``gidx`` a padded build's menu index.  Injection and
    termination are decided on the device; each round makes one packed
    read (done flags, cursors and the next round's accept gate).
    Returns ``(state, cursor, done)`` on the device."""
    dev = st.t.device
    lanes = roots.shape[0]
    budgets = np.asarray(budgets, np.int64)
    ctab_d = _device_table(ctab, dev)
    n_events = np.asarray(ctab.n_events, np.int64)
    cursor = torch.zeros((lanes,), dtype=_I32, device=dev)
    done = torch.zeros((lanes,), dtype=torch.bool, device=dev)
    c = st.pend.shape[2]
    t = 0
    host = _host(done, cursor, _accept_gate(st))
    while True:
        done_h, cur_h, gate_h = host[:, 0].astype(bool), host[:, 1], host[:, 2:].astype(bool)
        running = ~done_h & (t < budgets)
        if not running.any():
            break
        run = None if running.all() else running
        run_d = None if run is None else devm.to_device(torch.from_numpy(run), dev)
        if (running & (cur_h < n_events)).any():
            st, cursor = _churn_inject(ctab_d, cursor, st, c, run_d)
        st = round_fn.lanes(roots, st, t, ftab, running=run, gidx=gidx, acc_gate=gate_h)
        if (running & (cur_h + 1 >= n_events)).any():
            # only a lane that may have injected its last event can be done
            new_done = _churn_done(ctab_d, cursor, st)
            done = new_done if run_d is None else torch.where(run_d, new_done, done)
        t += 1
        host = _host(done, cursor, _accept_gate(st))
    return st, cursor, done


class ChurnResult(NamedTuple):
    """One churn run's outcome."""

    state: MemberState
    rounds: int
    done: bool
    injected: int

    def decision_log(self) -> str:
        return decision_log_of(self.state)


class ChurnEngine:
    """The churn driver with its decisions as data: a
    :class:`~tpu_paxos_torch.membership.churn_table.ChurnTable` of events
    evaluated against the engine state every round.

    Two build modes, decision-log identical per (churn, schedule, seed):
    compile-time constant (default: ``churn`` and ``schedule`` fixed at
    build) and runtime tables (``runtime_tables=True``: both arrive per
    ``run()`` call, within the ``(max_events, max_episodes)`` envelope).

    ``run()`` decides injection and termination from the tensors (one
    packed read a round); ``run_host()`` drives the SAME tables deciding
    both from numpy reads of the state each round, the JAX host-stepped
    twin.  Both give the same decision log."""

    def __init__(
        self,
        n_nodes: int,
        n_instances: int,
        *,
        churn=None,
        schedule=None,
        crash_rate: int = 0,
        max_rounds: int = 2000,
        runtime_tables: bool = False,
        max_events: int | None = None,
        max_episodes: int | None = None,
        device="cuda",
    ):
        from tpu_paxos_torch.fleet import runner as frun

        self.dev = devm.resolve(device)
        self.n = n_nodes
        self.i = n_instances
        self.c = n_instances * 2 + 8
        self.crash_rate = crash_rate
        self.max_rounds = int(max_rounds)
        self.runtime_tables = bool(runtime_tables)
        if runtime_tables:
            if churn is not None or schedule is not None:
                raise ValueError(
                    "runtime_tables=True takes churn/schedule per "
                    "run() call, not at build time"
                )
            self.max_events = ctm.MAX_EVENTS if max_events is None else int(max_events)
            self.max_episodes = frun.MAX_EPISODES if max_episodes is None else int(max_episodes)
            self._ctab = self._ftab = None
            self.schedule = self.churn = None
            comp = None
        else:
            _check_member_schedule(schedule)
            self.schedule = schedule
            self.churn = churn
            self._ctab = ctm.encode_churn(churn, n_nodes)
            self._ftab = stm.encode_schedule(schedule, n_nodes)
            self.max_events = int(self._ctab.vid.shape[0])
            self.max_episodes = int(self._ftab.t0.shape[0])
            comp = fltm.compile_schedule(schedule, n_nodes)
        self._round = _build_round(
            n_nodes, n_instances, self.c, crash_rate, comp=comp,
            runtime_schedule=runtime_tables, device=self.dev,
        )
        if not runtime_tables:
            _check_churn_capacity(self._ctab, self.i, self.c)

    def _tables(self, churn, schedule):
        if not self.runtime_tables:
            if churn is not None or schedule is not None:
                raise ValueError(
                    "this engine baked its tables at build time; "
                    "build with runtime_tables=True to pass them per "
                    "run"
                )
            return self._ctab, self._ftab
        _check_member_schedule(schedule)
        ctab = ctm.encode_churn(churn, self.n, self.max_events)
        ftab = stm.encode_schedule(schedule, self.n, self.max_episodes)
        return ctab, ftab

    def run(self, seed: int = 0, churn=None, schedule=None) -> ChurnResult:
        """init -> the churn loop -> final state, deciding on the device.
        In runtime-table mode ``churn``/``schedule`` select the lane of the
        envelope this run rides."""
        ctab, ftab = self._tables(churn, schedule)
        _check_churn_capacity(ctab, self.i, self.c)
        roots = prng.root_keys([seed])
        st0 = _init_lanes(self.n, self.i, self.c, 1, self.dev)
        final, cur, done = _run_churn_lanes(
            self._round, roots, st0, _one_lane(ctab),
            _one_lane(ftab) if self.runtime_tables else None,
            [self.max_rounds + int(ftab.horizon)],
        )
        t, done_h, cur_h = _host(final.t, done, cur)[0].tolist()
        return ChurnResult(state=lane_of(final, 0), rounds=t, done=bool(done_h), injected=cur_h)

    def run_host(self, seed: int = 0, churn=None, schedule=None) -> ChurnResult:
        """The host-stepped twin: one round per host-loop iteration, the
        injection and termination decisions recomputed each round from
        numpy reads of the state (:func:`_ready_host` /
        :func:`_done_host`).  Decision-log identical to :meth:`run`."""
        ctab, ftab = self._tables(churn, schedule)
        _check_churn_capacity(ctab, self.i, self.c)
        root = prng.root_key(seed)
        st = _init(self.n, self.i, self.c, self.dev)
        budget = self.max_rounds + int(ftab.horizon)
        tab = ftab if self.runtime_tables else None
        cur, done, t = 0, False, 0
        while not done and t < budget:
            if _ready_host(ctab, cur, st, t):
                via = int(ctab.via[cur])
                pos = int(st.tail[via])
                pend = st.pend.clone()
                if pos < self.c:
                    pend[via, pos] = int(ctab.vid[cur])
                tail = st.tail.clone()
                tail[via] += 1
                st = st._replace(pend=pend, tail=tail)
                cur += 1
            st = self._round(root, st, tab, t=t)
            t += 1
            done = _done_host(ctab, cur, st)
        return ChurnResult(state=st, rounds=t, done=done, injected=cur)


class MemberSim:
    """Host driver around the synchronous membership engine — plays the
    role of member/main.cpp: injects proposals and membership changes,
    steps the engine, exposes the Applied predicate and the per-node
    applied logs.  Every injection is recorded (round, op, args), so a
    run replays exactly (:meth:`save_injections`, :meth:`replay`)."""

    def __init__(
        self,
        n_nodes: int,
        n_instances: int,
        seed: int = 0,
        crash_rate: int = 0,
        schedule=None,
        device="cuda",
    ):
        self.dev = devm.resolve(device)
        self.n = n_nodes
        self.i = n_instances
        self.c = n_instances * 2 + 8
        self.root = prng.root_key(seed)
        self.schedule = schedule
        _check_member_schedule(schedule)
        comp = fltm.compile_schedule(schedule, n_nodes)
        self._round = _build_round(n_nodes, n_instances, self.c, crash_rate, comp,
                                   device=self.dev)
        self.state = _init(n_nodes, n_instances, self.c, self.dev)
        self._t_state, self._t = self.state, 0
        # the run's deterministic identity, written into the injection log
        self._init_args = {
            "n_nodes": n_nodes,
            "n_instances": n_instances,
            "seed": seed,
            "crash_rate": crash_rate,
            "schedule": schedule.to_dict() if schedule is not None else None,
        }
        self.injections: list[list] = []
        self.crash_rate = crash_rate
        self._sched_crashes = schedule is not None and any(
            e.kind == "crash" for e in schedule.episodes
        )
        # round at which each node's CURRENT crash was observed: the
        # rejoin guard ties a checkpoint to this epoch
        self._crash_round: dict[int, int] = {}

    def _round_now(self) -> int:
        """The state's round: kept on the host for the states this driver
        made, read once from a state the caller put in."""
        if self.state is not self._t_state:
            self._t_state, self._t = self.state, int(self.state.t)
        return self._t

    def _set(self, state: MemberState, t: int) -> None:
        self.state, self._t_state, self._t = state, state, t

    # -- injection (between rounds, host-side) --
    def propose(self, node: int, vid: int) -> None:
        st = self.state
        t = self._round_now()
        crashed, pos = _host(torch.stack([st.crashed[node].to(_I32), st.tail[node]])[None])[0]
        if crashed:
            raise RuntimeError(f"node {node} has crashed; propose elsewhere")
        # n_instances slots stay reserved for conflict requeues
        if pos >= self.c - self.i:
            raise RuntimeError("pending queue full (headroom reserved for requeues)")
        pend, tail = st.pend.clone(), st.tail.clone()
        pend[node, int(pos)] = int(vid)
        tail[node] += 1
        self._set(st._replace(pend=pend, tail=tail), t)
        self.injections.append([t, "propose", [int(node), int(vid)]])

    def propose_in_order(self, node: int, vids, max_rounds_each: int = 2000) -> bool:
        """In-order client: propose each vid only after the previous one
        is chosen.  Returns True when every value was chosen in order."""
        for v in vids:
            self.propose(node, int(v))
            if not self.run_until(lambda: self.chosen(int(v)), max_rounds=max_rounds_each):
                return False
        return True

    def add_acceptor(self, target: int, via: int = 0, force: bool = False) -> int:
        """Propose adding ``target`` to the acceptor set; adding a CRASHED
        node is refused (it inflates the quorum without a live acceptor)
        unless ``force``."""
        if not force and bool(self.state.crashed[target]):
            raise ValueError(
                f"node {target} has crashed; adding it would inflate the "
                "quorum without a live acceptor (or pass force=True)"
            )
        vid = change_vid(target, ADD_ACCEPTOR)
        self.propose(via, vid)
        return vid

    def del_acceptor(self, target: int, via: int = 0, force: bool = False) -> int:
        """Propose removing ``target`` from the acceptor set; refused
        unless ``force`` when the projected view would keep fewer live
        acceptors than its quorum."""
        if not force:
            acc_new = self._projected_acceptors(via)
            acc_new[target] = False
            alive = ~_np(self.state.crashed)
            q_new = int(acc_new.sum()) // 2 + 1
            live_new = int((acc_new & alive).sum())
            if live_new < q_new:
                raise ValueError(
                    f"deleting acceptor {target} would leave {live_new} "
                    f"live acceptors of a {q_new}-quorum view; delete "
                    "crashed members first (or pass force=True)"
                )
        vid = change_vid(target, DEL_ACCEPTOR)
        self.propose(via, vid)
        return vid

    def _projected_acceptors(self, via: int) -> np.ndarray:
        """``via``'s acceptor view with every in-flight membership change
        applied: chosen-but-unapplied entries, own assignments in flight
        and the pending ring."""
        st = self.state
        acc = _np(st.acceptors[via]).copy()

        def apply_vid(v: int) -> None:
            if v < CHANGE_BASE:
                return
            tgt, kind = decode_change(v)
            if kind in (ADD_ACCEPTOR, PROPOSER_TO_ACCEPTOR):
                acc[tgt] = True
            elif kind in (DEL_ACCEPTOR, ACCEPTOR_TO_PROPOSER):
                acc[tgt] = False

        chosen = _np(st.chosen_vid)
        for v in chosen[int(st.applied_upto[via]):]:
            if v != int(val.NONE):
                apply_vid(int(v))
        for v in _np(st.own_assign[via]):
            if v != int(val.NONE):
                apply_vid(int(v))
        pend = _np(st.pend[via])
        for pos in range(int(st.head[via]), min(int(st.tail[via]), self.c)):
            if pend[pos] != int(val.NONE):
                apply_vid(int(pend[pos]))
        return acc

    # -- stepping --
    def run_rounds(self, k: int) -> None:
        t = self._round_now()
        st = self.state
        for _ in range(k):
            st = self._round(self.root, st, t=t)
            t += 1
        self._set(st, t)
        # one read: the crash mask (engine-injected crashes are observed
        # once a stepping call, for the rejoin epoch guard) and the ring
        # overflow check (the requeue scatter drops past the ring)
        host = _host(torch.cat([st.crashed.to(_I32), st.tail.amax()[None]])[None])[0]
        if self.crash_rate or self._sched_crashes:
            for nn in np.flatnonzero(host[:-1]):
                self._crash_round.setdefault(int(nn), t)
        if int(host[-1]) > self.c:
            raise RuntimeError("pending ring overflow: requeue lost")

    def run_until(self, pred, max_rounds: int = 2000, step: int = 4) -> bool:
        for _ in range(0, max_rounds, step):
            if pred():
                return True
            self.run_rounds(step)
        return pred()

    # -- predicates / views --
    def chosen(self, vid: int) -> bool:
        return bool((self.state.chosen_vid == vid).any())

    def applied(self, vid: int, viewer: int = 0) -> bool:
        """Applied = a majority of the viewer's current acceptors have
        learned the value (ref member/paxos.cpp:1716-1733)."""
        st = self.state
        cv = _np(st.chosen_vid)
        where = np.flatnonzero(cv == vid)
        if not where.size:
            return False
        i = int(where[0])
        acc = _np(st.acceptors[viewer])
        learned = _np(st.learned[i]) != int(val.NONE)
        return int((acc & learned).sum()) >= int(acc.sum()) // 2 + 1

    def applied_log(self, node: int) -> np.ndarray:
        return applied_log_of(self.state, node)

    def crashed_set(self) -> set[int]:
        return set(np.flatnonzero(_np(self.state.crashed)).tolist())

    def next_shrink_target(self, viewer: int = 0) -> int | None:
        """The safe deletion order when shrinking back to {0}: crashed
        acceptors first, then the highest live one; None once only node 0
        remains."""
        accs = self.acceptor_set(viewer) - {0}
        if not accs:
            return None
        dead = sorted(accs & self.crashed_set())
        return dead[0] if dead else max(accs)

    def acceptor_set(self, viewer: int = 0) -> set[int]:
        return set(np.flatnonzero(_np(self.state.acceptors[viewer])).tolist())

    def learner_set(self, viewer: int = 0) -> set[int]:
        return set(np.flatnonzero(_np(self.state.learners[viewer])).tolist())

    # -- crash / rejoin --
    def crash(self, node: int) -> None:
        """Inject a deterministic fail-stop crash, guarded by the engine's
        admission rule (every survivor keeps a live majority of its own
        view's acceptors).  Node 0 is the harness driver."""
        if node == 0:
            raise ValueError("node 0 is the harness driver; it stays up")
        st = self.state
        t = self._round_now()
        alive_after = ~_np(st.crashed)
        alive_after[node] = False
        acc = _np(st.acceptors)
        for v in np.flatnonzero(alive_after):
            q = int(acc[v].sum()) // 2 + 1
            if int((acc[v] & alive_after).sum()) < q:
                raise ValueError(
                    f"crashing node {node} would leave node {v} without "
                    "a live majority of its acceptor view"
                )
        crashed = st.crashed.clone()
        crashed[node] = True
        self._set(st._replace(crashed=crashed), t)
        self._crash_round[node] = t
        self.injections.append([t, "crash", [int(node)]])

    def rejoin_from_checkpoint(self, node: int, path) -> None:
        """Restore ``node``'s durable per-node state from a checkpoint
        taken AT OR AFTER its current crash, clear the crash bit, and let
        anti-entropy catch it up.  An earlier snapshot would forget
        promises granted after it (the lost-promise hazard), so it is
        refused, as is a rejoin of a live node."""
        from tpu_paxos_torch import checkpoint as ckpt

        st = self.state
        t = self._round_now()
        if not bool(st.crashed[node]):
            raise ValueError(
                f"node {node} is not crashed; rejoin would overwrite "
                "live state with the snapshot"
            )
        snap, _meta = ckpt.restore(path, like=st)
        if not bool(snap.crashed[node]):
            raise ValueError(
                f"checkpoint predates node {node}'s crash — restoring it "
                "would forget promises granted after the snapshot"
            )
        cr = self._crash_round.get(node)
        if cr is not None and int(snap.t) < cr:
            raise ValueError(
                f"checkpoint is from round {int(snap.t)}, before node "
                f"{node}'s current crash at round {cr} — stale epoch"
            )
        # per-node leaves by their node-axis position; a field that is
        # neither listed nor global is a hard failure
        node_major = (
            "learners", "proposers", "acceptors", "version", "promised",
            "max_seen", "applied_upto", "count", "ballot", "pmax",
            "prepared", "delay_until", "adopted_b", "adopted_v",
            "cur_batch", "acks", "batch_age", "own_assign", "pend",
            "head", "tail", "stall",
        )
        node_minor = ("acc_ballot", "acc_vid", "learned")  # [I, N]
        cluster_global = {"t", "chosen_vid", "chosen_round", "chosen_ballot"}
        crashed = st.crashed.clone()
        crashed[node] = False
        kw = {"crashed": crashed}
        for f in node_major:
            x = getattr(st, f).clone()
            x[node] = getattr(snap, f)[node]
            kw[f] = x
        for f in node_minor:
            x = getattr(st, f).clone()
            x[:, node] = getattr(snap, f)[:, node]
            kw[f] = x
        uncovered = set(type(st)._fields) - set(kw) - cluster_global
        if uncovered:
            raise RuntimeError(
                "rejoin_from_checkpoint does not cover MemberState "
                f"fields {sorted(uncovered)}; classify them as "
                "node-major, node-minor, or cluster-global"
            )
        self._set(st._replace(**kw), t)
        self._crash_round.pop(node, None)
        # the log pins the checkpoint's content hash and geometry so a
        # replay against a moved or rewritten file fails by name
        self.injections.append([
            t, "rejoin",
            [int(node), str(path),
             {"sha256": _file_sha256(path), "n_nodes": self.n, "n_instances": self.i}],
        ])

    # -- host-injection record / replay (ref member/indet.cpp:24-119) --
    def save_injections(self, path) -> None:
        """Write the injection schedule as the replay artifact: engine
        geometry + seed, the (round, op, args) stream, and the final round
        count (the same bytes as the JAX package writes)."""
        with open(path, "w") as f:
            json.dump(
                {"version": 1, **self._init_args, "ops": self.injections,
                 "final_t": self._round_now()},
                f,
            )

    @classmethod
    def replay(cls, path, device="cuda") -> "MemberSim":
        """Re-execute a recorded run: same engine seed, every injection
        applied at the recorded round, stepped to the recorded final
        round; the decision log byte-compares equal."""
        with open(path) as f:
            log = json.load(f)
        if log.get("version") != 1:
            raise ValueError(f"unknown injection-log version {log.get('version')}")
        sched = fltm.FaultSchedule.from_dict(log["schedule"]) if log.get("schedule") else None
        ms = cls(
            n_nodes=log["n_nodes"],
            n_instances=log["n_instances"],
            seed=log["seed"],
            crash_rate=log["crash_rate"],
            schedule=sched,
            device=device,
        )
        for t_op, op, args in log["ops"]:
            if ms._round_now() > t_op:
                raise RuntimeError(
                    f"injection log out of order: at round {ms._round_now()} "
                    f"but op recorded for round {t_op}"
                )
            while ms._round_now() < t_op:
                ms.run_rounds(1)
            if op == "propose":  # add/del/transition ops record as propose
                ms.propose(*args)
            elif op == "crash":
                ms.crash(*args)
            elif op == "rejoin":
                # integrity gate before restoring (logs with 2-element
                # args replay unverified, as recorded)
                node, ck_path = args[0], args[1]
                if len(args) > 2 and args[2]:
                    meta = args[2]
                    if not os.path.exists(ck_path):
                        raise ValueError(
                            f"rejoin checkpoint {ck_path!r} missing at "
                            "replay time"
                        )
                    got = _file_sha256(ck_path)
                    if got != meta.get("sha256"):
                        raise ValueError(
                            f"rejoin checkpoint {ck_path!r} sha256 "
                            f"{got[:16]}... != recorded "
                            f"{str(meta.get('sha256'))[:16]}... — the file "
                            "changed since the run was recorded"
                        )
                    if meta.get("n_nodes") != ms.n or meta.get("n_instances") != ms.i:
                        raise ValueError(
                            "rejoin checkpoint geometry "
                            f"({meta.get('n_nodes')} nodes x "
                            f"{meta.get('n_instances')} instances) does not "
                            f"match the replayed run ({ms.n} x {ms.i})"
                        )
                ms.rejoin_from_checkpoint(node, ck_path)
            else:
                raise ValueError(f"unknown op {op!r} in injection log")
        while ms._round_now() < log["final_t"]:
            ms.run_rounds(1)
        return ms

    def decision_log(self) -> str:
        return decision_log_of(self.state)


def audit_entries():
    """The membership engine's registered entry points
    (``analysis/registry.py``), JAX's canonical calls at 3 nodes and 8
    instances: one round with crash sampling on (``MemberSim``'s round),
    the schedule-bearing replay round, the churn table's device step
    (inject + run-complete, one call) and the whole-run churn loop of a
    runtime-table ``ChurnEngine``."""
    from tpu_paxos_torch.analysis.registry import AuditEntry

    n, i = 3, 8
    c = i * 2 + 8

    def _round(device, comp):
        dev = devm.resolve(device)
        fn = _build_round(n, i, c, crash_rate=500, comp=comp, device=dev)
        return fn, (prng.root_key(0), _init(n, i, c, dev))

    def build(device):
        return _round(device, None)

    def build_replay(device):
        sched = fltm.FaultSchedule((
            fltm.partition(2, 10, (0,), (1, 2)),
            fltm.pause(4, 9, 1),
            fltm.crash(6, 2),
        ))
        return _round(device, fltm.compile_schedule(sched, n))

    def _small_tables():
        churn = ctm.ChurnSchedule((
            ctm.ChurnEvent(vid=100),
            ctm.ChurnEvent(vid=change_vid(1, ADD_ACCEPTOR), wait=ctm.WAIT_CHOSEN),
            ctm.ChurnEvent(vid=101, wait=ctm.WAIT_APPLIED),
        ))
        sched = fltm.FaultSchedule((fltm.pause(2, 5, 1), fltm.crash(8, 2)))
        return churn, sched

    def build_churn_table(device):
        dev = devm.resolve(device)
        churn, _ = _small_tables()
        ctab = _device_table(_one_lane(ctm.encode_churn(churn, n, 4)), dev)
        cursor = torch.zeros((1,), dtype=_I32, device=dev)

        def fn(ctab, cursor, st):
            st2, cur2 = _churn_inject(ctab, cursor, st, c)
            return st2, cur2, _churn_done(ctab, cur2, st2)

        return fn, (ctab, cursor, _init_lanes(n, i, c, 1, dev))

    def build_run_loop(device):
        eng = ChurnEngine(n, i, runtime_tables=True, max_events=4, max_episodes=2,
                          crash_rate=500, max_rounds=64, device=device)
        churn, sched = _small_tables()
        return eng.run, (0, churn, sched)

    return [
        AuditEntry("member.round", build),
        AuditEntry("member.round_replay", build_replay),
        AuditEntry("member.churn_table", build_churn_table),
        AuditEntry("member.run_loop", build_run_loop),
    ]
