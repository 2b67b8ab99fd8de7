"""Device-batched MEMBERSHIP fleets: many (seed x churn-schedule x
fault-schedule) lanes of the churn engine in one round loop, judged on
the device (port of ``tpu_paxos/fleet/member_runner.py``).

Each lane runs the churn driver of ``membership/engine.ChurnEngine.run``
(inject -> round -> done?) end to end on the lane-axis round: the churn
table (``membership/churn_table.ChurnTable``) and the fault-schedule table
(``fleet/schedule_table.ScheduleTable``, crash points included) are
per-lane runtime arrays, so ONE runner covers every (churn scenario,
episode mix, seed) of a fixed envelope ``(n_nodes, n_instances,
max_events, max_episodes, crash_rate, max_rounds)``;
``fleet/envelope.member_runner_for`` memoizes one runner per envelope.

The membership invariants (:func:`member_lane_verdict`) reduce each lane
to booleans on the device, so only the ``[L]`` verdict vectors move to
the host:

- **quorum intersection across epochs**: no learner holds a value
  different from the chosen record for its instance, and no event vid is
  chosen in two instances;
- **learner catch-up**: every live node listed as a learner in node 0's
  final view has learned every chosen instance;
- **coverage**: every churn-event vid was chosen, a lane-crashed
  injecting node excusing its events;
- **completed**: the churn loop's run-complete predicate held inside the
  round budget.

Lane for lane the fleet is decision-log identical to single
``ChurnEngine.run`` executions of the same (churn, schedule, seed): the
lane-batched threefry draws equal the per-lane ones.

A ``mesh=`` runner tiles the lane axis over the mesh's ranks as the sim
fleet's does (``fleet/runner.py``): rank ``r`` runs its block of lanes on
its device from the broadcast initial state, which every rank builds
whole (JAX's replicated in-spec), and the report gathers the ranks'
states and verdicts in lane order.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from tpu_paxos_torch.core import values as val
from tpu_paxos_torch.core.sim import _sum32, lane_of
from tpu_paxos_torch.fleet import runner as frun
from tpu_paxos_torch.fleet import schedule_table as stm
from tpu_paxos_torch.membership import churn_table as ctm
from tpu_paxos_torch.membership import engine as meng
from tpu_paxos_torch.parallel import mesh as pmesh
from tpu_paxos_torch.utils import device as devm
from tpu_paxos_torch.utils import prng


class MemberLaneVerdict(NamedTuple):
    """Per-lane membership verdict vectors, ``[L]`` each."""

    ok: torch.Tensor
    quorum: torch.Tensor  # quorum-intersection observable (agreement)
    catchup: torch.Tensor  # learner catch-up
    coverage: torch.Tensor  # crash-excused event-vid coverage
    completed: torch.Tensor  # run-complete inside the budget
    rounds: torch.Tensor  # int32 rounds simulated


class _Injected(NamedTuple):
    injected: torch.Tensor  # [L] events injected


def member_lane_verdict(st: meng.MemberState, ctab, done) -> MemberLaneVerdict:
    """Judge lane-stacked final churn-engine states on the device: ``st``
    and ``ctab`` (a ``ChurnTable`` of tensors) lane-leading, ``done``
    ``[L]`` bool."""
    chosen = st.chosen_vid  # [L, I]
    lanes, n = st.crashed.shape
    known = st.learned != val.NONE  # [L, I, N]
    # a learner cell disagreeing with the chosen record (a learn where
    # nothing was chosen included: NONE never equals a learned vid >= 0)
    agree = (~known | (st.learned == chosen[:, :, None])).reshape(lanes, -1).all(dim=1)
    evalid = ctab.vid != val.NONE  # [L, E]; padding slots vacuous
    n_hit = _sum32(ctab.vid[:, :, None] == chosen[:, None, :], dim=2)  # [L, E]
    no_double = (~evalid | (n_hit <= 1)).all(dim=1)
    quorum = agree & no_double
    owed = ~st.crashed & st.learners[:, 0]  # [L, N]
    chosen_i = chosen != val.NONE
    catchup = (~chosen_i[:, :, None] | known | ~owed[:, None, :]).reshape(lanes, -1).all(dim=1)
    via_crashed = st.crashed.gather(1, ctab.via.clamp(0, n - 1).long())  # [L, E]
    coverage = (~evalid | (n_hit >= 1) | via_crashed).all(dim=1)
    return MemberLaneVerdict(
        ok=quorum & catchup & coverage & done,
        quorum=quorum,
        catchup=catchup,
        coverage=coverage,
        completed=done,
        rounds=st.t,
    )


@dataclasses.dataclass
class MemberFleetReport:
    """One dispatch's outcome.  ``final`` stays on the device; only the
    ``[L]`` verdict vectors came to the host."""

    n_nodes: int
    n_lanes: int
    seeds: list
    churns: list
    schedules: list
    verdict: MemberLaneVerdict  # host numpy, [lanes] per field
    final: object  # device MemberState, lane-leading
    injected: np.ndarray  # [lanes] events injected
    seconds: float
    #: round-loop iterations of the dispatch (the slowest lane's rounds)
    iterations: int = 0

    @property
    def lanes_per_sec(self) -> float:
        return self.n_lanes / max(self.seconds, 1e-9)

    @property
    def failing(self) -> list:
        return [i for i in range(self.n_lanes) if not bool(self.verdict.ok[i])]

    def lane_state(self, i: int):
        """One lane's final state (views of the lane-stacked tensors)."""
        return lane_of(self.final, i)

    def lane_log(self, i: int) -> str:
        """One lane's canonical decision log, byte-equal to the single
        ``ChurnEngine.run`` of ``(churns[i], schedules[i], seeds[i])``;
        ``n_nodes`` is the dispatch's TRUE node count."""
        return meng.decision_log_of(self.lane_state(i), self.n_nodes)


class MemberFleetRunner:
    """Membership-fleet front end for one envelope: the lane-axis churn
    loop plus the on-device member verdict.  ``run()`` is called per
    scenario batch with fresh seeds, churn schedules and fault schedules.

    A ``geometry=`` runner (a ``core.geom.GeometryEnvelope``) is built at
    the envelope's node bound and takes each dispatch's TRUE node count
    (``run(n_nodes=...)``)."""

    def __init__(
        self,
        n_nodes: int,
        n_instances: int,
        *,
        max_events: int = ctm.MAX_EVENTS,
        max_episodes: int = frun.MAX_EPISODES,
        crash_rate: int = 0,
        max_rounds: int = 2000,
        mesh=None,
        geometry=None,
        device="cuda",
    ):
        if geometry is not None and n_nodes != geometry.bound_nodes:
            raise ValueError(
                "a geometry-padded member fleet must be built at the "
                f"envelope node bound ({geometry.bound_nodes}), got "
                f"n_nodes={n_nodes}"
            )
        self.dev = devm.resolve(device) if mesh is None else mesh.devices[0]
        self.geometry = geometry
        self.n = n_nodes
        self.i = n_instances
        self.c = n_instances * 2 + 8
        self.max_events = int(max_events)
        self.max_episodes = int(max_episodes)
        self.crash_rate = int(crash_rate)
        self.max_rounds = int(max_rounds)
        self.mesh = mesh
        # the round the whole-run loop of ChurnEngine.run drives
        self._rounds = pmesh.per_device(
            [self.dev] if mesh is None else mesh.devices,
            lambda dev: meng._build_round(n_nodes, n_instances, self.c, crash_rate,
                                          runtime_schedule=True, geometry=geometry, device=dev))

    def run(self, seeds, churns, schedules, n_nodes=None) -> MemberFleetReport:
        """One fleet dispatch: ``seeds[i]``, ``churns[i]`` (ChurnSchedule
        or None) and ``schedules[i]`` (FaultSchedule or None) drive lane
        ``i``.  A geometry-padded runner takes the dispatch's TRUE node
        count as ``n_nodes=``.  Returns once the verdict vectors are on the
        host; the per-lane states stay on the device."""
        if self.geometry is None:
            if n_nodes is not None:
                raise ValueError(
                    "n_nodes= is a geometry-padded dispatch input; "
                    "build the runner with a GeometryEnvelope"
                )
            gidx = None
        else:
            if n_nodes is None:
                raise ValueError(
                    "a geometry-padded member fleet takes its TRUE "
                    "node count per dispatch: run(n_nodes=...)"
                )
            gidx = self.geometry.index_of_nodes(n_nodes)
        seeds = [int(s) for s in seeds]
        churns = list(churns)
        schedules = list(schedules)
        n_lanes = len(seeds)
        if len(churns) != n_lanes or len(schedules) != n_lanes:
            raise ValueError("one churn + one schedule per lane required")
        pmesh.check_lanes(self.mesh, n_lanes)
        for s in schedules:
            meng._check_member_schedule(s)
        # the single-run engine's capacity proof, per lane
        for li, churn_lane in enumerate(churns):
            meng._check_churn_capacity(
                ctm.encode_churn(churn_lane, self.n, self.max_events),
                self.i, self.c, lane=li,
            )
        ctabs = ctm.encode_churn_batch(churns, self.n, self.max_events)
        ftabs = stm.encode_batch(schedules, self.n, self.max_episodes)
        lane_in = (prng.root_keys(seeds), ctabs, ftabs,
                   self.max_rounds + np.asarray(ftabs.horizon, np.int64))
        # paxlint: allow[DET001] wall metric only; never reaches artifacts
        t0 = time.perf_counter()
        outs = pmesh.on_lanes(self.mesh, "member", lambda _r, dev, blk: self._dispatch(dev, blk, gidx),
                              self.dev, lane_in)
        final = pmesh.gather_lanes(self.mesh, "member", [o[0] for o in outs])
        verdict, inj = pmesh.gather_lanes(self.mesh, "member", [o[1] for o in outs])
        # paxlint: allow[DET001] wall metric only; never reaches artifacts
        seconds = time.perf_counter() - t0  # the verdict copy is the sync
        return MemberFleetReport(
            n_nodes=self.n if self.geometry is None else int(n_nodes),
            n_lanes=n_lanes,
            seeds=seeds,
            churns=churns,
            schedules=schedules,
            verdict=verdict,
            final=final,
            injected=inj.injected,
            seconds=seconds,
            iterations=int(verdict.rounds.max()) if n_lanes else 0,
        )

    def _dispatch(self, dev, lane_in, gidx):
        """One block of lanes on ``dev`` from the broadcast initial state:
        ``(final states, (host verdict, host injected counts))``."""
        roots, ctabs, ftabs, budgets = lane_in
        st0 = meng._init_lanes(self.n, self.i, self.c, roots.shape[0], dev)
        final, cur, done = meng._run_churn_lanes(
            self._rounds[str(dev)], roots, st0, ctabs, ftabs, budgets, gidx=gidx)
        return final, tuple(devm.to_host(
            member_lane_verdict(final, meng._device_table(ctabs, dev), done), _Injected(cur)))


def _audit_scenarios(n_lanes: int):
    """JAX's two canonical (churn, schedule) pairs of the member audit,
    cycled over the lane count."""
    from tpu_paxos_torch.core import faults as fltm

    churns = [
        ctm.ChurnSchedule((
            ctm.ChurnEvent(vid=100),
            ctm.ChurnEvent(vid=meng.change_vid(1, meng.ADD_ACCEPTOR), wait=ctm.WAIT_CHOSEN),
        )),
        ctm.ChurnSchedule((
            ctm.ChurnEvent(vid=200),
            ctm.ChurnEvent(vid=201, wait=ctm.WAIT_CHOSEN),
            ctm.ChurnEvent(vid=meng.change_vid(2, meng.ADD_ACCEPTOR), wait=ctm.WAIT_APPLIED),
        )),
    ]
    scheds = [
        fltm.FaultSchedule((fltm.pause(2, 5, 1),)),
        fltm.FaultSchedule((fltm.crash(8, 2),)),
    ]
    return [churns[i % 2] for i in range(n_lanes)], [scheds[i % 2] for i in range(n_lanes)]


def shard_parity(n_devices: int, dcn_hosts: int = 1, device="cuda") -> dict:
    """The certificate's ``member.fleet_lanes`` driver (JAX's
    ``audit_entries`` ``shard_parity``): one 8-lane member-fleet dispatch
    (3 nodes, 8 instances, crash rate 500, 64 rounds) on an
    ``n_devices``-rank tile; per-lane verdict nibbles
    (quorum|catchup|coverage|completed) and decision-log sha256."""
    import hashlib

    mesh = frun._parity_mesh(n_devices, dcn_hosts, device)
    runner = MemberFleetRunner(3, 8, max_events=4, max_episodes=2, crash_rate=500,
                               max_rounds=64, mesh=mesh, device=device)
    churns, scheds = _audit_scenarios(8)
    rep = runner.run(list(range(8)), churns, scheds)
    v = rep.verdict
    return {
        "verdicts": "".join(
            format((int(bool(v.quorum[i])) << 3) | (int(bool(v.catchup[i])) << 2)
                   | (int(bool(v.coverage[i])) << 1) | int(bool(v.completed[i])), "x")
            for i in range(rep.n_lanes)
        ),
        "lane_logs": [hashlib.sha256(rep.lane_log(i).encode()).hexdigest()
                      for i in range(rep.n_lanes)],
    }


def audit_entries():
    """The member fleet's registered entry point (``analysis/registry.py``),
    JAX's canonical dispatch: 2 lanes of a small geometry (3 nodes, 8
    instances, crash rate 500, 64 rounds) with distinct churn scenarios
    and distinct episode mixes through the lane-stacked churn loop and the
    on-device member verdict.  ``shard_build`` lays it over a grid mesh at
    8 lanes; ``shard_state`` is the lane-stacked initial state at 8 lanes."""
    from tpu_paxos_torch.analysis.registry import AuditEntry

    def _setup(mesh=None, n_lanes: int = 2, device="cuda"):
        runner = MemberFleetRunner(3, 8, max_events=4, max_episodes=2, crash_rate=500,
                                   max_rounds=64, mesh=mesh, device=device)
        churns, scheds = _audit_scenarios(n_lanes)

        def fn():
            return runner.run(list(range(n_lanes)), churns, scheds)

        return fn, ()

    def shard_state(n_shards: int = 1):
        runner = MemberFleetRunner(3, 8, max_events=4, max_episodes=2, crash_rate=500,
                                   max_rounds=64, device="cpu")
        return "member", meng._init_lanes(3, 8, runner.c, 8, torch.device("cpu"))

    return [AuditEntry(
        "member.fleet_lanes", lambda device: _setup(device=device),
        covers=("MemberFleetRunner.run",),
        shard_build=lambda mesh: _setup(mesh=mesh, n_lanes=8, device=mesh.devices[0]),
        shard_state=shard_state,
    )]
