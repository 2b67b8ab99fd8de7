"""Device-batched fleet runner: many (seed x schedule x knob-mix) lanes
of the general engine in one round loop, judged on the device (port of
``tpu_paxos/fleet/runner.py``, the bound-free runner).

JAX ``vmap``s the engine's whole-run ``while_loop`` over a lane axis.
The port runs ONE round function over an explicit leading lane axis
(``core/sim.build_engine(...).lanes``): every lane's coins of a round are
drawn in one hash pass, every lane's schedule rows computed at once, and
the two ``simkern`` kernels cover every lane in one launch each, so the
host's per-round cost is paid once for ``L`` lanes.  A lane stops at its
own ``~done & t < max_rounds + horizon`` and keeps its state while the
others run on (``core/sim.run_lanes``).  The per-lane invariant subset
(``fleet/verdict.py``) is reduced on the device, and only the ``[L]``
verdict vectors move to the host.

Lane for lane the fleet equals single ``core/sim.run`` executions of the
same (cfg, schedule, knobs, seed): ``FleetReport.lane_cfg(i)`` is that
config.  A ``telemetry=True`` runner carries the flight recorder (with
its windowed plane) beside every lane's state and reduces it on the
device with the verdict; the summaries come to the host in the
verdict's one copy.

A ``geometry=`` runner (a ``core.geom.GeometryEnvelope``) is built at
the envelope's bound and serves every true geometry of its menu: each
``run(geometry=(n_nodes, proposers), protocol=...)`` dispatch names its
true geometry and protocol knobs, and its lanes make the decisions of
the bound-free runner of that geometry.

A ``mesh=`` runner (``parallel/mesh.Mesh``) tiles the lane axis over the
mesh's ranks, as JAX's ``shard_map`` over ``instance_spec(mesh)`` does:
rank ``r`` runs lanes ``[r L / D, (r + 1) L / D)`` on its device to its
own lanes' fixed point (lanes are independent: no collective), and the
report gathers the ranks' states and verdicts in lane order.  A rank
runs its whole loop in one turn of ``Mesh.run`` (the turn passes in
collectives, and the tile makes none), so on one card the ranks' rounds
run one rank after another.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from tpu_paxos_torch.config import EdgeFaultConfig, FaultConfig, SimConfig
from tpu_paxos_torch.core import geom as geo
from tpu_paxos_torch.core import net as netm
from tpu_paxos_torch.core import sim as simm
from tpu_paxos_torch.core import values as val
from tpu_paxos_torch.fleet import schedule_table as stm
from tpu_paxos_torch.fleet import verdict as vdt
from tpu_paxos_torch.parallel import mesh as pmesh
from tpu_paxos_torch.utils import device as devm
from tpu_paxos_torch.utils import prng

#: Default episode capacity of a runner: every lane's schedule must fit
#: (the stress mixes peak at 4; the search grammar samples at most this).
MAX_EPISODES = 8


def default_lane_count(backend: str | None = None) -> int:
    """Lanes per dispatch by backend: a card runs hundreds of small lanes
    per pass over its memory; the CPU keeps a few."""
    backend = backend or ("cuda" if torch.cuda.is_available() else "cpu")
    if backend == "tpu":
        return 256
    if backend in ("cuda", "gpu"):
        return 128
    return 8


def _pad_geometry_workload(workload, gates, bound_p: int):
    """Workload/gate rows padded with EMPTY rows to the envelope's
    proposer bound; a workload naming more proposers than the bound is
    rejected by name."""
    workload = [np.asarray(w, np.int32) for w in workload]
    if len(workload) > bound_p:
        raise ValueError(
            f"workload names {len(workload)} proposers; the envelope "
            f"geometry bound is {bound_p} proposers"
        )
    pad = bound_p - len(workload)
    wl = workload + [np.zeros((0,), np.int32)] * pad
    g = None
    if gates is not None:
        g = list(gates) + [np.zeros((0,), np.int32)] * pad
    return wl, g


@dataclasses.dataclass
class FleetReport:
    """One dispatch's outcome.  ``final`` stays on the device; only the
    ``[L]`` verdict vectors came to the host.  ``lane_result`` moves one
    lane's state when it is asked for."""

    cfg: SimConfig
    n_lanes: int
    seeds: list[int]
    schedules: list
    verdict: vdt.LaneVerdict  # host numpy, [lanes] per field
    final: simm.SimState  # device, lane-leading
    expected: np.ndarray  # the runner's template expected-vid set
    seconds: float
    #: per-lane i.i.d. FaultConfig (schedule-free): the knob mix each
    #: lane ran, the source ``lane_cfg`` bakes back in
    fault_cfgs: list = dataclasses.field(default_factory=list)
    #: per-lane expected-vid arrays
    expected_lanes: list = dataclasses.field(default_factory=list)
    #: round-loop iterations of the dispatch (the slowest lane's rounds)
    iterations: int = 0
    #: flight-recorder summaries, ``[lanes]``-leading host numpy
    #: (``telemetry/recorder.TelemetrySummary``); None unless the runner
    #: was built with ``telemetry=True``
    telemetry: object = None
    #: windowed series, ``[lanes, W]``-leading host numpy
    #: (``telemetry/recorder.WindowSummary``, bucket width
    #: ``recorder.WINDOW_ROUNDS``); None when recorder-free
    windows: object = None
    #: a tiled dispatch's round calls on each rank (empty untiled)
    rank_iterations: list = dataclasses.field(default_factory=list)

    @property
    def lanes_per_sec(self) -> float:
        return self.n_lanes / max(self.seconds, 1e-9)

    @property
    def failing(self) -> list[int]:
        return [i for i in range(self.n_lanes) if not bool(self.verdict.ok[i])]

    def lane_result(self, i: int) -> simm.SimResult:
        """Move ONE lane's final state to the host as the single-run
        result type."""
        exp = self.expected_lanes[i] if self.expected_lanes else self.expected
        return simm.to_result(simm.lane_of(self.final, i), exp)

    def lane_telemetry(self, i: int):
        """One lane's flight-recorder summary as a JSON-ready dict
        (``telemetry/recorder.summary_to_dict`` with the windowed block);
        None when the runner ran recorder-free."""
        if self.telemetry is None:
            return None
        from tpu_paxos_torch.telemetry import recorder as telem

        wone = telem.lane(self.windows, i) if self.windows is not None else None
        return telem.summary_to_dict(telem.lane(self.telemetry, i), wone, telem.WINDOW_ROUNDS)

    def lane_cfg(self, i: int) -> SimConfig:
        """The single-run config this lane equals: the base cfg with the
        lane's seed, i.i.d. knobs and schedule baked back in."""
        fc = self.fault_cfgs[i] if self.fault_cfgs else self.cfg.faults
        return dataclasses.replace(
            self.cfg,
            seed=self.seeds[i],
            faults=dataclasses.replace(fc, schedule=self.schedules[i]),
        )


class FleetRunner:
    """Fleet front end for one envelope: the lane-batched round function
    of the runtime-schedule, runtime-knob build and its workload
    template.  ``run()`` is called per generation / per mix with fresh
    seeds, schedules, knob mixes and workload tables.

    ``cfg.faults`` plays two roles: its ``max_delay`` is the envelope's
    RING BOUND (every lane's ``max_delay`` must stay <= it), and its
    i.i.d. knobs are the default per-lane knob mix when
    ``run(knobs=None)``.  ``cfg.faults.schedule`` must be None:
    schedules are per-lane runtime tables."""

    def __init__(
        self,
        cfg: SimConfig,
        workload: list[np.ndarray],
        gates: list[np.ndarray] | None = None,
        mesh=None,
        max_episodes: int = MAX_EPISODES,
        telemetry: bool = False,
        geometry=None,
        device="cuda",
    ):
        if cfg.faults.schedule is not None:
            raise ValueError(
                "fleet base cfg must not bake a schedule; schedules "
                "are per-lane runtime tables"
            )
        if geometry is not None:
            # padded runner: the build cfg IS the envelope bound; the
            # true geometry and protocol knobs arrive per run() dispatch
            if (
                cfg.n_nodes != geometry.bound_nodes
                or tuple(cfg.proposers)
                != tuple(range(geometry.bound_proposers))
            ):
                raise ValueError(
                    "a geometry-padded fleet runner must be built at "
                    "the envelope bound; use geometry.bound_cfg(cfg)"
                )
            workload, gates = _pad_geometry_workload(
                workload, gates, geometry.bound_proposers
            )
        self.geometry = geometry
        self.mesh = mesh
        # a tiled runner's states live on its ranks' devices; the report
        # gathers them on the first
        self.device = devm.resolve(device) if mesh is None else mesh.devices[0]
        self.cfg = cfg
        self.workload = [np.asarray(w, np.int32) for w in workload]
        self.gates = gates
        self.max_episodes = max_episodes
        self.telemetry = telemetry
        self.delay_bound = cfg.faults.max_delay
        #: set by fleet/envelope.runner_for: a cache-shared runner's
        #: template queues and base knobs are whatever caller warmed
        #: the cache, so run() REQUIRES explicit workloads= and knobs=
        self.explicit_inputs_only = False
        self.expected, self.owner = vdt.expected_owners(cfg, self.workload)
        #: bitmap bound of the verdict's chosen-membership bitmap: the
        #: envelope's vid space; every lane's vids must fall below it
        self.vid_bound = (
            int(self.expected.max()) + 1 if self.expected.size else 1
        )
        #: width of the per-lane expected/owner tables; lanes with fewer
        #: distinct vids pad with -1 (vacuously covered)
        self.v_cap = max(len(self.expected), 1)
        pend, gate, tail, c = simm.prepare_queues(cfg, self.workload, gates)
        self._tmpl = (pend, gate, tail)
        self.queue_cap = c
        self._gate_vid_cap = simm.gates_vid_cap(self.workload, gates)
        window_rounds = 0
        if telemetry:
            from tpu_paxos_torch.telemetry import recorder as telem

            window_rounds = telem.WINDOW_ROUNDS
        self._rounds = pmesh.per_device(self.devices, lambda dev: simm.build_engine(
            cfg, c, vid_cap=self._gate_vid_cap, device=dev,
            runtime_schedule=True, runtime_knobs=True,
            telemetry=telemetry, window_rounds=window_rounds,
            geometry=geometry, runtime_protocol=geometry is not None,
        ))

    @property
    def devices(self) -> list:
        """The devices the dispatch runs on: the runner's, or its mesh's
        ranks'."""
        return [self.device] if self.mesh is None else self.mesh.devices

    def _pad_vtab(self, exp: np.ndarray, own: np.ndarray):
        """A lane's expected/owner arrays padded to the envelope's table
        width (-1 expected = vacuous slot; its owner stays in node
        range)."""
        pe = np.full((self.v_cap,), -1, np.int32)
        po = np.zeros((self.v_cap,), np.int32)
        pe[: len(exp)] = exp
        po[: len(own)] = own
        return pe, po

    def _queues(self, n_lanes: int, workloads, owner_cfg=None):
        """Stacked per-lane (pend, gate, tail, expected, owner) plus the
        per-lane expected-vid list.  Per-lane workloads must match the
        template's SHAPES (same per-proposer lengths, same queue
        capacity) and fit the envelope's vid space."""
        def stack(arrays):
            first = arrays[0]
            if all(a is first for a in arrays):
                return np.broadcast_to(first, (n_lanes,) + first.shape)
            return np.stack(arrays)

        if workloads is None:
            exp_t, own_t = self._pad_vtab(self.expected, self.owner)
            pend, gate, tail = self._tmpl
            return (
                stack([pend]), stack([gate]), stack([tail]),
                stack([exp_t]), stack([own_t]),
                [self.expected] * n_lanes,
            )
        workloads = list(workloads)
        if len(workloads) != n_lanes:
            raise ValueError("one (workload, gates) pair per lane required")
        lanes, cache = [], {}
        for wl_lane, g_lane in workloads:
            key = (id(wl_lane), id(g_lane))
            if key not in cache:
                cache[key] = self._lane_tables(wl_lane, g_lane, owner_cfg)
            lanes.append(cache[key])
        return (
            stack([ln[0] for ln in lanes]), stack([ln[1] for ln in lanes]),
            stack([ln[2] for ln in lanes]), stack([ln[3] for ln in lanes]),
            stack([ln[4] for ln in lanes]), [ln[5] for ln in lanes],
        )

    def _lane_tables(self, wl_lane, g_lane, owner_cfg=None):
        """Validate one lane's (workload, gates) against the envelope and
        return its (pend, gate, tail, expected, owner, exp).  ``owner_cfg``
        (padded dispatches) is the TRUE geometry the verdict's vid ->
        owner-node map is computed against; the queues pad to the
        bound."""
        exp, own = vdt.expected_owners(owner_cfg or self.cfg, wl_lane)
        if self.geometry is not None:
            wl_lane, g_lane = _pad_geometry_workload(
                wl_lane, g_lane, self.geometry.bound_proposers
            )
        if exp.size and int(exp.max()) >= self.vid_bound:
            raise ValueError(
                f"per-lane workload vid {int(exp.max())} exceeds "
                f"the envelope's vid bound {self.vid_bound}; build "
                "the runner with a template covering the vid space"
            )
        if len(exp) > self.v_cap:
            raise ValueError(
                f"per-lane workload has {len(exp)} distinct vids; "
                f"the envelope's verdict table holds {self.v_cap}"
            )
        if g_lane is not None and self._gate_vid_cap == 0 and any(
            len(g) and (np.asarray(g) != int(val.NONE)).any()
            for g in g_lane
        ):
            raise ValueError(
                "per-lane gates need a gate-bearing template: the "
                "engine compiles gate logic in only when the "
                "template has gates"
            )
        p, g, t, c = simm.prepare_queues(self.cfg, wl_lane, g_lane)
        if c != self.queue_cap or p.shape != self._tmpl[0].shape:
            raise ValueError(
                "per-lane workload shapes must match the template "
                f"(capacity {c} vs {self.queue_cap})"
            )
        pe, po = self._pad_vtab(exp, own)
        return p, g, t, pe, po, exp

    def _knob_arrays(self, n_lanes: int, knobs):
        """Lane-stacked ``FaultKnobs`` plus the per-lane (schedule-free)
        FaultConfig list, the ``lane_cfg`` source.  ``knobs[i]`` may be a
        FaultConfig (edge matrices welcome) or a host FaultKnobs (scalar
        or matrix form); None defaults every lane to the base cfg's
        i.i.d. knobs.  Every lane NORMALIZES to matrix form
        (``net.matrix_knobs``: scalar knobs become a uniform ``[A, A]``
        matrix, which draws exactly what the scalar knob draws)."""
        if knobs is None:
            knobs = [self.cfg.faults] * n_lanes
        knobs = list(knobs)
        if len(knobs) != n_lanes:
            raise ValueError("one knob set per lane required")
        a = self.cfg.n_nodes
        fcs = []
        for k in knobs:
            if isinstance(k, netm.FaultKnobs):
                # routes through FaultConfig validation (rate ranges,
                # min <= max, per edge for matrix-form knobs)
                if np.ndim(k.drop_rate) >= 2:
                    k = FaultConfig(
                        max_delay=int(np.max(k.max_delay)),
                        crash_rate=int(k.crash_rate),
                        edges=EdgeFaultConfig(
                            drop_rate=k.drop_rate,
                            dup_rate=k.dup_rate,
                            min_delay=k.min_delay,
                            max_delay=k.max_delay,
                        ),
                    )
                else:
                    k = FaultConfig(
                        drop_rate=int(k.drop_rate),
                        dup_rate=int(k.dup_rate),
                        min_delay=int(k.min_delay),
                        max_delay=int(k.max_delay),
                        crash_rate=int(k.crash_rate),
                    )
            if not isinstance(k, FaultConfig):
                raise TypeError(
                    f"per-lane knobs must be FaultConfig or FaultKnobs, "
                    f"got {type(k).__name__}"
                )
            if k.schedule is not None:
                raise ValueError(
                    "per-lane knobs must not carry a schedule; "
                    "schedules are per-lane runtime tables"
                )
            if k.max_delay > self.delay_bound:
                raise ValueError(
                    f"lane max_delay {k.max_delay} exceeds the "
                    f"envelope's ring bound {self.delay_bound} "
                    "(cfg.faults.max_delay)"
                )
            if k.delivery_cut != self.cfg.faults.delivery_cut:
                raise ValueError(
                    "delivery_cut is a compile-time engine flag: every "
                    f"lane must match the runner's build "
                    f"({self.cfg.faults.delivery_cut}); build a "
                    "separate runner for the other semantics"
                )
            fcs.append(k)
        mats = [netm.matrix_knobs(fc, a) for fc in fcs]
        if self.geometry is not None:
            # true-size [n, n] edge tables pad to the bound with zeros
            # (the round slices the true leading block back out)
            mats = [netm.pad_matrix_knobs(m, a) for m in mats]
        stacked = netm.FaultKnobs(
            drop_rate=np.stack([m.drop_rate for m in mats]),
            dup_rate=np.stack([m.dup_rate for m in mats]),
            min_delay=np.stack([m.min_delay for m in mats]),
            max_delay=np.stack([m.max_delay for m in mats]),
            crash_rate=np.asarray([fc.crash_rate for fc in fcs], np.int32),
            # the gray clamp is each lane's OWN declared bound (what
            # lane_cfg() replays single-run), never the envelope ring
            delay_bound=np.asarray([fc.max_delay for fc in fcs], np.int32),
        )
        return stacked, fcs

    def run(
        self,
        seeds,
        schedules,
        workloads=None,
        knobs=None,
        regions=None,
        geometry=None,
        protocol=None,
    ) -> FleetReport:
        """One fleet dispatch: ``seeds[i]``, ``schedules[i]``
        (FaultSchedule or None) and ``knobs[i]`` (FaultConfig /
        FaultKnobs, or None for the base cfg's mix) drive lane ``i``;
        ``workloads`` optionally carries per-lane ``(workload, gates)``
        pairs (template-shaped; vid sets free within the envelope's vid
        bound); ``regions`` (telemetry runners only) optionally carries
        per-lane ``[A]`` node->region maps for the recorder's
        per-region-pair counters (None: every node in region 0).  Returns
        once the verdict vectors (and an armed runner's summaries) are on
        the host; the per-lane states stay on the device.

        Runners from the envelope cache (``fleet/envelope.runner_for``)
        REJECT ``workloads=None`` / ``knobs=None``: the cached template's
        queue order and base knobs belong to whichever caller warmed the
        cache.

        A padded runner takes every dispatch's TRUE geometry as
        ``geometry=(n_nodes, proposers)`` (on its menu) and its protocol
        knobs as ``protocol`` (a ProtocolConfig; None: the build cfg's),
        with explicit ``workloads=``; the report's ``cfg`` is the true
        geometry's."""
        if self.explicit_inputs_only and (workloads is None or knobs is None):
            raise ValueError(
                "this runner came from the envelope cache "
                "(fleet/envelope.runner_for): pass explicit workloads= "
                "and knobs= — its template queues and base knob mix "
                "are cache-normalized, not yours"
            )
        if self.geometry is None:
            if geometry is not None or protocol is not None:
                raise ValueError(
                    "geometry=/protocol= are geometry-padded dispatch "
                    "inputs; build the runner with a GeometryEnvelope "
                    "(FleetRunner(geometry=...))"
                )
            gm = pkn = None
            report_cfg = self.cfg
        else:
            if geometry is None:
                raise ValueError(
                    "a geometry-padded runner takes its TRUE geometry "
                    "per dispatch: run(geometry=(n_nodes, proposers))"
                )
            if workloads is None:
                raise ValueError(
                    "a geometry-padded dispatch needs explicit "
                    "workloads= (the verdict's vid->owner map is "
                    "computed against the TRUE geometry, not the "
                    "bound cfg)"
                )
            n_true, true_props = geometry
            true_props = tuple(int(x) for x in true_props)
            pc = protocol if protocol is not None else self.cfg.protocol
            # named rejections: off-menu / over-bound geometries through
            # GeometryEnvelope.index_of, out-of-span knobs through
            # config.PROTOCOL_SPANS in geo.protocol_knobs
            gm = geo.geometry_for(self.geometry, n_true, true_props)
            pkn = geo.protocol_knobs(pc, stall_patience=simm.IDLE_RESTART_ROUNDS)
            report_cfg = dataclasses.replace(
                self.cfg, n_nodes=int(n_true), proposers=true_props, protocol=pc,
            )
        seeds = [int(s) for s in seeds]
        schedules = list(schedules)
        n_lanes = len(seeds)
        if len(schedules) != n_lanes:
            raise ValueError("one schedule per lane required")
        pmesh.check_lanes(self.mesh, n_lanes)
        tabs = stm.encode_batch(schedules, self.cfg.n_nodes, self.max_episodes)
        kn, fault_cfgs = self._knob_arrays(n_lanes, knobs)
        # a gray episode on a lane whose declared bound is 0 would clamp
        # to a no-op: rejected by name, never silently excluded
        for i, (fc_i, s_i) in enumerate(zip(fault_cfgs, schedules)):
            if (
                fc_i.max_delay == 0
                and s_i is not None
                and any(e.kind == "gray" for e in s_i.episodes)
            ):
                raise ValueError(
                    f"lane {i}: gray episodes need a nonzero lane "
                    "max_delay (the delay-inflation clamp is the "
                    "lane's own declared bound; at 0 every gray "
                    "episode is a no-op)"
                )
        roots = prng.root_keys(seeds)
        pend, gate, tail, exp, own, exp_list = self._queues(
            n_lanes, workloads,
            owner_cfg=None if self.geometry is None else report_cfg,
        )
        if regions is not None and not self.telemetry:
            raise ValueError(
                "regions maps feed the flight recorder's region-pair "
                "counters; build the runner with telemetry=True"
            )
        if self.telemetry:
            a = self.cfg.n_nodes
            if regions is None:
                rmaps = np.zeros((n_lanes, a), np.int32)
            else:
                regions = list(regions)
                if len(regions) != n_lanes:
                    raise ValueError("one region map per lane required")
                rmaps = np.stack([
                    np.zeros((a,), np.int32) if r is None
                    else np.asarray(r, np.int32).reshape(a)
                    for r in regions
                ])
        else:
            rmaps = None
        budgets = self.cfg.max_rounds + tabs.horizon.astype(np.int64)
        lane_in = (roots, pend, gate, tail, exp, own, tabs, kn, budgets, rmaps)
        gp = dict(geom=gm, pknobs=pkn)
        for dev in self.devices:
            if dev.type == "cuda":
                # paxlint: allow[JAX103] one wait a device before the dispatch's wall clock starts
                torch.cuda.synchronize(dev)
        # paxlint: allow[DET001] wall metric only; never reaches artifacts
        t0 = time.perf_counter()
        outs = pmesh.on_lanes(self.mesh, "fleet", lambda _r, dev, blk: self._dispatch(dev, blk, gp),
                              self.device, lane_in)
        final = pmesh.gather_lanes(self.mesh, "fleet", [o[0] for o in outs])
        host = pmesh.gather_lanes(self.mesh, "fleet", [o[1] for o in outs])
        iters = max(o[2] for o in outs)
        rank_iters = [] if self.mesh is None else [o[2] for o in outs]
        verdict = host[0]
        tsum, wsum = (host[1], host[2]) if self.telemetry else (None, None)
        # paxlint: allow[DET001] wall metric only; never reaches artifacts
        seconds = time.perf_counter() - t0
        return FleetReport(
            cfg=report_cfg,
            n_lanes=n_lanes,
            seeds=seeds,
            schedules=schedules,
            verdict=verdict,
            final=final,
            expected=self.expected,
            seconds=seconds,
            fault_cfgs=fault_cfgs,
            expected_lanes=exp_list,
            iterations=iters,
            telemetry=tsum,
            windows=wsum,
            rank_iterations=rank_iters,
        )

    def _dispatch(self, dev, lane_in, gp):
        """The device part of a dispatch for one block of lanes on
        ``dev``: ``(final states, host verdict trees, round calls)``; the
        verdict's one copy is the sync."""
        roots, pend, gate, tail, exp, own, tabs, kn, budgets, rmaps = lane_in
        round_fn = self._rounds[str(dev)]
        states = simm.init_lanes(self.cfg, pend, gate, tail, roots, device=dev,
                                 geometry=self.geometry, **gp)
        if self.telemetry:
            from tpu_paxos_torch.telemetry import recorder as telem

            c, n_lanes = self.cfg, roots.shape[0]
            tele0 = (
                telem.init_telemetry(c.n_instances, len(c.proposers), c.n_nodes,
                                     lanes=n_lanes, device=dev),
                telem.init_windows(c.n_nodes, lanes=n_lanes, device=dev),
            )
            final, tele, iters = simm.run_lanes(
                round_fn, roots, states, budgets, tabs, kn, tele=tele0, **gp)
        else:
            final, iters = simm.run_lanes(round_fn, roots, states, budgets, tabs, kn, **gp)
        trees = [vdt.lane_verdict(
            self.cfg, final,
            torch.from_numpy(np.array(exp)).to(dev),
            torch.from_numpy(np.array(own)).to(dev),
            self.vid_bound, geom=gp["geom"],
        )]
        if self.telemetry:
            trees += telem.close(tele, final, tabs.horizon, rmaps, telem.WINDOW_ROUNDS)
        return final, tuple(devm.to_host(*trees)), iters


# ---------------- the shard certificate's lane drivers ----------------


def _parity_mesh(n_devices: int, dcn_hosts: int, device):
    """A parity run's mesh: none at one device (JAX's ``mesh=None``), else
    ``n_devices`` ranks, ``(dcn_hosts, n_devices / dcn_hosts)`` when
    ``dcn_hosts > 1``."""
    from tpu_paxos_torch.parallel import mesh as pm

    if n_devices <= 1:
        return None
    return pm.make_instance_mesh(n_devices, dcn_hosts=dcn_hosts, device=device)


def _audit_cfg() -> SimConfig:
    """JAX's fleet audit config: the engine's canonical small config with
    drop 500, crash 1000 and a delay bound of 2."""
    return dataclasses.replace(
        simm.audit_canonical_cfg(),
        faults=FaultConfig(drop_rate=500, crash_rate=1000, max_delay=2),
    )


def _audit_scheds(n_lanes: int) -> list:
    """JAX's canonical two-lane episode mix, cycled over ``n_lanes``."""
    from tpu_paxos_torch.core import faults as fltm

    base = [
        fltm.FaultSchedule((fltm.partition(2, 6, (0,), (1, 2)),)),
        fltm.FaultSchedule((fltm.pause(1, 4, 1), fltm.gray(2, 5, 2, delay=2))),
    ]
    return [base[i % 2] for i in range(n_lanes)]


def parity_record(rep, nibbles, stride: int, n_instances: int) -> dict:
    """A fleet dispatch as the shard certificate records it: one hex
    nibble a lane (``nibbles(verdict, i)``) and each lane's decision-log
    sha256."""
    import hashlib

    from tpu_paxos_torch.replay.decision_log import decision_log

    met = rep.final.met
    vids, bals = met.chosen_vid.cpu().numpy(), met.chosen_ballot.cpu().numpy()
    return {
        "verdicts": "".join(format(nibbles(rep.verdict, i), "x") for i in range(rep.n_lanes)),
        "lane_logs": [
            hashlib.sha256(decision_log(vids[i], bals[i], stride, n_instances).encode()).hexdigest()
            for i in range(rep.n_lanes)
        ],
    }


def _sim_nibble(v, i: int) -> int:
    return ((int(bool(v.ok[i])) << 3) | (int(bool(v.agreement[i])) << 2)
            | (int(bool(v.coverage[i])) << 1) | int(bool(v.quiescent[i])))


def shard_parity(n_devices: int, dcn_hosts: int = 1, device="cuda") -> dict:
    """The certificate's ``fleet.run_lanes`` driver (JAX's
    ``audit_entries`` ``shard_parity``): one 8-lane dispatch of the audit
    config on an ``n_devices``-rank tile; per-lane verdict nibbles
    (ok|agreement|coverage|quiescent) and decision-log sha256."""
    mesh = _parity_mesh(n_devices, dcn_hosts, device)
    cfg = _audit_cfg()
    runner = FleetRunner(cfg, simm.default_workload(cfg), max_episodes=2, mesh=mesh,
                         device=device)
    rep = runner.run(list(range(8)), _audit_scheds(8))
    return parity_record(rep, _sim_nibble, runner.vid_bound, cfg.n_instances)


def shard_parity_envelope(n_devices: int, dcn_hosts: int = 1, device="cuda") -> dict:
    """The certificate's ``fleet.run_lanes_envelope`` driver: the same
    dispatch at the audit geometry (3 nodes, 2 proposers) through the
    runner padded to a (5, 3) menu bound."""
    mesh = _parity_mesh(n_devices, dcn_hosts, device)
    cfg = _audit_cfg()
    genv = geo.GeometryEnvelope(menu=((3, (0, 1)), (5, (0, 1, 2))))
    workload = simm.default_workload(cfg)
    runner = FleetRunner(genv.bound_cfg(cfg), workload, max_episodes=2, geometry=genv,
                         mesh=mesh, device=device)
    rep = runner.run(
        list(range(8)), _audit_scheds(8),
        workloads=[(workload, None)] * 8, knobs=[cfg.faults] * 8,
        geometry=(cfg.n_nodes, cfg.proposers),
    )
    return parity_record(rep, _sim_nibble, runner.vid_bound, cfg.n_instances)


def _audit_knobs(cfg: SimConfig, n_lanes: int) -> list:
    """JAX's canonical two-lane knob mix (the audit config's i.i.d. faults,
    then a uniform per-edge table), cycled over ``n_lanes``."""
    mixes = [cfg.faults, FaultConfig(
        max_delay=2, edges=EdgeFaultConfig.uniform(cfg.n_nodes, dup_rate=1000, max_delay=1),
    )]
    return [mixes[i % 2] for i in range(n_lanes)]


def _audit_genv() -> geo.GeometryEnvelope:
    return geo.GeometryEnvelope(menu=((3, (0, 1)), (5, (0, 1, 2))))


def audit_entries():
    """The fleet runner's registered entry points (``analysis/registry.py``),
    JAX's canonical dispatches: 2 lanes of the audit config with distinct
    episode mixes and distinct i.i.d. knob mixes (the runtime-schedule,
    runtime-knob build and its on-device verdict), the same through the
    geometry-padded (5, 3) runner, and the recorder-armed runner.
    ``shard_build`` lays the first two over a grid mesh at 8 lanes (the
    tile makes no collective); ``shard_state`` is their lane-stacked
    initial state at 8 lanes, which divide the shard tier's grid."""
    from tpu_paxos_torch.analysis.registry import AuditEntry

    def _setup(telemetry: bool = False, mesh=None, n_lanes: int = 2, device="cuda"):
        cfg = _audit_cfg()
        runner = FleetRunner(cfg, simm.default_workload(cfg), max_episodes=2,
                             telemetry=telemetry, mesh=mesh, device=device)

        def fn():
            return runner.run(list(range(n_lanes)), _audit_scheds(n_lanes),
                              knobs=_audit_knobs(cfg, n_lanes))

        return fn, ()

    def _setup_envelope(mesh=None, n_lanes: int = 2, device="cuda"):
        cfg = _audit_cfg()
        workload = simm.default_workload(cfg)
        runner = FleetRunner(_audit_genv().bound_cfg(cfg), workload, max_episodes=2,
                             geometry=_audit_genv(), mesh=mesh, device=device)

        def fn():
            return runner.run(
                list(range(n_lanes)), _audit_scheds(n_lanes),
                workloads=[(workload, None)] * n_lanes, knobs=_audit_knobs(cfg, n_lanes),
                geometry=(cfg.n_nodes, cfg.proposers),
            )

        return fn, ()

    def shard_state(envelope: bool):
        cfg = _audit_cfg()
        workload = simm.default_workload(cfg)
        n_lanes = 8
        roots = prng.root_keys(range(n_lanes))
        if not envelope:
            runner = FleetRunner(cfg, workload, max_episodes=2, device="cpu")
            pend, gate, tail, *_ = runner._queues(n_lanes, None)
            return "fleet", simm.init_lanes(runner.cfg, pend, gate, tail, roots, device="cpu")
        genv = _audit_genv()
        runner = FleetRunner(genv.bound_cfg(cfg), workload, max_episodes=2, geometry=genv,
                             device="cpu")
        owner_cfg = dataclasses.replace(runner.cfg, n_nodes=cfg.n_nodes, proposers=cfg.proposers)
        pend, gate, tail, *_ = runner._queues(n_lanes, [(workload, None)] * n_lanes,
                                             owner_cfg=owner_cfg)
        gm = geo.geometry_for(genv, cfg.n_nodes, cfg.proposers)
        pkn = geo.protocol_knobs(cfg.protocol, stall_patience=simm.IDLE_RESTART_ROUNDS)
        return "fleet", simm.init_lanes(runner.cfg, pend, gate, tail, roots, device="cpu",
                                        geometry=genv, geom=gm, pknobs=pkn)

    return [
        AuditEntry(
            "fleet.run_lanes", lambda device: _setup(device=device),
            covers=("FleetRunner.run",),
            shard_build=lambda mesh: _setup(mesh=mesh, n_lanes=8, device=mesh.devices[0]),
            shard_state=lambda n_shards=1: shard_state(False),
        ),
        AuditEntry(
            "fleet.run_lanes_envelope", lambda device: _setup_envelope(device=device),
            shard_build=lambda mesh: _setup_envelope(mesh=mesh, n_lanes=8,
                                                     device=mesh.devices[0]),
            shard_state=lambda n_shards=1: shard_state(True),
        ),
        AuditEntry("fleet.run_lanes_telemetry",
                   lambda device: _setup(telemetry=True, device=device)),
    ]
