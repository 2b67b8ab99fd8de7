"""Fleet serving: many tenant value streams per dispatch, with per-lane
SLO verdicts reduced on the device (port of ``tpu_paxos/serve/fleet.py``;
the per-lane admission controller is
``serve/control.controlled_fleet_run``).

JAX ``vmap``s the serve driver's whole dispatch window over a
``[lanes]`` axis.  The port runs the same dispatch over the lane-axis
round (``serve/driver.run_window_lanes``): every lane's ingest stamps,
queue appends and ``rounds_per_window`` recorder-armed rounds per
sub-window advance together, one hash pass and one launch of each
``simkern`` kernel a round for all lanes.  Lanes run in lockstep on the
shared virtual clock; lanes whose plans ended run decision-neutral
drain windows, exactly as the single harness runs past quiescence.
Lanes differ in arrivals, seeds and SLOs, never in the engine build:
``fleet/envelope.serve_fleet_for`` memoizes one
:class:`ServeFleetRunner` per serve envelope, and lane count, windows
per dispatch and admit width are call shapes.

The SLO monitor runs on the device: each dispatch reduces every lane's
windowed latency series (global and per region,
``telemetry/recorder.region_window_hist``) against the SLO thresholds
to a ``[lanes]`` breach vector (:func:`_slo_breach`), so the
per-dispatch host read is four ``[lanes]`` vectors (done / round /
decided / breach) and only breaching lanes pay the windowed series
transfer and the host judge that names their breach windows per
(lane, region).  The device verdict is a conservative superset of the
host judge (``BURN_EPS`` covers the judge's 3-decimal rounding).

Lane for lane the fleet is decision-log-identical to single
``serve/harness.serve_run`` executions of the same (cfg, stream, seed)
at the same dispatch granularity, and to JAX's fleet.

A ``mesh=`` fleet tiles the lane axis over the mesh's ranks, as the sim
fleet does (``fleet/runner.py``): the loop state is the ranks' blocks,
each on its rank's device, and every dispatch runs every rank's block
(``Mesh.run``) and gathers the four ``[lanes]`` vectors and the series
in lane order.  The host loop stays global, as JAX's: it stops on, and
picks flagged lanes from, the gathered vectors, so no rank stops early.
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from tpu_paxos_torch.config import FaultConfig, SimConfig
from tpu_paxos_torch.core import sim as simm
from tpu_paxos_torch.core import values as val
from tpu_paxos_torch.parallel import mesh as pmesh
from tpu_paxos_torch.serve import arrivals as arrv
from tpu_paxos_torch.serve import driver as drv
from tpu_paxos_torch.serve import harness as sh
from tpu_paxos_torch.telemetry import recorder as telem
from tpu_paxos_torch.utils import counters
from tpu_paxos_torch.utils import device as devm
from tpu_paxos_torch.utils import prng

#: Margin subtracted from the burn threshold by the ON-DEVICE verdict
#: (:func:`_slo_breach`).  The host judge (harness._judge_series) rounds
#: each window's burn rate to 3 decimals before comparing, so a window
#: at burn >= burn_breach - 0.0005 can round UP into a named breach; the
#: device verdict must flag every such lane (it gates the transfer), so
#: it compares against the threshold minus this margin.
BURN_EPS = 5e-4


class ServeLane(NamedTuple):
    """One tenant stream: per-proposer vid sequences, their arrival
    rounds (nondecreasing per proposer: the queue is FIFO), and the
    lane's PRNG seed (the single-run twin is ``serve_run`` on
    ``dataclasses.replace(cfg, seed=seed)``)."""

    workload: list
    arrivals: list
    seed: int


def _slo_args(slo, region_names):
    """SLO-threshold arrays for one dispatch (host numpy): ``(k,
    region_k, budget_milli, burn_milli)``.  ``slo=None`` lowers to inert
    thresholds (bucket index = NUM_LAT_BUCKETS: nothing is ever bad).

    A declared region missing from ``region_names`` has no per-region
    series; its threshold folds into the GLOBAL series bucket index
    (min: more buckets count as bad), keeping the device verdict a
    superset of the host judge's global-series fallback."""
    b = telem.NUM_LAT_BUCKETS
    rk = np.full((telem.NUM_REGIONS,), b, np.int32)
    if slo is None:
        return (np.int32(b), rk, np.int32(1), np.int32(1000))
    k = bisect.bisect_right(telem.LAT_EDGES, int(slo.latency_rounds))
    names = tuple(region_names)
    for name, lat in slo.regions:
        kr = bisect.bisect_right(telem.LAT_EDGES, int(lat))
        if name in names:
            rk[names.index(name)] = kr
        else:
            k = min(k, kr)
    return (
        np.int32(k), rk,
        np.int32(max(int(slo.budget_milli), 1)),
        np.int32(round(float(slo.burn_breach) * 1000)),
    )


def _host_int(x) -> int:
    return int(x.item()) if isinstance(x, torch.Tensor) else int(x)


def _on(x, dev) -> torch.Tensor:
    """An int threshold (numpy or tensor) as an int32 tensor on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.int32)
    return devm.to_device(torch.from_numpy(np.array(x, np.int32)), dev)


def _slo_breach(lat_hist, region_hist, slo_k, region_k, budget_milli, burn_milli):
    """The per-lane SLO verdict on the device: ``[lanes]`` bool — does
    any window of the lane's global series (threshold bucket ``slo_k``)
    or any region's own series (``region_k[r]``) burn at or above the
    breach threshold?  ``lat_hist`` is ``[lanes, W, B]``,
    ``region_hist`` ``[lanes, R, W, B]`` (int tensors); the thresholds
    come from :func:`_slo_args`.

    Float32 as JAX computes it, operation for operation: the threshold
    ``burn_milli / 1000 - BURN_EPS`` is formed in numpy float32 on the
    host (IEEE division; a tensor divided by a Python scalar may be
    multiplied by its reciprocal instead), then each window compares
    ``float32(bad * 1000) >= threshold * float32(tot * budget)``: one
    rounded product, no sum, so nothing can contract into an FMA."""
    dev = lat_hist.device
    b = lat_hist.shape[-1]
    ar = torch.arange(b, dtype=torch.int32, device=dev)
    thresh = np.float32(_host_int(burn_milli)) / np.float32(1000.0) - np.float32(BURN_EPS)
    thresh = devm.to_device(torch.from_numpy(np.array(thresh, np.float32)), dev)
    budget = _host_int(budget_milli)

    def burns(hist, bad_mask):
        tot = hist.to(torch.int32).sum(dim=-1, dtype=torch.int32)
        bad = (hist.to(torch.int32) * bad_mask).sum(dim=-1, dtype=torch.int32)
        num = (bad * 1000).to(torch.float32)
        den = (tot * budget).to(torch.float32)
        return (tot > 0) & (num >= thresh * den)

    g = burns(lat_hist, (ar >= _on(slo_k, dev)).to(torch.int32))
    rmask = (ar[None, :] >= _on(region_k, dev)[:, None]).to(torch.int32)
    r = burns(region_hist, rmask[None, :, None, :])
    return g.any(dim=-1) | r.any(dim=-1).any(dim=-1)


class ServeFleetRunner:
    """Fleet serving front end for one serve envelope: the lane-axis
    dispatch window with the ``[lanes]``-stacked loop state consumed per
    call.  ``run`` (the host loop) lives in :func:`serve_fleet_run`.

    The engine build is exactly the single serve driver's
    (``build_engine(cfg, queue_cap, vid_cap=0, telemetry=True,
    window_rounds=ww)``), which is what makes a fleet lane
    decision-log-identical to its ``serve_run`` twin."""

    def __init__(
        self,
        cfg: SimConfig,
        queue_cap: int,
        vid_bound: int,
        rounds_per_window: int,
        window_rounds: int,
        mesh=None,
        device="cuda",
    ):
        if cfg.faults.schedule is not None:
            raise ValueError(
                "serve engines take no fault schedule (correlated-fault "
                "serving rides the fleet envelope, not this driver)"
            )
        ww = int(window_rounds)
        if ww <= 0:
            raise ValueError(
                "fleet serving always rides the windowed plane (the "
                "on-device SLO verdict reads it); window_rounds must "
                "be positive"
            )
        self.cfg = cfg
        self.queue_cap = int(queue_cap)
        self.vid_bound = int(vid_bound)
        self.rounds_per_window = int(rounds_per_window)
        self.window_rounds = ww
        self.mesh = mesh
        self.device = devm.resolve(device) if mesh is None else mesh.devices[0]
        self._rounds = pmesh.per_device(
            [self.device] if mesh is None else mesh.devices,
            lambda dev: simm.build_engine(cfg, self.queue_cap, vid_cap=0, telemetry=True,
                                          window_rounds=ww, device=dev))

    def _fn(self, sss, roots, admits, arrs, vid_regions, rmaps,
            slo_k, region_k, budget_milli, burn_milli, keeps=None):
        """One dispatch of every lane: ``(sss, done, t, decided, breach,
        summary, windows, region_windows)``, all ``[lanes, ...]`` device
        tensors; ``sss`` is consumed.  ``keeps`` is the admission
        controller's ``[L, S, P, K]`` shed mask (``serve/control.py``).
        ``sss`` is the ranks' blocks (:meth:`_init`) and comes back so;
        every other output is gathered in lane order."""
        slo = (slo_k, region_k, budget_milli, burn_milli)
        outs = pmesh.on_lanes(
            self.mesh, "serve", lambda r, dev, blk: self._dispatch(dev, sss[r], blk, slo),
            self.device, (roots, admits, arrs, vid_regions, rmaps, keeps))
        rest = pmesh.gather_lanes(self.mesh, "serve", [o[1:] for o in outs])
        return ([o[0] for o in outs], *rest)

    def _dispatch(self, dev, sss, lane_in, slo):
        """One dispatch of one block of lanes on ``dev``."""
        roots, admits, arrs, vid_regions, rmaps, keeps = lane_in
        slo_k, region_k, budget_milli, burn_milli = slo
        ww = self.window_rounds
        st, tl, ingest = drv.run_window_lanes(
            self._rounds[str(dev)], roots, sss.sim, sss.tele, sss.ingest, admits, arrs,
            self.rounds_per_window, self.vid_bound, keeps=keeps,
        )
        summ, wsum, adm = drv.epilogue(st, tl, ingest, ww, region_map=rmaps)
        rw = telem.region_window_hist(
            adm, st.met.chosen_vid, st.met.chosen_round, vid_regions, ww)
        breach = _slo_breach(wsum.lat_hist, rw, slo_k, region_k, budget_milli, burn_milli)
        # real stamped values decided per lane (hist mass: the
        # no-op-fill-free count the harness's `decided` means)
        decided = summ.lat_hist.sum(dim=-1, dtype=torch.int32)
        return drv.ServeLoopState(st, tl, ingest), st.done, st.t, decided, breach, summ, wsum, rw

    def _init(self, pend, gate, tail, roots):
        """Fresh ``[lanes]``-stacked loop state: ``pend``/``gate``
        ``[L, P, C+W]``, ``tail`` ``[L, P]`` (numpy) and ``roots``
        ``[L, 2]``: the list of the ranks' blocks, each on its rank's
        device (one block untiled)."""
        pmesh.check_lanes(self.mesh, roots.shape[0])
        return pmesh.on_lanes(self.mesh, "serve", lambda _r, dev, blk: self._init_block(dev, *blk),
                              self.device, (pend, gate, tail, roots))

    def gather(self, sss):
        """The loop state as one ``[lanes]``-stacked tree: the ranks'
        blocks concatenated on the first device, in lane order."""
        return pmesh.gather_lanes(self.mesh, "serve", sss)

    def _init_block(self, dev, pend, gate, tail, roots):
        cfg = self.cfg
        lanes = roots.shape[0]
        st = simm.init_lanes(cfg, pend, gate, tail, roots, device=dev)
        tele = (
            telem.init_telemetry(cfg.n_instances, len(cfg.proposers), cfg.n_nodes,
                                 lanes=lanes, device=dev),
            telem.init_windows(cfg.n_nodes, lanes=lanes, device=dev),
        )
        ingest = torch.full((lanes, self.vid_bound), val.NONE, dtype=torch.int32, device=dev)
        return drv.ServeLoopState(st, tele, ingest)


@dataclasses.dataclass
class ServeFleetReport:
    """One fleet serve run's outcome.  The per-lane summaries, the
    windowed series and the per-region series stay on the device; the
    per-dispatch read was four ``[lanes]`` vectors, and ``slo`` holds
    host-confirmed verdicts for the lanes the on-device monitor flagged
    (only those paid the series transfer)."""

    cfg: SimConfig
    n_lanes: int
    seeds: list
    rounds_per_window: int
    windows_per_dispatch: int
    admit_width: int
    window_rounds: int
    dispatches: int
    rounds: int
    done: bool
    n_values: list  # per-lane planned stream sizes
    decided: np.ndarray  # [lanes] real stamped values decided
    wall_seconds: float
    breach: np.ndarray  # [lanes] bool: the final on-device verdict
    first_breach_dispatch: list  # [lanes] 1-based dispatch | None
    slo: dict | None  # {lane: slo_windows verdict} for flagged lanes
    region_names: tuple
    final: object  # device [lanes]-stacked ServeLoopState
    summaries: object  # device [lanes] TelemetrySummary
    windows: object  # device [lanes, W] WindowSummary
    region_windows: object  # device [lanes, R, W, B] int32

    @property
    def decided_total(self) -> int:
        return int(self.decided.sum())

    @property
    def backlog(self) -> int:
        return int(sum(self.n_values)) - self.decided_total

    @property
    def values_per_sec(self) -> float:
        """Aggregate sustained throughput across every lane: the
        fleet's one clock served all of them."""
        return self.decided_total / max(self.wall_seconds, 1e-9)

    def lane_chosen(self, i: int):
        """One lane's decision arrays (chosen_vid, chosen_ballot), the
        decision-log parity hand-off; moves one lane."""
        met = self.final.sim.met
        return met.chosen_vid[i].cpu().numpy(), met.chosen_ballot[i].cpu().numpy()

    def lane_summary(self, i: int) -> dict:
        """One lane's flight-recorder summary dict (incl. the windowed
        block); moves that lane only."""
        one, wone = _lane_host(i, self.summaries, self.windows)
        return telem.summary_to_dict(
            one, wone, self.window_rounds,
            region_names=tuple(self.region_names),
        )

    def lane_region_windows(self, i: int) -> np.ndarray:
        """One lane's ``[R, W, B]`` per-region windowed latency
        histograms; moves that lane only."""
        return self.region_windows[i].cpu().numpy()


def _lane_host(i: int, *trees):
    """Lane ``i`` of ``[lanes, ...]`` device trees as host numpy trees,
    in one copy."""
    return [telem.lane(x, 0) for x in devm.to_host(*[simm.lane_of(tr, slice(i, i + 1))
                                                      for tr in trees])]


def _check_lane(cfg: SimConfig, lane: ServeLane, li: int):
    wl = [np.asarray(w, np.int32).reshape(-1) for w in lane.workload]
    if len(wl) != len(cfg.proposers):
        raise ValueError(
            f"lane {li}: one value stream per proposer required"
        )
    return ServeLane(wl, list(lane.arrivals), int(lane.seed))


class _FleetInputs(NamedTuple):
    """A fleet run's per-lane inputs: the runner, the empty queue arrays
    (numpy), the roots, the node->region map and, on the device, the
    per-lane maps, vid->region tables and SLO thresholds."""

    runner: object
    pend: np.ndarray
    gate: np.ndarray
    tail: np.ndarray
    roots: np.ndarray
    rmap: np.ndarray
    rmaps: torch.Tensor
    vid_regions: torch.Tensor
    slo_args: tuple


def _fleet_inputs(runner_for, cfg: SimConfig, lanes, rounds_per_window: int, ww: int,
                  slo, region_map, region_names, dev, mesh=None) -> _FleetInputs:
    """The envelope shapes (queue capacity and vid bound cover every
    lane), ``runner_for(cfg, c, v_bound, rounds_per_window,
    window_rounds=ww, mesh=mesh, device=dev)``'s runner, and the lanes'
    inputs."""
    n_lanes = len(lanes)
    c = max(simm.prepare_queues(cfg, ln.workload)[3] for ln in lanes)
    v_bound = max(drv.vid_bound_of(ln.workload) for ln in lanes)
    runner = runner_for(cfg, c, v_bound, rounds_per_window, window_rounds=ww, mesh=mesh,
                        device=dev)
    p = len(cfg.proposers)
    width = c + cfg.assign_window
    a = cfg.n_nodes
    if region_map is None:
        rmap = np.zeros((a,), np.int32)
    else:
        rmap = np.asarray(region_map, np.int32).reshape(a)
    rmaps = np.broadcast_to(rmap, (n_lanes, a))
    vid_regions = np.zeros((n_lanes, v_bound), np.int32)
    for li, ln in enumerate(lanes):
        for node, stream in zip(cfg.proposers, ln.workload):
            vid_regions[li, stream] = rmap[node]
    slo_k, region_k, budget_milli, burn_milli = _slo_args(slo, region_names)
    lane_tabs = devm.to_device(torch.from_numpy(
        np.concatenate([rmaps, vid_regions], axis=1)), dev)
    return _FleetInputs(
        runner,
        np.full((n_lanes, p, width), int(val.NONE), np.int32),
        np.full((n_lanes, p, width), int(val.NONE), np.int32),
        np.zeros((n_lanes, p), np.int32),
        prng.root_keys([ln.seed for ln in lanes]),
        rmap, lane_tabs[:, :a], lane_tabs[:, a:],
        (_on(slo_k, dev), _on(region_k, dev), budget_milli, burn_milli),
    )


def _confirm_flagged(flagged, slo, ww: int, rmap, region_names, summaries, windows,
                     region_windows) -> dict:
    """Host-confirmed verdicts for the flagged lanes ONLY: ``{lane:
    slo_windows verdict}`` naming (lane, region) breach windows with their
    diagnosis; everything else stays on the device."""
    from tpu_paxos_torch.telemetry import diagnose as diag

    out = {}
    for i in np.flatnonzero(flagged):
        i = int(i)
        lane_s, lane_w = _lane_host(i, summaries, windows)
        sd_i = telem.summary_to_dict(lane_s, lane_w, ww, region_names=tuple(region_names))
        wd_i = sd_i["windows"]
        # paxlint: allow[JAX103] one read a flagged lane, for its host-confirmed verdict
        lane_rw = region_windows[i].cpu().numpy()
        verdict = sh.slo_windows(wd_i, slo, region_series=lane_rw, region_names=region_names)
        diag.attach_diagnosis(
            verdict, wd_i,
            region_map=np.asarray(rmap),
            region_names=tuple(region_names),
            region_pairs=sd_i.get("region_pairs"),
            region_series=lane_rw,
        )
        out[i] = verdict
    return out


def serve_fleet_run(
    cfg: SimConfig,
    lanes,
    *,
    rounds_per_window: int = sh.ROUNDS_PER_WINDOW,
    windows_per_dispatch: int = sh.WINDOWS_PER_DISPATCH,
    admit_width: int | None = None,
    pipelined: bool = True,
    window_rounds: int | None = None,
    slo: sh.ServeSLO | None = None,
    region_map=None,
    region_names: tuple = (),
    mesh=None,
    device="cuda",
) -> ServeFleetReport:
    """Serve a fleet of tenant streams open-loop to completion (or the
    round budget) on ``device``: ``lanes[i]`` is a :class:`ServeLane`
    (or a ``(workload, arrivals, seed)`` triple).  Every lane advances
    in lockstep on the shared virtual clock (lanes whose plans end early
    run decision-neutral drain windows), and a 1-lane run is
    decision-log sha256-identical to ``serve_run`` at the same dispatch
    granularity.

    ``slo`` arms the on-device burn-rate monitor: each dispatch reduces
    every lane's windowed series (and, with ``region_map`` +
    ``region_names``, each region's own series) to a ``[lanes]`` breach
    vector, and only flagged lanes pay the series transfer + the host
    judge that names breach windows per (lane, region).  ``mesh`` tiles
    the lane axis over its ranks (the lane count must tile it)."""
    from tpu_paxos_torch.fleet import envelope as envm

    lanes = [
        _check_lane(cfg, ln if isinstance(ln, ServeLane) else ServeLane(*ln), i)
        for i, ln in enumerate(lanes)
    ]
    if not lanes:
        raise ValueError("at least one lane required")
    n_lanes = len(lanes)
    pmesh.check_lanes(mesh, n_lanes)
    plans = [
        arrv.ArrivalPlan(ln.workload, ln.arrivals, rounds_per_window)
        for ln in lanes
    ]
    k = int(admit_width or max(p.max_block for p in plans))
    if max(p.max_block for p in plans) > k:
        raise ValueError(
            f"admit_width {k} below this fleet's max block "
            f"{max(p.max_block for p in plans)}"
        )
    s = int(windows_per_dispatch)
    if s < 1:
        raise ValueError("windows_per_dispatch must be >= 1")
    if window_rounds is None:
        window_rounds = sh.WINDOWS_PER_BUCKET * rounds_per_window
    ww = int(window_rounds)
    if slo is not None and not ww:
        raise ValueError(
            "the SLO monitor reads the windowed series; "
            "window_rounds=0 disarms it"
        )
    dev = devm.resolve(device) if mesh is None else mesh.devices[0]
    fi = _fleet_inputs(envm.serve_fleet_for, cfg, lanes, rounds_per_window, ww, slo,
                       region_map, region_names, dev, mesh)
    p = len(cfg.proposers)
    n_disp_admit = max((pl.n_windows + s - 1) // s for pl in plans)
    disp_cap = max(
        cfg.round_budget // (rounds_per_window * s) + 1, n_disp_admit
    )
    empty = drv.upload_blocks(
        np.full((n_lanes, s, p, k), int(val.NONE), np.int32),
        np.zeros((n_lanes, s, p, k), np.int32), dev,
    )

    def super_block(d):
        """Dispatch ``d``'s S admission windows for every lane ([lanes,
        S, P, K]); lanes past their plan get empty rows."""
        adm = np.stack([
            np.stack([pl.block(d * s + i, k)[0] for i in range(s)])
            for pl in plans
        ])
        arr = np.stack([
            np.stack([pl.block(d * s + i, k)[1] for i in range(s)])
            for pl in plans
        ])
        return drv.upload_blocks(adm, arr, dev)

    first_breach: list = [None] * n_lanes

    def read(out):
        # the dispatch's four [lanes] vectors in one copy: the stop
        # scalars, the decided counts and the on-device SLO verdict
        counters.add("host_reads")
        host = torch.stack([x.reshape(n_lanes).to(torch.int32) for x in out[1:5]]).cpu().numpy()
        return host[0].astype(bool), host[1], host[2], host[3].astype(bool)

    def harvest(vecs):
        done, t, decided, breach = vecs
        for i in np.flatnonzero(breach):
            if first_breach[int(i)] is None:
                first_breach[int(i)] = harvested + 1
        return done, t, decided, breach

    pending = None
    last_done = np.zeros((n_lanes,), bool)
    last_t = np.zeros((n_lanes,), np.int32)
    last_decided = np.zeros((n_lanes,), np.int32)
    last_breach = np.zeros((n_lanes,), bool)
    last_dev = None
    d = harvested = 0
    # paxlint: allow[DET001] wall metric only; never reaches artifacts
    t0 = time.perf_counter()
    sss = fi.runner._init(fi.pend, fi.gate, fi.tail, fi.roots)
    while True:
        blk = super_block(d) if d < n_disp_admit else empty
        out = fi.runner._fn(sss, fi.roots, *blk, fi.vid_regions, fi.rmaps, *fi.slo_args)
        sss = out[0]
        vecs = read(out)
        d += 1
        if pipelined:
            if pending is not None:
                last_done, last_t, last_decided, last_breach = harvest(pending[0])
                last_dev = pending[1]
                harvested += 1
            pending = (vecs, out[5:])
        else:
            last_done, last_t, last_decided, last_breach = harvest(vecs)
            last_dev = out[5:]
            harvested += 1
        if harvested >= n_disp_admit and last_done.all():
            break
        if d >= disp_cap:
            break
    if pending is not None:
        last_done, last_t, last_decided, last_breach = harvest(pending[0])
        last_dev = pending[1]
        harvested += 1
    # paxlint: allow[DET001] wall metric only; never reaches artifacts
    wall = time.perf_counter() - t0

    summaries, windows, region_windows = last_dev
    slo_dict = None if slo is None else _confirm_flagged(
        last_breach, slo, ww, fi.rmap, region_names, summaries, windows, region_windows)
    return ServeFleetReport(
        cfg=cfg,
        n_lanes=n_lanes,
        seeds=[ln.seed for ln in lanes],
        rounds_per_window=int(rounds_per_window),
        windows_per_dispatch=s,
        admit_width=k,
        window_rounds=ww,
        dispatches=d,
        rounds=int(last_t.max()),
        done=bool(last_done.all()),
        n_values=[pl.n_values for pl in plans],
        decided=last_decided,
        wall_seconds=wall,
        breach=last_breach,
        first_breach_dispatch=first_breach,
        slo=slo_dict,
        region_names=tuple(region_names),
        final=fi.runner.gather(sss),
        summaries=summaries,
        windows=windows,
        region_windows=region_windows,
    )


# ---------------- the (lanes x offered-rates) surface ----------------


def _agg_windows_hist(rep: ServeFleetReport) -> tuple[np.ndarray, int]:
    """Fleet-aggregate windowed latency histogram ``[W, B]`` and the
    observed latency max, reduced on the device over the lane axis, so
    only the small aggregate moves."""
    hist = rep.windows.lat_hist.sum(dim=0, dtype=torch.int32).cpu().numpy()
    lat_max = int(rep.summaries.lat_max.max())
    return hist, lat_max


def _steady_p50_of(hist: np.ndarray, lat_max: int) -> int | None:
    """Steady-state median over a ``[W, B]`` windowed histogram — the
    harness's ``_steady_p50`` on an aggregate series (median of the
    active buckets' bucket-edge medians)."""
    p50s = [
        telem.latency_quantile(row, 0.50, lat_max)
        for row in hist
    ]
    p50s = [p for p in p50s if p >= 0]
    if not p50s:
        return None
    return sorted(p50s)[len(p50s) // 2]


def _fleet_point(rate_milli: int, rep: ServeFleetReport) -> dict:
    hist, lat_max = _agg_windows_hist(rep)
    total = hist.sum(axis=0)
    steady = _steady_p50_of(hist, lat_max)
    return {
        "rate_milli": int(rate_milli),
        "lanes": rep.n_lanes,
        "decided": rep.decided_total,
        "backlog": rep.backlog,
        "done": rep.done,
        "rounds": rep.rounds,
        "dispatches": rep.dispatches,
        "wall_seconds": round(rep.wall_seconds, 4),
        "values_per_sec": round(rep.values_per_sec, 1),
        "sustained": bool(rep.done and rep.backlog == 0),
        "p50": telem.latency_quantile(total, 0.50, lat_max),
        "p99": telem.latency_quantile(total, 0.99, lat_max),
        **({"p50_steady": steady} if steady is not None else {}),
        "breach_lanes": [int(i) for i in np.flatnonzero(rep.breach)],
        **({
            "slo": {str(i): v for i, v in rep.slo.items()}
        } if rep.slo else {}),
    }


def fleet_lanes(
    cfg: SimConfig,
    n_lanes: int,
    n_values: int,
    rate_milli: int,
    seed: int,
    arrivals: str = "poisson",
) -> list[ServeLane]:
    """Build one tenant fleet: ``n_lanes`` independent streams of
    ``n_values`` values each at offered rate ``rate_milli`` — every
    lane draws its OWN arrival process (seed-mixed per lane) and its
    own engine seed, deterministically per (seed, lane)."""
    build = arrv.ARRIVAL_BUILDERS[arrivals]
    vids = np.arange(int(n_values), dtype=np.int32)
    n_prop = len(cfg.proposers)
    out = []
    for li in range(int(n_lanes)):
        rounds = build(n_values, int(rate_milli), seed + 101 * li)
        streams, arrs = arrv.split_round_robin(vids, rounds, n_prop)
        out.append(ServeLane(streams, arrs, seed + li))
    return out


def grid_admit_width(
    cfg: SimConfig,
    n_values: int,
    lane_counts,
    rates_milli,
    *,
    seed: int = 0,
    rounds_per_window: int = sh.ROUNDS_PER_WINDOW,
    arrivals: str = "poisson",
) -> int:
    """ONE admit width covering every (lane count x rate) cell of a
    sweep grid: the (L, S, K) call shape keys the executable, so the
    grid must not fork it per rate.  Shared by :func:`sweep_fleet_load`
    and the bench (which needs the width BEFORE its warm pass)."""
    width = 1
    for lc in lane_counts:
        for rm in rates_milli:
            for ln in fleet_lanes(cfg, lc, n_values, rm, seed, arrivals):
                width = max(
                    width,
                    arrv.ArrivalPlan(
                        ln.workload, ln.arrivals, rounds_per_window
                    ).max_block,
                )
    return width


def sweep_fleet_load(
    cfg: SimConfig,
    n_values: int,
    lane_counts,
    rates_milli,
    *,
    seed: int = 0,
    rounds_per_window: int = sh.ROUNDS_PER_WINDOW,
    windows_per_dispatch: int = sh.WINDOWS_PER_DISPATCH,
    admit_width: int | None = None,
    window_rounds: int | None = None,
    knee_factor: float = 2.0,
    slo: sh.ServeSLO | None = None,
    region_map=None,
    region_names: tuple = (),
    mesh=None,
    arrivals: str = "poisson",
    control=None,
    device="cuda",
) -> dict:
    """The headline SURFACE: aggregate sustained values/sec and the
    saturation knee over (lane count x offered rate).  One cell = one
    fleet run of ``lane_count`` tenant streams, each ``n_values`` values
    at ``rate_milli``; every cell of a lane count shares the envelope's
    one cached runner (the admit width is the max over the whole grid),
    and the knee per lane count is ``harness.judge_knee`` over that
    row.

    ``control`` (a ``serve/control.ControlPolicy``; requires ``slo``)
    arms the per-lane admission controller in EVERY cell: points then
    carry their shed and decision ledgers, and the exit verdict
    (:func:`sweep_verdict`) refuses a floor-rate cell that only drained by
    shedding."""
    lane_counts = [int(x) for x in lane_counts]
    rates = sorted(int(x) for x in rates_milli)
    if control is not None:
        from tpu_paxos_torch.serve import control as ctlm

        if slo is None:
            raise ValueError(
                "a controlled sweep reads SLO verdicts; declare an slo"
            )
    # an explicit admit_width is authoritative (the caller computed it
    # with grid_admit_width); a too-narrow width fails loudly per run
    width = (
        int(admit_width) if admit_width
        else grid_admit_width(
            cfg, n_values, lane_counts, rates, seed=seed,
            rounds_per_window=rounds_per_window, arrivals=arrivals,
        )
    )
    cells = {}
    knee_surface = []
    surface = {}
    for lc in lane_counts:
        points = []
        for rm in rates:
            lanes = fleet_lanes(cfg, lc, n_values, rm, seed, arrivals)
            kw = dict(
                rounds_per_window=rounds_per_window,
                windows_per_dispatch=windows_per_dispatch,
                admit_width=width,
                window_rounds=window_rounds,
                slo=slo,
                region_map=region_map,
                region_names=region_names,
                mesh=mesh,
                device=device,
            )
            if control is not None:
                rep = ctlm.controlled_fleet_run(cfg, lanes, control=control, **kw)
            else:
                rep = serve_fleet_run(cfg, lanes, **kw)
            pt = _fleet_point(rm, rep)
            if control is not None:
                pt["shed"] = rep.shed_total
                pt["lane_shed"] = rep.lane_shed
                pt["control_decisions"] = len(rep.decisions)
            points.append(pt)
        knee = sh.judge_knee(points, knee_factor)
        cells[str(lc)] = {"points": points, "knee": knee}
        knee_surface.append({"lanes": lc, **knee})
        surface[str(lc)] = {
            str(pt["rate_milli"]): pt["values_per_sec"] for pt in points
        }
    return {
        "metric": "serve_fleet_latency_at_load_surface",
        "n_values": int(n_values),
        "arrivals": arrivals,
        "rounds_per_window": int(rounds_per_window),
        "windows_per_dispatch": int(windows_per_dispatch),
        "admit_width": width,
        "lane_counts": lane_counts,
        "rates_milli": rates,
        "values_per_sec_surface": surface,
        "cells": cells,
        "knee_surface": knee_surface,
        **({
            "control": ctlm.policy_to_dict(control)
        } if control is not None else {}),
    }


def sweep_verdict(summary: dict) -> bool:
    """The sweep's exit verdict: every lane count's FLOOR-rate cell must
    drain (a fleet that saturates at the floor rate is broken no matter
    how the single-lane row looks).

    Controller-armed sweeps (``summary["control"]``) are judged HARDER at
    the floor: the floor cell must drain with ZERO sheds and no
    host-confirmed floor breach (a controller that sheds its way to zero
    backlog at the floor rate is masking saturation); their higher-rate
    cells are exploratory.  Uncontrolled sweeps red the whole surface on
    any host-confirmed breach in any cell."""
    cells = summary.get("cells", {})
    if not cells:
        return False
    controlled = "control" in summary
    for c in cells.values():
        floor = c["points"][0]
        if not floor["sustained"]:
            return False
        if controlled:
            if floor.get("shed", 0):
                return False
            if floor.get("slo") and not all(
                v["ok"] for v in floor["slo"].values()
            ):
                return False
        else:
            for pt in c["points"]:
                if pt.get("slo") and not all(v["ok"] for v in pt["slo"].values()):
                    return False
    return True


# ---------------- the shard certificate's lane driver ----------------


def shard_parity(n_devices: int, dcn_hosts: int = 1, device="cuda") -> dict:
    """The certificate's ``serve.fleet_window`` driver (JAX's
    ``audit_entries`` ``shard_parity``): an 8-lane serve fleet (3 nodes,
    16 instances, drop 500, delay bound 2; 6 values a lane at 1500 milli)
    on an ``n_devices``-rank tile; per-lane nibbles (drained|breach) and
    decision-log sha256."""
    import hashlib

    from tpu_paxos_torch.fleet import runner as frun
    from tpu_paxos_torch.replay.decision_log import decision_log

    mesh = frun._parity_mesh(n_devices, dcn_hosts, device)
    cfg = SimConfig(n_nodes=3, n_instances=16, proposers=(0, 1), seed=0, max_rounds=256,
                    faults=FaultConfig(drop_rate=500, max_delay=2))
    rep = serve_fleet_run(
        cfg, fleet_lanes(cfg, 8, 6, 1500, 0),
        rounds_per_window=8, windows_per_dispatch=2, admit_width=6, mesh=mesh,
        slo=sh.ServeSLO(latency_rounds=16, budget_milli=100), device=device,
    )
    logs = []
    for i in range(rep.n_lanes):
        cv, cb = rep.lane_chosen(i)
        logs.append(hashlib.sha256(
            decision_log(cv, cb, stride=30, n_instances=len(cv)).encode()).hexdigest())
    return {
        "verdicts": "".join(
            format((int(rep.decided[i]) == rep.n_values[i]) << 1 | int(bool(rep.breach[i])), "x")
            for i in range(rep.n_lanes)
        ),
        "lane_logs": logs,
    }


# ---------------- CLI ----------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_paxos_torch serve --fleet",
        description="fleet serving: many tenant streams per dispatch "
        "(lane-axis serve windows, on-device per-lane SLO verdicts); "
        "single-cell run or the (lanes x rates) sustained-load + knee "
        "surface",
    )
    ap.add_argument("--nodes", type=int, default=5)
    ap.add_argument("--proposers", type=int, default=2)
    ap.add_argument("--lanes", type=int, default=4,
                    help="tenant streams per dispatch")
    ap.add_argument("--lane-counts", type=str, default="",
                    help="comma-separated lane counts: sweep the "
                    "(lanes x rates) SURFACE instead of one cell")
    ap.add_argument("--values", type=int, default=128,
                    help="values per lane stream")
    ap.add_argument("--rate-milli", type=int, default=4000)
    ap.add_argument("--sweep", type=str, default="",
                    help="comma-separated rate_milli list (the "
                    "surface's rate axis; single-cell otherwise)")
    ap.add_argument("--arrivals", type=str, default="poisson",
                    choices=sorted(arrv.ARRIVAL_BUILDERS),
                    help="arrival process per lane (serve/arrivals.py)")
    ap.add_argument("--rounds-per-window", type=int,
                    default=sh.ROUNDS_PER_WINDOW)
    ap.add_argument("--windows-per-dispatch", type=int,
                    default=sh.WINDOWS_PER_DISPATCH)
    ap.add_argument("--window-rounds", type=int, default=-1,
                    help="windowed bucket width in rounds (-1 = 4 "
                    "admission windows)")
    ap.add_argument("--slo-latency", type=int, default=0,
                    help="latency SLO in rounds; arms the on-device "
                    "per-lane burn-rate verdict (0 = no SLO)")
    ap.add_argument("--slo-budget-milli", type=int, default=100)
    ap.add_argument("--control", action="store_true",
                    help="arm the per-lane admission controller "
                    "(serve/control.py) in every cell; requires "
                    "--slo-latency.  The sweep verdict then refuses "
                    "a floor-rate cell that only drained by shedding")
    ap.add_argument("--priority-tiers", type=int, default=3,
                    help="declared per-value priority tiers for "
                    "--control (tier 0 = always admit)")
    ap.add_argument("--instances", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-rounds", type=int, default=20_000)
    ap.add_argument("--drop-rate", type=int, default=0)
    ap.add_argument("--dup-rate", type=int, default=0)
    ap.add_argument("--max-delay", type=int, default=0)
    ap.add_argument("--crash-rate", type=int, default=0)
    ap.add_argument("--mesh", type=int, default=0,
                    help="tile the lane axis over an N-rank mesh (lanes "
                    "must tile it)")
    ap.add_argument("--dcn-hosts", type=int, default=1,
                    help="with --mesh, arrange the ranks as a 2-D "
                    "(dcn-hosts x chips) mesh")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    n_inst = args.instances or max(64, 2 * args.values)
    cfg = SimConfig(
        n_nodes=args.nodes,
        n_instances=n_inst,
        proposers=tuple(range(args.proposers)),
        seed=args.seed,
        max_rounds=args.max_rounds,
        faults=FaultConfig(
            drop_rate=args.drop_rate,
            dup_rate=args.dup_rate,
            max_delay=args.max_delay,
            crash_rate=args.crash_rate,
        ),
    )
    mesh = None
    if args.mesh > 1:
        from tpu_paxos_torch.parallel import mesh as pm

        mesh = pm.make_instance_mesh(args.mesh, dcn_hosts=args.dcn_hosts, device=args.device)
    w_rounds = None if args.window_rounds < 0 else args.window_rounds
    slo = (
        sh.ServeSLO(latency_rounds=args.slo_latency,
                    budget_milli=args.slo_budget_milli)
        if args.slo_latency else None
    )
    policy = None
    if args.control:
        from tpu_paxos_torch.serve import control as ctlm

        if slo is None:
            raise SystemExit(
                "--control reads SLO verdicts; declare --slo-latency"
            )
        n_tiers = args.priority_tiers
        policy = ctlm.ControlPolicy(
            n_tiers=n_tiers,
            defer_tier=max(n_tiers - 1, 1),
            shed_tier=max(n_tiers - 1, 1),
        )
    if args.sweep or args.lane_counts:
        rates = (
            [int(x) for x in args.sweep.split(",") if x.strip()]
            if args.sweep else [args.rate_milli]
        )
        lane_counts = (
            [int(x) for x in args.lane_counts.split(",") if x.strip()]
            if args.lane_counts else [args.lanes]
        )
        summary = sweep_fleet_load(
            cfg, args.values, lane_counts, rates,
            seed=args.seed,
            rounds_per_window=args.rounds_per_window,
            windows_per_dispatch=args.windows_per_dispatch,
            window_rounds=w_rounds,
            slo=slo,
            mesh=mesh,
            arrivals=args.arrivals,
            control=policy,
            device=args.device,
        )
        # every lane count's LOWEST-rate cell must drain; a controller-
        # armed cell must also drain WITHOUT shedding at the floor
        summary["ok"] = sweep_verdict(summary)
    else:
        lanes = fleet_lanes(cfg, args.lanes, args.values,
                            args.rate_milli, args.seed, args.arrivals)
        kw = dict(
            rounds_per_window=args.rounds_per_window,
            windows_per_dispatch=args.windows_per_dispatch,
            window_rounds=w_rounds,
            slo=slo,
            mesh=mesh,
            device=args.device,
        )
        if policy is not None:
            rep = ctlm.controlled_fleet_run(cfg, lanes, control=policy, **kw)
        else:
            rep = serve_fleet_run(cfg, lanes, **kw)
        summary = {
            "metric": "serve_fleet",
            "arrivals": args.arrivals,
            **_fleet_point(args.rate_milli, rep),
            "first_breach_dispatch": [
                fb for fb in rep.first_breach_dispatch
            ],
            "ok": bool(
                rep.done and rep.backlog == 0
                and (not rep.slo
                     or all(v["ok"] for v in rep.slo.values()))
            ),
        }
        if policy is not None:
            summary["shed"] = rep.shed_total
            summary["lane_shed"] = rep.lane_shed
            summary["control_decisions"] = len(rep.decisions)
    print(json.dumps(summary, sort_keys=True))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())


def audit_setup(runner_cls, mesh=None, n_lanes: int = 2, device="cuda", keeps: bool = False):
    """JAX's canonical fleet serve dispatch of ``runner_cls`` (the serve or
    the controlled fleet runner): ``n_lanes`` lanes of the serve audit
    config, empty queues, each lane the same 2-window admission blocks
    (``keeps``: with a keep mask that sheds one real value), and one SLO.
    Returns ``(fn, args)`` for one ``runner._fn`` call."""
    cfg = drv.audit_cfg()
    workload = simm.default_workload(cfg)
    v_bound = drv.vid_bound_of(workload)
    c = simm.prepare_queues(cfg, workload)[3]
    runner = runner_cls(cfg, c, v_bound, drv.AUDIT_R_WINDOW, drv.AUDIT_W_ROUNDS, mesh=mesh,
                        device=device)
    dev = runner.device
    p = len(cfg.proposers)
    width = c + cfg.assign_window
    sss = runner._init(
        np.full((n_lanes, p, width), val.NONE, np.int32),
        np.full((n_lanes, p, width), val.NONE, np.int32),
        np.zeros((n_lanes, p), np.int32),
        prng.root_keys(range(n_lanes)),
    )
    admits, arrs = drv.audit_blocks(workload, p)
    admits, arrs = (np.broadcast_to(x, (n_lanes, *x.shape)).copy() for x in (admits, arrs))
    blocks = drv.upload_blocks(admits, arrs, dev)
    if keeps:
        kp = np.ones(admits.shape, bool)
        kp[:, 0, 0, 0] = False
        blocks = (*blocks, devm.to_device(torch.from_numpy(kp), dev))
    regions = (
        devm.to_device(torch.zeros((n_lanes, v_bound), dtype=torch.int32), dev),
        devm.to_device(torch.zeros((n_lanes, cfg.n_nodes), dtype=torch.int32), dev),
    )
    slo_k, region_k, budget_milli, burn_milli = _slo_args(
        sh.ServeSLO(latency_rounds=16, budget_milli=100, regions=(("us", 8),)), ("us",))
    slo = (_on(slo_k, dev), _on(region_k, dev), budget_milli, burn_milli)
    return runner._fn, (sss, prng.root_keys(range(n_lanes)), *blocks, *regions, *slo)


def audit_entries():
    """The fleet serve window's registered entry point
    (``analysis/registry.py``), JAX's canonical dispatch: 2 lanes of the
    serve audit config, a 2-window dispatch of real admission blocks
    through the lane-stacked round spans, the per-lane summary, window
    and region epilogues and the on-device SLO breach reduction.
    ``shard_build`` lays it over a grid mesh at 8 lanes; ``shard_state`` is
    the lane-stacked loop state at 8 lanes."""
    from tpu_paxos_torch.analysis.registry import AuditEntry

    def shard_state(n_shards: int = 1):
        _fn, args = audit_setup(ServeFleetRunner, n_lanes=8, device="cpu")
        return "serve", args[0][0]

    return [AuditEntry(
        "serve.fleet_window", lambda device: audit_setup(ServeFleetRunner, device=device),
        covers=("ServeFleetRunner._fn", "ServeFleetRunner._init"),
        shard_build=lambda mesh: audit_setup(ServeFleetRunner, mesh=mesh, n_lanes=8),
        shard_state=shard_state,
    )]
