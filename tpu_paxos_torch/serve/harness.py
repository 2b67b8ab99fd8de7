"""Host-side open-loop ingestion loop: dispatch windows over the serve
driver, latency-at-load sweeps, and the ``python -m tpu_paxos_torch
serve`` CLI (port of ``tpu_paxos/serve/harness.py``; ``--control``,
``--control-ab`` and ``--save-artifact`` drive the admission controller,
``serve/control.py``).

The loop runs ``windows_per_dispatch`` admission windows per dispatch
(``serve/driver.py``), the donated-state analog chaining on the device.
The **pipelined** mode (the default) harvests each dispatch's stop
scalars and metrics after issuing the next one, as JAX's double buffer
does; the **sequential baseline** (``windows_per_dispatch=1,
pipelined=False``) harvests each before the next.  The port reproduces
both loops' control flow exactly (the pipelined one stops one dispatch
later, and its last pending harvest sets ``rounds``), so ``dispatches``,
``windows_count``, ``rounds``, ``window_decided`` and
``slo_first_breach_dispatch`` equal JAX's in both modes.  JAX hides the
per-dispatch toll behind the next dispatch's compute; the port's round
reads its predicates on the host every round, so it claims no overlap.

Every dispatch granularity runs a BIT-IDENTICAL protocol trajectory:
windows are fixed round spans, admission happens every
``rounds_per_window`` rounds stamped with true arrival rounds, and the
plan is precomputed on the virtual clock (``serve/arrivals.py``).

The WINDOWED plane (on by default) makes each dispatch's epilogue a
metrics stream: per-virtual-clock-bucket latency histograms, drop
counts and stall depth arrive with every harvest, and the
:class:`ServeSLO` burn-rate monitor judges them per dispatch, so a
latency breach confined to one burst window is named (bucket index +
round span) even when the run-total histogram ends green.
``sweep_load`` carries the verdicts into the sweep summary and
``judge_knee`` reads the windowed steady-state median.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

from tpu_paxos_torch.config import FaultConfig, SimConfig
from tpu_paxos_torch.serve import arrivals as arrv
from tpu_paxos_torch.utils import counters

#: Default admission-window span, in rounds: admission latency is
#: bounded by one window span.
ROUNDS_PER_WINDOW = 8

#: Default admission windows per dispatch (1 = the sequential-dispatch
#: baseline).
WINDOWS_PER_DISPATCH = 8

#: Default windowed-plane bucket width, in admission windows: each of
#: the recorder's NUM_WINDOWS time buckets spans this many admission
#: windows (bucket width = WINDOWS_PER_BUCKET * rounds_per_window
#: rounds), so the SLO monitor's burn windows stay aligned with the
#: granularity values enter the system at.
WINDOWS_PER_BUCKET = 4


@dataclasses.dataclass(frozen=True)
class ServeSLO:
    """A declared serving SLO judged on the WINDOWED latency series.

    A decided value is GOOD when its commit latency (ingest-to-commit,
    in rounds) is <= ``latency_rounds`` — quantized DOWN to the
    recorder's histogram edge grid (``telemetry/recorder.LAT_EDGES``),
    so the per-window good/bad split is exact, never interpolated.
    ``budget_milli`` is the error budget: the allowed bad fraction per
    1000 decided values.  The per-window BURN RATE is the window's bad
    fraction over the budget (the SRE burn-rate convention: burn 1.0
    = spending the budget exactly; burn 4.0 = spending it 4x too
    fast), and a window at or above ``burn_breach`` is a named breach
    window — which is exactly what the run-total histogram cannot
    see: a mid-run breach that later traffic dilutes below the budget
    leaves the final histogram green.

    ``regions`` declares PER-REGION latency budgets for a WAN-shaped
    deployment: ``((name, latency_rounds), ...)`` pairs keyed off a
    topology preset's region names (``core/wan.py`` — use
    :func:`region_slo` to build one from a preset).  Each region's
    threshold is judged as its own SLO with breach windows NAMED per
    region in the verdict's ``regions`` block — against the region's
    OWN windowed latency series whenever one is available (a run with
    a declared ``region_map``: ``serve_run`` recomputes the per-region
    series post-clock from its own ingest table, and fleet serve
    lanes reduce them ON DEVICE — ``serve/fleet.py``, breach windows
    named per (lane, region)), so a slow far region can no longer
    red-flag a fast near one.  A region with no series (no region map
    declared) falls back to judging the GLOBAL series against its
    budget — the pre-fleet behavior, marked ``"series": "global"`` in
    the verdict.  The global ``latency_rounds`` stays the
    cluster-wide floor judgment; the report's ``ok`` requires the
    global AND every region to hold."""

    latency_rounds: int
    budget_milli: int = 100
    burn_breach: float = 1.0
    regions: tuple = ()

    def __post_init__(self) -> None:
        object.__setattr__(
            self, "regions",
            tuple((str(n), int(r)) for n, r in self.regions),
        )


def region_slo(
    preset,
    budgets: dict,
    *,
    latency_rounds: int,
    budget_milli: int = 100,
    burn_breach: float = 1.0,
) -> ServeSLO:
    """A :class:`ServeSLO` with per-region latency budgets keyed off
    a WAN preset's region names (``core/wan.WanPreset``): ``budgets``
    maps region name -> latency_rounds; every name must belong to the
    preset (a typo'd region would otherwise silently go unjudged)."""
    unknown = sorted(set(budgets) - set(preset.regions))
    if unknown:
        raise ValueError(
            f"unknown region(s) {', '.join(unknown)} for preset "
            f"{preset.name!r} (has: {', '.join(preset.regions)})"
        )
    return ServeSLO(
        latency_rounds=latency_rounds,
        budget_milli=budget_milli,
        burn_breach=burn_breach,
        regions=tuple(sorted(budgets.items())),
    )


def _judge_series(
    hist, wr: int, latency_rounds: int, budget_milli: int,
    burn_breach: float,
) -> dict:
    """One latency threshold judged over a ``[W, B]`` windowed
    histogram: per-window totals/bad-counts/burn rates, named breach
    windows with round spans, and the run-total verdict."""
    import bisect

    from tpu_paxos_torch.telemetry import recorder as telem

    k = bisect.bisect_right(telem.LAT_EDGES, int(latency_rounds))
    eff = telem.LAT_EDGES[k - 1] if k else 0
    tot = hist.sum(axis=1)
    bad = hist[:, k:].sum(axis=1)
    budget = max(int(budget_milli), 1) / 1000.0
    burn = [
        round(float(b) / float(t) / budget, 3) if t else 0.0
        for b, t in zip(bad, tot)
    ]
    breach = [
        w for w, bn in enumerate(burn)
        if tot[w] and bn >= burn_breach
    ]
    t_tot, b_tot = int(tot.sum()), int(bad.sum())
    frac_milli = round(1000.0 * b_tot / t_tot, 1) if t_tot else 0.0
    return {
        "latency_rounds": int(latency_rounds),
        "latency_rounds_effective": int(eff),
        "budget_milli": int(budget_milli),
        "burn_breach": float(burn_breach),
        "window_rounds": wr,
        "decided": tot.tolist(),
        "bad": bad.tolist(),
        "burn": burn,
        "burn_max": max(burn) if burn else 0.0,
        "breach_windows": breach,
        # the overflow bucket aggregates every round past the grid,
        # so its span is open-ended (null), not one window wide — a
        # closed [start, start+wr] there would misdirect an operator
        # to a 1-bucket slice of an arbitrarily long tail
        "breach_spans": [
            [w * wr, None if w == len(burn) - 1 else (w + 1) * wr]
            for w in breach
        ],
        "ok": not breach,
        # the run-total judgment the windowed one exists to correct:
        # a mid-run breach can hide under a green total
        "total_bad_milli": frac_milli,
        "total_ok": frac_milli <= float(budget_milli),
    }


def slo_windows(
    windows_dict: dict,
    slo: ServeSLO,
    region_series=None,
    region_names: tuple = (),
) -> dict:
    """Judge one run's windowed latency series against ``slo``:
    per-window totals/bad-counts/burn rates, the named breach
    windows (with their round spans), and the run-total verdict the
    windowed one is compared against.  ``windows_dict`` is the
    recorder's ``windows_to_dict`` output (the ``"windows"`` block of
    a summary dict) — this function is pure host arithmetic, so the
    monitor can run per dispatch at no device cost.

    With per-region budgets declared (``slo.regions``), each region's
    latency threshold is judged as its own SLO and named in the
    ``regions`` block (``regions_ok`` aggregates them); the top-level
    ``ok`` then requires the global verdict AND every region's.
    ``region_series`` (``[R, W, B]`` per-region windowed histograms,
    ``telemetry/recorder.region_window_hist``) with ``region_names``
    (index order) routes each named region to its OWN series —
    ``"series": "region"`` in its verdict; regions without one fall
    back to the global series (``"series": "global"``), the
    pre-fleet behavior."""
    hist = np.asarray(windows_dict["lat_hist"], np.int64)  # [W, B]
    wr = int(windows_dict["window_rounds"])
    out = _judge_series(
        hist, wr, slo.latency_rounds, slo.budget_milli, slo.burn_breach
    )
    if slo.regions:
        names = tuple(region_names)
        region_verdicts = {}
        for name, lat in slo.regions:
            if region_series is not None and name in names:
                series = np.asarray(
                    region_series, np.int64
                )[names.index(name)]
                which = "region"
            else:
                series, which = hist, "global"
            v = _judge_series(
                series, wr, lat, slo.budget_milli, slo.burn_breach
            )
            v["series"] = which
            region_verdicts[name] = v
        regions_ok = all(v["ok"] for v in region_verdicts.values())
        out["regions"] = {
            name: {
                k: v[k] for k in (
                    "latency_rounds", "latency_rounds_effective",
                    "burn", "burn_max", "breach_windows",
                    "breach_spans", "ok", "total_bad_milli", "total_ok",
                    "series",
                )
            }
            for name, v in region_verdicts.items()
        }
        out["regions_ok"] = regions_ok
        out["ok"] = bool(out["ok"] and regions_ok)
    return out


@dataclasses.dataclass
class ServeReport:
    """One open-loop run's outcome.  ``chosen_vid``/``chosen_ballot``
    transfer AFTER the clock stops (they exist for decision-log
    parity checks, not for the serving loop)."""

    cfg: SimConfig
    n_values: int
    rounds_per_window: int
    windows_per_dispatch: int
    admit_width: int
    pipelined: bool
    dispatches: int
    windows_count: int  # admission windows run (dispatches * S)
    rounds: int
    done: bool
    decided_values: int  # real stamped values decided (hist mass)
    backlog: int  # admitted values not yet decided at stop
    p50: int
    p99: int
    p999: int
    latency_max: int
    wall_seconds: float
    summary: dict  # final cumulative flight-recorder summary dict
    window_decided: list  # per-dispatch cumulative decided counts
    chosen_vid: np.ndarray
    chosen_ballot: np.ndarray
    #: windowed-plane bucket width in rounds (0 = plane disarmed)
    window_rounds: int = 0
    #: the final windowed series (recorder.windows_to_dict) — the
    #: per-bucket p50/p99/drop/stall stream; None when disarmed
    windows: dict | None = None
    #: SLO verdict (slo_windows) — None unless an SLO was declared
    slo: dict | None = None
    #: per-region windowed latency histograms ``[R, W, B]`` (the
    #: host-recomputed twin of the fleet lanes' on-device series,
    #: recorder.region_window_hist_host) — None unless a region map
    #: was declared; regions named by ``region_names``
    region_windows: np.ndarray | None = None
    region_names: tuple = ()
    #: first dispatch (1-based) whose harvested windowed series
    #: already named a breach window — the burn-rate monitor's
    #: per-dispatch output; None = never breached (or no SLO)
    slo_first_breach_dispatch: int | None = None
    #: the final device ServeLoopState (``keep_state=True`` only —
    #: offline export reads the per-instance phase ledger out of it)
    final_state: object | None = None

    @property
    def values_per_sec(self) -> float:
        return self.decided_values / max(self.wall_seconds, 1e-9)


def _read(out, slo, ww: int) -> np.ndarray:
    """One dispatch's host read, in one copy: ``[done, t, decided]``
    and, with an SLO declared, the windowed latency histogram the
    burn-rate monitor judges."""
    import torch

    counters.add("host_reads")
    parts = [out[1].reshape(1), out[2].reshape(1), out[3].decided.reshape(1)]
    if slo is not None and ww:
        parts.append(out[4].lat_hist.reshape(-1))
    return torch.cat([x.to(torch.int32) for x in parts]).cpu().numpy()


def serve_run(
    cfg: SimConfig,
    workload,
    arrival_rounds,
    *,
    rounds_per_window: int = ROUNDS_PER_WINDOW,
    windows_per_dispatch: int = WINDOWS_PER_DISPATCH,
    admit_width: int | None = None,
    pipelined: bool = True,
    window_rounds: int | None = None,
    slo: ServeSLO | None = None,
    region_map=None,
    region_names: tuple = (),
    keep_state: bool = False,
    device="cuda",
) -> ServeReport:
    """Serve one value stream open-loop to completion (or the round
    budget) on ``device``.  ``workload[p]`` is proposer ``p``'s vid
    sequence in queue order; ``arrival_rounds[p]`` its per-value arrival
    rounds (nondecreasing: the queue is FIFO per proposer).  All values
    arriving at round 0 is the zero-load parity shape: the run is
    decision-log-identical to closed-loop ``sim.run(cfg, workload)``.

    ``region_map`` (``[A]`` int32 node->region, e.g. a WAN preset's
    ``wan.node_regions``) with ``region_names`` adds PER-REGION windowed
    latency series to the report, recomputed after the clock stops on
    the host from the harness's own ingest table, and routes each
    declared region SLO to its own series.

    ``admit_width`` pins the upload block's width and
    ``windows_per_dispatch`` the amortization depth; admission timing,
    hence the latency distribution, is identical for every ``S``.

    ``window_rounds`` sets the windowed plane's bucket width (default
    ``WINDOWS_PER_BUCKET * rounds_per_window``; 0 disarms it).  The
    bucket width is not part of the trajectory: decisions and the
    cumulative histogram are identical for every setting.  With an
    ``slo``, the windowed burn-rate monitor runs per dispatch on the
    harvested series and the report names every breach window."""
    from tpu_paxos_torch.core import sim as simm
    from tpu_paxos_torch.core import values as val
    from tpu_paxos_torch.serve import driver as drv
    from tpu_paxos_torch.telemetry import recorder as telem
    from tpu_paxos_torch.utils import device as devm
    from tpu_paxos_torch.utils import prng

    workload = [np.asarray(w, np.int32).reshape(-1) for w in workload]
    if len(workload) != len(cfg.proposers):
        raise ValueError("one value stream per proposer required")
    plan = arrv.ArrivalPlan(workload, arrival_rounds, rounds_per_window)
    k = int(admit_width or plan.max_block)
    if plan.max_block > k:
        raise ValueError(
            f"admit_width {k} below this plan's max block "
            f"{plan.max_block}"
        )
    s = int(windows_per_dispatch)
    if s < 1:
        raise ValueError("windows_per_dispatch must be >= 1")
    if window_rounds is None:
        window_rounds = WINDOWS_PER_BUCKET * rounds_per_window
    ww = int(window_rounds)
    if slo is not None and not ww:
        raise ValueError(
            "the SLO monitor reads the windowed series; "
            "window_rounds=0 disarms it"
        )
    dev = devm.resolve(device)
    v_bound = drv.vid_bound_of(workload)
    root = prng.root_key(cfg.seed)
    ss, c = drv.init_serve_state(
        cfg, workload, v_bound, root, window_rounds=ww, device=dev
    )
    fn = drv.window_for(cfg, c, v_bound, rounds_per_window, window_rounds=ww, device=dev)
    p = len(cfg.proposers)
    empty = drv.upload_blocks(
        np.full((s, p, k), int(val.NONE), np.int32), np.zeros((s, p, k), np.int32), dev
    )
    n_disp_admit = (plan.n_windows + s - 1) // s
    # Watchdog: the budget the closed-loop driver grants, in dispatches.
    disp_cap = max(
        cfg.round_budget // (rounds_per_window * s) + 1, n_disp_admit
    )

    def super_block(d):
        """Stack dispatch ``d``'s S admission windows; windows past the
        plan are empty rows (the plan pads them itself)."""
        a = np.stack([plan.block(d * s + i, k)[0] for i in range(s)])
        r = np.stack([plan.block(d * s + i, k)[1] for i in range(s)])
        return a, r

    first_breach: list = []  # [dispatch] set once by the monitor

    def harvest(host):
        # the dispatch's stop scalars and, with an SLO declared, the
        # windowed burn-rate monitor on the [W, B] series it read
        if slo is not None and not first_breach:
            judged = slo_windows(
                {"window_rounds": ww,
                 "lat_hist": host[3:].reshape(telem.NUM_WINDOWS, telem.NUM_LAT_BUCKETS)},
                slo,
            )
            if judged["breach_windows"]:
                first_breach.append(harvested + 1)
        return bool(host[0]), int(host[1]), int(host[2])

    window_decided: list[int] = []
    pending = None
    last_done, last_t = False, 0
    last_out = None
    d = harvested = 0
    # paxlint: allow[DET001] wall metric only; never reaches artifacts
    t0 = time.perf_counter()
    while True:
        blk = super_block(d) if d < n_disp_admit else empty
        out = fn(ss, root, *blk)
        ss = out[0]
        host = _read(out, slo, ww)
        d += 1
        if pipelined:
            # JAX's double buffer: harvest the PREVIOUS dispatch
            if pending is not None:
                last_done, last_t, decided = harvest(pending[0])
                last_out = pending[1]
                window_decided.append(decided)
                harvested += 1
            pending = (host, out)
        else:
            last_done, last_t, decided = harvest(host)
            last_out = out
            window_decided.append(decided)
            harvested += 1
        # stop only on a quiescence signal from a dispatch that saw
        # EVERY admission: a mid-stream lull must not end the run
        if harvested >= n_disp_admit and last_done:
            break
        if d >= disp_cap:
            break
    if pending is not None:
        last_done, last_t, decided = harvest(pending[0])
        last_out = pending[1]
        window_decided.append(decided)
        harvested += 1
    # paxlint: allow[DET001] wall metric only; never reaches artifacts
    wall = time.perf_counter() - t0

    # Post-clock rendering: the final cumulative summary and decision
    # arrays move to the host after the serving loop stopped timing.
    trees = [simm.lanes_view(last_out[3])]
    if ww:
        trees.append(simm.lanes_view(last_out[4]))
    host_trees = [telem.lane(x, 0) for x in devm.to_host(*trees)]
    host_summ = host_trees[0]
    host_wsum = host_trees[1] if ww else None
    sd = telem.summary_to_dict(
        host_summ, host_wsum, ww, region_names=tuple(region_names)
    )
    hist = np.asarray(host_summ.lat_hist)
    lat_max = int(host_summ.lat_max)
    decided_values = int(hist.sum())
    windows_dict = sd.get("windows")
    met = ss.sim.met
    chosen_vid = met.chosen_vid.cpu().numpy()
    chosen_ballot = met.chosen_ballot.cpu().numpy()
    region_hists = None
    if region_map is not None and ww:
        # the host twin of the fleet lanes' on-device series: the ingest
        # table is the harness's own data (every value's true arrival
        # round), the decision arrays move after the clock stopped
        rmap = np.asarray(region_map, np.int32).reshape(cfg.n_nodes)
        ingest_host = np.full((v_bound,), int(val.NONE), np.int32)
        vid_region = np.zeros((v_bound,), np.int32)
        for node, s_p, a_p in zip(cfg.proposers, plan.streams, plan.arrs):
            ingest_host[s_p] = a_p
            vid_region[s_p] = rmap[node]
        region_hists = telem.region_window_hist_host(
            ingest_host, chosen_vid, met.chosen_round.cpu().numpy(), vid_region, ww,
        )
    slo_dict = (
        slo_windows(windows_dict, slo, region_series=region_hists,
                    region_names=region_names)
        if slo is not None and windows_dict is not None else None
    )
    if slo_dict is not None:
        # breach attribution (telemetry/diagnose.py): label every named
        # breach window with its ranked causes
        from tpu_paxos_torch.telemetry import diagnose as diag

        diag.attach_diagnosis(
            slo_dict, windows_dict,
            region_map=region_map, region_names=tuple(region_names),
            region_pairs=sd.get("region_pairs"),
            region_series=region_hists,
        )
    return ServeReport(
        cfg=cfg,
        n_values=plan.n_values,
        rounds_per_window=rounds_per_window,
        windows_per_dispatch=s,
        admit_width=k,
        pipelined=pipelined,
        dispatches=d,
        windows_count=d * s,
        rounds=last_t,
        done=last_done,
        decided_values=decided_values,
        backlog=plan.n_values - decided_values,
        p50=sd["latency_p50"],
        p99=sd["latency_p99"],
        p999=telem.latency_quantile(hist, 0.999, lat_max),
        latency_max=lat_max,
        wall_seconds=wall,
        summary=sd,
        window_decided=window_decided,
        chosen_vid=chosen_vid,
        chosen_ballot=chosen_ballot,
        window_rounds=ww,
        windows=windows_dict,
        slo=slo_dict,
        slo_first_breach_dispatch=(
            first_breach[0] if first_breach else None
        ),
        region_windows=region_hists,
        region_names=tuple(region_names),
        final_state=ss if keep_state else None,
    )


def _steady_p50(rep: ServeReport) -> int | None:
    """Steady-state median from the windowed series: the MEDIAN of
    the per-bucket p50s over the buckets that decided anything
    (later-middle on even counts, leaning toward the loaded end).
    The run-total p50 averages the unloaded warm-up in, so a run
    that saturates mid-sweep can average back under the doubling
    line; a single bucket would be hostage to the straggler drain
    tail (small-n, retry-biased slow) or a one-off duel cluster —
    the typical-window median sees sustained queueing and nothing
    else.  None when the plane is disarmed."""
    if rep.windows is None:
        return None
    # filter on the quantile itself, not the decided count: decided
    # includes no-op fills (which carry no latency), so a fill-only
    # bucket reports -1 — a sentinel, not a latency of -1
    p50s = [int(p) for p in rep.windows["latency_p50"] if int(p) >= 0]
    if not p50s:
        return None
    return sorted(p50s)[len(p50s) // 2]


def _point(rate_milli: int, rep: ServeReport) -> dict:
    steady = _steady_p50(rep)
    return {
        "rate_milli": int(rate_milli),
        "p50": rep.p50,
        "p99": rep.p99,
        "p999": rep.p999,
        "latency_max": rep.latency_max,
        "decided": rep.decided_values,
        "backlog": rep.backlog,
        "done": rep.done,
        "rounds": rep.rounds,
        "dispatches": rep.dispatches,
        "windows": rep.windows_count,
        "wall_seconds": round(rep.wall_seconds, 4),
        "values_per_sec": round(rep.values_per_sec, 1),
        "sustained": bool(rep.done and rep.backlog == 0),
        **({
            "p50_steady": steady,
            "p50_windows": rep.windows["latency_p50"],
            "p99_windows": rep.windows["latency_p99"],
            "window_rounds": rep.window_rounds,
        } if steady is not None else {}),
        **({"slo": rep.slo} if rep.slo is not None else {}),
    }


def judge_knee(points: list, factor: float = 2.0) -> dict:
    """Bracket the saturation knee from a latency-at-load sweep
    (points sorted by rate).  A point SATURATES when the run failed
    to drain inside the round budget, or its MEDIAN commit latency
    blew past ``factor`` times the lowest-rate median — the classic
    latency-doubling knee.  The judgment deliberately reads p50, not
    p99: the tail carries the fault-retry ladder (a dropped accept's
    ~100-round restart shows up at p99 even at near-zero load), while
    queueing delay past the engine's service rate moves EVERY value —
    the median is the saturation signal.

    Points carrying the windowed series are judged on ``p50_steady``
    (the last active bucket's median) instead of the run-total p50:
    the total smears the unloaded warm-up over the whole run, so a
    run that saturates mid-sweep can average back under the doubling
    line — the steady-state median is where queueing actually shows.
    Returns the bracketing rates (None where the sweep never
    crossed)."""
    if not points:
        return {"last_sustained_milli": None, "first_saturated_milli": None}

    def med(pt):
        return pt.get("p50_steady") or pt["p50"]

    windowed = any("p50_steady" in pt for pt in points)
    base = max(med(points[0]), 1)
    last_ok, first_bad = None, None
    for pt in points:
        # >=: p50 is latency-bucket-quantized, so the doubling point
        # lands exactly ON factor * base
        bad = (not pt["sustained"]) or med(pt) >= factor * base
        if bad and first_bad is None:
            first_bad = pt["rate_milli"]
        if not bad and first_bad is None:
            last_ok = pt["rate_milli"]
    return {
        "last_sustained_milli": last_ok,
        "first_saturated_milli": first_bad,
        "p50_factor": factor,
        "p50_base": base,
        "p50_metric": "p50_steady" if windowed else "p50",
    }


def sweep_load(
    cfg: SimConfig,
    n_values: int,
    rates_milli,
    *,
    seed: int = 0,
    rounds_per_window: int = ROUNDS_PER_WINDOW,
    windows_per_dispatch: int = WINDOWS_PER_DISPATCH,
    pipelined: bool = True,
    knee_factor: float = 2.0,
    admit_width: int | None = None,
    window_rounds: int | None = None,
    slo: ServeSLO | None = None,
    device="cuda",
) -> dict:
    """Latency at load: one open-loop Poisson run per offered rate
    (values per 1000 rounds), all sharing ONE cached window (the admit
    width is the max over every rate's plan; ``admit_width`` raises
    it), plus the knee judgment over the resulting points (the
    windowed steady-state median when the plane is armed — the
    default).  With an ``slo``, every point carries its burn-rate
    verdict and the summary names each rate's breach windows."""
    vids = np.arange(int(n_values), dtype=np.int32)
    n_prop = len(cfg.proposers)
    plans = {}
    for rm in rates_milli:
        rounds = arrv.poisson_rounds(n_values, int(rm), seed)
        plans[int(rm)] = arrv.split_round_robin(vids, rounds, n_prop)
    width = int(admit_width or 1)
    for rm, (streams, arrs) in plans.items():
        width = max(
            width,
            arrv.ArrivalPlan(streams, arrs, rounds_per_window).max_block,
        )
    points = []
    for rm in sorted(plans):
        streams, arrs = plans[rm]
        rep = serve_run(
            cfg, streams, arrs,
            rounds_per_window=rounds_per_window,
            windows_per_dispatch=windows_per_dispatch,
            admit_width=width,
            pipelined=pipelined,
            window_rounds=window_rounds,
            slo=slo,
            device=device,
        )
        points.append(_point(rm, rep))
    out = {
        "metric": "serve_latency_at_load",
        "n_values": int(n_values),
        "rounds_per_window": int(rounds_per_window),
        "windows_per_dispatch": int(windows_per_dispatch),
        "admit_width": int(width),
        "points": points,
        "knee": judge_knee(points, knee_factor),
    }
    if slo is not None:
        out["slo"] = {
            "latency_rounds": int(slo.latency_rounds),
            "budget_milli": int(slo.budget_milli),
            "burn_breach": float(slo.burn_breach),
            # every rate's named breach windows — the mid-run
            # story the per-point run-total columns cannot tell
            "breach_windows": {
                str(pt["rate_milli"]): pt["slo"]["breach_windows"]
                for pt in points if "slo" in pt
            },
            # breach attribution per rate: the diagnosis plane's
            # named causes (telemetry/diagnose.py) — why each rate's
            # windows breached, not just that they did
            "breach_causes": {
                str(pt["rate_milli"]):
                    pt["slo"].get("diagnosis", {}).get("causes", [])
                for pt in points if "slo" in pt
            },
            "ok": all(
                pt["slo"]["ok"] for pt in points if "slo" in pt
            ),
        }
    return out


def _serve_cfg(args) -> SimConfig:
    n_inst = args.instances or max(64, 2 * args.values)
    return SimConfig(
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
        **({"assign_window": args.assign_window}
           if getattr(args, "assign_window", 0) else {}),
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_paxos_torch serve",
        description="open-loop serving harness: Poisson / trace-replay "
        "arrivals admitted mid-flight through dispatch windows; commit "
        "latency (p50/p99/p999) at a sustained offered load, measured "
        "on the device",
    )
    ap.add_argument("--nodes", type=int, default=5)
    ap.add_argument("--proposers", type=int, default=2)
    ap.add_argument("--values", type=int, default=256,
                    help="values in the arriving stream")
    ap.add_argument("--rate-milli", type=int, default=2000,
                    help="offered load: values per 1000 rounds "
                    "(0 = offered-load-∞, everything arrives at "
                    "round 0)")
    ap.add_argument("--sweep", type=str, default="",
                    help="comma-separated rate_milli list: run the "
                    "latency-at-load sweep + knee judgment instead "
                    "of a single rate")
    ap.add_argument("--trace", type=str, default="",
                    help="JSON file with an explicit arrival-round "
                    "list (trace replay; overrides --rate-milli)")
    ap.add_argument("--arrivals", type=str, default="poisson",
                    choices=sorted(arrv.ARRIVAL_BUILDERS),
                    help="arrival process at --rate-milli "
                    "(serve/arrivals.py; deterministic per seed)")
    ap.add_argument("--rounds-per-window", type=int,
                    default=ROUNDS_PER_WINDOW)
    ap.add_argument("--windows-per-dispatch", type=int,
                    default=WINDOWS_PER_DISPATCH,
                    help="admission windows batched per dispatch")
    ap.add_argument("--sequential", action="store_true",
                    help="the sequential-dispatch baseline: one window "
                    "per dispatch, each harvested before the next")
    ap.add_argument("--window-rounds", type=int, default=-1,
                    help="windowed time-series bucket width in rounds "
                    "(-1 = 4 admission windows; 0 disarms the plane)")
    ap.add_argument("--slo-latency", type=int, default=0,
                    help="declare a latency SLO: commit latency (in "
                    "rounds, quantized to the histogram edges) every "
                    "value should meet; arms the windowed burn-rate "
                    "monitor (0 = no SLO)")
    ap.add_argument("--slo-budget-milli", type=int, default=100,
                    help="SLO error budget: allowed slow-value "
                    "fraction per 1000 decided (with --slo-latency)")
    ap.add_argument("--control", action="store_true",
                    help="arm the adaptive admission controller "
                    "(serve/control.py): between dispatches, read the "
                    "previous dispatch's burn + ranked causes and "
                    "shed/defer declared priority tiers (requires "
                    "--slo-latency)")
    ap.add_argument("--control-ab", action="store_true",
                    help="the spike A/B judgment: one load spike "
                    "served controller-off and controller-on at the "
                    "same offered trajectory, compared on the "
                    "breach-window list (requires --slo-latency)")
    ap.add_argument("--spike-factor", type=int, default=4,
                    help="--control-ab spike: arrival-rate multiplier "
                    "over the mid-run spike span")
    ap.add_argument("--spike-start-frac", type=float, default=0.375,
                    help="--control-ab spike: where the spike starts, "
                    "as a fraction of the value stream")
    ap.add_argument("--spike-len-frac", type=float, default=0.25,
                    help="--control-ab spike: spike span as a "
                    "fraction of the value stream")
    ap.add_argument("--assign-window", type=int, default=0,
                    help="cap concurrent assignment (SimConfig."
                    "assign_window; 0 = engine default).  The spike "
                    "A/B needs a bounded admission capacity for a "
                    "spike to build a real queue")
    ap.add_argument("--priority-tiers", type=int, default=3,
                    help="declared per-value priority tiers (tier 0 "
                    "= always admit)")
    ap.add_argument("--defer-tier", type=int, default=0,
                    help="lowest tier the controller DEFERS under "
                    "degradation (0 = policy default: shed-only, no "
                    "defer band)")
    ap.add_argument("--shed-tier", type=int, default=0,
                    help="lowest tier the controller SHEDS under "
                    "degradation (0 = policy default: top tier)")
    ap.add_argument("--save-artifact", type=str, default="",
                    help="write the controlled run's repro artifact "
                    "(policy + decision trail; replay with `python "
                    "-m tpu_paxos_torch repro`)")
    ap.add_argument("--instances", type=int, default=0,
                    help="instance-space size (0 = 2x values)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arrival-seed", type=int, default=-1,
                    help="arrival-process seed, decoupled from the "
                    "engine --seed (-1 = same as --seed)")
    ap.add_argument("--max-rounds", type=int, default=20_000)
    ap.add_argument("--drop-rate", type=int, default=0)
    ap.add_argument("--dup-rate", type=int, default=0)
    ap.add_argument("--max-delay", type=int, default=0)
    ap.add_argument("--crash-rate", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--json", action="store_true",
                    help="emit the full JSON summary (default prints "
                    "a one-line digest)")
    args = ap.parse_args(argv)
    cfg = _serve_cfg(args)
    pipelined = not args.sequential
    s_disp = 1 if args.sequential else args.windows_per_dispatch
    w_rounds = None if args.window_rounds < 0 else args.window_rounds
    slo = (
        ServeSLO(latency_rounds=args.slo_latency,
                 budget_milli=args.slo_budget_milli)
        if args.slo_latency else None
    )
    policy = None
    if args.control or args.control_ab:
        from tpu_paxos_torch.serve import control as ctlm

        if slo is None:
            raise SystemExit(
                "--control/--control-ab read SLO verdicts; declare "
                "--slo-latency"
            )
        n_tiers = args.priority_tiers
        shed_tier = args.shed_tier or n_tiers - 1 or 1
        policy = ctlm.ControlPolicy(
            n_tiers=n_tiers,
            defer_tier=args.defer_tier or shed_tier,
            shed_tier=shed_tier,
        )
    a_seed = args.seed if args.arrival_seed < 0 else args.arrival_seed
    if args.control_ab:
        summary = ctlm.spike_ab(
            cfg, args.values, args.rate_milli or 2000,
            slo=slo, seed=a_seed, policy=policy,
            rounds_per_window=args.rounds_per_window,
            windows_per_dispatch=s_disp,
            spike_factor=args.spike_factor,
            spike_start_frac=args.spike_start_frac,
            spike_len_frac=args.spike_len_frac,
            window_rounds=w_rounds,
            artifact_path=args.save_artifact or None,
            device=args.device,
        )
    elif args.sweep:
        rates = [int(x) for x in args.sweep.split(",") if x.strip()]
        summary = sweep_load(
            cfg, args.values, rates, seed=a_seed,
            rounds_per_window=args.rounds_per_window,
            windows_per_dispatch=s_disp,
            pipelined=pipelined,
            window_rounds=w_rounds,
            slo=slo,
            device=args.device,
        )
        summary["ok"] = bool(
            summary["points"] and summary["points"][0]["sustained"]
            and summary.get("slo", {}).get("ok", True)
        )
    else:
        vids = np.arange(args.values, dtype=np.int32)
        if args.trace:
            with open(args.trace) as f:
                rounds = arrv.trace_rounds(json.load(f))
            if len(rounds) != args.values:
                raise SystemExit(
                    f"trace has {len(rounds)} arrivals for "
                    f"--values {args.values}"
                )
        elif args.rate_milli <= 0:
            rounds = arrv.immediate_rounds(args.values)
        else:
            rounds = arrv.ARRIVAL_BUILDERS[args.arrivals](
                args.values, args.rate_milli, a_seed
            )
        streams, arrs = arrv.split_round_robin(
            vids, rounds, args.proposers
        )
        if args.control:
            rep = ctlm.controlled_serve_run(
                cfg, streams, arrs,
                control=policy,
                rounds_per_window=args.rounds_per_window,
                windows_per_dispatch=s_disp,
                window_rounds=w_rounds,
                slo=slo,
                device=args.device,
            )
            if args.save_artifact:
                ctlm.save_artifact(args.save_artifact, rep)
        else:
            rep = serve_run(
                cfg, streams, arrs,
                rounds_per_window=args.rounds_per_window,
                windows_per_dispatch=s_disp,
                pipelined=pipelined,
                window_rounds=w_rounds,
                slo=slo,
                device=args.device,
            )
        point = (
            ctlm._ab_point(rep) if args.control
            else _point(args.rate_milli, rep)
        )
        summary = {
            "metric": "serve",
            "mode": (
                "controlled" if args.control
                else "pipelined" if pipelined else "sequential"
            ),
            "rate_milli": args.rate_milli,
            **point,
            "latency_hist": rep.summary["latency_hist"],
            "ok": bool(
                rep.done and rep.backlog == 0
                and (rep.slo is None or rep.slo["ok"])
            ),
        }
        if rep.slo_first_breach_dispatch is not None:
            summary["slo_first_breach_dispatch"] = (
                rep.slo_first_breach_dispatch
            )
    print(json.dumps(summary, sort_keys=True))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
