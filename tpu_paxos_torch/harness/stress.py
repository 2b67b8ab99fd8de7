"""Randomized stress sweep (port of ``tpu_paxos/harness/stress.py``):
many seeds x fault mixes through the general engine, every run judged by
the full crash-aware invariant suite.

Each sweep samples seeds against a grid of fault mixes (crashes, in-order
gate chains, and correlated-fault episode schedules: partition flaps,
one-way cuts, node pauses, loss bursts) and asserts agreement,
exactly-once, executed-identical, in-order clients and quiescence on
every run.  The same (mix, seed) gives the same run as the JAX sweep.

Failure triage: with ``--triage-dir`` (or ``triage_dir=``), a failing
seed is handed to ``harness/shrink.py``: its fault schedule is greedily
shrunk to a minimal still-failing case and written as a JSON repro
artifact that ``python -m tpu_paxos_torch repro <artifact>`` re-executes
byte for byte.

The host loop builds the round function once per mix (a seed changes
only the PRNG root) and drives each seed as one lane of it
(``core/sim.run_lanes``).  The fleet sweep (``sweep_fleet``) runs each
episode mix's seeds as the lanes of one dispatch of the armed envelope
runner; the sharded sweep waits for the sharded engine.

CLI: ``python -m tpu_paxos_torch.harness.stress [--seeds N]
[--base-seed S] [--triage-dir D] [--fleet] [--device {cuda,cpu}]``
prints one JSON summary line (with ``--fleet`` two: the host-loop sweep
over the i.i.d.-only mixes, then the fleet sweep over the episode and
WAN mixes) and exits non-zero on any violation; ``--sharded`` exits 2
(not ported yet).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import zlib

import numpy as np

from tpu_paxos_torch.config import FaultConfig, SimConfig
from tpu_paxos_torch.core import faults as flt
from tpu_paxos_torch.core import sim as simm
from tpu_paxos_torch.core import values as val
from tpu_paxos_torch.core import wan as wanm
from tpu_paxos_torch.harness import shrink as shr
from tpu_paxos_torch.harness import validate
from tpu_paxos_torch.utils import log as logm
from tpu_paxos_torch.utils import prng

# Correlated-fault schedules for the episode mixes (5-node clusters).
SCHED_PARTITION_FLAP = flt.FaultSchedule((
    flt.partition(6, 26, (0, 1), (2, 3, 4)),
    flt.partition(40, 62, (0, 2, 4), (1, 3)),
    flt.partition(76, 96, (1, 4), (0, 2, 3)),
))
SCHED_ONE_WAY = flt.FaultSchedule((
    flt.one_way(5, 30, (0,), (2, 3)),
    flt.one_way(22, 48, (3, 4), (0,)),
    flt.one_way(60, 80, (1,), (2, 3, 4)),
))
SCHED_PAUSE_HEAVY = flt.FaultSchedule((
    flt.pause(4, 26, 1),
    flt.pause(18, 44, 3),
    flt.pause(34, 58, 4),
    flt.burst(10, 30, 2500),
))
SCHED_PAUSE_CRASH = flt.FaultSchedule((
    flt.pause(6, 30, 1),
    flt.pause(36, 60, 2),
))

# Fault mixes: (label, FaultConfig kwargs, n_nodes, n_proposers).
MIXES = [
    ("clean", dict(), 3, 1),
    ("debug.conf", dict(drop_rate=500, dup_rate=1000, max_delay=2), 5, 2),
    ("lossy", dict(drop_rate=2000, dup_rate=500, max_delay=4), 5, 2),
    ("duel-heavy", dict(drop_rate=1000, dup_rate=2000, max_delay=3), 5, 3),
    (
        "crashy",
        dict(drop_rate=500, dup_rate=1000, max_delay=2, crash_rate=4000),
        5,
        2,
    ),
    (
        "delay-heavy",
        dict(drop_rate=200, dup_rate=200, min_delay=1, max_delay=6),
        7,
        2,
    ),
    (
        "partition-flap",
        dict(drop_rate=300, dup_rate=500, max_delay=2, schedule=SCHED_PARTITION_FLAP),
        5,
        2,
    ),
    (
        "one-way",
        dict(drop_rate=300, dup_rate=500, max_delay=2, schedule=SCHED_ONE_WAY),
        5,
        2,
    ),
    (
        "pause-heavy",
        dict(drop_rate=200, dup_rate=500, max_delay=2, schedule=SCHED_PAUSE_HEAVY),
        5,
        2,
    ),
    (
        "pause-crash",
        dict(
            drop_rate=500, dup_rate=1000, max_delay=2, crash_rate=3000,
            schedule=SCHED_PAUSE_CRASH,
        ),
        5,
        2,
    ),
]
EPISODE_MIXES = [m for m in MIXES if "schedule" in m[1]]

SCHED_WAN_GRAY = flt.FaultSchedule((
    flt.gray(8, 40, 2, delay=3),
    flt.one_way(20, 48, (2,), (0, 1)),
))
SCHED_WAN5_GRAY = flt.FaultSchedule((
    flt.gray(6, 36, 3, 4, delay=2),
    flt.partition(24, 44, (0, 1, 2), (3, 4)),
))
WAN_MIXES = [
    (
        "wan-3region",
        dict(
            max_delay=wanm.PRESET_DELAY_BOUND,
            edges=wanm.edge_faults(wanm.WAN3, 5),
            schedule=SCHED_WAN_GRAY,
        ),
        5,
        2,
    ),
    (
        "wan-5region",
        dict(
            max_delay=wanm.PRESET_DELAY_BOUND,
            edges=wanm.edge_faults(wanm.WAN5, 5),
            schedule=SCHED_WAN5_GRAY,
        ),
        5,
        2,
    ),
]

#: node->region maps per WAN mix label (the recorder's region-pair
#: counters; sweep_fleet passes them through run(regions=))
WAN_REGIONS = {
    "wan-3region": wanm.node_regions(wanm.WAN3, 5),
    "wan-5region": wanm.node_regions(wanm.WAN5, 5),
}
#: preset region names per WAN mix label: the recorder's
#: ``region_pairs`` blocks render pairs by name (``us->ap``)
WAN_NAMES = {
    "wan-3region": wanm.WAN3.regions,
    "wan-5region": wanm.WAN5.regions,
}

N_IDS = 6  # ids per client chain (gated, in-order)
N_FREE = 8  # ungated values per proposer


def _workload(
    n_prop: int,
    rng: np.random.Generator,
    n_ids: int = N_IDS,
    n_free: int = N_FREE,
):
    """Per-proposer workload: one in-order gate chain + free values,
    with globally unique vids.  Returns (workload, gates, chains)."""
    workload, gates, chains = [], [], []
    nxt = 100
    for _ in range(n_prop):
        chain = np.arange(nxt, nxt + n_ids, dtype=np.int32)
        nxt += n_ids
        free = np.arange(nxt, nxt + n_free, dtype=np.int32)
        nxt += n_free
        rng.shuffle(free)
        w = np.concatenate([chain, free])
        g = np.concatenate(
            [
                np.asarray([int(val.NONE)] + chain[:-1].tolist(), np.int32),
                np.full(n_free, int(val.NONE), np.int32),
            ]
        )
        workload.append(w)
        gates.append(g)
        chains.append(chain)
    return workload, gates, chains


# Crash-aware invariant suite, shared with the shrinker so a shrunk
# repro artifact is judged by exactly the sweep's rules.  Kept as a
# module-level name: tests monkeypatch it to inject failures.
_validate_run = shr.validate_run


def _check_run(r, cfg: SimConfig, workload, chains) -> None:
    """Quiescence (excused only when every proposer crashed) + the
    crash-aware suite; mirrors shrink.check_run through the patchable
    ``_validate_run`` seam."""
    all_props_crashed = all(r.crashed[node] for node in cfg.proposers)
    if not r.done and not all_props_crashed:
        raise validate.InvariantViolation(
            f"no quiescence in {r.rounds} rounds"
        )
    _validate_run(r, cfg, workload, chains)


def sweep(
    n_seeds: int = 8,
    base_seed: int = 0,
    verbose: bool = True,
    triage_dir: str | None = None,
    mixes=None,
    device="cuda",
) -> dict:
    """Every (mix, seed) of the grid on ``device``; returns the JSON
    summary (``failures`` lists each failing seed, with its artifact
    when ``triage_dir`` is set)."""
    logger = logm.get_logger(
        "stress", logm.parse_level("INFO" if verbose else "WARN")
    )
    runs, failures = 0, []
    t0 = time.perf_counter()
    for label, fkw, n_nodes, n_prop in (MIXES if mixes is None else mixes):
        round_fn = None  # built once per mix; seeds share shapes
        for s in range(n_seeds):
            seed = base_seed + s
            rng = np.random.default_rng(
                seed * 7919 + zlib.crc32(label.encode()) % 1000
            )
            workload, gates, chains = _workload(n_prop, rng)
            cfg = SimConfig(
                n_nodes=n_nodes,
                n_instances=2 * sum(len(w) for w in workload),
                proposers=tuple(range(n_prop)),
                seed=seed,
                max_rounds=20_000,
                faults=FaultConfig(**fkw),
            )
            pend, gate, tail, c = simm.prepare_queues(cfg, workload, gates)
            if round_fn is None:
                round_fn = simm.build_engine(
                    cfg, c, vid_cap=simm.gates_vid_cap(workload, gates),
                    device=device,
                )
            root = prng.root_key(cfg.seed)
            state = simm.init_state(cfg, pend, gate, tail, root, device=device)
            final, _ = simm.run_lanes(
                round_fn, np.asarray([root], np.uint64), simm.lanes_view(state),
                [cfg.round_budget],
            )
            r = simm.to_result(
                simm.lane_of(final, 0), np.unique(np.concatenate(workload))
            )
            runs += 1
            try:
                _check_run(r, cfg, workload, chains)
            except validate.InvariantViolation as e:
                failure = {"mix": label, "seed": seed, "error": str(e)[:300]}
                logger.error("FAIL mix=%s seed=%d: %s", label, seed, e)
                if triage_dir:
                    # shrink the failing case to a minimal schedule and
                    # pin it as a one-command repro artifact
                    os.makedirs(triage_dir, exist_ok=True)
                    path = os.path.join(
                        triage_dir, f"repro_{label}_{seed}.json"
                    )
                    try:
                        case = shr.ReproCase(
                            cfg=cfg, workload=workload, gates=gates,
                            chains=chains,
                        )
                        art = shr.triage(
                            case, path, logger=logger, device=device
                        )
                        failure["artifact"] = path
                        failure["shrink_seconds"] = art.get("shrink_seconds")
                        logger.error("repro artifact written to %s", path)
                    except Exception as te:  # triage must never mask a failure
                        failure["triage_error"] = str(te)[:300]
                failures.append(failure)
        logger.info(
            "mix %-14s: %d seeds done (cumulative %d runs, %d failures)",
            label, n_seeds, runs, len(failures),
        )
    n_mixes = len(MIXES if mixes is None else mixes)
    return {
        "metric": "stress_sweep",
        "runs": runs,
        "mixes": n_mixes,
        "seeds_per_mix": n_seeds,
        "failures": failures,
        "ok": not failures,
        "seconds": round(time.perf_counter() - t0, 1),
    }


def _mix_telemetry(rep, cfg: SimConfig, region_names: tuple = ()) -> dict:
    """One mix's flight-recorder block, a pure function of (cfg, seeds):
    the lanes' counters and latency quantiles reduced across lanes
    (``telemetry/recorder.reduce_lanes``), the region-pair plane, the
    windowed series, and the configured against the observed drop rate
    (i.i.d.-layer drops over offered edges, per 1e4)."""
    from tpu_paxos_torch.telemetry import recorder as telem

    ts = rep.telemetry
    if ts is None:
        return {}
    agg = telem.reduce_lanes(
        ts, getattr(rep, "windows", None),
        region_names=tuple(region_names),
    )
    offered, dropped = agg["offered"], agg["dropped"]
    return {
        **{k: agg[k] for k in (
            "offered", "dropped", "duped", "delayed",
            "latency_p50", "latency_p99", "latency_max",
            "decided", "takeovers", "requeues", "restarts",
            "heal_gap_min", "stall_depth_max", "duel_depth_max",
        )},
        "region_pairs": agg["region_pairs"],
        **({"windows": agg["windows"]} if "windows" in agg else {}),
        "drop_rate_configured": cfg.faults.drop_rate,
        "drop_rate_observed": (
            round(1e4 * dropped / offered, 1) if offered else 0.0
        ),
    }


def sweep_fleet(
    n_seeds: int = 8,
    base_seed: int = 0,
    verbose: bool = True,
    triage_dir: str | None = None,
    mixes=None,
    device="cuda",
) -> dict:
    """The episode-mix sweeps through the FLEET runner: per mix, every
    seed is a lane of one dispatch of the armed envelope runner
    (``fleet/envelope.runner_for(..., telemetry=True)``), the schedule a
    per-lane table and the i.i.d. knobs per-lane knobs, so every mix of
    one geometry shares one runner.  Lanes are judged on the device by
    the invariant subset; only failing lanes come to the host for the
    full crash-aware suite and shrink triage.  Each lane equals the host
    loop's run of the same (mix, seed).

    ``compiles_per_mix`` keeps JAX's key: JAX counts the XLA compiles of
    each mix's dispatch, and the port compiles nothing, so each mix gets
    the ``runner_for`` cache misses it caused (the runners built for it;
    0 once an earlier mix built its envelope).  The summary equals JAX's
    less ``seconds``, ``lanes_per_sec`` and ``compiles_per_mix``."""
    from tpu_paxos_torch.fleet import envelope as env

    logger = logm.get_logger(
        "stress", logm.parse_level("INFO" if verbose else "WARN")
    )
    mixes = (EPISODE_MIXES + WAN_MIXES) if mixes is None else mixes
    runs, failures = 0, []
    lane_seconds, lanes_total = 0.0, 0
    compiles_per_mix: dict[str, int] = {}
    telemetry_per_mix: dict[str, dict] = {}
    t0 = time.perf_counter()
    for label, fkw, n_nodes, n_prop in mixes:
        sched = fkw["schedule"]
        base_kw = {k: v for k, v in fkw.items() if k != "schedule"}
        lanes = []  # (seed, workload, gates, chains)
        for s in range(n_seeds):
            seed = base_seed + s
            rng = np.random.default_rng(
                seed * 7919 + zlib.crc32(label.encode()) % 1000
            )
            workload, gates, chains = _workload(n_prop, rng)
            lanes.append((seed, workload, gates, chains))
        cfg = SimConfig(
            n_nodes=n_nodes,
            n_instances=2 * sum(len(w) for w in lanes[0][1]),
            proposers=tuple(range(n_prop)),
            seed=base_seed,
            max_rounds=20_000,
            faults=FaultConfig(**base_kw),
        )
        before = env.cache_misses()
        runner = env.runner_for(
            cfg, lanes[0][1], lanes[0][2], telemetry=True, device=device
        )
        compiles_per_mix[label] = env.cache_misses() - before
        rmap = WAN_REGIONS.get(label)
        rep = runner.run(
            [ln[0] for ln in lanes],
            [sched] * n_seeds,
            workloads=[(ln[1], ln[2]) for ln in lanes],
            knobs=[cfg.faults] * n_seeds,
            regions=None if rmap is None else [rmap] * n_seeds,
        )
        telemetry_per_mix[label] = _mix_telemetry(
            rep, cfg, region_names=WAN_NAMES.get(label, ())
        )
        runs += n_seeds
        lanes_total += n_seeds
        lane_seconds += rep.seconds
        for i in rep.failing:
            seed, workload, gates, chains = lanes[i]
            r = rep.lane_result(i)
            try:
                _check_run(r, rep.lane_cfg(i), workload, chains)
                # the device verdict flagged a lane the full suite clears:
                # a verdict/parity bug, reported as its own failure
                failures.append({
                    "mix": label, "seed": seed,
                    "error": "fleet verdict flagged a lane the full "
                    "suite clears (verdict/parity drift)",
                })
                logger.error(
                    "FLEET ANOMALY mix=%s seed=%d: verdict red, "
                    "suite green", label, seed,
                )
            except validate.InvariantViolation as e:
                failure = {"mix": label, "seed": seed, "error": str(e)[:300]}
                logger.error("FAIL mix=%s seed=%d: %s", label, seed, e)
                if triage_dir:
                    os.makedirs(triage_dir, exist_ok=True)
                    path = os.path.join(
                        triage_dir, f"repro_{label}_{seed}.json"
                    )
                    try:
                        case = shr.ReproCase(
                            cfg=rep.lane_cfg(i), workload=workload,
                            gates=gates, chains=chains,
                        )
                        art = shr.triage(case, path, logger=logger, device=device)
                        failure["artifact"] = path
                        failure["shrink_seconds"] = art.get("shrink_seconds")
                        logger.error("repro artifact written to %s", path)
                    except Exception as te:  # triage must never mask a failure
                        failure["triage_error"] = str(te)[:300]
                failures.append(failure)
        logger.info(
            "fleet mix %-14s: %d lanes in %.2fs (%.1f lanes/sec, "
            "%d runners built)",
            label, n_seeds, rep.seconds, rep.lanes_per_sec,
            compiles_per_mix[label],
        )
    return {
        "metric": "stress_sweep_fleet",
        "runs": runs,
        "mixes": len(mixes),
        "seeds_per_mix": n_seeds,
        "lanes": lanes_total,
        "lanes_per_sec": round(lanes_total / max(lane_seconds, 1e-9), 2),
        "compiles_per_mix": compiles_per_mix,
        "telemetry": telemetry_per_mix,
        "failures": failures,
        "ok": not failures,
        "seconds": round(time.perf_counter() - t0, 1),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=8, help="seeds per mix")
    ap.add_argument("--base-seed", type=int, default=0)
    ap.add_argument(
        "--triage-dir",
        type=str,
        default="",
        help="on any failing seed, shrink the fault schedule to a "
        "minimal failing case and write a repro artifact here "
        "(replay with `python -m tpu_paxos_torch repro <artifact>`)",
    )
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument(
        "--fleet",
        action="store_true",
        help="route the episode mixes through the fleet runner (seeds "
        "become lanes of one dispatch per mix; the host loop keeps the "
        "i.i.d.-only mixes)",
    )
    ap.add_argument("--sharded", action="store_true",
                    help="the sharded sweep (not ported yet)")
    args = ap.parse_args(argv)
    if args.sharded:
        print("tpu_paxos_torch.harness.stress: --sharded is not ported yet",
              file=sys.stderr)
        return 2
    triage_dir = args.triage_dir or None
    if args.fleet:
        host_mixes = [m for m in MIXES if "schedule" not in m[1]]
        summary = sweep(args.seeds, args.base_seed, triage_dir=triage_dir,
                        mixes=host_mixes, device=args.device)
        print(json.dumps(summary))
        fleet_summary = sweep_fleet(args.seeds, args.base_seed, triage_dir=triage_dir,
                                    device=args.device)
        print(json.dumps(fleet_summary))
        ok = summary["ok"] and fleet_summary["ok"]
    else:
        summary = sweep(args.seeds, args.base_seed, triage_dir=triage_dir,
                        device=args.device)
        print(json.dumps(summary))
        ok = summary["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
