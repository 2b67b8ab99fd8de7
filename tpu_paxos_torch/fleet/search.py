"""Randomized schedule search (port of ``tpu_paxos/fleet/search.py``):
generate episode schedules from a seeded grammar, run them as fleet
lanes, shrink every wedge found.

1. per lane, sample a schedule from the seeded grammar
   (:func:`sample_schedule`: partition / one-way / pause / burst / crash
   with jittered intervals, random groups and burst rates) and a fresh
   engine seed (the same numpy draw sequence as the JAX package's);
2. run the whole generation as one fleet dispatch of the armed runner;
   the on-device verdict plus the optional ``decision_round_max`` bound
   flag suspicious lanes;
3. every flagged lane is re-run as a single run, judged by the FULL
   invariant suite, greedily shrunk (``harness/shrink.py``) and written
   as a repro artifact that ``python -m tpu_paxos_torch repro`` replays
   byte for byte;
4. iterate generations until the budget runs out.

``python -m tpu_paxos_torch fleet`` prints ONE JSON summary line (lanes/s,
wedges found, artifact paths, per-generation near-miss margins) and exits
non-zero only on a REAL invariant violation (a ``decision_round_max``
bound is a synthetic wedge knob).  Same seeds, same summary as the JAX
CLI, less the wall-clock keys.  The lane tile over devices (``mesh=``,
``--mesh``) and the membership samplers are not ported yet and raise by
name.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import sys
import time

import numpy as np

from tpu_paxos_torch.config import (
    EdgeFaultConfig, FaultConfig, ProtocolConfig, SimConfig,
)
from tpu_paxos_torch.core import faults as fltm

KINDS = ("partition", "one_way", "pause", "burst", "crash")

#: The WAN-extended grammar: gray failures join the draw alphabet
#: (opt-in: adding a kind changes the seeded draw sequence).
KINDS_GRAY = KINDS + ("gray",)

#: Gray-episode delay-inflation draw bound (rounds).
GRAY_DELAY_MAX = 5

#: Edge-matrix gene base-latency cap, the committed WAN presets' range.
GENE_LAT_MAX = 4

#: Crash-point grid resolution: crash ``t0`` draws land on this many
#: quantized slots across the first 3/4 of the horizon.
CRASH_GRID = 8


@dataclasses.dataclass(frozen=True)
class Alphabet:
    """The declarative search-grammar spec: which episode kinds are
    drawable (in DRAW ORDER), whether per-edge WAN fault matrices are
    genes, and the schedule-shape bounds."""

    kinds: tuple = KINDS
    wan: bool = False
    max_episodes: int = 4
    horizon: int = 96

    def __post_init__(self) -> None:
        if not self.kinds:
            raise ValueError("alphabet needs at least one episode kind")
        bad = sorted(set(self.kinds) - set(KINDS_GRAY))
        if bad:
            raise ValueError(
                f"unknown episode kind(s): {', '.join(bad)} "
                f"(drawable: {', '.join(KINDS_GRAY)})"
            )
        if len(set(self.kinds)) != len(self.kinds):
            raise ValueError("alphabet kinds must be distinct")
        if self.max_episodes < 1:
            raise ValueError("max_episodes must be >= 1")
        if self.horizon < 8:
            raise ValueError("horizon must be >= 8 rounds")

    @classmethod
    def classic(
        cls, gray: bool = False, wan: bool = False,
        max_episodes: int = 4, horizon: int = 96,
    ) -> "Alphabet":
        return cls(
            kinds=KINDS_GRAY if gray else KINDS, wan=wan,
            max_episodes=max_episodes, horizon=horizon,
        )

    @property
    def gray(self) -> bool:
        return "gray" in self.kinds

    def member(self) -> "Alphabet":
        """The member-legal subset (the membership engine is not ported
        yet)."""
        raise NotImplementedError("Alphabet.member (membership) is not ported yet")

    def protocol(self):
        """WAN alphabets scale the retry ladder to the gene RTT (one
        protocol config for every lane keeps one envelope)."""
        if not self.wan:
            return None
        rtt = 2 * GENE_LAT_MAX + 2
        return ProtocolConfig(
            prepare_delay_max=rtt,
            prepare_retry_timeout=rtt,
            accept_retry_timeout=rtt,
            commit_retry_timeout=rtt,
        )

    def sample(self, rng: np.random.Generator, n_nodes: int):
        """One schedule draw under this alphabet."""
        return sample_schedule(
            rng, n_nodes, self.max_episodes, self.horizon,
            kinds=self.kinds,
        )

    def sample_episode(
        self, rng: np.random.Generator, n_nodes: int,
        crashed=frozenset(), kinds=None,
    ):
        """One episode draw under this alphabet (``kinds`` narrows the
        draw set; it must be a subset)."""
        use = self.kinds if kinds is None else tuple(kinds)
        bad = sorted(set(use) - set(self.kinds))
        if bad:
            raise ValueError(
                f"kind(s) outside this alphabet: {', '.join(bad)}"
            )
        return sample_episode(
            rng, n_nodes, self.horizon, crashed=crashed, kinds=use
        )


def sample_episode(
    rng: np.random.Generator, n_nodes: int, horizon: int,
    crashed=frozenset(),
    kinds=KINDS,
) -> fltm.Episode:
    """One grammar draw: a kind, a jittered interval inside ``[0,
    horizon)``, and kind-specific random structure.  ``crashed`` is the
    set of nodes earlier episodes of the same schedule crash: a crash
    draw without minority room falls back to a burst."""
    kind = kinds[int(rng.integers(len(kinds)))]
    t0 = int(rng.integers(0, max(1, horizon - 6)))
    width = int(rng.integers(4, max(5, horizon // 2)))
    t1 = min(t0 + width, horizon)
    if t1 <= t0:
        t1 = t0 + 1
    if kind == "crash":
        room = (n_nodes - 1) // 2 - len(crashed)
        avail = np.asarray(
            [n for n in range(n_nodes) if n not in crashed]
        )
        if room >= 1:
            k = int(rng.integers(1, room + 1))
            nodes = rng.permutation(avail)[:k]
            step = max(1, (3 * horizon // 4) // CRASH_GRID)
            t0c = int(rng.integers(0, CRASH_GRID)) * step
            return fltm.crash(t0c, *(int(x) for x in nodes))
        kind = "burst"  # no minority room left in this schedule
    if kind == "partition":
        nodes = rng.permutation(n_nodes)
        k = int(rng.integers(1, n_nodes))  # both sides non-empty
        return fltm.partition(
            t0, t1, tuple(int(x) for x in nodes[:k]),
            tuple(int(x) for x in nodes[k:]),
        )
    if kind == "one_way":
        nodes = rng.permutation(n_nodes)
        ns = int(rng.integers(1, n_nodes))
        nd = int(rng.integers(1, n_nodes))
        src = tuple(int(x) for x in nodes[:ns])
        dst = tuple(int(x) for x in rng.permutation(n_nodes)[:nd])
        return fltm.one_way(t0, t1, src, dst)
    if kind == "pause":
        n_paused = int(rng.integers(1, max(2, n_nodes // 2 + 1)))
        nodes = rng.permutation(n_nodes)[:n_paused]
        return fltm.pause(t0, t1, *(int(x) for x in nodes))
    if kind == "gray":
        n_gray = int(rng.integers(1, n_nodes + 1))
        nodes = rng.permutation(n_nodes)[:n_gray]
        d = int(rng.integers(1, GRAY_DELAY_MAX + 1))
        return fltm.gray(t0, t1, *(int(x) for x in nodes), delay=d)
    return fltm.burst(t0, t1, int(rng.integers(500, 6000)))


def sample_schedule(
    rng: np.random.Generator,
    n_nodes: int,
    max_episodes: int = 4,
    horizon: int = 96,
    kinds=KINDS,
) -> fltm.FaultSchedule:
    n_eps = int(rng.integers(1, max_episodes + 1))
    eps, crashed = [], set()
    for _ in range(n_eps):
        e = sample_episode(rng, n_nodes, horizon, crashed=crashed,
                           kinds=kinds)
        if e.kind == "crash":
            crashed.update(e.nodes)
        eps.append(e)
    return fltm.FaultSchedule(tuple(eps))


def sample_edge_knobs(
    rng: np.random.Generator,
    n_nodes: int,
    delay_bound: int,
    base_drop: int = 300,
) -> FaultConfig:
    """One grammar draw over the per-edge FAULT MATRIX axis: a random
    node->"region" clustering whose cross-cluster edges carry drawn
    latency (+1 jitter) and drawn asymmetric loss on top of
    ``base_drop``.  Base latencies are capped at ``GENE_LAT_MAX``."""
    n_groups = int(rng.integers(2, max(3, n_nodes // 2 + 2)))
    gmap = rng.integers(0, n_groups, size=n_nodes)
    lat = rng.integers(1, 3, size=(n_groups, n_groups))
    lat = np.minimum(lat + lat.T, GENE_LAT_MAX)  # symmetric-ish base
    np.fill_diagonal(lat, 0)
    loss = rng.integers(0, 1200, size=(n_nodes, n_nodes))
    cross = gmap[:, None] != gmap[None, :]
    mind = lat[gmap[:, None], gmap[None, :]].astype(np.int64)
    maxd = np.minimum(mind + 1, delay_bound)
    drop = np.where(cross, base_drop + loss, base_drop)
    drop = np.minimum(drop, 10_000)
    np.fill_diagonal(drop, 0)
    return FaultConfig(
        max_delay=int(delay_bound),
        edges=EdgeFaultConfig(
            drop_rate=drop,
            dup_rate=np.zeros_like(drop),
            min_delay=mind,
            max_delay=maxd,
        ),
    )


def sample_churn_schedule(*args, **kwargs):
    """A membership-schedule draw (waits for the membership engine)."""
    raise NotImplementedError("sample_churn_schedule (membership) is not ported yet")


def churn_targets(*args, **kwargs):
    """The acceptors a churn schedule names (waits for membership)."""
    raise NotImplementedError("churn_targets (membership) is not ported yet")


def sample_member_schedule(*args, **kwargs):
    """A member-legal fault-schedule draw (waits for membership)."""
    raise NotImplementedError("sample_member_schedule (membership) is not ported yet")


def lane_cause_series(rep, lanes) -> dict:
    """Per-LANE breach attribution (``telemetry/diagnose.label_windows``
    on one lane's own windowed series): ``{lane: cause series}`` for the
    requested lanes; lanes without telemetry are skipped."""
    from tpu_paxos_torch.telemetry import diagnose as diag

    out: dict = {}
    for i in lanes:
        d = rep.lane_telemetry(int(i))
        if not d or "windows" not in d:
            continue
        out[int(i)] = diag.label_windows(
            d["windows"], region_pairs=d.get("region_pairs")
        )
    return out


def _generation_margins(rep, flagged=()) -> dict:
    """One generation's ``[lanes]`` recorder summaries reduced to the
    near-miss margin vector: the closest any lane came to a liveness
    wedge, with the windowed series (``stall_margin_series``: per bucket,
    the minimum over lanes of the stall headroom left before
    ``core/sim.IDLE_RESTART_ROUNDS`` trips; ``latency_p99_series``,
    ``drop_series``), the generation's top cause per bucket
    (``cause_series``) and, for the flagged lanes, each lane's own
    (``lane_causes``)."""
    from tpu_paxos_torch.core.sim import IDLE_RESTART_ROUNDS
    from tpu_paxos_torch.telemetry import diagnose as diag
    from tpu_paxos_torch.telemetry import recorder as telem

    ts = rep.telemetry
    if ts is None:
        return {}
    ws = getattr(rep, "windows", None)
    agg = telem.reduce_lanes(ts, ws)
    out = {k: agg[k] for k in (
        "heal_gap_min", "stall_depth_max", "duel_depth_max",
        "rounds_max", "takeovers", "latency_p99", "latency_max",
    )}
    if ws is not None:
        out["window_rounds"] = agg["windows"]["window_rounds"]
        out["stall_margin_series"] = telem.stall_margin_series(
            ws, IDLE_RESTART_ROUNDS
        )
        out["latency_p99_series"] = agg["windows"]["latency_p99"]
        out["drop_series"] = agg["windows"]["dropped"]
        out["cause_series"] = diag.label_windows(
            agg["windows"], region_pairs=agg.get("region_pairs")
        )
        if flagged:
            out["lane_causes"] = {
                str(i): c
                for i, c in lane_cause_series(rep, sorted(flagged)).items()
            }
    return out


def search(
    n_lanes: int,
    generations: int,
    base_seed: int = 0,
    triage_dir: str | None = None,
    decision_round_max: int | None = None,
    n_nodes: int = 5,
    n_prop: int = 2,
    fault_kw: dict | None = None,
    max_episodes: int = 4,
    horizon: int = 96,
    max_wedges: int = 8,
    mesh=None,
    verbose: bool = True,
    gray: bool = False,
    wan: bool = False,
    alphabet: Alphabet | None = None,
    device="cuda",
) -> dict:
    """Run the generation loop on ``device``; returns the JSON-ready
    summary, equal to the JAX package's less ``seconds``,
    ``lanes_per_sec`` and each wedge's ``shrink_seconds``.

    The grammar is ``alphabet``; when None, ``gray``/``wan`` build the
    classic one (``gray=True`` adds gray episodes, ``wan=True`` draws a
    per-edge fault MATRIX per lane, ``sample_edge_knobs``).  Every
    generation runs on the armed envelope runner
    (``fleet/envelope.runner_for(..., telemetry=True)``) whose episode
    capacity is floored at ``runner.MAX_EPISODES``, the shrinker's
    envelope.  ``mesh`` (the lane tile over devices) is not ported yet."""
    from tpu_paxos_torch.fleet import envelope as env
    from tpu_paxos_torch.fleet import runner as frun
    from tpu_paxos_torch.harness import shrink as shr
    from tpu_paxos_torch.utils import log as logm

    if mesh is not None:
        raise NotImplementedError("search mesh= (the lane tile over devices) is not ported yet")
    # the stress workload builder drives sweeps and never makes replayed
    # bytes: imported late, as the JAX module keeps it out of its closure
    strs = importlib.import_module("tpu_paxos_torch.harness.stress")
    logger = logm.get_logger(
        "fleet", logm.parse_level("INFO" if verbose else "WARN")
    )
    if alphabet is None:
        alphabet = Alphabet.classic(
            gray=gray, wan=wan, max_episodes=max_episodes,
            horizon=horizon,
        )
    fault_kw = dict(fault_kw or dict(drop_rate=300, dup_rate=500, max_delay=2))
    wl_rng = np.random.default_rng(base_seed)
    workload, gates, chains = strs._workload(n_prop, wl_rng)
    # WAN genes need WAN timeouts: one protocol config for all lanes
    # scaled to the gene RTT (see Alphabet.protocol)
    protocol = alphabet.protocol()
    cfg = SimConfig(
        n_nodes=n_nodes,
        n_instances=2 * sum(len(w) for w in workload),
        proposers=tuple(range(n_prop)),
        seed=base_seed,
        max_rounds=20_000,
        faults=FaultConfig(**fault_kw),
        **({"protocol": protocol} if protocol is not None else {}),
    )
    runner = env.runner_for(
        cfg, workload, gates,
        max_episodes=max(alphabet.max_episodes, frun.MAX_EPISODES),
        telemetry=True, device=device,
    )
    lane_workloads = [(workload, gates)] * n_lanes
    lane_knobs = [cfg.faults] * n_lanes
    extra = (
        {"decision_round_max": int(decision_round_max)}
        if decision_round_max else {}
    )
    t0 = time.perf_counter()
    lanes_total = 0
    wedges: list[dict] = []
    anomalies: list[dict] = []
    gen_summaries: list[dict] = []
    for g in range(generations):
        sched_rng = np.random.default_rng((base_seed, g))
        schedules = [
            alphabet.sample(sched_rng, n_nodes)
            for _ in range(n_lanes)
        ]
        if alphabet.wan:
            # per-lane edge-matrix genes from their own seeded stream
            knob_rng = np.random.default_rng((base_seed, g, 7))
            lane_knobs = [
                sample_edge_knobs(
                    knob_rng, n_nodes, runner.delay_bound,
                    base_drop=cfg.faults.drop_rate,
                )
                for _ in range(n_lanes)
            ]
        seeds = [base_seed + g * n_lanes + i for i in range(n_lanes)]
        rep = runner.run(
            seeds, schedules,
            workloads=lane_workloads,
            knobs=lane_knobs,
        )
        lanes_total += n_lanes
        real_flagged = set(rep.failing)
        flagged = set(real_flagged)
        if decision_round_max is not None:
            flagged |= {
                i for i in range(n_lanes)
                if int(rep.verdict.max_round[i]) > decision_round_max
            }
        logger.info(
            "generation %d: %d lanes, %d flagged (%.1f lanes/sec)",
            g, n_lanes, len(flagged), rep.lanes_per_sec,
        )
        gen_summaries.append({
            "generation": g,
            "lanes": n_lanes,
            "flagged": len(flagged),
            "margins": _generation_margins(rep, flagged=flagged),
        })
        for i in sorted(flagged):
            if len(wedges) >= max_wedges:
                break
            # the synthetic decision_round_max check rides only lanes
            # flagged by it alone: a lane red on the REAL verdict shrinks
            # against the real invariants
            case = shr.ReproCase(
                cfg=rep.lane_cfg(i), workload=workload, gates=gates,
                chains=chains,
                extra_checks={} if i in real_flagged else dict(extra),
            )
            _, viol = shr.run_case(case, device=device)
            if viol is None:
                # the on-device subset flagged a lane the full suite
                # clears: surfaced, never hidden
                anomalies.append({
                    "generation": g, "lane": i, "seed": rep.seeds[i],
                    "verdict": {
                        f: bool(getattr(rep.verdict, f)[i])
                        for f in ("ok", "agreement", "coverage", "quiescent")
                    },
                })
                continue
            wedge = {
                "generation": g,
                "lane": i,
                "seed": rep.seeds[i],
                "violation": viol[:300],
                "synthetic": "decision_round_max" in (viol or ""),
                "schedule": rep.schedules[i].to_dict(),
            }
            if triage_dir:
                os.makedirs(triage_dir, exist_ok=True)
                path = os.path.join(
                    triage_dir, f"repro_fleet_g{g}_lane{i}.json"
                )
                try:
                    art = shr.triage(case, path, logger=logger, device=device)
                    wedge["artifact"] = path
                    wedge["shrink_seconds"] = art.get("shrink_seconds")
                    logger.info("wedge shrunk -> %s", path)
                except Exception as te:  # triage must never mask a find
                    wedge["triage_error"] = str(te)[:300]
            wedges.append(wedge)
        if len(wedges) >= max_wedges:
            logger.info("wedge budget (%d) reached", max_wedges)
            break
    seconds = time.perf_counter() - t0
    real = [w for w in wedges if not w["synthetic"]]
    return {
        "metric": "fleet_search",
        "lanes": n_lanes,
        "generations": generations,
        "lanes_total": lanes_total,
        "lanes_per_sec": round(lanes_total / max(seconds, 1e-9), 2),
        "seconds": round(seconds, 1),
        "wedges_found": len(wedges),
        "real_violations": len(real),
        "wedges": wedges,
        "anomalies": anomalies,
        "generation_telemetry": gen_summaries,
        "ok": not real and not anomalies,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_paxos_torch fleet",
        description="device-batched schedule search: sample episode "
        "schedules per lane, run them as one fleet dispatch per "
        "generation, shrink every wedge to a repro artifact",
    )
    ap.add_argument("--lanes", type=int, default=0,
                    help="lanes per generation (0 = the device's default)")
    ap.add_argument("--generations", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nodes", type=int, default=5)
    ap.add_argument("--proposers", type=int, default=2)
    ap.add_argument("--max-episodes", type=int, default=4)
    ap.add_argument("--horizon", type=int, default=96,
                    help="grammar bound: every sampled episode ends "
                    "by this round")
    ap.add_argument("--max-wedges", type=int, default=8)
    ap.add_argument("--decision-round-max", type=int, default=0,
                    help="flag lanes whose latest decision lands "
                    "after this round (synthetic wedge knob; 0 = off)")
    ap.add_argument("--gray", action="store_true",
                    help="add gray-failure episodes (per-node delay "
                    "inflation) to the grammar alphabet")
    ap.add_argument("--wan", action="store_true",
                    help="mutate the per-edge fault matrix per lane "
                    "(WAN-shaped drop/latency genes)")
    ap.add_argument("--drop-rate", type=int, default=300)
    ap.add_argument("--dup-rate", type=int, default=500)
    ap.add_argument("--max-delay", type=int, default=2)
    ap.add_argument("--crash-rate", type=int, default=0)
    ap.add_argument("--triage-dir", type=str, default="",
                    help="shrink every wedge into a repro artifact "
                    "here (replay: python -m tpu_paxos_torch repro <path>)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--mesh", type=int, default=0,
                    help="tile the lane axis over this many devices "
                    "(not ported yet)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    if args.mesh:
        raise NotImplementedError("fleet --mesh (the lane tile over devices) is not ported yet")
    from tpu_paxos_torch.fleet import runner as frun

    summary = search(
        n_lanes=args.lanes or frun.default_lane_count(args.device),
        generations=args.generations,
        base_seed=args.seed,
        triage_dir=args.triage_dir or None,
        decision_round_max=args.decision_round_max or None,
        n_nodes=args.nodes,
        n_prop=args.proposers,
        fault_kw=dict(
            drop_rate=args.drop_rate, dup_rate=args.dup_rate,
            max_delay=args.max_delay, crash_rate=args.crash_rate,
        ),
        max_episodes=args.max_episodes,
        horizon=args.horizon,
        max_wedges=args.max_wedges,
        verbose=not args.quiet,
        gray=args.gray,
        wan=args.wan,
        device=args.device,
    )
    print(json.dumps(summary, sort_keys=True))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
