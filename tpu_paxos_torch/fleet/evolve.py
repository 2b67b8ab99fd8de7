"""The certified selection loop on the port (port of
``tpu_paxos/fleet/evolve.py``): mutate-and-select wedge hunting over
fleet, membership, and serve lanes.

``fleet/search.py`` samples schedules blind — every generation is a
fresh i.i.d. draw from the grammar.  This module closes ROADMAP item
1's loop: a population is a ``[lanes]`` stack of GENOMES (fault
schedules, per-edge WAN knob matrices, churn-event tables, per-tenant
arrival plans under weather presets), one generation is ONE fleet
dispatch through the shared envelope cache (zero runner builds after
generation 0), fitness is the climbing signal the
flight recorder already emits, and selection/mutation/crossover
operate on the SAME grammar samplers ``search`` draws from (the
shared :class:`~tpu_paxos_torch.fleet.search.Alphabet` — the two samplers
cannot drift):

- **fleet axis** — fitness is the per-lane minimum stall margin
  (``telemetry/recorder.lane_stall_margins``): the tightest liveness
  headroom each genome reached.  Lower is fitter; a flagged lane (the
  on-device verdict subset, plus the optional synthetic
  ``decision_round_max`` bound) dominates everything.
- **member axis** — genomes carry a churn schedule
  (``search.sample_churn_schedule``) plus a member-legal fault
  schedule; fitness is rounds-to-finish (slower = closer to a stall),
  a red member verdict dominates.  Recall is measured against the
  302-scenario ``churn`` mc-scope denominator.
- **serve axis** — genomes are offered-load shapes under quantized
  weather presets (``serve/breach.py``); fitness is the windowed SLO
  burn rate, a breaching lane dominates, and the breach verdict
  carries the judge's diagnosis.

``diagnose.py``'s stable cause labels make the hunt CAUSE-TARGETED:
``--hunt gray-region`` biases mutation's episode draws toward the
gene families that produce that label (:data:`CAUSE_FAMILIES`) and
bonuses lanes whose own windowed series showed it (per-lane
attribution via ``search.lane_cause_series`` — the aggregate series
would credit the wrong genome).

Every flagged fleet lane re-derives single-run -> full judge ->
batched shrinker -> schema-closed artifact exactly like ``search``.
Recall is CERTIFIED (``--certified``): with
``TPU_PAXOS_SEEDED_WEDGE=takeover`` armed, the loop must find AND
shrink the wedge within <= 1/4 of the exhaustive quick-scope lane
budget — the denominator is read from ``mc_certificate.json``
(``scenarios_reduced``), never hard-coded — the shrunk artifact must
replay byte-identically, and warm compiles must be zero; the
BENCH_evolve.json record is withheld on any guard failure.

The operators (``Genome`` through :func:`select`) are the JAX package's
loop for loop: the order of ``rng.integers`` draws is the contract, so
every population (``population_sha256``), wedge and artifact equals
JAX's bit for bit.  Fitness is computed from integer windows into the
same Python floats, so ``select``'s ``(score, lane index)`` ties break
alike.

Where the port differs:

- **Runner builds, not XLA compiles.**  The port builds its runners
  eagerly in ``fleet/envelope`` and compiles nothing at the first
  dispatch, so ``compiles_per_generation`` counts envelope runner builds
  (``envelope.cache_misses``): on the fleet and member axes from *before*
  ``runner_for``/``member_runner_for`` (generation 0 carries the build),
  on the serve axis around ``breach.evaluate`` (one build per weather
  preset, in generation 0).  The contract is the zero pattern:
  generation 0 builds when the envelope is cold, every later generation
  builds nothing, and ``warm_compiles`` is 0.  JAX's generation-0 count
  is its XLA compiles (2 in BENCH_evolve.json); the port's is its runner
  builds (1 a cold envelope).
- **An explicit device.**  :func:`evolve` takes ``device`` (default
  ``"cuda"``) and the CLI ``--device {cuda,cpu}`` (in place of
  ``--backend``); there is no fallback.  ``--lanes 0`` takes
  ``runner.default_lane_count(device)``.  ``mesh=`` and ``--mesh N``
  tile each generation's lanes over a mesh's ranks; the CLI pads the
  lane count to tile it, as JAX's does.
- **The lane tile on the fleet axis only.**  As JAX's :func:`evolve`,
  the port tiles the fleet axis's lanes over ``mesh`` and runs the
  member and serve axes untiled whatever the mesh, so their lane counts
  and weather groups need not tile it.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import time

import numpy as np

from tpu_paxos_torch.config import FaultConfig, SimConfig
from tpu_paxos_torch.core import faults as fltm
from tpu_paxos_torch.fleet import search as srch

#: Cause label -> the episode-kind families whose genes produce it
#: (the mutation bias table).  Keys are diagnose.CAUSES members; the
#: mapping is part of the hunt contract (tests/test_torch_evolve.py) —
#: appending a family is additive, existing entries never move.
CAUSE_FAMILIES = {
    "gray-region": ("gray",),
    "partition": ("partition", "one_way"),
    "duel-churn": ("pause", "crash"),
    "saturation": ("burst",),
}

#: Hunted-family draw odds: a biased episode draw lands inside the
#: hunted family HUNT_BIAS times out of HUNT_BIAS + 1.
HUNT_BIAS = 4

#: Fraction of the population carried verbatim into the next
#: generation (at least one).
ELITE_FRAC = 0.25

#: Fraction of each generation replaced by FRESH grammar draws
#: (hunt-biased).  Pure mutate-and-select collapses onto the gen-0
#: lineages within a few generations — local moves around non-wedge
#: schedules rarely assemble a multi-episode interplay (the takeover
#: wedge needs a pause AND a crash in one schedule) — so the loop
#: keeps the blind sampler's full-draw coverage as an exploration
#: floor and lets selection climb the near-misses on top of it.
IMMIGRANT_FRAC = 0.25

#: Fitness dominance offsets (margin units): a genuinely flagged lane
#: must outrank every near-miss, and a hunted-cause sighting must
#: outrank an equal margin without one.
WEDGE_BONUS = 1_000_000.0
CAUSE_BONUS = 1_000.0

#: certificate scope whose ``scenarios_reduced`` is the recall
#: denominator, per axis (serve has no exhaustive twin — no budget).
BUDGET_SCOPES = {"fleet": "quick", "member": "churn"}

#: the certified-recall contract: evolve must find the wedge within
#: scenarios_reduced // BUDGET_DIV lanes.
BUDGET_DIV = 4

#: engine-scope label per axis (the JAX package's compile-census scopes,
#: kept as data; the port counts envelope runner builds on every axis).
ENGINE_SCOPES = {"fleet": "fleet", "member": "member", "serve": "serve_fleet"}


@dataclasses.dataclass(frozen=True)
class Genome:
    """One fleet/member individual: a fault schedule, an engine seed,
    and the optional WAN knob-matrix / churn-table genes."""

    schedule: fltm.FaultSchedule
    seed: int
    knobs: FaultConfig | None = None
    churn: object | None = None  # membership ChurnSchedule | None

    def to_dict(self) -> dict:
        d: dict = {
            "seed": int(self.seed),
            "schedule": self.schedule.to_dict(),
        }
        if self.knobs is not None:
            # EdgeFaultConfig canonicalizes rows to int tuples, so
            # asdict is already JSON-stable
            d["knobs"] = dataclasses.asdict(self.knobs)
        if self.churn is not None:
            d["churn"] = [
                {"vid": int(e.vid), "t0": int(e.t0), "wait": int(e.wait)}
                for e in self.churn.events
            ]
        return d


def _genome_dict(g) -> dict:
    return g.to_dict() if hasattr(g, "to_dict") else dataclasses.asdict(g)


def population_sha(pop) -> str:
    """sha256 over the population's stable JSON — the elitism-
    determinism pin (same seed -> same population, byte-for-byte)."""
    text = json.dumps([_genome_dict(g) for g in pop], sort_keys=True)
    return hashlib.sha256(text.encode()).hexdigest()


def hunt_kinds(alphabet: srch.Alphabet, hunt: str | None) -> tuple:
    """The hunted cause's episode-kind family, intersected with the
    alphabet (empty tuple = no bias)."""
    fam = CAUSE_FAMILIES.get(hunt or "", ())
    return tuple(k for k in fam if k in alphabet.kinds)


def draw_episode(
    rng, alphabet: srch.Alphabet, n_nodes: int,
    crashed=frozenset(), hunt: str | None = None,
):
    """One mutation-step episode draw: with a hunt armed, the draw
    lands inside the hunted family HUNT_BIAS/(HUNT_BIAS+1) of the
    time (kind drawn first, then the alphabet's episode sampler runs
    narrowed to it — the unbiased path consumes the identical draw
    sequence as ``Alphabet.sample_episode``)."""
    fam = hunt_kinds(alphabet, hunt)
    if fam and int(rng.integers(0, HUNT_BIAS + 1)):
        kind = fam[int(rng.integers(0, len(fam)))]
        return alphabet.sample_episode(
            rng, n_nodes, crashed=crashed, kinds=(kind,)
        )
    return alphabet.sample_episode(rng, n_nodes, crashed=crashed)


def fresh_schedule(
    rng, alphabet: srch.Alphabet, n_nodes: int,
    hunt: str | None = None, protected=frozenset(),
) -> fltm.FaultSchedule:
    """An immigrant's schedule: a full grammar draw, with one episode
    spliced to the hunted family when the draw carried none of it (a
    ``--hunt`` immigrant always brings at least one hunted gene)."""
    sched = alphabet.sample(rng, n_nodes)
    fam = hunt_kinds(alphabet, hunt)
    if fam and not any(e.kind in fam for e in sched.episodes):
        eps = list(sched.episodes)
        crashed = frozenset(protected) | {
            int(n) for e in eps if e.kind == "crash" for n in e.nodes
        }
        kind = fam[int(rng.integers(0, len(fam)))]
        eps[int(rng.integers(0, len(eps)))] = alphabet.sample_episode(
            rng, n_nodes, crashed=crashed, kinds=(kind,)
        )
        eps = legal_episodes(eps, n_nodes, protected=protected)
        if eps:
            sched = fltm.FaultSchedule(tuple(eps))
    return sched


def legal_episodes(eps, n_nodes: int, protected=frozenset()) -> tuple:
    """Re-impose the sampler's crash discipline on a spliced/crossed
    episode list: scheduled crashes keep the TOTAL crashed set a
    minority (majority-crash = no quorum = every lane reds vacuously)
    and never hit ``protected`` nodes (the member axis's driver node
    and churn targets).  Offending crash episodes drop; everything
    else passes through in order."""
    out: list = []
    crashed: set = set()
    cap = (n_nodes - 1) // 2
    for e in eps:
        if e.kind == "crash":
            nodes = set(int(x) for x in e.nodes)
            if nodes & set(protected):
                continue
            if len(crashed | nodes) > cap:
                continue
            crashed |= nodes
        out.append(e)
    return tuple(out)


def jitter_episode(rng, e, horizon: int):
    """Shift one episode's interval by a quantized delta (the
    episode-interval jitter move), width preserved, clipped inside
    ``[0, horizon]``."""
    step = max(1, horizon // srch.CRASH_GRID)
    delta = (int(rng.integers(0, 5)) - 2) * step
    width = max(int(e.t1) - int(e.t0), 1)
    t0 = min(max(int(e.t0) + delta, 0), max(horizon - width, 0))
    return dataclasses.replace(e, t0=t0, t1=t0 + width)


def mutate_schedule(
    rng, sched: fltm.FaultSchedule, alphabet: srch.Alphabet,
    n_nodes: int, hunt: str | None = None, protected=frozenset(),
) -> fltm.FaultSchedule:
    """One schedule mutation: splice (replace an episode with a fresh
    cause-biased draw), jitter (shift an interval), add, or drop —
    then the crash discipline re-applies."""
    eps = list(sched.episodes)
    move = int(rng.integers(0, 4))
    crashed = frozenset(protected) | {
        int(n) for e in eps if e.kind == "crash" for n in e.nodes
    }
    if move == 0 or not eps:  # splice
        j = int(rng.integers(0, max(len(eps), 1)))
        fresh = draw_episode(
            rng, alphabet, n_nodes, crashed=crashed, hunt=hunt
        )
        if eps:
            eps[j] = fresh
        else:
            eps.append(fresh)
    elif move == 1:  # jitter
        j = int(rng.integers(0, len(eps)))
        eps[j] = jitter_episode(rng, eps[j], alphabet.horizon)
    elif move == 2 and len(eps) < alphabet.max_episodes:  # add
        eps.append(
            draw_episode(rng, alphabet, n_nodes, crashed=crashed, hunt=hunt)
        )
    elif len(eps) > 1:  # drop
        eps.pop(int(rng.integers(0, len(eps))))
    out = legal_episodes(eps, n_nodes, protected=protected)
    if not out:
        out = (draw_episode(rng, alphabet, n_nodes, hunt=hunt),)
    return fltm.FaultSchedule(out)


def crossover_schedules(
    rng, a: fltm.FaultSchedule, b: fltm.FaultSchedule,
    alphabet: srch.Alphabet, n_nodes: int, protected=frozenset(),
) -> fltm.FaultSchedule:
    """Episode-list crossover: parent A's prefix + parent B's suffix
    at drawn split points, capped at the alphabet's episode bound,
    crash discipline re-applied (a legal child even when both parents
    carry crash genes)."""
    ea, eb = list(a.episodes), list(b.episodes)
    ka = int(rng.integers(0, len(ea) + 1))
    kb = int(rng.integers(0, len(eb) + 1))
    eps = (ea[:ka] + eb[kb:])[: alphabet.max_episodes]
    out = legal_episodes(eps, n_nodes, protected=protected)
    if not out:
        out = legal_episodes(ea, n_nodes, protected=protected) or (
            draw_episode(rng, alphabet, n_nodes),
        )
    return fltm.FaultSchedule(tuple(out))


def select(rng, pop, scores, make_child, make_fresh=None):
    """Elitist (mu+lambda)-style selection: rank ascending by score
    (ties break on lane index — fully deterministic), carry the elite
    fraction verbatim, fill the middle with children of parents drawn
    from the top half, and replace the tail with fresh immigrants
    (:data:`IMMIGRANT_FRAC`, when ``make_fresh`` is given) so the
    population never loses the blind sampler's coverage.
    Deterministic per rng stream: same seed -> same next population
    (pinned via :func:`population_sha`)."""
    n = len(pop)
    order = sorted(range(n), key=lambda i: (scores[i], i))
    n_elite = max(1, int(ELITE_FRAC * n))
    n_fresh = min(int(IMMIGRANT_FRAC * n), n - n_elite) if make_fresh else 0
    out = [pop[i] for i in order[:n_elite]]
    parents = order[: max(2, n // 2)]
    while len(out) < n - n_fresh:
        pa = pop[parents[int(rng.integers(0, len(parents)))]]
        pb = pop[parents[int(rng.integers(0, len(parents)))]]
        out.append(make_child(rng, pa, pb))
    while len(out) < n:
        out.append(make_fresh(rng))
    return out


def _budget_lanes(axis: str, cert_path: str | None) -> tuple:
    """(budget_lanes | None, scope_name | None, denominator | None):
    the certified-recall lane budget — ``scenarios_reduced // 4``
    read LIVE from the mc certificate, never hard-coded."""
    scope = BUDGET_SCOPES.get(axis)
    if scope is None:
        return None, None, None
    from tpu_paxos_torch.analysis import modelcheck as mc

    certs = mc.load_certificates(
        *( (cert_path,) if cert_path else () )
    )
    cert = certs.get(scope)
    if not cert or "scenarios_reduced" not in cert:
        return None, scope, None
    denom = int(cert["scenarios_reduced"])
    return denom // BUDGET_DIV, scope, denom


# ---------------------------------------------------------------
# fleet axis
# ---------------------------------------------------------------


def _evolve_fleet(
    n_lanes, generations, base_seed, alphabet, hunt, certified,
    budget, triage_dir, decision_round_max, n_nodes, n_prop,
    fault_kw, max_wedges, logger, device, mesh=None,
):
    from tpu_paxos_torch.core.sim import IDLE_RESTART_ROUNDS
    from tpu_paxos_torch.fleet import envelope as env
    from tpu_paxos_torch.fleet import runner as frun
    from tpu_paxos_torch.harness import shrink as shr
    from tpu_paxos_torch.harness import stress as strs
    from tpu_paxos_torch.telemetry import recorder as telem

    wl_rng = np.random.default_rng(base_seed)
    workload, gates, chains = strs._workload(n_prop, wl_rng)
    protocol = alphabet.protocol()
    fault_kw = dict(
        fault_kw or dict(drop_rate=300, dup_rate=500, max_delay=2)
    )
    cfg = SimConfig(
        n_nodes=n_nodes,
        n_instances=2 * sum(len(w) for w in workload),
        proposers=tuple(range(n_prop)),
        seed=base_seed,
        max_rounds=20_000,
        faults=FaultConfig(**fault_kw),
        **({"protocol": protocol} if protocol is not None else {}),
    )
    # the runner is built here: generation 0's count starts before it
    misses = env.cache_misses()
    runner = env.runner_for(
        cfg, workload, gates, mesh=mesh,
        max_episodes=max(alphabet.max_episodes, frun.MAX_EPISODES),
        telemetry=True, device=device,
    )
    lane_workloads = [(workload, gates)] * n_lanes
    extra = (
        {"decision_round_max": int(decision_round_max)}
        if decision_round_max else {}
    )

    # generation 0: fresh grammar draws (every gene a sample)
    rng0 = np.random.default_rng((base_seed, 0, 11))
    pop = [
        Genome(
            schedule=alphabet.sample(rng0, n_nodes),
            seed=int(rng0.integers(0, 1 << 16)),
            knobs=(
                srch.sample_edge_knobs(
                    rng0, n_nodes, runner.delay_bound,
                    base_drop=cfg.faults.drop_rate,
                )
                if alphabet.wan else None
            ),
        )
        for _ in range(n_lanes)
    ]

    lanes_total = 0
    first_find = None
    first_shrunk = None
    first_artifact = None
    wedges: list = []
    anomalies: list = []
    gen_summaries: list = []
    compiles_per_gen: list = []
    for g in range(generations):
        if (
            certified and budget is not None
            and lanes_total + n_lanes > budget
        ):
            logger.info(
                "certified lane budget (%d) would be exceeded; stopping",
                budget,
            )
            break
        if g:
            misses = env.cache_misses()
        rep = runner.run(
            [gn.seed for gn in pop],
            [gn.schedule for gn in pop],
            workloads=lane_workloads,
            knobs=[gn.knobs or cfg.faults for gn in pop],
        )
        compiles_per_gen.append(env.cache_misses() - misses)
        lanes_total += n_lanes
        real_flagged = set(rep.failing)
        flagged = set(real_flagged)
        if decision_round_max is not None:
            flagged |= {
                i for i in range(n_lanes)
                if int(rep.verdict.max_round[i]) > decision_round_max
            }
        # fitness: per-lane minimum stall margin (LOWER = fitter),
        # flagged lanes dominate, hunted-cause sightings bonus
        ws = getattr(rep, "windows", None)
        if ws is not None:
            margins = telem.lane_stall_margins(ws, IDLE_RESTART_ROUNDS)
        else:
            margins = [0.0] * n_lanes
        scores = [float(m) for m in margins]
        lane_causes = (
            srch.lane_cause_series(rep, range(n_lanes)) if hunt else {}
        )
        for i in range(n_lanes):
            if hunt and hunt in (lane_causes.get(i) or []):
                scores[i] -= CAUSE_BONUS
            if i in flagged:
                scores[i] -= WEDGE_BONUS
        logger.info(
            "generation %d: %d lanes, %d flagged (%.1f lanes/sec)",
            g, n_lanes, len(flagged), rep.lanes_per_sec,
        )
        gen_summaries.append({
            "generation": g,
            "lanes": n_lanes,
            "flagged": len(flagged),
            "best_margin": min(margins) if margins else None,
            "margins": srch._generation_margins(rep, flagged=flagged),
        })
        for i in sorted(flagged):
            if len(wedges) >= max_wedges:
                break
            case = shr.ReproCase(
                cfg=rep.lane_cfg(i), workload=workload, gates=gates,
                chains=chains,
                extra_checks={} if i in real_flagged else dict(extra),
            )
            _, viol = shr.run_case(case, device=device)
            if viol is None:
                anomalies.append({
                    "generation": g, "lane": i, "seed": rep.seeds[i],
                    "verdict": {
                        f: bool(getattr(rep.verdict, f)[i])
                        for f in ("ok", "agreement", "coverage",
                                  "quiescent")
                    },
                })
                continue
            if first_find is None:
                first_find = lanes_total
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
                    triage_dir, f"repro_evolve_g{g}_lane{i}.json"
                )
                try:
                    art = shr.triage(
                        case, path, logger=logger, device=device
                    )
                    wedge["artifact"] = path
                    wedge["shrink_seconds"] = art.get("shrink_seconds")
                    wedge["shrink_evals"] = art.get("shrink_evals")
                    if first_shrunk is None:
                        # the certified accounting: fleet lanes spent
                        # to the find PLUS the shrinker's candidate
                        # evaluations (each one lane of its batched
                        # dispatches)
                        first_shrunk = lanes_total + int(
                            art.get("shrink_evals", 0)
                        )
                        first_artifact = path
                    logger.info("wedge shrunk -> %s", path)
                except Exception as te:
                    wedge["triage_error"] = str(te)[:300]
            wedges.append(wedge)
        if certified and first_shrunk is not None:
            logger.info("certified find complete; stopping early")
            break
        if len(wedges) >= max_wedges and not certified:
            logger.info("wedge budget (%d) reached", max_wedges)
            break
        # next generation
        rng_g = np.random.default_rng((base_seed, g + 1, 11))

        def child(rng, pa, pb):
            sched = crossover_schedules(
                rng, pa.schedule, pb.schedule, alphabet, n_nodes
            )
            sched = mutate_schedule(
                rng, sched, alphabet, n_nodes, hunt=hunt
            )
            seed = (
                pa.seed if int(rng.integers(0, 2))
                else int(rng.integers(0, 1 << 16))
            )
            knobs = None
            if alphabet.wan:
                knobs = (
                    pa.knobs if int(rng.integers(0, 2))
                    else srch.sample_edge_knobs(
                        rng, n_nodes, runner.delay_bound,
                        base_drop=cfg.faults.drop_rate,
                    )
                )
            return Genome(schedule=sched, seed=seed, knobs=knobs)

        def fresh(rng):
            return Genome(
                schedule=fresh_schedule(rng, alphabet, n_nodes, hunt=hunt),
                seed=int(rng.integers(0, 1 << 16)),
                knobs=(
                    srch.sample_edge_knobs(
                        rng, n_nodes, runner.delay_bound,
                        base_drop=cfg.faults.drop_rate,
                    )
                    if alphabet.wan else None
                ),
            )

        pop = select(rng_g, pop, scores, child, make_fresh=fresh)
    return {
        "pop": pop,
        "lanes_total": lanes_total,
        "first_find": first_find,
        "first_shrunk": first_shrunk,
        "first_artifact": first_artifact,
        "wedges": wedges,
        "anomalies": anomalies,
        "generation_telemetry": gen_summaries,
        "compiles_per_generation": compiles_per_gen,
    }


# ---------------------------------------------------------------
# member axis
# ---------------------------------------------------------------


def _evolve_member(
    n_lanes, generations, base_seed, alphabet, hunt, certified,
    budget, triage_dir, n_nodes, n_instances, max_rounds,
    max_wedges, logger, device,
):
    from tpu_paxos_torch.fleet import envelope as env

    alphabet = alphabet.member()
    # the runner is built here: generation 0's count starts before it
    misses = env.cache_misses()
    runner = env.member_runner_for(
        n_nodes, n_instances,
        max_episodes=max(alphabet.max_episodes, 2),
        max_rounds=max_rounds, device=device,
    )
    horizon = min(alphabet.horizon, max_rounds)
    alphabet = dataclasses.replace(alphabet, horizon=horizon)

    def fresh(rng):
        churn = srch.sample_churn_schedule(rng, n_nodes, horizon=horizon)
        return Genome(
            schedule=srch.sample_member_schedule(
                rng, n_nodes, churn=churn,
                max_episodes=alphabet.max_episodes, horizon=horizon,
                kinds=alphabet.kinds,
            ),
            seed=int(rng.integers(0, 1 << 16)),
            churn=churn,
        )

    rng0 = np.random.default_rng((base_seed, 0, 13))
    pop = [fresh(rng0) for _ in range(n_lanes)]

    lanes_total = 0
    first_find = None
    wedges: list = []
    gen_summaries: list = []
    compiles_per_gen: list = []
    for g in range(generations):
        if (
            certified and budget is not None
            and lanes_total + n_lanes > budget
        ):
            logger.info(
                "certified lane budget (%d) would be exceeded; stopping",
                budget,
            )
            break
        if g:
            misses = env.cache_misses()
        rep = runner.run(
            [gn.seed for gn in pop],
            [gn.churn for gn in pop],
            [gn.schedule for gn in pop],
        )
        compiles_per_gen.append(env.cache_misses() - misses)
        lanes_total += n_lanes
        v = rep.verdict
        flagged = set(rep.failing)
        # fitness: MORE rounds = closer to a stall (the round budget
        # is the liveness patience here); red lanes dominate
        scores = [-float(v.rounds[i]) for i in range(n_lanes)]
        for i in sorted(flagged):
            scores[i] -= WEDGE_BONUS
        logger.info(
            "member generation %d: %d lanes, %d flagged "
            "(%.1f lanes/sec)",
            g, n_lanes, len(flagged), rep.lanes_per_sec,
        )
        gen_summaries.append({
            "generation": g,
            "lanes": n_lanes,
            "flagged": len(flagged),
            "rounds_max": int(np.max(v.rounds)) if n_lanes else None,
        })
        for i in sorted(flagged):
            if len(wedges) >= max_wedges:
                break
            if first_find is None:
                first_find = lanes_total
            log_text = rep.lane_log(i)
            cx = {
                "generation": g,
                "lane": i,
                "seed": rep.seeds[i],
                "churn": _genome_dict(pop[i]).get("churn"),
                "schedule": pop[i].schedule.to_dict(),
                "verdict": {
                    "quorum": bool(v.quorum[i]),
                    "catchup": bool(v.catchup[i]),
                    "coverage": bool(v.coverage[i]),
                    "completed": bool(v.completed[i]),
                    "rounds": int(v.rounds[i]),
                },
                "decision_log_sha256": hashlib.sha256(
                    log_text.encode()
                ).hexdigest(),
            }
            if triage_dir:
                os.makedirs(triage_dir, exist_ok=True)
                path = os.path.join(
                    triage_dir, f"evolve_member_g{g}_lane{i}.json"
                )
                with open(path, "w") as f:
                    json.dump(cx, f, indent=1, sort_keys=True)
                    f.write("\n")
                cx["artifact"] = path
            wedges.append(cx)
        if certified and first_find is not None:
            break
        if len(wedges) >= max_wedges and not certified:
            break
        rng_g = np.random.default_rng((base_seed, g + 1, 13))

        def child(rng, pa, pb):
            move = int(rng.integers(0, 4))
            churn = pa.churn
            if move == 0:  # fresh churn draw; schedule re-legalized
                churn = srch.sample_churn_schedule(
                    rng, n_nodes, horizon=horizon
                )
            protected = frozenset({0} | srch.churn_targets(churn))
            sched = crossover_schedules(
                rng, pa.schedule, pb.schedule, alphabet, n_nodes,
                protected=protected,
            )
            if move != 1:  # 1 = crossover-only (inheritance move)
                sched = mutate_schedule(
                    rng, sched, alphabet, n_nodes, hunt=hunt,
                    protected=protected,
                )
            seed = (
                pa.seed if int(rng.integers(0, 2))
                else int(rng.integers(0, 1 << 16))
            )
            return Genome(schedule=sched, seed=seed, churn=churn)

        pop = select(rng_g, pop, scores, child, make_fresh=fresh)
    return {
        "pop": pop,
        "lanes_total": lanes_total,
        "first_find": first_find,
        "first_shrunk": first_find,  # no shrinker on the member axis
        "first_artifact": None,
        "wedges": wedges,
        "anomalies": [],
        "generation_telemetry": gen_summaries,
        "compiles_per_generation": compiles_per_gen,
    }


# ---------------------------------------------------------------
# serve axis
# ---------------------------------------------------------------


def _serve_workload(n_prop: int) -> list:
    """The serve axis's fixed per-tenant vid streams (the genome is
    the LOAD SHAPE, not the values): 10 vids per proposer stream,
    disjoint ranges."""
    return [
        np.arange(20 * t, 20 * t + 10, dtype=np.int32)
        for t in range(n_prop)
    ]


def _evolve_serve(
    n_lanes, generations, base_seed, hunt, triage_dir,
    max_wedges, logger, latency_rounds, budget_milli, device,
):
    from tpu_paxos_torch.fleet import envelope as env
    from tpu_paxos_torch.serve import breach as brch
    from tpu_paxos_torch.serve import harness as sh

    workload = _serve_workload(2)
    cfg = SimConfig(
        n_nodes=3, n_instances=48, proposers=(0, 1), seed=base_seed,
        max_rounds=4000,
    )
    slo = sh.ServeSLO(
        latency_rounds=latency_rounds, budget_milli=budget_milli
    )
    names = brch.WEATHER_NAMES
    # fixed weather slots: lane i's preset never changes (the preset
    # IS the envelope; per-slot lane counts are runner shapes)
    slot_of = [names[i * len(names) // n_lanes] for i in range(n_lanes)]
    rng0 = np.random.default_rng((base_seed, 0, 17))
    pop = [
        brch.sample_serve_genome(rng0, workload, slot_of[i], hunt=hunt)
        for i in range(n_lanes)
    ]
    admit_width = max(len(w) for w in workload)

    lanes_total = 0
    first_find = None
    breaches: list = []
    gen_summaries: list = []
    compiles_per_gen: list = []
    for g in range(generations):
        # the serve runners build inside evaluate, one per preset
        misses = env.cache_misses()
        ev = brch.evaluate(
            cfg, pop, workload, slo=slo, admit_width=admit_width,
            device=device,
        )
        compiles_per_gen.append(env.cache_misses() - misses)
        lanes_total += n_lanes
        # fitness: max windowed burn (HIGHER = fitter); breaching
        # lanes dominate, hunted-cause diagnoses bonus
        scores = [-float(b) for b in ev["burn"]]
        for i in range(n_lanes):
            if hunt and hunt in ev["causes"].get(i, []):
                scores[i] -= CAUSE_BONUS
            if ev["breach"][i]:
                scores[i] -= WEDGE_BONUS
        flagged = [i for i in range(n_lanes) if ev["breach"][i]]
        logger.info(
            "serve generation %d: %d lanes, %d breached "
            "(burn max %.3f)",
            g, n_lanes, len(flagged), max(ev["burn"] or [0.0]),
        )
        gen_summaries.append({
            "generation": g,
            "lanes": n_lanes,
            "flagged": len(flagged),
            "burn_max": max(ev["burn"] or [0.0]),
        })
        for i in flagged:
            if len(breaches) >= max_wedges:
                break
            causes = ev["causes"].get(i, [])
            if first_find is None and (hunt is None or hunt in causes):
                first_find = lanes_total
            rec = {
                "generation": g,
                "lane": i,
                "genome": _genome_dict(pop[i]),
                "burn": float(ev["burn"][i]),
                "causes": causes,
            }
            if triage_dir:
                os.makedirs(triage_dir, exist_ok=True)
                path = os.path.join(
                    triage_dir, f"evolve_serve_g{g}_lane{i}.json"
                )
                with open(path, "w") as f:
                    json.dump(
                        dict(rec, verdict=ev["verdicts"].get(i)),
                        f, indent=1, sort_keys=True, default=str,
                    )
                    f.write("\n")
                rec["artifact"] = path
            breaches.append(rec)
        if len(breaches) >= max_wedges:
            break
        rng_g = np.random.default_rng((base_seed, g + 1, 17))

        def child(rng, pa, pb):
            # per-tenant gene mix (weather slots must match — select
            # runs per slot below, so they always do)
            ks = tuple(
                (pa if int(rng.integers(0, 2)) else pb).kinds[t]
                for t in range(len(pa.kinds))
            )
            rs = tuple(
                (pa if int(rng.integers(0, 2)) else pb).rates[t]
                for t in range(len(pa.rates))
            )
            g2 = dataclasses.replace(pa, kinds=ks, rates=rs)
            return brch.mutate_serve_genome(rng, g2, hunt=hunt)

        # selection runs PER WEATHER SLOT: slot sizes are runner
        # shapes, and crossover across presets would move a genome's
        # envelope
        nxt = list(pop)
        for name in names:
            idx = [i for i in range(n_lanes) if slot_of[i] == name]
            if not idx:
                continue
            sub = select(
                rng_g, [pop[i] for i in idx], [scores[i] for i in idx],
                child,
                make_fresh=lambda rng, name=name: brch.sample_serve_genome(
                    rng, workload, name, hunt=hunt
                ),
            )
            for i, gn in zip(idx, sub):
                nxt[i] = gn
        pop = nxt
    return {
        "pop": pop,
        "lanes_total": lanes_total,
        "first_find": first_find,
        "first_shrunk": first_find,  # no shrinker on the serve axis
        "first_artifact": None,
        "wedges": breaches,
        "anomalies": [],
        "generation_telemetry": gen_summaries,
        "compiles_per_generation": compiles_per_gen,
    }


# ---------------------------------------------------------------
# the loop
# ---------------------------------------------------------------


def evolve(
    axis: str = "fleet",
    n_lanes: int = 8,
    generations: int = 4,
    base_seed: int = 0,
    hunt: str | None = None,
    certified: bool = False,
    triage_dir: str | None = None,
    decision_round_max: int | None = None,
    n_nodes: int = 5,
    n_prop: int = 2,
    fault_kw: dict | None = None,
    max_wedges: int = 4,
    mesh=None,
    verbose: bool = True,
    gray: bool = False,
    wan: bool = False,
    alphabet: srch.Alphabet | None = None,
    cert_path: str | None = None,
    member_nodes: int = 3,
    member_instances: int = 8,
    member_rounds: int = 200,
    serve_latency_rounds: int = 8,
    serve_budget_milli: int = 200,
    device="cuda",
) -> dict:
    """Run the mutate-and-select loop on one axis; returns the
    JSON-ready summary.  ``certified`` flips the exit semantics: the
    run is ok IFF the hunt found (and, on the fleet axis, shrank) a
    wedge within the certificate-derived lane budget, the artifact
    replays byte-identically, and warm compiles are zero.  Runs on
    ``device``; with ``mesh``, the fleet axis's lanes tile its ranks
    (a lane count that does not tile it raises the tile's
    ``ValueError``, as JAX's), and the member and serve axes run
    untiled, as JAX's do."""
    from tpu_paxos_torch.telemetry import diagnose as diag
    from tpu_paxos_torch.utils import device as devm
    from tpu_paxos_torch.utils import log as logm

    if axis not in ("fleet", "member", "serve"):
        raise ValueError(f"unknown axis {axis!r}")
    if hunt is not None:
        if hunt not in diag.CAUSES:
            raise ValueError(
                f"unknown hunt cause {hunt!r} "
                f"(known: {', '.join(diag.CAUSES)})"
            )
    logger = logm.get_logger(
        "evolve", logm.parse_level("INFO" if verbose else "WARN")
    )
    if alphabet is None:
        alphabet = srch.Alphabet.classic(gray=gray, wan=wan)
    budget, budget_scope, denom = _budget_lanes(axis, cert_path)
    if certified and budget is None:
        raise ValueError(
            f"--certified needs a '{BUDGET_SCOPES.get(axis)}' mc "
            "certificate (run make mc-quick / the churn scope first)"
        )
    dev = devm.resolve(device) if mesh is None else mesh.devices[0]
    t0 = time.perf_counter()  # paxlint: allow[DET001] lanes/sec metric only; never reaches artifacts
    if axis == "fleet":
        r = _evolve_fleet(
            n_lanes, generations, base_seed, alphabet, hunt,
            certified, budget, triage_dir, decision_round_max,
            n_nodes, n_prop, fault_kw, max_wedges, logger, dev, mesh,
        )
    elif axis == "member":
        r = _evolve_member(
            n_lanes, generations, base_seed, alphabet, hunt,
            certified, budget, triage_dir, member_nodes,
            member_instances, member_rounds, max_wedges, logger, dev,
        )
    else:
        r = _evolve_serve(
            n_lanes, generations, base_seed, hunt, triage_dir,
            max_wedges, logger, serve_latency_rounds,
            serve_budget_milli, dev,
        )
    seconds = time.perf_counter() - t0  # paxlint: allow[DET001] lanes/sec metric only; never reaches artifacts
    compiles = r["compiles_per_generation"]
    warm = sum(compiles[1:]) if len(compiles) > 1 else 0
    replay_match = None
    if r["first_artifact"] is not None:
        from tpu_paxos_torch.harness import shrink as shr

        replay_match = bool(
            shr.reproduce(r["first_artifact"], device=dev)["match"]
        )
    found_in_budget = (
        r["first_shrunk"] is not None
        and (budget is None or r["first_shrunk"] <= budget)
    )
    if certified:
        cert_ok = (
            found_in_budget
            and warm == 0
            and (replay_match is None or replay_match)
            # the fleet axis MUST have a replayable artifact
            and (axis != "fleet" or replay_match is True)
        )
    else:
        cert_ok = None
    real = [w for w in r["wedges"] if not w.get("synthetic", False)]
    if certified:
        ok = bool(cert_ok)
    else:
        ok = not real and not r["anomalies"]
    return {
        "metric": "evolve",
        "axis": axis,
        "hunt": hunt,
        "base_seed": base_seed,
        "lanes": n_lanes,
        "generations_run": len(compiles),
        "lanes_total": r["lanes_total"],
        "lanes_per_sec": round(
            r["lanes_total"] / max(seconds, 1e-9), 2
        ),
        "seconds": round(seconds, 1),
        "budget_scope": budget_scope,
        "budget_denominator": denom,
        "budget_lanes": budget,
        "lanes_to_first_find": r["first_find"],
        "lanes_to_shrunk_artifact": r["first_shrunk"],
        "artifact": r["first_artifact"],
        "replay_match": replay_match,
        "compiles_per_generation": compiles,
        "warm_compiles": warm,
        "population_sha256": population_sha(r["pop"]),
        "wedges_found": len(r["wedges"]),
        "real_violations": len(real),
        "wedges": r["wedges"],
        "anomalies": r["anomalies"],
        "generation_telemetry": r["generation_telemetry"],
        "certified": cert_ok,
        "ok": ok,
    }


def bench_record(summary: dict, wedge_env: str) -> dict | None:
    """The BENCH_evolve.json record for one certified run — or None
    (WITHHELD) when any guard fails: the find must be inside the
    certificate budget, the artifact must replay byte-identically
    (fleet axis), and generations past the first must have compiled
    nothing."""
    if not summary.get("certified"):
        return None
    return {
        "metric": "evolve_recall",
        "axis": summary["axis"],
        "seeded_wedge": wedge_env,
        "hunt": summary["hunt"],
        "population": summary["lanes"],
        "base_seed": summary["base_seed"],
        "budget_scope": summary["budget_scope"],
        "budget_denominator": summary["budget_denominator"],
        "budget_lanes": summary["budget_lanes"],
        "lanes_to_first_find": summary["lanes_to_first_find"],
        "lanes_to_shrunk_artifact": summary["lanes_to_shrunk_artifact"],
        "replay_match": summary["replay_match"],
        "warm_compiles": summary["warm_compiles"],
        "generations_run": summary["generations_run"],
        "compiles_per_generation": summary["compiles_per_generation"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_paxos_torch evolve",
        description="mutate-and-select wedge hunting: evolve fault/"
        "churn/load genomes over fleet lanes, one dispatch per "
        "generation, certified recall against the mc certificate",
    )
    ap.add_argument("--axis", choices=("fleet", "member", "serve"),
                    default="fleet")
    ap.add_argument("--lanes", type=int, default=0,
                    help="population size (0 = the device's default)")
    ap.add_argument("--generations", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hunt", type=str, default="",
                    help="bias mutation toward the gene families that "
                    "produce this diagnose.py cause label")
    ap.add_argument("--certified", action="store_true",
                    help="certified-recall mode: ok iff the wedge is "
                    "found+shrunk within the mc-certificate lane "
                    "budget, replays byte-identically, and warm "
                    "compiles are zero")
    ap.add_argument("--bench-out", type=str, default="",
                    help="write the BENCH_evolve.json record here "
                    "(withheld unless every certified guard passes)")
    ap.add_argument("--nodes", type=int, default=5)
    ap.add_argument("--proposers", type=int, default=2)
    ap.add_argument("--max-wedges", type=int, default=4)
    ap.add_argument("--decision-round-max", type=int, default=0,
                    help="flag lanes whose latest decision lands "
                    "after this round (synthetic wedge knob; 0 = off)")
    ap.add_argument("--gray", action="store_true")
    ap.add_argument("--wan", action="store_true")
    ap.add_argument("--triage-dir", type=str, default="")
    ap.add_argument("--cert-file", type=str, default="",
                    help="mc certificate path (default: the "
                    "committed analysis/mc_certificate.json)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--mesh", type=int, default=0,
                    help="tile the lane axis over this many ranks (the "
                    "lane count is padded to tile it)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    from tpu_paxos_torch.fleet import runner as frun

    mesh = None
    if args.mesh:
        from tpu_paxos_torch.parallel import mesh as pm

        mesh = pm.make_instance_mesh(args.mesh, device=args.device)
    n_lanes = args.lanes or frun.default_lane_count(args.device)
    if mesh is not None:
        n_lanes += (-n_lanes) % mesh.size
    summary = evolve(
        axis=args.axis,
        n_lanes=n_lanes,
        generations=args.generations,
        base_seed=args.seed,
        hunt=args.hunt or None,
        certified=args.certified,
        triage_dir=args.triage_dir or None,
        decision_round_max=args.decision_round_max or None,
        n_nodes=args.nodes,
        n_prop=args.proposers,
        max_wedges=args.max_wedges,
        mesh=mesh,
        verbose=not args.quiet,
        gray=args.gray,
        wan=args.wan,
        cert_path=args.cert_file or None,
        device=args.device,
    )
    if args.bench_out:
        wedge = os.environ.get("TPU_PAXOS_SEEDED_WEDGE", "")
        rec = bench_record(summary, wedge)
        if rec is None:
            print(
                "bench record WITHHELD: certified guards failed",
                file=sys.stderr,
            )
        else:
            with open(args.bench_out, "w") as f:
                json.dump(rec, f, indent=1, sort_keys=True)
                f.write("\n")
    print(json.dumps(summary, sort_keys=True))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
