"""Serve-axis breach fitness for the selection loop on the port (port of
``tpu_paxos/serve/breach.py``; ``fleet/evolve``).

The liveness axis hunts wedges with fault-schedule genomes; this
module is its serve-side twin: a genome here is an OFFERED-LOAD shape
(per-tenant arrival process + rate + seeds) under a quantized
"weather" preset, and fitness is the windowed SLO burn rate the
recorder already emits — how close that load shape drove some window
to its error budget.  The serve engines take NO fault schedule (the
i.i.d. drop/dup/delay knobs are constants of the envelope's runner
build), so weather cannot be a free per-lane gene: it is drawn
from the small :data:`WEATHERS` preset table, the population is
partitioned into fixed-size weather slots, and one generation costs
one ``serve_fleet_run`` dispatch PER PRESET through the shared
envelope cache — every preset builds its runner in generation 0 and
never again (``fleet/envelope.cache_misses``, pinned by
tests/test_torch_evolve.py).

Per-genome fitness keeps the lane axis (``telemetry.recorder.
lane_burn_rates``) so selection credits the genome that burned, and
breaching lanes carry the judge's diagnosis block — the stable cause
names ``--hunt`` steers toward (``saturation`` is the serve-reachable
family: backlog growth under queue-dominated latency).

:func:`evaluate` takes ``device`` (default ``"cuda"``; no fallback) and
reads each preset dispatch's windowed latency histograms to the host in
one copy.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpu_paxos_torch.config import FaultConfig, SimConfig
from tpu_paxos_torch.serve import arrivals as arrv
from tpu_paxos_torch.serve import fleet as sfl
from tpu_paxos_torch.serve import harness as sh
from tpu_paxos_torch.telemetry import recorder as telem

#: Quantized weather presets (name -> FaultConfig knobs).  Each preset
#: is ONE envelope runner build; keep this table SMALL and append-only —
#: every entry the population uses is paid for in generation 0.
#: Rates are per 10_000 (config.FaultConfig semantics).
WEATHERS = (
    ("calm", dict(drop_rate=0, dup_rate=0, max_delay=1)),
    ("breezy", dict(drop_rate=500, dup_rate=1000, max_delay=2)),
    ("squall", dict(drop_rate=2000, dup_rate=1000, max_delay=3)),
)
WEATHER_NAMES = tuple(n for n, _ in WEATHERS)

#: Arrival-process gene alphabet (names of the deterministic samplers
#: in serve/arrivals.py).  ``immediate`` is offered-load-infinity.
ARRIVAL_KINDS = ("immediate", "poisson", "bursty", "spike")

#: Offered-rate gene grid, values per 1000 rounds (quantized so the
#: mutation step is a tier move, like the WAN knob tiers).
RATE_GRID = (250, 500, 1000, 2000, 4000)

#: Cause family -> the arrival kinds whose load shape can produce it
#: on the serve axis (the hunt bias table; mirrors evolve's
#: CAUSE_FAMILIES for fault kinds).  Only ``saturation`` is
#: load-reachable — the others need fault schedules the serve engine
#: does not take.
HUNT_KINDS = {"saturation": ("bursty", "spike", "immediate")}


@dataclasses.dataclass(frozen=True)
class ServeGenome:
    """One serve-lane individual: a weather slot plus the load shape.
    ``kinds``/``rates`` are per-tenant (one entry per workload
    stream); ``aseed`` seeds the arrival processes, ``seed`` the
    engine."""

    weather: str
    kinds: tuple
    rates: tuple
    aseed: int
    seed: int

    def __post_init__(self):
        if self.weather not in WEATHER_NAMES:
            raise ValueError(f"unknown weather {self.weather!r}")
        if len(self.kinds) != len(self.rates):
            raise ValueError("kinds/rates must be per-tenant parallel")
        for k in self.kinds:
            if k not in ARRIVAL_KINDS:
                raise ValueError(f"unknown arrival kind {k!r}")
        for r in self.rates:
            if r not in RATE_GRID:
                raise ValueError(f"rate {r} off the RATE_GRID")


def weather_cfg(cfg: SimConfig, weather: str) -> SimConfig:
    """The base config under one weather preset (replaces the whole
    fault layer — serve engines reject schedules anyway)."""
    kw = dict(WEATHERS)[weather]
    return dataclasses.replace(cfg, faults=FaultConfig(**kw))


def _rounds(kind: str, n: int, rate: int, seed: int) -> np.ndarray:
    if kind == "immediate":
        return arrv.immediate_rounds(n)
    if kind == "poisson":
        return arrv.poisson_rounds(n, rate, seed)
    if kind == "bursty":
        return arrv.bursty_rounds(n, rate, seed)
    if kind == "spike":
        return arrv.spike_rounds(n, rate, seed)
    raise ValueError(f"unknown arrival kind {kind!r}")


def lane_of(genome: ServeGenome, workload) -> sfl.ServeLane:
    """Express one genome as a ServeLane over the shared workload:
    per-tenant arrival rounds drawn by the genome's kind/rate genes
    (tenant t's process seeded at ``aseed*131 + t`` so tenants are
    independent but the genome is one deterministic point)."""
    if len(genome.kinds) != len(workload):
        raise ValueError(
            f"genome has {len(genome.kinds)} tenants; workload has "
            f"{len(workload)}"
        )
    arrs = [
        np.sort(_rounds(k, len(wl), r, genome.aseed * 131 + t))
        for t, (k, r, wl) in enumerate(
            zip(genome.kinds, genome.rates, workload)
        )
    ]
    return sfl.ServeLane(workload, arrs, genome.seed)


def sample_serve_genome(
    rng, workload, weather: str, hunt: str | None = None,
    seed_span: int = 1 << 16,
) -> ServeGenome:
    """Draw one individual for a weather slot.  ``hunt`` biases the
    per-tenant kind draw toward :data:`HUNT_KINDS`' family for that
    cause (uniform over the family; uniform over all kinds
    otherwise)."""
    kinds = HUNT_KINDS.get(hunt, ARRIVAL_KINDS)
    ks = tuple(kinds[int(rng.integers(0, len(kinds)))] for _ in workload)
    rs = tuple(
        RATE_GRID[int(rng.integers(0, len(RATE_GRID)))] for _ in workload
    )
    return ServeGenome(
        weather=weather, kinds=ks, rates=rs,
        aseed=int(rng.integers(0, seed_span)),
        seed=int(rng.integers(0, seed_span)),
    )


def mutate_serve_genome(
    rng, g: ServeGenome, hunt: str | None = None,
    seed_span: int = 1 << 16,
) -> ServeGenome:
    """One mutation step: pick a gene family (kind flip, rate tier
    step, arrival reseed, engine reseed) and move it.  The weather
    slot NEVER mutates — it is the envelope partition (a weather flip
    would be a new runner build, breaking the zero-warm-build
    contract)."""
    move = int(rng.integers(0, 4))
    if move == 0:
        t = int(rng.integers(0, len(g.kinds)))
        kinds = HUNT_KINDS.get(hunt, ARRIVAL_KINDS)
        ks = list(g.kinds)
        ks[t] = kinds[int(rng.integers(0, len(kinds)))]
        return dataclasses.replace(g, kinds=tuple(ks))
    if move == 1:
        t = int(rng.integers(0, len(g.rates)))
        i = RATE_GRID.index(g.rates[t])
        step = 1 if rng.integers(0, 2) else -1
        rs = list(g.rates)
        rs[t] = RATE_GRID[min(max(i + step, 0), len(RATE_GRID) - 1)]
        return dataclasses.replace(g, rates=tuple(rs))
    if move == 2:
        return dataclasses.replace(
            g, aseed=int(rng.integers(0, seed_span))
        )
    return dataclasses.replace(g, seed=int(rng.integers(0, seed_span)))


def evaluate(
    cfg: SimConfig,
    genomes,
    workload,
    *,
    slo: sh.ServeSLO,
    rounds_per_window: int = sh.ROUNDS_PER_WINDOW,
    windows_per_dispatch: int = sh.WINDOWS_PER_DISPATCH,
    admit_width: int | None = None,
    mesh=None,
    device="cuda",
) -> dict:
    """One generation's serve fitness: group the population by
    weather slot (preserving genome order within each), run ONE
    ``serve_fleet_run`` dispatch per preset present through the
    shared envelope cache on ``device``, and scatter per-lane results
    back to genome order.  ``mesh`` tiles each dispatch's lanes over its
    ranks: a preset's group whose size does not tile it raises the tile's
    ``ValueError``, as JAX's.

    Returns ``{"burn": [n] float, "breach": [n] bool,
    "causes": {genome_index: [cause names]},
    "verdicts": {genome_index: slo verdict}}`` — ``burn`` is the
    max-over-windows burn rate at the SLO's threshold (higher =
    fitter for breach hunting), ``causes`` only for flagged lanes
    whose judge attached a diagnosis."""
    genomes = list(genomes)
    n = len(genomes)
    burn = [0.0] * n
    breach = [False] * n
    causes: dict = {}
    verdicts: dict = {}
    for name, _ in WEATHERS:
        idx = [i for i, g in enumerate(genomes) if g.weather == name]
        if not idx:
            continue
        wcfg = weather_cfg(cfg, name)
        lanes = [lane_of(genomes[i], workload) for i in idx]
        rep = sfl.serve_fleet_run(
            wcfg, lanes,
            rounds_per_window=rounds_per_window,
            windows_per_dispatch=windows_per_dispatch,
            admit_width=admit_width, slo=slo, mesh=mesh, device=device,
        )
        # one copy per completed preset dispatch, never per lane
        rates = telem.lane_burn_rates(
            # paxlint: allow[JAX103] one copy a weather preset's dispatch, never a lane
            rep.windows.lat_hist.cpu().numpy(),
            slo.latency_rounds, slo.budget_milli,
        )
        # paxlint: allow[JAX103] one copy a weather preset's dispatch, never a lane
        flags = np.asarray(rep.breach)
        for li, gi in enumerate(idx):
            burn[gi] = float(rates[li])
            breach[gi] = bool(flags[li])
            v = (rep.slo or {}).get(li)
            if v is not None:
                verdicts[gi] = v
                diag = v.get("diagnosis")
                if diag:
                    causes[gi] = list(diag.get("causes", []))
    return {
        "burn": burn, "breach": breach,
        "causes": causes, "verdicts": verdicts,
    }
