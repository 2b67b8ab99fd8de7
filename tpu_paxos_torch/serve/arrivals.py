"""Arrival processes and the window-quantized admission plan (the
port's own copy of ``tpu_paxos/serve/arrivals.py``; numpy only, the same
draws seed for seed).

Open-loop load is expressed on the VIRTUAL clock: an arrival process
assigns each value an arrival round, and the serve harness admits a
value at the first dispatch-window boundary at or after its arrival
(window quantization is part of the serving latency — a value
arriving mid-window waits for the next upload, exactly like a request
waiting for the next batch in a batched serving system).  Keeping
load in rounds makes every run deterministic and replayable: the same
(seed, rate) always produces the same admission timeline, so the
pipelined and sequential dispatch modes run bit-identical protocol
trajectories and differ only in wall clock.

Offered load is an integer ``rate_milli`` — values per 1000 rounds —
so sweep points serialize exactly in JSON.  The offered-load-∞ limit
(every value arrives at round 0, the zero-load parity shape: the serve
path must then be decision-log-identical to the closed-loop engine) is
:func:`immediate_rounds`.
"""

from __future__ import annotations

import numpy as np

#: ``core/values.NONE`` (-1), kept local: the admission plan runs on the
#: ingestion thread of a serving host and imports nothing but numpy.
NONE = -1


def poisson_rounds(n_values: int, rate_milli: int, seed: int) -> np.ndarray:
    """Sorted int32 arrival rounds of a Poisson process at
    ``rate_milli`` values per 1000 rounds: exponential inter-arrival
    gaps with mean ``1000/rate_milli`` rounds, cumulated and floored
    to the round grid.  Deterministic per (n_values, rate_milli,
    seed)."""
    if rate_milli <= 0:
        raise ValueError(
            f"rate_milli must be positive (got {rate_milli}); use "
            "immediate_rounds() for the offered-load-∞ limit"
        )
    # domain-separated from every other harness rng (seed tuples mix
    # like SeedSequence spawn keys)
    rng = np.random.default_rng((0x53455256, int(seed)))
    gaps = rng.exponential(1000.0 / rate_milli, size=int(n_values))
    return np.floor(np.cumsum(gaps)).astype(np.int32)


def pareto_rounds(
    n_values: int, rate_milli: int, seed: int, alpha: float = 1.5
) -> np.ndarray:
    """Heavy-tailed arrivals: Lomax (Pareto-II) inter-arrival gaps
    with tail index ``alpha`` scaled to the same MEAN gap as
    :func:`poisson_rounds` at ``rate_milli`` (``alpha`` must exceed 1
    or the mean diverges) — long quiet stretches punctuated by
    clustered arrivals, the classic open-internet traffic shape the
    exponential's memorylessness cannot produce.  Deterministic per
    (n_values, rate_milli, seed, alpha)."""
    if rate_milli <= 0:
        raise ValueError(
            f"rate_milli must be positive (got {rate_milli}); use "
            "immediate_rounds() for the offered-load-∞ limit"
        )
    if alpha <= 1.0:
        raise ValueError(
            f"alpha must exceed 1 (got {alpha}); at alpha <= 1 the "
            "Lomax mean diverges and rate_milli means nothing"
        )
    rng = np.random.default_rng((0x50415245, int(seed)))
    mean = 1000.0 / rate_milli
    # Lomax mean = scale / (alpha - 1)  =>  scale pins the offered rate
    gaps = rng.pareto(alpha, size=int(n_values)) * (mean * (alpha - 1.0))
    return np.floor(np.cumsum(gaps)).astype(np.int32)


def bursty_rounds(
    n_values: int, rate_milli: int, seed: int, burst: int = 8
) -> np.ndarray:
    """Bursty arrivals: values arrive in geometric-size bursts (mean
    ``burst`` values sharing ONE arrival round) separated by
    exponential gaps scaled so the long-run offered rate is still
    ``rate_milli`` values per 1000 rounds — the batched-upstream shape
    (a replicating shard, a client-side retry storm) that stresses
    admission-window quantization hardest.  Deterministic per
    (n_values, rate_milli, seed, burst)."""
    if rate_milli <= 0:
        raise ValueError(
            f"rate_milli must be positive (got {rate_milli}); use "
            "immediate_rounds() for the offered-load-∞ limit"
        )
    if burst < 1:
        raise ValueError(f"burst must be >= 1 (got {burst})")
    rng = np.random.default_rng((0x42555253, int(seed)))
    n = int(n_values)
    sizes = rng.geometric(1.0 / burst, size=n)  # mean `burst`, >= 1
    # truncate the burst train at exactly n values (sizes are >= 1,
    # so n bursts always cover n values)
    counts = np.clip(n - (np.cumsum(sizes) - sizes), 0, sizes)
    keep = counts > 0
    sizes, counts = sizes[keep], counts[keep]
    # burst START gaps: mean burst arrivals per gap at the target rate
    gaps = rng.exponential(1000.0 / rate_milli * burst, size=len(sizes))
    starts = np.floor(np.cumsum(gaps)).astype(np.int64)
    return np.repeat(starts, counts)[:n].astype(np.int32)


def diurnal_rounds(
    n_values: int, rate_milli: int, seed: int,
    period: int = 2048, depth: float = 0.8,
) -> np.ndarray:
    """Diurnal arrivals: an inhomogeneous Poisson process whose rate
    swings sinusoidally around ``rate_milli`` (peak ``1 + depth``,
    trough ``1 - depth`` of the mean) with period ``period`` rounds —
    the day/night load curve a fleet controller must ride.  Sampled
    exactly by time-warping a unit-rate process through the inverse
    integrated-rate function (bisection on the monotone cumulative
    rate; no thinning, so the draw count is deterministic).
    Deterministic per (n_values, rate_milli, seed, period, depth)."""
    if rate_milli <= 0:
        raise ValueError(
            f"rate_milli must be positive (got {rate_milli}); use "
            "immediate_rounds() for the offered-load-∞ limit"
        )
    if not (0.0 <= depth < 1.0):
        raise ValueError(f"depth must be in [0, 1) (got {depth})")
    if period < 2:
        raise ValueError(f"period must be >= 2 (got {period})")
    rng = np.random.default_rng((0x44495552, int(seed)))
    base = rate_milli / 1000.0  # values per round
    if int(n_values) == 0:
        return np.zeros((0,), np.int32)
    unit = np.cumsum(rng.exponential(1.0, size=int(n_values)))

    def cum_rate(t):
        # integral of base * (1 + depth * sin(2 pi t / period))
        w = 2.0 * np.pi / period
        return base * (t + depth * (1.0 - np.cos(w * t)) / w)

    lo = np.zeros_like(unit)
    hi = np.full_like(unit, unit[-1] / (base * (1.0 - depth)) + period)
    for _ in range(64):  # bisection to well under round resolution
        mid = 0.5 * (lo + hi)
        below = cum_rate(mid) < unit
        lo = np.where(below, mid, lo)
        hi = np.where(below, hi, mid)
    return np.floor(hi).astype(np.int32)


def spike_rounds(
    n_values: int, rate_milli: int, seed: int,
    factor: int = 8, start_frac: float = 0.375, len_frac: float = 0.25,
) -> np.ndarray:
    """Load-spike arrivals: a Poisson process at ``rate_milli`` whose
    rate multiplies by ``factor`` over one contiguous mid-run span —
    the flash-crowd shape the admission controller
    (``serve/control.py``) is judged against.  The spike spans
    ``[start_frac, start_frac + len_frac)`` of the BASE-rate horizon
    (``1000 * n_values / rate_milli`` rounds), so the same fractions
    mean the same story at every rate.  Sampled exactly by inverting
    the piecewise-linear cumulative rate in closed form (no thinning
    — the draw count is deterministic).  Deterministic per
    (n_values, rate_milli, seed, factor, start_frac, len_frac)."""
    if rate_milli <= 0:
        raise ValueError(
            f"rate_milli must be positive (got {rate_milli}); use "
            "immediate_rounds() for the offered-load-∞ limit"
        )
    if factor < 1:
        raise ValueError(f"factor must be >= 1 (got {factor})")
    if not (0.0 <= start_frac and 0.0 < len_frac):
        raise ValueError("spike span fractions must be positive")
    rng = np.random.default_rng((0x5350494B, int(seed)))
    base = rate_milli / 1000.0  # values per round
    if int(n_values) == 0:
        return np.zeros((0,), np.int32)
    horizon = n_values / base
    t0, t1 = start_frac * horizon, (start_frac + len_frac) * horizon
    unit = np.cumsum(rng.exponential(1.0, size=int(n_values)))
    # cumulative rate: base*t before t0; slope base*factor inside
    # [t0, t1); base again after — invert piecewise
    u0 = base * t0
    u1 = u0 + base * factor * (t1 - t0)
    t = np.where(
        unit <= u0,
        unit / base,
        np.where(
            unit <= u1,
            t0 + (unit - u0) / (base * factor),
            t1 + (unit - u1) / base,
        ),
    )
    return np.floor(t).astype(np.int32)


#: Name -> builder map for the CLI's --arrivals flag (every builder
#: shares the (n_values, rate_milli, seed) signature; extra shape
#: knobs keep their defaults there).
ARRIVAL_BUILDERS = {
    "poisson": poisson_rounds,
    "pareto": pareto_rounds,
    "bursty": bursty_rounds,
    "diurnal": diurnal_rounds,
    "spike": spike_rounds,
}


def tier_priorities(vids, n_tiers: int = 3) -> np.ndarray:
    """A declared per-value priority column: tier ``vid % n_tiers``
    (0 = most important, higher tiers shed/defer first under the
    admission controller's degradation).  Deterministic and
    value-derived so replays reconstruct it from the artifact; real
    deployments would declare tiers per request class the same way."""
    if n_tiers < 1:
        raise ValueError(f"n_tiers must be >= 1 (got {n_tiers})")
    return (np.asarray(vids, np.int64) % int(n_tiers)).astype(np.int32)


def immediate_rounds(n_values: int) -> np.ndarray:
    """The offered-load-∞ limit: every value arrives at round 0 (all
    admitted in window 0 — the zero-load parity shape)."""
    return np.zeros((int(n_values),), np.int32)


def trace_rounds(rounds) -> np.ndarray:
    """Trace replay: an explicit arrival-round sequence.  Must be
    nondecreasing and nonnegative (arrival order is admission order —
    the queue is FIFO per proposer)."""
    arr = np.asarray(rounds, np.int32).reshape(-1)
    if arr.size and int(arr.min()) < 0:
        raise ValueError("trace arrival rounds must be nonnegative")
    if np.any(np.diff(arr) < 0):
        raise ValueError("trace arrival rounds must be nondecreasing")
    return arr


def split_round_robin(vids: np.ndarray, rounds: np.ndarray, n_prop: int):
    """Deal a single (vid, arrival-round) stream round-robin over the
    proposers in arrival order; per-proposer subsequences stay sorted.
    Returns ``(streams, arrs)`` — lists of per-proposer arrays."""
    vids = np.asarray(vids, np.int32).reshape(-1)
    rounds = np.asarray(rounds, np.int32).reshape(-1)
    if vids.shape != rounds.shape:
        raise ValueError("one arrival round per vid required")
    streams = [vids[p::n_prop] for p in range(n_prop)]
    arrs = [rounds[p::n_prop] for p in range(n_prop)]
    return streams, arrs


class ArrivalPlan:
    """The window-quantized admission plan: which values each dispatch
    window uploads, per proposer.

    Window ``j`` covers rounds ``[j*R, (j+1)*R)`` and its admission
    happens at round ``j*R``, BEFORE the window's rounds run — so it
    may admit exactly the values with ``arrival <= j*R`` not yet
    admitted (a value arriving strictly inside a window waits for the
    next boundary; one arriving at the boundary makes the upload).
    Every block is a NONE-padded value prefix per proposer row, ready
    for :func:`tpu_paxos_torch.core.sim.admit_block`.

    ``prios`` is the optional PRIORITY COLUMN (one int tier per value,
    parallel to ``streams``; 0 = most important): the plain plan
    ignores it for admission — window quantization treats every tier
    alike — but carries it per block (:meth:`prio_block`) so the
    admission controller (``serve/control.py``) can shed or defer at
    declared tiers while deferred values keep their TRUE arrival
    rounds from this plan's ``arrs`` (they charge their real
    queue-wait through the ingest stamps)."""

    def __init__(self, streams, arrs, rounds_per_window: int, prios=None):
        if len(streams) != len(arrs):
            raise ValueError("one arrival array per proposer stream")
        self.streams = [np.asarray(s, np.int32).reshape(-1) for s in streams]
        self.arrs = [trace_rounds(a) for a in arrs]
        for s, a in zip(self.streams, self.arrs):
            if s.shape != a.shape:
                raise ValueError("one arrival round per stream value")
        if prios is None:
            self.prios = None
        else:
            if len(prios) != len(self.streams):
                raise ValueError("one priority array per proposer stream")
            self.prios = [np.asarray(p, np.int32).reshape(-1) for p in prios]
            for s, p in zip(self.streams, self.prios):
                if s.shape != p.shape:
                    raise ValueError("one priority tier per stream value")
                if p.size and int(p.min()) < 0:
                    raise ValueError("priority tiers must be nonnegative")
        if rounds_per_window <= 0:
            raise ValueError("rounds_per_window must be positive")
        self.rounds_per_window = int(rounds_per_window)
        # cut[p][j]: values of proposer p admitted by the start of
        # window j (cumulative); the final window admits everything.
        horizon = max(
            (int(a[-1]) for a in self.arrs if a.size), default=0
        )
        # the last admission window's boundary must reach the latest
        # arrival: ceil(horizon / R) + 1 windows, indices 0..ceil
        r = self.rounds_per_window
        self.n_windows = (horizon + r - 1) // r + 1
        # _cuts[p][j] .. _cuts[p][j+1]: the stream slice window j
        # uploads — cumulative arrivals <= j*R, leading 0 so window 0
        # takes exactly the round-0 arrivals
        self._cuts = [
            np.concatenate([
                [0],
                np.searchsorted(
                    a,
                    np.arange(self.n_windows) * r,
                    side="right",
                ),
            ])
            for a in self.arrs
        ]

    @property
    def n_values(self) -> int:
        return sum(len(s) for s in self.streams)

    @property
    def max_block(self) -> int:
        """Largest per-proposer admission count of any window — the
        floor for the driver's static ``admit_width``."""
        widest = 0
        for cuts in self._cuts:
            widest = max(widest, int(np.diff(cuts).max(initial=0)))
        return max(widest, 1)

    def block(self, j: int, admit_width: int):
        """Window ``j``'s upload: ``(admit [P, K], arr [P, K])`` int32
        — vids as a NONE-padded prefix per row, their arrival rounds
        alongside (0 in padding slots; the stamp scatter drops them).
        Windows past the plan return empty blocks (the drain phase)."""
        p = len(self.streams)
        admit = np.full((p, admit_width), NONE, np.int32)
        arr = np.zeros((p, admit_width), np.int32)
        if j >= self.n_windows:
            return admit, arr
        for pi in range(p):
            lo, hi = int(self._cuts[pi][j]), int(self._cuts[pi][j + 1])
            n = hi - lo
            if n > admit_width:
                raise ValueError(
                    f"window {j} admits {n} values for proposer {pi}; "
                    f"admit_width {admit_width} is too narrow "
                    "(use >= plan.max_block)"
                )
            admit[pi, :n] = self.streams[pi][lo:hi]
            arr[pi, :n] = self.arrs[pi][lo:hi]
        return admit, arr

    def prio_block(self, j: int, admit_width: int) -> np.ndarray:
        """Window ``j``'s priority tiers, ``[P, K]`` int32 aligned
        with :meth:`block`'s layout (0 in padding slots).  Requires a
        declared priority column."""
        if self.prios is None:
            raise ValueError("this plan declares no priority column")
        p = len(self.streams)
        out = np.zeros((p, admit_width), np.int32)
        if j >= self.n_windows:
            return out
        for pi in range(p):
            lo, hi = int(self._cuts[pi][j]), int(self._cuts[pi][j + 1])
            out[pi, :hi - lo] = self.prios[pi][lo:hi]
        return out
