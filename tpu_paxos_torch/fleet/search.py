"""The schedule-search grammar's samplers (port of the samplers of
``tpu_paxos/fleet/search.py``): seeded numpy draws of episode schedules
and per-edge fault matrices, the same draw sequence as the JAX package's
for the same ``np.random.Generator`` state.  The search loop itself
(``search()``) waits for the flight recorder."""

from __future__ import annotations

import dataclasses

import numpy as np

from tpu_paxos_torch.config import EdgeFaultConfig, FaultConfig, ProtocolConfig
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
