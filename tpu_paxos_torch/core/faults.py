"""The port's own copy of ``tpu_paxos/core/faults.py`` (jax-free there
too): the port imports nothing of the JAX package.

Correlated fault schedules: deterministic, round-interval episodes.

The i.i.d. layer (``config.FaultConfig``: per-message drop/dup/delay,
per-node fail-stop crashes) reproduces the reference's ``THNetWork`` +
``RandomFailure`` model — but real consensus deployments die to
*correlated* faults the reference never injects: network partitions,
asymmetric (one-way) links, GC-style node pauses, and burst-loss
windows.  This module adds that layer as a ``FaultSchedule`` of
*episodes*, each active over a half-open round interval ``[t0, t1)``:

- ``partition(t0, t1, *groups)`` — symmetric partition: nodes in
  different groups cannot exchange messages in either direction
  (nodes listed in no group form one implicit extra group);
- ``one_way(t0, t1, src, dst)`` — asymmetric link cut: messages from
  ``src`` nodes to ``dst`` nodes are lost, the reverse direction
  stays up;
- ``pause(t0, t1, *nodes)`` — node pause (a long GC / VM migration):
  ALL of the node's I/O is suppressed while paused, but unlike a
  crash its state is preserved and it resumes at ``t1``;
- ``burst(t0, t1, drop_rate)`` — loss burst: ``drop_rate``/1e4 is
  ADDED to the i.i.d. drop rate inside the window (clamped to 1e4);
- ``crash(t0, *nodes)`` — deterministic fail-stop CRASH POINT: the
  nodes fail-stop at the end of round ``t0`` (the same
  takes-effect-next-round timing as the i.i.d. crash injection) and
  never return — unlike every other kind a crash does not heal, so
  its interval is the single round ``[t0, t0+1)`` and the liveness
  contract's crash excusals apply exactly as for sampled crashes.
  This is the model checker's deterministic crash axis
  (analysis/modelcheck.py): a (node, round) grid instead of a rate.
- ``gray(t0, t1, *nodes, delay=k)`` — GRAY FAILURE: the nodes are
  *slow*, not dead.  Every message a gray node sends or receives
  while the episode is active has ``k`` extra rounds added to its
  sampled delay (sums along an edge when both ends are gray, and
  across overlapping gray episodes), clamped at the engine's arrival
  ring bound (``cfg.faults.max_delay``) — gray NEVER drops a
  message, which is exactly what makes gray failures invisible to
  crash- and pause-shaped detectors.  Like a pause the node heals at
  ``t1`` with its state intact; unlike a pause it keeps acting every
  round, just at WAN-shaped latency.

Episodes compose: overlapping cuts AND their reachability, pauses OR,
burst rates add, crash sets union (and stay crashed forever), gray
inflations ADD per node.  :func:`compile_schedule` lowers a schedule
to dense per-round numpy tables that the general engine
(``core/sim.py``) reads with ``min(t, horizon)``.

Liveness contract (enforced by the engines): paused nodes are excused
only *while* paused, and quiescence is never declared before the last
heal — convergence is owed within ``max_rounds`` rounds past the
final episode end (``SimConfig.round_budget``).

Schedules are plain data (tuples of ints) so they serialize to JSON —
the unit of the stress harness's shrink-and-repro artifacts
(``harness/shrink.py``) — and hash/compare structurally, so they can
be baked statically into an engine closure.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

KINDS = ("partition", "one_way", "pause", "burst", "crash", "gray")


@dataclasses.dataclass(frozen=True)
class Episode:
    """One correlated-fault episode, active over rounds [t0, t1)."""

    kind: str
    t0: int
    t1: int
    groups: tuple[tuple[int, ...], ...] = ()  # partition
    src: tuple[int, ...] = ()  # one_way
    dst: tuple[int, ...] = ()  # one_way
    nodes: tuple[int, ...] = ()  # pause / crash / gray
    drop_rate: int = 0  # burst, per 1e4, added to FaultConfig.drop_rate
    delay: int = 0  # gray, extra delay rounds per affected message

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"unknown episode kind {self.kind!r}")
        if not 0 <= self.t0 < self.t1:
            raise ValueError(
                f"episode interval [{self.t0}, {self.t1}) must be "
                "non-empty and start at round >= 0"
            )
        # canonicalize container args so episodes hash/compare stably
        object.__setattr__(
            self, "groups", tuple(tuple(int(x) for x in g) for g in self.groups)
        )
        for f in ("src", "dst", "nodes"):
            object.__setattr__(
                self, f, tuple(sorted(int(x) for x in getattr(self, f)))
            )
        if self.kind == "partition":
            flat = [x for g in self.groups for x in g]
            if not self.groups or not all(self.groups):
                raise ValueError("partition needs non-empty groups")
            if len(flat) != len(set(flat)):
                raise ValueError("partition groups must be disjoint")
        if self.kind == "one_way" and (not self.src or not self.dst):
            raise ValueError("one_way needs non-empty src and dst")
        if self.kind == "pause" and not self.nodes:
            raise ValueError("pause needs at least one node")
        if self.kind == "burst" and not 0 < self.drop_rate <= 10_000:
            raise ValueError("burst drop_rate must be in (0, 10000]")
        if self.kind == "crash":
            if not self.nodes:
                raise ValueError("crash needs at least one node")
            if self.t1 != self.t0 + 1:
                # crashes are permanent — a wider interval would imply
                # a heal that never happens
                raise ValueError(
                    "crash episodes are instants: t1 must be t0 + 1"
                )
        if self.kind == "gray":
            if not self.nodes:
                raise ValueError("gray needs at least one node")
            if self.delay < 1:
                raise ValueError("gray delay must be >= 1 round")

    def shifted(self, t0: int, t1: int) -> "Episode":
        """Same episode over a different interval (the shrinker's
        interval-narrowing move)."""
        return dataclasses.replace(self, t0=t0, t1=t1)

    def _max_node(self) -> int:
        return max(
            [x for g in self.groups for x in g]
            + list(self.src) + list(self.dst) + list(self.nodes)
            + [0]
        )


def partition(t0: int, t1: int, *groups) -> Episode:
    """Symmetric partition: nodes in different groups are mutually
    unreachable during [t0, t1); unlisted nodes form one implicit
    extra group."""
    return Episode("partition", t0, t1, groups=tuple(tuple(g) for g in groups))


def one_way(t0: int, t1: int, src, dst) -> Episode:
    """One-way link cut: src -> dst messages are lost during [t0, t1)."""
    return Episode("one_way", t0, t1, src=tuple(src), dst=tuple(dst))


def pause(t0: int, t1: int, *nodes) -> Episode:
    """Pause nodes during [t0, t1): state preserved, all I/O suppressed."""
    return Episode("pause", t0, t1, nodes=tuple(nodes))


def burst(t0: int, t1: int, drop_rate: int) -> Episode:
    """Loss burst: add drop_rate/1e4 to the i.i.d. drop rate in [t0, t1)."""
    return Episode("burst", t0, t1, drop_rate=drop_rate)


def crash(t0: int, *nodes) -> Episode:
    """Deterministic crash point: ``nodes`` fail-stop at the end of
    round ``t0`` and never return (module doc)."""
    return Episode("crash", t0, t0 + 1, nodes=tuple(nodes))


def gray(t0: int, t1: int, *nodes, delay: int = 2) -> Episode:
    """Gray failure: ``nodes`` are slow during [t0, t1) — ``delay``
    extra rounds on every message they send or receive, clamped at
    the ring bound, never dropped (module doc)."""
    return Episode("gray", t0, t1, nodes=tuple(nodes), delay=delay)


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """An immutable, hashable sequence of episodes (see module doc)."""

    episodes: tuple[Episode, ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(self, "episodes", tuple(self.episodes))
        for e in self.episodes:
            if not isinstance(e, Episode):
                raise TypeError(f"episodes must be Episode, got {type(e)}")

    @property
    def horizon(self) -> int:
        """First round at which every episode has ended (0 if empty)."""
        return max((e.t1 for e in self.episodes), default=0)

    def without(self, i: int) -> "FaultSchedule":
        """Schedule minus episode ``i`` (the shrinker's drop move)."""
        eps = self.episodes
        return FaultSchedule(eps[:i] + eps[i + 1:])

    def replaced(self, i: int, ep: Episode) -> "FaultSchedule":
        eps = list(self.episodes)
        eps[i] = ep
        return FaultSchedule(tuple(eps))

    # -- JSON plumbing for repro artifacts / injection logs --
    def to_dict(self) -> dict:
        return {
            "episodes": [
                {
                    k: (list(map(list, v)) if k == "groups" else
                        list(v) if isinstance(v, tuple) else v)
                    for k, v in dataclasses.asdict(e).items()
                }
                for e in self.episodes
            ]
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FaultSchedule":
        eps = []
        for e in d.get("episodes", []):
            eps.append(
                Episode(
                    kind=e["kind"],
                    t0=e["t0"],
                    t1=e["t1"],
                    groups=tuple(tuple(g) for g in e.get("groups", ())),
                    src=tuple(e.get("src", ())),
                    dst=tuple(e.get("dst", ())),
                    nodes=tuple(e.get("nodes", ())),
                    drop_rate=e.get("drop_rate", 0),
                    delay=e.get("delay", 0),
                )
            )
        return cls(tuple(eps))


class CompiledSchedule(NamedTuple):
    """Dense per-round tables, horizon+1 rows; row ``horizon`` is the
    healed steady state (engines index with ``min(t, horizon)``) —
    except ``crashed``, which is CUMULATIVE: crash points never heal,
    so row ``horizon`` carries every crash and the min-index read
    stays correct forever.  The ``has_*`` flags say which dimensions
    the schedule has: an engine skips the table read (and, for
    ``reach``, the per-edge send masking) for an absent one."""

    reach: np.ndarray  # [H+1, N, N] bool, True = src row can reach dst col
    paused: np.ndarray  # [H+1, N] bool
    extra_drop: np.ndarray  # [H+1] int32, additional per-1e4 drop rate
    crashed: np.ndarray  # [H+1, N] bool, cumulative scheduled crashes
    gray: np.ndarray  # [H+1, N] int32, per-node extra delay rounds
    horizon: int
    has_reach: bool
    has_pause: bool
    has_burst: bool
    has_crash: bool
    has_gray: bool


def validate_episode(e: Episode, n_nodes: int) -> None:
    """Cluster-size checks of one episode."""
    if e._max_node() >= n_nodes:
        raise ValueError(
            f"episode {e.kind}[{e.t0},{e.t1}) names node "
            f"{e._max_node()} but the cluster has {n_nodes} nodes"
        )
    if e.kind == "partition":
        # a single group needs unlisted nodes to form the implicit
        # complement, or the 'partition' cuts nothing
        listed = sum(len(g) for g in e.groups)
        if len(e.groups) < 2 and listed >= n_nodes:
            raise ValueError(
                f"partition[{e.t0},{e.t1}) lists every node in one "
                "group — nothing is cut; name >= 2 groups or leave "
                "nodes unlisted to form the implicit complement"
            )


def episode_tables(e: Episode, n_nodes: int):
    """Static per-episode masks: ``(cut [N, N] bool, paused [N] bool,
    extra_drop int, crash [N] bool, gray [N] int32)`` where ``cut[s, d]``
    means the s->d edge is severed while the episode is active,
    ``crash`` names the nodes a crash point fail-stops (active from
    ``t0`` FOREVER — crashes never heal), and ``gray`` is the per-node
    extra delay a gray episode inflicts while active.  The diagonal is
    never cut (a node always reaches itself).  Only the episode's own
    dimension is non-trivial; the others return zeros."""
    validate_episode(e, n_nodes)
    cut = np.zeros((n_nodes, n_nodes), bool)
    paused = np.zeros((n_nodes,), bool)
    crash_m = np.zeros((n_nodes,), bool)
    gray_v = np.zeros((n_nodes,), np.int32)
    extra = 0
    if e.kind == "partition":
        group_of = np.full((n_nodes,), len(e.groups), np.int32)
        for gi, g in enumerate(e.groups):
            group_of[list(g)] = gi
        cut = group_of[:, None] != group_of[None, :]
    elif e.kind == "one_way":
        cut[np.ix_(list(e.src), list(e.dst))] = True
        np.fill_diagonal(cut, False)
    elif e.kind == "pause":
        paused[list(e.nodes)] = True
    elif e.kind == "burst":
        extra = e.drop_rate
    elif e.kind == "crash":
        crash_m[list(e.nodes)] = True
    elif e.kind == "gray":
        gray_v[list(e.nodes)] = e.delay
    return cut, paused, extra, crash_m, gray_v


def compile_schedule(
    sched: FaultSchedule | None, n_nodes: int
) -> CompiledSchedule | None:
    """Lower a schedule to per-round tables for ``n_nodes`` nodes.
    Returns None for an absent/empty schedule."""
    if sched is None or not sched.episodes:
        return None
    h = sched.horizon
    reach = np.ones((h + 1, n_nodes, n_nodes), bool)
    paused = np.zeros((h + 1, n_nodes), bool)
    extra = np.zeros((h + 1,), np.int64)
    crashed = np.zeros((h + 1, n_nodes), bool)
    gray_t = np.zeros((h + 1, n_nodes), np.int64)
    for e in sched.episodes:
        rows = slice(e.t0, e.t1)  # t1 <= h, so row h stays healed
        cut, pmask, xd, cmask, gv = episode_tables(e, n_nodes)
        reach[rows] &= ~cut[None]
        paused[rows] |= pmask[None]
        extra[rows] += xd
        gray_t[rows] += gv[None]
        # crash points are permanent: from t0 through row h inclusive,
        # so the engine's min(t, horizon) read never un-crashes a node
        crashed[e.t0:] |= cmask[None]
    np.einsum("tnn->tn", reach)[:] = True  # a node always reaches itself
    return CompiledSchedule(
        reach=reach,
        paused=paused,
        extra_drop=np.minimum(extra, 10_000).astype(np.int32),
        crashed=crashed,
        # uncapped sum here; the engine clamps the INFLATED delay at
        # the ring bound, which also bounds any overlapping-gray sum
        gray=np.minimum(gray_t, np.iinfo(np.int32).max).astype(np.int32),
        horizon=h,
        has_reach=any(e.kind in ("partition", "one_way") for e in sched.episodes),
        has_pause=any(e.kind == "pause" for e in sched.episodes),
        has_burst=any(e.kind == "burst" for e in sched.episodes),
        has_crash=any(e.kind == "crash" for e in sched.episodes),
        has_gray=any(e.kind == "gray" for e in sched.episodes),
    )
