"""The port's own copy of ``tpu_paxos/core/faults.py`` (jax-free there too): the port
imports nothing of the JAX package.

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
inflations ADD per node.  The port holds only the schedule types that
``config.py`` needs: its engine does not run schedules yet, and raises
``NotImplementedError`` on a schedule with episodes.  The JAX
package's ``compile_schedule`` (the per-round table lowering) comes
with the slice that runs them.

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
