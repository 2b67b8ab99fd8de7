"""The port's own copy of ``tpu_paxos/config.py`` (jax-free there too): the port
imports nothing of the JAX package.

Configuration dataclasses — the TPU equivalent of the reference SPI knobs.

The reference exposes retry/timeout knobs through ``paxos::Config``
(ref multi/paxos.h:251-274: prepare_delay_min/max, prepare_retry_count,
prepare_retry_timeout, accept_retry_count, accept_retry_timeout,
commit_retry_timeout) and fault-injection knobs through the harness CLI
(ref multi/main.cpp:467-496: --net-drop-rate, --net-dup-rate,
--net-min-delay, --net-max-delay, --seed).

Here wall-clock milliseconds become integer *rounds* of the
bulk-synchronous schedule: one round is one full message exchange
(request leg + reply leg).  A retry timeout of ``k`` means "if the
quorum has not been reached ``k`` rounds after sending, resend".
"""

from __future__ import annotations

import dataclasses

from tpu_paxos_torch.core.faults import FaultSchedule


@dataclasses.dataclass(frozen=True)
class ProtocolConfig:
    """Protocol liveness knobs, in units of rounds.

    Mirrors ``paxos::Config`` (ref multi/paxos.h:251-274) with
    milliseconds mapped to round counts.
    """

    # Randomized delay before (re)starting a prepare — the anti-dueling
    # backoff (ref multi/paxos.cpp:1244-1247 samples uniformly in
    # [prepare_delay_min_, prepare_delay_max_]).
    prepare_delay_min: int = 0
    prepare_delay_max: int = 4
    # Prepare is resent this many times, prepare_retry_timeout rounds
    # apart, before restarting with a higher ballot
    # (ref multi/paxos.cpp:757-801).
    prepare_retry_count: int = 3
    prepare_retry_timeout: int = 2
    # Accept is resent this many times before falling back to prepare
    # (AcceptRejected, ref multi/paxos.cpp:969-983, 1328-1343).
    accept_retry_count: int = 3
    accept_retry_timeout: int = 2
    # Commit/learn is retried forever, this many rounds apart, until
    # every node has replied (ref multi/paxos.cpp:1022-1027, 1625-1641).
    commit_retry_timeout: int = 2

    def __post_init__(self) -> None:
        if self.prepare_delay_min < 0:
            raise ValueError("prepare_delay_min must be >= 0")
        if self.prepare_delay_min > self.prepare_delay_max:
            raise ValueError("prepare_delay_min > prepare_delay_max")
        for name in (
            "prepare_retry_count",
            "prepare_retry_timeout",
            "accept_retry_count",
            "accept_retry_timeout",
            "commit_retry_timeout",
        ):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1")


#: Declared spans for the TRACED protocol knobs
#: (core/geom.ProtocolKnobs).  A padded-envelope executable is shared
#: across protocol-knob mixes, so a knob outside its declared span is
#: rejected BY NAME at encode time (geom.protocol_knobs) instead of
#: silently running a configuration the envelope was never validated
#: for.  ``stall_patience`` is the idle-liveness restart patience
#: (sim.IDLE_RESTART_ROUNDS is the compile-time default).
PROTOCOL_SPANS: dict = {
    "prepare_delay_min": (0, 64),
    "prepare_delay_max": (0, 64),
    "prepare_retry_count": (1, 64),
    "prepare_retry_timeout": (1, 256),
    "accept_retry_count": (1, 64),
    "accept_retry_timeout": (1, 256),
    "commit_retry_timeout": (1, 256),
    "stall_patience": (1, 1024),
}


def _matrix(field: str, m, n: int | None) -> tuple:
    """Canonicalize one per-edge table to a square tuple-of-tuples of
    ints; ``n`` (if known) pins the side length."""
    rows = tuple(tuple(int(x) for x in row) for row in m)
    side = len(rows)
    if n is not None and side != n:
        raise ValueError(f"{field} must be {n}x{n}, got {side} rows")
    for r in rows:
        if len(r) != side:
            raise ValueError(f"{field} must be square ({side}x{side})")
    return rows


@dataclasses.dataclass(frozen=True)
class EdgeFaultConfig:
    """Per-edge ``[A, A]`` i.i.d. fault tables — the WAN-shaped
    generalization of the scalar THNetWork knobs.  Entry ``[s][d]``
    governs messages from node ``s`` to node ``d``: drop/dup rates
    per 1e4 and a uniform delay span in rounds, all free to be
    asymmetric.  A uniform matrix is bit-identical to the equivalent
    scalar knobs (the exact-at-zero masked-sampling contract,
    core/net.py — sha256 parity pinned by tests/test_geo.py), so
    every scalar config is the degenerate case of this model.

    Plain tuples of ints: hashable, JSON-serializable (repro
    artifacts), and structurally comparable like every other config
    dataclass."""

    drop_rate: tuple  # [A][A] per 10_000
    dup_rate: tuple  # [A][A] per 10_000
    min_delay: tuple  # [A][A] rounds
    max_delay: tuple  # [A][A] rounds

    def __post_init__(self) -> None:
        d = _matrix("edges.drop_rate", self.drop_rate, None)
        n = len(d)
        if n < 1:
            raise ValueError("edges tables must name at least one node")
        object.__setattr__(self, "drop_rate", d)
        for f in ("dup_rate", "min_delay", "max_delay"):
            object.__setattr__(self, f, _matrix(f"edges.{f}", getattr(self, f), n))
        for f in ("drop_rate", "dup_rate"):
            for row in getattr(self, f):
                for v in row:
                    if not 0 <= v <= 10_000:
                        raise ValueError(f"edges.{f} must be in [0, 10000]")
        for s in range(n):
            for t in range(n):
                lo, hi = self.min_delay[s][t], self.max_delay[s][t]
                if lo < 0 or lo > hi:
                    raise ValueError(
                        f"edges delay span [{lo}, {hi}] on edge "
                        f"{s}->{t} must satisfy 0 <= min <= max"
                    )

    @property
    def n_nodes(self) -> int:
        return len(self.drop_rate)

    @property
    def delay_bound(self) -> int:
        """Largest per-edge max_delay — the ring bound this matrix
        needs."""
        return max(max(row) for row in self.max_delay)

    @classmethod
    def uniform(cls, n_nodes: int, drop_rate: int = 0, dup_rate: int = 0,
                min_delay: int = 0, max_delay: int = 0) -> "EdgeFaultConfig":
        """The uniform matrix equivalent of scalar knobs (the sha256
        parity anchor)."""
        def full(v):
            return tuple((int(v),) * n_nodes for _ in range(n_nodes))

        return cls(full(drop_rate), full(dup_rate), full(min_delay),
                   full(max_delay))

    def to_dict(self) -> dict:
        return {
            f: [list(r) for r in getattr(self, f)]
            for f in ("drop_rate", "dup_rate", "min_delay", "max_delay")
        }

    @classmethod
    def from_dict(cls, d: dict) -> "EdgeFaultConfig":
        return cls(**{
            f: tuple(tuple(r) for r in d[f])
            for f in ("drop_rate", "dup_rate", "min_delay", "max_delay")
        })


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Network fault injection, THNetWork semantics.

    The reference drops a message with probability drop_rate/10000,
    duplicates with dup_rate/10000 (up to 3 copies, recursively), and
    delays by a uniform sample in [min_delay, max_delay] milliseconds
    (ref multi/main.cpp:51-162).  Here delays are integer rounds; a
    dropped message simply never arrives (the protocol's retry ladder
    provides liveness), and duplicates are re-deliveries of idempotent
    messages (they additionally improve effective delivery probability,
    which is how they are modelled: an edge delivers if any of its
    1 + dup copies survives the drop coin).
    """

    drop_rate: int = 0  # per 10_000
    dup_rate: int = 0  # per 10_000
    min_delay: int = 0  # rounds
    max_delay: int = 0  # rounds
    # member/ style random process crashes: probability per node per
    # round, per 1_000_000 (ref member/indet.h:146-150 crashes with
    # failure_rate/1e6 on every log call).
    crash_rate: int = 0  # per 1_000_000
    # Correlated-fault layer on top of the i.i.d. knobs above: a
    # deterministic schedule of partition / one-way-cut / pause /
    # burst-loss / crash-point / gray episodes (core/faults.py).
    # None = no episodes.
    schedule: FaultSchedule | None = None
    # Per-edge [A, A] drop/dup/delay tables (WAN topologies,
    # asymmetric loss).  When set, the tables REPLACE the scalar
    # drop/dup/min_delay knobs (which must stay 0 — one unambiguous
    # source of truth) and the scalar ``max_delay`` becomes the RING
    # BOUND: it must cover every per-edge max_delay (the arrival
    # calendars are statically sized to ``max_delay + 2`` slots).
    edges: EdgeFaultConfig | None = None
    # Delivery-time partition semantics (the PR-1 follow-on): with
    # True, in-flight copies whose edge is cut on their ARRIVAL round
    # are dropped at the partition edge (same-side copies deliver
    # untouched).  Default False keeps the send-time-only semantics
    # every existing schedule, artifact, and certificate was recorded
    # under — it is a compile-time engine flag, not a runtime knob.
    delivery_cut: bool = False

    def __post_init__(self) -> None:
        if not 0 <= self.drop_rate <= 10_000:
            raise ValueError("drop_rate must be in [0, 10000]")
        if not 0 <= self.dup_rate <= 10_000:
            raise ValueError("dup_rate must be in [0, 10000]")
        if self.min_delay > self.max_delay:
            raise ValueError("min_delay > max_delay")
        if self.min_delay < 0:
            raise ValueError("min_delay must be >= 0")
        if not 0 <= self.crash_rate <= 1_000_000:
            raise ValueError("crash_rate must be in [0, 1000000]")
        if self.schedule is not None and not isinstance(
            self.schedule, FaultSchedule
        ):
            raise TypeError("schedule must be a FaultSchedule or None")
        if (
            self.schedule is not None
            and self.max_delay == 0
            and any(e.kind == "gray" for e in self.schedule.episodes)
        ):
            # NAMED rejection, never silent exclusion (the mc-scope /
            # membership discipline): gray inflation clamps at the
            # ring bound, so at max_delay=0 every gray episode would
            # be a complete no-op — the user would believe they
            # verified gray behavior when no fault was injected
            raise ValueError(
                "gray episodes need a nonzero ring bound: with "
                "max_delay=0 the delay-inflation clamp reduces every "
                "gray episode to a no-op (set max_delay to the delay "
                "headroom gray messages may use)"
            )
        if self.edges is not None:
            if not isinstance(self.edges, EdgeFaultConfig):
                raise TypeError("edges must be an EdgeFaultConfig or None")
            if self.drop_rate or self.dup_rate or self.min_delay:
                raise ValueError(
                    "edges tables replace the scalar drop/dup/delay "
                    "knobs; keep drop_rate/dup_rate/min_delay at 0"
                )
            if self.edges.delay_bound > self.max_delay:
                raise ValueError(
                    f"edges max_delay {self.edges.delay_bound} exceeds "
                    f"the ring bound max_delay={self.max_delay}"
                )

    @property
    def is_reliable(self) -> bool:
        return (
            self.drop_rate == 0
            and self.min_delay == 0
            and self.max_delay == 0
            and self.crash_rate == 0
            and self.edges is None
            and (self.schedule is None or not self.schedule.episodes)
        )


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Whole-simulation shape: the TPU analog of the reference CLI line
    ``srvcnt cltcnt idcnt propose_interval --seed=...``
    (ref multi/main.cpp:456-521, multi/debug.conf.sample:1)."""

    n_nodes: int = 3
    n_instances: int = 100
    # Which nodes act as proposers.  () means node 0 only.
    proposers: tuple[int, ...] = (0,)
    seed: int = 0
    # Hard cap on simulated rounds (liveness watchdog, not a protocol
    # knob).  The scan exits early once every instance is chosen.
    max_rounds: int = 10_000
    # Queue entries a proposer may assign per round (static first-fit
    # window).  The default suits correctness runs; large-instance
    # throughput runs raise it — assignment rate is assign_window per
    # proposer per round at O(window^2) one-hot cost.
    assign_window: int = 64
    protocol: ProtocolConfig = dataclasses.field(default_factory=ProtocolConfig)
    faults: FaultConfig = dataclasses.field(default_factory=FaultConfig)

    def __post_init__(self) -> None:
        if self.n_nodes < 1:
            raise ValueError("n_nodes must be >= 1")
        if self.n_instances < 1:
            raise ValueError("n_instances must be >= 1")
        if self.assign_window < 1:
            raise ValueError("assign_window must be >= 1")
        props = self.proposers or (0,)
        object.__setattr__(self, "proposers", tuple(sorted(set(props))))
        for p in self.proposers:
            if not 0 <= p < self.n_nodes:
                raise ValueError(f"proposer {p} out of range")
        if (
            self.faults.edges is not None
            and self.faults.edges.n_nodes != self.n_nodes
        ):
            raise ValueError(
                f"faults.edges is {self.faults.edges.n_nodes}x"
                f"{self.faults.edges.n_nodes} but the cluster has "
                f"{self.n_nodes} nodes"
            )

    @property
    def quorum(self) -> int:
        # Majority quorum, ref multi/paxos.cpp:1047: n/2 + 1.
        return self.n_nodes // 2 + 1

    @property
    def round_budget(self) -> int:
        """Liveness-watchdog round cap.  With a fault schedule, the
        full ``max_rounds`` budget starts only at the last heal —
        convergence is owed AFTER the final episode ends, however long
        the schedule itself runs (the heal-then-converge contract,
        core/faults.py)."""
        s = self.faults.schedule
        return self.max_rounds + (s.horizon if s is not None else 0)
