"""WAN topology presets: geo-replicated cluster shapes as per-edge
fault matrices plus a node->region assignment (the port's own copy of
``tpu_paxos/core/wan.py``, pure numpy there too).

A geo-replicated Paxos cluster does not fail like a rack: its latency
is an asymmetric ``[A, A]`` matrix set by the speed of light between
regions, its loss concentrates on the long-haul links, and its worst
outages are *gray* — a slow region, not a dead one.  This module
ships that shape as data: each preset lowers to a
:class:`~tpu_paxos_torch.config.EdgeFaultConfig` (per-edge drop/delay
tables, ``config.py``) plus an ``[A]`` region map, with every delay
bounded by one shared ring bound (:data:`PRESET_DELAY_BOUND`).

Delay units are protocol rounds.  The RTT ratios are the classic
WAN shape (intra-region ~0, cross-continent 2-4x a regional hop),
not a claim about any particular provider; what matters for the
protocol is the RATIO structure — quorums form at the speed of the
median region pair, and the far region rides the retry ladder.

Nodes are assigned to regions round-robin (``node_regions``), so a
5-node cluster on the 3-region preset lands 2/2/1 — the standard
multi-region quorum layout.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpu_paxos_torch.config import EdgeFaultConfig, FaultConfig

#: Every preset's delay entries stay <= this bound (the JAX package's
#: fleet envelope ring bound), so presets share one ring size.
PRESET_DELAY_BOUND = 8


@dataclasses.dataclass(frozen=True)
class WanPreset:
    """One WAN topology: region names, a symmetric one-way base
    latency matrix (rounds, per region pair), per-pair delay jitter,
    and per-pair loss (per 1e4, applied to cross-region edges)."""

    name: str
    regions: tuple[str, ...]
    latency: tuple  # [R][R] base one-way delay in rounds
    jitter: int = 1  # extra max-delay rounds on every edge
    loss: tuple | None = None  # [R][R] drop per 1e4 (None = lossless)

    def __post_init__(self) -> None:
        r = len(self.regions)
        lat = tuple(tuple(int(x) for x in row) for row in self.latency)
        if len(lat) != r or any(len(row) != r for row in lat):
            raise ValueError(f"latency must be {r}x{r}")
        object.__setattr__(self, "latency", lat)
        if self.loss is not None:
            ls = tuple(tuple(int(x) for x in row) for row in self.loss)
            if len(ls) != r or any(len(row) != r for row in ls):
                raise ValueError(f"loss must be {r}x{r}")
            object.__setattr__(self, "loss", ls)
        hi = max(max(row) for row in lat) + self.jitter
        if hi > PRESET_DELAY_BOUND:
            raise ValueError(
                f"preset {self.name!r} peaks at delay {hi} > the "
                f"envelope ring bound {PRESET_DELAY_BOUND}"
            )

    @property
    def n_regions(self) -> int:
        return len(self.regions)


#: 3-region preset (us / eu / ap): one regional hop is ~1 round, the
#: transatlantic link 2, transpacific 3-4 — the realistic RTT ratio
#: triangle.  Modest loss on the long links, asymmetric (the return
#: path is slightly worse — real WANs are).
WAN3 = WanPreset(
    name="wan-3region",
    regions=("us", "eu", "ap"),
    latency=(
        (0, 2, 3),
        (2, 0, 4),
        (3, 4, 0),
    ),
    jitter=1,
    loss=(
        (0, 50, 80),
        (60, 0, 100),
        (90, 120, 0),
    ),
)

#: 5-region preset (us-east / us-west / eu / ap / sa): finer ratio
#: ladder — coast-to-coast 1, transatlantic 2, transpacific 3-4,
#: south-america tail 3-4 with the worst loss.
WAN5 = WanPreset(
    name="wan-5region",
    regions=("use", "usw", "eu", "ap", "sa"),
    latency=(
        (0, 1, 2, 4, 3),
        (1, 0, 3, 3, 4),
        (2, 3, 0, 4, 4),
        (4, 3, 4, 0, 5),
        (3, 4, 4, 5, 0),
    ),
    jitter=1,
    loss=(
        (0, 20, 60, 100, 120),
        (20, 0, 80, 80, 140),
        (60, 80, 0, 100, 150),
        (100, 80, 100, 0, 180),
        (120, 140, 150, 180, 0),
    ),
)

PRESETS = {p.name: p for p in (WAN3, WAN5)}


def node_regions(preset: WanPreset, n_nodes: int) -> np.ndarray:
    """Round-robin node->region assignment: ``[A]`` int32 region
    indices."""
    return (np.arange(n_nodes, dtype=np.int32) % preset.n_regions)


def edge_faults(preset: WanPreset, n_nodes: int) -> EdgeFaultConfig:
    """Lower a preset to the per-edge ``[A, A]`` tables for an
    ``n_nodes`` cluster: each edge inherits its region pair's base
    latency as ``min_delay``, plus ``jitter`` as the span, and the
    pair's loss rate (intra-region edges stay fast and lossless)."""
    rmap = node_regions(preset, n_nodes)
    lat = np.asarray(preset.latency, np.int32)[rmap[:, None], rmap[None, :]]
    if preset.loss is not None:
        drop = np.asarray(preset.loss, np.int32)[rmap[:, None], rmap[None, :]]
    else:
        drop = np.zeros((n_nodes, n_nodes), np.int32)
    np.fill_diagonal(drop, 0)
    # EdgeFaultConfig canonicalizes any iterable-of-iterables (incl.
    # numpy rows) to int tuples in __post_init__
    return EdgeFaultConfig(
        drop_rate=drop,
        dup_rate=np.zeros_like(drop),
        min_delay=lat,
        max_delay=lat + preset.jitter,
    )


def wan_fault_config(
    preset: WanPreset,
    n_nodes: int,
    *,
    delay_bound: int = PRESET_DELAY_BOUND,
    crash_rate: int = 0,
    schedule=None,
    delivery_cut: bool = False,
) -> FaultConfig:
    """A ready-to-run :class:`FaultConfig` for one preset: the edge
    tables plus the envelope ring bound as the scalar ``max_delay``
    (so every preset of a geometry lands on one fleet envelope
    key)."""
    edges = edge_faults(preset, n_nodes)
    if edges.delay_bound > delay_bound:
        raise ValueError(
            f"preset {preset.name!r} needs ring bound "
            f"{edges.delay_bound} > requested {delay_bound}"
        )
    return FaultConfig(
        max_delay=delay_bound,
        crash_rate=crash_rate,
        schedule=schedule,
        edges=edges,
        delivery_cut=delivery_cut,
    )
