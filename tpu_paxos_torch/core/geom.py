"""Geometry-padded envelopes: one runner for every tenant geometry on a
menu (port of ``tpu_paxos/core/geom.py``).

The node and proposer axes of the engine's state are PADDED to an
envelope bound and the true geometry arrives per dispatch as data:

- :class:`GeometryEnvelope`: the menu of ``(n_nodes, proposers)``
  entries and the bound shapes they pad to; part of the envelope cache
  key.
- :class:`Geometry`: which menu entry a dispatch is, plus the masks and
  indices the round needs (node mask, proposer slot -> node map, quorum,
  crash room).  Absent nodes are permanently masked: never sampled,
  never quorum-counted, never send or receive.
- :class:`ProtocolKnobs`: the protocol liveness constants as per-call
  values; ``static_protocol`` gives the same field set for the unpadded
  build.

Why a MENU and not just a bound: threefry's words depend on the draw's
shape (``randint(key, (5,))`` is not a prefix of ``randint(key, (7,))``),
so every draw whose shape depends on the geometry is made at the true
entry's shape and then padded (:func:`menu_randint`; the engine does the
same for its copy plans) with values that never matter: a crash coin of
1e6 never crashes, a pad proposer's backoff is never read.  The padded
run then makes the unpadded run's decisions.

True nodes are always ids ``0..n-1`` (a menu entry's node set is a
prefix of the bound's), so schedules and knob matrices encoded at the
bound width carry the true geometry's values in their leading block.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from tpu_paxos_torch.config import PROTOCOL_SPANS, ProtocolConfig, SimConfig
from tpu_paxos_torch.utils import prng


@dataclasses.dataclass(frozen=True)
class GeometryEnvelope:
    """The geometry menu one padded runner serves.

    ``menu`` is a tuple of ``(n_nodes, proposers)`` entries; the engine
    pads every [A]/[P]-shaped array to ``bound_nodes`` /
    ``bound_proposers`` (the menu maxima) and makes its shape-dependent
    draws at the dispatch's entry.  Hashable: an envelope-cache key
    component."""

    menu: tuple

    def __post_init__(self) -> None:
        entries = []
        for entry in self.menu:
            n, props = entry
            n = int(n)
            props = tuple(sorted({int(x) for x in props})) or (0,)
            if n < 1:
                raise ValueError("menu entry needs n_nodes >= 1")
            for x in props:
                if not 0 <= x < n:
                    raise ValueError(
                        f"menu entry ({n}, {props}): proposer {x} out "
                        "of range"
                    )
            entries.append((n, props))
        if not entries:
            raise ValueError("a GeometryEnvelope needs at least one entry")
        if len(set(entries)) != len(entries):
            raise ValueError("menu entries must be distinct")
        object.__setattr__(self, "menu", tuple(entries))

    @property
    def bound_nodes(self) -> int:
        return max(n for n, _ in self.menu)

    @property
    def bound_proposers(self) -> int:
        return max(len(props) for _, props in self.menu)

    def bound_cfg(self, cfg: SimConfig) -> SimConfig:
        """``cfg`` re-shaped onto the bound: ``n_nodes`` raised to the
        node bound and ``proposers`` widened to ``bound_proposers``
        slots (the slot -> node map is per-dispatch data)."""
        return dataclasses.replace(
            cfg,
            n_nodes=self.bound_nodes,
            proposers=tuple(range(self.bound_proposers)),
        )

    def index_of(self, n_nodes: int, proposers) -> int:
        """Menu index of a true geometry, with NAMED rejections: past
        the bound, or missing from the menu."""
        entry = (
            int(n_nodes),
            tuple(sorted({int(x) for x in proposers})) or (0,),
        )
        if entry in self.menu:
            return self.menu.index(entry)
        if entry[0] > self.bound_nodes or len(entry[1]) > self.bound_proposers:
            raise ValueError(
                f"geometry {entry} exceeds the envelope geometry bound "
                f"({self.bound_nodes} nodes, {self.bound_proposers} "
                "proposers)"
            )
        raise ValueError(
            f"geometry {entry} is not in the envelope menu {self.menu}"
        )

    def index_of_nodes(self, n_nodes: int) -> int:
        """Menu index by node count alone (the first entry with that
        count); same named rejections as :meth:`index_of`."""
        n = int(n_nodes)
        for i, (n_m, _) in enumerate(self.menu):
            if n_m == n:
                return i
        if n > self.bound_nodes:
            raise ValueError(
                f"geometry ({n} nodes) exceeds the envelope geometry "
                f"bound ({self.bound_nodes} nodes)"
            )
        raise ValueError(
            f"geometry ({n} nodes) is not in the envelope menu "
            f"{self.menu}"
        )


class Geometry(NamedTuple):
    """The per-dispatch geometry of one padded run (shared by a fleet's
    lanes), host numpy, built by :func:`geometry_for`."""

    geom_idx: np.int32  # menu index
    n_true: np.int32  # true node count
    quorum: np.int32  # n_true // 2 + 1
    max_crash: np.int32  # (n_true - 1) // 2 crash-injection room
    node_mask: np.ndarray  # [A_bound] bool: ids < n_true
    pn: np.ndarray  # [P_bound] int32 proposer slot -> node id (pad: 0)
    prop_mask: np.ndarray  # [P_bound] bool: true proposer slots


class ProtocolKnobs(NamedTuple):
    """The protocol liveness constants as per-call values."""

    prepare_delay_min: int
    prepare_delay_max: int
    prepare_retry_count: int
    prepare_retry_timeout: int
    accept_retry_count: int
    accept_retry_timeout: int
    commit_retry_timeout: int
    stall_patience: int


def geometry_for(env: GeometryEnvelope, n_nodes: int, proposers) -> Geometry:
    """The :class:`Geometry` of one true geometry of ``env`` (named
    rejection through ``env.index_of`` when it is off the menu)."""
    idx = env.index_of(n_nodes, proposers)
    n, props = env.menu[idx]
    a, p = env.bound_nodes, env.bound_proposers
    pn = np.zeros((p,), np.int32)
    pn[: len(props)] = props
    return Geometry(
        geom_idx=np.int32(idx),
        n_true=np.int32(n),
        quorum=np.int32(n // 2 + 1),
        max_crash=np.int32((n - 1) // 2),
        node_mask=np.arange(a) < n,
        pn=pn,
        prop_mask=np.arange(p) < len(props),
    )


def protocol_knobs(pc: ProtocolConfig, stall_patience: int = 8) -> ProtocolKnobs:
    """The per-call encoding of a ProtocolConfig, span-checked against
    the declared spans (``config.PROTOCOL_SPANS``): an out-of-span knob
    is rejected by name, never clamped.  ``stall_patience`` is the
    idle-liveness restart patience (``sim.IDLE_RESTART_ROUNDS``)."""
    values = {
        "prepare_delay_min": pc.prepare_delay_min,
        "prepare_delay_max": pc.prepare_delay_max,
        "prepare_retry_count": pc.prepare_retry_count,
        "prepare_retry_timeout": pc.prepare_retry_timeout,
        "accept_retry_count": pc.accept_retry_count,
        "accept_retry_timeout": pc.accept_retry_timeout,
        "commit_retry_timeout": pc.commit_retry_timeout,
        "stall_patience": int(stall_patience),
    }
    for name, v in values.items():
        lo, hi = PROTOCOL_SPANS[name]
        if not lo <= int(v) <= hi:
            raise ValueError(
                f"protocol knob {name}={v} is outside its declared "
                f"span [{lo}, {hi}] (config.PROTOCOL_SPANS)"
            )
    return ProtocolKnobs(**{k: np.int32(v) for k, v in values.items()})


def static_protocol(pc: ProtocolConfig, stall_patience: int = 8) -> ProtocolKnobs:
    """The protocol constants of ``pc`` plus the idle-liveness restart
    patience (``sim.IDLE_RESTART_ROUNDS``), as plain ints."""
    return ProtocolKnobs(
        prepare_delay_min=pc.prepare_delay_min,
        prepare_delay_max=pc.prepare_delay_max,
        prepare_retry_count=pc.prepare_retry_count,
        prepare_retry_timeout=pc.prepare_retry_timeout,
        accept_retry_count=pc.accept_retry_count,
        accept_retry_timeout=pc.accept_retry_timeout,
        commit_retry_timeout=pc.commit_retry_timeout,
        stall_patience=int(stall_patience),
    )


def menu_lengths(env: GeometryEnvelope, axis: str) -> list[int]:
    """Per-menu-entry TRUE length along one padded axis."""
    if axis == "nodes":
        return [n for n, _ in env.menu]
    if axis == "proposers":
        return [len(props) for _, props in env.menu]
    raise ValueError(f"unknown padded axis {axis!r}")


def menu_pad(env: GeometryEnvelope, geom_idx: int, axis: str, drawn: torch.Tensor,
             pad_value: int) -> torch.Tensor:
    """``drawn`` (``[..., n_m]``, a draw at entry ``geom_idx``'s true
    length along ``axis``) padded to the bound with ``pad_value``."""
    bound = env.bound_nodes if axis == "nodes" else env.bound_proposers
    n_m = menu_lengths(env, axis)[int(geom_idx)]
    if drawn.shape[-1] != n_m:
        raise ValueError(f"a draw of {drawn.shape[-1]} is not entry {int(geom_idx)}'s {n_m}")
    out = torch.full((*drawn.shape[:-1], bound), pad_value, dtype=drawn.dtype,
                     device=drawn.device)
    out[..., :n_m] = drawn
    return out


def menu_randint(env: GeometryEnvelope, geom_idx: int, key, axis: str, lo, hi,
                 pad_value: int, device=None) -> torch.Tensor:
    """Menu-switched 1-D ``randint``: drawn at entry ``geom_idx``'s TRUE
    length along ``axis`` (threefry's words depend on the shape) and
    padded to the bound with ``pad_value``.  ``key`` is one key (``(k1,
    k2)``; returns ``[bound]``) or a ``[L, 2]`` array of lane keys
    (returns ``[L, bound]``), drawn through ``prng.randint_lanes``."""
    keys = np.asarray(key, np.uint64)
    one = keys.ndim == 1
    keys = keys.reshape(-1, 2)
    n_m = menu_lengths(env, axis)[int(geom_idx)]
    drawn = prng.randint_lanes([(keys, (n_m,), lo, hi)], device)[0]
    out = menu_pad(env, geom_idx, axis, drawn, pad_value)
    return out[0] if one else out
