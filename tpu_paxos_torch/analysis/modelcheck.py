"""smallcheck on the port (port of ``tpu_paxos/analysis/modelcheck.py``):
exhaustive bounded model checking of the protocol on lane-batched fleet
dispatches.

A declarative **scope** discretizes the fault universe (episode kinds x
quantized round intervals x node groups x rate tiers, i.i.d. knob tiers,
workload gate tiers and engine seeds) and the ENTIRE cross product is
enumerated, so "no counterexample found" means *no scenario in the
declared scope wedges*.  Scope files may also declare CHURN scopes
(``"type": "churn"``, ``analysis/mc_member.py``) and CONTROLLER scopes
(``"type": "control"``, ``analysis/mc_control.py``); all three share this
module's codec helpers, chunking and certificate machinery.

The codec half (scope parsing and hashing, the episode alphabet, the
combinatorial-number-system combo codec, symmetry reduction) is the JAX
package's, loop for loop: the reduced scenario list is the certificate's
index space, so ``combinations``/``permutations`` order and the orbit
choice stay exactly as they are there.  ``analysis/mc_scope.json`` and
``analysis/mc_certificate.json`` are byte copies of the JAX package's.

Where the port differs:

- **Runner builds, not XLA compiles.**  The port builds a fleet runner
  eagerly in ``fleet/envelope.runner_for`` and compiles nothing at the
  first dispatch, so ``compiles_per_chunk`` counts envelope runner
  builds (``envelope.cache_misses``) from *before* ``runner_for``, the
  build charged to chunk 0.  The contract is the zero pattern: chunk 0
  builds when the envelope is cold, every later chunk builds nothing.
- **Verdict bits on every device.**  The port's contract is bit equality
  with the JAX package wherever it runs, so :func:`check_certificate`
  compares the verdict bits whatever device ran (the JAX checker skips
  them off the pinning backend).  ``summary["backend"]`` records the
  torch device type (``"cuda"`` / ``"cpu"``).
- **An explicit device.**  :func:`run_scope` takes ``device`` (default
  ``"cuda"``) and the CLI ``--device {cuda,cpu}``; there is no fallback.

Counterexamples drop into the triage stack: the lane's config is re-run
single (``harness/shrink.run_case``, the FULL invariant suite), greedily
shrunk (``shrink.triage``) and written as ``mc_scenario_<index>.json``
under the analysis-dump retention namespace (``analysis/triage.py``).  A
lane the device verdict flags but the full suite clears is an anomaly,
reported, never dropped.

CLI: ``python -m tpu_paxos_torch mc [--scope quick,gray,churn,control]
[--device cuda|cpu] [--json]``.  Exit 0 iff no counterexample and the
pinned certificate matches; 2 on a scope error.  The port certifies
and never pins: the certificate file is a byte copy of the JAX
package's, re-pinned there (``TPU_PAXOS_MC_PIN=1 make mc``) and copied
over.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import os
import sys
from itertools import combinations, permutations

import numpy as np

from tpu_paxos_torch.config import FaultConfig, SimConfig
from tpu_paxos_torch.core import faults as fltm

#: Default scope + certificate homes (committed next to the other
#: analysis pins).
DEFAULT_SCOPE = os.path.join(os.path.dirname(__file__), "mc_scope.json")
DEFAULT_CERT = os.path.join(
    os.path.dirname(__file__), "mc_certificate.json"
)

#: Movable-node permutation groups past this size are a scope-design
#: error, not a reduction opportunity (8! canonical-form checks per
#: combo would dominate the enumeration itself).
MAX_PERMS = 5040

#: Scenario episode-count ceiling == fleet.runner.MAX_EPISODES (the
#: fleet's default envelope capacity; cross-checked by
#: tests/test_torch_modelcheck.py).  Hardcoded rather than imported so
#: the codec/scope layer stays torch-free.  The bound keeps every scope
#: inside the envelope's episode capacity, so the mc sweep and the
#: shrinker's candidate evaluators (which floor their capacity at the
#: same default) never need a wider runner.
MAX_SCOPE_EPISODES = 8

#: Gray delay-tier ceiling == fleet.envelope.MAX_DELAY_BOUND (the
#: floor of every fleet envelope's delay ring; cross-checked by
#: tests/test_torch_modelcheck.py, hardcoded for the same reason
#: as MAX_SCOPE_EPISODES).  The engines clamp the INFLATED per-
#: message delay at the ring bound, so a gray tier past it would be
#: indistinguishable from the tier AT it — the clamp is exactly what
#: makes the delay axis finite, and the validator keeps the declared
#: grid inside the distinguishable range.
MAX_GRAY_DELAY = 8

#: Episode kinds the letter builder cannot enumerate: kind -> reason.
#: NAMED rejection, never silent exclusion — a scope declaring a kind
#: listed here fails loudly rather than certifying a universe it
#: silently never enumerated.  Empty today: every ``faults.KINDS``
#: member has a codec axis (gray landed with the quantized
#: ``gray_delays`` tier grid).  The table stays so a future grammar
#: kind lands HERE (with its reason) until its axis exists, and so
#: sibling scope validators (mc_member's member-engine alphabet) can
#: declare their own rejections the same data-driven way.
UNSUPPORTED_KINDS: dict[str, str] = {}


class ScopeError(Exception):
    """The scope file is malformed or internally inconsistent."""


@dataclasses.dataclass(frozen=True)
class McScope:
    """One declared model-checking scope (see module doc).  All
    fields are plain data so the scope serializes, hashes, and
    certificates stably."""

    n_nodes: int
    proposers: int  # proposer count; proposer nodes are 0..proposers-1
    horizon: int  # every episode ends by this round
    max_rounds: int  # convergence budget past the last heal
    intervals: tuple  # ((t0, t1), ...) quantized episode intervals
    kinds: tuple  # episode kinds in the alphabet, listed order
    partition_group_sizes: tuple = (1,)
    pause_set_sizes: tuple = (1,)
    burst_rates: tuple = ()
    #: deterministic crash points (faults.crash): the rounds at which
    #: a crash letter fail-stops its nodes.  Crash letters ignore the
    #: interval grid — a crash is an instant, not a window.
    crash_rounds: tuple = ()
    crash_set_sizes: tuple = (1,)
    #: gray axis (gray weather in the alphabet): one letter per
    #: (interval x node set x delay tier).  ``gray_delays`` is the
    #: quantized delay-tier grid — empty unless "gray" is in kinds.
    #: Both fields serialize ONLY when non-default (to_dict elides
    #: them) so pre-gray scopes hash — and certify — byte-identically.
    gray_set_sizes: tuple = (1,)
    gray_delays: tuple = ()
    max_episodes: int = 2  # scenarios combine up to this many episodes
    knob_tiers: tuple = ()  # (FaultConfig kwargs dict, ...) — crash points
    gate_tiers: tuple = (True,)  # workload-gate on/off axis
    seeds: tuple = (0,)
    symmetry_reduction: bool = True
    chunk_lanes: int = 16
    workload_seed: int = 0
    n_ids: int = 4  # gate-chain length per proposer
    n_free: int = 4  # ungated values per proposer

    _FIELDS = (
        "n_nodes", "proposers", "horizon", "max_rounds", "intervals",
        "kinds", "partition_group_sizes", "pause_set_sizes",
        "burst_rates", "crash_rounds", "crash_set_sizes",
        "gray_set_sizes", "gray_delays",
        "max_episodes", "knob_tiers", "gate_tiers",
        "seeds", "symmetry_reduction", "chunk_lanes", "workload_seed",
        "n_ids", "n_free",
    )

    #: Fields added AFTER certificates were first pinned: serialized
    #: only when non-default, so every pre-existing scope's sha256 —
    #: and therefore its pinned certificate — stays byte-identical.
    _ELIDED_DEFAULTS = {"gray_set_sizes": (1,), "gray_delays": ()}

    @classmethod
    def from_dict(cls, d: dict) -> "McScope":
        if not isinstance(d, dict):
            raise ScopeError("scope must be a JSON object")
        unknown = sorted(set(d) - set(cls._FIELDS))
        if unknown:
            raise ScopeError(f"unknown scope field(s): {', '.join(unknown)}")
        missing = [
            f for f in ("n_nodes", "proposers", "horizon", "max_rounds",
                        "intervals", "kinds")
            if f not in d
        ]
        if missing:
            raise ScopeError(f"scope missing field(s): {', '.join(missing)}")
        kw = dict(d)
        kw["intervals"] = tuple(
            (int(t0), int(t1)) for t0, t1 in kw["intervals"]
        )
        for f in ("kinds", "partition_group_sizes", "pause_set_sizes",
                  "burst_rates", "crash_rounds", "crash_set_sizes",
                  "gray_set_sizes", "gray_delays",
                  "gate_tiers", "seeds"):
            if f in kw:
                kw[f] = tuple(kw[f])
        if "knob_tiers" in kw:
            kw["knob_tiers"] = tuple(dict(t) for t in kw["knob_tiers"])
        try:
            scope = cls(**kw)
        except TypeError as e:
            raise ScopeError(f"bad scope field types: {e}") from None
        scope.validate()
        return scope

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["intervals"] = [list(iv) for iv in self.intervals]
        for f in ("kinds", "partition_group_sizes", "pause_set_sizes",
                  "burst_rates", "crash_rounds", "crash_set_sizes",
                  "gate_tiers", "seeds"):
            d[f] = list(d[f])
        d["knob_tiers"] = [dict(t) for t in self.knob_tiers]
        for f, dflt in self._ELIDED_DEFAULTS.items():
            # post-pin fields leave the serialization (and the
            # sha256) untouched at their defaults — see _ELIDED_DEFAULTS
            if getattr(self, f) == dflt:
                del d[f]
            else:
                d[f] = list(d[f])
        return d

    def sha256(self) -> str:
        """The scope's identity hash — certificate key; any scope edit
        (even a reordering, which changes the codec) changes it."""
        text = json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))
        return hashlib.sha256(text.encode()).hexdigest()

    def validate(self) -> None:
        if self.n_nodes < 2:
            raise ScopeError("n_nodes must be >= 2")
        if not 1 <= self.proposers < self.n_nodes + 1:
            raise ScopeError("proposers must be in [1, n_nodes]")
        if self.horizon < 1:
            raise ScopeError("horizon must be >= 1")
        if self.max_rounds < 1:
            raise ScopeError("max_rounds must be >= 1")
        if not self.intervals:
            raise ScopeError("intervals must be non-empty")
        for t0, t1 in self.intervals:
            if not 0 <= t0 < t1 <= self.horizon:
                raise ScopeError(
                    f"interval [{t0}, {t1}) must be non-empty inside "
                    f"[0, horizon={self.horizon}]"
                )
        bad = sorted(set(self.kinds) - set(fltm.KINDS))
        if bad:
            raise ScopeError(f"unknown episode kind(s): {', '.join(bad)}")
        for k in self.kinds:
            if k in UNSUPPORTED_KINDS:
                raise ScopeError(
                    f"episode kind {k!r} is not enumerable by this "
                    f"checker: {UNSUPPORTED_KINDS[k]}"
                )
        if "gray" in self.kinds:
            if not self.gray_delays:
                raise ScopeError("gray in kinds needs gray_delays")
            if len(set(self.gray_delays)) != len(self.gray_delays):
                raise ScopeError("gray_delays must be distinct")
            for dly in self.gray_delays:
                if not 1 <= dly <= MAX_GRAY_DELAY:
                    raise ScopeError(
                        f"gray_delays entries must be in "
                        f"[1, {MAX_GRAY_DELAY}] (the fleet envelope's "
                        "delay-ring bound — the engines clamp inflated "
                        "delays there, so tiers past it collapse into "
                        "the boundary tier)"
                    )
        elif self.gray_delays:
            raise ScopeError("gray_delays declared without gray in kinds")
        if "gray" in self.kinds:
            # the fleet's named dispatch rejection, moved to scope
            # parse time: the delay-inflation clamp is each lane's OWN
            # declared bound (fleet/runner._knob_arrays), so a zero-
            # max_delay tier would turn every gray letter into a no-op
            for t in self.knob_tiers:
                if int(t.get("max_delay", 0)) < 1:
                    raise ScopeError(
                        f"gray in kinds needs max_delay >= 1 on every "
                        f"knob tier (tier {t} clamps gray inflation "
                        "to its own declared bound; at 0 every gray "
                        "episode is a no-op)"
                    )
        if "burst" in self.kinds and not self.burst_rates:
            raise ScopeError("burst in kinds needs burst_rates")
        for r in self.burst_rates:
            if not 0 < r <= 10_000:
                raise ScopeError("burst rates must be in (0, 10000]")
        if "crash" in self.kinds and not self.crash_rounds:
            raise ScopeError("crash in kinds needs crash_rounds")
        for t in self.crash_rounds:
            if not 0 <= t < self.horizon:
                raise ScopeError(
                    "crash rounds must be in [0, horizon)"
                )
        for sizes, what in (
            (self.partition_group_sizes, "partition_group_sizes"),
            (self.pause_set_sizes, "pause_set_sizes"),
            (self.crash_set_sizes, "crash_set_sizes"),
            (self.gray_set_sizes, "gray_set_sizes"),
        ):
            for k in sizes:
                if not 1 <= k < self.n_nodes:
                    raise ScopeError(
                        f"{what} entries must be in [1, n_nodes)"
                    )
        if not 0 <= self.max_episodes <= MAX_SCOPE_EPISODES:
            raise ScopeError(
                f"max_episodes must be in [0, {MAX_SCOPE_EPISODES}] "
                "(the fleet envelope's episode capacity — the mc "
                "sweep and the shrinker's candidate evaluators share "
                "one compiled executable only within it)"
            )
        if not self.knob_tiers:
            raise ScopeError("knob_tiers must be non-empty")
        for t in self.knob_tiers:
            if "schedule" in t:
                raise ScopeError(
                    "knob tiers are i.i.d. only; schedules come from "
                    "the episode axes"
                )
            try:
                FaultConfig(**t)
            except (TypeError, ValueError) as e:
                raise ScopeError(f"bad knob tier {t}: {e}") from None
        if not self.gate_tiers:
            raise ScopeError("gate_tiers must be non-empty")
        if not self.seeds or len(set(self.seeds)) != len(self.seeds):
            raise ScopeError("seeds must be non-empty and distinct")
        if self.chunk_lanes < 1:
            raise ScopeError("chunk_lanes must be >= 1")
        if self.symmetry_reduction:
            movable = self.n_nodes - self.proposers
            if math.factorial(max(movable, 1)) > MAX_PERMS:
                raise ScopeError(
                    f"{movable} movable nodes = "
                    f"{math.factorial(movable)} permutations per "
                    "canonical-form check; shrink the scope or set "
                    "symmetry_reduction: false"
                )


def _scope_types() -> dict:
    """The scope-type registry: JSON ``"type"`` discriminator ->
    ``(scope_cls, enum_cls, run_fn)``.  ``"fault"`` (the default, and
    the only type pre-gray scope files could name) is this module's
    own McScope/ScopeEnum/run_scope; the churn and controller scopes
    live in sibling modules that import THIS module for the shared
    codec/certificate machinery, so the registry is built lazily to
    keep the import acyclic (and the codec layer torch-free)."""
    from tpu_paxos_torch.analysis import mc_control, mc_member

    return {
        "fault": (McScope, ScopeEnum, run_scope),
        "churn": (
            mc_member.ChurnScope, mc_member.ChurnEnum,
            mc_member.run_scope,
        ),
        "control": (
            mc_control.ControlScope, mc_control.ControlEnum,
            mc_control.run_scope,
        ),
    }


def load_scopes(path: str = DEFAULT_SCOPE) -> dict:
    """Parse the scope file: a JSON object of name -> scope.  Each
    entry's optional ``"type"`` field picks the scope family
    (:func:`_scope_types`); absent = ``"fault"``, so pre-existing
    scope files parse — and hash — exactly as before."""
    try:
        with open(path) as f:
            raw = json.load(f)
    except OSError as e:
        raise ScopeError(f"unreadable scope file: {e}") from None
    except json.JSONDecodeError as e:
        raise ScopeError(f"invalid scope JSON: {e}") from None
    if not isinstance(raw, dict) or not raw:
        raise ScopeError("scope file must map scope names to scopes")
    types = _scope_types()
    out = {}
    for name in sorted(raw):
        d = raw[name]
        kind = d.get("type", "fault") if isinstance(d, dict) else "fault"
        if kind not in types:
            raise ScopeError(
                f"scope {name!r}: unknown scope type {kind!r} "
                f"(one of {', '.join(sorted(types))})"
            )
        cls = types[kind][0]
        if kind != "fault":
            d = {k: v for k, v in d.items() if k != "type"}
        try:
            out[name] = cls.from_dict(d)
        except ScopeError as e:
            raise ScopeError(f"scope {name!r}: {e}") from None
    return out


def scope_type(scope) -> str:
    """A loaded scope's type discriminator (its class name is not the
    contract; the registry key is)."""
    for kind, (cls, _, _) in _scope_types().items():
        if isinstance(scope, cls):
            return kind
    raise ScopeError(f"unregistered scope object {type(scope).__name__}")


def enum_for(scope):
    """The scope's enumerator (``.reduced`` is the dispatch order the
    certificate's verdict nibbles follow, for every scope type)."""
    return _scope_types()[scope_type(scope)][1](scope)


def run_for(scope):
    """The scope's run function (``run_scope``-shaped: same kwargs,
    same summary keys — the certificate machinery is shared)."""
    return _scope_types()[scope_type(scope)][2]


# ---------------- episode alphabet ----------------

def _table_key(e: fltm.Episode, n_nodes: int) -> tuple:
    """An episode's SEMANTIC identity: its interval plus the static
    masks the engine actually sees (faults.episode_tables).  Two
    grammar spellings with equal masks — e.g. a partition group and
    its complement — are the same letter."""
    cut, paused, extra, crash_m, gray_v = fltm.episode_tables(e, n_nodes)
    return (
        e.t0, e.t1, cut.tobytes(), paused.tobytes(), int(extra),
        crash_m.tobytes(), gray_v.tobytes(),
    )


def episode_alphabet(scope: McScope) -> list[fltm.Episode]:
    """The scope's finite episode alphabet, in deterministic order:
    intervals in listed order, kinds in listed order, node structures
    in lexicographic order; semantic duplicates (by mask) keep the
    first spelling."""
    nodes = range(scope.n_nodes)
    out: list[fltm.Episode] = []
    seen: set[tuple] = set()

    def add(e: fltm.Episode) -> None:
        key = _table_key(e, scope.n_nodes)
        if key not in seen:
            seen.add(key)
            out.append(e)

    for t0, t1 in scope.intervals:
        for kind in scope.kinds:
            if kind == "partition":
                for k in scope.partition_group_sizes:
                    for grp in combinations(nodes, k):
                        if k < scope.n_nodes:  # implicit complement
                            add(fltm.partition(t0, t1, grp))
            elif kind == "one_way":
                for src in nodes:
                    for dst in nodes:
                        if src != dst:
                            add(fltm.one_way(t0, t1, (src,), (dst,)))
            elif kind == "pause":
                for k in scope.pause_set_sizes:
                    for grp in combinations(nodes, k):
                        add(fltm.pause(t0, t1, *grp))
            elif kind == "burst":
                for r in scope.burst_rates:
                    add(fltm.burst(t0, t1, int(r)))
            elif kind == "gray":
                # the (node set x delay tier) grid: the ring-bound
                # clamp (MAX_GRAY_DELAY) already bounded the tiers
                for k in scope.gray_set_sizes:
                    for grp in combinations(nodes, k):
                        for dly in scope.gray_delays:
                            add(fltm.gray(t0, t1, *grp, delay=int(dly)))
    # crash points ride their own round grid (a crash is an instant,
    # not a window), appended after the interval letters
    if "crash" in scope.kinds:
        for t in scope.crash_rounds:
            for k in scope.crash_set_sizes:
                for grp in combinations(nodes, k):
                    add(fltm.crash(int(t), *grp))
    return out


def _permute_episode(e: fltm.Episode, perm: dict[int, int]) -> fltm.Episode:
    """The episode with every node label mapped through ``perm``
    (Episode.__post_init__ re-canonicalizes the containers)."""
    if e.kind == "partition":
        return fltm.partition(
            e.t0, e.t1, *[tuple(perm[x] for x in g) for g in e.groups]
        )
    if e.kind == "one_way":
        return fltm.one_way(
            e.t0, e.t1,
            tuple(perm[x] for x in e.src), tuple(perm[x] for x in e.dst),
        )
    if e.kind == "pause":
        return fltm.pause(e.t0, e.t1, *(perm[x] for x in e.nodes))
    if e.kind == "crash":
        return fltm.crash(e.t0, *(perm[x] for x in e.nodes))
    if e.kind == "gray":
        # gray names nodes exactly like pause — the delay tier rides
        # along unchanged, so gray letters break acceptor symmetry
        # the same way pause sets do (closure = full node-set orbit
        # per delay tier)
        return fltm.gray(
            e.t0, e.t1, *(perm[x] for x in e.nodes), delay=e.delay
        )
    return e  # burst names no nodes


# ---------------- combination codec ----------------

def n_combos(m: int, k_max: int) -> int:
    """Episode combinations of size 0..k_max over an m-letter
    alphabet."""
    return sum(math.comb(m, k) for k in range(k_max + 1))


def combo_unrank(r: int, m: int, k_max: int) -> tuple[int, ...]:
    """Rank -> strictly-increasing index tuple: sizes in increasing
    order, lexicographic within a size (combinatorial number
    system)."""
    if r < 0:
        raise IndexError(f"combo rank {r} out of range")
    for k in range(k_max + 1):
        c = math.comb(m, k)
        if r < c:
            out = []
            x = 0
            for i in range(k):
                while True:
                    below = math.comb(m - x - 1, k - i - 1)
                    if r < below:
                        out.append(x)
                        x += 1
                        break
                    r -= below
                    x += 1
            return tuple(out)
        r -= c
    raise IndexError("combo rank past the scope's combination count")


def combo_rank(combo: tuple[int, ...], m: int, k_max: int) -> int:
    """Inverse of :func:`combo_unrank` (bijection pinned by
    tests/test_torch_modelcheck.py)."""
    k = len(combo)
    if k > k_max:
        raise ValueError(f"combo larger than max_episodes={k_max}")
    if any(not 0 <= x < m for x in combo) or list(combo) != sorted(set(combo)):
        raise ValueError(f"combo must be strictly increasing in [0, {m})")
    r = sum(math.comb(m, j) for j in range(k))
    prev = -1
    for i, x in enumerate(combo):
        for y in range(prev + 1, x):
            r += math.comb(m - y - 1, k - i - 1)
        prev = x
    return r


class Scenario:
    """One decoded scenario: the full-codec ``index`` is its stable
    name; ``combo`` holds alphabet indices."""

    __slots__ = ("index", "combo", "tier", "gate", "seed")

    def __init__(self, index, combo, tier, gate, seed):
        self.index = index
        self.combo = combo
        self.tier = tier
        self.gate = gate
        self.seed = seed


class ScopeEnum:
    """The scope's enumerator: alphabet, bijective codec, symmetry
    reduction, and scenario materialization."""

    def __init__(self, scope: McScope):
        self.scope = scope
        self.alphabet = episode_alphabet(scope)
        self.m = len(self.alphabet)
        self.n_combos = n_combos(self.m, scope.max_episodes)
        self.n_tiers = len(scope.knob_tiers)
        self.n_gates = len(scope.gate_tiers)
        self.n_seeds = len(scope.seeds)
        self.total = self.n_combos * self.n_tiers * self.n_gates * self.n_seeds
        self._index_of = {
            _table_key(e, scope.n_nodes): i
            for i, e in enumerate(self.alphabet)
        }
        self._perms = self._node_perms() if scope.symmetry_reduction else []
        if self._perms:
            self._check_closure()
        self.reduced = self._reduced_indices()

    # -- codec --

    def decode(self, index: int) -> Scenario:
        if not 0 <= index < self.total:
            raise IndexError(
                f"scenario index {index} outside [0, {self.total})"
            )
        r, seed = divmod(index, self.n_seeds)
        r, gate = divmod(r, self.n_gates)
        cr, tier = divmod(r, self.n_tiers)
        combo = combo_unrank(cr, self.m, self.scope.max_episodes)
        return Scenario(index, combo, tier, gate, seed)

    def encode(self, sc: Scenario) -> int:
        cr = combo_rank(sc.combo, self.m, self.scope.max_episodes)
        return (
            (cr * self.n_tiers + sc.tier) * self.n_gates + sc.gate
        ) * self.n_seeds + sc.seed

    # -- symmetry --

    def _node_perms(self):
        movable = list(range(self.scope.proposers, self.scope.n_nodes))
        perms = []
        for p in permutations(movable):
            if tuple(movable) == p:
                continue  # identity adds nothing to the orbit min
            perm = {i: i for i in range(self.scope.proposers)}
            perm.update(dict(zip(movable, p)))
            perms.append(perm)
        return perms

    def _check_closure(self) -> None:
        # the alphabet must be closed under the movable-node group, or
        # canonicalization would map a scenario outside the scope
        for i, e in enumerate(self.alphabet):
            for perm in self._perms:
                pe = _permute_episode(e, perm)
                if _table_key(pe, self.scope.n_nodes) not in self._index_of:
                    raise ScopeError(
                        f"alphabet not closed under node-permutation "
                        f"symmetry: letter {i} ({e.kind}[{e.t0},{e.t1})) "
                        "permutes outside the scope — enumerate the "
                        "full structure orbit or set "
                        "symmetry_reduction: false"
                    )

    def canon_combo(self, combo: tuple[int, ...]) -> tuple[int, ...]:
        """The combo's canonical orbit representative: the
        lexicographically-least index tuple over all movable-node
        permutations (idempotent — pinned by test)."""
        if not self._perms:
            return tuple(combo)
        best = tuple(combo)
        for perm in self._perms:
            mapped = tuple(sorted(
                self._index_of[
                    _table_key(
                        _permute_episode(self.alphabet[i], perm),
                        self.scope.n_nodes,
                    )
                ]
                for i in combo
            ))
            if mapped < best:
                best = mapped
        return best

    def combo_feasible(self, combo: tuple[int, ...]) -> bool:
        """A combo is dispatchable iff its scheduled crash points stay
        within the fail-stop minority cap ``(n_nodes - 1) // 2`` —
        beyond it no quorum survives and liveness is vacuously
        unjudgeable (the same cap the i.i.d. crash injection
        enforces), so those combos are excluded from the scenario set
        rather than reported as fake wedges."""
        crashed: set[int] = set()
        for i in combo:
            e = self.alphabet[i]
            if e.kind == "crash":
                crashed.update(e.nodes)
        return len(crashed) <= (self.scope.n_nodes - 1) // 2

    def _reduced_indices(self) -> list[int]:
        """Full-codec indices of the dispatched scenarios, increasing:
        canonical under the movable-node group (when reduction is on)
        AND feasible under the crash minority cap."""
        per_combo = self.n_tiers * self.n_gates * self.n_seeds
        out = []
        for cr in range(self.n_combos):
            combo = combo_unrank(cr, self.m, self.scope.max_episodes)
            if not self.combo_feasible(combo):
                continue
            if self._perms and self.canon_combo(combo) != combo:
                continue
            base = cr * per_combo
            out.extend(range(base, base + per_combo))
        return out

    # -- materialization --

    def schedule_of(self, sc: Scenario) -> fltm.FaultSchedule | None:
        if not sc.combo:
            return None
        return fltm.FaultSchedule(tuple(self.alphabet[i] for i in sc.combo))

    def faults_of(self, sc: Scenario) -> FaultConfig:
        return FaultConfig(**self.scope.knob_tiers[sc.tier])

    def describe(self, sc: Scenario) -> dict:
        """JSON-ready scenario description for counterexample
        reports."""
        sched = self.schedule_of(sc)
        return {
            "index": sc.index,
            "combo": list(sc.combo),
            "episodes": sched.to_dict()["episodes"] if sched else [],
            "knob_tier": dict(self.scope.knob_tiers[sc.tier]),
            "gates": bool(self.scope.gate_tiers[sc.gate]),
            "seed": int(self.scope.seeds[sc.seed]),
        }


# ---------------- chunked dispatch ----------------

# The padding rule is shared with the greedy shrinker's batched
# candidate evaluator (harness/shrink._runtime_batch_eval) and lives
# in its own stdlib-only module so the shrinker's replay-critical
# import closure never reaches this module's CLI machinery.
from tpu_paxos_torch.analysis.chunking import chunk_pad  # noqa: E402


def run_scope(
    scope: McScope,
    triage_dir: str | None = None,
    verbose: bool = True,
    max_counterexamples: int = 8,
    chunk_limit: int | None = None,
    device="cuda",
) -> dict:
    """Enumerate and dispatch the scope on ``device``; returns the
    JSON-ready summary (verdict bits, runner builds per chunk,
    counterexamples).  ``chunk_limit`` bounds the dispatched chunks (a
    verdict-bit PREFIX is then checked against the pinned certificate
    without paying the whole sweep), and the sweep stops early once
    ``max_counterexamples`` have been collected (wedged lanes burn the
    whole watchdog budget, so certifying a known-red scope is wasted
    work; an early-stopped run is never pinnable)."""
    from tpu_paxos_torch.analysis import triage as triage_mod
    from tpu_paxos_torch.fleet import envelope as env
    from tpu_paxos_torch.fleet import runner as frun
    from tpu_paxos_torch.harness import shrink as shr
    from tpu_paxos_torch.harness import stress as strs
    from tpu_paxos_torch.utils import device as devm
    from tpu_paxos_torch.utils import log as logm

    logger = logm.get_logger(
        "mc", logm.parse_level("INFO" if verbose else "WARN")
    )
    dev = devm.resolve(device)
    enum = ScopeEnum(scope)
    wl_rng = np.random.default_rng(scope.workload_seed)
    workload, gates, chains = strs._workload(
        scope.proposers, wl_rng, n_ids=scope.n_ids, n_free=scope.n_free
    )
    cfg = SimConfig(
        n_nodes=scope.n_nodes,
        n_instances=2 * sum(len(w) for w in workload),
        proposers=tuple(range(scope.proposers)),
        seed=0,
        max_rounds=scope.max_rounds,
    )
    # Shared envelope: the episode capacity floors at the fleet default
    # and the recorder is armed, as the JAX sweep's runner is (both are
    # decision-log-neutral).  The runner is built here, so the build is
    # counted from before it and charged to chunk 0.
    misses = env.cache_misses()
    runner = env.runner_for(
        cfg, workload, gates,
        max_episodes=max(scope.max_episodes, frun.MAX_EPISODES),
        telemetry=True, device=dev,
    )
    all_chunks = chunk_pad(enum.reduced, scope.chunk_lanes)
    chunks = all_chunks[:chunk_limit] if chunk_limit else all_chunks
    nibbles: list[str] = []
    compiles_per_chunk: list[int] = []
    counterexamples: list[dict] = []
    anomalies: list[dict] = []
    lanes_total = 0
    seconds = 0.0
    for ci, (chunk, n_real) in enumerate(chunks):
        scenarios = [enum.decode(i) for i in chunk]
        if ci:
            misses = env.cache_misses()
        rep = runner.run(
            [scope.seeds[sc.seed] for sc in scenarios],
            [enum.schedule_of(sc) for sc in scenarios],
            workloads=[
                (workload, gates if scope.gate_tiers[sc.gate] else None)
                for sc in scenarios
            ],
            knobs=[enum.faults_of(sc) for sc in scenarios],
        )
        compiles_per_chunk.append(env.cache_misses() - misses)
        lanes_total += n_real
        seconds += rep.seconds
        v = rep.verdict
        for li in range(n_real):
            ok, ag = bool(v.ok[li]), bool(v.agreement[li])
            cov, qu = bool(v.coverage[li]), bool(v.quiescent[li])
            nibbles.append(
                f"{(ok << 3) | (ag << 2) | (cov << 1) | qu:x}"
            )
            if ok:
                continue
            sc = scenarios[li]
            gated = bool(scope.gate_tiers[sc.gate])
            case = shr.ReproCase(
                cfg=rep.lane_cfg(li),
                workload=workload,
                gates=gates if gated else None,
                chains=chains if gated else [],
            )
            _, viol = shr.run_case(case, device=dev)
            if viol is None:
                # device subset flagged a lane the full suite clears —
                # surface the parity break, never hide it
                anomalies.append({
                    "scenario": enum.describe(sc),
                    "verdict": {"ok": ok, "agreement": ag,
                                "coverage": cov, "quiescent": qu},
                })
                continue
            cx = {
                "scenario": enum.describe(sc),
                "violation": viol[:300],
            }
            logger.error("COUNTEREXAMPLE scenario %d: %s", sc.index, viol)
            if triage_dir and len(counterexamples) < max_counterexamples:
                os.makedirs(triage_dir, exist_ok=True)
                # deterministic mc_ name: repeat runs overwrite, and the
                # analysis-dump retention cap applies
                path = os.path.join(
                    triage_dir,
                    triage_mod.dump_name("mc", f"scenario_{sc.index}", "json"),
                )
                try:
                    art = shr.triage(case, path, logger=logger, device=dev)
                    cx["artifact"] = path
                    cx["shrink_seconds"] = art.get("shrink_seconds")
                    triage_mod.prune(triage_dir)
                except Exception as te:  # triage must never mask a find
                    cx["triage_error"] = str(te)[:300]
            counterexamples.append(cx)
        if verbose and (ci % 8 == 0 or ci == len(chunks) - 1):
            logger.info(
                "chunk %d/%d: %d scenarios judged, %d counterexamples "
                "(%.1f lanes/sec)", ci + 1, len(chunks), lanes_total,
                len(counterexamples), rep.lanes_per_sec,
            )
        if len(counterexamples) >= max_counterexamples:
            logger.error(
                "counterexample budget (%d) reached after chunk %d/%d; "
                "stopping early", max_counterexamples, ci + 1, len(chunks),
            )
            chunks = chunks[:ci + 1]
            break
    bits = "".join(nibbles)
    return {
        "metric": "modelcheck",
        "backend": dev.type,
        "scope_sha256": scope.sha256(),
        "alphabet": enum.m,
        "combos": enum.n_combos,
        "scenarios_full": enum.total,
        "scenarios_reduced": len(enum.reduced),
        "chunk_lanes": scope.chunk_lanes,
        "chunks": len(all_chunks),
        "chunks_run": len(chunks),
        "lanes_judged": lanes_total,
        "lanes_per_sec": round(lanes_total / max(seconds, 1e-9), 2),
        "compiles_per_chunk": compiles_per_chunk,
        "verdict_bits": bits,
        "verdict_bits_sha256": hashlib.sha256(bits.encode()).hexdigest(),
        "counterexamples": counterexamples,
        "anomalies": anomalies,
        "seeded_wedge": _seeded_wedge_flag(),
        "ok": not counterexamples and not anomalies,
    }


def _seeded_wedge_flag() -> str:
    from tpu_paxos_torch.core import sim as simm

    return simm.seeded_wedge()


# ---------------- scope certificate ----------------

#: Certificate fields that must match exactly (the scope's shape); the
#: verdict bits are compared after them.
_CERT_SHAPE_FIELDS = (
    "scope_sha256", "alphabet", "combos", "scenarios_full",
    "scenarios_reduced", "chunk_lanes", "chunks",
)


def make_certificate(summary: dict) -> dict:
    """The pinnable subset of a FULL run's summary."""
    if summary["chunks_run"] != summary["chunks"]:
        raise ValueError(
            "cannot certify a chunk-limited run: the verdict bits "
            "must cover the whole reduced scope"
        )
    return {
        "version": 1,
        "backend": summary["backend"],
        **{f: summary[f] for f in _CERT_SHAPE_FIELDS},
        "verdict_bits": summary["verdict_bits"],
        "verdict_bits_sha256": summary["verdict_bits_sha256"],
        "counterexamples": len(summary["counterexamples"]),
    }


def check_certificate(pinned: dict, summary: dict, enum) -> list[str]:
    """Compare a run against the pinned certificate; returns failure
    strings (empty = pass).  A verdict drift names the first diverging
    scenario's full-codec index.

    Unlike the JAX checker, which compares verdict bits only on the
    backend that pinned them, this one compares them whatever device
    ran: the port's contract is bit equality with the JAX package on
    every device, and the committed certificates were pinned by JAX on
    the CPU.  ``pinned["backend"]`` is informational here."""
    fails = []
    for f in _CERT_SHAPE_FIELDS:
        if pinned.get(f) != summary[f]:
            fails.append(
                f"certificate field {f!r} drifted: pinned "
                f"{pinned.get(f)!r} vs measured {summary[f]!r} "
                "(scope edits re-pin with the JAX package's "
                "TPU_PAXOS_MC_PIN=1 make mc; copy its certificate here)"
            )
    if fails:
        return fails  # verdict bits are meaningless across scope drift
    old, new = pinned.get("verdict_bits", ""), summary["verdict_bits"]
    limit = min(len(old), len(new))
    for i in range(limit):
        if old[i] != new[i]:
            idx = enum.reduced[i]
            fails.append(
                f"verdict drifted at scenario index {idx} (reduced "
                f"position {i}): pinned nibble {old[i]} vs measured "
                f"{new[i]} — a new counterexample or an engine "
                "behavior change"
            )
            break
    else:
        if len(old) != len(new) and summary["chunks_run"] == summary["chunks"]:
            fails.append(
                f"verdict bit count drifted: pinned {len(old)} vs "
                f"measured {len(new)}"
            )
    return fails


def load_certificates(path: str = DEFAULT_CERT) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except OSError:
        return {}
    except json.JSONDecodeError as e:
        raise ScopeError(f"invalid certificate JSON: {e}") from None


def save_certificate(path: str, scope_name: str, cert: dict) -> None:
    certs = load_certificates(path)
    certs[scope_name] = cert
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(certs, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


# ---------------- CLI ----------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_paxos_torch mc",
        description="exhaustive bounded model checking: enumerate "
        "every fault scenario of a declared scope, dispatch them as "
        "lane-batched fleet dispatches, shrink any counterexample, and "
        "gate on the pinned scope certificate",
    )
    ap.add_argument("--scope", default="quick",
                    help="comma-separated scope name(s) in the scope "
                    "file (default: quick); scopes sharing an engine "
                    "envelope share its runner within one invocation")
    ap.add_argument("--scope-file", default=DEFAULT_SCOPE)
    ap.add_argument("--cert-file", default=DEFAULT_CERT)
    ap.add_argument("--chunk-limit", type=int, default=0,
                    help="dispatch at most this many chunks (0 = all; "
                    "a limited run is checked by verdict prefix)")
    ap.add_argument("--triage-dir", type=str, default="",
                    help="shrink counterexamples into mc_scenario_<i> "
                    "repro artifacts here")
    ap.add_argument("--max-counterexamples", type=int, default=8)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    names = [n for n in args.scope.split(",") if n]
    try:
        scopes = load_scopes(args.scope_file)
        plan = []
        for name in names:
            if name not in scopes:
                raise ScopeError(
                    f"scope {name!r} not in {args.scope_file} "
                    f"(available: {', '.join(sorted(scopes))})"
                )
            plan.append((name, scopes[name], enum_for(scopes[name])))
        if not plan:
            raise ScopeError("--scope named no scopes")
    except ScopeError as e:
        print(f"mc: {e}", file=sys.stderr)
        return 2
    rc = 0
    for name, scope, enum in plan:
        rc = max(rc, _run_one(name, scope, enum, args))
    return rc


def _run_one(name, scope, enum, args) -> int:
    """Run + certificate-gate one scope (any type); the CLI's exit
    code is the max over the listed scopes."""
    summary = run_for(scope)(
        scope,
        triage_dir=args.triage_dir or None,
        verbose=not args.quiet,
        max_counterexamples=args.max_counterexamples,
        chunk_limit=args.chunk_limit or None,
        device=args.device,
    )
    summary["scope"] = name
    pinned = load_certificates(args.cert_file).get(name)
    if pinned is None:
        cert_fails = [
            f"no pinned certificate for scope {name!r} in "
            f"{args.cert_file}; pin with the JAX package's "
            "TPU_PAXOS_MC_PIN=1 make mc and copy its certificate here"
        ]
    elif summary["chunks_run"] == summary["chunks"]:
        cert_fails = check_certificate(pinned, summary, enum)
    else:
        # chunk-limited smoke: the shape fields plus the verdict
        # PREFIX must agree
        cert_fails = check_certificate(
            dict(pinned,
                 verdict_bits=pinned.get("verdict_bits", "")[
                     : len(summary["verdict_bits"])
                 ]),
            summary, enum,
        )
    summary["certificate_failures"] = cert_fails
    ok = summary["ok"] and not cert_fails
    if args.json:
        print(json.dumps(summary, sort_keys=True))
    else:
        for fail in cert_fails:
            print(f"mc: {fail}", file=sys.stderr)
        status = "SCOPE CLEAN" if ok else "FAILED"
        print(
            f"[mc:{name}] {status} "
            f"({summary['scenarios_reduced']}/{summary['scenarios_full']} "
            f"scenarios post-reduction, {summary['chunks_run']}/"
            f"{summary['chunks']} chunks, "
            f"{len(summary['counterexamples'])} counterexamples, "
            f"compiles/chunk {summary['compiles_per_chunk'][:3]}...)"
        )
    return 0 if ok else 1


def audit_entries():
    """The mc lane surface's registered entry point
    (``analysis/registry.py``), JAX's canonical chunk: one 2-lane chunk of
    a tiny scope, decoded through the codec and dispatched as
    :func:`run_scope` stacks it (runtime schedule tables, knob vectors and
    per-lane gate toggles through the recorder-armed fleet runner)."""
    from tpu_paxos_torch.analysis.registry import AuditEntry
    from tpu_paxos_torch.fleet import runner as frun
    from tpu_paxos_torch.harness import stress as strs

    def build(device):
        scope = McScope.from_dict({
            "n_nodes": 3, "proposers": 2, "horizon": 12,
            "max_rounds": 64, "intervals": [[2, 8]],
            "kinds": ["pause", "burst"], "pause_set_sizes": [1],
            "burst_rates": [2000], "max_episodes": 2,
            "knob_tiers": [
                {"drop_rate": 500, "crash_rate": 1000, "max_delay": 2},
            ],
            "gate_tiers": [True, False],
            "seeds": [0], "chunk_lanes": 2, "n_ids": 2, "n_free": 2,
        })
        enum = ScopeEnum(scope)
        workload, gates, _ = strs._workload(
            scope.proposers, np.random.default_rng(scope.workload_seed),
            n_ids=scope.n_ids, n_free=scope.n_free,
        )
        cfg = SimConfig(
            n_nodes=scope.n_nodes, n_instances=2 * sum(len(w) for w in workload),
            proposers=(0, 1), seed=0, max_rounds=scope.max_rounds,
            faults=FaultConfig(max_delay=2),
        )
        runner = frun.FleetRunner(cfg, workload, gates, max_episodes=scope.max_episodes,
                                  telemetry=True, device=device)
        (chunk, _), = chunk_pad(enum.reduced[:2], scope.chunk_lanes)
        scenarios = [enum.decode(i) for i in chunk]

        def fn():
            return runner.run(
                [scope.seeds[sc.seed] for sc in scenarios],
                [enum.schedule_of(sc) for sc in scenarios],
                workloads=[(workload, gates if scope.gate_tiers[sc.gate] else None)
                           for sc in scenarios],
                knobs=[enum.faults_of(sc) for sc in scenarios],
            )

        return fn, ()

    return [AuditEntry("mc.run_chunk", build)]


if __name__ == "__main__":
    sys.exit(main())
