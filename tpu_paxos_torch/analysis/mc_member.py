"""mc churn scope on the port (port of ``tpu_paxos/analysis/mc_member.py``):
exhaustive bounded model checking of membership reconfiguration under
faults, through the member fleet.

``analysis/modelcheck.py`` certifies the GENERAL engine's fault
universe; this module is its membership sibling.  A declared
:class:`ChurnScope` (``mc_scope.json`` entries with ``"type":
"churn"``) quantizes the churn universe to a finite grid:

- **event letters** — one per (event kind x argument x quantized
  ``t0``): ``plain`` value injections (vids ``PLAIN_VID_BASE + i``),
  ``add`` / ``del`` acceptor changes (vids from
  ``membership.engine.change_vid``), injected at a ``t0_grid`` round;
- **churn variants** — ordered sequences of up to ``max_events``
  letters (distinct change vids, every ``del`` preceded by its
  ``add`` — the initial view is node 0 alone, so a bare delete names
  a non-member) crossed with per-event ``wait_gates`` (the first
  event is always ``WAIT_NONE``, the ``ChurnSchedule`` contract);
  variant 0 is the empty schedule — the fault-only baseline lane;
- **fault letters** — the SAME episode alphabet builder as the fault
  scopes (``modelcheck.episode_alphabet``), restricted to kinds the
  membership engine admits (:data:`MEMBER_UNSUPPORTED_KINDS` is the
  data-driven rejection table, ``modelcheck.UNSUPPORTED_KINDS``'s
  discipline).

The codec is ``index = ((variant * n_fault_combos + fault_rank) *
n_seeds + seed)`` — variants list-ranked in deterministic enumeration
order, fault combinations ranked by the combinatorial number system
(``modelcheck.combo_unrank``).  A scenario's index is its STABLE NAME
in certificates and failure messages, exactly like the fault scopes.

Feasibility (named rule, never silent): a scenario is dispatchable
iff its scheduled crash set is disjoint from ``{0} | targets`` —
node 0 is the harness driver (``membership.engine``'s
``_check_member_schedule`` rejects crashing it by name), and a crash
inside the churn's named acceptor set can leave an epoch's quorum
permanently unreachable, making liveness vacuously unjudgeable (the
membership analog of the fault scopes' crash minority cap).  There
is NO node-permutation reduction here: every add/del letter names a
node, so the movable-node group of the fault scopes is broken by
construction — the certificate's full and reduced counts differ only
by the feasibility rule.

Chunks dispatch through ``fleet/envelope.member_runner_for`` (the
shared member envelope: one runner build, charged to the first chunk,
and none after; ``compiles_per_chunk`` counts them, as
``modelcheck.run_scope`` does) and are judged by
``fleet/member_runner.member_lane_verdict`` ON DEVICE; the verdict
nibble is ``(ok << 3) | (quorum << 2) | (catchup << 1) | coverage``
(``completed`` folds into ``ok``).  Certificates ride the shared
machinery in ``modelcheck`` (same file, same
first-diverging-scenario drift naming).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from itertools import permutations, product

from tpu_paxos_torch.analysis import modelcheck as mcm
from tpu_paxos_torch.analysis.chunking import chunk_pad
from tpu_paxos_torch.core import faults as fltm
from tpu_paxos_torch.membership import churn_table as ctm

ScopeError = mcm.ScopeError

#: Episode kinds the MEMBERSHIP engine cannot take, kind -> reason —
#: the same data-driven rejection discipline as
#: ``modelcheck.UNSUPPORTED_KINDS`` (named rejection, never silent
#: exclusion).
MEMBER_UNSUPPORTED_KINDS: dict[str, str] = {
    "gray": (
        "the membership engine's synchronous network has no arrival "
        "calendar to inflate (membership/engine._check_member_schedule "
        "rejects gray by name); gray weather is certified by the "
        "fault scopes' gray axis"
    ),
}

#: Event-letter kinds, in enumeration order within a letter class.
EV_PLAIN, EV_ADD, EV_DEL = "plain", "add", "del"

#: Plain-value vid base: plain letter ``i`` injects vid ``BASE + i``
#: (well below ``membership.engine.CHANGE_BASE``, so plain and change
#: vids can never collide).
PLAIN_VID_BASE = 100


@dataclasses.dataclass(frozen=True)
class ChurnScope:
    """One declared churn-checking scope (module doc).  Plain data,
    stable serialization/hash — ``to_dict`` carries ``"type":
    "churn"`` so a churn scope can never hash-collide with a fault
    scope of coincidentally equal fields."""

    n_nodes: int
    n_instances: int
    max_rounds: int  # member-driver convergence budget
    horizon: int  # every fault episode (and t0) stays inside this
    plain_values: int = 1  # distinct plain-value letters
    add_targets: tuple = ()  # addable acceptors (never node 0)
    del_targets: tuple = ()  # deletable acceptors (subset of adds)
    t0_grid: tuple = (0,)  # quantized injection rounds
    wait_gates: tuple = (ctm.WAIT_NONE,)  # gates for events past the first
    max_events: int = 2  # schedule length cap
    # fault axis — the member-legal subset of the fault-scope grammar
    intervals: tuple = ()
    kinds: tuple = ()
    partition_group_sizes: tuple = (1,)
    pause_set_sizes: tuple = (1,)
    burst_rates: tuple = ()
    crash_rounds: tuple = ()
    crash_set_sizes: tuple = (1,)
    max_fault_episodes: int = 1
    seeds: tuple = (0,)
    crash_rate: int = 0  # i.i.d. knob — COMPILE-TIME in the member engine
    chunk_lanes: int = 16

    _FIELDS = (
        "n_nodes", "n_instances", "max_rounds", "horizon",
        "plain_values", "add_targets", "del_targets", "t0_grid",
        "wait_gates", "max_events", "intervals", "kinds",
        "partition_group_sizes", "pause_set_sizes", "burst_rates",
        "crash_rounds", "crash_set_sizes", "max_fault_episodes",
        "seeds", "crash_rate", "chunk_lanes",
    )

    @classmethod
    def from_dict(cls, d: dict) -> "ChurnScope":
        if not isinstance(d, dict):
            raise ScopeError("scope must be a JSON object")
        unknown = sorted(set(d) - set(cls._FIELDS))
        if unknown:
            raise ScopeError(f"unknown scope field(s): {', '.join(unknown)}")
        missing = [
            f for f in ("n_nodes", "n_instances", "max_rounds", "horizon")
            if f not in d
        ]
        if missing:
            raise ScopeError(f"scope missing field(s): {', '.join(missing)}")
        kw = dict(d)
        if "intervals" in kw:
            kw["intervals"] = tuple(
                (int(t0), int(t1)) for t0, t1 in kw["intervals"]
            )
        for f in ("add_targets", "del_targets", "t0_grid", "wait_gates",
                  "kinds", "partition_group_sizes", "pause_set_sizes",
                  "burst_rates", "crash_rounds", "crash_set_sizes",
                  "seeds"):
            if f in kw:
                kw[f] = tuple(kw[f])
        try:
            scope = cls(**kw)
        except TypeError as e:
            raise ScopeError(f"bad scope field types: {e}") from None
        scope.validate()
        return scope

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["intervals"] = [list(iv) for iv in self.intervals]
        for f in ("add_targets", "del_targets", "t0_grid", "wait_gates",
                  "kinds", "partition_group_sizes", "pause_set_sizes",
                  "burst_rates", "crash_rounds", "crash_set_sizes",
                  "seeds"):
            d[f] = list(d[f])
        d["type"] = "churn"
        return d

    def sha256(self) -> str:
        text = json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))
        return hashlib.sha256(text.encode()).hexdigest()

    def validate(self) -> None:
        if self.n_nodes < 2:
            raise ScopeError("n_nodes must be >= 2")
        if self.n_instances < 1:
            raise ScopeError("n_instances must be >= 1")
        if self.max_rounds < 1:
            raise ScopeError("max_rounds must be >= 1")
        if self.horizon < 1:
            raise ScopeError("horizon must be >= 1")
        if self.plain_values < 0:
            raise ScopeError("plain_values must be >= 0")
        for what, targets in (("add_targets", self.add_targets),
                              ("del_targets", self.del_targets)):
            if len(set(targets)) != len(targets):
                raise ScopeError(f"{what} must be distinct")
            for t in targets:
                if not 1 <= t < self.n_nodes:
                    raise ScopeError(
                        f"{what} entries must be in [1, n_nodes) — "
                        "node 0 is the harness driver"
                    )
        if not set(self.del_targets) <= set(self.add_targets):
            raise ScopeError(
                "del_targets must be a subset of add_targets: the "
                "initial view is node 0 alone, so a delete is only "
                "enumerable after its add"
            )
        if not self.t0_grid or len(set(self.t0_grid)) != len(self.t0_grid):
            raise ScopeError("t0_grid must be non-empty and distinct")
        for t0 in self.t0_grid:
            if not 0 <= t0 < self.horizon:
                raise ScopeError("t0_grid entries must be in [0, horizon)")
        gates = (ctm.WAIT_NONE, ctm.WAIT_CHOSEN, ctm.WAIT_APPLIED)
        if not self.wait_gates or len(set(self.wait_gates)) != len(
            self.wait_gates
        ):
            raise ScopeError("wait_gates must be non-empty and distinct")
        for w in self.wait_gates:
            if w not in gates:
                raise ScopeError(f"wait_gates entries must be in {gates}")
        if not 1 <= self.max_events <= ctm.MAX_EVENTS:
            raise ScopeError(
                f"max_events must be in [1, {ctm.MAX_EVENTS}]"
            )
        if not event_letters(self):
            raise ScopeError(
                "no churn letters: declare plain_values and/or "
                "add_targets"
            )
        bad = sorted(set(self.kinds) - set(fltm.KINDS))
        if bad:
            raise ScopeError(f"unknown episode kind(s): {', '.join(bad)}")
        for k in self.kinds:
            reason = MEMBER_UNSUPPORTED_KINDS.get(
                k, mcm.UNSUPPORTED_KINDS.get(k)
            )
            if reason is not None:
                raise ScopeError(
                    f"episode kind {k!r} is not enumerable by the "
                    f"churn checker: {reason}"
                )
        if self.kinds and not self.intervals:
            if set(self.kinds) != {"crash"}:
                raise ScopeError("interval kinds need intervals")
        for t0, t1 in self.intervals:
            if not 0 <= t0 < t1 <= self.horizon:
                raise ScopeError(
                    f"interval [{t0}, {t1}) must be non-empty inside "
                    f"[0, horizon={self.horizon}]"
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
                raise ScopeError("crash rounds must be in [0, horizon)")
        for sizes, what in (
            (self.partition_group_sizes, "partition_group_sizes"),
            (self.pause_set_sizes, "pause_set_sizes"),
            (self.crash_set_sizes, "crash_set_sizes"),
        ):
            for k in sizes:
                if not 1 <= k < self.n_nodes:
                    raise ScopeError(
                        f"{what} entries must be in [1, n_nodes)"
                    )
        if not 0 <= self.max_fault_episodes <= mcm.MAX_SCOPE_EPISODES:
            raise ScopeError(
                f"max_fault_episodes must be in "
                f"[0, {mcm.MAX_SCOPE_EPISODES}]"
            )
        if not self.seeds or len(set(self.seeds)) != len(self.seeds):
            raise ScopeError("seeds must be non-empty and distinct")
        if not 0 <= self.crash_rate <= 10_000:
            raise ScopeError("crash_rate must be in [0, 10000]")
        if self.chunk_lanes < 1:
            raise ScopeError("chunk_lanes must be >= 1")


def _fault_proxy(scope: ChurnScope) -> mcm.McScope:
    """A fault-scope view of the churn scope's fault axis, so the
    letter builder is SHARED with the fault scopes (one alphabet
    implementation — a grammar change cannot diverge between
    checkers).  Constructed directly (no validate): the churn
    validator already checked the member-legal subset."""
    return mcm.McScope(
        n_nodes=scope.n_nodes,
        proposers=1,
        horizon=scope.horizon,
        max_rounds=scope.max_rounds,
        intervals=scope.intervals or ((0, 1),),
        kinds=scope.kinds,
        partition_group_sizes=scope.partition_group_sizes,
        pause_set_sizes=scope.pause_set_sizes,
        burst_rates=scope.burst_rates,
        crash_rounds=scope.crash_rounds,
        crash_set_sizes=scope.crash_set_sizes,
        max_episodes=scope.max_fault_episodes,
    )


def event_letters(scope: ChurnScope) -> list[tuple]:
    """The churn event alphabet, deterministic order: plains, then
    adds, then dels; within a class, arguments in listed order x the
    ``t0_grid`` in listed order.  A letter is ``(kind, arg, t0)``."""
    out: list[tuple] = []
    for i in range(scope.plain_values):
        for t0 in scope.t0_grid:
            out.append((EV_PLAIN, int(i), int(t0)))
    for kind, targets in ((EV_ADD, scope.add_targets),
                          (EV_DEL, scope.del_targets)):
        for tgt in targets:
            for t0 in scope.t0_grid:
                out.append((kind, int(tgt), int(t0)))
    return out


def _seq_valid(letters: list[tuple], seq: tuple[int, ...]) -> bool:
    """A letter sequence materializes to a legal ChurnSchedule iff
    its vids are distinct (two t0 spellings of one event are the same
    vid) and every del's target was added earlier in the sequence."""
    vids: set = set()
    added: set = set()
    for li in seq:
        kind, arg, _ = letters[li]
        ident = (kind if kind == EV_PLAIN else kind, arg)
        if ident in vids:
            return False
        vids.add(ident)
        if kind == EV_DEL and arg not in added:
            return False
        if kind == EV_ADD:
            added.add(arg)
    return True


def churn_variants(scope: ChurnScope) -> list:
    """Every enumerable churn variant, deterministic order: variant 0
    is the EMPTY schedule (fault-only baseline lane); then by length,
    letter tuples in lexicographic index order, wait assignments in
    ``wait_gates`` listed order (mixed radix over positions >= 1 —
    the first event is forced ``WAIT_NONE``).  A variant is
    ``None`` or ``(letter_indices, waits)``."""
    letters = event_letters(scope)
    out: list = [None]
    for k in range(1, scope.max_events + 1):
        for seq in permutations(range(len(letters)), k):
            if not _seq_valid(letters, seq):
                continue
            for waits in product(scope.wait_gates, repeat=k - 1):
                out.append((seq, (ctm.WAIT_NONE,) + tuple(waits)))
    return out


class ChurnScenario:
    """One decoded churn scenario; ``index`` is its stable name."""

    __slots__ = ("index", "variant", "combo", "seed")

    def __init__(self, index, variant, combo, seed):
        self.index = index
        self.variant = variant  # variant list index
        self.combo = combo  # fault-alphabet index tuple
        self.seed = seed  # seed list index


class ChurnEnum:
    """The churn scope's enumerator: event letters, variant list,
    fault alphabet, bijective codec, feasibility filtering."""

    def __init__(self, scope: ChurnScope):
        self.scope = scope
        self.letters = event_letters(scope)
        self.variants = churn_variants(scope)
        self.n_variants = len(self.variants)
        self.fault_alphabet = mcm.episode_alphabet(_fault_proxy(scope))
        self.m = len(self.fault_alphabet)
        self.n_fault_combos = mcm.n_combos(
            self.m, scope.max_fault_episodes
        )
        self.n_seeds = len(scope.seeds)
        self.total = self.n_variants * self.n_fault_combos * self.n_seeds
        self.reduced = self._reduced_indices()

    # -- codec --

    def decode(self, index: int) -> ChurnScenario:
        if not 0 <= index < self.total:
            raise IndexError(
                f"scenario index {index} outside [0, {self.total})"
            )
        r, seed = divmod(index, self.n_seeds)
        vi, fr = divmod(r, self.n_fault_combos)
        combo = mcm.combo_unrank(
            fr, self.m, self.scope.max_fault_episodes
        )
        return ChurnScenario(index, vi, combo, seed)

    def encode(self, sc: ChurnScenario) -> int:
        fr = mcm.combo_rank(
            sc.combo, self.m, self.scope.max_fault_episodes
        )
        return (
            sc.variant * self.n_fault_combos + fr
        ) * self.n_seeds + sc.seed

    # -- feasibility --

    def variant_targets(self, vi: int) -> set:
        """The nodes a variant's change letters name."""
        v = self.variants[vi]
        if v is None:
            return set()
        return {
            self.letters[li][1]
            for li in v[0]
            if self.letters[li][0] != EV_PLAIN
        }

    def combo_feasible(self, combo: tuple, vi: int) -> bool:
        """Dispatchable iff scheduled crashes avoid ``{0} | targets``
        (module doc: the driver plus the churn's named acceptors —
        a crash inside the epoch acceptor set can wedge its quorum
        forever, making liveness vacuously unjudgeable)."""
        protected = {0} | self.variant_targets(vi)
        for i in combo:
            e = self.fault_alphabet[i]
            if e.kind == "crash" and set(e.nodes) & protected:
                return False
        return True

    def _reduced_indices(self) -> list[int]:
        out = []
        for vi in range(self.n_variants):
            for fr in range(self.n_fault_combos):
                combo = mcm.combo_unrank(
                    fr, self.m, self.scope.max_fault_episodes
                )
                if not self.combo_feasible(combo, vi):
                    continue
                base = (vi * self.n_fault_combos + fr) * self.n_seeds
                out.extend(range(base, base + self.n_seeds))
        return out

    # -- materialization --

    def churn_of(self, sc: ChurnScenario):
        v = self.variants[sc.variant]
        if v is None:
            return None
        from tpu_paxos_torch.membership import engine as meng

        seq, waits = v
        events = []
        for li, w in zip(seq, waits):
            kind, arg, t0 = self.letters[li]
            if kind == EV_PLAIN:
                vid = PLAIN_VID_BASE + arg
            elif kind == EV_ADD:
                vid = meng.change_vid(arg, meng.ADD_ACCEPTOR)
            else:
                vid = meng.change_vid(arg, meng.DEL_ACCEPTOR)
            events.append(
                ctm.ChurnEvent(vid=vid, t0=t0, wait=int(w))
            )
        return ctm.ChurnSchedule(tuple(events))

    def schedule_of(self, sc: ChurnScenario):
        if not sc.combo:
            return None
        return fltm.FaultSchedule(
            tuple(self.fault_alphabet[i] for i in sc.combo)
        )

    def describe(self, sc: ChurnScenario) -> dict:
        v = self.variants[sc.variant]
        sched = self.schedule_of(sc)
        return {
            "index": sc.index,
            "variant": sc.variant,
            "events": [] if v is None else [
                {
                    "kind": self.letters[li][0],
                    "arg": self.letters[li][1],
                    "t0": self.letters[li][2],
                    "wait": int(w),
                }
                for li, w in zip(v[0], v[1])
            ],
            "combo": list(sc.combo),
            "episodes": sched.to_dict()["episodes"] if sched else [],
            "seed": int(self.scope.seeds[sc.seed]),
        }


# ---------------- chunked dispatch ----------------

def run_scope(
    scope: ChurnScope,
    triage_dir: str | None = None,
    verbose: bool = True,
    max_counterexamples: int = 8,
    chunk_limit: int | None = None,
    device="cuda",
) -> dict:
    """Enumerate and dispatch the churn scope through the member fleet
    on ``device``; returns the ``modelcheck.run_scope``-shaped summary
    (same certificate machinery).  Counterexamples carry the failing
    lane's decision-log sha and a JSON description dump
    (``mc_member_scenario_<index>.json``): a member-fleet lane equals
    its single run, so the lane log is the replay surface."""
    from tpu_paxos_torch.analysis import triage as triage_mod
    from tpu_paxos_torch.fleet import envelope as env
    from tpu_paxos_torch.utils import device as devm
    from tpu_paxos_torch.utils import log as logm

    logger = logm.get_logger(
        "mc", logm.parse_level("INFO" if verbose else "WARN")
    )
    dev = devm.resolve(device)
    enum = ChurnEnum(scope)
    # the runner is built here: its build is charged to chunk 0
    misses = env.cache_misses()
    runner = env.member_runner_for(
        scope.n_nodes, scope.n_instances,
        crash_rate=scope.crash_rate,
        max_rounds=scope.max_rounds,
        device=dev,
    )
    all_chunks = chunk_pad(enum.reduced, scope.chunk_lanes)
    chunks = all_chunks[:chunk_limit] if chunk_limit else all_chunks
    nibbles: list[str] = []
    compiles_per_chunk: list[int] = []
    counterexamples: list[dict] = []
    lanes_total = 0
    seconds = 0.0
    for ci, (chunk, n_real) in enumerate(chunks):
        scenarios = [enum.decode(i) for i in chunk]
        if ci:
            misses = env.cache_misses()
        rep = runner.run(
            [scope.seeds[sc.seed] for sc in scenarios],
            [enum.churn_of(sc) for sc in scenarios],
            [enum.schedule_of(sc) for sc in scenarios],
        )
        compiles_per_chunk.append(env.cache_misses() - misses)
        lanes_total += n_real
        seconds += rep.seconds
        v = rep.verdict
        for li in range(n_real):
            ok, qu = bool(v.ok[li]), bool(v.quorum[li])
            cu, cov = bool(v.catchup[li]), bool(v.coverage[li])
            nibbles.append(
                f"{(ok << 3) | (qu << 2) | (cu << 1) | cov:x}"
            )
            if ok:
                continue
            sc = scenarios[li]
            log_text = rep.lane_log(li)
            cx = {
                "scenario": enum.describe(sc),
                "verdict": {
                    "quorum": qu, "catchup": cu, "coverage": cov,
                    "completed": bool(v.completed[li]),
                    "rounds": int(v.rounds[li]),
                },
                "decision_log_sha256": hashlib.sha256(
                    log_text.encode()
                ).hexdigest(),
            }
            logger.error(
                "COUNTEREXAMPLE churn scenario %d: %s",
                sc.index, json.dumps(cx["verdict"], sort_keys=True),
            )
            if triage_dir and len(counterexamples) < max_counterexamples:
                os.makedirs(triage_dir, exist_ok=True)
                path = os.path.join(
                    triage_dir,
                    triage_mod.dump_name(
                        "mc", f"member_scenario_{sc.index}", "json"
                    ),
                )
                with open(path, "w") as f:
                    json.dump(
                        dict(cx, scope_sha256=scope.sha256()),
                        f, indent=1, sort_keys=True,
                    )
                    f.write("\n")
                cx["artifact"] = path
                triage_mod.prune(triage_dir)
            counterexamples.append(cx)
        if verbose and (ci % 8 == 0 or ci == len(chunks) - 1):
            logger.info(
                "churn chunk %d/%d: %d scenarios judged, %d "
                "counterexamples (%.1f lanes/sec)",
                ci + 1, len(chunks), lanes_total,
                len(counterexamples), rep.lanes_per_sec,
            )
        if len(counterexamples) >= max_counterexamples:
            logger.error(
                "counterexample budget (%d) reached after chunk "
                "%d/%d; stopping early", max_counterexamples,
                ci + 1, len(chunks),
            )
            chunks = chunks[:ci + 1]
            break
    bits = "".join(nibbles)
    return {
        "metric": "modelcheck-member",
        "backend": dev.type,
        "scope_sha256": scope.sha256(),
        # shape pins (shared certificate fields): "alphabet" counts
        # EVERY letter — churn events plus fault episodes; "combos"
        # is the (variant x fault-combination) grid
        "alphabet": len(enum.letters) + enum.m,
        "combos": enum.n_variants * enum.n_fault_combos,
        "churn_letters": len(enum.letters),
        "churn_variants": enum.n_variants,
        "fault_alphabet": enum.m,
        "fault_combos": enum.n_fault_combos,
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
        "anomalies": [],
        "seeded_wedge": mcm._seeded_wedge_flag(),
        "ok": not counterexamples,
    }


def audit_entries():
    """The churn-chunk surface's registered entry point
    (``analysis/registry.py``), JAX's canonical chunk: one 2-lane chunk of
    a tiny churn scope, decoded through the codec and dispatched as
    :func:`run_scope` stacks it (runtime churn tables and fault masks
    through the member fleet runner)."""
    from tpu_paxos_torch.analysis.registry import AuditEntry
    from tpu_paxos_torch.fleet import member_runner as mfr

    def build(device):
        scope = ChurnScope.from_dict({
            "n_nodes": 3, "n_instances": 8, "max_rounds": 64,
            "horizon": 12, "plain_values": 1, "add_targets": [1],
            "del_targets": [], "t0_grid": [0],
            "wait_gates": [ctm.WAIT_NONE, ctm.WAIT_APPLIED],
            "max_events": 2, "intervals": [[2, 8]],
            "kinds": ["pause", "crash"], "pause_set_sizes": [1],
            "crash_rounds": [4], "crash_set_sizes": [1],
            "max_fault_episodes": 1, "seeds": [0], "crash_rate": 500,
            "chunk_lanes": 2,
        })
        enum = ChurnEnum(scope)
        runner = mfr.MemberFleetRunner(
            scope.n_nodes, scope.n_instances, max_episodes=2,
            crash_rate=scope.crash_rate, max_rounds=scope.max_rounds, device=device,
        )
        (chunk, _), = chunk_pad(enum.reduced[:2], scope.chunk_lanes)
        scenarios = [enum.decode(i) for i in chunk]

        def fn():
            return runner.run(
                [scope.seeds[sc.seed] for sc in scenarios],
                [enum.churn_of(sc) for sc in scenarios],
                [enum.schedule_of(sc) for sc in scenarios],
            )

        return fn, ()

    return [AuditEntry("mc.member_chunk", build)]
