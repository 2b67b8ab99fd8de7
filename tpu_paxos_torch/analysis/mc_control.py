"""mc controller scope on the port (port of
``tpu_paxos/analysis/mc_control.py``): exhaustive model checking of the
admission controller's policy invariants.

The cause-aware controller (``serve/control.py``) carries four
contracts: never shed on a gray-region window (the veto holds even
beside saturation), admit every value exactly once with TRUE arrival
stamps through deferral, step the ladder monotonically (degrade one rung
down, restore one rung up, never outside ``[0, top]``), and restore only
after ``patience`` calm dispatches.  Here they are machine-checked
invariants over an EXHAUSTIVE grid, riding the mc tier's codec /
chunking / certificate machinery (``mc_scope.json`` entries with
``"type": "control"``).

Two planes, one scenario index space:

- **host plane**: every (policy, dispatch-letter sequence) pair.  The
  policy grid is ``tier_bands x patiences x ladders`` (canonical cause
  table).  A dispatch letter is ``(cause-name window set, burn
  reading)``; the empty set is a quiet dispatch (the restore path's
  food).  Sequences of length ``1..max_dispatches`` are ranked by a
  length-stratified base-L positional codec.  Each scenario drives
  ``decide()`` through the letters and judges the trail against an
  INDEPENDENT oracle (:func:`judge_sequence`: predicted-state
  reconstruction, not a re-run of ``decide``'s code), then exercises the
  admission ledger (:func:`_admission_exact`): the sequence's degraded
  timeline replayed as floors over a tiered ``ControlledPlan``, drained
  floors-off, every vid exactly once with its original stamp.
- **e2e plane**: a small grid of REAL ``controlled_serve_run`` lanes on
  the card (policy-grid index x arrival seed) on a small shared
  geometry, judged by the SAME trail checker.  Device causes are
  saturation-plane: the serve stack has no gray-weather path, so gray
  letters exist only in the host plane, which is exactly where the
  seeded shed-on-gray wedge (``TPU_PAXOS_SEEDED_WEDGE=shed-on-gray``,
  ``serve/control.wedged_policy``) is provably FOUND: every gray-naming
  sequence under a wedged policy fails the veto invariant, shrinks
  greedily to a minimal sequence, and lands as a byte-replaying
  ``mc-control`` artifact (``python -m tpu_paxos_torch repro`` routes it
  back through :func:`reproduce`; the trail is pure host arithmetic, so
  replay is exact byte compare, and the artifacts are the JAX package's
  byte for byte).

There is no symmetry reduction: policy knobs and cause names pin every
identity, so full == reduced and the certificate's counts say so.  The
verdict nibble is ``(ok << 3) | (veto << 2) | (ladder << 1) |
admission``.  ``compiles_per_chunk`` counts envelope runner builds
(``fleet/envelope.cache_misses``): the first e2e cell builds the
controlled window, every later chunk builds nothing.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time

import numpy as np

from tpu_paxos_torch.analysis import modelcheck as mcm
from tpu_paxos_torch.analysis.chunking import chunk_pad
from tpu_paxos_torch.serve import arrivals as arrv
from tpu_paxos_torch.serve import control as ctl
from tpu_paxos_torch.telemetry import diagnose as diag

ScopeError = mcm.ScopeError

#: Artifact engine discriminator (``__main__.run_repro`` routes it).
ARTIFACT_ENGINE = "mc-control"

#: Sequence-length ceiling: the scenario count grows as ``L^k``.
MAX_CTL_DISPATCHES = 6


@dataclasses.dataclass(frozen=True)
class ControlScope:
    """One declared controller-checking scope (module doc).  Plain
    data, stable serialization/hash; ``to_dict`` carries ``"type":
    "control"``."""

    tier_bands: tuple  # ((n_tiers, defer_tier, shed_tier), ...)
    patiences: tuple
    ladders: tuple  # ladder tuples; () = fixed granularity
    window_sets: tuple  # cause-NAME tuples; () = quiet dispatch
    burn_tiers: tuple  # quantized burn readings (milli)
    max_dispatches: int = 3
    burn_low_milli: int = 500
    plan_values: int = 6  # per-stream values in the admission exercise
    chunk_lanes: int = 64
    e2e_policies: tuple = ()  # policy-grid indices run on device
    e2e_arrival_seeds: tuple = ()

    _FIELDS = (
        "tier_bands", "patiences", "ladders", "window_sets",
        "burn_tiers", "max_dispatches", "burn_low_milli",
        "plan_values", "chunk_lanes", "e2e_policies",
        "e2e_arrival_seeds",
    )

    @classmethod
    def from_dict(cls, d: dict) -> "ControlScope":
        if not isinstance(d, dict):
            raise ScopeError("scope must be a JSON object")
        unknown = sorted(set(d) - set(cls._FIELDS))
        if unknown:
            raise ScopeError(f"unknown scope field(s): {', '.join(unknown)}")
        missing = [
            f for f in ("tier_bands", "patiences", "ladders",
                        "window_sets", "burn_tiers")
            if f not in d
        ]
        if missing:
            raise ScopeError(f"scope missing field(s): {', '.join(missing)}")
        kw = dict(d)
        if "tier_bands" in kw:
            kw["tier_bands"] = tuple(
                tuple(int(x) for x in band) for band in kw["tier_bands"]
            )
        if "ladders" in kw:
            kw["ladders"] = tuple(
                tuple(int(s) for s in lad) for lad in kw["ladders"]
            )
        if "window_sets" in kw:
            kw["window_sets"] = tuple(
                tuple(str(nm) for nm in ws) for ws in kw["window_sets"]
            )
        for f in ("patiences", "burn_tiers", "e2e_policies",
                  "e2e_arrival_seeds"):
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
        d["tier_bands"] = [list(b) for b in self.tier_bands]
        d["ladders"] = [list(lad) for lad in self.ladders]
        d["window_sets"] = [list(ws) for ws in self.window_sets]
        for f in ("patiences", "burn_tiers", "e2e_policies",
                  "e2e_arrival_seeds"):
            d[f] = list(d[f])
        d["type"] = "control"
        return d

    def sha256(self) -> str:
        text = json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))
        return hashlib.sha256(text.encode()).hexdigest()

    def validate(self) -> None:
        if not self.tier_bands or len(set(self.tier_bands)) != len(
            self.tier_bands
        ):
            raise ScopeError("tier_bands must be non-empty and distinct")
        for band in self.tier_bands:
            if len(band) != 3:
                raise ScopeError(
                    "each tier band is (n_tiers, defer_tier, shed_tier)"
                )
            n_t, df, sh_ = band
            if not 1 <= df <= sh_ <= n_t:
                raise ScopeError(
                    f"tier band {band} must satisfy 1 <= defer <= "
                    "shed <= n_tiers"
                )
        if not self.patiences or len(set(self.patiences)) != len(
            self.patiences
        ):
            raise ScopeError("patiences must be non-empty and distinct")
        for p in self.patiences:
            if p < 1:
                raise ScopeError("patiences entries must be >= 1")
        if not self.ladders or len(set(self.ladders)) != len(self.ladders):
            raise ScopeError("ladders must be non-empty and distinct")
        for lad in self.ladders:
            if any(s < 1 for s in lad):
                raise ScopeError("ladder entries must be >= 1")
            if list(lad) != sorted(lad):
                raise ScopeError(f"ladder {lad} must ascend")
        if not self.window_sets or len(set(self.window_sets)) != len(
            self.window_sets
        ):
            raise ScopeError("window_sets must be non-empty and distinct")
        for ws in self.window_sets:
            if len(set(ws)) != len(ws):
                raise ScopeError(f"window set {ws} must be distinct")
            for nm in ws:
                if nm not in diag.CAUSE_IDS:
                    raise ScopeError(
                        f"unknown cause name {nm!r} (one of "
                        f"{sorted(diag.CAUSE_IDS)})"
                    )
        if not self.burn_tiers or len(set(self.burn_tiers)) != len(
            self.burn_tiers
        ):
            raise ScopeError("burn_tiers must be non-empty and distinct")
        for b in self.burn_tiers:
            if not 0 <= b <= 100_000:
                raise ScopeError("burn_tiers entries must be in [0, 100000]")
        if not 1 <= self.max_dispatches <= MAX_CTL_DISPATCHES:
            raise ScopeError(
                f"max_dispatches must be in [1, {MAX_CTL_DISPATCHES}]"
            )
        if self.burn_low_milli < 0:
            raise ScopeError("burn_low_milli must be >= 0")
        if not 1 <= self.plan_values <= 64:
            raise ScopeError("plan_values must be in [1, 64]")
        if self.chunk_lanes < 1:
            raise ScopeError("chunk_lanes must be >= 1")
        n_pol = (
            len(self.tier_bands) * len(self.patiences) * len(self.ladders)
        )
        if bool(self.e2e_policies) != bool(self.e2e_arrival_seeds):
            raise ScopeError(
                "e2e_policies and e2e_arrival_seeds come together "
                "(the e2e grid is their product)"
            )
        if len(set(self.e2e_policies)) != len(self.e2e_policies):
            raise ScopeError("e2e_policies must be distinct")
        for pi in self.e2e_policies:
            if not 0 <= pi < n_pol:
                raise ScopeError(
                    f"e2e_policies entry {pi} outside the policy grid "
                    f"[0, {n_pol})"
                )
        if len(set(self.e2e_arrival_seeds)) != len(self.e2e_arrival_seeds):
            raise ScopeError("e2e_arrival_seeds must be distinct")


def policy_grid(scope: ControlScope) -> list:
    """The policy axis, deterministic band x patience x ladder order,
    canonical cause table (``serve/control.default_table``)."""
    out = []
    for n_t, df, sh_ in scope.tier_bands:
        for pat in scope.patiences:
            for lad in scope.ladders:
                out.append(ctl.ControlPolicy(
                    n_tiers=n_t, defer_tier=df, shed_tier=sh_,
                    burn_low_milli=scope.burn_low_milli,
                    patience=pat, ladder=tuple(lad),
                ))
    return out


class CtlScenario:
    """One decoded controller scenario; ``index`` is its stable name.
    ``seq`` is the dispatch-letter index tuple (host plane) or None
    (e2e plane, ``e2e_seed`` set)."""

    __slots__ = ("index", "policy", "seq", "e2e_seed")

    def __init__(self, index, policy, seq, e2e_seed=None):
        self.index = index
        self.policy = policy  # policy-grid index
        self.seq = seq
        self.e2e_seed = e2e_seed


class ControlEnum:
    """The controller scope's enumerator: policy grid, dispatch
    letters, length-stratified sequence codec, e2e cell tail."""

    def __init__(self, scope: ControlScope):
        self.scope = scope
        self.policies = policy_grid(scope)
        self.n_policies = len(self.policies)
        self.letters = [
            (ws, int(b))
            for ws in scope.window_sets for b in scope.burn_tiers
        ]
        self.n_letters = len(self.letters)
        self.n_seq = sum(
            self.n_letters ** k
            for k in range(1, scope.max_dispatches + 1)
        )
        self.host_total = self.n_policies * self.n_seq
        self.n_e2e = (
            len(scope.e2e_policies) * len(scope.e2e_arrival_seeds)
        )
        self.total = self.host_total + self.n_e2e
        # no reduction: policy knobs and cause names pin every
        # identity — there is no node group to quotient by
        self.reduced = list(range(self.total))

    # -- sequence codec (length-stratified base-L positional) --

    def seq_unrank(self, r: int) -> tuple:
        k = 1
        while r >= self.n_letters ** k:
            r -= self.n_letters ** k
            k += 1
        digits = []
        for _ in range(k):
            r, d = divmod(r, self.n_letters)
            digits.append(d)
        return tuple(reversed(digits))

    def seq_rank(self, seq: tuple) -> int:
        off = sum(
            self.n_letters ** j for j in range(1, len(seq))
        )
        r = 0
        for d in seq:
            r = r * self.n_letters + d
        return off + r

    # -- scenario codec --

    def decode(self, index: int) -> CtlScenario:
        if not 0 <= index < self.total:
            raise IndexError(
                f"scenario index {index} outside [0, {self.total})"
            )
        if index < self.host_total:
            pi, sr = divmod(index, self.n_seq)
            return CtlScenario(index, pi, self.seq_unrank(sr))
        ei = index - self.host_total
        a, b = divmod(ei, len(self.scope.e2e_arrival_seeds))
        return CtlScenario(
            index, int(self.scope.e2e_policies[a]), None,
            e2e_seed=int(self.scope.e2e_arrival_seeds[b]),
        )

    def encode(self, sc: CtlScenario) -> int:
        if sc.seq is not None:
            return sc.policy * self.n_seq + self.seq_rank(sc.seq)
        a = self.scope.e2e_policies.index(sc.policy)
        b = self.scope.e2e_arrival_seeds.index(sc.e2e_seed)
        return (
            self.host_total
            + a * len(self.scope.e2e_arrival_seeds) + b
        )

    def policy_of(self, pi: int) -> ctl.ControlPolicy:
        """Materialize policy ``pi`` — the seeded shed-on-gray wedge
        rewrites the table here when armed (module doc)."""
        p = self.policies[pi]
        return ctl.wedged_policy(p) if ctl.seeded_policy_wedge() else p

    def describe(self, sc: CtlScenario) -> dict:
        d = {
            "index": sc.index,
            "policy": ctl.policy_to_dict(self.policy_of(sc.policy)),
            "policy_index": sc.policy,
        }
        if sc.seq is not None:
            d["sequence"] = [
                {
                    "causes": list(self.letters[li][0]),
                    "burn_milli": self.letters[li][1],
                }
                for li in sc.seq
            ]
        else:
            d["arrival_seed"] = int(sc.e2e_seed)
        return d


# ---------------- the host-plane oracle -----------------------------


def _trail_legal(policy: ctl.ControlPolicy, decisions) -> bool:
    """Ladder/flag transition legality of a decision trail, judged by
    predicted-state reconstruction (shared by both planes): degrade
    steps exactly one rung down (floor 0) and arms degradation, hold
    changes neither, restore steps exactly one rung up (cap top),
    disarms, and only fires when something was degraded or below
    top."""
    level, degraded = policy.top_level, False
    for dc in decisions:
        act = dc["action"]
        if act == "degrade":
            level = max(0, level - 1)
            if dc["level"] != level or not dc["degraded"]:
                return False
            degraded = True
        elif act == "hold":
            if dc["level"] != level or dc["degraded"] != degraded:
                return False
        elif act == "restore":
            if not (degraded or level < policy.top_level):
                return False
            level = min(policy.top_level, level + 1)
            if dc["level"] != level or dc["degraded"]:
                return False
            degraded = False
        else:
            return False
    return True


def judge_sequence(
    policy: ctl.ControlPolicy, letters, plan_values: int,
):
    """Drive ``decide()`` through materialized dispatch letters
    (``(cause-name tuple, burn_milli)`` pairs, dispatch ``d`` naming
    window ``d``) and judge the trail:

    - **veto** — no degrade decision covers a gray-naming window;
    - **ladder** — every named breach decides, transitions are
      :func:`_trail_legal`, restore fires exactly when owed
      (``patience`` consecutive calm low-burn dispatches AND degraded
      or below top — both directions: an early restore and a missed
      restore each break the bit);
    - **admission** — :func:`_admission_exact` over the sequence's
      degraded-floor timeline.

    Returns ``(decisions, bits)``."""
    gray = diag.CAUSE_IDS["gray-region"]
    st = ctl.ControllerState(level=policy.top_level)
    decisions: list = []
    veto_ok = ladder_ok = True
    quiet_run = 0  # decide's calm counter, tracked independently
    degr_timeline: list = []
    for d, (names, burn) in enumerate(letters, start=1):
        degr_timeline.append(st.degraded)
        new_windows = (
            [] if not names else
            [(d, tuple(sorted(diag.CAUSE_IDS[nm] for nm in names)))]
        )
        pre_level, pre_degraded = st.level, st.degraded
        dec = ctl.decide(
            policy, st, dispatch=d, burn_milli=burn,
            new_windows=new_windows,
        )
        if dec is None:
            if new_windows:
                ladder_ok = False  # a named breach must decide
            if burn <= policy.burn_low_milli:
                if quiet_run + 1 >= policy.patience and (
                    pre_degraded or pre_level < policy.top_level
                ):
                    ladder_ok = False  # restore owed, not granted
                quiet_run += 1
            else:
                quiet_run = 0
            continue
        decisions.append(dec)
        if dec["action"] == "degrade" and any(
            gray in cs for w, cs in new_windows if w in dec["windows"]
        ):
            veto_ok = False
        if dec["action"] == "restore":
            if not (
                burn <= policy.burn_low_milli
                and quiet_run + 1 >= policy.patience
                and (pre_degraded or pre_level < policy.top_level)
            ):
                ladder_ok = False  # restore granted, not owed
        quiet_run = 0
    ladder_ok = ladder_ok and _trail_legal(policy, decisions)
    admission_ok = _admission_exact(policy, degr_timeline, plan_values)
    return decisions, {
        "veto": veto_ok, "ladder": ladder_ok, "admission": admission_ok,
    }


def _collect(adm, arr, keep, admitted: dict, shed: dict) -> bool:
    ok = True
    p, k = adm.shape
    for pi in range(p):
        for s in range(k):
            vid = int(adm[pi, s])
            if vid < 0:
                continue
            if vid in admitted or vid in shed:
                ok = False  # a vid may leave the queue exactly once
            bucket = admitted if keep[pi, s] else shed
            bucket[vid] = int(arr[pi, s])
    return ok


def _admission_exact(
    policy: ctl.ControlPolicy, degr_timeline, plan_values: int,
) -> bool:
    """Exactly-once / true-stamp admission over a small two-stream
    tiered plan: the sequence's degraded timeline replays as floors,
    then the plan drains floors-off (the restore path pulls every
    deferred value).  Checks: each vid admitted XOR shed exactly
    once, union complete, admitted stamps equal the original
    arrivals (deferral never re-stamps), the shed ledger names only
    shed-band tiers and agrees with the count."""
    v = int(plan_values)
    streams = [
        np.arange(v, dtype=np.int32),
        np.arange(100, 100 + v, dtype=np.int32),
    ]
    arrivals = [
        np.arange(v, dtype=np.int32) * 3,
        np.arange(v, dtype=np.int32) * 3 + 1,
    ]
    prios = [
        np.arange(v, dtype=np.int32) % policy.n_tiers,
        (np.arange(v, dtype=np.int32) + 1) % policy.n_tiers,
    ]
    plan = ctl.ControlledPlan(streams, arrivals, prios, 4)
    k = max(plan.max_block, 1) + 2
    stamp = {
        int(vid): int(ar)
        for s, a in zip(streams, arrivals)
        for vid, ar in zip(s, a)
    }
    admitted: dict = {}
    shed: dict = {}
    ok = True
    j = 0
    for degraded in degr_timeline:
        if plan.exhausted:
            break
        sf = policy.shed_tier if degraded else None
        df = policy.defer_tier if degraded else None
        adm, arr, keep = plan.take(
            j, k, shed_floor=sf, defer_floor=df
        )
        j += 1
        ok &= _collect(adm, arr, keep, admitted, shed)
    while not plan.exhausted and j < plan.n_windows + 64:
        adm, arr, keep = plan.take(j, k)
        j += 1
        ok &= _collect(adm, arr, keep, admitted, shed)
    ok &= plan.exhausted
    ok &= not (set(admitted) & set(shed))
    ok &= (set(admitted) | set(shed)) == set(stamp)
    ok &= len(shed) == plan.shed_count == len(plan.shed_records)
    ok &= all(stamp[vid] == ar for vid, ar in admitted.items())
    ok &= all(
        r["tier"] >= policy.shed_tier for r in plan.shed_records
    )
    return bool(ok)


def violation_of(bits: dict) -> str | None:
    if not bits["veto"]:
        return "ctl-gray-veto"
    if not bits["ladder"]:
        return "ctl-ladder"
    if not bits["admission"]:
        return "ctl-admission"
    return None


def shrink_sequence(
    policy: ctl.ControlPolicy, letters_all, seq: tuple,
    plan_values: int,
) -> tuple:
    """Greedy dispatch-letter drop to fixpoint, preserving SOME
    violation (the mc fault scopes' shrink philosophy: the smallest
    sequence that still breaks a contract)."""

    def violated(s):
        _, bits = judge_sequence(
            policy, [letters_all[li] for li in s], plan_values
        )
        return violation_of(bits) is not None

    cur = list(seq)
    changed = True
    while changed:
        changed = False
        for i in range(len(cur)):
            cand = cur[:i] + cur[i + 1:]
            if cand and violated(tuple(cand)):
                cur = cand
                changed = True
                break
    return tuple(cur)


# ---------------- the repro artifact --------------------------------


def save_ctl_artifact(
    path: str, scope: ControlScope, policy: ctl.ControlPolicy,
    letters, violation: str, decisions,
) -> dict:
    """Self-contained mc-control artifact: the (possibly wedged)
    policy, the materialized dispatch letters, the violation, and the
    trail with its control-log sha — everything :func:`reproduce`
    needs, independent of the wedge env var at replay time."""
    art = {
        "engine": ARTIFACT_ENGINE,
        "scope_sha256": scope.sha256(),
        "plan_values": int(scope.plan_values),
        "policy": ctl.policy_to_dict(policy),
        "sequence": [
            {"causes": list(names), "burn_milli": int(b)}
            for names, b in letters
        ],
        "violation": violation,
        "decisions": decisions,
        "control_log_sha256": hashlib.sha256(
            ctl.control_log(decisions).encode()
        ).hexdigest(),
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(art, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return art


def reproduce(path: str, device=None) -> dict:
    """Re-execute an mc-control artifact.  The decide() trail is pure
    host arithmetic, so replay is exact: ``match`` iff the control
    log byte-compares equal (sha256) AND the decision trail AND the
    violation are identical.  ``device`` is accepted for the ``repro``
    CLI's uniform call and unused: nothing runs on a device."""
    from tpu_paxos_torch.analysis.artifact_schema import ArtifactSchemaError

    try:
        with open(path) as f:
            art = json.load(f)
    except OSError as e:
        raise ArtifactSchemaError(
            "", f"unreadable artifact: {e}"
        ) from None
    except json.JSONDecodeError as e:
        raise ArtifactSchemaError(
            "", f"invalid JSON (truncated write?): {e}"
        ) from None
    if not isinstance(art, dict):
        raise ArtifactSchemaError("", "artifact must be a JSON object")
    for field in ("engine", "policy", "sequence", "violation",
                  "decisions", "control_log_sha256", "plan_values"):
        if field not in art:
            raise ArtifactSchemaError(
                field, "missing mc-control artifact field"
            )
    if art["engine"] != ARTIFACT_ENGINE:
        raise ArtifactSchemaError(
            "engine", "not an mc-control artifact"
        )
    policy = ctl.policy_from_dict(art["policy"])
    letters = [
        (tuple(e["causes"]), int(e["burn_milli"]))
        for e in art["sequence"]
    ]
    decisions, bits = judge_sequence(
        policy, letters, art["plan_values"]
    )
    violation = violation_of(bits) or "none"
    sha = hashlib.sha256(
        ctl.control_log(decisions).encode()
    ).hexdigest()
    return {
        "artifact": path,
        "engine": ARTIFACT_ENGINE,
        "violation": violation,
        "recorded_violation": art["violation"],
        "decision_log": ctl.control_log(decisions),
        "decision_log_sha256": sha,
        "recorded_sha256": art["control_log_sha256"],
        "decisions_match": decisions == art["decisions"],
        "match": (
            sha == art["control_log_sha256"]
            and decisions == art["decisions"]
            and violation == art["violation"]
        ),
    }


# ---------------- the e2e device cells ------------------------------


def _run_e2e_cell(enum: ControlEnum, sc: CtlScenario, device="cuda"):
    """One device lane: the controller driving a REAL controlled serve
    run on ``device`` at a small shared geometry (3 nodes, 48 instances),
    arrival seed varying per cell, judged by the same trail checker
    as the host plane plus the on-device exactly-once ledger (shed
    vids distinct, never chosen).  Completion (``done``/backlog) is
    reported, not judged: it is workload-dependent, not a policy
    contract."""
    from tpu_paxos_torch.config import FaultConfig, SimConfig
    from tpu_paxos_torch.serve import harness as sh

    policy = enum.policy_of(sc.policy)
    wl = [
        np.arange(0, 10, dtype=np.int32),
        np.arange(20, 30, dtype=np.int32),
    ]
    rounds = arrv.poisson_rounds(20, 4000, int(sc.e2e_seed))
    arrs = [np.sort(rounds[0::2]), np.sort(rounds[1::2])]
    prios = [
        arrv.tier_priorities(w, n_tiers=policy.n_tiers) for w in wl
    ]
    cfg = SimConfig(
        n_nodes=3, n_instances=48, proposers=(0, 1), seed=3,
        max_rounds=4000,
        faults=FaultConfig(drop_rate=500, dup_rate=1000, max_delay=2),
    )
    slo = sh.ServeSLO(latency_rounds=16, budget_milli=150)
    rep = ctl.controlled_serve_run(
        cfg, wl, arrs, priorities=prios, control=policy,
        rounds_per_window=8, windows_per_dispatch=2, admit_width=10,
        window_rounds=32, slo=slo, device=device,
    )
    gray = diag.CAUSE_IDS["gray-region"]
    veto = not any(
        dc["action"] == "degrade" and gray in dc["cause_ids"]
        for dc in rep.decisions
    )
    ladder = _trail_legal(policy, rep.decisions)
    shed_vids = [r["vid"] for r in rep.sheds]
    chosen = {int(v) for v in np.asarray(rep.chosen_vid) if v >= 0}
    once = (
        len(shed_vids) == len(set(shed_vids))
        and not (set(shed_vids) & chosen)
    )
    bits = {"veto": veto, "ladder": ladder, "admission": once}
    info = {
        "arrival_seed": int(sc.e2e_seed),
        "dispatches": int(rep.dispatches),
        "decisions": len(rep.decisions),
        "shed": int(rep.shed_count),
        "done": bool(rep.done),
        "backlog": int(rep.backlog),
        "decision_log_sha256": rep.decision_log_sha256,
    }
    return bits, rep.decisions, info


# ---------------- chunked dispatch ----------------------------------


def run_scope(
    scope: ControlScope,
    triage_dir: str | None = None,
    verbose: bool = True,
    max_counterexamples: int = 8,
    chunk_limit: int | None = None,
    device="cuda",
) -> dict:
    """Enumerate and judge the controller scope; returns the
    ``modelcheck.run_scope``-shaped summary.  The e2e cells run FIRST on
    ``device`` (one chunk each: the first builds the shared controlled
    window, so every later chunk reports zero builds) and the host plane
    follows in ``chunk_lanes``-sized chunks; verdict nibbles are
    assembled in scenario-index order regardless.  Host counterexamples
    shrink greedily and land as byte-replaying mc-control artifacts
    through the triage stack."""
    from tpu_paxos_torch.analysis import triage as triage_mod
    from tpu_paxos_torch.fleet import envelope as env
    from tpu_paxos_torch.utils import device as devm
    from tpu_paxos_torch.utils import log as logm

    logger = logm.get_logger(
        "mc", logm.parse_level("INFO" if verbose else "WARN")
    )
    dev = devm.resolve(device)
    enum = ControlEnum(scope)
    host_chunks = chunk_pad(
        list(range(enum.host_total)), scope.chunk_lanes
    )
    work = [
        ("e2e", i) for i in range(enum.host_total, enum.total)
    ] + [("host", ch) for ch in host_chunks]
    n_chunks = len(work)
    if chunk_limit:
        work = work[:chunk_limit]
    nibble_by_idx: dict = {}
    compiles_per_chunk: list[int] = []
    counterexamples: list[dict] = []
    lanes_total = 0
    t0 = time.perf_counter()  # paxlint: allow[DET001] lanes/sec metric only; never reaches artifacts
    for ci, (kind, item) in enumerate(work):
        before = env.cache_misses()
        judged = []
        if kind == "e2e":
            sc = enum.decode(item)
            bits, decisions, info = _run_e2e_cell(enum, sc, device=dev)
            judged.append((sc, bits, decisions, info))
        else:
            chunk, n_real = item
            for idx in chunk[:n_real]:
                sc = enum.decode(idx)
                policy = enum.policy_of(sc.policy)
                letters = [enum.letters[li] for li in sc.seq]
                decisions, bits = judge_sequence(
                    policy, letters, scope.plan_values
                )
                judged.append((sc, bits, decisions, None))
        compiles_per_chunk.append(env.cache_misses() - before)
        lanes_total += len(judged)
        for sc, bits, decisions, info in judged:
            ok = bits["veto"] and bits["ladder"] and bits["admission"]
            nib = (
                (ok << 3) | (bits["veto"] << 2)
                | (bits["ladder"] << 1) | bits["admission"]
            )
            nibble_by_idx[sc.index] = f"{nib:x}"
            if ok:
                continue
            viol = violation_of(bits)
            cx = {
                "scenario": enum.describe(sc),
                "violation": viol,
            }
            if info is not None:
                cx["e2e"] = info
            logger.error(
                "COUNTEREXAMPLE control scenario %d: %s", sc.index, viol,
            )
            if (
                sc.seq is not None and triage_dir
                and len(counterexamples) < max_counterexamples
            ):
                policy = enum.policy_of(sc.policy)
                small = shrink_sequence(
                    policy, enum.letters, sc.seq, scope.plan_values,
                )
                letters = [enum.letters[li] for li in small]
                sdec, sbits = judge_sequence(
                    policy, letters, scope.plan_values
                )
                os.makedirs(triage_dir, exist_ok=True)
                path = os.path.join(
                    triage_dir,
                    triage_mod.dump_name(
                        "mc", f"ctl_scenario_{sc.index}", "json"
                    ),
                )
                save_ctl_artifact(
                    path, scope, policy, letters,
                    violation_of(sbits) or viol, sdec,
                )
                cx["artifact"] = path
                cx["shrunk_dispatches"] = len(small)
                triage_mod.prune(triage_dir)
            counterexamples.append(cx)
        if verbose and (ci % 16 == 0 or ci == len(work) - 1):
            logger.info(
                "control chunk %d/%d: %d scenarios judged, %d "
                "counterexamples", ci + 1, len(work), lanes_total,
                len(counterexamples),
            )
        if len(counterexamples) >= max_counterexamples:
            logger.error(
                "counterexample budget (%d) reached after chunk "
                "%d/%d; stopping early", max_counterexamples,
                ci + 1, len(work),
            )
            break
    seconds = time.perf_counter() - t0  # paxlint: allow[DET001] lanes/sec metric only; never reaches artifacts
    bits_str = "".join(
        nibble_by_idx[i] for i in sorted(nibble_by_idx)
    )
    return {
        "metric": "modelcheck-control",
        "backend": dev.type,
        "scope_sha256": scope.sha256(),
        # shape pins (shared certificate fields): "alphabet" counts
        # dispatch letters, "combos" the bounded sequences
        "alphabet": enum.n_letters,
        "combos": enum.n_seq,
        "policies": enum.n_policies,
        "e2e_cells": enum.n_e2e,
        "scenarios_full": enum.total,
        "scenarios_reduced": len(enum.reduced),
        "chunk_lanes": scope.chunk_lanes,
        "chunks": n_chunks,
        "chunks_run": len(compiles_per_chunk),
        "lanes_judged": lanes_total,
        "lanes_per_sec": round(lanes_total / max(seconds, 1e-9), 2),
        "compiles_per_chunk": compiles_per_chunk,
        "verdict_bits": bits_str,
        "verdict_bits_sha256": hashlib.sha256(
            bits_str.encode()
        ).hexdigest(),
        "counterexamples": counterexamples,
        "anomalies": [],
        "seeded_wedge": mcm._seeded_wedge_flag(),
        "ok": not counterexamples,
    }
