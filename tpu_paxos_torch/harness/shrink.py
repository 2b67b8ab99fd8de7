"""Failure triage (port of ``tpu_paxos/harness/shrink.py``): greedy
shrinking of a failing stress case into a minimal, one-command repro
artifact.

When a stress seed violates an invariant, the question is which part of
the fault schedule makes the violation happen.  This module re-runs the
deterministic case under progressively smaller inputs and keeps every
reduction that still fails:

1. drop whole episodes from the ``FaultSchedule`` (greedy, to a fixed
   point);
2. narrow each surviving episode's ``[t0, t1)`` interval by bisection,
   and halve surviving gray episodes' delay inflation;
3. collapse a per-edge fault matrix (``cfg.faults.edges``): drop it, else
   flatten it to the equivalent uniform scalar knobs;
4. zero the i.i.d. fault knobs (drop/dup/delay/crash) and the
   ``delivery_cut`` flag one at a time;
5. minimize the seed (try 0 and successive bisections toward 0).

The result is written as a JSON repro artifact, self-contained (config,
workload, gates, in-order chains, extra checks, the violation text and
the decision-log sha256), which ``python -m tpu_paxos_torch repro
<artifact>`` re-executes byte for byte.  The artifact format is the JAX
package's: each package replays the other's artifacts, and for the same
case both write the same bytes.

Every candidate is judged on the general engine: the initial failure and
the artifact pin by ``core/sim.run`` (``run_case``), the shrink moves by
the envelope's runtime-schedule, runtime-knob fleet runner
(``fleet/envelope.runner_for``), one lane per candidate, or
``SHRINK_BATCH_LANES`` candidates a dispatch.  A fleet lane equals the
single run of its ``lane_cfg``, so both judges agree.  Each entry point
takes the ``device`` its runs go to (default ``"cuda"``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np

from tpu_paxos_torch.analysis.artifact_schema import (
    ARTIFACT_FORMAT,
    ArtifactSchemaError,
    validate_artifact,
)
from tpu_paxos_torch.config import (
    EdgeFaultConfig,
    FaultConfig,
    ProtocolConfig,
    SimConfig,
)
from tpu_paxos_torch.core import faults as fltm
from tpu_paxos_torch.core import sim as simm
from tpu_paxos_torch.harness import validate
from tpu_paxos_torch.replay.decision_log import decision_log

# Cap on shrink re-runs: each candidate evaluation is a full engine run.
# The greedy passes converge long before this in practice.
MAX_EVALS = 200


@dataclasses.dataclass
class ReproCase:
    """A fully-specified deterministic run plus its judgment criteria.

    ``engine`` selects the runner that re-executes the case: ``"sim"``
    (``core/sim.run``) or ``"sharded"`` (``parallel/sharded_sim.run_sharded``
    over a ``devices``-rank mesh).  The sharded engine's placement differs
    from the unsharded one's, so its decision logs compare only with
    sharded replays at the same rank count."""

    cfg: SimConfig
    workload: list[np.ndarray]
    gates: list[np.ndarray] | None
    chains: list[np.ndarray]  # in-order client chains (may be empty)
    extra_checks: dict = dataclasses.field(default_factory=dict)
    engine: str = "sim"
    devices: int = 1

    def with_faults(self, faults: FaultConfig) -> "ReproCase":
        return dataclasses.replace(
            self, cfg=dataclasses.replace(self.cfg, faults=faults)
        )

    def with_schedule(self, sched: fltm.FaultSchedule | None) -> "ReproCase":
        if sched is not None and not sched.episodes:
            sched = None
        return self.with_faults(
            dataclasses.replace(self.cfg.faults, schedule=sched)
        )


def validate_run(r, cfg: SimConfig, workload, chains) -> None:
    """Crash-aware invariant suite shared by the stress sweep and the
    shrinker: safety (agreement, executed-identical, at-most-once,
    only-workload values) holds unconditionally; liveness is owed only
    to values whose proposer survived (a crashed proposer's undrained
    queue is legitimately lost).  Paused/partitioned proposers get no
    such waiver: after the last heal their values are owed."""
    crashed_props = [
        i for i, node in enumerate(cfg.proposers) if r.crashed[node]
    ]
    full = np.unique(np.concatenate(workload))
    if not crashed_props:
        seqs = validate.check_all(r.learned, full)
    else:
        validate.check_agreement(r.learned)
        seqs = validate.check_executed_identical(r.learned)
        validate.check_exactly_once(r.learned, None)  # at most once
        chosen = r.chosen_vid[r.chosen_vid >= 0]
        extra = np.setdiff1d(chosen, full)
        if extra.size:
            raise validate.InvariantViolation(
                f"non-workload values chosen: {extra[:8].tolist()}"
            )
        live = [
            w for i, w in enumerate(workload) if i not in crashed_props
        ]
        if live:  # with every proposer crashed, no liveness is owed
            missing = np.setdiff1d(np.unique(np.concatenate(live)), chosen)
            if missing.size:
                raise validate.InvariantViolation(
                    f"surviving proposers' values never chosen: "
                    f"{missing[:8].tolist()}"
                )
    live_chains = [
        ch for i, ch in enumerate(chains) if i not in crashed_props and len(ch)
    ]
    if live_chains:
        validate.check_in_order_clients(max(seqs, key=len), live_chains)


def _extra_checks(case: ReproCase, r) -> None:
    """Artifact-recorded auxiliary invariants.  ``decision_round_max``
    asserts every decision lands by round R: a deliberately tight R
    turns a slow-converging schedule into a reproducible violation
    without touching the real invariants."""
    rmax = case.extra_checks.get("decision_round_max")
    if rmax is not None:
        rounds = r.chosen_round[r.chosen_vid != -1]
        if rounds.size and int(rounds.max()) > int(rmax):
            raise validate.InvariantViolation(
                f"decision at round {int(rounds.max())} exceeds "
                f"decision_round_max={int(rmax)}"
            )


def check_run(r, cfg: SimConfig, workload, chains) -> None:
    """Quiescence + the crash-aware suite.  Quiescence is excused only
    when EVERY proposer crashed (no one is left to close the log)."""
    all_props_crashed = all(r.crashed[node] for node in cfg.proposers)
    if not r.done and not all_props_crashed:
        raise validate.InvariantViolation(
            f"no quiescence in {r.rounds} rounds"
        )
    validate_run(r, cfg, workload, chains)


def _judge(case: ReproCase, r):
    """Quiescence + crash-aware suite + the artifact-recorded extra
    checks; returns the violation string or None."""
    try:
        check_run(r, case.cfg, case.workload, case.chains)
        _extra_checks(case, r)
    except validate.InvariantViolation as e:
        return str(e)
    return None


def _runner(case: ReproCase, device):
    """The case's envelope runner (runtime schedule and knobs): every
    shrink move changes only its per-lane inputs, so all candidates of a
    case share it.  None for cases that cannot ride it (sharded).

    The runner is the plain one: the JAX shrinker arms the recorder only
    so that its candidates share the sweep's compiled program, and the
    port compiles nothing, so the recorder would be cost without use (it
    changes no verdict)."""
    if case.engine != "sim":
        return None
    from tpu_paxos_torch.fleet import envelope as env
    from tpu_paxos_torch.fleet import runner as frun

    sched = case.cfg.faults.schedule
    max_eps = max(
        frun.MAX_EPISODES, 0 if sched is None else len(sched.episodes)
    )
    return env.runner_for(
        case.cfg, case.workload, case.gates, max_episodes=max_eps,
        device=device,
    )


def _run_lanes(runner, cands):
    """One fleet dispatch, candidate ``i`` on lane ``i``."""
    return runner.run(
        [c.cfg.seed for c in cands],
        [c.cfg.faults.schedule for c in cands],
        workloads=[(c.workload, c.gates) for c in cands],
        knobs=[dataclasses.replace(c.cfg.faults, schedule=None) for c in cands],
    )


def _runtime_candidate_eval(case: ReproCase, device="cuda"):
    """Candidate evaluator on the case's envelope runner, one lane a
    candidate.  Returns ``eval(cand) -> violation-or-None``, or None when
    the case cannot ride the runtime engine (sharded cases)."""
    runner = _runner(case, device)
    if runner is None:
        return None

    def _eval(cand: ReproCase):
        return _judge(cand, _run_lanes(runner, [cand]).lane_result(0))

    return _eval


#: Fixed lane width of the shrinker's batched candidate dispatches:
#: every batch pads to exactly this many lanes (``chunking.chunk_pad``).
SHRINK_BATCH_LANES = 8


def _runtime_batch_eval(case: ReproCase, device="cuda"):
    """Multi-lane twin of :func:`_runtime_candidate_eval`: the
    independent candidates of one greedy pass become lanes of one fleet
    dispatch of ``SHRINK_BATCH_LANES`` lanes (the last chunk padded by
    repeating its final candidate; padding lanes' verdicts are dropped).
    Same runner as the one-lane evaluator, so the verdicts are equal
    lane for lane.  Returns ``eval_many(cands) -> [violation-or-None]``,
    or None for cases that cannot ride the runtime engine (sharded)."""
    from tpu_paxos_torch.analysis import chunking

    runner = _runner(case, device)
    if runner is None:
        return None

    def eval_many(cands):
        out = []
        for chunk, n_real in chunking.chunk_pad(
            list(cands), SHRINK_BATCH_LANES
        ):
            rep = _run_lanes(runner, chunk)
            out.extend(
                _judge(chunk[i], rep.lane_result(i)) for i in range(n_real)
            )
        return out

    return eval_many


def run_case(case: ReproCase, device="cuda"):
    """Execute the case on ``device``; returns (SimResult,
    violation-string-or-None).  A sharded case runs on a mesh of its
    recorded ``devices`` ranks; the ranks are threads that share the
    cards there are, so JAX's "needs N devices" refusal has no
    counterpart."""
    if case.engine == "sharded":
        from tpu_paxos_torch.parallel import mesh as pmesh
        from tpu_paxos_torch.parallel import sharded_sim

        mesh = pmesh.make_instance_mesh(case.devices, device=device)
        r = sharded_sim.run_sharded(case.cfg, mesh, case.workload, case.gates)
    else:
        r = simm.run(case.cfg, case.workload, case.gates, device=device)
    return r, _judge(case, r)


def decision_log_text(case: ReproCase, r) -> str:
    """Canonical decision-log rendering for the byte-compare surface;
    stride is derived from the workload so arbitrary vids decode
    stably."""
    stride = int(max(int(np.max(w)) for w in case.workload if len(w))) + 1
    return decision_log(
        r.chosen_vid, r.chosen_ballot,
        stride=stride, n_instances=case.cfg.n_instances,
    )


def _sha256(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


class _Budget:
    def __init__(self, n: int):
        self.left = n

    def spend(self) -> bool:
        self.left -= 1
        return self.left >= 0


def shrink_case(
    case: ReproCase, max_evals: int = MAX_EVALS, logger=None,
    batch: bool = True, stats: dict | None = None, device="cuda",
) -> tuple[ReproCase, str]:
    """Greedily minimize a failing case (see module doc for the move
    set).  Returns (shrunk case, its violation).  Raises ValueError if
    the input case does not fail.

    Each pass's independent candidates are evaluated in one multi-lane
    fleet dispatch (``batch=True``) or one at a time; the greedy control
    flow consumes the verdicts in order either way, so the accepted move
    sequence and the final case are the same.  The budget is spent per
    candidate either way; a batch may evaluate candidates the lazy path
    would have skipped, which only matters within one dispatch of
    exhaustion."""
    _, viol = run_case(case, device)
    if viol is None:
        raise ValueError("case does not fail; nothing to shrink")
    budget = _Budget(max_evals)
    evaluator = _runtime_candidate_eval(case, device)
    batch_eval = _runtime_batch_eval(case, device) if batch else None

    def note(msg):
        if logger is not None:
            logger.info("shrink: %s", msg)

    def try_batch(cands):
        """Same-base candidates judged together; candidates past the
        budget come back None (= not accepted)."""
        cands = list(cands)
        n = min(len(cands), max(budget.left, 0))
        take = cands[:n]
        for _ in take:
            budget.spend()
        if not take:
            return [None] * len(cands)
        if batch_eval is not None and len(take) > 1:
            vs = batch_eval(take)
        elif evaluator is not None:
            vs = [evaluator(c) for c in take]
        else:
            vs = [run_case(c, device)[1] for c in take]
        return vs + [None] * (len(cands) - n)

    changed = True
    while changed and budget.left > 0:
        changed = False
        # 1. drop episodes, greedily to a fixed point: all drops of the
        #    current base ride one dispatch; each acceptance changes the
        #    base, so the not-yet-visited SUFFIX re-batches
        sched = case.cfg.faults.schedule

        def _drop_verdicts(s, start):
            if s is None or start >= len(s.episodes):
                return []
            return try_batch(
                [case.with_schedule(s.without(j))
                 for j in range(start, len(s.episodes))]
            )

        i = 0
        base = 0
        vs = _drop_verdicts(sched, 0)
        while sched is not None and i < len(sched.episodes):
            v = vs[i - base]
            if v is not None:
                ep = sched.episodes[i]
                note(f"dropped {ep.kind}[{ep.t0},{ep.t1})")
                case, viol = case.with_schedule(sched.without(i)), v
                sched = case.cfg.faults.schedule
                changed = True
                base = i
                vs = _drop_verdicts(sched, i)
            else:
                i += 1
        # 2. narrow surviving intervals by bisection (tail half first)
        sched = case.cfg.faults.schedule
        if sched is not None:
            for i in range(len(sched.episodes)):
                while budget.left > 0:
                    sched = case.cfg.faults.schedule
                    ep = sched.episodes[i]
                    w = ep.t1 - ep.t0
                    if w <= 1:
                        break
                    halves = (
                        (ep.t0, ep.t0 + w // 2),  # cut the tail half
                        (ep.t1 - w // 2, ep.t1),  # cut the head half
                    )
                    cands = [
                        case.with_schedule(
                            sched.replaced(i, ep.shifted(t0, t1))
                        )
                        for t0, t1 in halves
                    ]
                    vs = try_batch(cands)
                    narrowed = None
                    for (t0, t1), cand, v in zip(halves, cands, vs):
                        if v is not None:
                            narrowed, viol = cand, v
                            note(f"narrowed {ep.kind} to [{t0},{t1})")
                            break
                    if narrowed is None:
                        break
                    case, changed = narrowed, True
        # 2b. halve surviving gray episodes' delay inflation toward 1
        sched = case.cfg.faults.schedule
        if sched is not None:
            for i in range(len(sched.episodes)):
                while budget.left > 0:
                    sched = case.cfg.faults.schedule
                    ep = sched.episodes[i]
                    if ep.kind != "gray" or ep.delay <= 1:
                        break
                    cand = case.with_schedule(sched.replaced(
                        i, dataclasses.replace(ep, delay=ep.delay // 2)
                    ))
                    v = try_batch([cand])[0]
                    if v is None:
                        break
                    note(f"gray delay -> {ep.delay // 2}")
                    case, viol, changed = cand, v, True
        # 3. collapse the per-edge fault matrix: drop it entirely first,
        #    else flatten to the equivalent uniform SCALAR knobs (max
        #    rates over the matrix)
        if case.cfg.faults.edges is not None and budget.left > 0:
            fc = case.cfg.faults
            e = fc.edges
            flat = dataclasses.replace(
                fc, edges=None,
                drop_rate=max(max(r) for r in e.drop_rate),
                dup_rate=max(max(r) for r in e.dup_rate),
                min_delay=min(min(r) for r in e.min_delay),
            )
            cands = [
                case.with_faults(dataclasses.replace(fc, edges=None)),
                case.with_faults(flat),
            ]
            labels = ["edges dropped", "edges -> uniform scalars"]
            vs = try_batch(cands)
            for lbl, cand, v in zip(labels, cands, vs):
                if v is not None:
                    note(lbl)
                    case, viol, changed = cand, v, True
                    break
        # 4. zero the i.i.d. fault knobs one at a time (an acceptance
        #    changes the base; the remaining zeroings re-batch)
        repls = [
            {"drop_rate": 0},
            {"dup_rate": 0},
            {"min_delay": 0, "max_delay": 0},
            {"crash_rate": 0},
            {"delivery_cut": False},
        ]
        while repls and budget.left > 0:
            fc = case.cfg.faults
            live = [
                r for r in repls
                if not all(getattr(fc, k) == v for k, v in r.items())
                # a surviving edge matrix pins the ring bound: zeroing
                # max_delay under it would fail config validation
                and not ("max_delay" in r and fc.edges is not None)
            ]
            if not live:
                break
            vs = try_batch(
                [case.with_faults(dataclasses.replace(fc, **r))
                 for r in live]
            )
            for k, (r, v) in enumerate(zip(live, vs)):
                if v is not None:
                    note(f"zeroed {'/'.join(r)}")
                    case = case.with_faults(
                        dataclasses.replace(case.cfg.faults, **r)
                    )
                    viol, changed = v, True
                    repls = live[k + 1:]
                    break
            else:
                break
        # 5. seed minimization (bisect toward 0)
        while case.cfg.seed > 0 and budget.left > 0:
            cand_seeds = [
                s for s in (0, case.cfg.seed // 2) if s != case.cfg.seed
            ]
            cands = [
                dataclasses.replace(
                    case, cfg=dataclasses.replace(case.cfg, seed=s)
                )
                for s in cand_seeds
            ]
            vs = try_batch(cands)
            for s, cand, v in zip(cand_seeds, cands, vs):
                if v is not None:
                    note(f"seed -> {s}")
                    case, viol, changed = cand, v, True
                    break
            else:
                break
    if stats is not None:
        # candidate-eval count (an out-param, so the return shape stays);
        # left can undershoot 0 by at most the final batch
        stats["evals"] = max_evals - max(budget.left, 0)
    return case, viol


# ---------------- artifact (de)serialization ----------------

def _cfg_to_dict(cfg: SimConfig) -> dict:
    fc = cfg.faults
    return {
        "n_nodes": cfg.n_nodes,
        "n_instances": cfg.n_instances,
        "proposers": list(cfg.proposers),
        "seed": cfg.seed,
        "max_rounds": cfg.max_rounds,
        "assign_window": cfg.assign_window,
        "protocol": dataclasses.asdict(cfg.protocol),
        "faults": {
            "drop_rate": fc.drop_rate,
            "dup_rate": fc.dup_rate,
            "min_delay": fc.min_delay,
            "max_delay": fc.max_delay,
            "crash_rate": fc.crash_rate,
            "schedule": (
                fc.schedule.to_dict() if fc.schedule is not None else None
            ),
            # WAN fields are written only when non-default, so classic
            # artifacts keep the pre-matrix bytes
            **({"edges": fc.edges.to_dict()} if fc.edges is not None
               else {}),
            **({"delivery_cut": True} if fc.delivery_cut else {}),
        },
    }


def _cfg_from_dict(d: dict) -> SimConfig:
    f = dict(d["faults"])
    sched = f.pop("schedule", None)
    edges = f.pop("edges", None)
    return SimConfig(
        n_nodes=d["n_nodes"],
        n_instances=d["n_instances"],
        proposers=tuple(d["proposers"]),
        seed=d["seed"],
        max_rounds=d["max_rounds"],
        assign_window=d["assign_window"],
        protocol=ProtocolConfig(**d["protocol"]),
        faults=FaultConfig(
            **f,
            schedule=(
                fltm.FaultSchedule.from_dict(sched) if sched else None
            ),
            edges=(
                EdgeFaultConfig.from_dict(edges) if edges else None
            ),
        ),
    )


def save_artifact(path: str, case: ReproCase, violation: str, device="cuda") -> dict:
    """Run the (already-shrunk) case once more on ``device`` to pin its
    decision-log hash, then write the self-contained artifact."""
    r, v = run_case(case, device)
    if v != violation:
        # a drifting violation means the artifact would not reproduce
        raise RuntimeError(
            f"violation drifted between runs: {violation!r} -> {v!r}"
        )
    art = {
        "format": ARTIFACT_FORMAT,
        "engine": case.engine,
        "devices": case.devices,
        "cfg": _cfg_to_dict(case.cfg),
        "workload": [np.asarray(w).tolist() for w in case.workload],
        "gates": (
            None
            if case.gates is None
            else [np.asarray(g).tolist() for g in case.gates]
        ),
        "chains": [np.asarray(c).tolist() for c in case.chains],
        "extra_checks": case.extra_checks,
        "violation": violation,
        "decision_log_sha256": _sha256(decision_log_text(case, r)),
        "rounds": int(r.rounds),
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(art, f, indent=1)
    os.replace(tmp, path)
    return art


def load_artifact(path: str) -> tuple[ReproCase, dict]:
    """Read and validate an artifact.  Every rejection (unreadable file,
    truncated JSON, wrong format, bad field, a config constructor's
    refusal) is an ``ArtifactSchemaError`` naming the field where there
    is one."""
    try:
        with open(path) as f:
            art = json.load(f)
    except OSError as e:
        raise ArtifactSchemaError("", f"unreadable artifact: {e}") from None
    except json.JSONDecodeError as e:
        raise ArtifactSchemaError(
            "", f"invalid JSON (truncated write?): {e}"
        ) from None
    try:
        validate_artifact(art)
    except ArtifactSchemaError as e:
        raise ArtifactSchemaError(
            e.field, f"{e.problem} (artifact {path!r})"
        ) from None
    try:
        case = ReproCase(
            cfg=_cfg_from_dict(art["cfg"]),
            workload=[np.asarray(w, np.int32) for w in art["workload"]],
            gates=(
                None
                if art["gates"] is None
                else [np.asarray(g, np.int32) for g in art["gates"]]
            ),
            chains=[np.asarray(c, np.int32) for c in art["chains"]],
            extra_checks=art.get("extra_checks") or {},
            engine=art.get("engine", "sim"),
            devices=art.get("devices", 1),
        )
    except (ValueError, TypeError) as e:
        raise ArtifactSchemaError(
            "cfg", f"rejected by config validation: {e} (artifact {path!r})"
        ) from None
    return case, art


def reproduce(path: str, device="cuda") -> dict:
    """Re-execute an artifact on ``device``; returns the comparison
    against its recorded outcome.  ``match`` is True iff the identical
    violation recurs AND the decision log's sha256 is equal."""
    case, art = load_artifact(path)
    r, violation = run_case(case, device)
    log_text = decision_log_text(case, r)
    sha = _sha256(log_text)
    return {
        "artifact": path,
        "violation": violation,
        "recorded_violation": art["violation"],
        "decision_log_sha256": sha,
        "recorded_sha256": art["decision_log_sha256"],
        "rounds": int(r.rounds),
        "done": bool(r.done),
        "decision_log": log_text,
        "match": (
            violation == art["violation"] and sha == art["decision_log_sha256"]
        ),
    }


def triage(
    case: ReproCase, out_path: str, max_evals: int = MAX_EVALS, logger=None,
    device="cuda",
) -> dict:
    """The sweep's failure hook: shrink the failing case and write its
    repro artifact.  Returns the artifact dict plus ``shrink_seconds``
    (wall) and ``shrink_evals`` (candidate evaluations), which are NOT
    written to the artifact file, whose schema is closed."""
    import time

    # paxlint: allow[DET001] wall metric only; never reaches artifacts
    t0 = time.perf_counter()
    stats: dict = {}
    small, viol = shrink_case(
        case, max_evals=max_evals, logger=logger, stats=stats, device=device
    )
    art = save_artifact(out_path, small, viol, device=device)
    # paxlint: allow[DET001] wall metric only; never reaches artifacts
    seconds = time.perf_counter() - t0
    if logger is not None:
        logger.info("shrink: wall time %.2fs", seconds)
    return dict(
        art,
        shrink_seconds=round(seconds, 2),
        shrink_evals=int(stats.get("evals", 0)),
    )
