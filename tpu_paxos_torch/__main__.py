"""``python -m tpu_paxos_torch`` — the reference CLI on the port.

The ``--engine=sim`` and ``--engine=fast`` surfaces of ``python -m
tpu_paxos``: positional ``srvcnt cltcnt idcnt [propose_interval]`` plus
the ``--key=value`` knobs (ref multi/main.cpp:456-521, delays in
rounds), and ``--device {cuda,cpu}`` (default cuda; there is no quiet
fallback to the CPU).

Output, byte for byte as the JAX CLI prints it: for the general engine
the decision log in the reference grammar on stdout, then one invariant
verdict line; for the fast path the verdict line alone.  Exit code 0
iff every invariant holds; 2 for what the port does not run yet
(``--engine=member``, ``--mesh``, every subcommand but ``repro``,
``trace`` and ``fleet``).

``python -m tpu_paxos_torch repro <artifact> [--json] [--device
{cuda,cpu}]`` replays a repro artifact (``harness/shrink.py``): the
decision log, then the JSON summary or verdict line; exit 0 iff the
recorded violation recurs with an equal decision-log sha256, 1 if not,
2 for a malformed artifact (a JSON summary naming the field) and for
artifacts of engines the port does not run yet.

``python -m tpu_paxos_torch trace <artifact> [--stdout] [--device
{cuda,cpu}]`` re-runs a repro artifact with the flight recorder armed
and renders it as a Chrome-trace/Perfetto timeline
(``telemetry/export.py``).

``python -m tpu_paxos_torch fleet [--lanes N] [--generations G] [--seed
S] [--gray] [--wan] [--triage-dir D] [--device {cuda,cpu}] ...`` runs
the device-batched schedule search (``fleet/search.py``) and prints its
one JSON summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_SUBCOMMANDS = ("serve", "evolve", "mc", "lint", "audit")

#: Artifact engines whose replay is not ported yet, and what replays them.
_UNPORTED_ENGINES = {
    "sharded": "the instance-sharded engine",
    "serve": "the serve admission controller",
    "mc-control": "the controller model checker",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_paxos_torch",
        description="multi-Paxos simulation harness (PyTorch / CUDA)",
    )
    p.add_argument("srvcnt", type=int, help="number of server nodes")
    p.add_argument("cltcnt", type=int, help="number of clients")
    p.add_argument("idcnt", type=int, help="ids proposed per client")
    p.add_argument("propose_interval", type=int, nargs="?", default=0,
                   help="accepted for reference-CLI fidelity; pacing is "
                   "subsumed by the round schedule")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--paxos-prepare-delay-min", type=int, default=0)
    p.add_argument("--paxos-prepare-delay-max", type=int, default=4)
    p.add_argument("--paxos-prepare-retry-count", type=int, default=3)
    p.add_argument("--paxos-prepare-retry-timeout", type=int, default=2)
    p.add_argument("--paxos-accept-retry-count", type=int, default=3)
    p.add_argument("--paxos-accept-retry-timeout", type=int, default=2)
    p.add_argument("--paxos-commit-retry-timeout", type=int, default=2)
    p.add_argument("--net-drop-rate", type=int, default=0)
    p.add_argument("--net-dup-rate", type=int, default=0)
    p.add_argument("--net-min-delay", type=int, default=0)
    p.add_argument("--net-max-delay", type=int, default=0)
    p.add_argument("--crash-rate", type=int, default=0,
                   help="per-node fail-stop crash rate per 1e6 per round")
    p.add_argument("--log-level", type=str, default="INFO")
    p.add_argument("--max-rounds", type=int, default=10_000)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--mesh", type=int, default=0,
                   help="sharding the instance axis is not ported yet")
    p.add_argument("--engine", choices=("sim", "fast", "member"), default="sim")
    p.add_argument("--json", action="store_true",
                   help="emit a JSON summary instead of the verdict line")
    p.add_argument("--save-state", type=str, default="",
                   help="dump the run's decision tensors to this .npz path")
    return p


def _emit(args, summary: dict) -> None:
    if args.json:
        print(json.dumps(summary, sort_keys=True))
    else:
        status = "ALL INVARIANTS GREEN" if summary.get("ok") else "FAILED"
        detail = ", ".join(f"{k}={v}" for k, v in sorted(summary.items()) if k != "ok")
        print(f"[{summary.get('engine')}] {status} ({detail})")


def run_sim(args) -> int:
    import numpy as np

    from tpu_paxos_torch import config as cfgm
    from tpu_paxos_torch.core import sim
    from tpu_paxos_torch.harness import reference_runner as refr
    from tpu_paxos_torch.harness import validate
    from tpu_paxos_torch.replay.decision_log import decision_log as render_log
    from tpu_paxos_torch.utils import log as logm

    logger = logm.get_logger("cli", logm.parse_level(args.log_level))
    workload, gates, in_order = refr.equivalent_workload(args.srvcnt, args.cltcnt, args.idcnt)
    cfg = cfgm.SimConfig(
        n_nodes=args.srvcnt,
        n_instances=args.cltcnt * args.idcnt * 2,
        proposers=tuple(range(args.srvcnt)),
        seed=args.seed,
        max_rounds=args.max_rounds,
        protocol=cfgm.ProtocolConfig(
            prepare_delay_min=args.paxos_prepare_delay_min,
            prepare_delay_max=args.paxos_prepare_delay_max,
            prepare_retry_count=args.paxos_prepare_retry_count,
            prepare_retry_timeout=args.paxos_prepare_retry_timeout,
            accept_retry_count=args.paxos_accept_retry_count,
            accept_retry_timeout=args.paxos_accept_retry_timeout,
            commit_retry_timeout=args.paxos_commit_retry_timeout,
        ),
        faults=cfgm.FaultConfig(
            drop_rate=args.net_drop_rate,
            dup_rate=args.net_dup_rate,
            min_delay=args.net_min_delay,
            max_delay=args.net_max_delay,
            crash_rate=args.crash_rate,
        ),
    )
    logger.info(
        "sim: %d nodes, %d clients x %d ids, seed %d",
        args.srvcnt, args.cltcnt, args.idcnt, args.seed,
    )
    res = sim.run(cfg, workload, gates, device=args.device)
    if args.save_state:
        np.savez(
            args.save_state,
            chosen_vid=res.chosen_vid, chosen_round=res.chosen_round,
            chosen_ballot=res.chosen_ballot, learned=res.learned,
            crashed=res.crashed, msgs=res.msgs,
            rounds=np.int64(res.rounds), done=np.bool_(res.done),
        )
        logger.info("decision tensors saved to %s", args.save_state)
    sys.stdout.write(
        render_log(res.chosen_vid, res.chosen_ballot, stride=args.idcnt,
                   n_instances=cfg.n_instances)
    )
    ok, verdict = True, []
    try:
        seqs = validate.check_all(res.learned, res.expected_vids)
        validate.check_in_order_clients(seqs[0], in_order)
        if not res.done:
            raise validate.InvariantViolation(f"did not quiesce in {res.rounds} rounds")
        verdict = ["agreement", "exactly_once", "in_order_clients", "quiescence"]
    except validate.InvariantViolation as e:
        ok = False
        logger.error("invariant violated: %s", e)
    summary = {
        "engine": "sim",
        "rounds": res.rounds,
        "done": res.done,
        "chosen": int((res.chosen_vid != -1).sum()),
        "executed": int((res.chosen_vid >= 0).sum()),
        "crashed": int(res.crashed.sum()),
        "msgs": res.msgs.tolist(),
        "invariants": verdict,
        "ok": ok,
    }
    _emit(args, summary)
    return 0 if ok else 1


def run_fast(args) -> int:
    """One prepared proposer chooses ``cltcnt * idcnt`` sequential vids
    in one prepare -> accept -> commit pipeline (``core/fast.py``)."""
    import numpy as np
    import torch

    from tpu_paxos_torch.core import fast
    from tpu_paxos_torch.harness import validate
    from tpu_paxos_torch.utils import log as logm

    logger = logm.get_logger("cli", logm.parse_level(args.log_level))
    n = args.cltcnt * args.idcnt
    quorum = args.srvcnt // 2 + 1
    state = fast.init_state(n, args.srvcnt, device=args.device)
    vids = torch.arange(n, dtype=torch.int32, device=state.learned.device)
    state, n_chosen = fast.choose_all(state, vids, proposer=0, quorum=quorum)
    n_chosen = int(n_chosen)
    learned = fast.learned_ia(state)
    if args.save_state:
        # all tensors in the validators' [instances, nodes] convention
        np.savez(
            args.save_state,
            learned=learned,
            acc_ballot=state.acc_ballot.cpu().numpy().T,
            acc_vid=state.acc_vid.cpu().numpy().T,
            n_chosen=np.int64(n_chosen),
        )
        logger.info("decision tensors saved to %s", args.save_state)
    ok = True
    try:
        validate.check_all(learned, np.arange(n))
    except validate.InvariantViolation as e:
        ok = False
        logger.error("invariant violated: %s", e)
    _emit(args, {
        "engine": "fast",
        "chosen": n_chosen,
        "devices": 1,
        "invariants": ["agreement", "exactly_once"] if ok else [],
        "ok": ok and n_chosen == n,
    })
    return 0 if ok and n_chosen == n else 1


def run_repro(argv) -> int:
    """``python -m tpu_paxos_torch repro <artifact>``: re-execute a
    repro artifact and verify it reproduces (identical violation, equal
    decision-log sha256)."""
    ap = argparse.ArgumentParser(
        prog="python -m tpu_paxos_torch repro",
        description="replay a stress-triage repro artifact",
    )
    ap.add_argument("artifact", help="path to a repro .json "
                    "(written by the stress sweep's --triage-dir)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--json", action="store_true",
                    help="emit a JSON summary instead of the verdict line")
    ap.add_argument("--log-level", type=str, default="INFO")
    args = ap.parse_args(argv)
    # replay surface: log stamps carry no wall clock
    os.environ.setdefault("TPU_PAXOS_DETERMINISTIC", "1")
    from tpu_paxos_torch.utils import log as logm

    logger = logm.get_logger("repro", logm.parse_level(args.log_level))
    # Peek the engine before loading: artifacts of engines the port does
    # not run yet exit 2 by name.  Unreadable or malformed files fall
    # through to load_artifact's field-named schema error.
    try:
        with open(args.artifact) as f:
            hdr = json.load(f)
        engine = hdr.get("engine", "sim") if isinstance(hdr, dict) else "sim"
    except (OSError, ValueError):
        engine = "sim"
    if isinstance(engine, str) and engine in _UNPORTED_ENGINES:
        print(f"tpu_paxos_torch: repro of engine '{engine}' artifacts "
              f"({_UNPORTED_ENGINES[engine]}) is not ported yet", file=sys.stderr)
        return 2
    from tpu_paxos_torch.analysis.artifact_schema import ArtifactSchemaError
    from tpu_paxos_torch.harness import shrink as shr

    try:
        rep = shr.reproduce(args.artifact, device=args.device)
    except ArtifactSchemaError as e:
        # malformed artifact: fail before the engine does, naming the
        # offending field
        logger.error("%s", e)
        _emit(args, {
            "engine": "repro", "ok": False,
            "schema_error": {"field": e.field, "problem": e.problem},
        })
        return 2
    sys.stdout.write(rep.pop("decision_log"))
    if rep["match"]:
        logger.info(
            "reproduced: %s (decision log sha256 %s)",
            rep["violation"], rep["decision_log_sha256"][:16],
        )
    else:
        logger.error(
            "did NOT reproduce: violation %r vs recorded %r, log sha %s "
            "vs recorded %s",
            rep["violation"], rep["recorded_violation"],
            rep["decision_log_sha256"][:16], rep["recorded_sha256"][:16],
        )
    _emit(args, {"engine": "repro", "ok": rep["match"], **rep})
    return 0 if rep["match"] else 1


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "repro":
        return run_repro(argv[1:])
    if argv and argv[0] == "trace":
        from tpu_paxos_torch.telemetry import export

        return export.main(argv[1:])
    if argv and argv[0] == "fleet":
        # device-batched schedule search: (seed x schedule) lanes a
        # dispatch, wedges shrunk to repro artifacts
        from tpu_paxos_torch.fleet import search as fsearch

        return fsearch.main(argv[1:])
    if argv and argv[0] in _SUBCOMMANDS:
        print(f"tpu_paxos_torch: '{argv[0]}' is not ported yet", file=sys.stderr)
        return 2
    args = build_parser().parse_args(argv)
    if args.engine == "member" or args.mesh:
        what = "--engine=member" if args.engine == "member" else "--mesh"
        if args.mesh and args.engine != "sim":
            what = f"--mesh with --engine={args.engine}"
        print(f"tpu_paxos_torch: {what} is not ported yet", file=sys.stderr)
        return 2
    return run_fast(args) if args.engine == "fast" else run_sim(args)


if __name__ == "__main__":
    sys.exit(main())
