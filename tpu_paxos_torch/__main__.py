"""``python -m tpu_paxos_torch`` — the reference CLI on the port.

The ``--engine=sim``, ``--engine=fast`` and ``--engine=member``
surfaces of ``python -m tpu_paxos``: positional ``srvcnt cltcnt idcnt
[propose_interval]`` plus the ``--key=value`` knobs (ref
multi/main.cpp:456-521, delays in rounds), and ``--device {cuda,cpu}``
(default cuda; there is no quiet fallback to the CPU).

Output, byte for byte as the JAX CLI prints it: for the general engine
the decision log in the reference grammar on stdout, then one invariant
verdict line; for the fast path the verdict line alone; for the
membership engine (``--engine=member``: the member/ churn scenario —
grow the acceptor set to ``srvcnt`` with ``cltcnt * idcnt`` values
proposed meanwhile, shrink back to {0}, check prefix consistency; with
``--crash-rate``, ``--record-injections F`` / ``--replay-injections F``
and ``--save-state F`` writing the engine checkpoint) the verdict line,
with the decision-log hash.  ``--trace-dir D`` runs the engine under
``torch.profiler`` and writes ``D/trace.json`` (``utils/log.profile_trace``;
stdout unchanged).  ``--mesh N`` (with ``--dcn-hosts H``)
shards the instance axis of ``--engine=sim`` and ``--engine=fast`` over
an ``N``-rank mesh (``parallel/``: ``N`` threads, each on its own device
or all on one card); ``--engine=member`` ignores it, as the JAX CLI
does.  Exit code 0 iff every invariant holds.

``python -m tpu_paxos_torch repro <artifact> [--json] [--device
{cuda,cpu}]`` replays a repro artifact (``harness/shrink.py``): the
decision log, then the JSON summary or verdict line; exit 0 iff the
recorded violation recurs with an equal decision-log sha256, 1 if not,
2 for a malformed artifact (a JSON summary naming the field).  A sharded
artifact (``engine: "sharded"``) replays on a mesh of its recorded
``devices``.

``python -m tpu_paxos_torch trace <artifact> [--stdout] [--device
{cuda,cpu}]`` re-runs a repro artifact with the flight recorder armed
and renders it as a Chrome-trace/Perfetto timeline
(``telemetry/export.py``).

``python -m tpu_paxos_torch fleet [--lanes N] [--generations G] [--seed
S] [--gray] [--wan] [--triage-dir D] [--device {cuda,cpu}] ...`` runs
the device-batched schedule search (``fleet/search.py``) and prints its
one JSON summary line.

``python -m tpu_paxos_torch serve [--values N] [--rate-milli R]
[--sweep R1,R2,...] [--slo-latency L] [--device {cuda,cpu}] ...`` serves
an open-loop value stream (``serve/harness.py``) and ``serve --fleet
[--lanes N] ...`` a fleet of tenant streams (``serve/fleet.py``), each
printing one JSON summary line; ``--control``, ``--control-ab`` and
``--save-artifact`` arm the admission controller (``serve/control.py``),
whose artifacts ``repro`` replays; ``serve --fleet --mesh N [--dcn-hosts
H]`` tiles the fleet's lanes over an ``N``-rank mesh (the lane count must
tile it).

``python -m tpu_paxos_torch mc [--scope quick,gray,churn,control]
[--json] [--triage-dir D] [--device {cuda,cpu}]`` model-checks the
declared scopes (``analysis/modelcheck.py``) against the committed
certificates; ``repro`` replays its ``mc-control`` counterexample
artifacts (``analysis/mc_control.reproduce``).

``python -m tpu_paxos_torch evolve [--axis {fleet,member,serve}]
[--lanes N] [--generations G] [--hunt CAUSE] [--certified] [--bench-out
F] [--device {cuda,cpu}] ...`` runs the certified selection loop
(``fleet/evolve.py``) and prints its one JSON summary line.  ``fleet
--mesh N`` and ``evolve --mesh N`` tile each generation's lanes over an
``N``-rank mesh, the lane count padded to tile it.

``python -m tpu_paxos_torch lint [paths] [--json] [--fix [--write]]``
runs paxlint on the port (``analysis/lint.py``, pure AST) against its
committed baseline.  ``python -m tpu_paxos_torch audit [--device
{cuda,cpu}] [--pin] [--json] ...`` runs every registered entry point
once and holds its kernel calls, host reads, collectives and (on a
card) syncs and launches a round against ``analysis/launch_budget.json``,
with the unregistered-surface sweep and the shard tier
(``analysis/audit.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

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
                   help="shard the instance axis over this many ranks "
                   "(0 = unsharded)")
    p.add_argument("--dcn-hosts", type=int, default=1,
                   help="with --mesh, arrange the ranks as a 2-D "
                   "(dcn-hosts x chips) mesh; collectives reduce over "
                   "both axes")
    p.add_argument("--engine", choices=("sim", "fast", "member"), default="sim")
    p.add_argument("--json", action="store_true",
                   help="emit a JSON summary instead of the verdict line")
    p.add_argument("--trace-dir", type=str, default="",
                   help="write a torch.profiler Chrome trace of the engine "
                   "run to DIR/trace.json (CUDA kernels included on a card)")
    p.add_argument("--save-state", type=str, default="",
                   help="dump the run's decision tensors (for "
                   "--engine=member: the engine checkpoint) to this .npz path")
    p.add_argument("--record-injections", type=str, default="",
                   help="--engine=member: save the run's (round, op, args) "
                   "host-injection log here for later replay (the "
                   "reference's indet record pass, ref member/run.sh)")
    p.add_argument("--replay-injections", type=str, default="",
                   help="--engine=member: instead of running the churn "
                   "scenario, re-execute a recorded injection log; the "
                   "emitted decision-log hash must match the recording "
                   "run's (ref member/run.sh:10-16, member/diff.sh)")
    return p


def _emit(args, summary: dict) -> None:
    if args.json:
        print(json.dumps(summary, sort_keys=True))
    else:
        status = "ALL INVARIANTS GREEN" if summary.get("ok") else "FAILED"
        detail = ", ".join(f"{k}={v}" for k, v in sorted(summary.items()) if k != "ok")
        print(f"[{summary.get('engine')}] {status} ({detail})")


def _with_trace(args, runner):
    """Run ``runner`` under ``utils/log.profile_trace`` when --trace-dir
    is set (the bench harness's profiling hook)."""
    from tpu_paxos_torch.utils import log as logm

    with logm.profile_trace(args.trace_dir, args.device):
        return runner()


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
    if args.mesh:
        from tpu_paxos_torch.parallel import mesh as pmesh
        from tpu_paxos_torch.parallel import sharded_sim

        # The chain-aware split keeps each client's gate chain on one
        # shard, so per-shard demand is set by the largest chain cluster
        mesh = pmesh.make_instance_mesh(args.mesh, dcn_hosts=args.dcn_hosts, device=args.device)
        cfg = sharded_sim.padded_config(cfg, workload, gates, mesh.size)
        logger.info("instance axis sharded over %d devices", mesh.size)
        res = _with_trace(args, lambda: sharded_sim.run_sharded(cfg, mesh, workload, gates))
    else:
        res = _with_trace(args, lambda: sim.run(cfg, workload, gates, device=args.device))
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
    n_devices = 1

    def _go():
        nonlocal n_devices
        if args.mesh:
            from tpu_paxos_torch.parallel import mesh as pmesh
            from tpu_paxos_torch.parallel import sharded

            mesh = pmesh.make_instance_mesh(args.mesh, dcn_hosts=args.dcn_hosts,
                                            device=args.device)
            n_devices = mesh.size
            states = sharded.init_sharded_state(mesh, n, args.srvcnt)
            step = sharded.sharded_choose_all(mesh, proposer=0, quorum=quorum)
            states, n_chosen = step(
                states, pmesh.shard_instances(mesh, torch.arange(n, dtype=torch.int32)))
            return sharded.gather_state(states), n_chosen
        state = fast.init_state(n, args.srvcnt, device=args.device)
        vids = torch.arange(n, dtype=torch.int32, device=state.learned.device)
        return fast.choose_all(state, vids, proposer=0, quorum=quorum)

    state, n_chosen = _with_trace(args, _go)
    n_chosen = int(n_chosen)
    learned = np.asarray(state.learned).T if args.mesh else fast.learned_ia(state)
    if args.save_state:
        # all tensors in the validators' [instances, nodes] convention
        np.savez(
            args.save_state,
            learned=learned,
            acc_ballot=np.asarray(state.acc_ballot if args.mesh else state.acc_ballot.cpu()).T,
            acc_vid=np.asarray(state.acc_vid if args.mesh else state.acc_vid.cpu()).T,
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
        "devices": n_devices,
        "invariants": ["agreement", "exactly_once"] if ok else [],
        "ok": ok and n_chosen == n,
    })
    return 0 if ok and n_chosen == n else 1


def _sha16(text: str) -> str:
    import hashlib

    return hashlib.sha256(text.encode()).hexdigest()[:16]


def run_member(args) -> int:
    """member/ churn scenario: grow the cluster from 1 to srvcnt
    acceptors, propose cltcnt*idcnt values meanwhile, shrink back, and
    validate prefix consistency (ref member/main.cpp:101-161, 260-265)."""
    return _with_trace(args, lambda: _run_member_body(args))


def _run_member_body(args) -> int:
    from tpu_paxos_torch.harness import validate
    from tpu_paxos_torch.membership import engine as mem
    from tpu_paxos_torch.utils import log as logm

    logger = logm.get_logger("cli", logm.parse_level(args.log_level))
    if args.replay_injections:
        if args.record_injections:
            raise SystemExit(
                "--replay-injections and --record-injections are "
                "mutually exclusive (replay re-executes an existing "
                "log; it does not re-record)"
            )
        # geometry, seed and crash rate come from the log; log stamps go
        # deterministic so byte-compares of the output are stable
        os.environ.setdefault("TPU_PAXOS_DETERMINISTIC", "1")
        logger.info(
            "replaying %s: geometry/seed/crash-rate come from the log",
            args.replay_injections,
        )
        sim = mem.MemberSim.replay(args.replay_injections, device=args.device)
        _emit(args, {
            "engine": "member",
            "replayed_from": args.replay_injections,
            "rounds": int(sim.state.t),
            "injections": len(sim.injections),
            "decision_log_sha256": _sha16(sim.decision_log()),
            "ok": True,
        })
        return 0

    def member_emit(sim, payload: dict) -> None:
        # the injection log saves on every exit, and every member verdict
        # carries the decision-log hash
        if args.record_injections:
            sim.save_injections(args.record_injections)
            logger.info("injection log saved to %s", args.record_injections)
        payload["decision_log_sha256"] = _sha16(sim.decision_log())
        _emit(args, payload)

    n = args.srvcnt
    nvals = args.cltcnt * args.idcnt
    sim = mem.MemberSim(n, n_instances=max(4 * (nvals + 4 * n), 64),
                        seed=args.seed, crash_rate=args.crash_rate, device=args.device)
    vid = 0
    for tgt in range(1, n):
        if tgt in sim.crashed_set():
            logger.info("skipping crashed add target %d", tgt)
            continue
        cv = sim.add_acceptor(tgt)
        if vid < nvals:
            sim.propose(0, vid)
            vid += 1
        if not sim.run_until(lambda: sim.applied(cv), args.max_rounds):
            logger.error("add_acceptor(%d) never applied", tgt)
            member_emit(sim, {"engine": "member", "ok": False})
            return 1
    # propose via node 0, the one node whose proposer role survives the
    # whole churn schedule (ref member/main.cpp:204-212)
    while vid < nvals:
        sim.propose(0, vid)
        vid += 1
        sim.run_rounds(2)
    # shrink, crashed members first (MemberSim.next_shrink_target)
    for _ in range(2 * n):
        tgt = sim.next_shrink_target()
        if tgt is None:
            break
        cv = sim.del_acceptor(tgt)
        if not sim.run_until(lambda: sim.applied(cv), args.max_rounds):
            logger.error("del_acceptor(%d) never applied", tgt)
            member_emit(sim, {"engine": "member", "ok": False})
            return 1
    # drain: every proposed value applied at node 0 before the verdict
    drained = sim.run_until(
        lambda: set(range(nvals)) <= set(sim.applied_log(0).tolist())
        and sim.acceptor_set() == {0},
        args.max_rounds,
    )
    logs = [sim.applied_log(a) for a in range(n)]
    ok = True
    if not drained:
        ok = False
        logger.error(
            "drain incomplete: %d/%d values applied at node 0, "
            "acceptors=%s", len(set(logs[0].tolist()) & set(range(nvals))),
            nvals, sorted(sim.acceptor_set()),
        )
    try:
        validate.check_prefix_consistency(logs)
    except validate.InvariantViolation as e:
        ok = False
        logger.error("invariant violated: %s", e)
    if args.save_state:
        from tpu_paxos_torch import checkpoint

        checkpoint.save(args.save_state, sim.state, {"engine": "member", "seed": args.seed})
        logger.info("member state saved to %s", args.save_state)
    member_emit(sim, {
        "engine": "member",
        "rounds": int(sim.state.t),
        "applied_node0": len(logs[0]),
        "final_acceptors": sorted(sim.acceptor_set()),
        "invariants": ["prefix_consistency"] if ok else [],
        "ok": ok,
    })
    return 0 if ok else 1


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
    # Peek the engine before loading (a sharded artifact replays on a
    # mesh of its recorded device count, which run_case reads).
    # Unreadable or malformed files fall through to load_artifact's
    # field-named schema error.
    try:
        with open(args.artifact) as f:
            hdr = json.load(f)
        engine = hdr.get("engine", "sim") if isinstance(hdr, dict) else "sim"
    except (OSError, ValueError):
        engine = "sim"
    from tpu_paxos_torch.analysis.artifact_schema import ArtifactSchemaError

    if engine == "serve":
        # controlled-serve artifacts replay through the admission
        # controller: the same schema surface, the decision log extended
        # with the control trail
        from tpu_paxos_torch.serve import control as shr
    elif engine == "mc-control":
        # controller-invariant counterexamples replay as a pure host
        # decide() trail: the artifact carries the full policy, so no
        # wedge env is needed
        from tpu_paxos_torch.analysis import mc_control as shr
    else:
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
    if argv and argv[0] == "serve":
        if "--fleet" in argv[1:]:
            # fleet serving: many tenant streams per dispatch, on-device
            # per-lane SLO verdicts (serve/fleet.py)
            from tpu_paxos_torch.serve import fleet as serve_fleet

            return serve_fleet.main([a for a in argv[1:] if a != "--fleet"])
        # open-loop serving: arrivals admitted between dispatch windows;
        # latency at load and the knee sweep (serve/harness.py)
        from tpu_paxos_torch.serve import harness as serve_harness

        return serve_harness.main(argv[1:])
    if argv and argv[0] == "fleet":
        # device-batched schedule search: (seed x schedule) lanes a
        # dispatch, wedges shrunk to repro artifacts
        from tpu_paxos_torch.fleet import search as fsearch

        return fsearch.main(argv[1:])
    if argv and argv[0] == "mc":
        # exhaustive bounded model checking: a declared scope's whole
        # scenario cross product as chunked fleet lanes, gated on the
        # pinned scope certificate
        from tpu_paxos_torch.analysis import modelcheck

        return modelcheck.main(argv[1:])
    if argv and argv[0] == "evolve":
        # the certified selection loop: mutate-and-select genomes, one
        # fleet dispatch per generation, recall against the mc
        # certificate
        from tpu_paxos_torch.fleet import evolve

        return evolve.main(argv[1:])
    if argv and argv[0] == "lint":
        # paxlint on the port: pure AST, no torch import
        from tpu_paxos_torch.analysis import lint

        return lint.main(argv[1:])
    if argv and argv[0] == "audit":
        # the per-round contracts of every registered entry point
        from tpu_paxos_torch.analysis import audit

        return audit.main(argv[1:])
    args = build_parser().parse_args(argv)
    if args.engine == "member":
        return run_member(args)
    return run_fast(args) if args.engine == "fast" else run_sim(args)


if __name__ == "__main__":
    sys.exit(main())
