"""Record/replay diff of a wall-clock-paced membership driver on the port
(the port of ``scripts/replay_diff_member.py``; ref member/diff.sh:1-3
diffs two runs' logs, member/run.sh:10-16 is the record-then-replay
loop).

The driver paces its injections by real time (sleeps between marks), so
which engine round each proposal or membership change lands on varies
run to run with machine load: the host nondeterminism the reference's
Indet subsystem records (member/indet.cpp:24-119).  The injection log
captures the schedule that actually happened; the replay re-executes it
and must produce a byte-identical decision log.

    python scripts/torch_replay_diff_member.py [--device cpu]

Prints one JSON line (``replay_diff_member``, ``rounds``,
``injections``, ``log_bytes``); exit 0 iff the logs are equal.  Runs on
the card unless told ``--device cpu``.
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu_paxos_torch.membership.engine import MemberSim  # noqa: E402

MARK_S = 0.015  # wall-clock spacing of the driver's injections


def wall_clock_driver(seed: int, device="cuda") -> MemberSim:
    """Inject proposals and membership changes at ~15 ms wall-clock marks
    while the engine free-runs: the round each lands on depends on real
    time, not on anything deterministic."""
    ms = MemberSim(n_nodes=5, n_instances=64, seed=seed, device=device)
    plan = [
        ("propose", 0, 100),
        ("add", 1),
        ("propose", 1, 101),
        ("add", 2),
        ("propose", 0, 102),
    ]
    # paxlint: allow[DET001] the driver's pacing is wall time by design; the log records it
    next_mark = time.monotonic() + MARK_S
    while plan or not all(ms.chosen(v) for v in (100, 101, 102)):
        ms.run_rounds(1)
        # paxlint: allow[DET001] the driver's pacing is wall time by design
        if plan and time.monotonic() >= next_mark:
            kind, *args = plan.pop(0)
            if kind == "propose":
                ms.propose(args[0], args[1])
            else:
                ms.add_acceptor(args[0])
            # paxlint: allow[DET001] the driver's pacing is wall time by design
            next_mark = time.monotonic() + MARK_S
        if int(ms.state.t) > 4000:
            raise RuntimeError("driver did not converge")
    return ms


def replay_diff(ms: MemberSim, device="cuda") -> dict:
    """Save ``ms``'s injection log, replay it, and byte-compare the two
    decision logs."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "injections.json")
        ms.save_injections(path)
        rep = MemberSim.replay(path, device=device).decision_log()
    rec = ms.decision_log()
    return {
        "replay_diff_member": rec == rep,
        "rounds": int(ms.state.t),
        "injections": len(ms.injections),
        "log_bytes": len(rec),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    out = replay_diff(wall_clock_driver(11, args.device), args.device)
    print(json.dumps(out))
    return 0 if out["replay_diff_member"] else 1


if __name__ == "__main__":
    sys.exit(main())
