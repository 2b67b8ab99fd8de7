"""The port's stricter mode: one tiny config per engine (sim, fast, member,
sharded, serve), run with ``CUDA_LAUNCH_BLOCKING=1`` (every launch waits
for its kernel, so a fault surfaces at the launch that made it), each
engine's invariants asserted and its decision-log sha256 held to the same
config's run in normal mode.  The port's analog of the reference's
valgrind pass (ref multi/val.sh:1-5) and of ``scripts/check_smoke.py``.

    python scripts/torch_check_smoke.py [--device cpu]

The script starts itself twice more as child processes, once in each
mode, and compares what they print; the sanitizer half of the reference's
pass has no counterpart here (``compute-sanitizer`` refuses the card's
machine, see ROADMAP.md).  Runs on the card unless told ``--device
cpu``; on the CPU the blocking mode changes nothing, and the check still
runs every engine twice.  Exit 0 iff every engine holds.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

#: the argument that makes this script the child that runs the engines
CHILD_FLAG = "--engines"


def _sha(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


def smoke_sim(device) -> str:
    from tpu_paxos_torch.config import FaultConfig, SimConfig
    from tpu_paxos_torch.core import sim
    from tpu_paxos_torch.harness import validate
    from tpu_paxos_torch.replay.decision_log import decision_log

    cfg = SimConfig(n_nodes=3, n_instances=4, proposers=(0,), seed=0, max_rounds=60,
                    faults=FaultConfig())
    r = sim.run(cfg, device=device)
    assert r.done, f"sim smoke did not quiesce in {r.rounds} rounds"
    validate.check_agreement(r.learned)
    validate.check_exactly_once(r.learned, r.expected_vids)
    return decision_log(r.chosen_vid, r.chosen_ballot, cfg.n_instances, cfg.n_instances)


def smoke_fast(device) -> str:
    import numpy as np
    import torch

    from tpu_paxos_torch.core import fast
    from tpu_paxos_torch.harness import validate
    from tpu_paxos_torch.replay.decision_log import decision_log

    n, i = 3, 16
    state = fast.init_state(i, n, device=device)
    vids = torch.arange(i, dtype=torch.int32, device=state.learned.device)
    state, n_chosen = fast.choose_all(state, vids, proposer=0, quorum=2)
    assert int(n_chosen) == i, f"fast smoke chose {int(n_chosen)}/{i}"
    validate.check_all(fast.learned_ia(state), np.arange(i))
    return decision_log(state.learned[0].cpu().numpy(), state.acc_ballot[0].cpu().numpy(),
                        i, i)


def smoke_member(device) -> str:
    from tpu_paxos_torch.harness import validate
    from tpu_paxos_torch.membership.engine import MemberSim

    ms = MemberSim(n_nodes=3, n_instances=8, seed=0, device=device)
    ms.propose(0, 100)
    assert ms.run_until(lambda: ms.chosen(100), max_rounds=400)
    cv = ms.add_acceptor(1)
    assert ms.run_until(lambda: ms.applied(cv), max_rounds=400)
    validate.check_prefix_consistency([ms.applied_log(a) for a in range(3)])
    return ms.decision_log()


def smoke_sharded(device) -> str:
    from tpu_paxos_torch.config import FaultConfig, SimConfig
    from tpu_paxos_torch.harness import validate
    from tpu_paxos_torch.parallel import mesh as pmesh
    from tpu_paxos_torch.parallel import sharded_sim
    from tpu_paxos_torch.replay.decision_log import decision_log

    cfg = SimConfig(n_nodes=3, n_instances=16, proposers=(0, 1), seed=0, max_rounds=200,
                    faults=FaultConfig(drop_rate=500, max_delay=1))
    r = sharded_sim.run_sharded(cfg, pmesh.make_instance_mesh(2, device=device))
    assert r.done, f"sharded smoke did not quiesce in {r.rounds} rounds"
    validate.check_all(r.learned, r.expected_vids)
    return decision_log(r.chosen_vid, r.chosen_ballot, cfg.n_instances, cfg.n_instances)


def smoke_serve(device) -> str:
    import numpy as np

    from tpu_paxos_torch.config import SimConfig
    from tpu_paxos_torch.harness import validate
    from tpu_paxos_torch.replay.decision_log import decision_log
    from tpu_paxos_torch.serve import harness

    cfg = SimConfig(n_nodes=3, n_instances=32, proposers=(0, 1), seed=0, max_rounds=400)
    streams = [np.arange(0, 8, dtype=np.int32), np.arange(100, 108, dtype=np.int32)]
    arrivals = [np.arange(8, dtype=np.int32), np.arange(8, dtype=np.int32)]
    rep = harness.serve_run(cfg, streams, arrivals, rounds_per_window=4, device=device)
    assert rep.done and rep.backlog == 0, "serve smoke left a backlog"
    assert rep.decided_values == 16, f"serve smoke decided {rep.decided_values}/16"
    validate.check_exactly_once(rep.chosen_vid[:, None], np.concatenate(streams))
    return decision_log(rep.chosen_vid, rep.chosen_ballot, 100, cfg.n_instances)


ENGINES = {"sim": smoke_sim, "fast": smoke_fast, "member": smoke_member,
           "sharded": smoke_sharded, "serve": smoke_serve}


def run_engines(device) -> dict:
    """Each engine's decision-log sha256 in this process's mode."""
    return {name: _sha(fn(device)) for name, fn in ENGINES.items()}


def _child(device: str, blocking: bool) -> dict:
    env = dict(os.environ)
    env.pop("CUDA_LAUNCH_BLOCKING", None)
    if blocking:
        env["CUDA_LAUNCH_BLOCKING"] = "1"
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), CHILD_FLAG, "--device",
                           device], cwd=HERE, env=env, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        raise SystemExit(f"the {'blocking' if blocking else 'normal'} run failed "
                         f"(exit {proc.returncode})")
    return json.loads(proc.stdout.splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument(CHILD_FLAG, action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.engines:
        print(json.dumps(run_engines(args.device), sort_keys=True))
        return 0
    normal = _child(args.device, blocking=False)
    strict = _child(args.device, blocking=True)
    ok = True
    for name in ENGINES:
        same = strict[name] == normal[name]
        ok = ok and same
        print(f"  {name}: invariants green; decision log sha256 {strict[name][:16]} "
              f"(CUDA_LAUNCH_BLOCKING=1) {'==' if same else '!='} {normal[name][:16]} (normal)")
    print(json.dumps({"check_smoke": ok, "device": args.device, "engines": sorted(ENGINES)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
