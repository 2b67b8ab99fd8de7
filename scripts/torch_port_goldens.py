"""Compute the JAX-reference goldens the PyTorch port is held to.

Runs the JAX package (``tpu_paxos``) on the CPU for the runs that
``chip_smoke.py`` repeats with the port on the card, and prints (or
writes) what each must reproduce:

- ``bench_sim``: the ``"engine": "sim"`` bench record's configuration
  (``bench.bench_sim_record``): 5 nodes, 2**23 instances, proposers
  (0, 1), assign_window 2**20, debug.conf faults (drop 500, dup 1000,
  delay 0-2), seed 0, default workload;
- ``bench_sim_partition_flap`` and ``bench_sim_wan3``: the same run
  under the correlated-fault mixes of ``tpu_paxos/harness/stress.py``
  (``partition-flap``: drop 300, dup 500, delay 0-2, three flapping
  bisections; ``wan-3region``: the WAN3 per-edge tables at ring bound
  8, a gray node and a one-way cut);
- ``cli_4_4_10``: ``python -m tpu_paxos 4 4 10 --seed=0
  --net-drop-rate=500 --net-dup-rate=1000 --net-max-delay=2``;
- ``fast_cli_2p23``: the stdout of ``python -m tpu_paxos 5 8192 1024
  --engine=fast --json`` (2**23 instances through the fast path).

The general-engine entries hold the round count, ``done``, the chosen
count and the decision-log sha256 (with the config, faults included, as
plain JSON the port rebuilds without the JAX package); the scheduled
ones also the sha256 of the ``chosen_round`` array (int32, little
endian), since a schedule moves decision rounds more than decisions.

Usage (from the repo root)::

    JAX_PLATFORMS=cpu python scripts/torch_port_goldens.py \
        [--write tpu_paxos_torch/data/goldens.json] [--instances N]

``--instances`` shrinks the bench run (for a quick self-check); the
committed file holds the full 2**23 run.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

COMMAND = "JAX_PLATFORMS=cpu python scripts/torch_port_goldens.py --write tpu_paxos_torch/data/goldens.json"


def bench_sim_config(n_instances: int = 1 << 23) -> dict:
    return {
        "n_nodes": 5,
        "n_instances": n_instances,
        "proposers": [0, 1],
        "seed": 0,
        "assign_window": max(256, min(1 << 20, n_instances // 8)),
        "max_rounds": 20_000,
        "faults": {"drop_rate": 500, "dup_rate": 1000, "max_delay": 2},
    }


CLI_ARGS = [4, 4, 10]
CLI_FAULTS = {"drop_rate": 500, "dup_rate": 1000, "max_delay": 2}


SCHEDULED = {
    "bench_sim_partition_flap": "partition-flap",
    "bench_sim_wan3": "wan-3region",
}
FAST_CLI_ARGS = ["5", "8192", "1024", "--engine=fast", "--json"]


def _faults_json(kw: dict) -> dict:
    """A stress mix's FaultConfig kwargs as plain JSON."""
    out = {}
    for k, v in sorted(kw.items()):
        out[k] = v.to_dict() if hasattr(v, "to_dict") else v
    return out


def _summary(res, log_text: str) -> dict:
    return {
        "rounds": int(res.rounds),
        "done": bool(res.done),
        "chosen": int((res.chosen_vid != -1).sum()),
        "decision_log_sha256": hashlib.sha256(log_text.encode()).hexdigest(),
    }


def chosen_round_sha256(chosen_round) -> str:
    import numpy as np

    return hashlib.sha256(np.asarray(chosen_round, "<i4").tobytes()).hexdigest()


def _bench_run(bc: dict, faults, rounds_sha: bool = False) -> dict:
    from tpu_paxos import config as cfgm
    from tpu_paxos.core import sim
    from tpu_paxos.replay.decision_log import decision_log

    cfg = cfgm.SimConfig(
        n_nodes=bc["n_nodes"], n_instances=bc["n_instances"],
        proposers=tuple(bc["proposers"]), seed=bc["seed"],
        assign_window=bc["assign_window"], max_rounds=bc["max_rounds"],
        faults=faults,
    )
    res = sim.run(cfg)
    stride = max(cfg.n_instances, 1024)
    out = _summary(res, decision_log(res.chosen_vid, res.chosen_ballot, stride, cfg.n_instances))
    out.update(config=bc, stride=stride)
    if rounds_sha:
        out["chosen_round_sha256"] = chosen_round_sha256(res.chosen_round)
    return out


def _fast_cli_stdout(argv) -> str:
    import contextlib
    import io

    from tpu_paxos import __main__ as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    if rc != 0:
        raise RuntimeError(f"python -m tpu_paxos {' '.join(argv)} exited {rc}")
    return buf.getvalue()


def compute(n_instances: int = 1 << 23) -> dict:
    from tpu_paxos import config as cfgm
    from tpu_paxos.harness import reference_runner as refr
    from tpu_paxos.harness import stress
    from tpu_paxos.replay.decision_log import decision_log
    from tpu_paxos.core import sim

    bc = bench_sim_config(n_instances)
    bench = _bench_run(bc, cfgm.FaultConfig(**bc["faults"]))
    mixes = {m[0]: m[1] for m in stress.MIXES + stress.WAN_MIXES}
    scheduled = {}
    for key, mix in sorted(SCHEDULED.items()):
        sc = dict(bc, faults=_faults_json(mixes[mix]), mix=mix)
        scheduled[key] = _bench_run(sc, cfgm.FaultConfig(**mixes[mix]), rounds_sha=True)

    srv, clt, ids = CLI_ARGS
    workload, gates, _ = refr.equivalent_workload(srv, clt, ids)
    ccfg = cfgm.SimConfig(
        n_nodes=srv, n_instances=clt * ids * 2, proposers=tuple(range(srv)),
        seed=0, faults=cfgm.FaultConfig(**CLI_FAULTS),
    )
    cres = sim.run(ccfg, workload, gates)
    cli = _summary(cres, decision_log(cres.chosen_vid, cres.chosen_ballot, ids, ccfg.n_instances))
    cli.update(
        args=CLI_ARGS, faults=CLI_FAULTS, stride=ids,
        cli="python -m tpu_paxos 4 4 10 --seed=0 --net-drop-rate=500 "
            "--net-dup-rate=1000 --net-max-delay=2",
    )
    fast_argv = list(FAST_CLI_ARGS)
    if n_instances != 1 << 23:  # the quick self-check shrinks this too
        fast_argv[1] = str(max(1, n_instances // 1024))
    out = _fast_cli_stdout(fast_argv)
    fast_cli = {
        "args": fast_argv,
        "cli": "python -m tpu_paxos " + " ".join(fast_argv),
        "stdout": out,
        "stdout_sha256": hashlib.sha256(out.encode()).hexdigest(),
    }
    return {"command": COMMAND, "bench_sim": bench, "cli_4_4_10": cli,
            "fast_cli_2p23": fast_cli, **scheduled}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", default="", help="write the goldens JSON here")
    ap.add_argument("--instances", type=int, default=1 << 23)
    args = ap.parse_args(argv)
    out = compute(args.instances)
    text = json.dumps(out, indent=1, sort_keys=True) + "\n"
    if args.write:
        with open(args.write, "w") as f:
            f.write(text)
    sys.stdout.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
