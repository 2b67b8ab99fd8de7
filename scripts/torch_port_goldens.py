"""Compute the JAX-reference goldens the PyTorch port is held to.

Runs the JAX package (``tpu_paxos``) on the CPU for the two runs that
``chip_smoke.py`` repeats with the port on the card, and prints (or
writes) their round count, chosen count and decision-log sha256:

- ``bench_sim``: the ``"engine": "sim"`` bench record's configuration
  (``bench.bench_sim_record``): 5 nodes, 2**23 instances, proposers
  (0, 1), assign_window 2**20, debug.conf faults (drop 500, dup 1000,
  delay 0-2), seed 0, default workload;
- ``cli_4_4_10``: ``python -m tpu_paxos 4 4 10 --seed=0
  --net-drop-rate=500 --net-dup-rate=1000 --net-max-delay=2``.

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


def _summary(res, log_text: str) -> dict:
    return {
        "rounds": int(res.rounds),
        "done": bool(res.done),
        "chosen": int((res.chosen_vid != -1).sum()),
        "decision_log_sha256": hashlib.sha256(log_text.encode()).hexdigest(),
    }


def compute(n_instances: int = 1 << 23) -> dict:
    from tpu_paxos import config as cfgm
    from tpu_paxos.core import sim
    from tpu_paxos.harness import reference_runner as refr
    from tpu_paxos.replay.decision_log import decision_log

    bc = bench_sim_config(n_instances)
    cfg = cfgm.SimConfig(
        n_nodes=bc["n_nodes"], n_instances=bc["n_instances"],
        proposers=tuple(bc["proposers"]), seed=bc["seed"],
        assign_window=bc["assign_window"], max_rounds=bc["max_rounds"],
        faults=cfgm.FaultConfig(**bc["faults"]),
    )
    res = sim.run(cfg)
    stride = max(cfg.n_instances, 1024)
    bench = _summary(res, decision_log(res.chosen_vid, res.chosen_ballot, stride, cfg.n_instances))
    bench.update(config=bc, stride=stride)

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
    return {"command": COMMAND, "bench_sim": bench, "cli_4_4_10": cli}


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
