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
  --engine=fast --json`` (2**23 instances through the fast path);
- ``fleet``: the JAX ``FleetRunner`` at ``bench.py``'s fleet record
  configuration (``bench.bench_fleet_record``): 5 nodes, proposers (0,
  1), the gated stress workload ``stress._workload(2, default_rng(0))``
  on 56 instances, ``max_rounds`` 20000, ring bound 8, 128 lanes with
  schedules drawn lane after lane by ``search.sample_schedule(rng, 5, 4,
  96)`` from ``default_rng(1)``, under the headline knob cycle (seeds
  0-127) and the delay-spread cycle (seeds 50000-50127); per lane the
  six verdict fields and the decision-log sha256 (stride: the runner's
  vid bound).

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


FLEET_LANES = 128
FLEET_CYCLES = {
    # cycle: (first seed, knob mixes as FaultConfig kwargs, cycled by lane)
    "headline": (0, [
        {},
        {"drop_rate": 500, "dup_rate": 1000, "max_delay": 2},
        {"drop_rate": 2000, "dup_rate": 500, "max_delay": 2},
        {"drop_rate": 1000, "dup_rate": 2000, "max_delay": 2},
    ]),
    "delay": (50_000, [
        {"drop_rate": 500, "dup_rate": 1000, "max_delay": 2},
        {"drop_rate": 2000, "dup_rate": 500, "max_delay": 4},
        {"drop_rate": 200, "dup_rate": 200, "min_delay": 1, "max_delay": 6},
        {"drop_rate": 300, "dup_rate": 500, "max_delay": 8},
    ]),
}


def fleet_config(workload) -> dict:
    return {
        "n_nodes": 5,
        "n_instances": 2 * sum(len(w) for w in workload),
        "proposers": [0, 1],
        "seed": 0,
        "max_rounds": 20_000,
        "faults": {"drop_rate": 300, "dup_rate": 500, "max_delay": 8},
        "workload": "stress._workload(2, numpy.random.default_rng(0))",
        "schedules": "search.sample_schedule(rng, 5, 4, 96) per lane, rng = default_rng(1)",
        "lanes": FLEET_LANES,
    }


def fleet_goldens(n_lanes: int = FLEET_LANES) -> dict:
    import numpy as np

    from tpu_paxos import config as cfgm
    from tpu_paxos.fleet import runner as frun
    from tpu_paxos.fleet import search
    from tpu_paxos.harness import stress
    from tpu_paxos.replay.decision_log import decision_log

    workload, gates, _ = stress._workload(2, np.random.default_rng(0))
    fc = fleet_config(workload)
    cfg = cfgm.SimConfig(
        n_nodes=fc["n_nodes"], n_instances=fc["n_instances"],
        proposers=tuple(fc["proposers"]), seed=fc["seed"],
        max_rounds=fc["max_rounds"], faults=cfgm.FaultConfig(**fc["faults"]),
    )
    rng = np.random.default_rng(1)
    schedules = [search.sample_schedule(rng, 5, 4, 96) for _ in range(n_lanes)]
    runner = frun.FleetRunner(cfg, workload, gates)
    out = {"config": dict(fc, lanes=n_lanes), "stride": runner.vid_bound}
    for name, (first, mixes) in sorted(FLEET_CYCLES.items()):
        knobs = [cfgm.FaultConfig(**mixes[i % len(mixes)]) for i in range(n_lanes)]
        rep = runner.run([first + i for i in range(n_lanes)], schedules, knobs=knobs)
        # one transfer per fleet dispatch, after its verdict
        chosen_vid = np.asarray(rep.final.met.chosen_vid)  # paxlint: allow[JAX103] once per dispatch
        chosen_ballot = np.asarray(rep.final.met.chosen_ballot)  # paxlint: allow[JAX103] once per dispatch
        v = rep.verdict
        out[name] = {
            "first_seed": first,
            "knob_mixes": mixes,
            **{f: np.asarray(getattr(v, f)).tolist() for f in v._fields},
            "decision_log_sha256": [
                hashlib.sha256(decision_log(
                    chosen_vid[i], chosen_ballot[i], runner.vid_bound, cfg.n_instances,
                ).encode()).hexdigest()
                for i in range(n_lanes)
            ],
        }
    return out


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
            "fast_cli_2p23": fast_cli, "fleet": fleet_goldens(), **scheduled}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", default="", help="write the goldens JSON here")
    ap.add_argument("--instances", type=int, default=1 << 23)
    ap.add_argument("--fleet-only", action="store_true",
                    help="recompute only the fleet entry of the --write file")
    args = ap.parse_args(argv)
    if args.fleet_only:
        with open(args.write) as f:
            out = json.load(f)
        out["fleet"] = fleet_goldens()
    else:
        out = compute(args.instances)
    text = json.dumps(out, indent=1, sort_keys=True) + "\n"
    if args.write:
        with open(args.write, "w") as f:
            f.write(text)
    sys.stdout.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
