"""The general engine's round cost on the card, for one tree of the port
against another.

    python scripts/torch_round_ab.py [--root DIR] [--reps N]

Loads ``DIR/scripts/torch_sim_profile.py`` (default: this checkout's),
so that ``tpu_paxos_torch`` is imported from ``DIR``, and times two
workloads with that tree's helpers:

- bench_sim: ``core/sim.run`` at the ``"engine": "sim"`` bench
  configuration (5 nodes, 2**23 instances, proposers (0, 1),
  assign_window 2**20, drop 500 / dup 1000 / delay 0-2, seed 0);
- the fleet headline: ``chip_smoke.py`` phase 9's 128-lane dispatch
  (bench.py's fleet configuration, seeds 0-127, the headline knob
  cycle).

Each runs once cold, then ``--reps`` times timed (synchronized wall, ms a
round, the median's ms a round), then once under
``torch.cuda.set_sync_debug_mode`` for its host syncs a round.  Prints
the card (``nvidia-smi`` name and power limit) and one JSON line.  To
compare two trees, run it for each in turns (A, B, B, A) on one
machine in one go: hosts differ more than the trees do.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import torch


def _load_profile(root: str):
    path = os.path.join(root, "scripts", "torch_sim_profile.py")
    spec = importlib.util.spec_from_file_location("torch_sim_profile_ab", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _syncs(fn) -> int:
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in seen)


def _timed(fn, reps: int):
    fn()  # cold: kernel build, allocator, host caches
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return out, walls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_round_ab: CUDA is not available", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    prof = _load_profile(root)
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    out = {"root": root, "card": card}

    cfg = prof.bench_cfg(1 << 23)
    res, walls = _timed(lambda: prof.sim.run(cfg, device=dev), args.reps)
    out["bench_sim"] = {
        "rounds": res.rounds, "ms_per_round": [w * 1e3 / res.rounds for w in walls],
        "median_ms_per_round": statistics.median(walls) * 1e3 / res.rounds,
        "syncs_per_round": _syncs(lambda: prof.sim.run(cfg, device=dev)) / res.rounds,
    }

    ((runner, kw),) = prof._fleet_dispatches("headline", dev)
    rep, walls = _timed(lambda: runner.run(**kw), args.reps)
    rounds = rep.iterations
    out["fleet_headline"] = {
        "lanes": rep.n_lanes, "round_calls": rounds,
        "ms_per_round": [w * 1e3 / rounds for w in walls],
        "median_ms_per_round": statistics.median(walls) * 1e3 / rounds,
        "syncs_per_round": _syncs(lambda: runner.run(**kw)) / rounds,
    }
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
