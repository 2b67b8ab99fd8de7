"""Where the PyTorch port's general engine spends its time on the card.

Runs ``tpu_paxos_torch.core.sim.run`` at the ``"engine": "sim"`` bench
configuration (the main path that ``chip_smoke.py`` drives: 5 nodes,
2**23 instances, proposers (0, 1), assign_window 2**20, drop 500 / dup
1000 / delay 0-2, seed 0) and prints:

- the synchronized wall time of a warm run, its rounds and ms/round;
- the host-to-device synchronizations per round (counted with
  ``torch.cuda.set_sync_debug_mode``);
- a host split of one run: time in the host-side threefry draws
  (``prng.randint_many``) and time in the round's global-predicate
  reads (``sim._any``, each of which waits for the device to drain),
  per round;
- under ``torch.profiler``: the device's busy time (the sum of the
  device-side events, kernels and copies; one stream, so nothing
  overlaps), the device ops per round, the idle share of the warm
  run's wall (the profiler slows the host, not the device), and the
  top device ops by self time with their counts.

Usage (from the repo root, on a machine with a CUDA card)::

    python scripts/torch_sim_profile.py [--instances N] [--top K]

``--device cpu`` with a small ``--instances`` rehearses the script on a
machine without a card; it then reports no device time.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import warnings

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tpu_paxos_torch import config as cfgm  # noqa: E402
from tpu_paxos_torch.core import sim  # noqa: E402
from tpu_paxos_torch.core import simkern as sk  # noqa: E402
from tpu_paxos_torch.utils import prng  # noqa: E402


def bench_cfg(n_instances: int) -> cfgm.SimConfig:
    return cfgm.SimConfig(
        n_nodes=5, n_instances=n_instances, proposers=(0, 1), seed=0,
        assign_window=max(256, min(1 << 20, n_instances // 8)), max_rounds=20_000,
        faults=cfgm.FaultConfig(drop_rate=500, dup_rate=1000, max_delay=2),
    )


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed_run(cfg, dev):
    _sync(dev)
    t0 = time.perf_counter()
    res = sim.run(cfg, device=dev)
    _sync(dev)
    return res, time.perf_counter() - t0


def count_syncs(cfg, dev) -> int:
    """Synchronizing CUDA calls in one run (each warns once in 'warn'
    mode)."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            sim.run(cfg, device=dev)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in seen)


def host_split(cfg, dev, rounds: int) -> dict:
    """Host ms per round spent drawing coins and waiting in predicate
    reads, by wrapping the two functions for one run."""
    spent = {"prng": 0.0, "predicates": 0.0}
    calls = {"predicates": 0}

    def timed(name, fn):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[name] += time.perf_counter() - t0
                calls[name] = calls.get(name, 0) + 1
        return wrapper

    saved = (prng.randint_many, sim._any)
    prng.randint_many = timed("prng", saved[0])
    sim._any = timed("predicates", saved[1])
    try:
        timed_run(cfg, dev)
    finally:
        prng.randint_many, sim._any = saved
    return {
        "prng_ms_per_round": spent["prng"] * 1e3 / rounds,
        "predicate_reads_per_round": calls["predicates"] / rounds,
        "predicate_ms_per_round": spent["predicates"] * 1e3 / rounds,
    }


def profile_run(cfg, dev, top: int, rounds: int, wall_ms: float) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(dev)
    with profile(activities=acts) as prof:
        sim.run(cfg, device=dev)
        _sync(dev)
    # device-side events only: a CPU op's "self device time" repeats
    # the time of the kernels it launched
    rows = [
        (ev.key, ev.count, ev.self_device_time_total / 1e3)
        for ev in prof.key_averages() if ev.device_type != DeviceType.CPU
    ]
    busy_ms = sum(r[2] for r in rows)
    rows.sort(key=lambda r: -r[2])
    return {
        "device_busy_ms": busy_ms,
        "device_ops_per_round": sum(r[1] for r in rows) / rounds,
        "device_idle_share": (1 - busy_ms / wall_ms) if rows else None,
        "top": [{"op": k[:90], "count": n, "self_ms": ms} for k, n, ms in rows[:top]],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--instances", type=int, default=1 << 23)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_sim_profile: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device(args.device)
    cfg = bench_cfg(args.instances)
    out = {"instances": cfg.n_instances, "device": args.device}
    if dev.type == "cuda":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
    timed_run(cfg, dev)  # warm: kernel build, allocator, host caches
    sk.reset_counts()
    res, wall = timed_run(cfg, dev)
    out.update(
        rounds=res.rounds, done=bool(res.done), wall_s=wall,
        ms_per_round=wall * 1e3 / res.rounds, launches=dict(sk.LAUNCHES),
    )
    if dev.type == "cuda":
        out["syncs_per_round"] = count_syncs(cfg, dev) / res.rounds
    out["host_split"] = host_split(cfg, dev, res.rounds)
    out["profile"] = profile_run(cfg, dev, args.top, res.rounds, wall * 1e3)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
