"""Where the PyTorch port's general engine spends its time on the card.

Runs ``tpu_paxos_torch.core.sim.run`` at the ``"engine": "sim"`` bench
configuration (the main path that ``chip_smoke.py`` drives: 5 nodes,
2**23 instances, proposers (0, 1), assign_window 2**20, drop 500 / dup
1000 / delay 0-2, seed 0) and prints:

- the synchronized wall time of a warm run, its rounds and ms/round;
- the host-to-device synchronizations per round (counted with
  ``torch.cuda.set_sync_debug_mode``);
- a host split of one run: time in the threefry draws
  (``prng.randint_lanes``: keys on the host, words hashed on the card)
  and time in the round's global-predicate
  reads (``sim._any``, each of which waits for the device to drain),
  per round;
- under ``torch.profiler``: the device's busy time (the sum of the
  device-side events, kernels and copies; one stream, so nothing
  overlaps), the device ops per round, the idle share of the warm
  run's wall (the profiler slows the host, not the device), and the
  top device ops by self time with their counts.

Usage (from the repo root, on a machine with a CUDA card)::

    python scripts/torch_sim_profile.py [--instances N] [--top K]
    python scripts/torch_sim_profile.py --fleet {shrink,headline}

``--fleet`` profiles fleet dispatches (``fleet/runner.FleetRunner.run``)
instead: ``shrink`` the failure shrinker's 8-lane dispatches (the
``culprit`` triage case of ``tpu_paxos_torch/data/goldens.json``: every
batched dispatch of ``shrink_case(batch=True)`` is recorded, then replayed
timed), ``headline`` the 128-lane headline dispatch of ``chip_smoke.py``
phase 9 (bench.py's fleet configuration, seeds 0-127, the headline knob
cycle).  For each it prints the dispatches' lanes, round calls, wall and
ms a round, host syncs a round, the host's ms a round by block of the
round (exclusive host time of each wrapped function: the draws, the
acceptor side, the proposer round, assignment, requeue, the two kernels'
wrappers, the predicate reads, the frozen-lane select, the loop's
per-round read and parking test, the init and the verdict), and under
``torch.profiler`` the device's busy time, its idle share of the
dispatches' wall and the top device ops.

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

    saved = (prng.randint_lanes, sim._any)
    prng.randint_lanes = timed("prng", saved[0])
    sim._any = timed("predicates", saved[1])
    try:
        timed_run(cfg, dev)
    finally:
        prng.randint_lanes, sim._any = saved
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


class BlockTimer:
    """Exclusive host time by block: each wrapped function's time less
    the time of wrapped functions it calls, summed by block name."""

    def __init__(self):
        self.ms = {}
        self.calls = {}
        self._stack = []
        self._saved = []

    def wrap(self, owner, attr: str, block: str) -> None:
        fn = getattr(owner, attr)

        def timed(*a, **kw):
            self._stack.append(0.0)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                total = time.perf_counter() - t0
                inner = self._stack.pop()
                self.ms[block] = self.ms.get(block, 0.0) + (total - inner) * 1e3
                self.calls[block] = self.calls.get(block, 0) + 1
                if self._stack:
                    self._stack[-1] += total

        self._saved.append((owner, attr, fn))
        setattr(owner, attr, timed)

    def restore(self) -> None:
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved.clear()


def _wrap_round_blocks(timer: BlockTimer) -> None:
    from tpu_paxos_torch.core import net as netm
    from tpu_paxos_torch.fleet import runner as frun
    from tpu_paxos_torch.fleet import schedule_table as stm
    from tpu_paxos_torch.fleet import verdict as vdt

    timer.wrap(frun.FleetRunner, "run", "dispatch host (tables, knobs, copies)")
    timer.wrap(sim, "run_lanes", "loop: per-round read, lane bookkeeping")
    timer.wrap(sim, "_unchanged", "loop: parking test")
    timer.wrap(sim, "init_lanes", "init")
    timer.wrap(vdt, "lane_verdict", "verdict")
    timer.wrap(sim, "_lane_round", "acceptor side")
    timer.wrap(sim, "_proposer_round", "proposer round")
    timer.wrap(sim, "_assign", "assign")
    timer.wrap(sim, "_requeue", "requeue")
    timer.wrap(sim, "_freeze", "frozen-lane select")
    timer.wrap(sim, "_any", "predicate reads")
    for mod, name in ((prng, "stream_keys"), (prng, "split_keys"),
                      (netm, "lane_copy_plans"), (stm, "masks_at"), (stm, "crashes_at")):
        timer.wrap(mod, name, "draws and schedule rows")
    timer.wrap(sk, "store_accepts", "store_accepts wrapper")
    timer.wrap(sk, "accum_acks", "accum_acks wrapper")


def _fleet_dispatches(mode: str, dev):
    """The dispatches to profile: ``[(runner, run_kwargs), ...]``."""
    import numpy as np

    from tpu_paxos_torch.fleet import envelope
    from tpu_paxos_torch.fleet import runner as frun

    with open(os.path.join(ROOT, "tpu_paxos_torch", "data", "goldens.json")) as f:
        goldens = json.load(f)
    if mode == "headline":
        from tpu_paxos_torch.fleet import search
        from tpu_paxos_torch.harness import stress

        gold = goldens["fleet"]
        c = gold["config"]
        wl, gates, _ = stress._workload(2, np.random.default_rng(0))
        cfg = cfgm.SimConfig(
            n_nodes=c["n_nodes"], n_instances=c["n_instances"], proposers=tuple(c["proposers"]),
            seed=c["seed"], max_rounds=c["max_rounds"], faults=cfgm.FaultConfig(**c["faults"]),
        )
        rng = np.random.default_rng(1)
        n = c["lanes"]
        scheds = [search.sample_schedule(rng, 5, 4, 96) for _ in range(n)]
        mixes = gold["headline"]["knob_mixes"]
        knobs = [cfgm.FaultConfig(**mixes[i % len(mixes)]) for i in range(n)]
        runner = frun.FleetRunner(cfg, wl, gates, device=dev)
        first = gold["headline"]["first_seed"]
        return [(runner, dict(seeds=[first + i for i in range(n)], schedules=scheds,
                              knobs=knobs))]
    from tpu_paxos_torch.harness import shrink as shr

    spec = goldens["triage_wedge"]["cases"]["culprit"]
    case = shr.ReproCase(
        cfg=shr._cfg_from_dict(spec["cfg"]),
        workload=[np.asarray(w, np.int32) for w in spec["workload"]],
        gates=None, chains=[np.asarray(ch, np.int32) for ch in spec["chains"]],
        extra_checks=dict(spec["extra_checks"]),
    )
    envelope.clear_cache()
    seen = []
    real = frun.FleetRunner.run

    def recording(self, seeds, schedules, **kw):
        if len(seeds) == shr.SHRINK_BATCH_LANES:
            seen.append((self, dict(seeds=list(seeds), schedules=list(schedules), **kw)))
        return real(self, seeds, schedules, **kw)

    frun.FleetRunner.run = recording
    try:
        shr.shrink_case(case, max_evals=spec["max_evals"], device=dev)
    finally:
        frun.FleetRunner.run = real
    return seen


def profile_fleet(mode: str, dev, top: int) -> dict:
    """Time, sync-count, block-split and profile the mode's dispatches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dispatches = _fleet_dispatches(mode, dev)
    for runner, kw in dispatches:  # warm
        runner.run(**kw)
    _sync(dev)
    t0 = time.perf_counter()
    reps = [runner.run(**kw) for runner, kw in dispatches]
    _sync(dev)
    wall = time.perf_counter() - t0
    rounds = sum(r.iterations for r in reps)
    out = {
        "mode": mode, "dispatches": len(reps), "lanes": sorted({r.n_lanes for r in reps}),
        "instances": reps[0].cfg.n_instances, "round_calls": rounds, "wall_s": wall,
        "ms_per_round": wall * 1e3 / rounds,
        "lanes_per_sec": sum(r.n_lanes for r in reps) / wall,
    }
    if dev.type == "cuda":
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for runner, kw in dispatches:
                    runner.run(**kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        out["syncs_per_round"] = sum("synchroniz" in str(w.message) for w in caught) / rounds
    timer = BlockTimer()
    _wrap_round_blocks(timer)
    try:
        _sync(dev)
        t0 = time.perf_counter()
        for runner, kw in dispatches:
            runner.run(**kw)
        _sync(dev)
        timed_wall = time.perf_counter() - t0
    finally:
        timer.restore()
    out["blocks_wall_s"] = timed_wall
    out["host_ms_per_round_by_block"] = {
        k: v / rounds for k, v in sorted(timer.ms.items(), key=lambda kv: -kv[1])
    }
    out["block_calls_per_round"] = {k: v / rounds for k, v in sorted(timer.calls.items())}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    _sync(dev)
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        for runner, kw in dispatches:
            runner.run(**kw)
        _sync(dev)
    prof_wall = time.perf_counter() - t0
    rows = [
        (ev.key, ev.count, ev.self_device_time_total / 1e3)
        for ev in prof.key_averages() if ev.device_type != DeviceType.CPU
    ]
    busy_ms = sum(r[2] for r in rows)
    rows.sort(key=lambda r: -r[2])
    out["profile"] = {
        "device_busy_ms": busy_ms,
        "device_busy_ms_per_round": busy_ms / rounds,
        "device_ops_per_round": sum(r[1] for r in rows) / rounds,
        # against the unprofiled wall: the profiler slows the host only
        "device_idle_share": (1 - busy_ms / (wall * 1e3)) if rows else None,
        "profiled_wall_s": prof_wall,
        "top": [{"op": k[:90], "count": n, "self_ms": ms} for k, n, ms in rows[:top]],
    }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--instances", type=int, default=1 << 23)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--fleet", choices=("shrink", "headline"), default="",
                    help="profile fleet dispatches instead of one sim.run")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_sim_profile: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device(args.device)
    card = None
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
    if args.fleet:
        out = {"device": args.device, "card": card, **profile_fleet(args.fleet, dev, args.top)}
        print(json.dumps(out, indent=1))
        return 0
    cfg = bench_cfg(args.instances)
    out = {"instances": cfg.n_instances, "device": args.device}
    if card is not None:
        out["card"] = card
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
