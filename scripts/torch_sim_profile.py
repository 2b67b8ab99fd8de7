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
  reads (``sim._any`` and ``sim._global_max``, each of which waits for
  the device to drain),
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

``--member {config5,fleet}`` profiles the membership engine instead:
``config5`` is BASELINE config 5 (``ChurnEngine(7, --instances,
churn=grow_shrink_schedule(7, 5, values_per_step=1),
max_rounds=4000)``, default 2**20 instances), one seed-5 run of each
driver (``run``, deciding from the tensors, and ``run_host``, deciding
from numpy reads); ``fleet`` is ``chip_smoke.py`` phase 14d's 128-lane
member fleet (3 nodes, 8 instances, 200 rounds, the lanes drawn from
``default_rng(0)``).  For each it prints wall, rounds, ms and host syncs
a round, the host's ms a round by block (the round, its two predicate
reads and the churn loop's per-round read, the threefry draws, the churn
injection and run-complete test) and under ``torch.profiler`` the
device's busy time, idle share and top ops.

``--serve {full,fleet}`` profiles open-loop serving instead
(``serve/driver.py``): ``full`` the first ``--dispatches`` dispatches
(default 8, 512 round calls) of ``chip_smoke.py`` phase 15a's stream
(2**16 Poisson values at 16000 milli on 2**17 instances, 2-round
windows, 32 a dispatch, 128-round buckets), ``fleet`` those of phase
15c's 256-lane serve fleet at 32000 milli.  It prints the wall, ms and
host syncs a round, the host's ms a round by block (the round's blocks
as for ``--fleet``, the ingest stamp, ``admit_block`` and the dispatch
epilogue) and under ``torch.profiler`` the device's busy time, idle
share and top ops.

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

    saved = (prng.randint_lanes, sim._any, sim._global_max)
    prng.randint_lanes = timed("prng", saved[0])
    sim._any = timed("predicates", saved[1])
    sim._global_max = timed("predicates", saved[2])
    try:
        timed_run(cfg, dev)
    finally:
        prng.randint_lanes, sim._any, sim._global_max = saved
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
    timer.wrap(sim, "_global_max", "predicate reads")
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


def _goldens_script():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_port_goldens", os.path.join(ROOT, "scripts", "torch_port_goldens.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script


def _serve_dispatches(mode: str, n_disp: int, dev):
    """A callable running the first ``n_disp`` dispatches of phase 15a's
    stream (``full``: the driver's window, as ``serve_run`` calls it) or
    of 15c's 256-lane fleet at 32000 milli (``fleet``: the fleet runner's
    dispatch) from a fresh state, each with its harvest read; it returns
    the round calls.  Also returns the lane count."""
    import numpy as np

    from tpu_paxos_torch.fleet import envelope
    from tpu_paxos_torch.serve import driver as drv
    from tpu_paxos_torch.serve import fleet as sfl
    from tpu_paxos_torch.serve import harness as sh

    script = _goldens_script()
    m = script.serve_modules(port=True)
    c = script.SERVE
    r, s, ww = c["rounds_per_window"], c["windows_per_dispatch"], c["window_rounds"]
    slo = script.serve_slo(m)
    part = c["full"] if mode == "full" else c["fleet"]
    cfg = script.serve_cfg(m, part["n_values"])
    if mode == "full":
        lanes = [sfl.ServeLane(*script.serve_stream(m, part["n_values"], part["rate_milli"]),
                               cfg.seed)]
    else:
        lanes = m.sfl.fleet_lanes(cfg, part["lanes"], part["n_values"], part["rates"][0], c["seed"])
    plans = [m.arrv.ArrivalPlan(ln.workload, ln.arrivals, r) for ln in lanes]
    k = max(pl.max_block for pl in plans)
    qc = max(sim.prepare_queues(cfg, ln.workload)[3] for ln in lanes)
    vb = max(drv.vid_bound_of(ln.workload) for ln in lanes)
    n, p = len(lanes), len(cfg.proposers)
    blocks = [
        tuple(np.stack([np.stack([pl.block(d * s + i, k)[j] for i in range(s)]) for pl in plans])
              for j in (0, 1))
        for d in range(n_disp)
    ]
    if mode == "full":
        root = prng.root_key(cfg.seed)
        fn = drv.window_for(cfg, qc, vb, r, window_rounds=ww, device=dev)

        def run():
            ss, _ = drv.init_serve_state(cfg, lanes[0].workload, vb, root, window_rounds=ww,
                                         device=dev)
            for adm, arr in blocks:
                out = fn(ss, root, adm[0], arr[0])
                ss = out[0]
                sh._read(out, slo, ww)
            return n_disp * s * r
        return run, n

    runner = envelope.serve_fleet_for(cfg, qc, vb, r, window_rounds=ww, device=dev)
    roots = prng.root_keys([ln.seed for ln in lanes])
    width = qc + cfg.assign_window
    slo_args = sfl._slo_args(slo, ())
    tabs = torch.zeros((n, cfg.n_nodes + vb), dtype=torch.int32, device=dev)

    def run():
        st = runner._init(np.full((n, p, width), -1, np.int32),
                          np.full((n, p, width), -1, np.int32), np.zeros((n, p), np.int32), roots)
        for adm, arr in blocks:
            out = runner._fn(st, roots, *drv.upload_blocks(adm, arr, dev),
                             tabs[:, cfg.n_nodes:], tabs[:, :cfg.n_nodes], *slo_args)
            st = out[0]
            torch.stack([x.reshape(n).to(torch.int32) for x in out[1:5]]).cpu()
        return n_disp * s * r
    return run, n


def profile_serve(mode: str, n_disp: int, dev, top: int) -> dict:
    """Time, sync-count, block-split and profile the serve dispatches
    (the fleet runner's dispatch, which a single stream runs at one
    lane as ``serve_run`` does through the driver)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu_paxos_torch.serve import driver as drv

    run, lanes = _serve_dispatches(mode, n_disp, dev)
    run()  # warm
    _sync(dev)
    t0 = time.perf_counter()
    rounds = run()
    _sync(dev)
    wall = time.perf_counter() - t0
    out = {"mode": mode, "lanes": lanes, "dispatches": n_disp, "round_calls": rounds,
           "wall_s": wall, "ms_per_round": wall * 1e3 / rounds}
    if dev.type == "cuda":
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        out["syncs_per_round"] = sum("synchroniz" in str(w.message) for w in caught) / rounds
    timer = BlockTimer()
    _wrap_round_blocks(timer)
    timer.wrap(drv, "_stamp", "ingest stamp")
    timer.wrap(sim, "admit_block", "admit_block")
    timer.wrap(drv, "epilogue", "dispatch epilogue")
    timer.wrap(drv, "upload_blocks", "block upload")
    try:
        run()
        _sync(dev)
    finally:
        timer.restore()
    out["host_ms_per_round_by_block"] = {
        k: v / rounds for k, v in sorted(timer.ms.items(), key=lambda kv: -kv[1])}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    _sync(dev)
    with profile(activities=acts) as prof:
        run()
        _sync(dev)
    rows = [(ev.key, ev.count, ev.self_device_time_total / 1e3)
            for ev in prof.key_averages() if ev.device_type != DeviceType.CPU]
    busy_ms = sum(r[2] for r in rows)
    rows.sort(key=lambda r: -r[2])
    out["profile"] = {
        "device_busy_ms_per_round": busy_ms / rounds,
        "device_ops_per_round": sum(r[1] for r in rows) / rounds,
        # against the unprofiled wall: the profiler slows the host only
        "device_idle_share": (1 - busy_ms / (wall * 1e3)) if rows else None,
        "top": [{"op": k[:90], "count": n, "self_ms": ms} for k, n, ms in rows[:top]],
    }
    return out


def _member_cases(mode: str, n_instances: int, dev):
    """``[(label, fn)]``: the runs ``--member`` profiles."""
    from tpu_paxos_torch.fleet import member_runner as mrun
    from tpu_paxos_torch.fleet import search
    from tpu_paxos_torch.membership import churn_table as ctm
    from tpu_paxos_torch.membership import engine as meng

    if mode == "config5":
        eng = meng.ChurnEngine(7, n_instances, churn=ctm.grow_shrink_schedule(7, 5, 1),
                               max_rounds=4000, device=dev)
        return [("run", lambda: eng.run(seed=5)), ("run_host", lambda: eng.run_host(seed=5))]
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_port_goldens", os.path.join(ROOT, "scripts", "torch_port_goldens.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    lanes = script.member_fleet_lanes(search, 128, 3)
    runner = mrun.MemberFleetRunner(3, 8, max_episodes=4, max_rounds=200, device=dev)
    return [("fleet", lambda: runner.run(*lanes))]


def _member_rounds(res) -> int:
    return res.iterations if hasattr(res, "iterations") else res.rounds


def profile_member(mode: str, n_instances: int, dev, top: int) -> dict:
    """Time, sync-count, block-split and profile the membership runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu_paxos_torch.membership import engine as meng

    out = {"mode": mode, "instances": n_instances if mode == "config5" else 8}
    for label, fn in _member_cases(mode, n_instances, dev):
        fn()  # warm
        _sync(dev)
        t0 = time.perf_counter()
        res = fn()
        _sync(dev)
        wall = time.perf_counter() - t0
        rounds = _member_rounds(res)
        rec = {"wall_s": wall, "rounds": rounds, "ms_per_round": wall * 1e3 / rounds}
        if dev.type == "cuda":
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    fn()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            rec["syncs_per_round"] = sum("synchroniz" in str(w.message) for w in caught) / rounds
        timer = BlockTimer()
        timer.wrap(meng, "_lane_round", "round (less the blocks below)")
        timer.wrap(meng, "_host", "predicate and loop reads")
        timer.wrap(prng, "randint_lanes", "threefry draws")
        timer.wrap(meng, "_churn_inject", "churn injection")
        timer.wrap(meng, "_churn_done", "run-complete test")
        timer.wrap(meng, "_ready_host", "host injection gate (run_host)")
        timer.wrap(meng, "_done_host", "host run-complete test (run_host)")
        try:
            _sync(dev)
            fn()
            _sync(dev)
        finally:
            timer.restore()
        rec["host_ms_per_round_by_block"] = {
            k: v / rounds for k, v in sorted(timer.ms.items(), key=lambda kv: -kv[1])}
        rec["block_calls_per_round"] = {k: v / rounds for k, v in sorted(timer.calls.items())}
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        _sync(dev)
        with profile(activities=acts) as prof:
            fn()
            _sync(dev)
        rows = [(ev.key, ev.count, ev.self_device_time_total / 1e3)
                for ev in prof.key_averages() if ev.device_type != DeviceType.CPU]
        busy_ms = sum(r[2] for r in rows)
        rows.sort(key=lambda r: -r[2])
        rec["profile"] = {
            "device_busy_ms_per_round": busy_ms / rounds,
            "device_ops_per_round": sum(r[1] for r in rows) / rounds,
            # against the unprofiled wall: the profiler slows the host only
            "device_idle_share": (1 - busy_ms / (wall * 1e3)) if rows else None,
            "top": [{"op": k[:90], "count": n, "self_ms": ms} for k, n, ms in rows[:top]],
        }
        out[label] = rec
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--instances", type=int, default=1 << 23)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--fleet", choices=("shrink", "headline"), default="",
                    help="profile fleet dispatches instead of one sim.run")
    ap.add_argument("--member", choices=("config5", "fleet"), default="",
                    help="profile the membership engine instead of one sim.run")
    ap.add_argument("--serve", choices=("full", "fleet"), default="",
                    help="profile open-loop serving dispatches instead of one sim.run")
    ap.add_argument("--dispatches", type=int, default=8,
                    help="--serve: the dispatches profiled")
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
    if args.serve:
        out = {"device": args.device, "card": card,
               **profile_serve(args.serve, args.dispatches, dev, args.top)}
        print(json.dumps(out, indent=1))
        return 0
    if args.fleet:
        out = {"device": args.device, "card": card, **profile_fleet(args.fleet, dev, args.top)}
        print(json.dumps(out, indent=1))
        return 0
    if args.member:
        n = args.instances if args.instances != 1 << 23 else 1 << 20
        out = {"device": args.device, "card": card, **profile_member(args.member, n, dev, args.top)}
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
