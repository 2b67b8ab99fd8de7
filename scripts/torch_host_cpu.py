"""How much host CPU does one process of the port use while it drives the
card?  Runs ``chip_smoke.py``'s host-looped workloads in this process and
prints, for each, its wall seconds and the CPU seconds that this process
spent in that time (every thread of it, user and system), so that the
ratio says how many cores one such process keeps busy.

    python scripts/torch_host_cpu.py [--threads N] [--reps N]

The workloads: bench_sim's ``sim.run`` (5 nodes, 2**23 instances, phase
3's configuration), phase 9's 128-lane fleet headline cycle and the
256-lane serve fleet at its 128000-milli cell (15c).  ``--threads N``
calls ``torch.set_num_threads(N)`` first.  Prints the card (``nvidia-smi``
name and power limit), torch's thread counts and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402


def _cpu_s() -> float:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def _threads() -> int:
    with open("/proc/self/status") as f:
        return int(next(x for x in f if x.startswith("Threads:")).split()[1])


def _workloads(goldens):
    from tpu_paxos_torch.core import sim
    from tpu_paxos_torch.fleet import runner as frun

    script = cs._goldens_script(HERE)
    m = script.serve_modules(port=True)
    width = script.serve_fleet_width(m)
    rate = goldens["serve"]["config"]["fleet"]["rates"][-1]
    bench = cs._bench_cfg(goldens["bench_sim"])
    cfg, wl, gates = cs._fleet_config(goldens)
    seeds, sch, knobs = cs._fleet_cycle(goldens, "headline")
    fleet = frun.FleetRunner(cfg, wl, gates, device=cs.DEV)
    return {
        "bench_sim": lambda: sim.run(bench, device=cs.DEV),
        "fleet_headline_128": lambda: fleet.run(seeds, sch, knobs=knobs),
        "serve_fleet_256": lambda: script.serve_fleet_run(m, rate, width, device=cs.DEV),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_host_cpu: CUDA is not available", file=sys.stderr)
        return 1
    if args.threads:
        torch.set_num_threads(args.threads)
    from tpu_paxos_torch.core import fastwin as fw
    from tpu_paxos_torch.core import simkern as sk
    from tpu_paxos_torch.utils import kbuild

    kbuild.build_all([sk.NAME, fw.NAME])
    sk.load()
    with open(os.path.join(HERE, "tpu_paxos_torch", "data", "goldens.json")) as fh:
        goldens = json.load(fh)
    card = cs._card_line()
    print(f"{card} | torch threads {torch.get_num_threads()} interop "
          f"{torch.get_num_interop_threads()} | os cpus {os.cpu_count()}")
    out = {}
    work = _workloads(goldens)
    for name in sorted(work):
        fn = work[name]
        fn()  # warm: the first run builds what it caches
        # paxlint: allow[JAX103] one sync a timed run, outside the run
        torch.cuda.synchronize()
        for rep in range(args.reps):
            # paxlint: allow[DET001] the run's wall is printed, never serialized
            c0, t0 = _cpu_s(), time.perf_counter()
            fn()
            # paxlint: allow[JAX103] one sync a timed run, outside the run
            torch.cuda.synchronize()
            # paxlint: allow[DET001] the run's wall is printed, never serialized
            wall, cpu = time.perf_counter() - t0, _cpu_s() - c0
            out.setdefault(name, []).append(
                {"wall_s": wall, "cpu_s": cpu, "cpu_per_wall": cpu / wall,
                 "threads": _threads()})
            print(f"{name} rep {rep}: wall_s={wall:.3f} cpu_s={cpu:.3f} "
                  f"cpu_per_wall={cpu / wall:.3f} threads={_threads()} | {card}")
    print(json.dumps({"threads": torch.get_num_threads(), "runs": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
