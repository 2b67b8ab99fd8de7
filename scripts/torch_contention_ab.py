"""Does a host-check child of ``chip_smoke.py``'s kind and phase 21's
audit child slow the host-looped phases that run beside them?  Times
those phases' runs with and without the children, in one process on the
card.

    python scripts/torch_contention_ab.py [--reps N]

The host-check child is numpy and ``tpu_paxos_torch.native`` on a
``[1e8, 7]`` array and its 1e8-line decision log (about 270 s of host
work, 19b's full size); the audit child runs on the same card.  The
phases' ms a round are host-bound.  This script times, on the card:

- 20a: phase 9's 128-lane headline cycle on the 8-rank lane tile (ms a
  rank round);
- 15c: the 256-lane serve fleet at its 128000-milli cell (ms a round);
- 16c: the controlled 256-lane fleet (ms a round);
- 15a: the 65536-value serve run at I=131072 (ms a round), once each
  way,

first alone (A), then with both children running (B: the host-check
child on a ``[1e8, 7]`` array of the same shape as 19b's, made on the
host, and the audit child), then alone again, in the order A, A(15a),
B, B(15a), B, A, with each run's host syncs a round.  The children are
stopped after the last B.  One warm run of each short workload comes
first.  Prints the card (``nvidia-smi`` name and power limit) and one
JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

N_19B, A_19B = 100_000_000, 7


def _workloads(goldens):
    from tpu_paxos_torch.fleet import runner as frun
    from tpu_paxos_torch.parallel import mesh as pmesh

    script = cs._goldens_script(HERE)
    m = script.serve_modules(port=True)
    width = script.serve_fleet_width(m)
    rate = goldens["serve"]["config"]["fleet"]["rates"][-1]
    cfg, wl, gates = cs._fleet_config(goldens)
    seeds, sch, knobs = cs._fleet_cycle(goldens, "headline")
    mesh = pmesh.make_instance_mesh(cs.TILE_RANKS, device=cs.DEV)
    tile = frun.FleetRunner(cfg, wl, gates, mesh=mesh, device=cs.DEV)

    def serve_calls(rep):
        return rep.dispatches * rep.windows_per_dispatch * rep.rounds_per_window

    short = {
        "20a": (lambda: tile.run(seeds, sch, knobs=knobs), lambda rep: sum(rep.rank_iterations)),
        "15c": (lambda: script.serve_fleet_run(m, rate, width, device=cs.DEV), serve_calls),
        "16c": (lambda: script.control_fleet_run(m, device=cs.DEV), serve_calls),
    }
    long = {"15a": (lambda: script.serve_full_run(m, device=cs.DEV), serve_calls)}
    return short, long


def _time(name, fn, rounds_of, label: str, out: dict, card: str) -> None:
    rep, wall, syncs, _ = cs._serve_timed(fn)
    rounds = rounds_of(rep)
    del rep
    torch.cuda.empty_cache()
    rec = {"ms_per_round": wall / rounds * 1e3, "syncs_per_round": syncs / rounds,
           "wall_s": wall}
    out.setdefault(name, {}).setdefault(label, []).append(rec)
    print(f"{name} [{label}]: wall_s={wall:.3f} rounds={rounds} "
          f"ms_per_round={rec['ms_per_round']:.3f} syncs_per_round={rec['syncs_per_round']:.2f} "
          f"| {card}", flush=True)


def _start_children(card: str) -> list:
    import numpy as np

    # paxlint: allow[DET001] the set-up's wall is printed, never serialized
    t0 = time.perf_counter()
    vids = np.arange(N_19B, dtype=np.int32)
    native = cs.start_native_compare(
        {"learned": np.repeat(vids[:, None], A_19B, axis=1), "chosen_vid": vids,
         "chosen_ballot": np.ones(N_19B, np.int32)},
        1 << 27, N_19B, f"load, [{N_19B}, {A_19B}]", card)
    audit = cs._spawn([cs.AUDIT_FLAG], native[1], "audit")
    # paxlint: allow[DET001] the set-up's wall is printed, never serialized
    print(f"children started ({time.perf_counter() - t0:.1f} s to save the arrays)", flush=True)
    return [native, audit]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=2, help="runs of each short workload a turn")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_contention_ab: CUDA is not available", file=sys.stderr)
        return 1
    card = cs._card_line()
    print(card, flush=True)
    with open(os.path.join(HERE, "tpu_paxos_torch", "data", "goldens.json")) as fh:
        goldens = json.load(fh)
    from tpu_paxos_torch.core import fastwin, simkern
    from tpu_paxos_torch.utils import kbuild

    kbuild.build_all([simkern.NAME, fastwin.NAME])
    simkern.load()
    fastwin.load()
    short, long = _workloads(goldens)
    out: dict = {}
    for name, (fn, rounds_of) in sorted(short.items()):
        _time(name, fn, rounds_of, "warm", out, card)

    def turn(label):
        for _ in range(args.reps):
            for name, (fn, rounds_of) in sorted(short.items()):
                _time(name, fn, rounds_of, label, out, card)

    try:
        turn("alone")
        for name, (fn, rounds_of) in sorted(long.items()):
            _time(name, fn, rounds_of, "alone", out, card)
        children = _start_children(card)
        turn("beside")
        for name, (fn, rounds_of) in sorted(long.items()):
            _time(name, fn, rounds_of, "beside", out, card)
        turn("beside")
        alive = [c[2] for c in children if c[0].poll() is None]
        print(f"children still running after the last B run: {alive}", flush=True)
    finally:
        cs.stop_children()
    turn("alone")
    summary = {}
    for name, runs in sorted(out.items()):
        med = {label: statistics.median(r["ms_per_round"] for r in recs)
               for label, recs in sorted(runs.items()) if label != "warm"}
        summary[name] = {
            "ms_per_round_median": med,
            "beside_over_alone": med["beside"] / med["alone"],
            "syncs_per_round": sorted({round(r["syncs_per_round"], 4)
                                       for label, recs in sorted(runs.items())
                                       if label != "warm"
                                       for r in recs}),
        }
    print(json.dumps({"card": card, "workloads": summary, "runs": out}, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
