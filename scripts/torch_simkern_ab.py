"""Time builds of ``simkern.cu``'s ``accum_acks`` against each other on
one card, in turns, on chip_smoke's synthetic operands and on the
operands of every ``accum_acks`` launch of one bench_sim run.

    python3 scripts/torch_simkern_ab.py [LABEL=path/to/simkern.cu ...]

The package's own source is labelled ``tree`` and always comes first.
Each source is compiled with ``nvcc -Xptxas -v`` (all at once; the
register and spill lines are printed) and loaded with ``ctypes``; each
must equal ``simkern.accum_acks_plain`` exactly on every operand set.
Times are CUDA-event medians from restored operands after an L2 flush
(``chip_smoke.time_in_place``), taken in turns: the sources in the order
given, then in reverse, so each has two turns in one call.

Per bench_sim snapshot it also prints the acceptor sectors the ack fold
needs under two rules: a matched proposer has a batch there (``live``),
and a matched proposer has a batch there that is not yet acked
(``unacked``, the rule ``simkern.bytes_needed`` counts).  The last line
is a JSON summary.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402
from tpu_paxos_torch.core import simkern as sk  # noqa: E402
from tpu_paxos_torch.core import values as val  # noqa: E402
from tpu_paxos_torch.utils import kbuild  # noqa: E402


def build(sources: list) -> list:
    """Compile every ``(label, path)`` source at once; return
    ``[(label, launch function)]`` in the same order."""
    out_dir = os.path.join(kbuild.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    compiler = kbuild.nvcc()
    builds = []
    for label, src in sources:
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        out = os.path.join(out_dir, f"{label}_{kbuild.ARCH}_{digest}.so")
        builds.append((label, src, out, subprocess.Popen(
            [compiler, f"-arch={kbuild.ARCH}", "-O3", "-std=c++17", "-shared",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", out, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    launches = []
    for label, src, out, proc in builds:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {src}:\n{log}")
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"ptxas [{label}] {line.split(':', 1)[-1].strip()}")
        launches.append((label, _launcher(ctypes.CDLL(out))))
    return launches


def _launcher(lib):
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.simkern_accum_acks.argtypes = [vp] * 7 + [i32, i32, i64, vp]
    lib.simkern_accum_acks.restype = i32

    def launch(acks, cur_batch, acc_ballot, acc_vid, learned, ballot, amatch_pa):
        p, a, i = acks.shape
        scal = sk._scalars(ballot, amatch_pa, acks.device)
        n_ack = torch.empty((p, i), dtype=torch.int32, device=acks.device)
        code = lib.simkern_accum_acks(
            acks.data_ptr(), n_ack.data_ptr(), cur_batch.data_ptr(),
            acc_ballot.data_ptr(), acc_vid.data_ptr(), learned.data_ptr(),
            scal.data_ptr(), a, p, i, torch.cuda.current_stream().cuda_stream,
        )
        if code != 0:
            raise RuntimeError(f"accum_acks launch failed ({code})")
        return acks, n_ack

    return launch


def in_turns(launches: list, ops, reps: int) -> dict:
    """Each build equal to the plain version on ``ops``, then timed in
    the given order and in reverse: ``{label: [ms, ms]}``."""
    want = sk.accum_acks_plain(*ops)
    for label, launch in launches:
        got = launch(ops[0].clone(), *ops[1:])
        torch.cuda.synchronize()
        if cs._max_abs_err(zip(got, want)):
            raise SystemExit(f"build {label} disagrees with accum_acks_plain")
    del want
    times = {label: [] for label, _ in launches}
    for label, launch in launches + launches[::-1]:
        times[label].append(cs.time_in_place(launch, ops, (0,), reps))
    return times


def acceptor_sectors(ops) -> tuple[int, int]:
    """Acceptor-array bytes (three [A, I] int32 rows' sectors) under the
    ``live`` and the ``unacked`` rule."""
    acks, cur_batch, _, _, _, _, amatch_pa = ops
    live = amatch_pa[:, :, None] & (cur_batch != val.NONE)[:, None, :]
    unacked = live & ((acks & 1) == 0)
    return (3 * sk._sector_bytes(live.any(dim=0), 4),
            3 * sk._sector_bytes(unacked.any(dim=0), 4))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="*", metavar="LABEL=PATH")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_simkern_ab: CUDA is not available", file=sys.stderr)
        return 1
    sources = [("tree", kbuild.source(sk.NAME))]
    sources += [tuple(arg.split("=", 1)) for arg in args.sources]
    card = cs._card_line()
    print(f"card: {card}")
    launches = build(sources)
    sk.load()

    ab, av, lr, bat, abal, elig, acks = cs._rand_inputs(cs.I_FULL, seed=cs.I_FULL)
    ops = (acks, bat, ab, av, lr, abal, elig)
    synthetic = in_turns(launches, ops, cs.REPS)
    synth_bound = sk.bytes_needed("accum_acks", *ops) / cs.HBM_BYTES_PER_S * 1e3
    print(f"synthetic A={cs.A} P={cs.P} I={cs.I_FULL}: {json.dumps(synthetic, sort_keys=True)} "
          f"needed bound {synth_bound:.4f} ms")
    del ab, av, lr, bat, abal, elig, acks, ops

    with open(os.path.join(HERE, "tpu_paxos_torch", "data", "goldens.json")) as fh:
        goldens = json.load(fh)
    counts = cs.run_main_path(sk, goldens)
    snaps = cs.snapshot_main_path(sk, goldens, counts)["accum_acks"]
    main_path = {label: [0.0, 0.0] for label, _ in launches}
    needed = live_b = unacked_b = 0
    for n, ops in enumerate(snaps):
        t = in_turns(launches, ops, cs.SNAP_REPS)
        for label, _ in launches:
            main_path[label][0] += t[label][0]
            main_path[label][1] += t[label][1]
        b = sk.bytes_needed("accum_acks", *ops)
        lb, ub = acceptor_sectors(ops)
        needed, live_b, unacked_b = needed + b, live_b + lb, unacked_b + ub
        print(f"snapshot {n}: needs {b} bytes; acceptor sectors live {lb}, unacked {ub} "
              f"({1 - ub / max(lb, 1):.1%} fewer) {json.dumps(t, sort_keys=True)}")
    bound = needed / cs.HBM_BYTES_PER_S * 1e3
    print(f"main path accum_acks sums: {json.dumps(main_path, sort_keys=True)} needed bound {bound:.4f} ms; "
          f"acceptor sectors live {live_b}, unacked {unacked_b} ({1 - unacked_b / max(live_b, 1):.1%} fewer)")
    print(json.dumps({
        "card": card, "synthetic_ms": synthetic, "synthetic_bound_ms": synth_bound,
        "main_path_ms": main_path, "main_path_bound_ms": bound,
        "acceptor_bytes_live": live_b, "acceptor_bytes_unacked": unacked_b,
    }, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
