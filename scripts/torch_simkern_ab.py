"""Time builds of one ``simkern.cu`` kernel against each other on one
card, in turns, on chip_smoke's synthetic operands and on the operands
of every launch of that kernel in one bench_sim run.

    python3 scripts/torch_simkern_ab.py [--kernel accum_acks|store_accepts] \\
        [LABEL=path/to/simkern.cu ...]

The package's own source is labelled ``tree`` and always comes first.
Each source is compiled with ``nvcc -Xptxas -v`` (all at once; the
register and spill lines are printed) and loaded with ``ctypes``; each
must equal the kernel's plain version exactly on every operand set.
Each source is launched through the interface it declares: a leading
lane count (``nL``, the tree's, launched at one lane), or the older
one-run interfaces, where ``simkern_accum_acks`` (and, earlier still,
``simkern_store_accepts``) take one packed scalar array (``scal``).  The
packed array is built once per operand set, outside the timed events, so
every build is timed on its kernel alone.  Times are CUDA-event
medians from restored operands after an L2 flush
(``chip_smoke.time_in_place``), taken in turns: the sources in the order
given, then in reverse, so each has two turns in one call.

Per bench_sim snapshot it also prints the acceptor sectors the kernel
needs under two rules.  ``accum_acks``: a matched proposer has a batch
there (``live``), or one not yet acked (``unacked``, the rule
``simkern.bytes_needed`` counts).  ``store_accepts``: ``learned`` and
``acc_ballot`` where an eligible proposer has a batch (``needed``), or
``acc_ballot`` only where ``learned`` is also NONE (``unlearned``, the
rule ``simkern.bytes_needed`` counts).  The last line is a JSON summary.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402
from tpu_paxos_torch.core import simkern as sk  # noqa: E402
from tpu_paxos_torch.core import values as val  # noqa: E402
from tpu_paxos_torch.utils import kbuild  # noqa: E402

# kernel: (plain version, in-place operand indices, the two sector rules)
KERNELS = {
    "accum_acks": (sk.accum_acks_plain, (0,), ("live", "unacked")),
    "store_accepts": (sk.store_accepts_plain, (0, 1), ("needed", "unlearned")),
}


def build(kernel: str, sources: list) -> list:
    """Compile every ``(label, path)`` source at once; return
    ``[(label, launch function)]`` in the same order."""
    out_dir = os.path.join(kbuild.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    compiler = kbuild.nvcc()
    builds = []
    for label, src in sources:
        with open(src, "rb") as f:
            text = f.read()
        digest = hashlib.sha256(text).hexdigest()[:16]
        out = os.path.join(out_dir, f"{label}_{kbuild.ARCH}_{digest}.so")
        builds.append((label, src, text.decode(), out, subprocess.Popen(
            [compiler, f"-arch={kbuild.ARCH}", "-O3", "-std=c++17", "-shared",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", out, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    launches = []
    for label, src, text, out, proc in builds:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {src}:\n{log}")
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"ptxas [{label}] {line.split(':', 1)[-1].strip()}")
        lib = ctypes.CDLL(out)
        lanes = lane_interface(text)
        if kernel == "accum_acks":
            launches.append((label, _ack_launcher(lib, lanes)))
        else:
            launches.append((label, _store_launcher(lib, lanes, packed_store_scalars(text))))
    return launches


def _signature(text: str, fn: str) -> str:
    m = re.search(rf"int\s+{fn}\s*\(([^)]*)\)", text)
    if m is None:
        raise ValueError(f"no {fn} in the source")
    return m.group(1)


def packed_store_scalars(text: str) -> bool:
    """Whether a source's ``simkern_store_accepts`` takes one packed
    scalar array (``scal``) instead of ``abal`` and ``elig``."""
    return re.search(r"\bscal\b", _signature(text, "simkern_store_accepts")) is not None


def lane_interface(text: str) -> bool:
    """Whether a source's launchers take a leading lane count (``nL``)."""
    return re.search(r"\bnL\b", _signature(text, "simkern_store_accepts")) is not None


_PACKED: dict = {}


def _packed(first, pa):
    """The older interfaces' [P] + [P, A] int32 scalar array, built once
    per operand pair (outside the timed events)."""
    key = (first.data_ptr(), pa.data_ptr(), first.device)
    if key not in _PACKED:
        _PACKED[key] = torch.cat([
            first.to(torch.int32).reshape(-1), pa.to(torch.int32).reshape(-1),
        ]).contiguous()
    return _PACKED[key]


def _ack_launcher(lib, lanes: bool):
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.simkern_accum_acks.argtypes = (
        [vp] * 8 + [i32] * 3 + [i64, vp] if lanes else [vp] * 7 + [i32, i32, i64, vp]
    )
    lib.simkern_accum_acks.restype = i32

    def launch(acks, cur_batch, acc_ballot, acc_vid, learned, ballot, amatch_pa):
        p, a, i = acks.shape
        n_ack = torch.empty((p, i), dtype=torch.int32, device=acks.device)
        if lanes:
            scalars, dims = [ballot.data_ptr(), amatch_pa.data_ptr()], [1, a, p, i]
        else:
            scalars, dims = [_packed(ballot, amatch_pa).data_ptr()], [a, p, i]
        code = lib.simkern_accum_acks(
            acks.data_ptr(), n_ack.data_ptr(), cur_batch.data_ptr(),
            acc_ballot.data_ptr(), acc_vid.data_ptr(), learned.data_ptr(),
            *scalars, *dims, torch.cuda.current_stream().cuda_stream,
        )
        if code != 0:
            raise RuntimeError(f"accum_acks launch failed ({code})")
        return acks, n_ack

    return launch


def _store_launcher(lib, lanes: bool, packed: bool):
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.simkern_store_accepts.argtypes = (
        [vp] * (5 if packed else 6) + [i32] * (3 if lanes else 2) + [i64, vp]
    )
    lib.simkern_store_accepts.restype = i32

    def launch(acc_ballot, acc_vid, learned, abat, abal, elig):
        a, i = acc_ballot.shape
        if packed:
            scalars = [_packed(abal, elig).data_ptr()]
        else:
            scalars = [abal.data_ptr(), elig.data_ptr()]
        dims = [1, a, abat.shape[0], i] if lanes else [a, abat.shape[0], i]
        code = lib.simkern_store_accepts(
            acc_ballot.data_ptr(), acc_vid.data_ptr(), learned.data_ptr(),
            abat.data_ptr(), *scalars, *dims, torch.cuda.current_stream().cuda_stream,
        )
        if code != 0:
            raise RuntimeError(f"store_accepts launch failed ({code})")
        return acc_ballot, acc_vid

    return launch


def in_turns(kernel: str, launches: list, ops, reps: int) -> dict:
    """Each build equal to the plain version on ``ops``, then timed in
    the given order and in reverse: ``{label: [ms, ms]}``."""
    plain, in_place, _ = KERNELS[kernel]
    want = plain(*ops)
    for label, launch in launches:
        got = launch(*[t.clone() if k in in_place else t for k, t in enumerate(ops)])
        torch.cuda.synchronize()
        if cs._max_abs_err(zip(got, want)):
            raise SystemExit(f"build {label} disagrees with {kernel}'s plain version")
    del want
    times = {label: [] for label, _ in launches}
    for label, launch in launches + launches[::-1]:
        times[label].append(cs.time_in_place(launch, ops, in_place, reps))
    return times


def acceptor_sectors(kernel: str, ops) -> tuple[int, int]:
    """Acceptor-array bytes (the [A, I] int32 rows' sectors) the kernel
    needs under its two rules (``KERNELS``), the wider rule first."""
    if kernel == "accum_acks":
        acks, cur_batch, _, _, _, _, amatch_pa = ops
        live = amatch_pa[:, :, None] & (cur_batch != val.NONE)[:, None, :]
        unacked = live & ((acks & 1) == 0)
        # acc_ballot, acc_vid and learned
        return (3 * sk._sector_bytes(live.any(dim=0), 4),
                3 * sk._sector_bytes(unacked.any(dim=0), 4))
    _, _, learned, abat, _, elig = ops
    need = (elig[:, :, None] & (abat != val.NONE)[:, None, :]).any(dim=0)
    # learned, and acc_ballot beside it or only where learned is NONE
    rows = sk._sector_bytes(need, 4)
    return 2 * rows, rows + sk._sector_bytes(need & (learned == val.NONE), 4)


def _synthetic_ops(kernel: str):
    ab, av, lr, bat, abal, elig, acks = cs._rand_inputs(cs.I_FULL, seed=cs.I_FULL)
    if kernel == "accum_acks":
        return (acks, bat, ab, av, lr, abal, elig)
    return (ab, av, lr, bat, abal, elig)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="accum_acks")
    ap.add_argument("sources", nargs="*", metavar="LABEL=PATH")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_simkern_ab: CUDA is not available", file=sys.stderr)
        return 1
    kernel = args.kernel
    wide, narrow = KERNELS[kernel][2]
    sources = [("tree", kbuild.source(sk.NAME))]
    sources += [tuple(arg.split("=", 1)) for arg in args.sources]
    card = cs._card_line()
    print(f"card: {card} | kernel {kernel}")
    launches = build(kernel, sources)
    sk.load()

    ops = _synthetic_ops(kernel)
    synthetic = in_turns(kernel, launches, ops, cs.REPS)
    synth_bound = sk.bytes_needed(kernel, *ops) / cs.HBM_BYTES_PER_S * 1e3
    print(f"synthetic A={cs.A} P={cs.P} I={cs.I_FULL}: {json.dumps(synthetic, sort_keys=True)} "
          f"needed bound {synth_bound:.4f} ms")
    del ops

    with open(os.path.join(HERE, "tpu_paxos_torch", "data", "goldens.json")) as fh:
        goldens = json.load(fh)
    counts = cs.run_main_path(sk, goldens)
    snaps = cs.snapshot_main_path(sk, goldens, counts)[kernel]
    main_path = {label: [0.0, 0.0] for label, _ in launches}
    needed = wide_b = narrow_b = 0
    for n, ops in enumerate(snaps):
        t = in_turns(kernel, launches, ops, cs.SNAP_REPS)
        for label, _ in launches:
            main_path[label][0] += t[label][0]
            main_path[label][1] += t[label][1]
        b = sk.bytes_needed(kernel, *ops)
        wb, nb = acceptor_sectors(kernel, ops)
        needed, wide_b, narrow_b = needed + b, wide_b + wb, narrow_b + nb
        print(f"snapshot {n}: needs {b} bytes; acceptor sectors {wide} {wb}, {narrow} {nb} "
              f"({1 - nb / max(wb, 1):.1%} fewer) {json.dumps(t, sort_keys=True)}")
    bound = needed / cs.HBM_BYTES_PER_S * 1e3
    print(f"main path {kernel} sums: {json.dumps(main_path, sort_keys=True)} needed bound {bound:.4f} ms; "
          f"acceptor sectors {wide} {wide_b}, {narrow} {narrow_b} "
          f"({1 - narrow_b / max(wide_b, 1):.1%} fewer)")
    print(json.dumps({
        "card": card, "kernel": kernel, "synthetic_ms": synthetic,
        "synthetic_bound_ms": synth_bound, "main_path_ms": main_path,
        "main_path_bound_ms": bound,
        f"acceptor_bytes_{wide}": wide_b, f"acceptor_bytes_{narrow}": narrow_b,
    }, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
