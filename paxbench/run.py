"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 -m paxbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints one JSON line last on stdout (with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics and the trace's breakdown), and the numbers that
decided ``correct``, each beside its limit, last on stderr.  Exits 2 and
prints no result where the cell cannot run here: no CUDA card or too few,
no program in the checkout, or ``jax``/``tpu_paxos`` loaded when the
window closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from paxbench import harness

    try:
        out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                               t_start=T0)
    except harness.NoResult as exc:
        print(f"paxbench: no result: {exc}", file=sys.stderr)
        return 2
    harness.print_result(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
