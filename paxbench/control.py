"""The control: a cell run as the benchmark runs it, with one fault of
``faults.py`` planted under its timed path, whose comparison has to come
out not correct.

    python3 -m paxbench.control --workload <cell> --seed <n> --seconds <s> --fault <name>

Prints the result line as ``run.py`` does (``correct`` should be false;
the numbers compared, each beside its limit, last on stderr).  The
benchmark's own runs never plant a fault.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--fault", required=True)
    args = p.parse_args(argv)
    from paxbench import faults, harness

    kind = harness.cell_kind(args.workload)
    try:
        out = harness.run_cell(args.workload, args.seed, args.seconds, False, t_start=T0,
                               fault=lambda: faults.plant(kind, args.fault))
    except harness.NoResult as exc:
        print(f"paxbench: no result: {exc}", file=sys.stderr)
        return 2
    harness.print_result(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
