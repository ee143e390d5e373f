#!/usr/bin/env python3
"""Run one cell of the H100 benchmark of felics_tpu_torch and print its
result as the last line of standard output.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Exits nonzero, printing no result, when
there is no CUDA device (or fewer than the cell asks for), when the code
under test is missing, or when JAX or the JAX package has been loaded.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="length of the window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: per-layer metrics from a profiled window")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, ROOT)
    from h100_bench import harness

    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
