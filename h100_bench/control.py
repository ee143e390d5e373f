#!/usr/bin/env python3
"""Read the comparison's numbers on the card for the code under test and
for the control (the reference with one guarantee broken, as the
configuration's container module picks it: ``containers/<container>.py``,
``reference/controls.py``), seed after seed, in one process.

    python3 h100_bench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

Prints one JSON line a run: the seed, which side ran, ``correct`` and the
numbers compared. The benchmark's own runs never run the control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from h100_bench import check, harness

    if not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    harness.set_heap(cell.config)
    container = harness.load_container(cell.config)
    direction = harness.load_file(
        harness.BENCH_DIR / "drivers" / f"{cell.mix['driver']}.py").DIRECTION
    for seed in args.seeds:
        for side in ("program", "control"):
            sub = container.control(direction, cell.config, device) if side == "control" else None
            t0 = time.perf_counter()
            result, checks = harness.run_cell(cell, seed, args.seconds, False, device,
                                              t0, substitute=sub)
            print(json.dumps({
                "workload": cell.name, "seed": seed, "side": side,
                "correct": check.correct(checks) and result["failed"] == 0,
                "calls": result["run"].calls, "failed": result["failed"],
                "check_s": result["check_s"],
                "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
