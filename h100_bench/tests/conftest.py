"""Shared helpers of the benchmark's CPU tests: cells cut to a size the
plain versions of the code under test run in well under a second."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CELLS = ["gray8-t64.ingest-b12", "gray8-t64.serve-stream-4x3"]
# The cells of BENCHMARK.json by their configuration and mix, and a batch
# decode of mixed sizes, so that the driver no cell uses yet (and the
# eager chain of mixed shapes) runs too.
PAIRS = {
    "gray8-t64.ingest-b12": ("flct-gray8-t64", "ingest-b12"),
    "gray8-t64.serve-stream-4x3": ("flct-gray8-t64", "serve-stream-4x3"),
    "gray8-t64.serve-mixed": ("flct-gray8-t64", "serve-stream-4x3"),
}
MIXED = {"driver": "decompress_tiled_batch", "sizes": [[512, 512], [256, 256]],
         "counts": [12, 12], "batch": 6}


def pair_cell(name):
    """The cell of a pair, reporting no metric (the CPU tests read the
    check and the run)."""
    from h100_bench import harness

    config, traffic = PAIRS[name]
    cell = harness.make_cell(name, 1, harness.BENCH_DIR / "configs" / f"{config}.json",
                             traffic, [], [])
    if name.endswith("mixed"):
        cell.mix.update(MIXED)
    return cell


def tiny(cell):
    """The cell with 8x8 tiles and pools of a few small images, the calls
    and passes of its mix kept whole (set-up's warm blocks cut with
    ``warm_blocks_of_two``)."""
    cell.config["tile"] = [8, 8]
    m = cell.mix
    per_call = m["batch"]
    m["sizes"] = [[12 + 6 * i, 16 + 4 * i] for i in range(len(m["sizes"]))]
    if len(m["sizes"]) > 1:
        m["counts"] = [per_call // len(m["sizes"]) + 1] * len(m["sizes"])
        m["counts"][-1] = 2 * per_call - sum(m["counts"][:-1])
    else:
        m["counts"] = [2 * per_call]
    m["sample_calls"] = 2
    m["trace_calls"] = 1
    return cell


@pytest.fixture
def warm_blocks_of_two(monkeypatch):
    from h100_bench import harness

    monkeypatch.setattr(harness, "WARM_BLOCK", 2)


@pytest.fixture
def cpu(warm_blocks_of_two):
    import torch

    return torch.device("cpu")
