"""The command without a card: it fails and prints no result (no fallback
to the CPU); with a card, every cell runs briefly and comes out correct."""

import json
import shutil
import subprocess
import sys

import pytest

from conftest import CELLS, ROOT


def command(cwd, cell, seconds=1, trace=0):
    return subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload", cell, "--seed", str(2**31 + 3),
         "--seconds", str(seconds), "--trace", str(trace)],
        cwd=cwd, capture_output=True, text=True, timeout=900)


def result_lines(stdout):
    out = []
    for line in stdout.splitlines():
        try:
            out.append(json.loads(line))
        except ValueError:
            pass
    return out


def test_without_a_card_it_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    p = command(ROOT, CELLS[0])
    assert p.returncode != 0 and not result_lines(p.stdout)
    assert "CUDA" in p.stderr


def test_with_only_the_benchmark_it_fails(tmp_path):
    shutil.copy(f"{ROOT}/BENCHMARK.json", tmp_path)
    shutil.copytree(f"{ROOT}/h100_bench", tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = command(tmp_path, CELLS[0])
    assert p.returncode != 0 and not result_lines(p.stdout)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for trace in (0, 1):
        p = command(ROOT, cell, 1, trace)
        assert p.returncode == 0, p.stderr[-2000:]
        line = result_lines(p.stdout)[-1]
        assert line["correct"] and line["device"]["platform"] == "gpu"
