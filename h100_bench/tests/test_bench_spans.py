"""The readers of the program's host spans (``host_stage_ms``,
``host_finish_ms``, ``host_wait_ms``, ``.enc`` and ``.dec``): the union of
the spans of their prefix over a window's calls, nested and overlapping
spans counted once, and nothing where the window holds no such span (a
program without spans). A traced run of each cell reports them."""

import time

import pytest

from conftest import CELLS, tiny
from h100_bench import harness, trace

METRICS = {"host_stage_ms": "felics.stage.", "host_finish_ms": "felics.finish.",
           "host_wait_ms": "felics.wait"}
READERS = [f"{m}.{d}" for m in METRICS for d in ("enc", "dec")]


def reader(name):
    return harness.load_file(harness.BENCH_DIR / "metrics" / f"{name}.py").read


def window(host):
    """Two calls of 100 us, each with the host events ``host``."""
    return trace.Window(calls=2, wall_s=300e-6, call_spans=[(0.0, 100.0), (200.0, 300.0)],
                        device=[("flct_encode_kernel", 50.0, 60.0)], blocking=[],
                        host=host, launches=1, kernel="flct_encode_kernel")


HOST = [
    ("aten::empty", 1.0, 2.0),
    # call 1: overlapping stage spans, 0-20; finish spans end to end, 40-70
    ("felics.stage.group", 0.0, 10.0), ("felics.stage.fill", 5.0, 20.0),
    ("felics.wait", 20.0, 40.0),
    ("felics.finish.strip", 40.0, 60.0), ("felics.finish.pack", 60.0, 70.0),
    # call 2: a stage span nested in another, 210-240; one finish span
    ("felics.stage.fill", 210.0, 240.0), ("felics.stage.group", 215.0, 220.0),
    ("felics.wait", 240.0, 250.0),
    ("felics.finish.copy_out", 250.0, 260.0),
]
# ms a call: (20 + 30) / 2, (30 + 10) / 2, (20 + 10) / 2
WANT = {"host_stage_ms": 0.025, "host_finish_ms": 0.02, "host_wait_ms": 0.015}


@pytest.mark.parametrize("name", READERS)
def test_reader_is_the_union_over_calls(name):
    got = reader(name)(harness.Run("encode", window=window(HOST)))
    assert got == pytest.approx(WANT[name.split(".")[0]], abs=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_without_spans(name):
    read = reader(name)
    assert read(harness.Run("decode")) is None
    bare = [e for e in HOST if not e[0].startswith("felics.")]
    assert read(harness.Run("decode", window=window(bare))) is None


def test_every_reader_is_in_the_benchmark():
    bench = harness.read_bench()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        m = entries[name]
        cell = CELLS[0] if name.endswith(".enc") else CELLS[1]
        assert m["source"] == "program_span" and cell in m["workloads"]
        assert m["layer"] == "entry and host chain" and m["unit"] == "ms"


@pytest.mark.parametrize("cell_name", CELLS)
def test_a_traced_cpu_run_reports_the_span_metrics(cell_name, cpu):
    """On the CPU the program waits on no device event, so the wait metric
    is left out there; the card's run below reports it."""
    cell = tiny(harness.load_cell(cell_name))
    res, checks = harness.run_cell(cell, 2**31 + 29, 0.2, True, cpu, time.perf_counter())
    line = harness.report(cell, True, res, checks, cpu)
    d = "enc" if "ingest" in cell_name else "dec"
    metrics = line["metrics"]
    for m in ("host_stage_ms", "host_finish_ms"):
        assert metrics[f"{m}.{d}"]["value"] > 0 and metrics[f"{m}.{d}"]["unit"] == "ms"
    assert f"host_wait_ms.{d}" not in metrics
    assert line["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
def test_a_traced_card_run_reports_every_span_metric(cell_name):
    import torch

    from test_bench_card import command, result_lines

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = command(harness.ROOT, cell_name, 1, 1)
    assert p.returncode == 0, p.stderr[-2000:]
    line = result_lines(p.stdout)[-1]
    d = "enc" if "ingest" in cell_name else "dec"
    for m in METRICS:
        assert line["metrics"][f"{m}.{d}"]["value"] > 0
    assert not [n for n, *_ in line["breakdown"]["device_ops"] if n.startswith("felics.")]
