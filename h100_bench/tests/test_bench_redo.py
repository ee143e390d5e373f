"""The reader of ``redo_share.enc`` (the program's ``felics.finish.redo.*``
spans over its ``felics.stage.key`` spans, one a geometry group) and the
rgb8 ingest cell ``rgb8-t32.ingest-b8``: its driver hands over images as
a decoder lays them out, and a traced CPU run of it, cut to a tiny size,
reports every per-layer metric it lists that the CPU can give, and comes
out correct."""

import time

import numpy as np
import pytest

from conftest import tiny
from h100_bench import harness, trace

RGB_CELL = "rgb8-t32.ingest-b8"
INGEST = ["gray8-t64.ingest-b12", RGB_CELL]


def reader():
    return harness.load_file(harness.BENCH_DIR / "metrics" / "redo_share.enc.py").read


def window(host):
    return trace.Window(calls=2, wall_s=300e-6, call_spans=[(0.0, 100.0), (200.0, 300.0)],
                        device=[("flct_encode_kernel", 50.0, 60.0)], blocking=[],
                        host=host, launches=1, kernel="flct_encode_kernel")


# two calls of two groups each; one width redo and one capacity redo
HOST = [
    ("felics.stage.group", 0.0, 10.0),
    ("felics.stage.key", 10.0, 12.0), ("felics.stage.key", 12.0, 14.0),
    ("felics.finish.redo.width", 40.0, 41.0), ("felics.finish.strip", 41.0, 50.0),
    ("felics.stage.group", 200.0, 210.0),
    ("felics.stage.key", 210.0, 212.0), ("felics.stage.key", 212.0, 214.0),
    ("felics.finish.redo.capacity", 240.0, 241.0), ("aten::empty", 241.0, 242.0),
]


@pytest.mark.parametrize("host, want", [
    (HOST, 50.0),
    ([e for e in HOST if not e[0].startswith("felics.finish.redo.")], 0.0),
    ([e for e in HOST if e[0] != "felics.finish.redo.capacity"], 25.0),
], ids=["two-of-four", "none", "one-of-four"])
def test_reader_is_redo_spans_over_groups(host, want):
    assert reader()(harness.Run("encode", window=window(host))) == pytest.approx(want)


def test_reader_finds_nothing_without_groups_or_redo_spans(monkeypatch):
    from felics_tpu_torch.parallel import tiling

    read = reader()
    assert read(harness.Run("encode")) is None
    assert read(harness.Run("decode", window=window(HOST))) is None
    keyless = [e for e in HOST if e[0] != "felics.stage.key"]
    assert read(harness.Run("encode", window=window(keyless))) is None
    monkeypatch.delattr(tiling, "REDO_SPANS")  # a program without the spans
    assert read(harness.Run("encode", window=window(HOST))) is None


def test_the_benchmark_lists_the_reader_and_the_cell():
    bench = harness.read_bench()
    m = {m["name"]: m for m in bench["per_layer"]}["redo_share.enc"]
    assert m["source"] == "program_span" and set(INGEST) <= set(m["workloads"])
    assert m["layer"] == "entry and host chain" and m["moves"] == "encode_mpx_s"
    assert (m["unit"], m["better"]) == ("%", "lower")
    cell = harness.load_cell(RGB_CELL)
    assert cell.config["color"] == "rgb" and cell.config["tile"] == [32, 32]
    assert (cell.mix["batch"], cell.mix["counts"]) == (8, [64]) and cell.chips == 1
    gray = harness.load_cell(INGEST[0])
    assert {x["name"] for x in cell.per_layer} == {x["name"] for x in gray.per_layer}
    assert {x["name"] for x in cell.end_to_end} == {"encode_mpx_s", "setup_s"}


def test_the_rgb8_cell_hands_over_images_as_a_decoder_does(cpu):
    """The pool's rgb images are (H, W, 3) views of (3, H, W) data; the
    cell's driver gives the entry point C-contiguous copies of them."""
    from h100_bench.traffic import images

    cell = harness.load_cell(RGB_CELL)
    drv = harness.load_file(harness.BENCH_DIR / "drivers" / f"{cell.mix['driver']}.py")
    pool = images.make_pool(2**32 + 43, [(24, 20)], [3], True, 8, cpu)
    assert not any(im.flags.c_contiguous for im in pool)
    driver = drv.Driver(pool, (8, 8), cell.mix, cpu)
    assert drv.DIRECTION == "encode"
    for im, handed in zip(pool, driver.pool):
        assert handed.flags.c_contiguous and np.array_equal(handed, im)


@pytest.mark.parametrize("forced", [False, True], ids=["hinted", "capacity-redo"])
def test_a_traced_cpu_run_of_the_rgb8_cell(forced, cpu, monkeypatch):
    """Tiny rgb8 images at 8x8 tiles; a capacity hint cut to one word
    makes every group redo its compaction, so the share reads 100%."""
    from felics_tpu_torch.parallel import tiling

    if forced:
        monkeypatch.setattr(tiling, "payload_cap_hint", lambda cfg, nt, t, c: 1)
    cell = tiny(harness.load_cell(RGB_CELL))
    res, checks = harness.run_cell(cell, 2**32 + 41, 0.2, True, cpu, time.perf_counter())
    line = harness.report(cell, True, res, checks, cpu)
    metrics = line["metrics"]
    assert line["correct"] and res["run"].window.calls == 1
    assert metrics["redo_share.enc"] == {"value": 100.0 if forced else 0.0, "unit": "%"}
    for name in ("host_stage_ms.enc", "host_finish_ms.enc", "host_work_ms.enc",
                 "call_p95_ms.enc"):
        assert metrics[name]["value"] > 0


@pytest.mark.cuda
def test_the_rgb8_cell_runs_correct_on_the_card():
    import torch

    from test_bench_card import command, result_lines

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for trace_on in (0, 1):
        p = command(harness.ROOT, RGB_CELL, 1, trace_on)
        assert p.returncode == 0, p.stderr[-2000:]
        line = result_lines(p.stdout)[-1]
        assert line["correct"] and line["device"]["platform"] == "gpu"
        names = set(line["metrics"])
        if trace_on:
            assert {"redo_share.enc", "k1_roofline", "host_wait_ms.enc"} <= names
        else:
            assert names == {"encode_mpx_s", "setup_s"}
