"""FLCT gray16 at 32x32 tiles, the benchmark's 16-bit gray archive, on the
CPU: the port's batched encode against the plain reference that the
benchmark holds it to (``h100_bench/reference/flct_ref.py``: k 0..14,
16-bit raw preambles, the k0 prior over 6 x 15 (bucket, k) totals), byte
for byte, and the batched decode back to every image exactly; the graph
branch of the group dispatch (``test_torch_onepass``'s stub capture) and
the eager chain of a mixed-size group; and a tiny run of each of the
configuration's cells through the benchmark's harness, in a process of
its own (the harness refuses to run beside JAX, which this suite loads)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from felics_tpu_torch.config import TileConfig  # noqa: E402
from felics_tpu_torch.parallel import batch, graphs, tiling  # noqa: E402
from h100_bench.reference import flct_ref  # noqa: E402
from h100_bench.traffic import images as traffic  # noqa: E402
from test_torch_onepass import cpu_graphs  # noqa: E402,F401

CPU = torch.device("cpu")
TILE = (32, 32)
CELLS = ["gray16-t32.ingest-b4", "gray16-t32.serve-b4"]


def _noise(h, w, seed):
    return np.random.default_rng(seed).integers(0, 1 << 16, (h, w), dtype=np.uint16)


def _pool(seed, size, n):
    return traffic.make_pool(seed, [size], [n], False, 16, "cpu")


CASES = {
    "traffic-pool-of-three": lambda: _pool(2**31 + 23, (64, 64), 3),
    "full-range-noise-64x96": lambda: [_noise(64, 96, 1)],
    "all-0-and-all-65535": lambda: [np.zeros((64, 64), np.uint16),
                                    np.full((64, 64), 65535, np.uint16)],
    "clamped-edges-33x47": lambda: [_noise(33, 47, 2), _pool(2**31 + 24, (33, 47), 1)[0]],
}


def _round_trip(imgs):
    blobs = batch.compress_tiled_batch(imgs, TileConfig(*TILE), device=CPU)
    assert len(blobs) == len(imgs)
    assert blobs == [flct_ref.encode_image(im, TILE, CPU) for im in imgs]
    for blob in blobs:
        hd = flct_ref.read_container(blob)
        assert (hd.channels, hd.depth) == (1, 16)
    outs = batch.decompress_tiled_batch(blobs, device=CPU)
    assert len(outs) == len(imgs)
    for im, out in zip(imgs, outs):
        assert out.dtype == np.uint16 and np.array_equal(out, im)
    return blobs


@pytest.mark.parametrize("case", CASES)
def test_gray16_t32_batch_equals_reference_and_round_trips(case):
    _round_trip(CASES[case]())


def test_full_range_noise_reaches_k_14_and_outgrows_the_raw_planes():
    """Uniform 16-bit noise: the largest k of the 16-bit tables is coded,
    and every tile's stream is longer than its raw plane."""
    im = _noise(64, 96, 1)
    x = flct_ref.planes(im, *TILE, CPU)
    k0, facts = flct_ref.k_of_image(x, *flct_ref.neighbours(*TILE, CPU), 16)
    assert int(facts["k"].max()) == 14 and 14 in k0.tolist()[0]
    blob = flct_ref.encode_image(im, TILE, CPU)
    assert flct_ref.read_container(blob).tile_lengths.min() > TILE[0] * TILE[1] * 2


def test_a_fresh_16_bit_capacity_hint_is_redone_to_the_reference_bytes(monkeypatch):
    """31 noise tiles of 32x32: ~544 words a tile against the fresh hint's
    514 (the raw plane and 2), 15,934 words rounded up to a bucket of
    16,384, which the noise outgrows. The compaction is redone at the exact
    size, and the bytes are the reference's, that call and the next."""
    monkeypatch.setattr(tiling, "_cap_hints", {})
    before = tiling.REDOS["capacity"]
    _round_trip([_noise(32, 31 * 32, 3)])
    assert tiling.REDOS["capacity"] == before + 1
    _round_trip([_noise(32, 31 * 32, 4)])


def _replayed(direction, call, calls=4):
    """The output of the first of up to ``calls`` calls that replayed a
    graph (a plan runs eagerly at its first sighting, and a hint that moves
    after the first call makes a new plan)."""
    for _ in range(calls):
        before = graphs.REPLAYS[direction]
        out = call()
        if graphs.REPLAYS[direction] > before:
            return out
    raise AssertionError(f"no {direction} graph replayed in {calls} calls")


def test_graph_branch_gives_the_reference_bytes_and_images(cpu_graphs):
    imgs = _pool(2**31 + 25, (64, 64), 4)
    tc = TileConfig(*TILE)
    blobs = _replayed("encode", lambda: batch.compress_tiled_batch(imgs, tc, device=CPU))
    assert blobs == [flct_ref.encode_image(im, TILE, CPU) for im in imgs]
    outs = _replayed("decode", lambda: batch.decompress_tiled_batch(blobs, device=CPU))
    assert all(o.dtype == np.uint16 and np.array_equal(o, im) for o, im in zip(outs, imgs))


def test_a_mixed_size_group_takes_the_eager_chain(cpu_graphs):
    """Images of different sizes with the same 32x32 tiles are one geometry
    group of mixed shapes: no graph, the eager chain every call."""
    imgs = [_pool(2**31 + 26, (64, 64), 1)[0], _noise(96, 64, 7), _noise(64, 128, 8)]
    for _ in range(3):
        eager = dict(tiling.EAGER)
        replays = dict(graphs.REPLAYS)
        _round_trip(imgs)
        assert tiling.EAGER == {d: eager[d] + 1 for d in eager}
        assert graphs.REPLAYS == replays


# The harness's tiny run of each cell, in a fresh interpreter: its result
# lines, one a cell and trace setting, with the metrics each was to report.
TINY_RUNS = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from h100_bench import harness
tiny = harness.load_file(harness.BENCH_DIR / "tests" / "conftest.py").tiny
harness.WARM_BLOCK = 2
cpu = torch.device("cpu")
for name in sys.argv[2:]:
    for on in (False, True):
        cell = tiny(harness.load_cell(name))
        res, checks = harness.run_cell(cell, 2**31 + 27, 0.2, on, cpu, time.perf_counter())
        line = harness.report(cell, on, res, checks, cpu)
        want = [m["name"] for m in (cell.per_layer if on else cell.end_to_end)]
        print("RESULT " + json.dumps({"cell": name, "trace": on, "want": want,
                                      "line": line}, default=str), flush=True)
"""
# The per-layer metrics each cell reports.
PER_LAYER = {
    "enc": {"call_p95_ms.enc", "host_work_ms.enc", "graph_replay_share.enc",
            "chain_device_ms.enc", "k1_roofline", "device_idle_share.enc", "host_stage_ms.enc",
            "host_finish_ms.enc", "host_wait_ms.enc", "redo_share.enc"},
    "dec": {"host_work_ms.dec", "graph_replay_share.dec", "chain_device_ms.dec", "k2_roofline",
            "device_idle_share.dec", "host_stage_ms.dec", "host_finish_ms.dec",
            "host_wait_ms.dec"},
}
# Metrics a CPU run cannot read: device records, and waits on the device.
CPU_SILENT = ("chain_device_ms", "device_idle_share", "k1_roofline", "k2_roofline",
              "host_wait_ms")


@pytest.fixture(scope="module")
def tiny_runs():
    p = subprocess.run([sys.executable, "-c", TINY_RUNS, ROOT, *CELLS], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    runs = [json.loads(s[len("RESULT "):]) for s in p.stdout.splitlines()
            if s.startswith("RESULT ")]
    return {(r["cell"], r["trace"]): r for r in runs}


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_cpu_run_of_each_cell_is_correct_and_reports_its_metrics(tiny_runs, cell,
                                                                        trace):
    run = tiny_runs[(cell, trace)]
    line = run["line"]
    assert line["correct"] and line["failed"] == 0
    assert line["checks"]["bad_containers"]["value"] == 0
    if cell.endswith("serve-b4"):
        assert line["checks"]["bad_samples"]["value"] == 0
    got = set(line["metrics"])
    want = set(run["want"])
    d = "enc" if "ingest" in cell else "dec"
    if trace:
        assert want == PER_LAYER[d]
        assert got == {m for m in want if not m.startswith(CPU_SILENT)}
    else:
        assert want == got == {"setup_s", "encode_mpx_s" if d == "enc" else "decode_mpx_s"}
    assert all(v["value"] >= 0 for v in line["metrics"].values())
