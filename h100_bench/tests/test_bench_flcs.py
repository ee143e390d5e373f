"""FLCS in the benchmark: the plain reference (``reference/flcs_ref.py``)
byte for byte against the port's FLCS on the CPU, its header reader, the
two container modules against the references they read, and whole CPU
runs of an FLCS ingest and serve cell, built here and not in
BENCHMARK.json: the program comes out correct, its controls and a broken
timed path do not."""

import time
from dataclasses import replace

import numpy as np
import pytest
import torch

from h100_bench import check, harness
from h100_bench.reference import flcs_ref, flct_ref
from h100_bench.traffic import images

CPU = torch.device("cpu")
SHAPES = [(20, 24), (17, 9), (1, 7), (7, 1), (1, 1), (1, 2), (2, 1), (0, 5), (3, 0)]
KINDS = [(False, np.uint8), (False, np.uint16), (True, np.uint8), (True, np.uint16)]


def inputs(shape, rgb, dtype, seed):
    """A smooth and a noise image of ``shape`` (and three samples a pixel
    for rgb)."""
    rng = np.random.default_rng(seed)
    full = shape + ((3,) if rgb else ())
    mx = np.iinfo(dtype).max
    smooth = rng.integers(-3, 4, full).cumsum(axis=1)
    return [np.clip(smooth + mx // 2, 0, mx).astype(dtype),
            rng.integers(0, mx + 1, full).astype(dtype)]


def port(ims):
    from felics_tpu_torch import compress_images_bytes

    return compress_images_bytes(ims, container="flcs", device="cpu")


@pytest.mark.parametrize("rgb,dtype", KINDS, ids=["gray8", "gray16", "rgb8", "rgb16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_reference_equals_the_port(shape, rgb, dtype):
    ims = inputs(shape, rgb, dtype, sum(shape) + 5 * rgb + (dtype == np.uint16))
    assert flcs_ref.encode_images(ims, CPU) == port(ims)


def smooth_noise(shape, level, std, dtype, seed=5):
    rng = np.random.default_rng(seed)
    mx = np.iinfo(dtype).max
    return np.clip(level + rng.normal(0, std, shape), 0, mx).astype(dtype)


@pytest.mark.parametrize("im", [
    smooth_noise((96, 96), 128, 2, np.uint8),
    smooth_noise((64, 64, 3), 30000, 3, np.uint16),
    smooth_noise((64, 80), 30000, 5, np.uint16),
], ids=["gray8", "rgb16", "gray16"])
def test_halved_tables_equal_the_port(im):
    """Flat images with small noise pile out-of-range samples into a few
    contexts, whose rows then pass COUNT_SCALING and are halved."""
    ims = [im, im[::-1].copy()]
    blobs, halvings = flcs_ref.encode_group(ims, CPU)
    assert halvings > 0
    assert blobs == port(ims)


def test_the_control_skips_the_halving_and_still_reads_back():
    from felics_tpu_torch.config import CONFIG_8BIT
    from felics_tpu_torch.core import codec

    (im,) = images.make_pool(2**31 + 1, [(96, 96)], [1], False, 8, CPU)
    (want,) = flcs_ref.encode_images([im], CPU)
    (got,) = flcs_ref.encode_images([im], CPU, count_scaling=None)
    assert got != want
    words = torch.from_numpy(codec.payload_words([got[flcs_ref.HEADER_SIZE:]]).view(np.int32))
    planes, _end, overrun = codec.decode_scan_scalar(
        words, 96, 96, replace(CONFIG_8BIT, count_scaling=None), 1)
    assert not bool(overrun[0]) and np.array_equal(planes[0, 0].numpy().reshape(96, 96), im)


@pytest.mark.parametrize("shape,rgb,dtype", [
    ((20, 30), False, np.uint8), ((5, 7), True, np.uint16), ((0, 4), True, np.uint8),
    ((1, 1), False, np.uint16),
])
def test_header_reader_round_trips(shape, rgb, dtype):
    (im,) = inputs(shape, rgb, dtype, 3)[:1]
    blob = flcs_ref.encode_images([im], CPU)[0]
    hd = flcs_ref.read_header(blob)
    assert (hd.height, hd.width, hd.channels, hd.depth) == (
        shape[0], shape[1], 3 if rgb else 1, 16 if dtype == np.uint16 else 8)
    assert hd.payload_bytes == len(blob) - flcs_ref.HEADER_SIZE > 0
    assert flcs_ref.header(im) == blob[:flcs_ref.HEADER_SIZE]
    with pytest.raises(ValueError):
        flcs_ref.read_header(b"FLCT" + blob[4:])
    with pytest.raises(ValueError):
        flcs_ref.read_header(blob[:10])


@pytest.mark.parametrize("rgb,depth", [(False, 8), (True, 8), (False, 16)])
def test_the_flct_module_reads_as_flct_ref(rgb, depth):
    flct = harness.load_container({})  # a configuration without the key is FLCT
    config = {"container": "flct", "tile": [8, 16]}
    pool = images.make_pool(2**31 + 61, [(24, 40), (9, 13)], [3, 2], rgb, depth, CPU)
    blobs = [flct_ref.encode_image(im, (8, 16), CPU) for im in pool]
    assert flct.reference(pool, config, CPU)([4, 0, 2]) == [blobs[4], blobs[0], blobs[2]]
    assert [flct.payload_bytes(b) for b in blobs] == [
        flct_ref.read_container(b).payload_bytes for b in blobs]
    assert flct.groups(pool, config) == len(
        {(flct_ref.tile_dims(*im.shape[:2], (8, 16)), im.ndim, im.dtype.str) for im in pool})
    assert flct.groups(pool, config) == 2 and flct.groups(pool[:3], config) == 1
    assert flct.KERNELS == {"encode": "flct_encode_kernel", "decode": "flct_decode_kernel"}
    from felics_tpu_torch.ops import tile_codec

    assert (flct.launches("encode"), flct.launches("decode")) == (
        tile_codec.ENCODE_LAUNCHES, tile_codec.DECODE_LAUNCHES)


def test_the_flcs_module():
    flcs = harness.load_container({"container": "flcs"})
    pool = images.make_pool(2**31 + 67, [(12, 16), (12, 16), (1, 1)], [2, 1, 1], False, 8, CPU)
    pool[2] = pool[2].T.copy()  # (16, 12): another shape
    blobs = flcs_ref.encode_images(pool, CPU)
    assert flcs.reference(pool, {}, CPU)([3, 1, 0]) == [blobs[3], blobs[1], blobs[0]]
    assert [flcs.payload_bytes(b) for b in blobs] == [len(b) - 14 for b in blobs]
    assert flcs.groups(pool, {}) == 2 and flcs.groups(pool[3:], {}) == 0
    assert flcs.KERNELS == {"encode": "flcs_kscan_kernel", "decode": "flcs_decode_kernel"}
    from felics_tpu_torch.core import codec
    from felics_tpu_torch.ops import kscan

    assert (flcs.launches("encode"), flcs.launches("decode")) == (kscan.LAUNCHES,
                                                                  codec.DECODE_LAUNCHES)


# FLCS cells built here, at tiny sizes: the CPU's k scan walks ranks and
# its decode pixels, one step at a time.
CONFIG = {"name": "flcs-gray8", "container": "flcs", "color": "gray", "depth": 8}
MIXES = {
    "ingest": {"driver": "compress_images_bytes", "sizes": [[20, 24]], "counts": [4],
               "batch": 2, "sample_calls": 2, "trace_calls": 1},
    "serve": {"driver": "decompress_images_bytes", "sizes": [[6, 8]], "counts": [4],
              "batch": 2, "sample_calls": 2, "trace_calls": 1},
}


def flcs_cell(kind, rgb=False, size=None):
    config = dict(CONFIG, color="rgb" if rgb else "gray")
    mix = dict(MIXES[kind], sizes=[size]) if size else dict(MIXES[kind])
    return harness.Cell(f"flcs.{kind}", 1, config, mix, [], [])


def run(cell, cpu, substitute=None, trace_on=False):
    res, checks = harness.run_cell(cell, 2**31 + 71, 0.2, trace_on, cpu, time.perf_counter(),
                                   substitute=substitute)
    return harness.report(cell, trace_on, res, checks, cpu), checks, res


@pytest.mark.parametrize("kind,rgb,trace_on", [
    ("ingest", False, False), ("ingest", False, True), ("ingest", True, False),
    ("serve", False, False), ("serve", False, True), ("serve", True, False),
], ids=["ingest", "ingest-traced", "ingest-rgb", "serve", "serve-traced", "serve-rgb"])
def test_an_flcs_cell_runs_correct(kind, rgb, trace_on, cpu):
    cell = flcs_cell(kind, rgb)
    line, checks, res = run(cell, cpu, trace_on=trace_on)
    assert line["correct"] and line["failed"] == 0 and check.correct(checks)
    r = res["run"]
    assert checks["images_compared"]["value"] == 2 * min(r.calls, 2)
    assert all(c["value"] == 0 for c in checks.values() if c["limit"] is not None)
    assert r.groups == r.calls and r.replays == 0
    if trace_on:
        kernel = "flcs_kscan_kernel" if kind == "ingest" else "flcs_decode_kernel"
        assert r.window is not None and r.window.kernel == kernel
        assert r.trace_least_s > 0


@pytest.mark.parametrize("kind", ["ingest", "serve"])
def test_the_flcs_controls_are_not_correct(kind, cpu):
    """Ingest at 96 x 96, where the halving decides some of the bytes."""
    cell = flcs_cell(kind, size=[96, 96] if kind == "ingest" else None)
    direction = "encode" if kind == "ingest" else "decode"
    control = harness.load_container(cell.config).control(direction, cell.config, cpu)
    line, checks, _ = run(cell, cpu, control)
    assert not line["correct"]
    key = "bad_containers" if kind == "ingest" else "bad_samples"
    assert checks[key]["value"] > checks[key]["limit"]


def flip_a_payload_byte(monkeypatch):
    from felics_tpu_torch.core import codec

    real = codec._encode_group
    monkeypatch.setattr(codec, "_encode_group", lambda *a: [
        p[:-1] + bytes([p[-1] ^ 1]) for p in real(*a)])


def alter_a_pixel(monkeypatch):
    from felics_tpu_torch.core import codec

    real = codec._decode_group

    def altered(members, device):
        out = real(members, device)
        for im in out:
            im.reshape(-1)[0] ^= 1
        return out
    monkeypatch.setattr(codec, "_decode_group", altered)


@pytest.mark.parametrize("kind,fault", [("ingest", flip_a_payload_byte),
                                        ("serve", alter_a_pixel)])
def test_a_broken_flcs_path_is_not_correct(kind, fault, cpu, monkeypatch):
    fault(monkeypatch)
    line, checks, _ = run(flcs_cell(kind), cpu)
    key = "bad_containers" if kind == "ingest" else "bad_samples"
    assert not line["correct"] and checks[key]["value"] > 0
