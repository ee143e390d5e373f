"""Random geometry and cross-codec cases of tests/test_differential.py and
tests/test_more_coverage.py, held on the port with ``device="cpu"``.

* Six random FLCT geometries (image and tile dims, depth, color): the
  port's bytes equal felics_tpu's XLA engine's, and each side decodes the
  other's container exactly.
* FLCS on random crops: the device codec's bytes equal felics_tpu's oracle's
  and the port's oracle's; the port's oracle, the native codec and (on the
  small crops) the device decoder read the reference's container exactly.
* The coverage cases no other port test has: an rgb16 FLCT batch, native
  reading the port's FLCS and the port reading native's, a 100x3 image at
  tile 64, read_tiled_header of a 40x56 image at tile 16, probe on both
  containers, and ``__version__``.

Inputs are made with numpy from a seed; tolerance zero.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import felics_tpu
from felics_tpu import api as ref_api
from felics_tpu.config import TileConfig as RefTileConfig
from felics_tpu.parallel import tiling as ref_tiling
import felics_tpu_torch
from felics_tpu_torch import api, native
from felics_tpu_torch.config import TileConfig
from felics_tpu_torch.core import oracle
from felics_tpu_torch.format import header_for_array
from felics_tpu_torch.parallel import batch, flct, tiling

CPU = "cpu"
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def built_native():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, os.path.join(repo, "native", "build.py")], check=True)
    assert native.available()


def _img(rng, h, w, dtype, channels):
    shape = (h, w) if channels == 1 else (h, w, 3)
    step = 6 if np.dtype(dtype).itemsize == 1 else 700
    base = np.cumsum(
        np.cumsum(rng.integers(-step, step + 1, shape), 0), 1
    ).astype(np.int64)
    hi = np.iinfo(dtype).max
    return np.clip(base + hi // 2, 0, hi).astype(dtype)


def smooth(rng, w, h, dtype=np.uint8, channels=None):
    shape = (h, w) if channels is None else (h, w, channels)
    img = np.cumsum(np.cumsum(rng.integers(-6, 7, shape), 0), 1) + 128
    return np.clip(img, 0, np.iinfo(dtype).max).astype(dtype)


def _exact(out, img):
    assert out.dtype == img.dtype and out.shape == img.shape
    np.testing.assert_array_equal(out, img)


@pytest.mark.parametrize("seed", range(6))
def test_differential_flct_random_geometry(seed):
    import jax

    # Each geometry compiles fresh XLA programs on the reference side;
    # dropping them keeps a long worker from accumulating executables.
    jax.clear_caches()
    rng = np.random.default_rng(100 + seed)
    h, w = int(rng.integers(2, 90)), int(rng.integers(2, 90))
    th, tw = int(rng.integers(2, 33)), int(rng.integers(2, 33))
    dtype = [np.uint8, np.uint16][int(rng.integers(0, 2))]
    channels = [1, 3][int(rng.integers(0, 2))]
    img = _img(rng, h, w, dtype, channels)
    case = (h, w, th, tw, dtype.__name__, channels)
    ref = ref_tiling.compress_tiled_bytes(img, RefTileConfig(th, tw), engine="xla")
    port = tiling.compress_tiled_bytes(img, TileConfig(th, tw), device=CPU)
    assert port == ref, case
    _exact(ref_tiling.decompress_tiled_bytes(port, engine="xla"), img)
    _exact(tiling.decompress_tiled_bytes(ref, device=CPU), img)


@pytest.mark.parametrize("seed", range(5))
def test_differential_flcs_random_crops(seed, built_native):
    """A random crop of a random-walk image: device bytes == felics_tpu's
    oracle's == the port's oracle's; the reference's container decodes
    exactly on the port's oracle, on native and, for crops of at most 256
    pixels, on the device decoder."""
    rng = np.random.default_rng(200 + seed)
    dtype = [np.uint8, np.uint16][int(rng.integers(0, 2))]
    channels = [1, 3][int(rng.integers(0, 2))]
    big = _img(rng, 64, 64, dtype, channels)
    h, w = int(rng.integers(1, 40)), int(rng.integers(1, 40))
    y, x = int(rng.integers(0, 64 - h + 1)), int(rng.integers(0, 64 - w + 1))
    img = np.ascontiguousarray(big[y : y + h, x : x + w])
    hd = header_for_array(img)
    ref = ref_api.compress_image_bytes(img, backend="oracle")
    assert api.compress_image_bytes(img, device=CPU) == ref, img.shape
    assert oracle.compress_image_bytes(img, hd) == ref
    _exact(oracle.decompress_image_bytes(ref, hd), img)
    _exact(native.decompress(ref), img)
    if h * w <= 256:
        _exact(api.decompress_image_bytes(ref, device=CPU), img)


def test_rgb16_flct_batch_round_trip(rng, built_native):
    images = [smooth(rng, 40, 24, np.uint16, 3), smooth(rng, 16, 48, np.uint16, 3)]
    blobs = batch.compress_tiled_batch(images, TileConfig(tile_h=16, tile_w=16), device=CPU)
    for im, blob, out in zip(images, blobs, batch.decompress_tiled_batch(blobs, device=CPU)):
        assert blob == native.compress_tiled(im, header_for_array(im), 16, 16)
        _exact(out, im)


def test_port_flcs_reads_native(rng, built_native):
    img = smooth(rng, 24, 18, np.uint16, 3)
    data = native.compress(img, header_for_array(img))
    _exact(api.decompress_image_bytes(data, device=CPU), img)


def test_native_reads_port_flcs(rng, built_native):
    img = smooth(rng, 31, 17, np.uint8, 3)
    data = api.compress_image_bytes(img, device=CPU)
    _exact(native.decompress(data, header_for_array(img)), img)


def test_flct_extreme_tile_clamp(rng, built_native):
    # tile bigger than the image in one dim only
    img = smooth(rng, 100, 3, np.uint8)
    data = api.compress_image_bytes(img, container="flct", tile=TileConfig(64, 64), device=CPU)
    assert data == native.compress_tiled(img, header_for_array(img), 64, 64)
    assert (flct.read_tiled_header(data).tile_w, flct.read_tiled_header(data).tile_h) == (64, 3)
    _exact(api.decompress_image_bytes(data, device=CPU), img)


def test_flct_header_probe():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (40, 56)).astype(np.uint8)
    data = api.compress_image_bytes(img, container="flct", tile=TileConfig(16, 16), device=CPU)
    hdr = flct.read_tiled_header(data)
    assert (hdr.width, hdr.height, hdr.n_tiles) == (56, 40, 12)
    ref = ref_tiling.read_tiled_header(data)
    assert hdr.payload_off == ref.payload_off
    assert np.array_equal(hdr.tile_lengths, ref.tile_lengths)


def test_probe_both_containers(rng, built_native):
    img = smooth(rng, 24, 18, np.uint16, 3)
    flcs = native.compress(img, header_for_array(img))
    info = api.probe(flcs)
    assert info == {
        "container": "flcs", "color_type": "rgb", "pixel_depth": 16,
        "width": 24, "height": 18,
    }
    assert info == felics_tpu.probe(flcs)
    data = api.compress_image_bytes(img, container="flct", tile=TileConfig(16, 16), device=CPU)
    info = api.probe(data)
    assert info["container"] == "flct"
    assert (info["width"], info["height"], info["n_tiles"]) == (24, 18, 4)
    hdr = flct.read_tiled_header(data)
    assert info["payload_bytes"] == len(data) - hdr.payload_off
    assert info["payload_bytes"] == int(hdr.tile_lengths.sum())
    assert info == felics_tpu.probe(data)


def test_version_exported():
    assert isinstance(felics_tpu_torch.__version__, str) and felics_tpu_torch.__version__
    assert "__version__" in felics_tpu_torch.__all__
