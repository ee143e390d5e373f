"""Every image shape 0..20 x 0..20 through the port, held against the native
C++ codec and the port's scalar oracle: the counterpart of
tests/test_dims_sweep.py for felics_tpu_torch, on the CPU.

Per dtype {u8, u16} x color {gray, rgb} x container:

* flcs: over the whole grid, the oracle (core/oracle.py) and ``native``
  write the same bytes and each decodes the other's container exactly, in
  the image's dtype; on the spanning subset SUBSET x SUBSET (the
  reference's ``JAX_DIMS``) the device codec on ``device="cpu"`` writes the
  oracle's bytes, and the batched decode of those containers is exact;
* flct at tile 4x3 on ``device="cpu"``: the batched pair over the whole
  grid (one launch per tile geometry) and the per-image pair over the
  subset: bytes equal to ``native.compress_tiled``, exact round trips, and
  each side decoding the other's container.

The one place native and the port differ is the header-only FLCT container
of a zero-area image: native clamps its tile fields to the image, felics_tpu
writes max(2, tile) and the port writes felics_tpu's bytes, which the test
checks against felics_tpu itself. Images are random, made with numpy from a
seed; tolerance zero.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from felics_tpu.config import TileConfig as RefTileConfig
from felics_tpu.parallel import tiling as ref_tiling
from felics_tpu_torch import api, native
from felics_tpu_torch.config import TileConfig
from felics_tpu_torch.core import oracle
from felics_tpu_torch.format import header_for_array
from felics_tpu_torch.parallel import batch, tiling

CPU = "cpu"
torch.set_num_threads(1)
SIDES = range(21)
SUBSET = {0, 1, 2, 3, 5, 12, 20}
TILE = TileConfig(tile_h=4, tile_w=3)


@pytest.fixture(scope="module", autouse=True)
def built_native():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, os.path.join(repo, "native", "build.py")], check=True)
    assert native.available()


def _grid(dtype, channels, seed):
    rng = np.random.default_rng(seed)
    hi = np.iinfo(dtype).max + 1
    return [
        rng.integers(0, hi, (h, w) if channels is None else (h, w, channels)).astype(dtype)
        for w in SIDES for h in SIDES
    ]


def _in_subset(img):
    return img.shape[0] in SUBSET and img.shape[1] in SUBSET


def _exact(out, img, what):
    assert out.dtype == img.dtype and out.shape == img.shape, what
    np.testing.assert_array_equal(out, img, err_msg=str(what))


def _flcs(images):
    for img in images:
        hd = header_for_array(img)
        ora, nat = oracle.compress_image_bytes(img, hd), native.compress(img, hd)
        assert ora == nat, (img.dtype, img.shape)
        _exact(native.decompress(ora), img, ("native of oracle", img.shape))
        _exact(oracle.decompress_image_bytes(nat, hd), img, ("oracle of native", img.shape))
    subset = [img for img in images if _in_subset(img)]
    blobs = [api.compress_image_bytes(img, device=CPU) for img in subset]
    for img, blob in zip(subset, blobs):
        assert blob == oracle.compress_image_bytes(img, header_for_array(img)), img.shape
    for img, out in zip(subset, api.decompress_images_bytes(blobs, device=CPU)):
        _exact(out, img, ("device round trip", img.shape))


def _native_tiled(img):
    """native's FLCT container, or felics_tpu's for a zero-area image."""
    if img.size == 0:
        return ref_tiling.compress_tiled_bytes(img, RefTileConfig(TILE.tile_h, TILE.tile_w))
    return native.compress_tiled(img, header_for_array(img), TILE.tile_w, TILE.tile_h)


def _flct(images):
    blobs = batch.compress_tiled_batch(images, TILE, device=CPU)
    outs = batch.decompress_tiled_batch(blobs, device=CPU)
    natives = [native.compress_tiled(img, header_for_array(img), TILE.tile_w, TILE.tile_h)
               for img in images]
    from_native = batch.decompress_tiled_batch(natives, device=CPU)
    for img, blob, out, back in zip(images, blobs, outs, from_native):
        assert blob == _native_tiled(img), (img.dtype, img.shape)
        _exact(out, img, ("batched round trip", img.shape))
        _exact(back, img, ("port of native", img.shape))
        _exact(native.decompress_tiled(blob), img, ("native of port", img.shape))
    for img, blob in zip(images, blobs):
        if _in_subset(img):
            one = tiling.compress_tiled_bytes(img, TILE, device=CPU)
            assert one == blob, ("per-image bytes", img.shape)
            _exact(tiling.decompress_tiled_bytes(one, device=CPU), img,
                   ("per-image round trip", img.shape))


@pytest.mark.parametrize("container", ["flcs", "flct"])
@pytest.mark.parametrize("channels", [None, 3], ids=["gray", "rgb"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16], ids=["u8", "u16"])
def test_dims_sweep(dtype, channels, container):
    seed = (np.dtype(dtype).itemsize, channels or 1, int(container == "flct"))
    images = _grid(dtype, channels, seed)
    assert len(images) == 441
    if container == "flcs":
        _flcs(images)
    else:
        _flct(images)
