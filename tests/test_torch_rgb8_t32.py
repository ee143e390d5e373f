"""FLCT rgb8 at 32x32 tiles, the benchmark's colour archive, on the CPU:
the port's batched encode against the plain reference that the benchmark
holds it to (``h100_bench/reference/flct_ref.py``: YCoCg-R with
truncating halvings, signed chroma planes with ``depth + 1`` raw bits, a
three-plane k0 prior), byte for byte, and the batched decode back to every
image exactly."""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from felics_tpu_torch.config import TileConfig  # noqa: E402
from felics_tpu_torch.core.color import rgb_to_ycocg  # noqa: E402
from felics_tpu_torch.parallel import batch  # noqa: E402
from h100_bench.reference import flct_ref  # noqa: E402
from h100_bench.traffic import images as traffic  # noqa: E402

CPU = torch.device("cpu")
TILE = (32, 32)
# every primary and secondary at full scale, black, white and greys
PALETTE = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255], [255, 255, 0], [0, 255, 255],
                    [255, 0, 255], [0, 0, 0], [255, 255, 255], [128, 128, 128],
                    [1, 1, 1], [254, 254, 254]], dtype=np.uint8)


def _noise(h, w, seed):
    return [np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)]


def _saturated():
    """4x4 blocks of the palette, seeded, so that Co and Cg reach -255
    and +255 and the chroma planes' raw preambles use their ninth bit."""
    idx = np.random.default_rng(18).integers(0, len(PALETTE), (12, 14))
    return [PALETTE[np.kron(idx, np.ones((4, 4), dtype=np.int64))]]


CASES = {
    "whole-tiles-64x96": lambda: _noise(64, 96, 1),
    "clamped-edges-70x45": lambda: _noise(70, 45, 2),
    "saturated-primaries-and-greys": _saturated,
    "traffic-pool-of-three": lambda: traffic.make_pool(2**31 + 18, [(64, 64)], [3], True, 8,
                                                       "cpu"),
}


@pytest.mark.parametrize("case", CASES)
def test_rgb8_t32_batch_equals_reference_and_round_trips(case):
    imgs = CASES[case]()
    if case.startswith("saturated"):
        _, co, cg = rgb_to_ycocg(*(imgs[0][..., c] for c in range(3)))
        assert {co.min(), co.max(), cg.min(), cg.max()} == {-255, 255}
    blobs = batch.compress_tiled_batch(imgs, TileConfig(*TILE), device=CPU)
    assert len(blobs) == len(imgs)
    for im, blob in zip(imgs, blobs):
        assert blob == flct_ref.encode_image(im, TILE, CPU)
        hd = flct_ref.read_container(blob)
        assert (hd.channels, hd.depth) == (3, 8)
    for im, out in zip(imgs, batch.decompress_tiled_batch(blobs, device=CPU)):
        assert out.dtype == np.uint8 and np.array_equal(out, im)


@pytest.mark.parametrize("depth", [8, 16])
def test_planar_rgb_gives_the_interleaved_containers(depth):
    """Images whose samples lie plane after plane in memory (an (H, W, 3)
    view of (3, H, W) data, as ``traffic/images.py`` gives them) encode to
    the containers of the same images laid out interleaved."""
    pool = traffic.make_pool(2**31 + 19, [(48, 40)], [2], True, depth, "cpu")
    assert not any(im.flags.c_contiguous for im in pool)
    interleaved = [np.ascontiguousarray(im) for im in pool]
    tc = TileConfig(*TILE)
    blobs = batch.compress_tiled_batch(pool, tc, device=CPU)
    assert blobs == batch.compress_tiled_batch(interleaved, tc, device=CPU)
    assert blobs == [flct_ref.encode_image(im, TILE, CPU) for im in pool]
