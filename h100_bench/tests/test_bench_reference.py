"""The plain reference against the code under test's containers on the
CPU, and the controls against the reference."""

import numpy as np
import pytest
import torch

from h100_bench.reference import controls, flct_ref
from h100_bench.traffic import images

CASES = [
    ((20, 24), np.uint8, (8, 8)), ((17, 9, 3), np.uint8, (4, 3)),
    ((12, 13), np.uint16, (8, 4)), ((9, 21, 3), np.uint16, (4, 8)),
    ((33, 40), np.uint8, (64, 64)), ((2, 2), np.uint8, (2, 2)), ((3, 50), np.uint8, (4, 4)),
]


def inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    mx = np.iinfo(dtype).max
    smooth = np.clip(rng.integers(-3, 4, shape).cumsum(axis=1) + mx // 2, 0, mx).astype(dtype)
    return [smooth, rng.integers(0, mx + 1, shape).astype(dtype)]


@pytest.mark.parametrize("shape,dtype,tile", CASES)
def test_reference_equals_the_port(shape, dtype, tile):
    from felics_tpu_torch import compress_tiled_batch
    from felics_tpu_torch.config import TileConfig

    ims = inputs(shape, dtype, sum(shape))
    want = compress_tiled_batch(ims, TileConfig(*tile), device="cpu")
    assert [flct_ref.encode_image(im, tile, "cpu") for im in ims] == want


@pytest.mark.parametrize("rgb", [False, True])
def test_reference_equals_the_port_on_generated_images(rgb):
    from felics_tpu_torch import compress_tiled_batch, decompress_tiled_batch
    from felics_tpu_torch.config import TileConfig

    ims = images.make_pool(3, [(24, 40)], [2], rgb, 8, "cpu")
    want = compress_tiled_batch(ims, TileConfig(8, 16), device="cpu")
    assert [flct_ref.encode_image(im, (8, 16), "cpu") for im in ims] == want
    outs = decompress_tiled_batch(want, device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(outs, ims))


def test_container_facts():
    (im,) = images.make_pool(4, [(20, 30)], [1], True, 8, "cpu")
    blob = flct_ref.encode_image(im, (8, 8), "cpu")
    t = flct_ref.read_container(blob)
    assert (t.width, t.height, t.channels, t.depth, t.tile_w, t.tile_h) == (30, 20, 3, 8, 8, 8)
    assert len(t.tile_lengths) == 3 * 4
    assert t.payload_bytes == len(blob) - (24 + 9 + 2 * 12)


def test_bit_length_is_exact():
    x = torch.tensor([0, 1, 2, 3, 4, 255, 256, (1 << 33) - 1, 1 << 33])
    assert flct_ref.bit_length(x).tolist() == [int(v).bit_length() for v in x.tolist()]


def test_controls_differ_from_the_reference():
    from felics_tpu_torch.config import TileConfig
    from felics_tpu_torch.parallel.tiling import compress_tiled_bytes

    ims = images.make_pool(6, [(32, 32)], [3], False, 8, "cpu")
    ref = [flct_ref.encode_image(im, (8, 8), "cpu") for im in ims]
    v0 = controls.v0_encode(ims, (8, 8), "cpu")
    assert all(a != b for a, b in zip(v0, ref))
    # the reference's v0 is the port's own path without the k-prior
    assert v0 == [compress_tiled_bytes(im, TileConfig(8, 8), k_prior=False, device="cpu")
                  for im in ims]
    lossy = controls.lossy_decode(ims)
    assert all(np.count_nonzero(a != b) > 0 for a, b in zip(lossy, ims))
