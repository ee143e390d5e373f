"""The port's batched FLCT pair (felics_tpu_torch.parallel.batch) against
per-image containers of the JAX reference's XLA engine, on the CPU with the
plain PyTorch versions of the kernels. Tolerance zero.
"""

import numpy as np
import pytest
import torch

from felics_tpu.config import TileConfig
from felics_tpu.parallel import batch as ref_batch
from felics_tpu.parallel import tiling as ref
from felics_tpu_torch import (
    compress_tiled_batch,
    compress_tiled_bytes,
    decompress_tiled_batch,
    errors,
)
from felics_tpu_torch.parallel import flct

TC = TileConfig(8, 8)
# The plain versions run many tiny ops: intra-op threads only contend with
# the other test workers.
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the FLCT kernels have no CPU mode")
    return torch.device("cuda")


def _image(shape, depth_max, seed, smooth=True):
    rng = np.random.default_rng(seed)
    dt = np.uint8 if depth_max == 255 else np.uint16
    if smooth:
        base = rng.integers(-3, 4, shape).cumsum(axis=1) + depth_max // 2
        return np.clip(base, 0, depth_max).astype(dt)
    return rng.integers(0, depth_max + 1, shape).astype(dt)


def _mixed():
    """Four geometries: two gray8 sizes sharing a tile, a gray8 image that
    clamps the tile to 5x8, and an rgb8 image."""
    return [
        _image((24, 24), 255, 1),
        _image((17, 24), 255, 2, smooth=False),
        _image((5, 19), 255, 3),
        _image((16, 16, 3), 255, 4),
    ]


def test_batch_matches_per_image_reference():
    images = _mixed()
    blobs = compress_tiled_batch(images, TC, device="cpu")
    for im, blob in zip(images, blobs):
        assert blob == ref.compress_tiled_bytes(im, TC, engine="xla")
    outs = decompress_tiled_batch(blobs, device="cpu")
    for im, out in zip(images, outs):
        assert out.dtype == im.dtype and np.array_equal(out, im)
    for im, out in zip(images, ref_batch.decompress_tiled_batch(blobs, engine="xla")):
        assert np.array_equal(out, im)


def test_batch_decodes_reference_batch():
    images = [_image((24, 24), 255, 5), _image((16, 24), 255, 6, smooth=False)]
    blobs = ref_batch.compress_tiled_batch(images, TC, engine="xla")
    assert compress_tiled_batch(images, TC, device="cpu") == blobs
    for im, out in zip(images, decompress_tiled_batch(blobs, device="cpu")):
        assert np.array_equal(out, im)


def test_gray16_batch_equals_per_image():
    images = [_image((16, 16), 65535, 7), _image((16, 16), 65535, 8, smooth=False)]
    blobs = compress_tiled_batch(images, TC, device="cpu")
    assert blobs == [compress_tiled_bytes(im, TC, device="cpu") for im in images]
    for im, out in zip(images, decompress_tiled_batch(blobs, device="cpu")):
        assert out.dtype == np.uint16 and np.array_equal(out, im)


def test_empty_members_and_batches():
    assert compress_tiled_batch([], TC, device="cpu") == []
    assert decompress_tiled_batch([], device="cpu") == []
    images = [np.zeros((0, 4), np.uint8), _image((8, 8), 255, 9)]
    blobs = compress_tiled_batch(images, TC, device="cpu")
    outs = decompress_tiled_batch(blobs, device="cpu")
    assert outs[0].shape == (0, 4) and np.array_equal(outs[1], images[1])


def test_corrupt_member_raises_or_keeps_shapes():
    images = _mixed()[:2]
    blobs = compress_tiled_batch(images, TC, device="cpu")
    hd = flct.read_tiled_header(blobs[1])
    rng = np.random.default_rng(10)
    for pos in rng.integers(hd.payload_off, len(blobs[1]), 8):
        data = bytearray(blobs[1])
        data[pos] ^= 0xFF
        try:
            outs = decompress_tiled_batch([blobs[0], bytes(data)], device="cpu")
        except errors.DecompressionError:
            continue
        assert [o.shape for o in outs] == [im.shape for im in images]
        assert np.array_equal(outs[0], images[0])


def test_truncated_member_raises_io_error():
    images = _mixed()[:2]
    blobs = compress_tiled_batch(images, TC, device="cpu")
    with pytest.raises(errors.IoError):
        decompress_tiled_batch([blobs[0], blobs[1][:-3]], device="cpu")


@pytest.mark.cuda
def test_cuda_batch_matches_cpu(cuda):
    images = _mixed()
    blobs = compress_tiled_batch(images, TC, device=cuda)
    assert blobs == compress_tiled_batch(images, TC, device="cpu")
    for im, out in zip(images, decompress_tiled_batch(blobs, device=cuda)):
        assert np.array_equal(out, im)
