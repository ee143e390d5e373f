"""Corrupt-input regressions of tests/test_robustness.py, held on the port's
entry points with ``device="cpu"``.

Each case keeps the reference's wall-clock guard (``_Alarm``): a decoder
that hangs on corrupt input fails its test, not the suite. Every corrupt
input must raise a ``felics_tpu_torch.errors.DecompressionError`` or
decode to an image of the right shape and dtype. Where felics_tpu raises a
named class on the same bytes (its JAX scan decoder for FLCS, its header
checks for FLCT), the port raises the class of the same name, and where
the JAX scan decoder returns an image the port returns the same pixels.
Each FLCT header forgery also goes through
``decompress_tiled_batch(on_error="isolate")`` beside a good member: the
bad member comes back as its error, the good one as its image.
"""

import signal

import numpy as np
import pytest
import torch

from felics_tpu import api as ref_api
from felics_tpu import errors as ref_errors
from felics_tpu_torch import api, errors
from felics_tpu_torch.config import TileConfig
from felics_tpu_torch.parallel import batch, tiling

CPU = "cpu"
torch.set_num_threads(1)


class _Alarm:
    """Hard wall-clock guard: these are anti-hang regressions, so a hang
    must fail the test rather than the whole suite."""

    def __init__(self, seconds: int):
        self.seconds = seconds

    def __enter__(self):
        def handler(signum, frame):
            raise TimeoutError("decoder hung on corrupt input")

        self._old = signal.signal(signal.SIGALRM, handler)
        signal.alarm(self.seconds)

    def __exit__(self, *exc):
        signal.alarm(0)
        signal.signal(signal.SIGALRM, self._old)


def _smooth(rng, w, h, dtype=np.uint8):
    img = np.cumsum(np.cumsum(rng.integers(-6, 7, (h, w)), 0), 1) + 128
    return np.clip(img, 0, np.iinfo(dtype).max).astype(dtype)


def _patch(data: bytes, off: int, value: bytes) -> bytes:
    return data[:off] + value + data[off + len(value) :]


def _outcome(decode, errors_module):
    """The decoded image, or the name of the DecompressionError raised."""
    try:
        return decode()
    except errors_module.DecompressionError as e:
        return type(e).__name__


def _same_outcome(got, want, shape, dtype):
    if isinstance(want, str) or isinstance(got, str):
        assert got == want
    else:
        assert got.shape == shape and got.dtype == dtype
        np.testing.assert_array_equal(got, want)


def _flcs_like_jax(data: bytes, shape, dtype) -> str:
    """Decode on the port and on felics_tpu's JAX scan decoder; the
    outcomes must be the same. Returns the port's outcome."""
    with _Alarm(120):
        got = _outcome(lambda: api.decompress_image_bytes(data, device=CPU), errors)
    want = _outcome(lambda: ref_api.decompress_image_bytes(data, backend="jax"), ref_errors)
    _same_outcome(got, want, shape, dtype)
    return got


def test_flcs_all_ones_tail_raises_not_hangs(rng):
    # A truncated stream whose tail is 0xFF bytes: a unary run that never
    # ends must raise within seconds.
    img = _smooth(rng, 64, 64)
    data = api.compress_image_bytes(img, backend="oracle")
    corrupt = data[: max(14, len(data) // 2)] + b"\xff" * 4
    assert isinstance(_flcs_like_jax(corrupt, img.shape, img.dtype), str)


def test_flcs_truncated_payload_raises(rng):
    img = _smooth(rng, 48, 32)
    data = api.compress_image_bytes(img, backend="oracle")
    assert isinstance(_flcs_like_jax(data[: 14 + 8], img.shape, img.dtype), str)


def _flct_blob(rng):
    img = _smooth(rng, 48, 40)
    return img, api.compress_image_bytes(
        img, container="flct", tile=TileConfig(16, 16), device=CPU)


def _forgery_raises(rng, off: int, value: bytes) -> None:
    """A forged FLCT header field raises felics_tpu's class on the per-image
    call; in an isolating batch it is that member's error and the good
    member decodes."""
    img, data = _flct_blob(rng)
    corrupt = _patch(data, off, value)
    with _Alarm(120):
        with pytest.raises(errors.DecompressionError) as got:
            api.decompress_image_bytes(corrupt, device=CPU)
        out = batch.decompress_tiled_batch([corrupt, data], device=CPU, on_error="isolate")
    with pytest.raises(ref_errors.DecompressionError) as want:
        ref_api.decompress_image_bytes(corrupt)
    assert type(got.value).__name__ == type(want.value).__name__
    assert isinstance(out[0], errors.DecompressionError)
    assert type(out[0]).__name__ == type(want.value).__name__
    assert out[1].dtype == img.dtype
    np.testing.assert_array_equal(out[1], img)


def test_flct_zeroed_tile_h_raises(rng):
    _forgery_raises(rng, 16, b"\x00\x00")  # tile_h u16 at offset 16


def test_flct_zeroed_tile_w_raises(rng):
    _forgery_raises(rng, 14, b"\x00\x00")  # tile_w u16 at offset 14


def test_flct_tile_dims_one_rejected(rng):
    # Encoders never emit tile dims < 2; a forged 1 must be rejected, not
    # mis-decoded.
    _forgery_raises(rng, 16, b"\x00\x01")


def test_flct_grid_mismatch_raises(rng):
    _forgery_raises(rng, 20, b"\x00\x00\x00\x07")  # n_tiles: 6 -> 7


def test_flct_batch_header_corruption_raises(rng):
    img, data = _flct_blob(rng)
    corrupt = _patch(data, 16, b"\x00\x00")
    with _Alarm(120):
        with pytest.raises(errors.DecompressionError):
            batch.decompress_tiled_batch([data, corrupt], device=CPU)
        out = batch.decompress_tiled_batch([data, corrupt], device=CPU, on_error="isolate")
    np.testing.assert_array_equal(out[0], img)
    assert isinstance(out[1], errors.InvalidDimensions)


def test_flcs_random_corruption_sweep(rng):
    """Random single-bit flips of an FLCS payload through the device decoder
    on the CPU: each ends in a DecompressionError or a decode, the same one
    felics_tpu's JAX scan decoder gives."""
    img = _smooth(rng, 48, 32)
    data = api.compress_image_bytes(img, backend="oracle")
    for _ in range(12):
        pos = int(rng.integers(14, len(data)))
        bad = _patch(data, pos, bytes([data[pos] ^ (1 << int(rng.integers(0, 8)))]))
        _flcs_like_jax(bad, img.shape, img.dtype)


@pytest.mark.parametrize("entry", ["per_image", "isolated_batch"])
def test_flct_random_corruption_sweep(rng, entry):
    """Every random single-byte flip of an FLCT container either raises a
    DecompressionError or decodes to an image of the right shape (a flip in
    dead padding may decode exactly), through the per-image call and
    through an isolating batch, where a good member beside it stays
    exact."""
    img = _smooth(rng, 64, 48)
    data = tiling.compress_tiled_bytes(img, TileConfig(16, 16), device=CPU)
    good = _smooth(rng, 20, 20)
    good_blob = tiling.compress_tiled_bytes(good, TileConfig(16, 16), device=CPU)
    with _Alarm(300):
        for _ in range(20):
            pos = int(rng.integers(0, len(data)))
            bad = _patch(data, pos, bytes([data[pos] ^ (1 << int(rng.integers(0, 8)))]))
            if entry == "per_image":
                out = _outcome(lambda: tiling.decompress_tiled_bytes(bad, device=CPU), errors)
            else:
                out, kept = batch.decompress_tiled_batch(
                    [bad, good_blob], device=CPU, on_error="isolate")
                np.testing.assert_array_equal(kept, good)
                if isinstance(out, errors.DecompressionError):
                    out = type(out).__name__
            if not isinstance(out, str):
                assert out.shape == img.shape and out.dtype == img.dtype
