"""The port's per-image FLCT entry points (felics_tpu_torch.parallel.tiling)
against the JAX reference's XLA engine, on the CPU with the plain PyTorch
versions of the kernels. Tolerance zero: container bytes and pixels must be
identical.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from felics_tpu.config import TileConfig, tiled_config_for_depth
from felics_tpu.format import ColorType, PixelDepth
from felics_tpu.parallel import tiling as ref
from felics_tpu_torch import compress_tiled_bytes, decompress_tiled_bytes, errors
from felics_tpu_torch.device import to_host, upload_image
from felics_tpu_torch.format import header_for_array
from felics_tpu_torch.ops import tile_codec as tcd
from felics_tpu_torch.parallel import flct, tiling

CPU = torch.device("cpu")
# The plain versions run many tiny ops: intra-op threads only contend with
# the other test workers.
torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


# tests/test_pallas_codec.py CASES: gray8, gray16, odd tiles, rgb8, rgb16.
CASES = [
    ((24, 24), 255, (8, 8), True),
    ((16, 16), 255, (4, 4), False),
    ((16, 24), 65535, (8, 8), True),
    ((13, 9), 255, (5, 3), False),
    ((16, 16, 3), 255, (8, 8), True),
    ((8, 8, 3), 65535, (4, 4), False),
]


@pytest.mark.parametrize("k_prior", [True, False], ids=["v2", "v0"])
@pytest.mark.parametrize("shape,depth_max,tile,smooth", CASES)
def test_container_matches_reference(shape, depth_max, tile, smooth, k_prior):
    img = _image(shape, depth_max, sum(shape) + depth_max, smooth)
    tc = TileConfig(tile_h=tile[0], tile_w=tile[1])
    mine = compress_tiled_bytes(img, tc, k_prior=k_prior, device="cpu")
    theirs = ref.compress_tiled_bytes(img, tc, engine="xla", k_prior=k_prior)
    assert mine == theirs
    out = decompress_tiled_bytes(theirs, device="cpu")
    assert out.dtype == img.dtype and np.array_equal(out, img)


@pytest.mark.parametrize("shape,depth_max,tile,smooth", CASES)
def test_reference_decodes_port_containers(shape, depth_max, tile, smooth):
    img = _image(shape, depth_max, 11, smooth)
    tc = TileConfig(tile_h=tile[0], tile_w=tile[1])
    blob = compress_tiled_bytes(img, tc, device="cpu")
    assert np.array_equal(ref.decompress_tiled_bytes(blob, engine="xla"), img)


@pytest.mark.parametrize(
    "shape,tile", [((1, 7), (4, 4)), ((5, 3), (16, 16)), ((2, 2, 3), (8, 8))]
)
def test_tiles_clamped_to_small_images(shape, tile):
    img = _image(shape, 255, 4, False)
    tc = TileConfig(*tile)
    blob = compress_tiled_bytes(img, tc, device="cpu")
    assert blob == ref.compress_tiled_bytes(img, tc, engine="xla")
    assert np.array_equal(decompress_tiled_bytes(blob, device="cpu"), img)


@pytest.mark.parametrize("shape", [(0, 5), (4, 0, 3)])
def test_empty_image(shape):
    img = np.zeros(shape, np.uint8)
    blob = compress_tiled_bytes(img, TileConfig(4, 4), device="cpu")
    assert blob == ref.compress_tiled_bytes(img, TileConfig(4, 4), engine="xla")
    out = decompress_tiled_bytes(blob, device="cpu")
    assert out.shape == img.shape and out.dtype == img.dtype


def test_decode_tolerates_corrupt_payload():
    """As tests/test_pallas_codec.py requires: flipped payload bytes give a
    DecompressionError or an image of the right shape, never a crash."""
    img = _image((16, 16), 255, 9)
    blob = compress_tiled_bytes(img, TileConfig(8, 8), device="cpu")
    hd = flct.read_tiled_header(blob)
    rng = np.random.default_rng(10)
    for pos in rng.integers(hd.payload_off, len(blob), 12):
        data = bytearray(blob)
        data[pos] ^= 0xFF
        try:
            out = decompress_tiled_bytes(bytes(data), device="cpu")
        except errors.DecompressionError:
            continue
        assert out.shape == img.shape


def test_truncated_and_malformed_containers():
    img = _image((16, 16), 255, 2)
    blob = compress_tiled_bytes(img, TileConfig(8, 8), device="cpu")
    with pytest.raises(errors.IoError):
        decompress_tiled_bytes(blob[:-1], device="cpu")
    with pytest.raises(errors.IoError):
        decompress_tiled_bytes(blob[:20], device="cpu")
    with pytest.raises(errors.InvalidSignature):
        decompress_tiled_bytes(b"FLCS" + blob[4:], device="cpu")
    bad_grid = bytearray(blob)
    bad_grid[23] += 1  # n_tiles no longer matches the dims
    with pytest.raises(errors.InvalidDimensions):
        decompress_tiled_bytes(bytes(bad_grid), device="cpu")


def test_out_of_depth_values_raise_invalid_value():
    """A stream that decodes past the depth is rejected: a flat 255 tile is
    two 0xFF preamble bytes and a '1' per pixel; '01' instead makes the
    first coded pixel out of range above 255."""
    img = np.full((8, 8), 255, np.uint8)
    blob = bytearray(compress_tiled_bytes(img, TileConfig(8, 8), device="cpu"))
    hd = flct.read_tiled_header(bytes(blob))
    assert blob[hd.payload_off + 2] == 0xFF
    blob[hd.payload_off + 2] = 0x7F
    with pytest.raises(errors.InvalidValue):
        decompress_tiled_bytes(bytes(blob), device="cpu")


def test_width_relaunch_on_overflow(monkeypatch):
    """A stream longer than the width hint is relaunched once, by the
    finish half, at the exact width: its words equal a direct launch at
    that width and decode to the tiles, the container equals an unforced
    call's, and the hint learns the width."""
    rng = np.random.default_rng(7)
    checker = (np.arange(32)[:, None] + np.arange(32)[None, :]) % 2 == 1
    img = np.where(checker, rng.integers(240, 256, (32, 32)),
                   rng.integers(0, 16, (32, 32))).astype(np.uint8)
    want = compress_tiled_bytes(img, TileConfig(32, 32), device="cpu")
    hd = header_for_array(img)
    cfg = tiling.tiled_config_for_depth(hd.pixel_depth)
    key = (32 * 32, 1, hd.pixel_depth)
    # As if the widest stream seen had been one word: the hint is the
    # smallest bucket, 64 words (2 bits a pixel).
    monkeypatch.setattr(tcd, "_w_hints", {key: 1})
    p = tiling.encode_dispatch([img], [hd], 32, 32, True, CPU)
    assert p.W == 64
    assert tiling.encode_finish(p) == [want]
    max_bits = int(p.bits.max())
    assert max_bits > 32 * 64
    assert p.W == tcd.bucket_words(-(-max_bits // 32)) == p.words.shape[1]
    direct = tcd.encode_tiles(p.tiles, cfg, 32, 32, p.W, p.prior)
    assert torch.equal(direct[0], p.words) and torch.equal(direct[1], p.bits)
    assert torch.equal(tcd.decode_tiles(p.words, cfg, 32, 32, 1, p.prior), p.tiles)
    assert tcd._w_hints[key] == -(-max_bits // 32)


@pytest.mark.parametrize("shape,depth_max", [((13, 9, 3), 255), ((16, 24), 65535)])
def test_image_tiles_match_reference(shape, depth_max):
    img = _image(shape, depth_max, 6, False)
    color = ColorType.RGB if img.ndim == 3 else ColorType.GRAY
    want, _, _ = ref._prepare_tiles(img, color, 4, 5)
    got = tiling.image_tiles(upload_image(img, CPU)[None], 4, 5)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("depth_max", [255, 65535])
def test_k0_prior_matches_reference(depth_max):
    """Exact int64 k0 per image of a two-image batch, ties to the largest k,
    equal to the reference's host int64 pass (and its prior formula)."""
    imgs = [_image((16, 16, 3), depth_max, 1), _image((16, 16, 3), depth_max, 2, False)]
    cfg = tiled_config_for_depth(
        PixelDepth.EIGHT if depth_max == 255 else PixelDepth.SIXTEEN
    )
    parts = [ref._prepare_tiles(im, ColorType.RGB, 8, 8)[0] for im in imgs]
    want = ref.compute_k0_batch(np.concatenate(parts), [4, 4], 8, 8, cfg, 6)
    tiles = torch.from_numpy(np.concatenate(parts).astype(np.int32))
    k0, prior = tiling.k0_prior(tiles, [4, 4], 8, 8, cfg)
    assert np.array_equal(k0.numpy(), want)
    assert np.array_equal(prior[:4].numpy(), np.broadcast_to(
        ref.prior_from_k0(want[0], cfg, 3), (4, 3, 6, cfg.num_k)))


def test_word_rows_match_reference():
    rng = np.random.default_rng(8)
    lens = np.array([5, 0, 9, 4, 13], np.int64)
    payload = rng.integers(0, 256, int(lens.sum()), dtype=np.uint8).tobytes()
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    want = ref._payload_to_columns(payload, starts, lens, 4)
    got = tiling.word_rows(torch.frombuffer(bytearray(payload), dtype=torch.uint8),
                           torch.from_numpy(lens), 4)
    assert np.array_equal(got.numpy(), want.view(np.int32))


# Bit counts of the tiles of one compaction, rows of W = 8 words (256 bits):
# every residue mod 32 (so mod 8) over 1-6 whole words; 1-bit tiles; tiles
# that fill their row; tiles past their row (middle and last), which the
# compaction clamps to the row's 32 bytes.
PAYLOAD_BITS = {
    "residues": [32 * k + r for k, r in zip(
        np.random.default_rng(10).integers(1, 7, 32), range(32))],
    "one bit": [1, 37, 1, 1],
    "full rows": [256, 5, 256],
    "past the row": [300, 64, 257, 1000],
}


@pytest.mark.parametrize("room", ["exact", "spare", "short"])
@pytest.mark.parametrize("bits", list(PAYLOAD_BITS))
def test_byte_payload_matches_reference_compaction(bits, room):
    """The exact-byte compaction equals the reference's host compaction of
    the same word rows, byte for byte, with zeros past the used count; a
    capacity below the count keeps the payload's first 4 * cap bytes and
    reports the whole count."""
    bits = np.array(PAYLOAD_BITS[bits], np.int64)
    W = 8
    words = np.random.default_rng(9).integers(
        -(1 << 31), 1 << 31, (len(bits), W)).astype(np.int32)
    tb = np.minimum((bits + 7) // 8, 4 * W)
    want = ref._columns_to_payload(words.view(np.uint32), tb)
    n = len(want)
    cap = -(-n // 4) + {"exact": 0, "spare": 5, "short": -1}[room]
    pay, total = tiling.byte_payload(torch.from_numpy(words), torch.from_numpy(bits), cap)
    assert int(total) == n and pay.dtype == torch.uint8 and pay.numel() == 4 * cap
    if room == "short":
        assert n > 4 * cap and pay.numpy().tobytes() == want[: 4 * cap]
    else:
        assert pay[:n].numpy().tobytes() == want
        assert not pay[n:].any()


def test_to_host_round_trips_mixed_dtypes():
    ts = [torch.tensor([True, False]), torch.arange(5, dtype=torch.int64),
          torch.tensor([[1, -2], [3, 4]], dtype=torch.int32),
          torch.tensor([7, 255], dtype=torch.uint8)]
    for t, h in zip(ts, to_host(*ts)):
        assert np.array_equal(h, t.numpy()) and h.dtype == t.numpy().dtype


def test_import_loads_no_jax():
    code = ("import sys, felics_tpu_torch; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'felics_tpu')]; "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    img = _image((8, 8), 255, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        compress_tiled_bytes(img, TileConfig(4, 4))
    with pytest.raises(RuntimeError, match="cuda"):
        decompress_tiled_bytes(compress_tiled_bytes(img, TileConfig(4, 4), device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,depth_max,tile,smooth", CASES)
def test_cuda_container_matches_cpu(cuda, shape, depth_max, tile, smooth):
    img = _image(shape, depth_max, 3, smooth)
    tc = TileConfig(tile_h=tile[0], tile_w=tile[1])
    blob = compress_tiled_bytes(img, tc, device=cuda)
    assert blob == compress_tiled_bytes(img, tc, device="cpu")
    assert np.array_equal(decompress_tiled_bytes(blob, device=cuda), img)
