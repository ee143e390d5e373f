"""The port's tile codec (felics_tpu_torch.ops.tile_codec) against the
Pallas kernels of the reference, run in interpret mode on the CPU as
tests/test_pallas_codec.py runs them. Tolerance zero: words, bit counts
and pixels must be identical.

The CUDA kernels themselves run only on a card; their cases carry the
``cuda`` marker and skip where torch.cuda.is_available() is False.
"""

import jax
import numpy as np
import pytest
import torch

from felics_tpu.config import tiled_config_for_depth
from felics_tpu.format import ColorType, PixelDepth
from felics_tpu.ops import pallas_codec as pc
from felics_tpu.parallel import tiling as ref_tiling
from felics_tpu_torch.convert import prior_from_reference
from felics_tpu_torch.ops import tile_codec as tcd
from felics_tpu_torch.ops.bits import bit_length, shl32, shr32

CPU = torch.device("cpu")
# The plain versions run many tiny ops: intra-op threads only contend with
# the other test workers.
torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _fresh_jax_caches():
    # Interpret-mode Pallas compiles late in a long-lived worker have
    # crashed XLA:CPU before (tests/conftest.py); start from empty caches.
    jax.clear_caches()
    yield


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


def _tiles_and_prior(shape, depth_max, tile, smooth, prior_kind, seed=3):
    """Reference-prepared tiles and a k-table seed: the image's own prior
    (as the reference container computes it), zeros, or random per tile."""
    img = _image(shape, depth_max, seed, smooth)
    color = ColorType.RGB if img.ndim == 3 else ColorType.GRAY
    depth = PixelDepth.EIGHT if depth_max == 255 else PixelDepth.SIXTEEN
    cfg = tiled_config_for_depth(depth)
    th, tw = tile
    tiles, _, _ = ref_tiling._prepare_tiles(img, color, th, tw)
    nt, c, t = tiles.shape
    nb = tcd.num_buckets(cfg)
    if prior_kind == "image":
        k0 = ref_tiling.compute_k0(tiles, th, tw, cfg, nb)
        prior = ref_tiling.prior_from_k0(k0, cfg, c)
    elif prior_kind == "zero":
        prior = ref_tiling.prior_from_k0(None, cfg, c)
    else:
        rng = np.random.default_rng(seed)
        prior = rng.integers(0, 40, (nt, c, nb, cfg.num_k)).astype(np.int32)
    return tiles.astype(np.int32), prior, cfg


PALLAS_CASES = [
    ((24, 24), 255, (8, 8), True, "image"),
    ((8, 8, 3), 65535, (4, 4), False, "image"),
    ((13, 9), 255, (5, 3), False, "per-tile"),
]


@pytest.mark.parametrize("shape,depth_max,tile,smooth,prior_kind", PALLAS_CASES)
def test_tile_codec_matches_pallas(shape, depth_max, tile, smooth, prior_kind):
    tiles, prior, cfg = _tiles_and_prior(shape, depth_max, tile, smooth, prior_kind)
    th, tw = tile
    nt, c, t = tiles.shape
    W = pc.encode_width_bound(cfg, t, c)
    words_p, bits_p = pc.encode_tiles(tiles, cfg, th, tw, W, prior)
    words_p, bits_p = np.asarray(words_p), np.asarray(bits_p)

    prior_t = prior_from_reference(prior, nt, CPU)
    words_t, bits_t = tcd.encode_tiles(torch.from_numpy(tiles), cfg, th, tw, W, prior_t)
    assert np.array_equal(words_t.numpy(), words_p.view(np.int32))
    assert np.array_equal(bits_t.numpy(), bits_p.astype(np.int64))

    dec_p = np.asarray(pc.decode_tiles(words_p, cfg, th, tw, c, prior))
    dec_t = tcd.decode_tiles(words_t, cfg, th, tw, c, prior_t).numpy()
    assert np.array_equal(dec_t, dec_p)
    assert np.array_equal(dec_t, tiles)


def _serial_k(tiles, prior, th, tw, nb, K):
    """k of every out-of-range pixel from a serial walk of each domain's
    table, pixel by pixel, in Python ints (uint32 wrap); the largest k
    elsewhere."""
    nt, c, t = tiles.shape
    out = np.full((nt, c, t), K - 1, np.int64)
    x = np.arange(t) % tw
    y = np.arange(t) // tw
    for i in range(nt):
        for ci in range(c):
            plane = [int(v) for v in tiles[i, ci]]
            table = [[int(v) & 0xFFFFFFFF for v in row] for row in prior[i, ci]]
            for j in range(2, t):
                if y[j] == 0:
                    a, b = j - 1, j - 2
                elif x[j] > 0:
                    a, b = j - 1, j - tw
                elif y[j] >= 2:
                    a, b = j - tw, j - 2 * tw
                else:
                    a, b = j - tw, j - tw + 1
                p, h, lo = plane[j], max(plane[a], plane[b]), min(plane[a], plane[b])
                if lo <= p <= h:
                    continue
                v = lo - p - 1 if p < lo else p - h - 1
                row = table[min((h - lo).bit_length(), nb - 1)]
                best = min(row)
                out[i, ci, j] = max(k for k in range(K) if row[k] == best)
                for k in range(K):
                    row[k] = (row[k] + (v >> k) + 1 + k) & 0xFFFFFFFF
    return out


@pytest.mark.parametrize("prior_kind", ["zero", "per-tile"])
@pytest.mark.parametrize("shape,depth_max,tile,smooth", [
    ((24, 24), 255, (8, 8), True),
    ((8, 8, 3), 65535, (4, 4), False),
    ((13, 9), 255, (5, 3), False),
    ((16, 16, 3), 255, (8, 8), False),
])
def test_prefix_sum_k_matches_kscan_tiled(shape, depth_max, tile, smooth, prior_kind):
    """The encode kernel's k pass (prefix sums of Rice-length rows, written
    out plainly as tile_k_ref) equals the reference's scan-free kscan_tiled
    on _tiled_stage1's analysis, and a serial walk of the table."""
    from felics_tpu.ops.kscan_tiled import kscan_tiled

    tiles, prior, cfg = _tiles_and_prior(shape, depth_max, tile, smooth, prior_kind)
    th, tw = tile
    nt, c, t = tiles.shape
    nb, K = tcd.num_buckets(cfg), cfg.num_k
    per_tile = np.ascontiguousarray(np.broadcast_to(prior, (nt, c, nb, K)), np.int32)
    _, _, oor, residual, _, _, qctx = ref_tiling._tiled_stage1(tiles, th, tw, nb)
    want = np.asarray(kscan_tiled(
        qctx.reshape(nt * c, t), oor.reshape(nt * c, t), residual.reshape(nt * c, t),
        cfg, nb, per_tile.reshape(nt * c, nb, K),
    )).reshape(nt, c, t)
    got = tcd.tile_k_ref(torch.from_numpy(tiles), cfg, th, tw,
                         prior_from_reference(prior, nt, CPU)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, _serial_k(tiles, per_tile, th, tw, nb, K))
    assert np.asarray(oor).any()  # the cases do exercise the table


@pytest.mark.parametrize("prior_kind", ["zero", "image"])
def test_shared_and_per_tile_prior_agree(prior_kind):
    """A (C, nb, K) prior and its per-tile broadcast give the same stream."""
    tiles, prior, cfg = _tiles_and_prior((16, 16, 3), 255, (8, 8), True, prior_kind)
    nt, c, t = tiles.shape
    x = torch.from_numpy(tiles)
    shared = tcd.encode_tiles(x, cfg, 8, 8, 256, torch.from_numpy(prior))
    per_tile = tcd.encode_tiles(x, cfg, 8, 8, 256, prior_from_reference(prior, nt, CPU))
    assert torch.equal(shared[0], per_tile[0]) and torch.equal(shared[1], per_tile[1])


def test_overflowing_width_keeps_exact_bits():
    """Words past W are dropped, the bit count stays exact, and the words
    that fit equal the head of the full-width stream."""
    tiles, prior, cfg = _tiles_and_prior((16, 16), 255, (8, 8), False, "zero")
    x, pr = torch.from_numpy(tiles), torch.from_numpy(prior)
    full_w, full_b = tcd.encode_tiles(x, cfg, 8, 8, 128, pr)
    assert int(full_b.max()) > 32 * 4
    short_w, short_b = tcd.encode_tiles(x, cfg, 8, 8, 4, pr)
    assert torch.equal(short_b, full_b)
    assert torch.equal(short_w, full_w[:, :4])


def test_decode_of_garbage_words_terminates():
    """Random and all-ones rows (an endless unary run) stay inside the row,
    terminate, and give int32 planes of the right shape."""
    cfg = tiled_config_for_depth(PixelDepth.SIXTEEN)
    rng = np.random.default_rng(5)
    rows = rng.integers(-(1 << 31), 1 << 31, (3, 8)).astype(np.int32)
    rows[1] = -1  # 0xFFFFFFFF everywhere
    prior = torch.zeros((3, tcd.num_buckets(cfg), cfg.num_k), dtype=torch.int32)
    out = tcd.decode_tiles(torch.from_numpy(rows), cfg, 4, 4, 3, prior)
    assert out.shape == (3, 3, 16) and out.dtype == torch.int32


def test_empty_tile_batch():
    cfg = tiled_config_for_depth(PixelDepth.EIGHT)
    prior = torch.zeros((1, 6, 6), dtype=torch.int32)
    words, bits = tcd.encode_tiles(torch.zeros((0, 1, 16), dtype=torch.int32),
                                   cfg, 4, 4, 64, prior)
    assert words.shape == (0, 64) and bits.shape == (0,)
    out = tcd.decode_tiles(words, cfg, 4, 4, 1, prior)
    assert out.shape == (0, 1, 16)


def test_argument_checks():
    cfg = tiled_config_for_depth(PixelDepth.EIGHT)
    x = torch.zeros((2, 1, 16), dtype=torch.int32)
    good = torch.zeros((1, 6, 6), dtype=torch.int32)
    with pytest.raises(ValueError, match="2x2"):
        tcd.encode_tiles(torch.zeros((2, 1, 8), dtype=torch.int32), cfg, 8, 1, 64, good)
    with pytest.raises(ValueError, match="prior shape"):
        tcd.encode_tiles(x, cfg, 4, 4, 64, torch.zeros((1, 6, 5), dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        tcd.encode_tiles(x, cfg, 4, 4, 64, good.to(torch.int64))
    with pytest.raises(ValueError, match="int32"):
        tcd.encode_tiles(x.to(torch.int64), cfg, 4, 4, 64, good)
    with pytest.raises(ValueError, match="unsupported device"):
        tcd.encode_tiles(x.to("meta"), cfg, 4, 4, 64, good.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        tcd.decode_tiles(torch.zeros((2, 4), dtype=torch.int32, device="meta"),
                         cfg, 4, 4, 1, good.to("meta"))


@pytest.mark.parametrize("s", [0, 1, 17, 31, 32, 33, 63])
def test_bounded_shifts(s):
    v = torch.tensor([0, 1, 0x80000000, 0xFFFFFFFF, 0x12345678], dtype=torch.int64)
    want_l = [(int(x) << s) & 0xFFFFFFFF if s < 32 else 0 for x in v]
    want_r = [int(x) >> s if s < 32 else 0 for x in v]
    assert shl32(v, s).tolist() == want_l
    assert shr32(v, s).tolist() == want_r


def test_bit_length_exact():
    vals = [0, 1, 2, 3, 4, 255, 256, 131070, 131071, (1 << 31) - 1, 1 << 31,
            (1 << 32) - 1]
    x = torch.tensor(vals, dtype=torch.int64)
    assert bit_length(x, 33).tolist() == [v.bit_length() for v in vals]
    # Capped: min(bit_length, max_bits) — the context bucket.
    assert bit_length(x, 5).tolist() == [min(v.bit_length(), 5) for v in vals]


@pytest.mark.parametrize("depth", [PixelDepth.EIGHT, PixelDepth.SIXTEEN])
@pytest.mark.parametrize("t,c", [(16, 1), (15, 3), (1024, 1), (1024, 3)])
def test_width_helpers_match_reference(depth, t, c):
    cfg = tiled_config_for_depth(depth)
    assert tcd.encode_width_bound(cfg, t, c) == pc.encode_width_bound(cfg, t, c)
    for w in (1, 63, 64, 65, 700, 5000):
        assert tcd.bucket_words(w) == pc.bucket_words(w)


def test_width_hint_tracks_observed_streams(monkeypatch):
    monkeypatch.setattr(tcd, "_w_hints", {})
    cfg = tiled_config_for_depth(PixelDepth.EIGHT)
    first = tcd.width_hint(cfg, 1024, 1)
    assert first == tcd.bucket_words(64 + 1024 * 20 // 32)
    tcd.observe_width(cfg, 1024, 1, 32 * 100)
    assert tcd.width_hint(cfg, 1024, 1) == tcd.bucket_words(125)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,depth_max,tile,smooth,prior_kind", PALLAS_CASES)
def test_cuda_kernels_match_plain_versions(cuda, shape, depth_max, tile, smooth, prior_kind):
    tiles, prior, cfg = _tiles_and_prior(shape, depth_max, tile, smooth, prior_kind)
    th, tw = tile
    nt, c, t = tiles.shape
    W = tcd.encode_width_bound(cfg, t, c)
    x = torch.from_numpy(tiles).to(cuda)
    pr = prior_from_reference(prior, nt, cuda)
    wk, bk = tcd.encode_tiles(x, cfg, th, tw, W, pr)
    wr, br = tcd.encode_tiles_ref(x, cfg, th, tw, W, pr)
    assert torch.equal(wk, wr) and torch.equal(bk, br)
    dk = tcd.decode_tiles(wk, cfg, th, tw, c, pr)
    assert torch.equal(dk, tcd.decode_tiles_ref(wk, cfg, th, tw, c, pr))
    assert torch.equal(dk, x)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from felics_tpu_torch.ops import _build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda _p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    from felics_tpu_torch.ops import _build

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such card' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no such card"):
        _build.build()
    assert list((tmp_path / "build").iterdir()) == []  # no half-built library
