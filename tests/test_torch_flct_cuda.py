"""The FLCT tile kernels K1 (felics_tpu_torch/csrc/flct_encode.cu) and K2
(felics_tpu_torch/csrc/flct_decode.cu) against their plain versions
(ops/tile_codec.py: encode_tiles_ref, decode_tiles_ref), the k0/prior
kernel K5 (csrc/flct_k0_prior.cu) against its plain version
(parallel/tiling.py: k0_prior_ref), and K1 and K2 against the
port's scalar oracle (core/oracle.py: each word row decoded as one tile
stream in bucketed-k mode), and the plain versions' own round trips.

This module imports no JAX and nothing of felics_tpu, so it runs on a card
as well as here: inputs are made with numpy from a seed and tiled by the
port itself. The kernel cases carry the ``cuda`` marker and skip where
torch.cuda.is_available() is False; the plain-version cases run on the CPU.
Tolerance zero: words, bit counts and planes are integers. On a host
without JAX, skip tests/conftest.py (it sets JAX up):

    python3 -m pytest --noconftest tests/test_torch_flct_cuda.py -q
"""

import numpy as np
import pytest
import torch

from felics_tpu_torch.config import TileConfig, tiled_config_for_depth
from felics_tpu_torch.core import oracle
from felics_tpu_torch.device import upload_image
from felics_tpu_torch.format import PixelDepth, header_for_array
from felics_tpu_torch.ops import tile_codec as tcd
from felics_tpu_torch.parallel import batch, flct, tiling

CPU = torch.device("cpu")
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the FLCT kernels have no CPU mode")
    return torch.device("cuda")


def _image(seed, shape, dtype, smooth):
    rng = np.random.default_rng(seed)
    hi = np.iinfo(dtype).max
    if smooth:
        img = np.cumsum(np.cumsum(rng.integers(-6, 7, shape), 0), 1) + hi // 2
        return np.clip(img, 0, hi).astype(dtype)
    return rng.integers(0, hi + 1, shape).astype(dtype)


# name, image, tile, prior ("image": the container's k-prior; "zero")
CASES = [
    ("gray8 zero prior", _image(1, (24, 24), np.uint8, True), (8, 8), "zero"),
    ("gray8 prior", _image(2, (24, 24), np.uint8, True), (8, 8), "image"),
    ("rgb8", _image(3, (16, 16, 3), np.uint8, True), (8, 8), "image"),
    ("rgb16", _image(4, (8, 8, 3), np.uint16, False), (4, 4), "image"),
    ("gray16", _image(5, (16, 24), np.uint16, True), (8, 8), "image"),
    ("gray8 13x9 tile 5x3", _image(6, (13, 9), np.uint8, False), (5, 3), "image"),
    ("gray8 tile 64x64", _image(7, (64, 64), np.uint8, True), (64, 64), "image"),
]
IDS = [c[0] for c in CASES]


def _inputs(img, tile, prior_kind, device):
    """(tiles, prior, cfg, th, tw) of one image, tiled as the main path
    tiles it."""
    hd = header_for_array(img)
    cfg = tiled_config_for_depth(hd.pixel_depth)
    th, tw = flct.clamped_tile_dims(hd.height, hd.width, TileConfig(*tile))
    tiles = tiling.image_tiles(upload_image(img, device)[None], th, tw)
    nt, c, _ = tiles.shape
    if prior_kind == "image":
        _, prior = tiling.k0_prior(tiles, [nt], th, tw, cfg)
    else:
        prior = torch.zeros((c, tcd.num_buckets(cfg), cfg.num_k), dtype=torch.int32,
                            device=device)
    return tiles, prior, cfg, th, tw


def _overflow_inputs(device):
    """Noise on a checkerboard under a prior that holds every bucket at
    k = 0: ~230 bits a pixel, far past a narrow W."""
    rng = np.random.default_rng(8)
    checker = (np.arange(16)[:, None] + np.arange(16)[None, :]) % 2 == 1
    img = np.where(checker, rng.integers(240, 256, (16, 16)),
                   rng.integers(0, 16, (16, 16))).astype(np.uint8)
    cfg = tiled_config_for_depth(PixelDepth.EIGHT)
    tiles = tiling.image_tiles(upload_image(img, device)[None], 8, 8)
    prior = torch.full((1, tcd.num_buckets(cfg), cfg.num_k), 1 << 20, dtype=torch.int32,
                       device=device)
    prior[..., 0] = 0
    return tiles, prior, cfg


def _garbage_rows(device):
    """Random words, and all ones (an endless unary run)."""
    rng = np.random.default_rng(9)
    rows = rng.integers(-(1 << 31), 1 << 31, (40, 8)).astype(np.int32)
    rows[1] = -1
    return torch.from_numpy(rows).to(device)


GARBAGE = [(PixelDepth.EIGHT, 1), (PixelDepth.SIXTEEN, 3)]


def _oracle_planes(words, bits, tiles, prior, cfg, th, tw):
    """Each word row decoded on the port's oracle as one tile stream: its
    planes must be the tile's and end at the row's bit count, and the
    oracle must encode the tile back to the row's bits. Returns the
    (n, C, t) decoded planes."""
    c = tiles.shape[1]
    rows = words.cpu().numpy().view(np.uint32).astype(">u4")
    priors = prior.cpu().numpy()
    want = tiles.cpu().numpy()
    out = []
    for i, row in enumerate(rows):
        p = priors[i] if priors.ndim == 4 else priors
        stream = row.tobytes()
        planes, end = oracle.decompress_tile(stream, th, tw, c, cfg, p)
        assert end == int(bits[i]) and np.array_equal(planes, want[i]), i
        again, nbits = oracle.compress_tile(want[i], th, tw, cfg, p)
        assert nbits == end and again == stream[:len(again)], i
        out.append(planes)
    return torch.from_numpy(np.stack(out).astype(np.int32))


@pytest.mark.parametrize("name,img,tile,prior_kind", CASES, ids=IDS)
def test_plain_versions_round_trip(name, img, tile, prior_kind):
    tiles, prior, cfg, th, tw = _inputs(img, tile, prior_kind, CPU)
    nt, c, t = tiles.shape
    W = tcd.encode_width_bound(cfg, t, c)
    words, bits = tcd.encode_tiles_ref(tiles, cfg, th, tw, W, prior)
    assert int(bits.max()) <= 32 * W
    assert torch.equal(tcd.decode_tiles_ref(words, cfg, th, tw, c, prior), tiles)


@pytest.mark.parametrize("name,img,tile,prior_kind", CASES, ids=IDS)
def test_plain_words_decode_on_the_oracle(name, img, tile, prior_kind):
    tiles, prior, cfg, th, tw = _inputs(img, tile, prior_kind, CPU)
    W = tcd.encode_width_bound(cfg, tiles.shape[2], tiles.shape[1])
    words, bits = tcd.encode_tiles_ref(tiles, cfg, th, tw, W, prior)
    _oracle_planes(words, bits, tiles, prior, cfg, th, tw)


def test_plain_encode_overflowing_width_keeps_exact_bits():
    tiles, prior, cfg = _overflow_inputs(CPU)
    full_w, full_b = tcd.encode_tiles_ref(tiles, cfg, 8, 8, 1024, prior)
    assert int(full_b.max()) > 32 * 64
    short_w, short_b = tcd.encode_tiles_ref(tiles, cfg, 8, 8, 64, prior)
    assert torch.equal(short_b, full_b)
    assert torch.equal(short_w, full_w[:, :64])


@pytest.mark.parametrize("depth,c", GARBAGE, ids=[f"{d.name} C={c}" for d, c in GARBAGE])
def test_plain_decode_of_garbage_words_terminates(depth, c):
    cfg = tiled_config_for_depth(depth)
    prior = torch.zeros((c, tcd.num_buckets(cfg), cfg.num_k), dtype=torch.int32)
    out = tcd.decode_tiles_ref(_garbage_rows(CPU), cfg, 4, 4, c, prior)
    assert out.shape == (40, c, 16) and out.dtype == torch.int32


@pytest.mark.parametrize("n,tpb", [(1, 1), (48, 1), (768, 2), (1024, 2), (2048, 4),
                                   (3072, 8), (12288, 32), (100000, 32)])
def test_decode_tiles_per_block(n, tpb):
    """K2 puts fewer tiles in a block while that gives more blocks, up to
    DECODE_MIN_BLOCKS; a full warp of tiles once there are enough."""
    assert tcd.decode_tiles_per_block(n) == tpb


@pytest.mark.parametrize("K,tw,tpb,shared", [
    (6, 32, 32, True), (6, 256, 32, True), (15, 256, 32, True), (6, 1700, 32, True),
    (15, 1700, 32, False), (6, 1800, 32, False), (6, 29000, 1, True), (6, 30000, 1, False),
])
def test_decode_ring_fits_shared_memory(K, tw, tpb, shared):
    """K2 keeps its rings of the row above in shared memory beside the
    k-table up to the opt-in limit (227 KB on an H100); wider tiles put
    them in global scratch."""
    assert (tcd.decode_smem_bytes(K, tw, tpb) <= 232448) == shared


@pytest.mark.cuda
@pytest.mark.parametrize("name,img,tile,prior_kind", CASES, ids=IDS)
def test_cuda_kernels_match_plain_versions(cuda, name, img, tile, prior_kind):
    tiles, prior, cfg, th, tw = _inputs(img, tile, prior_kind, cuda)
    nt, c, t = tiles.shape
    W = tcd.encode_width_bound(cfg, t, c)
    wk, bk = tcd.encode_tiles(tiles, cfg, th, tw, W, prior)
    wr, br = tcd.encode_tiles_ref(tiles, cfg, th, tw, W, prior)
    assert torch.equal(wk, wr) and torch.equal(bk, br)
    dk = tcd.decode_tiles(wk, cfg, th, tw, c, prior)
    assert torch.equal(dk, tcd.decode_tiles_ref(wk, cfg, th, tw, c, prior))
    assert torch.equal(dk, tiles)


@pytest.mark.cuda
@pytest.mark.parametrize("name,img,tile,prior_kind", CASES, ids=IDS)
def test_cuda_kernels_match_the_oracle(cuda, name, img, tile, prior_kind):
    """K1's word rows decode on the oracle to the tiles, and K2's planes
    are the oracle's."""
    tiles, prior, cfg, th, tw = _inputs(img, tile, prior_kind, cuda)
    nt, c, t = tiles.shape
    wk, bk = tcd.encode_tiles(tiles, cfg, th, tw, tcd.encode_width_bound(cfg, t, c), prior)
    planes = _oracle_planes(wk, bk, tiles, prior, cfg, th, tw)
    assert torch.equal(tcd.decode_tiles(wk, cfg, th, tw, c, prior).cpu(), planes)


@pytest.mark.cuda
def test_cuda_encode_overflowing_width(cuda):
    """Words past W are dropped and the bit count stays exact, as in the
    plain version; the words that fit are the head of the full stream."""
    tiles, prior, cfg = _overflow_inputs(cuda)
    short_w, short_b = tcd.encode_tiles(tiles, cfg, 8, 8, 64, prior)
    ref_w, ref_b = tcd.encode_tiles_ref(tiles, cfg, 8, 8, 64, prior)
    assert int(short_b.max()) > 32 * 64
    assert torch.equal(short_w, ref_w) and torch.equal(short_b, ref_b)
    full_w, full_b = tcd.encode_tiles(tiles, cfg, 8, 8, 1024, prior)
    assert torch.equal(full_b, short_b) and torch.equal(full_w[:, :64], short_w)


@pytest.mark.cuda
@pytest.mark.parametrize("depth,c", GARBAGE, ids=[f"{d.name} C={c}" for d, c in GARBAGE])
def test_cuda_decode_of_garbage_words(cuda, depth, c):
    cfg = tiled_config_for_depth(depth)
    prior = torch.zeros((c, tcd.num_buckets(cfg), cfg.num_k), dtype=torch.int32,
                        device=cuda)
    rows = _garbage_rows(cuda)
    got = tcd.decode_tiles(rows, cfg, 4, 4, c, prior)
    assert torch.equal(got, tcd.decode_tiles_ref(rows, cfg, 4, 4, c, prior))


@pytest.mark.cuda
def test_cuda_decode_ring_in_global_scratch(cuda):
    """A tile 30,000 pixels wide: K2's ring does not fit in shared memory
    and goes to global scratch; the round trip is still exact (the plain
    versions, at 60,000 steps, are left out)."""
    img = _image(10, (2, 30000), np.uint8, True)
    tiles, prior, cfg, th, tw = _inputs(img, (2, 30000), "image", cuda)
    nt, c, t = tiles.shape
    tpb = tcd.decode_tiles_per_block(nt)
    assert not tcd.decode_smem_bytes(cfg.num_k, tw, tpb) <= 232448
    W = tcd.encode_width_bound(cfg, t, c)
    words, bits = tcd.encode_tiles(tiles, cfg, th, tw, W, prior)
    assert int(bits.max()) <= 32 * W
    assert torch.equal(tcd.decode_tiles(words, cfg, th, tw, c, prior), tiles)


@pytest.mark.cuda
def test_cuda_decode_long_row_takes_wide_positions(cuda):
    """A 2x2 tile in a row of more than 2^26 words (zero past its bits, so
    the chain ends after 4 pixels): decode_tiles takes K2's 64-bit-position
    instantiation, and the planes equal the plain version's and the tile."""
    img = _image(11, (2, 2), np.uint8, False)
    tiles, prior, cfg, th, tw = _inputs(img, (2, 2), "image", cuda)
    words, _ = tcd.encode_tiles(tiles, cfg, th, tw, 64, prior)
    W = (1 << 26) + 64
    assert tcd.decode_wide_positions(W, 1, th, tw)
    assert not tcd.decode_wide_positions(64, 1, th, tw)
    rows = torch.zeros((1, W), dtype=torch.int32, device=cuda)
    rows[:, :64] = words
    before, wide_before = tcd.DECODE_LAUNCHES, tcd.DECODE_WIDE_LAUNCHES
    got = tcd.decode_tiles(rows, cfg, th, tw, 1, prior)
    assert tcd.DECODE_LAUNCHES == before + 1
    assert tcd.DECODE_WIDE_LAUNCHES == wide_before + 1
    assert torch.equal(got, tcd.decode_tiles_ref(rows, cfg, th, tw, 1, prior))
    assert torch.equal(got, tiles)


# One tile whose first coded pixel of its last plane lies v + 1 above its
# context, under a prior that holds every bucket at k = 0: its code is a run
# of v ones, 3 + v bits in all, which K2's 32-bit window holds up to v = 29.
# name, depth, planes, tile, v, the kernel's slow-path steps
RUN_CASES = [
    ("gray8 run to the window's edge", 8, 1, (8, 8), 29, 0),
    ("gray8 run one past the window", 8, 1, (8, 8), 30, 1),
    ("gray8 run of 150", 8, 1, (8, 8), 150, 1),
    ("gray16 run of 5000", 16, 1, (8, 8), 5000, 1),
    ("rgb16 Cg run to the window's edge", 16, 3, (4, 4), 29, 0),
    ("rgb16 Cg run of 60000", 16, 3, (4, 4), 60000, 1),
    ("rgb8 Cg run one past the window", 8, 3, (4, 4), 30, 1),
]
RUN_IDS = [c[0] for c in RUN_CASES]


def _run_tile(depth, c, tile, v, device):
    """(tiles, prior, cfg) of a RUN_CASES tile: constant planes (100 for Y,
    0 for Co/Cg), the last plane's third pixel at base + 1 + v."""
    cfg = tiled_config_for_depth(PixelDepth.EIGHT if depth == 8 else PixelDepth.SIXTEEN)
    th, tw = tile
    tiles = torch.zeros((1, c, th * tw), dtype=torch.int32)
    tiles[:, 0] = 100
    tiles[0, c - 1, 2] = int(tiles[0, c - 1, 0]) + 1 + v
    nb, K = tcd.num_buckets(cfg), cfg.num_k
    prior = torch.full((c, nb, K), 1 << 20, dtype=torch.int32)
    prior[..., 0] = 0
    return tiles.to(device), prior.to(device), cfg


def _encoded_at_exact_width(encode, tiles, prior, cfg, th, tw):
    """Word rows of the tiles at a width that holds every stream."""
    W = tcd.encode_width_bound(cfg, th * tw, tiles.shape[1])
    words, bits = encode(tiles, cfg, th, tw, W, prior)
    if int(bits.max()) > 32 * W:
        W = tiling.exact_width(int(bits.max()))
        words, bits = encode(tiles, cfg, th, tw, W, prior)
    return words


@pytest.mark.parametrize("name,depth,c,tile,v,slow", RUN_CASES, ids=RUN_IDS)
def test_plain_versions_on_runs_past_the_window(name, depth, c, tile, v, slow):
    tiles, prior, cfg = _run_tile(depth, c, tile, v, CPU)
    words = _encoded_at_exact_width(tcd.encode_tiles_ref, tiles, prior, cfg, *tile)
    assert torch.equal(tcd.decode_tiles_ref(words, cfg, *tile, c, prior), tiles)


def test_decode_slow_steps_counts_the_kernel_only():
    """The slow-step count is the CUDA kernel's: the plain version takes none."""
    tiles, prior, cfg = _run_tile(8, 1, (8, 8), 30, CPU)
    words = _encoded_at_exact_width(tcd.encode_tiles_ref, tiles, prior, cfg, 8, 8)
    with pytest.raises(ValueError, match="slow_steps"):
        tcd.decode_tiles(words, cfg, 8, 8, 1, prior, slow_steps=torch.zeros(1, dtype=torch.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("name,depth,c,tile,v,slow", RUN_CASES, ids=RUN_IDS)
def test_cuda_decode_of_runs_past_the_window(cuda, name, depth, c, tile, v, slow):
    """A code that just fits K2's window takes its fast path, one a bit
    longer its slow path (counted); both decode as the plain version does."""
    tiles, prior, cfg = _run_tile(depth, c, tile, v, cuda)
    words = _encoded_at_exact_width(tcd.encode_tiles, tiles, prior, cfg, *tile)
    count = torch.zeros(1, dtype=torch.int64, device=cuda)
    got = tcd.decode_tiles(words, cfg, *tile, c, prior, slow_steps=count)
    assert torch.equal(got, tcd.decode_tiles_ref(words, cfg, *tile, c, prior))
    assert torch.equal(got, tiles)
    assert int(count) == slow


@pytest.mark.cuda
def test_cuda_decode_of_a_smooth_image_takes_no_slow_step(cuda):
    img = _image(7, (64, 64), np.uint8, True)
    tiles, prior, cfg, th, tw = _inputs(img, (64, 64), "image", cuda)
    words = _encoded_at_exact_width(tcd.encode_tiles, tiles, prior, cfg, th, tw)
    count = torch.zeros(1, dtype=torch.int64, device=cuda)
    assert torch.equal(tcd.decode_tiles(words, cfg, th, tw, 1, prior, slow_steps=count), tiles)
    assert int(count) == 0


@pytest.mark.cuda
def test_cuda_decode_run_past_the_window_with_rings_in_global_scratch(cuda):
    """The slow path beside rings in global scratch: a 2x30000 tile (its
    plain version, at 60,000 steps, is left out)."""
    tiles, prior, cfg = _run_tile(8, 1, (2, 30000), 30, cuda)
    assert not tcd.decode_smem_bytes(cfg.num_k, 30000, 1) <= 232448
    words = _encoded_at_exact_width(tcd.encode_tiles, tiles, prior, cfg, 2, 30000)
    count = torch.zeros(1, dtype=torch.int64, device=cuda)
    assert torch.equal(tcd.decode_tiles(words, cfg, 2, 30000, 1, prior, slow_steps=count), tiles)
    assert int(count) == 1


@pytest.mark.cuda
def test_cuda_decode_run_past_the_window_with_wide_positions(cuda):
    """The slow path in K2's 64-bit-position instantiation: a 2x2 tile whose
    one coded out-of-range pixel needs it, in a row of more than 2^26 words."""
    tiles, prior, cfg = _run_tile(8, 1, (2, 2), 30, cuda)
    words = _encoded_at_exact_width(tcd.encode_tiles, tiles, prior, cfg, 2, 2)
    W = (1 << 26) + 64
    assert tcd.decode_wide_positions(W, 1, 2, 2)
    rows = torch.zeros((1, W), dtype=torch.int32, device=cuda)
    rows[:, :words.shape[1]] = words
    count = torch.zeros(1, dtype=torch.int64, device=cuda)
    wide_before = tcd.DECODE_WIDE_LAUNCHES
    got = tcd.decode_tiles(rows, cfg, 2, 2, 1, prior, slow_steps=count)
    assert tcd.DECODE_WIDE_LAUNCHES == wide_before + 1
    assert torch.equal(got, tcd.decode_tiles_ref(rows, cfg, 2, 2, 1, prior))
    assert torch.equal(got, tiles)
    assert int(count) == 1


def _run_rows(W, device):
    """Garbage rows full of long runs of ones: after a sign bit, 29 or more
    ones, words of all ones, and random words with a long run inside."""
    rng = np.random.default_rng(12)
    rows = rng.integers(-(1 << 31), 1 << 31, (40, W)).astype(np.int64)
    rows[:8] |= 0x3FFFFFF0
    rows[8:16] = 0x3FFFFFFF
    rows[16:24] = 0x7FFFFFFF
    rows[24:32, ::2] = -1
    rows[24:32, 1::2] = 0x3FFFFFFF
    rows[32:] = rng.integers(0, 1 << 31, (8, W)) | 0x1FFFFFF8
    return torch.from_numpy(rows.astype(np.uint32).view(np.int32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("prior_kind", ["k0", "zero"])
@pytest.mark.parametrize("depth,c", GARBAGE, ids=[f"{d.name} C={c}" for d, c in GARBAGE])
def test_cuda_decode_of_garbage_runs(cuda, depth, c, prior_kind):
    """Corrupt rows whose runs pass K2's window, cut short by the row's end
    or saturating the value: the kernel's planes are the plain version's."""
    cfg = tiled_config_for_depth(depth)
    prior = torch.zeros((c, tcd.num_buckets(cfg), cfg.num_k), dtype=torch.int32, device=cuda)
    if prior_kind == "k0":
        prior[..., 1:] = 1 << 20
    for W in (1, 3, 7):
        rows = _run_rows(W, cuda)
        count = torch.zeros(1, dtype=torch.int64, device=cuda)
        got = tcd.decode_tiles(rows, cfg, 4, 4, c, prior, slow_steps=count)
        assert torch.equal(got, tcd.decode_tiles_ref(rows, cfg, 4, 4, c, prior)), W


def _serving_images():
    """Four geometries: gray8 at two sizes (one clamps the tile), rgb8 and
    gray16."""
    return [_image(20, (24, 24), np.uint8, True), _image(21, (13, 9), np.uint8, False),
            _image(22, (16, 16, 3), np.uint8, True), _image(23, (16, 24), np.uint16, True),
            _image(24, (24, 24), np.uint8, False)]


@pytest.mark.cuda
def test_cuda_stream_equals_batch(cuda):
    """The stream pair on the card gives, batch by batch, the bytes of the
    batched call on the card, which are the plain versions' bytes on the
    CPU, at depths 1 to 3; the decode stream gives the images back."""
    ims = _serving_images()
    batches = [ims[:2], ims[2:4], [], ims[4:]]
    tc = TileConfig(8, 8)
    want = [batch.compress_tiled_batch(b, tc, device=cuda) for b in batches]
    assert want == [batch.compress_tiled_batch(b, tc, device=CPU) for b in batches]
    for depth in (1, 2, 3):
        assert batch.compress_tiled_stream(iter(batches), tc, depth=depth, device=cuda) == want
    outs = batch.decompress_tiled_stream(iter(want), depth=2, device=cuda)
    for b, o in zip(batches, outs):
        assert len(o) == len(b)
        for im, out in zip(b, o):
            assert out.dtype == im.dtype and np.array_equal(out, im)


@pytest.mark.cuda
def test_cuda_dispatch_halves_do_not_wait(cuda):
    """Both dispatch halves enqueue their whole device chain without one
    synchronising call: under torch.cuda.set_sync_debug_mode("error"),
    which raises on any, they run through, and their finish halves give
    the batched call's bytes and images."""
    ims = _serving_images()
    tc = TileConfig(8, 8)
    blobs = batch.compress_tiled_batch(ims, tc, device=cuda)  # build, hints, pinned pool
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):  # the mode is live
            int(torch.ones(1, device=cuda).sum())
        enc = batch._encode_dispatch(ims, tc, cuda)
        dec = batch._decode_dispatch(blobs, cuda, False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert batch._encode_finish(enc) == blobs
    for im, out in zip(ims, batch._decode_finish(dec, cuda, False)):
        assert out.dtype == im.dtype and np.array_equal(out, im)


# The edges of the 0..20 x 0..20 grid: rows 0, 1, 2 and 20, every width
# 0..20, at the smallest tile (2x2), per class.
EDGE_ROWS = (0, 1, 2, 20)
EDGE_CLASSES = {"gray8": (np.uint8, ()), "gray16": (np.uint16, ()),
                "rgb8": (np.uint8, (3,)), "rgb16": (np.uint16, (3,))}
EDGE_TILE = TileConfig(2, 2)


def _edge_row(h, cls):
    dtype, extra = EDGE_CLASSES[cls]
    rng = np.random.default_rng([h, list(EDGE_CLASSES).index(cls)])
    hi = np.iinfo(dtype).max + 1
    return [rng.integers(0, hi, (h, w) + extra).astype(dtype) for w in range(21)]


def _edge_pending(images, device):
    """The row's non-empty images encoded as the batched call encodes them
    at 2x2 (one geometry group of mixed shapes): the pending after its
    finish half, which holds the tiles, priors, word rows and bits."""
    images = [im for im in images if im.size]
    p = tiling.encode_dispatch(images, [header_for_array(im) for im in images],
                               2, 2, True, device)
    tiling.encode_finish(p)
    return p


@pytest.mark.parametrize("cls", list(EDGE_CLASSES))
@pytest.mark.parametrize("h", EDGE_ROWS)
def test_plain_versions_on_edge_rows(h, cls):
    """The plain versions round-trip the row's tiles, and the oracle reads
    their word rows as the tiles (row 0 has no tiles at all)."""
    images = _edge_row(h, cls)
    if h == 0:
        assert all(im.size == 0 for im in images)
        return
    p = _edge_pending(images, CPU)
    nt, c, _ = p.tiles.shape
    assert nt == sum(-(-h // 2) * -(-im.shape[1] // 2) for im in images)
    assert torch.equal(tcd.decode_tiles_ref(p.words, p.plan.cfg, 2, 2, c, p.prior), p.tiles)
    _oracle_planes(p.words, p.bits, p.tiles, p.prior, p.plan.cfg, 2, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("cls", list(EDGE_CLASSES))
@pytest.mark.parametrize("h", EDGE_ROWS)
def test_cuda_kernels_on_edge_rows(cuda, h, cls):
    """K1 and K2 on the row's tiles at 2x2 equal their plain versions, to
    the word, bit count and plane; the batched pair on the card gives the
    CPU's bytes and the images back; a row of zero-area images launches
    no kernel."""
    images = _edge_row(h, cls)
    before = tcd.ENCODE_LAUNCHES, tcd.DECODE_LAUNCHES
    blobs = batch.compress_tiled_batch(images, EDGE_TILE, device=cuda)
    outs = batch.decompress_tiled_batch(blobs, device=cuda)
    launched = tcd.ENCODE_LAUNCHES - before[0], tcd.DECODE_LAUNCHES - before[1]
    # one geometry group: K2 once, K1 once (again if a stream outgrew the
    # width hint); nothing for zero-area images
    assert launched == (0, 0) if h == 0 else launched[0] >= 1 and launched[1] == 1
    assert blobs == batch.compress_tiled_batch(images, EDGE_TILE, device=CPU)
    for im, out in zip(images, outs):
        assert out.dtype == im.dtype and np.array_equal(out, im)
    if h == 0:
        return
    p = _edge_pending(images, cuda)
    nt, c, _ = p.tiles.shape
    wk, bk = tcd.encode_tiles(p.tiles, p.plan.cfg, 2, 2, p.W, p.prior)
    wr, br = tcd.encode_tiles_ref(p.tiles, p.plan.cfg, 2, 2, p.W, p.prior)
    assert torch.equal(wk, wr) and torch.equal(bk, br)
    assert torch.equal(wk, p.words) and torch.equal(bk, p.bits)
    dk = tcd.decode_tiles(wk, p.plan.cfg, 2, 2, c, p.prior)
    assert torch.equal(dk, tcd.decode_tiles_ref(wk, p.plan.cfg, 2, 2, c, p.prior))
    assert torch.equal(dk, p.tiles)


# Same-shape groups on the card replay a CUDA graph of their chain from the
# second sighting of their key (parallel/graphs.py). Three images of one
# odd shape per class, at an odd tile.
def _planar(im):
    """``im`` with its samples plane after plane in memory, an (H, W, 3)
    view of (3, H, W) data."""
    return np.ascontiguousarray(im.transpose(2, 0, 1)).transpose(1, 2, 0)


GRAPH_CLASSES = {
    "gray8": ([_image(30 + i, (45, 37), np.uint8, True) for i in range(3)], (8, 6)),
    "rgb8": ([_image(33 + i, (29, 31, 3), np.uint8, True) for i in range(3)], (7, 5)),
    "gray16": ([_image(36 + i, (33, 27), np.uint16, True) for i in range(3)], (6, 8)),
    "rgb8 planar": ([_planar(_image(33 + i, (29, 31, 3), np.uint8, True)) for i in range(3)],
                    (7, 5)),
    "rgb16 planar": ([_planar(_image(39 + i, (21, 18, 3), np.uint16, True))
                      for i in range(3)], (8, 8)),
}


@pytest.fixture(scope="module")
def native_codec():
    import os
    import subprocess
    import sys

    from felics_tpu_torch import native

    if not native.LIB_PATH.exists():
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        subprocess.run([sys.executable, os.path.join(repo, "native", "build.py")],
                       check=True)
    return native


def _until_replayed(fn, direction, calls=6):
    """fn()'s results over calls until one of them replayed a graph of
    ``direction`` (a key runs eagerly at its first sighting, and a hint that
    moves after the first call makes a new key); fails past ``calls``."""
    from felics_tpu_torch.parallel import graphs

    outs = []
    for _ in range(calls):
        before = graphs.REPLAYS[direction]
        outs.append(fn())
        if graphs.REPLAYS[direction] > before:
            return outs
    raise AssertionError(f"no {direction} graph replayed in {calls} calls")


@pytest.mark.cuda
@pytest.mark.parametrize("cls", list(GRAPH_CLASSES))
def test_cuda_graph_replay_equals_eager_chain_and_native(cuda, native_codec, cls):
    """The batched pair and the per-image pair replay graphs from a key's
    second sighting: every container equals the eager chain's and the
    native codec's, every decode is exact, and K1 and K2 count their runs
    inside the replays."""
    from felics_tpu_torch.parallel import graphs

    images, (th, tw) = GRAPH_CLASSES[cls]
    tc = TileConfig(th, tw)
    headers = [header_for_array(im) for im in images]
    eager = tiling.encode_finish(tiling.encode_dispatch(images, headers, th, tw, True, cuda))
    assert eager == [native_codec.compress_tiled(im, hd, tw, th)
                     for im, hd in zip(images, headers)]
    k1 = tcd.ENCODE_LAUNCHES
    for blobs in _until_replayed(lambda: batch.compress_tiled_batch(images, tc, device=cuda),
                                 "encode"):
        assert blobs == eager
    assert tcd.ENCODE_LAUNCHES > k1
    k2 = tcd.DECODE_LAUNCHES
    for outs in _until_replayed(lambda: batch.decompress_tiled_batch(eager, device=cuda),
                                "decode"):
        for im, out in zip(images, outs):
            assert out.dtype == im.dtype and np.array_equal(out, im)
    assert tcd.DECODE_LAUNCHES > k2
    for blob in _until_replayed(lambda: tiling.compress_tiled_bytes(images[0], tc, device=cuda),
                                "encode"):
        assert blob == eager[0]
    for out in _until_replayed(lambda: tiling.decompress_tiled_bytes(eager[0], device=cuda),
                               "decode"):
        assert np.array_equal(out, images[0])
    assert all(g.key.direction in ("encode", "decode") for g in graphs.cache(cuda).graphs)


@pytest.mark.cuda
def test_cuda_graph_slots_with_one_key_keep_their_own_data(cuda, native_codec):
    """A depth-2 stream of four batches of one shape, each of other images:
    two batches in flight under one key replay two graphs, and every batch
    gets its own containers and images back."""
    from felics_tpu_torch.parallel import graphs

    tc = TileConfig(8, 8)
    batches = [[_image(40 + 2 * b + i, (40, 24), np.uint8, bool(b % 2)) for i in range(2)]
               for b in range(4)]
    want = [[native_codec.compress_tiled(im, header_for_array(im), 8, 8) for im in b]
            for b in batches]
    for _ in range(3):
        assert batch.compress_tiled_stream(iter(batches), tc, depth=2, device=cuda) == want
        outs = batch.decompress_tiled_stream(iter(want), depth=2, device=cuda)
        for b, o in zip(batches, outs):
            assert all(np.array_equal(x, y) for x, y in zip(b, o))
    for direction in ("encode", "decode"):
        keys = [g.key for g in graphs.cache(cuda).graphs
                if g.key.direction == direction and g.key.dims == ((40, 24),) * 2]
        assert max(keys.count(k) for k in keys) >= 2, direction


@pytest.mark.cuda
def test_cuda_graph_corrupt_payload_flags_like_eager(cuda):
    """A same-shape batch with one member's payload zeroed (pixels soon
    below 0): the graph replay gives the eager chain's validity flags and
    images, and the isolating batched call keeps the error in its place."""
    from felics_tpu_torch import errors

    images, (th, tw) = GRAPH_CLASSES["gray8"]
    blobs = batch.compress_tiled_batch(images, TileConfig(th, tw), device=cuda)
    hd = flct.read_tiled_header(blobs[1])
    bad = bytearray(blobs[1])
    bad[hd.payload_off :] = bytes(len(bad) - hd.payload_off)
    datas = [blobs[0], bytes(bad), blobs[2]]
    headers = [flct.read_tiled_header(d) for d in datas]
    payloads = [tiling.payload_of(d, h) for d, h in zip(datas, headers)]
    want_imgs, want_ok = tiling.decode_finish(tiling.decode_dispatch(headers, payloads, cuda))
    assert want_ok.tolist() == [True, False, True]
    for imgs, ok in _until_replayed(lambda: tiling.decode_finish(
            tiling.decode_group_dispatch(headers, payloads, cuda)), "decode"):
        assert ok.tolist() == want_ok.tolist()
        assert all(np.array_equal(a, b) for a, b in zip(imgs, want_imgs))
    for outs in _until_replayed(lambda: batch.decompress_tiled_batch(
            datas, device=cuda, on_error="isolate"), "decode"):
        assert isinstance(outs[1], errors.InvalidValue)
        assert np.array_equal(outs[0], images[0]) and np.array_equal(outs[2], images[2])


@pytest.mark.cuda
def test_cuda_graph_dispatch_does_not_wait_on_replay(cuda):
    """Once a key's graph exists, its dispatch half (the static buffers'
    fill, the upload, the replay, the copy back and the event) runs under
    torch.cuda.set_sync_debug_mode("error"), and its finish half gives the
    eager bytes and images."""
    from felics_tpu_torch.parallel import graphs

    images, (th, tw) = GRAPH_CLASSES["rgb8"]
    tc = TileConfig(th, tw)
    blobs = _until_replayed(lambda: batch.compress_tiled_batch(images, tc, device=cuda),
                            "encode")[-1]
    _until_replayed(lambda: batch.decompress_tiled_batch(blobs, device=cuda), "decode")
    torch.cuda.synchronize()
    replays = dict(graphs.REPLAYS)
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):  # the mode is live
            int(torch.ones(1, device=cuda).sum())
        enc = batch._encode_dispatch(images, tc, cuda)
        dec = batch._decode_dispatch(blobs, cuda, False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert graphs.REPLAYS == {"encode": replays["encode"] + 1,
                              "decode": replays["decode"] + 1}
    assert batch._encode_finish(enc) == blobs
    for im, out in zip(images, batch._decode_finish(dec, cuda, False)):
        assert out.dtype == im.dtype and np.array_equal(out, im)


def _overwritten(batches):
    """``bytearray`` copies of each batch's containers, zeroed as soon as
    the consumer asks for the next batch: a stream has dispatched the batch
    by then, and may not have finished it."""
    for b in batches:
        copies = [bytearray(d) for d in b]
        yield copies
        for c in copies:
            c[:] = bytes(len(c))


@pytest.mark.cuda
def test_cuda_decode_stage_copies_before_dispatch_returns(cuda):
    """gray16 at tile 32, 4 a call, and a depth-2 stream of gray8 chunks of
    3 at tile 64 replay their decode graphs and give the eager chain's and
    the CPU's images, from ``bytearray`` containers zeroed right after each
    dispatch returns: the stage's one copy of each payload is made by
    then."""
    g16 = [_image(50 + i, (96, 128), np.uint16, True) for i in range(4)]
    g8 = [[_image(60 + 3 * b + i, (128, 192), np.uint8, bool(i % 2)) for i in range(3)]
          for b in range(4)]
    blobs16 = batch.compress_tiled_batch(g16, TileConfig(32, 32), device=cuda)
    blobs8 = [batch.compress_tiled_batch(b, TileConfig(64, 64), device=cuda) for b in g8]
    headers = [flct.read_tiled_header(d) for d in blobs16]
    eager, ok = tiling.decode_finish(tiling.decode_dispatch(
        headers, [tiling.payload_of(d, hd) for d, hd in zip(blobs16, headers)], cuda))
    assert ok.all()
    for want, got in zip(g16, batch.decompress_tiled_batch(blobs16, device=CPU)):
        assert np.array_equal(got, want)

    def dispatch_then_overwrite():
        copies = [bytearray(d) for d in blobs16]
        state = batch._decode_dispatch(copies, cuda, False)
        for c in copies:
            c[:] = bytes(len(c))
        return batch._decode_finish(state, cuda, False)

    for outs in _until_replayed(dispatch_then_overwrite, "decode"):
        assert all(np.array_equal(o, e) for o, e in zip(outs, eager))
    cpu8 = [batch.decompress_tiled_batch(b, device=CPU) for b in blobs8]
    assert all(np.array_equal(o, im) for c, b in zip(cpu8, g8) for o, im in zip(c, b))
    for outs in _until_replayed(lambda: batch.decompress_tiled_stream(
            _overwritten(blobs8), depth=2, device=cuda), "decode"):
        for got, want in zip(outs, cpu8):
            assert all(np.array_equal(o, w) for o, w in zip(got, want))


@pytest.mark.cuda
def test_cuda_graph_cache_hands_evicted_pools_back(cuda, native_codec):
    """Under a bound of one byte, batches of 1..6 images of one shape (one
    key each) capture and replay in turn, each capture evicting the graphs
    before it: every eviction's pools are handed back at once, and every
    container equals the native codec's."""
    from felics_tpu_torch.parallel import graphs

    cache = graphs.cache(cuda)
    images = [_image(60 + i, (96, 80), np.uint8, bool(i % 2)) for i in range(6)]
    want = [native_codec.compress_tiled(im, header_for_array(im), 8, 8) for im in images]
    saved, releases, cache.max_bytes = cache.max_bytes, cache.releases, 1
    try:
        for n in range(1, len(images) + 1):
            for blobs in _until_replayed(lambda: batch.compress_tiled_batch(
                    images[:n], TileConfig(8, 8), device=cuda), "encode"):
                assert blobs == want[:n]
                assert cache.dropped == 0 and len(cache.graphs) <= 1
        assert cache.releases - releases >= len(images) - 1
    finally:
        cache.max_bytes = saved


# Groups whose graph replays under a capacity hint of one word: gray8 at
# the ingest benchmark's shape and tile, gray16 and rgb8 at tile 32.
REDO_CLASSES = {
    "gray8 t64 12x512": ([_image(90 + i, (512, 512), np.uint8, True) for i in range(12)], 64),
    "gray16 t32": ([_image(110 + i, (256, 256), np.uint16, True) for i in range(3)], 32),
    "rgb8 t32": ([_image(120 + i, (256, 256, 3), np.uint8, bool(i % 2))
                  for i in range(3)], 32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("cls", list(REDO_CLASSES))
def test_cuda_graph_capacity_redo_equals_eager_and_cpu(cuda, monkeypatch, cls):
    """Once a group's key has been captured, the capacity hint is cut to one
    word: the new key's graph compacts the payload into 4 bytes, and every
    call's finish compacts it again at the exact size. Replayed, eager and
    CPU containers are identical."""
    from felics_tpu_torch.parallel import graphs

    images, t = REDO_CLASSES[cls]
    tc = TileConfig(t, t)
    want = batch.compress_tiled_batch(images, tc, device=CPU)
    headers = [header_for_array(im) for im in images]
    for blobs in _until_replayed(lambda: batch.compress_tiled_batch(images, tc, device=cuda),
                                 "encode"):
        assert blobs == want
    monkeypatch.setattr(tiling, "payload_cap_hint", lambda cfg, nt, t, c: 1)
    redos = tiling.REDOS["capacity"]
    eager = tiling.encode_finish(tiling.encode_dispatch(images, headers, t, t, True, cuda))
    assert eager == want and tiling.REDOS["capacity"] == redos + 1
    replayed = _until_replayed(lambda: batch.compress_tiled_batch(images, tc, device=cuda),
                               "encode")
    assert all(blobs == want for blobs in replayed)
    assert tiling.REDOS["capacity"] == redos + 1 + len(replayed)
    assert any(g.key.direction == "encode" and g.key.cap == 1
               for g in graphs.cache(cuda).graphs)


@pytest.mark.cuda
def test_cuda_graph_path_spans_stay_host_events(cuda):
    """A profiled graph-path encode and decode of 12 gray8 512x512 images at
    tile 64 (keys captured first) records the port's spans as host events
    only: no device event carries a ``felics.`` name, since no span encloses
    an upload, a replay or a copy back. A trace reader that files every
    CUDA-typed event as device work then never counts a span."""
    from torch.profiler import ProfilerActivity, profile

    from felics_tpu_torch.parallel import graphs

    images = [_image(80 + i, (512, 512), np.uint8, True) for i in range(12)]
    tc = TileConfig(64, 64)
    blobs = _until_replayed(lambda: batch.compress_tiled_batch(images, tc, device=cuda),
                            "encode")[-1]
    _until_replayed(lambda: batch.decompress_tiled_batch(blobs, device=cuda), "decode")
    replays = dict(graphs.REPLAYS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        again = batch.compress_tiled_batch(images, tc, device=cuda)
        outs = batch.decompress_tiled_batch(blobs, device=cuda)
    assert graphs.REPLAYS == {"encode": replays["encode"] + 1,
                              "decode": replays["decode"] + 1}
    assert again == blobs and all(np.array_equal(o, im) for o, im in zip(outs, images))
    events = list(prof.events())
    spans = [e for e in events if e.name.startswith("felics.")]
    assert {e.name for e in spans} == {
        "felics.stage.group", "felics.stage.key", "felics.stage.fill", "felics.wait",
        "felics.finish.strip", "felics.finish.pack", "felics.finish.copy_out"}
    assert all(e.device_type.name == "CPU" for e in spans)
    assert any(e.device_type.name == "CUDA" for e in events)  # the device was traced


# ---------------------------------------------------------------------------
# K5, the k0/prior pass (csrc/flct_k0_prior.cu) against its plain version
# (tiling.k0_prior_ref). tests/test_torch_onepass.py holds the plain version
# to felics_tpu's compute_k0_prior_jax on the same cases (K5_CASES), so the
# kernel equals the reference through it.
# ---------------------------------------------------------------------------


def _checkerboard16(side):
    """0 and 65535 alternating: at tile 16 every pixel off a tile's top row
    and left column lies 65535 out of range, and a 208x208 image's bucket-0
    sums at k = 0 pass 2^31."""
    return ((np.arange(side)[:, None] + np.arange(side)[None, :]) % 2 * 65535).astype(np.uint16)


def _ramp(step):
    return np.tile((np.arange(16) * step).astype(np.uint8), (4, 1))


# name: (images, tile). Images of one case share a tile; different shapes
# give different tile counts (the eager path's uploaded owners).
K5_CASES = {
    "gray8 t64": ([_image(140 + i, (128, 192), np.uint8, True) for i in range(2)], (64, 64)),
    "gray8 t32": ([_image(142 + i, (96, 64), np.uint8, bool(i % 2)) for i in range(3)],
                  (32, 32)),
    "rgb8 t32": ([_image(145 + i, (64, 96, 3), np.uint8, bool(i % 2)) for i in range(2)],
                 (32, 32)),
    "gray16 t32 K=15": ([_image(147 + i, (64, 64), np.uint16, bool(i % 2)) for i in range(2)],
                        (32, 32)),
    "rgb16 t16 K=15": ([_image(149, (32, 48, 3), np.uint16, False)], (16, 16)),
    "gray16 sums past 2^31": ([_checkerboard16(208)], (16, 16)),
    # residual 0 in bucket 1 (k0 = 0); residual 2 in bucket 2, a tie of k =
    # 0, 1, 2 that goes to 2; every other bucket empty (K - 1)
    "ties and empty buckets": ([_ramp(1), _ramp(3)], (4, 16)),
    "flat: every bucket empty": ([np.full((24, 24), v, np.uint8) for v in (0, 200)], (8, 8)),
    "mixed tile counts": ([_image(150, (40, 40), np.uint8, True),
                           _image(151, (72, 24), np.uint8, False),
                           _image(152, (16, 16), np.uint8, True)], (16, 16)),
    "gray8 t256": ([_image(153 + i, (256, 512), np.uint8, True) for i in range(2)],
                   (256, 256)),
    "odd tile 5x3": ([_image(155, (13, 9), np.uint8, False)], (5, 3)),
}


def k5_inputs(name, device):
    """(tiles, counts, th, tw, cfg) of a K5 case, tiled as the eager chain
    tiles a group (image by image when the shapes differ)."""
    images, (th, tw) = K5_CASES[name]
    cfg = tiled_config_for_depth(header_for_array(images[0]).pixel_depth)
    tiles = torch.cat([tiling.image_tiles(upload_image(im, device)[None], th, tw)
                       for im in images])
    counts = [int(np.prod(TileConfig(th, tw).grid(*im.shape[:2]))) for im in images]
    return tiles, counts, th, tw, cfg


def _int32_extremes(device):
    """Uniform int32 planes: residuals past 2^27, so K5 sums warps in 16-bit
    halves; outside what an image gives, and outside the reference's
    16-bit split sums."""
    rng = np.random.default_rng(13)
    tiles = rng.integers(-(1 << 31), 1 << 31, (4, 3, 64), dtype=np.int64).astype(np.int32)
    return torch.from_numpy(tiles).to(device), [2, 2], 8, 8, tiled_config_for_depth(
        PixelDepth.SIXTEEN)


def test_k0_prior_on_cpu_runs_the_plain_version():
    tiles, counts, th, tw, cfg = k5_inputs("mixed tile counts", CPU)
    before = tcd.PRIOR_LAUNCHES
    k0, prior = tiling.k0_prior(tiles, counts, th, tw, cfg)
    want_k0, want_prior = tiling.k0_prior_ref(tiles, counts, th, tw, cfg)
    assert tcd.PRIOR_LAUNCHES == before
    assert torch.equal(k0, want_k0) and torch.equal(prior, want_prior)
    assert k0.shape == (3, 1, 6) and prior.shape == (tiles.shape[0], 1, 6, cfg.num_k)


K5_BAD_ARGS = {
    "int64 tiles": (lambda t, c: (t.long(), c), "int32"),
    "rank 2": (lambda t, c: (t[:, 0], c), "int32"),
    "counts short of the tiles": (lambda t, c: (t, c[:-1]), "do not split"),
    "counts past the tiles": (lambda t, c: (t, c + [1]), "do not split"),
    "a negative count": (lambda t, c: (t, [c[0] + 1, -1] + c[2:]), "do not split"),
    "plane of another tile size": (lambda t, c: (t[..., :-1], c), "pixels"),
}


@pytest.mark.parametrize("case", list(K5_BAD_ARGS))
def test_k0_prior_checks_its_arguments_first(case):
    """The wrapper's checks raise before the plain version or the kernel
    runs, and count no launch."""
    tiles, counts, th, tw, cfg = k5_inputs("mixed tile counts", CPU)
    bad, match = K5_BAD_ARGS[case]
    tiles, counts = bad(tiles, counts)
    before = tcd.PRIOR_LAUNCHES
    with pytest.raises(ValueError, match=match):
        tiling.k0_prior(tiles, counts, th, tw, cfg)
    assert tcd.PRIOR_LAUNCHES == before


def test_k0_prior_plain_version_on_int32_extremes():
    """The plain version's int64 sums on planes no image gives: every
    coded pixel's Rice lengths summed by hand, in Python ints."""
    tiles, counts, th, tw, cfg = _int32_extremes(CPU)
    k0, prior = tiling.k0_prior(tiles, counts, th, tw, cfg)
    from felics_tpu_torch.core.context import neighbour_indices

    a, b = neighbour_indices(th, tw)
    K, x = cfg.num_k, tiles.numpy().astype(np.int64)
    sums = np.zeros((2, 3, 6, K), dtype=object)
    for tile in range(4):
        for c in range(3):
            p = x[tile, c]
            for j in range(2, th * tw):
                lo, hi = min(p[a[j]], p[b[j]]), max(p[a[j]], p[b[j]])
                if lo <= p[j] <= hi:
                    continue
                res = int(lo - p[j] - 1 if p[j] < lo else p[j] - hi - 1)
                q = min(int(hi - lo).bit_length(), 5)
                sums[tile // 2, c, q] += [(res >> k) + k + 1 for k in range(K)]
    want = np.array([[[max(k for k in range(K) if r[k] == min(r)) for r in cb] for cb in im]
                     for im in sums])
    assert np.array_equal(k0.numpy(), want)
    assert np.array_equal(prior.numpy(),
                          flct.PRIOR_WEIGHT * np.abs(np.arange(K) - want[[0, 0, 1, 1], ..., None]))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(K5_CASES) + ["int32 extremes (wide warp sums)"])
def test_cuda_k0_prior_matches_plain_version(cuda, name):
    """K5 on the card equals the plain version on the CPU, k0 and every
    tile's prior, in two launches (the sums, then the pick)."""
    if name in K5_CASES:
        tiles, counts, th, tw, cfg = k5_inputs(name, CPU)
    else:
        tiles, counts, th, tw, cfg = _int32_extremes(CPU)
    want_k0, want_prior = tiling.k0_prior(tiles, counts, th, tw, cfg)
    before = tcd.PRIOR_LAUNCHES
    k0, prior = tiling.k0_prior(tiles.to(cuda), counts, th, tw, cfg)
    torch.cuda.synchronize()
    assert tcd.PRIOR_LAUNCHES == before + 2
    assert k0.device.type == prior.device.type == "cuda"
    assert k0.dtype == prior.dtype == torch.int32
    assert torch.equal(k0.cpu(), want_k0) and torch.equal(prior.cpu(), want_prior)


@pytest.mark.cuda
def test_cuda_graph_replay_counts_k5_inside(cuda):
    """An encode group's eager chain launches K5 twice and K1 once; its
    graph captures them, and each replay adds the same to the counts."""
    from felics_tpu_torch.parallel import graphs

    images = [_image(160 + i, (96, 96), np.uint8, True) for i in range(3)]
    tc = TileConfig(32, 32)
    want = batch.compress_tiled_batch(images, tc, device=CPU)
    counts = tcd.PRIOR_LAUNCHES, tcd.ENCODE_LAUNCHES
    eager = tiling.EAGER["encode"]
    assert batch.compress_tiled_batch(images, tc, device=cuda) == want
    assert tiling.EAGER["encode"] == eager + 1
    assert (tcd.PRIOR_LAUNCHES, tcd.ENCODE_LAUNCHES) == (counts[0] + 2, counts[1] + 1)
    _until_replayed(lambda: batch.compress_tiled_batch(images, tc, device=cuda), "encode")
    counts = tcd.PRIOR_LAUNCHES, tcd.ENCODE_LAUNCHES
    replays = graphs.REPLAYS["encode"]
    assert batch.compress_tiled_batch(images, tc, device=cuda) == want
    assert graphs.REPLAYS["encode"] == replays + 1
    assert (tcd.PRIOR_LAUNCHES, tcd.ENCODE_LAUNCHES) == (counts[0] + 2, counts[1] + 1)
