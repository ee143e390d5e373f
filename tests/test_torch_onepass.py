"""The port's counterparts of felics_tpu's single-dispatch FLCT chains
(felics_tpu_torch/parallel/tiling.py, graphs.py) against the JAX package,
on the CPU with the plain PyTorch versions of the kernels:

* the one-pass k0/prior against ``compute_k0_prior_jax``, also on the cases
  tests/test_torch_flct_cuda.py holds kernel K5 to this plain version on;
* the batched assembly against the per-image one and the reference's
  vmapped ``_assemble_image_body``;
* the eager same-shape encode chain against ``_fused_encode_chain_images``
  and the decode chain against ``_fused_decode_images_chain``, both with
  Pallas in interpret mode, and the graph branch of the group dispatch
  against both, a stub in place of the capture running the same body;
* the input layouts (fill, then the body's views) and the plan's one read
  of the hints a group;
* the graph cache's bookkeeping, with stubs in place of the capture.

Tolerance zero: payload bytes, bit counts, k values, pixels and flags are
integers.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from felics_tpu.config import tiled_config_for_depth as ref_config
from felics_tpu.ops import pallas_codec as pc
from felics_tpu.ops.kscan_tiled import num_buckets as ref_num_buckets
from felics_tpu.parallel import tiling as ref
from felics_tpu_torch.config import TileConfig, tiled_config_for_depth
from felics_tpu_torch.device import as_pixels, pack, upload_image
from felics_tpu_torch.format import PixelDepth, header_for_array
from felics_tpu_torch.ops import tile_codec as tcd
from felics_tpu_torch.parallel import flct, graphs, tiling
from test_torch_flct_cuda import K5_CASES, k5_inputs

CPU = torch.device("cpu")
torch.set_num_threads(1)


def _smooth(rng, shape, dtype, step):
    hi = np.iinfo(dtype).max
    img = np.cumsum(np.cumsum(rng.integers(-step, step + 1, shape), 0), 1) + hi // 2
    return np.clip(img, 0, hi).astype(dtype)


def _depth(dtype):
    return PixelDepth.EIGHT if dtype == np.uint8 else PixelDepth.SIXTEEN


def _tiles(images, th, tw):
    return tiling.image_tiles(
        torch.stack([upload_image(im, CPU) for im in images]), th, tw)


def _ref_k0_prior(tiles, n, th, tw, depth):
    cfg = ref_config(depth)
    img = np.repeat(np.arange(n, dtype=np.int32), tiles.shape[0] // n)
    k0, prior = ref.compute_k0_prior_jax(
        jnp.asarray(tiles.numpy()), jnp.asarray(img), th, tw, cfg,
        ref_num_buckets(cfg), n)
    return np.asarray(k0), np.asarray(prior)


# ---------------------------------------------------------------------------
# k0 / prior
# ---------------------------------------------------------------------------

# name, images (3 a batch), tile
K0_CASES = [
    ("gray8", [_smooth(np.random.default_rng(s), (21, 19), np.uint8, 6)
               for s in range(3)], (8, 6)),
    ("rgb8", [_smooth(np.random.default_rng(10 + s), (13, 17, 3), np.uint8, 9)
              for s in range(3)], (5, 7)),
    ("gray16", [_smooth(np.random.default_rng(20 + s), (19, 14), np.uint16, 800)
                for s in range(3)], (6, 5)),
    # flat images: every bucket's sums are 0 (a tie over all k) or empty
    ("gray8 flat", [np.full((12, 12), v, np.uint8) for v in (0, 77, 255)], (4, 4)),
]


@pytest.mark.parametrize("name,images,tile", K0_CASES, ids=[c[0] for c in K0_CASES])
def test_k0_prior_matches_compute_k0_prior_jax(name, images, tile):
    th, tw = tile
    depth = _depth(images[0].dtype)
    tiles = _tiles(images, th, tw)
    per = tiles.shape[0] // len(images)
    k0, prior = tiling.k0_prior(tiles, [per] * len(images), th, tw,
                                tiled_config_for_depth(depth))
    want_k0, want_prior = _ref_k0_prior(tiles, len(images), th, tw, depth)
    assert np.array_equal(k0.numpy(), want_k0)
    assert np.array_equal(prior.numpy(), want_prior)
    if name == "gray8 flat":  # no pixel out of range: the largest k everywhere
        assert (k0.numpy() == tiled_config_for_depth(depth).num_k - 1).all()


def test_k0_prior_16_bit_sums_past_2_31():
    """A 208x208 gray16 checkerboard of 0 and 65535 at tile 16: a pixel off
    a tile's top row and left column has both neighbours (left, above) of
    the other colour, so it lies 65535 out of range, in bucket 0, at a k = 0
    cost of 65535; 169 tiles of 225 such pixels sum to ~2.49e9, past 2^31.
    The int64 sums keep it exact, as the reference's split sums do; then
    the same tiles as two images of unequal tile counts (the uploaded owner
    index)."""
    h = w = 208
    board = ((np.arange(h)[:, None] + np.arange(w)[None, :]) % 2 * 65535).astype(np.uint16)
    tiles = _tiles([board], 16, 16)
    cfg = tiled_config_for_depth(PixelDepth.SIXTEEN)
    nt = tiles.shape[0]
    k0, prior = tiling.k0_prior(tiles, [nt], 16, 16, cfg)
    want_k0, want_prior = _ref_k0_prior(tiles, 1, 16, 16, PixelDepth.SIXTEEN)
    assert np.array_equal(k0.numpy(), want_k0)
    assert np.array_equal(prior.numpy(), want_prior)
    assert nt * 15 * 15 * 65535 > (1 << 31)
    # the same tiles split into two images of unequal tile counts
    k0_2, prior_2 = tiling.k0_prior(tiles, [nt // 3, nt - nt // 3], 16, 16, cfg)
    img = np.repeat([0, 1], [nt // 3, nt - nt // 3]).astype(np.int32)
    rk0, rprior = ref.compute_k0_prior_jax(
        jnp.asarray(tiles.numpy()), jnp.asarray(img), 16, 16,
        ref_config(PixelDepth.SIXTEEN), 6, 2)
    assert np.array_equal(k0_2.numpy(), np.asarray(rk0))
    assert np.array_equal(prior_2.numpy(), np.asarray(rprior))


def test_k0_prior_ties_go_to_the_largest_k():
    """One 4x16 tile per image, rows of a ramp: only the top row's pixels
    are out of range (above the two to their left). Steps of 1: residual
    0 in bucket 1, cost 1 + k, so k = 0. Steps of 3: residual 2 in bucket
    2, cost 3 at k = 0, 1 and 2, a tie that goes to k = 2. Every other
    bucket is empty and gets the largest k."""
    cfg = tiled_config_for_depth(PixelDepth.EIGHT)
    ramp1 = np.tile(np.arange(16, dtype=np.uint8), (4, 1))
    ramp3 = np.tile((np.arange(16) * 3).astype(np.uint8), (4, 1))
    tiles = _tiles([ramp1, ramp3], 4, 16)
    k0, prior = tiling.k0_prior(tiles, [1, 1], 4, 16, cfg)
    want_k0, want_prior = _ref_k0_prior(tiles, 2, 4, 16, PixelDepth.EIGHT)
    assert np.array_equal(k0.numpy(), want_k0)
    assert np.array_equal(prior.numpy(), want_prior)
    want = np.full((2, 1, 6), cfg.num_k - 1)
    want[0, 0, 1], want[1, 0, 2] = 0, 2
    assert np.array_equal(k0.numpy(), want)


@pytest.mark.parametrize("name", list(K5_CASES))
def test_k0_prior_matches_compute_k0_prior_jax_on_the_kernel_cases(name):
    """The cases tests/test_torch_flct_cuda.py holds K5 to its plain version
    on: the plain version equals compute_k0_prior_jax there, tile owners
    as the reference's per-tile image index."""
    tiles, counts, th, tw, cfg = k5_inputs(name, CPU)
    k0, prior = tiling.k0_prior(tiles, counts, th, tw, cfg)
    rcfg = ref_config(cfg.pixel_depth)
    img = np.repeat(np.arange(len(counts), dtype=np.int32), counts)
    want_k0, want_prior = ref.compute_k0_prior_jax(
        jnp.asarray(tiles.numpy()), jnp.asarray(img), th, tw, rcfg,
        ref_num_buckets(rcfg), len(counts))
    assert np.array_equal(k0.numpy(), np.asarray(want_k0))
    assert np.array_equal(prior.numpy(), np.asarray(want_prior))


# ---------------------------------------------------------------------------
# Batched assembly
# ---------------------------------------------------------------------------

ASSEMBLY = [("gray8", np.uint8, 1), ("rgb8", np.uint8, 3), ("gray16", np.uint16, 1),
            ("rgb16", np.uint16, 3)]


@pytest.mark.parametrize("name,dtype,c", ASSEMBLY, ids=[a[0] for a in ASSEMBLY])
def test_batched_assembly(name, dtype, c):
    """Four 11x13 images at tile 4x5 (padding in both directions): the
    batched assembly equals the per-image one and the reference's vmapped
    body with its plane check. Image 1 gets a plane value past the depth in
    its tile padding, image 2 one below the plane's least value inside
    the image, image 3 a chroma value that stays in its plane bounds but
    leaves the pixel range (RGB) or stays valid (gray)."""
    rng = np.random.default_rng(len(name))
    shape = (11, 13) + ((3,) if c == 3 else ())
    images = [rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
              for _ in range(4)]
    th, tw = 4, 5
    bufs = _tiles(images, th, tw).clone()
    bound = np.iinfo(dtype).max
    lo = 0 if c == 1 else -bound
    per = bufs.shape[0] // 4
    tx = -(-13 // tw)
    corner = per + (tx - 1)  # image 1's top-right tile: columns 13..14 are padding
    bufs[corner, 0, tw - 1] = bound + 1
    bufs[2 * per, 0, 3] = lo - 1
    bufs[3 * per, c - 1, 0] = bound if c == 3 else 7
    h0 = header_for_array(images[0])
    hd = flct.TiledHeader(h0.color_type, h0.pixel_depth, 13, 11, tw, th, per,
                          np.zeros(per, np.int64))
    plan = tiling.decode_plan([hd] * 4, np.zeros(4 * per, np.int64))
    out, valid = tiling.assemble_images(bufs, plan)
    one = [tiling.assemble_images(bufs[i * per : (i + 1) * per],
                                  tiling.decode_plan([hd], hd.tile_lengths))
           for i in range(4)]
    assert torch.equal(out, torch.cat([o for o, _ in one]))
    assert valid.tolist() == [bool(v) for _, v in one]
    assert valid.tolist()[:3] == [True, False, False]
    assert valid.tolist()[3] == (c == 1)
    assert np.array_equal(out[0].numpy(), images[0].astype(np.int32))
    ty = -(-11 // th)
    rb = jnp.asarray(bufs.numpy()).reshape(4, ty * tx, c, th * tw)
    ref_out, ref_valid = jax.vmap(lambda b: ref._assemble_image_body(
        b, th, tw, c, ty, tx, 11, 13, bound))(rb)
    planes_ok = jnp.all((rb >= lo) & (rb <= bound), axis=(1, 2, 3))
    assert valid.tolist() == np.asarray(ref_valid & planes_ok).tolist()
    for o, r, ok in zip(out, np.asarray(ref_out), valid.tolist()):
        if ok:
            assert np.array_equal(o.numpy(), r.astype(np.int32))
    # the flags and narrowed images that travel to the host
    flags, *imgs = tiling.assembled(plan, bufs)
    assert flags.tolist() == valid.tolist() and len(imgs) == 4
    assert imgs[0].dtype == (torch.uint8 if dtype == np.uint8 else torch.int16)


# ---------------------------------------------------------------------------
# The same-shape chains against the reference's single-dispatch chains
# ---------------------------------------------------------------------------

# name, two images of one odd shape, odd tile
CHAINS = [
    ("gray8", [_smooth(np.random.default_rng(30 + s), (19, 23), np.uint8, 5)
               for s in range(2)], (7, 5)),
    ("rgb8", [_smooth(np.random.default_rng(40 + s), (13, 11, 3), np.uint8, 4)
              for s in range(2)], (3, 3)),
    ("gray16", [_smooth(np.random.default_rng(50 + s), (17, 9), np.uint16, 300)
                for s in range(2)], (6, 3)),
]


@pytest.fixture(autouse=True)
def _fresh_jax_caches():
    jax.clear_caches()
    yield


def _chain_results(p):
    """(bit counts, payload bytes as compacted on the device, k0) of a
    dispatched group, after checking that the hints held (no redo)."""
    bits, total, pay, k0 = (a.copy() for a in p.result.wait())
    assert int(bits.max()) <= 32 * p.W and int(total[0]) <= 4 * p.plan.cap
    return bits, pay[: int(total[0])], k0


def _assert_reference_encode(images, th, tw, bits, pay, k0):
    """The chain's bit counts, payload and k0 are the reference's
    single-dispatch chain's."""
    cfg = ref_config(_depth(images[0].dtype))
    c = 3 if images[0].ndim == 3 else 1
    t = th * tw
    W = pc.encode_width_bound(cfg, t, c)
    cap = ref.payload_cap_hint(cfg, len(bits), t, c)
    r_pay, r_bits, r_k0, r_total = ref._fused_encode_chain_images(
        jnp.asarray(np.stack(images)), th, tw, cfg, ref_num_buckets(cfg), len(images),
        W, cap, True, c == 3)
    assert np.array_equal(bits, np.asarray(r_bits).astype(np.int64))
    assert np.array_equal(k0, np.asarray(r_k0))
    # the reference compacts word-aligned and strips the pads on the host
    tile_bytes = (bits + 7) // 8
    assert bytes(pay) == ref._strip_word_alignment(
        np.asarray(r_pay)[: int(r_total)], tile_bytes)


def _reference_containers(images, th, tw):
    return [ref.compress_tiled_bytes(im, TileConfig(th, tw), engine="xla") for im in images]


@pytest.mark.parametrize("name,images,tile", CHAINS, ids=[c[0] for c in CHAINS])
def test_encode_chain_matches_fused_encode_chain_images(name, images, tile):
    th, tw = tile
    headers = [header_for_array(im) for im in images]
    p = tiling.encode_dispatch(images, headers, th, tw, True, CPU)
    _assert_reference_encode(images, th, tw, *_chain_results(p))
    # and the finish half packs the reference's containers
    assert tiling.encode_finish(p) == _reference_containers(images, th, tw)


def _decode_cases(images, th, tw):
    """The two containers, and the same pair with the second's payload
    turned to zero bytes (every pixel one below its neighbours: values
    soon below 0): (headers, payloads, the flags they decode to)."""
    blobs = [tiling.compress_tiled_bytes(im, TileConfig(th, tw), device=CPU)
             for im in images]
    hd1 = flct.read_tiled_header(blobs[1])
    bad = bytearray(blobs[1])
    bad[hd1.payload_off :] = bytes(len(bad) - hd1.payload_off)
    for datas, want_flags in ((blobs, [True, True]), ([blobs[0], bytes(bad)], [True, False])):
        headers = [flct.read_tiled_header(d) for d in datas]
        yield headers, [tiling.payload_of(d, hd) for d, hd in zip(datas, headers)], want_flags


def _assert_reference_decode(images, th, tw, headers, payloads, imgs, flags, want_flags):
    """The images and flags are the reference's single-dispatch chain's."""
    h0 = headers[0]
    cfg = ref_config(h0.pixel_depth)
    c = h0.num_channels
    lens = np.concatenate([hd.tile_lengths for hd in headers])
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    payload = b"".join(payloads)
    buf = np.frombuffer(payload.ljust(ref._bucket_bytes(len(payload)), b"\0"), np.uint8)
    prior = np.stack([flct.prior_from_k0(hd.k0, tiled_config_for_depth(h0.pixel_depth), c)
                      for hd in headers])
    prior = np.repeat(prior, h0.n_tiles, axis=0)
    ty, tx = TileConfig(th, tw).grid(h0.height, h0.width)
    wd = pc.bucket_words(int(-(-lens.max() // 4)))
    r_out, r_valid = ref._fused_decode_images_chain(
        jnp.asarray(buf), jnp.asarray(starts, jnp.int32), jnp.asarray(lens, jnp.int32),
        jnp.asarray(prior), th, tw, c, cfg, wd, len(headers), ty, tx, h0.height,
        h0.width, (1 << cfg.depth_bits) - 1, True)
    assert flags.tolist() == np.asarray(r_valid).tolist() == want_flags
    for im, got, r, ok in zip(images, imgs, np.asarray(r_out), flags):
        if ok:
            assert got.dtype == im.dtype
            assert np.array_equal(got, r) and np.array_equal(got, im)


@pytest.mark.parametrize("name,images,tile", CHAINS, ids=[c[0] for c in CHAINS])
def test_decode_chain_matches_fused_decode_images_chain(name, images, tile):
    """Both pairs of ``_decode_cases`` through the port's eager decode chain
    and the reference's single-dispatch chain: the same images and validity
    flags."""
    th, tw = tile
    for headers, payloads, want_flags in _decode_cases(images, th, tw):
        imgs, flags = tiling.decode_finish(tiling.decode_dispatch(headers, payloads, CPU))
        _assert_reference_decode(images, th, tw, headers, payloads, imgs, flags, want_flags)


class CpuGraph:
    """``graphs.capture``'s graph on the CPU: the static input buffer the
    group's fill writes, and a replay that runs the captured body on it."""

    def __init__(self, key, in_bytes, body):
        self.key, self.body, self.nbytes = key, body, in_bytes
        self.host_in = torch.zeros(in_bytes, dtype=torch.uint8)

    def replay(self):
        tensors, self.outputs = self.body(self.host_in)
        self.host_out, self.specs = pack(*tensors)
        graphs.REPLAYS[self.key[0]] += 1

    def settle(self):
        pass


@pytest.fixture
def cpu_graphs(monkeypatch):
    """Same-shape groups on the CPU through the graph branch of the group
    dispatch, with ``CpuGraph`` in place of the capture, fresh hints and
    a fresh cache."""
    cache = graphs.GraphCache(8, 1 << 40)
    monkeypatch.setattr(tcd, "_w_hints", {})
    monkeypatch.setattr(tiling, "_cap_hints", {})
    monkeypatch.setattr(tiling, "keyed", lambda plan, device: tiling.same_shape(plan.dims))
    monkeypatch.setattr(graphs, "cache", lambda device: cache)
    monkeypatch.setattr(graphs, "capture",
                        lambda key, device, in_bytes, body: CpuGraph(key, in_bytes, body))
    return cache


def _replayed(direction, dispatch, finish, calls=4):
    """The first of up to ``calls`` dispatches that replayed a graph
    (a plan runs eagerly at its first sighting, and a hint that moves after
    the first call makes a new plan); the others are finished."""
    for _ in range(calls):
        before = graphs.REPLAYS[direction]
        p = dispatch()
        if graphs.REPLAYS[direction] > before:
            return p
        finish(p)
    raise AssertionError(f"no {direction} graph replayed in {calls} calls")


@pytest.mark.parametrize("direction", ["encode", "decode", "decode corrupt"])
@pytest.mark.parametrize("name,images,tile", CHAINS, ids=[c[0] for c in CHAINS])
def test_graph_branch_matches_eager_chain_and_fused_chains(cpu_graphs, name, images, tile,
                                                           direction):
    """The group dispatch's graph branch (fill the graph's input, replay
    the captured body, copy back) gives the eager chain's results, and so
    the reference's single-dispatch chains': bit counts, payload, k0 and
    containers; images and validity flags, also of a corrupt payload."""
    th, tw = tile
    if direction == "encode":
        headers = [header_for_array(im) for im in images]
        eager = tiling.encode_dispatch(images, headers, th, tw, True, CPU)
        want = _chain_results(eager)
        p = _replayed("encode", lambda: tiling.encode_group_dispatch(
            images, headers, th, tw, True, CPU), tiling.encode_finish)
        assert isinstance(p.result, graphs.Lease)
        assert p.result.graph.key == p.plan
        got = _chain_results(p)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
        _assert_reference_encode(images, th, tw, *got)
        assert tiling.encode_finish(p) == tiling.encode_finish(eager) == \
            _reference_containers(images, th, tw)
        return
    headers, payloads, want_flags = list(_decode_cases(images, th, tw))[
        direction == "decode corrupt"]
    want_imgs, want_ok = tiling.decode_finish(tiling.decode_dispatch(headers, payloads, CPU))
    p = _replayed("decode", lambda: tiling.decode_group_dispatch(headers, payloads, CPU),
                  tiling.decode_finish)
    assert isinstance(p, graphs.Lease)
    imgs, flags = tiling.decode_finish(p)
    assert flags.tolist() == want_ok.tolist() == want_flags
    assert all(np.array_equal(a, b) for a, b in zip(imgs, want_imgs))
    _assert_reference_decode(images, th, tw, headers, payloads, imgs, flags, want_flags)


@pytest.mark.parametrize("shapes", ["same shape", "mixed shapes"])
@pytest.mark.parametrize("name,images,tile", CHAINS, ids=[c[0] for c in CHAINS])
def test_input_layouts_round_trip(name, images, tile, shapes):
    """Each direction's fill, then the body's views of the bytes it wrote:
    the images (one batch, or one an image), and the length table, the
    priors and the payload. The eager chains then give each image's
    container and image back."""
    th, tw = tile
    if shapes == "mixed shapes":
        images = [images[0], np.ascontiguousarray(images[1][:-2, 1:])]
    headers = [header_for_array(im) for im in images]
    plan = tiling.encode_plan(headers, th, tw, True)
    host = torch.empty(plan.in_bytes(), dtype=torch.uint8)
    tiling.fill_images(host.numpy(), plan, images)
    views = tiling.image_views(host, plan)
    assert len(views) == (1 if shapes == "same shape" else 2)
    got = [im for v in views for im in as_pixels(v)]
    assert all(np.array_equal(g.numpy(), im) for g, im in zip(got, images))
    blobs = tiling.encode_finish(tiling.encode_dispatch(images, headers, th, tw, True, CPU))
    assert blobs == [tiling.compress_tiled_bytes(im, TileConfig(th, tw), device=CPU)
                     for im in images]

    hds = [flct.read_tiled_header(b) for b in blobs]
    payloads = [tiling.payload_of(b, hd) for b, hd in zip(blobs, hds)]
    lens = np.concatenate([hd.tile_lengths for hd in hds])
    dplan = tiling.decode_plan(hds, lens)
    host = torch.empty(dplan.in_bytes(), dtype=torch.uint8)
    tiling.fill_containers(host.numpy(), dplan, hds, lens, payloads)
    lens_t, priors, pay = tiling.container_views(host, dplan)
    cfg = tiled_config_for_depth(hds[0].pixel_depth)
    assert np.array_equal(lens_t.numpy(), lens)
    assert np.array_equal(priors.numpy(), np.stack(
        [flct.prior_from_k0(hd.k0, cfg, hd.num_channels) for hd in hds]))
    assert len(pay) == dplan.size and bytes(pay[: int(lens.sum())]) == b"".join(payloads)
    imgs, ok = tiling.decode_finish(tiling.decode_dispatch(hds, payloads, CPU))
    assert ok.all() and all(np.array_equal(a, b) for a, b in zip(imgs, images))


def test_a_group_reads_each_hint_once(cpu_graphs, monkeypatch):
    """Over calls that run eagerly, capture and replay, each group dispatch
    reads the width hint and the capacity hint once, and its pending state,
    its graph's key and its chain take them from its plan."""
    images, (th, tw) = CHAINS[1][1], CHAINS[1][2]
    headers = [header_for_array(im) for im in images]
    reads = {"width": [], "cap": []}
    real_width, real_cap = tcd.width_hint, tiling.payload_cap_hint

    def width_hint(*a):
        reads["width"].append(real_width(*a))
        return reads["width"][-1]

    def payload_cap_hint(*a):
        reads["cap"].append(real_cap(*a))
        return reads["cap"][-1]

    monkeypatch.setattr(tcd, "width_hint", width_hint)
    monkeypatch.setattr(tiling, "payload_cap_hint", payload_cap_hint)
    encodes = []
    real_encode = tcd.encode_tiles

    def encode_tiles(*a):
        encodes.append(a[4])
        return real_encode(*a)

    monkeypatch.setattr(tcd, "encode_tiles", encode_tiles)
    replays = graphs.REPLAYS["encode"]
    for call in range(1, 5):
        p = tiling.encode_group_dispatch(images, headers, th, tw, True, CPU)
        assert len(reads["width"]) == len(reads["cap"]) == call
        assert (p.W, p.plan.W, p.plan.cap) == (reads["width"][-1], reads["width"][-1],
                                               reads["cap"][-1])
        if isinstance(p.result, graphs.Lease):
            assert p.result.graph.key == p.plan
        else:
            assert encodes[-1] == p.plan.W
        tiling.encode_finish(p)
    assert graphs.REPLAYS["encode"] > replays


def test_group_dispatch_on_the_cpu_runs_the_eager_chain(monkeypatch):
    """On the CPU no group has a key, and the group halves are the eager
    chains: the cache is never asked."""
    def no_cache(device):
        raise AssertionError("the CPU asked the graph cache")

    monkeypatch.setattr(graphs, "cache", no_cache)
    images = CHAINS[0][1]
    headers = [header_for_array(im) for im in images]
    assert not tiling.keyed(tiling.encode_plan(headers, 7, 5, True), CPU)
    p = tiling.encode_group_dispatch(images, headers, 7, 5, True, CPU)
    blobs = tiling.encode_finish(p)
    assert blobs == tiling.encode_finish(tiling.encode_dispatch(images, headers, 7, 5, True, CPU))
    th_hd = [flct.read_tiled_header(b) for b in blobs]
    lens = np.concatenate([hd.tile_lengths for hd in th_hd])
    assert not tiling.keyed(tiling.decode_plan(th_hd, lens), CPU)
    imgs, ok = tiling.decode_finish(tiling.decode_group_dispatch(
        th_hd, [tiling.payload_of(b, hd) for b, hd in zip(blobs, th_hd)], CPU))
    assert ok.all() and all(np.array_equal(a, b) for a, b in zip(imgs, images))


# ---------------------------------------------------------------------------
# The graph cache, with stubs in place of the capture
# ---------------------------------------------------------------------------


class StubGraph:
    def __init__(self, key, nbytes=10):
        self.key, self.nbytes, self.settled = key, nbytes, 0

    def settle(self):
        self.settled += 1


class Capture:
    """A capture function that makes StubGraphs and counts its calls."""

    def __init__(self):
        self.made = []

    def __call__(self, key, nbytes=10):
        def capture():
            g = StubGraph(key, nbytes)
            self.made.append(g)
            return g
        return capture


def test_cache_first_sight_is_eager_then_capture_then_replay():
    cache, cap = graphs.GraphCache(4, 1000), Capture()
    assert cache.acquire("a", cap("a")) is None  # first sight: eager
    assert cap.made == []
    lease = cache.acquire("a", cap("a"))  # second: captured
    assert [g.key for g in cap.made] == ["a"] and lease.graph is cap.made[0]
    lease.release()
    again = cache.acquire("a", cap("a"))  # then replayed, no new capture
    assert again.graph is cap.made[0] and len(cap.made) == 1
    again.release()
    assert cap.made[0].settled == 0  # released leases need no settling


def test_cache_one_graph_per_slot_in_flight():
    """Two batches in flight under one key (two stream slots) replay two
    graphs; once both are released, the two are reused in turn."""
    cache, cap = graphs.GraphCache(4, 1000), Capture()
    cache.acquire("k", cap("k"))
    slot0 = cache.acquire("k", cap("k"))
    slot1 = cache.acquire("k", cap("k"))
    assert len(cap.made) == 2 and slot0.graph is not slot1.graph
    slot0.release()
    slot2 = cache.acquire("k", cap("k"))
    assert slot2.graph is slot0.graph and len(cap.made) == 2
    slot1.release()
    slot2.release()
    assert cache.acquire("k", cap("k")).graph in cap.made and len(cap.made) == 2


def test_cache_evicts_the_least_recently_used_idle_graph():
    cache, cap = graphs.GraphCache(2, 1000), Capture()
    for k in "abc":
        cache.acquire(k, cap(k))
    a = cache.acquire("a", cap("a"))
    b = cache.acquire("b", cap("b"))
    a.release()
    b.release()
    c = cache.acquire("c", cap("c"))  # a third graph: "a", least recent, goes
    assert [g.key for g in cache.graphs] == ["b", "c"]
    b2 = cache.acquire("b", cap("b"))  # "b" is reused, not captured again
    assert b2.graph.key == "b" and len(cap.made) == 3
    # busy graphs are never evicted, even past the bound
    d = cache.acquire("d", cap("d")) or cache.acquire("d", cap("d"))
    assert {g.key for g in cache.graphs} == {"b", "c", "d"}
    for lease in (b2, c, d):
        lease.release()
    cache.acquire("e", cap("e"))
    cache.acquire("e", cap("e"))
    assert len(cache.graphs) == 2 and cache.graphs[-1].key == "e"


def test_cache_bounds_the_bytes_of_its_graphs():
    cache, cap = graphs.GraphCache(10, 100), Capture()
    leases = []
    for k in "abc":
        cache.acquire(k, cap(k, 40))
        leases.append(cache.acquire(k, cap(k, 40)))
        leases[-1].release()
    assert [g.key for g in cache.graphs] == ["b", "c"]
    assert sum(g.nbytes for g in cache.graphs) <= 100


def test_cache_hands_evicted_pools_back_within_its_bound():
    """An evicted graph's bytes count against the bound until they are
    handed back; they are handed back once they would pass it."""
    handed = []
    cache, cap = graphs.GraphCache(10, 100, release=lambda: handed.append(1)), Capture()
    for k in "ab":
        cache.acquire(k, cap(k, 40))
        cache.acquire(k, cap(k, 40)).release()
    assert cache.dropped == 0 and handed == []
    cache.acquire("c", cap("c", 40))
    cache.acquire("c", cap("c", 40)).release()  # "a" goes: 40 + 80 > 100
    assert [g.key for g in cache.graphs] == ["b", "c"]
    assert handed == [1] and cache.dropped == 0 and cache.releases == 1
    small = graphs.GraphCache(1, 1000, release=lambda: handed.append(2))
    for k in "de":
        small.acquire(k, cap(k, 40))
        small.acquire(k, cap(k, 40)).release()  # "d" goes: 40 + 40 <= 1000
    assert small.dropped == 40 and handed == [1]


def test_cache_trim_fits_a_cut_bound():
    handed = []
    cache, cap = graphs.GraphCache(10, 1000, release=lambda: handed.append(1)), Capture()
    for k in "abc":
        cache.acquire(k, cap(k, 40))
        cache.acquire(k, cap(k, 40)).release()
    busy = cache.acquire("c", cap("c", 40))
    cache.max_bytes = 50
    cache.trim()  # "a" and "b" go; "c" is busy and stays
    assert [g.key for g in cache.graphs] == ["c"]
    assert handed == [1] and cache.dropped == 0
    busy.release()


def test_cache_makes_room_before_a_capture_when_the_device_is_short():
    handed, free = [], [1000]
    cache = graphs.GraphCache(4, 800, release=lambda: handed.append(1),
                              free_bytes=lambda: free[0])
    cap = Capture()
    cache.acquire("a", cap("a", 300))
    cache.acquire("a", cap("a", 300)).release()  # 1000 free >= 800 // 8
    assert handed == [] and cache.largest == 300
    free[0] = 599  # under twice the largest graph
    cache.acquire("b", cap("b"))
    cache.acquire("b", cap("b")).release()
    assert handed == [1]
    cache.acquire("b", cap("b")).release()  # a replay captures nothing
    assert handed == [1]


def test_cache_settles_a_graph_whose_lease_was_dropped():
    """A lease dropped without release (a batch abandoned by an exception)
    frees its graph, which is waited on before it is used again."""
    cache, cap = graphs.GraphCache(4, 1000), Capture()
    cache.acquire("a", cap("a"))
    lease = cache.acquire("a", cap("a"))
    g = lease.graph
    del lease
    gc.collect()
    again = cache.acquire("a", cap("a"))
    assert again.graph is g and g.settled == 1 and len(cap.made) == 1


def test_a_moved_hint_makes_a_new_key(monkeypatch):
    """The encode plan, a same-shape group's key on CUDA, holds the width
    and capacity hints: once a wider stream or a smaller payload has been
    seen, the same group has a new key (its first sight, so eager). The
    decode plan holds the row width and the payload's bucket. Mixed shapes
    have no key."""
    images = [np.zeros((64, 64), np.uint8)] * 2
    headers = [header_for_array(im) for im in images]
    cuda = torch.device("cuda")
    monkeypatch.setattr(tcd, "_w_hints", {})
    monkeypatch.setattr(tiling, "_cap_hints", {})
    first = tiling.encode_plan(headers, 32, 32, True)
    assert tiling.keyed(first, cuda) and first == tiling.encode_plan(headers, 32, 32, True)
    assert (first.direction, first.tile_h, first.tile_w, first.num_channels,
            first.pixel_depth, first.dims) == ("encode", 32, 32, 1, PixelDepth.EIGHT,
                                               ((64, 64),) * 2)
    cfg = tiled_config_for_depth(PixelDepth.EIGHT)
    tcd.observe_width(cfg, 1024, 1, 32 * 1000)
    wider = tiling.encode_plan(headers, 32, 32, True)
    assert wider.W > first.W and wider._replace(W=first.W) == first
    tiling.observe_payload(cfg, 1024, 1, 80, 8)
    smaller = tiling.encode_plan(headers, 32, 32, True)
    assert smaller.cap < wider.cap and smaller._replace(cap=wider.cap) == wider
    mixed = [header_for_array(im) for im in (images[0], images[0][:-1])]
    assert not tiling.keyed(tiling.encode_plan(mixed, 32, 32, True), cuda)
    images = CHAINS[0][1]
    blobs = [tiling.compress_tiled_bytes(im, TileConfig(7, 5), device=CPU) for im in images]
    hds = [flct.read_tiled_header(b) for b in blobs]
    lens = np.concatenate([hd.tile_lengths for hd in hds])
    plan = tiling.decode_plan(hds, lens)
    assert tiling.keyed(plan, cuda)
    assert (plan.direction, plan.tile_h, plan.tile_w, plan.num_channels, plan.pixel_depth,
            plan.dims, plan.nt) == ("decode", 7, 5, 1, PixelDepth.EIGHT, ((19, 23),) * 2,
                                    len(lens))
    assert (plan.wd, plan.size) == (tiling.row_width(lens),
                                    tiling.payload_bucket(int(lens.sum())))
    odd = [hds[0], flct.read_tiled_header(tiling.compress_tiled_bytes(
        images[0][:-1], TileConfig(7, 5), device=CPU))]
    assert not tiling.keyed(tiling.decode_plan(odd, np.concatenate(
        [hd.tile_lengths for hd in odd])), cuda)


def test_rgb_memory_layout_leaves_the_key_alone():
    """RGB images whose samples lie plane after plane in memory (an
    (H, W, 3) view of (3, H, W) data) key their group as the interleaved
    copies do: the fill copies either layout into one (H, W, 3) input."""
    rng = np.random.default_rng(18)
    interleaved = [rng.integers(0, 256, (40, 24, 3), dtype=np.uint8) for _ in range(2)]
    planes = [np.ascontiguousarray(im.transpose(2, 0, 1)).transpose(1, 2, 0)
              for im in interleaved]
    cuda = torch.device("cuda")
    filled = []
    for images in (interleaved, planes, [planes[0], interleaved[1]]):
        plan = tiling.encode_plan([header_for_array(im) for im in images], 8, 8, True)
        assert tiling.keyed(plan, cuda)
        host = np.zeros(plan.in_bytes(), np.uint8)
        tiling.fill_images(host, plan, images)
        filled.append((plan, host.tobytes()))
    assert filled[0] == filled[1] == filled[2]
    assert filled[0][1] == np.stack(interleaved).tobytes()


def test_payload_bucket_matches_reference():
    for n in (0, 1, 4095, 4096, 4097, 10_000, 1 << 20, (1 << 20) + 1, 123_456_789):
        assert tiling.payload_bucket(n) == ref._bucket_bytes(n)
