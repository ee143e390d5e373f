"""The port's FLCS codec (felics_tpu_torch.ops.{analysis,kscan,bitpack},
felics_tpu_torch.core.codec) against the JAX reference (felics_tpu.ops.*,
felics_tpu.core.jax_codec) and the scalar oracle, on the CPU with the plain
PyTorch versions of the kernels. Inputs are made with numpy from a seed;
tolerance zero: every output is an integer and must be identical.

The CUDA kernels K3 and K4 are held to these plain versions in
tests/test_torch_flcs_cuda.py, which imports no JAX so it can run on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from felics_tpu import api as ref_api
from felics_tpu import errors
from felics_tpu.config import CONFIG_8BIT, CONFIG_16BIT
from felics_tpu.format import header_bytes
from felics_tpu.core import jax_codec
from felics_tpu.ops import analysis as ref_analysis
from felics_tpu.ops import kscan as ref_kscan
from felics_tpu_torch import api as port_api
from felics_tpu_torch import errors as port_errors
from felics_tpu_torch.convert import symbols_from_reference
from felics_tpu_torch.core import codec
from felics_tpu_torch.ops import analysis, bitpack, kscan
from felics_tpu_torch.ops.bits import words_to_bytes

CPU = torch.device("cpu")
# The plain versions run many tiny ops: intra-op threads only contend with
# the other test workers.
torch.set_num_threads(1)


def random_image(rng, width, height, dtype, channels=None):
    shape = (height, width) if channels is None else (height, width, channels)
    return rng.integers(0, np.iinfo(dtype).max + 1, size=shape).astype(dtype)


def smooth_image(rng, width, height, dtype, channels=None):
    shape = (height, width) if channels is None else (height, width, channels)
    img = np.cumsum(np.cumsum(rng.integers(-6, 7, size=shape), 0), 1) + 128
    return np.clip(img, 0, np.iinfo(dtype).max).astype(dtype)


def halving_image(seed=0):
    """tests/test_jax_codec.py::test_adversarial_halving's image: 0/255
    noise, large residuals in few contexts, heavy count scaling."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, size=(40, 40)) * 255).astype(np.uint8)


def _channels(img):
    """(C, n) int32 numpy planes of an image, as the reference makes them."""
    return np.stack(jax_codec._image_channels(img, ref_api.header_for_array(img)))


# Planes for the module-level comparisons: (name, planes, height, width, cfg).
def _plane_cases():
    rng = np.random.default_rng(11)
    return [
        ("gray8 smooth 23x17", _channels(smooth_image(rng, 17, 23, np.uint8)), 23, 17, CONFIG_8BIT),
        ("gray8 random 16x16", _channels(random_image(rng, 16, 16, np.uint8)), 16, 16, CONFIG_8BIT),
        ("gray8 halving 40x40", _channels(halving_image()), 40, 40, CONFIG_8BIT),
        ("gray16 smooth 16x16", _channels(smooth_image(rng, 16, 16, np.uint16)), 16, 16, CONFIG_16BIT),
        ("gray16 random 9x7", _channels(random_image(rng, 9, 7, np.uint16)), 7, 9, CONFIG_16BIT),
        ("rgb8 8x6", _channels(random_image(rng, 6, 8, np.uint8, 3)), 8, 6, CONFIG_8BIT),
        ("rgb16 8x6", _channels(random_image(rng, 6, 8, np.uint16, 3)), 8, 6, CONFIG_16BIT),
        ("gray8 1x50", _channels(smooth_image(rng, 50, 1, np.uint8)), 1, 50, CONFIG_8BIT),
        ("gray8 50x1", _channels(smooth_image(rng, 1, 50, np.uint8)), 50, 1, CONFIG_8BIT),
    ]


PLANE_CASES = _plane_cases()
IDS = [c[0] for c in PLANE_CASES]


@pytest.mark.parametrize("name,planes,h,w,cfg", PLANE_CASES, ids=IDS)
def test_analysis_and_symbols_match_reference(name, planes, h, w, cfg):
    port = analysis.analyze_channel(torch.from_numpy(planes), h, w)
    k_np = np.random.default_rng(2).integers(0, cfg.num_k, planes.shape)
    sym = analysis.symbolize(port, torch.from_numpy(planes), torch.from_numpy(k_np), h, w)
    for ci, chan in enumerate(planes):
        ref = ref_analysis.analyze_channel(jnp.asarray(chan), h, w)
        for field, want in zip(analysis.Analysis._fields, ref):
            got = getattr(port, field)[ci].numpy()
            assert np.array_equal(got, np.asarray(want).astype(got.dtype)), field
        ref_sym = ref_analysis.symbolize(ref, jnp.asarray(chan), jnp.asarray(k_np[ci]), h, w)
        for field, want in zip(analysis.Symbols._fields, ref_sym):
            got = getattr(sym, field)[ci].numpy()
            assert np.array_equal(got, np.asarray(want).astype(np.int64)), field


@pytest.mark.parametrize("name,planes,h,w,cfg", PLANE_CASES, ids=IDS)
def test_compute_k_matches_reference(name, planes, h, w, cfg):
    port = analysis.analyze_channel(torch.from_numpy(planes), h, w)
    k = kscan.compute_k(port.context, port.oor, port.residual, cfg)
    for ci, chan in enumerate(planes):
        ref = ref_analysis.analyze_channel(jnp.asarray(chan), h, w)
        want = np.asarray(ref_kscan.compute_k(ref.context, ref.oor, ref.residual, cfg))
        assert np.array_equal(k[ci].numpy(), want.astype(np.int64))


def test_sort_updates_matches_reference():
    _name, planes, h, w, _cfg = PLANE_CASES[0]
    port = analysis.analyze_channel(torch.from_numpy(planes), h, w)
    su = kscan.sort_updates(port.context, port.oor)
    ref = ref_analysis.analyze_channel(jnp.asarray(planes[0]), h, w)
    want = ref_kscan.sort_updates(ref.context, ref.oor)
    n_oor = int(want.num_oor)
    assert int(su.num_oor[0]) == n_oor
    assert int(su.num_contexts[0]) == int(want.num_contexts)
    assert int(su.max_rank[0]) == int(want.max_rank)
    for field in ("order", "compact", "rank"):
        got = getattr(su, field)[0].numpy()[:n_oor]
        assert np.array_equal(got, np.asarray(getattr(want, field))[:n_oor]), field


def test_all_in_range_lanes_get_the_largest_k():
    planes = np.full((2, 20), 9, np.int32)  # flat: no out-of-range pixel
    port = analysis.analyze_channel(torch.from_numpy(planes), 4, 5)
    k = kscan.compute_k(port.context, port.oor, port.residual, CONFIG_16BIT)
    assert k.tolist() == [[14] * 20] * 2


@pytest.mark.parametrize("name,planes,h,w,cfg", PLANE_CASES, ids=IDS)
def test_packer_on_reference_symbols(name, planes, h, w, cfg):
    """The reference's own symbols, packed by the port, give the payload
    the reference's encoder emits."""
    parts = [
        jax_codec.encode_channel_symbols(jnp.asarray(ch), h, w, cfg) for ch in planes
    ]
    ref_sym = jax_codec._concat_symbols(parts) if len(parts) > 1 else parts[0]
    sym = symbols_from_reference(jax.device_get(ref_sym), CPU)
    offsets, total = bitpack.symbol_offsets(sym)
    n_big = int(bitpack.count_big_symbols(sym))
    assert n_big == int(jax_codec.bitpack.count_big_symbols(ref_sym))
    nbytes = (int(total) + 7) // 8
    words = bitpack.pack_bits_scatter(sym, offsets, -(-nbytes // 4), n_big)
    payload = words_to_bytes(words)[:nbytes].numpy().tobytes()
    assert payload == jax_codec.encode_payload(list(planes), h, w, cfg)


def test_packer_long_unary_runs():
    """Runs of ones longer than 64 bits (whole words inside a run), runs
    that end on a word boundary, and empty symbols."""
    q = [0, 0, 70, 31, 33, 95, 0, 64]
    a_len = [32, 0, 2, 1, 2, 2, 1, 2]
    b_len = [32, 0, 3, 0, 1, 7, 4, 1]
    rng = np.random.default_rng(4)
    a_val = [int(rng.integers(0, 1 << n)) if n else 0 for n in a_len]
    b_val = [int(rng.integers(0, 1 << n)) if n else 0 for n in b_len]
    sym = analysis.Symbols(*(torch.tensor(v, dtype=torch.int64)
                             for v in (a_val, a_len, q, b_val, b_len)))
    bits = "".join(
        (format(a, f"0{al}b") if al else "") + "1" * qq + (format(b, f"0{bl}b") if bl else "")
        for a, al, qq, b, bl in zip(a_val, a_len, q, b_val, b_len)
    )
    bits += "0" * (-len(bits) % 32)
    want = int(bits, 2).to_bytes(len(bits) // 8, "big")
    offsets, total = bitpack.symbol_offsets(sym)
    assert int(total) == sum(a_len) + sum(q) + sum(b_len)
    n_big = int(bitpack.count_big_symbols(sym))
    words = bitpack.pack_bits_scatter(sym, offsets, len(bits) // 32, n_big)
    assert words_to_bytes(words).numpy().tobytes() == want


def _ref_scan(words_np, h, w, cfg, c):
    bufs, ends, ovs = jax.device_get(
        jax_codec._decode_images_scan(jnp.asarray(words_np), h, w, cfg, c)
    )
    return np.asarray(bufs), np.asarray(ends).astype(np.int64), np.asarray(ovs)


def _port_scan(words_np, h, w, cfg, c):
    planes, end, ov = codec.decode_scan(
        torch.from_numpy(words_np.view(np.int32)), h, w, cfg, c
    )
    return planes.numpy(), end.numpy(), ov.numpy()


@pytest.mark.parametrize("name,planes,h,w,cfg", PLANE_CASES[:7], ids=IDS[:7])
def test_decode_scan_matches_reference(name, planes, h, w, cfg):
    """Planes, end bit and overrun flag of the reference's scan, on two
    lanes: the stream and the stream with a run of flipped bytes."""
    c = planes.shape[0]
    payload = jax_codec.encode_payload(list(planes), h, w, cfg)
    corrupt = bytearray(payload)
    mid = len(corrupt) // 2
    corrupt[mid : mid + 3] = bytes(b ^ 0xA5 for b in corrupt[mid : mid + 3])
    words = codec.payload_words([payload, bytes(corrupt)])
    want = _ref_scan(words, h, w, cfg, c)
    got = _port_scan(words, h, w, cfg, c)
    for g, wv in zip(got, want):
        assert np.array_equal(g, wv)
    assert np.array_equal(got[0][0], planes)
    assert int(got[1][0]) <= len(payload) * 8 and not got[2][0]


@pytest.mark.parametrize("name,planes,h,w,cfg", PLANE_CASES, ids=IDS)
def test_scalar_decode_scan_matches_reference(name, planes, h, w, cfg):
    """The scalar plain version of K4 (Python ints, lane by lane) gives the
    reference scan's planes, end bits and overrun flags on the stream, the
    stream with flipped bytes, and all-ones words."""
    c = planes.shape[0]
    payload = jax_codec.encode_payload(list(planes), h, w, cfg)
    corrupt = bytearray(payload)
    mid = len(corrupt) // 2
    corrupt[mid : mid + 3] = bytes(b ^ 0x5A for b in corrupt[mid : mid + 3])
    words = codec.payload_words([payload, bytes(corrupt), b"\x3f" + b"\xff" * 11])
    want = _ref_scan(words, h, w, cfg, c)
    got = codec.decode_scan_scalar(torch.from_numpy(words.view(np.int32)), h, w, cfg, c)
    for g, wv in zip(got, want):
        assert np.array_equal(g.numpy(), wv)
    assert np.array_equal(got[0][0].numpy(), planes)


@pytest.mark.parametrize("depth_cfg", [CONFIG_8BIT, CONFIG_16BIT], ids=["8", "16"])
def test_decode_scan_of_garbage_matches_reference(depth_cfg):
    """Random and all-ones words (unary runs off the end, int32 wrap-around
    in values and tables) decode to the reference's planes, end bits and
    overrun flags."""
    rng = np.random.default_rng(8)
    words = rng.integers(0, 1 << 32, (3, 6), dtype=np.uint64).astype(np.uint32)
    words[1, 2:] = 0xFFFFFFFF
    words[1, 2] = 0x3FFFFFFF  # marker '00', then ones to the end
    words[2, 3:] = 0xFFFFFFFF
    want = _ref_scan(words, 5, 7, depth_cfg, 3)
    got = _port_scan(words, 5, 7, depth_cfg, 3)
    scalar = codec.decode_scan_scalar(torch.from_numpy(words.view(np.int32)), 5, 7, depth_cfg, 3)
    for g, sc, wv in zip(got, scalar, want):
        assert np.array_equal(g, wv)
        assert np.array_equal(sc.numpy(), wv)
    assert got[2][1]  # the all-ones lane overran


DIMS = [(2, 1), (1, 2), (3, 3), (7, 4), (23, 17), (64, 64), (1, 50), (50, 1)]
RGB_DIMS = [(1, 2), (5, 3), (16, 11), (32, 32)]


def _assert_bytes_match(img):
    port = port_api.compress_image_bytes(img, device=CPU)
    assert port == ref_api.compress_image_bytes(img, backend="oracle")
    assert port == ref_api.compress_image_bytes(img, backend="jax")


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("width,height", DIMS)
def test_gray_container_bytes(width, height, dtype):
    rng = np.random.default_rng(width * 100 + height)
    for maker in (random_image, smooth_image):
        _assert_bytes_match(maker(rng, width, height, dtype))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("width,height", RGB_DIMS)
def test_rgb_container_bytes(width, height, dtype):
    rng = np.random.default_rng(width * 100 + height + 7)
    for maker in (random_image, smooth_image):
        _assert_bytes_match(maker(rng, width, height, dtype, 3))


def test_halving_container_bytes():
    _assert_bytes_match(halving_image())


@pytest.mark.parametrize("shape", [(0, 3), (3, 0), (1, 1), (0, 0), (1, 1, 3), (0, 2, 3)])
def test_degenerate_dims(shape):
    img = np.full(shape, 7, dtype=np.uint8)
    blob = codec.compress_image_bytes(img, ref_api.header_for_array(img), CPU)
    assert blob == ref_api.compress_image_bytes(img, backend="oracle")
    assert blob == ref_api.compress_image_bytes(img, backend="jax")
    out = codec.decompress_image_bytes(blob, CPU)
    assert out.shape == img.shape and out.dtype == img.dtype
    assert np.array_equal(out, img)


DECODE_CASES = [
    ((9, 7, None), np.uint8), ((16, 16, None), np.uint16), ((8, 6, 3), np.uint8),
    ((8, 6, 3), np.uint16), ((1, 50, None), np.uint8), ((50, 1, None), np.uint16),
]


@pytest.mark.parametrize("dims,dtype", DECODE_CASES)
def test_decode_round_trip(dims, dtype):
    rng = np.random.default_rng(21)
    img = smooth_image(rng, *dims[:2], dtype, dims[2])
    blob = ref_api.compress_image_bytes(img, backend="oracle")
    out = port_api.decompress_image_bytes(blob, device=CPU)
    assert out.dtype == img.dtype
    assert np.array_equal(out, img)


def _mixed(rng):
    """tests/test_batched_flcs.py's batch: two shapes share a group, gray16,
    rgb8 and rgb16."""
    def smooth(w, h, dtype=np.uint8, channels=None):
        shape = (h, w) if channels is None else (h, w, channels)
        hi = np.iinfo(dtype).max
        img = np.cumsum(np.cumsum(rng.integers(-6, 7, shape), 0), 1) + hi // 2
        return np.clip(img, 0, hi).astype(dtype)

    return [
        smooth(24, 16), smooth(24, 16), smooth(17, 9), smooth(12, 10, np.uint16),
        smooth(14, 11, channels=3), smooth(8, 8, np.uint16, channels=3),
        np.asarray([[7]], np.uint8), np.zeros((0, 5), np.uint8),
    ]


def test_batch_equals_single_images():
    images = _mixed(np.random.default_rng(1234))
    batched = codec.compress_images_bytes(images, CPU)
    for im, blob in zip(images, batched):
        assert blob == codec.compress_image_bytes(im, ref_api.header_for_array(im), CPU)
        assert blob == ref_api.compress_image_bytes(im, backend="oracle")
    outs = codec.decompress_images_bytes(batched, device=CPU)
    for im, out in zip(images, outs):
        assert out.dtype == im.dtype and np.array_equal(out, im)
    assert codec.compress_images_bytes([], CPU) == []
    assert codec.decompress_images_bytes([], device=CPU) == []


def _error_class(fn, errors_module):
    """The name of the DecompressionError subclass ``fn`` raises (either
    package's hierarchy), or None."""
    try:
        fn()
    except errors_module.DecompressionError as e:
        return type(e).__name__
    return None


def _corrupt_blobs():
    rng = np.random.default_rng(5)
    gray = smooth_image(rng, 12, 10, np.uint8)
    rgb = random_image(rng, 6, 5, np.uint8, 3)
    out = []
    for img in (gray, rgb):
        blob = ref_api.compress_image_bytes(img, backend="oracle")
        for cut in (15, 18, 22, len(blob) - 1):
            out.append(blob[:cut])
        for seed in range(4):
            data = bytearray(blob)
            for p in np.random.default_rng(seed).integers(14, len(data), 3):
                data[int(p)] ^= 0xFF
            out.append(bytes(data))
        out.append(blob + b"\x00\x07")  # trailing bytes are ignored
    out.append(b"FLCX" + blob[4:])  # bad magic
    out.append(blob[:10])  # header cut short
    return out


@pytest.mark.parametrize("idx", range(20))
def test_corrupt_containers_raise_like_reference(idx):
    blobs = _corrupt_blobs()
    assert len(blobs) == 20
    data = blobs[idx]
    want = _error_class(lambda: ref_api.decompress_image_bytes(data, backend="jax"), errors)
    got = _error_class(lambda: port_api.decompress_image_bytes(data, device=CPU), port_errors)
    assert got == want
    if want is None:
        out = port_api.decompress_image_bytes(data, device=CPU)
        ref = ref_api.decompress_image_bytes(data, backend="jax")
        assert out.dtype == ref.dtype and np.array_equal(out, ref)


def test_header_only_container_raises_io_error():
    """A container cut right after its header: the port (and the oracle)
    raise IoError; the reference's per-image jax decoder raises a bare
    IndexError on the empty word buffer."""
    img = smooth_image(np.random.default_rng(3), 5, 4, np.uint8)
    data = ref_api.compress_image_bytes(img, backend="oracle")[:14]
    with pytest.raises(port_errors.IoError):
        codec.decompress_image_bytes(data, CPU)
    with pytest.raises(errors.IoError):
        ref_api.decompress_image_bytes(data, backend="oracle")


def test_isolate_returns_errors_for_bad_members():
    rng = np.random.default_rng(9)
    imgs = [smooth_image(rng, 10, 8, np.uint8) for _ in range(3)]
    imgs.append(np.asarray([[5]], np.uint8))
    blobs = [ref_api.compress_image_bytes(im, backend="oracle") for im in imgs]
    bad = list(blobs)
    bad[1] = blobs[1][:20]  # truncated
    bad.append(b"XXXX" + blobs[0][4:])  # bad magic
    out = codec.decompress_images_bytes(bad, on_error="isolate", device=CPU)
    ref = jax_codec.decompress_images_bytes(bad, on_error="isolate")
    assert [type(o).__name__ for o in out] == [type(r).__name__ for r in ref]
    assert isinstance(out[1], port_errors.IoError)
    assert isinstance(out[4], port_errors.InvalidSignature)
    for i in (0, 2, 3):
        assert np.array_equal(out[i], imgs[i])
    with pytest.raises(port_errors.IoError):
        codec.decompress_images_bytes(bad[:4], device=CPU)
    with pytest.raises(ValueError, match="on_error"):
        codec.decompress_images_bytes(blobs, on_error="skip", device=CPU)


def test_out_of_range_values_raise_invalid_value():
    """A stream whose values decode outside the depth: InvalidValue, as the
    reference's range check raises."""
    planes = np.array([[300, 5, 7, 9]], np.int32)  # 300 does not fit 8 bits
    payload = jax_codec.encode_payload(list(planes), 2, 2, CONFIG_8BIT)
    data = header_bytes(ref_api.header_for_array(np.zeros((2, 2), np.uint8))) + payload
    with pytest.raises(errors.InvalidValue):
        ref_api.decompress_image_bytes(data, backend="jax")
    with pytest.raises(port_errors.InvalidValue):
        codec.decompress_image_bytes(data, CPU)


def test_decode_scan_argument_checks():
    w = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        codec.decode_scan(w.long(), 4, 4, CONFIG_8BIT, 1)
    with pytest.raises(ValueError, match=">= 2 pixels"):
        codec.decode_scan(w, 1, 1, CONFIG_8BIT, 1)
    with pytest.raises(ValueError, match="channels"):
        codec.decode_scan(w, 4, 4, CONFIG_8BIT, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        codec.decode_scan(w.to("meta"), 4, 4, CONFIG_8BIT, 1)
