"""The port's FLCT serving calls against the JAX reference, on the CPU with
the plain PyTorch versions of the kernels: the pipelined stream pair
(``compress_tiled_stream`` / ``decompress_tiled_stream``), per-member error
isolation (``on_error="isolate"``), the dispatch/finish split's two redo
paths, K2's choice of position width, the native FLCT decoder binding and
the package surface. The same numpy-seeded inputs go to the port
(``device="cpu"``) and to the reference (``engine="xla"``); tolerance zero
(bytes and pixels), and exception classes are compared by name.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import felics_tpu
import felics_tpu_torch as ft
from felics_tpu import format as ref_format
from felics_tpu.config import TileConfig
from felics_tpu.parallel import batch as ref_batch
from felics_tpu_torch import errors, native
from felics_tpu_torch.core.context import neighbour_indices
from felics_tpu_torch.device import HostCopy, neighbours, upload
from felics_tpu_torch.ops import tile_codec as tcd
from felics_tpu_torch.parallel import batch, tiling

CPU = "cpu"
TC = TileConfig(8, 8)
ISO_TC = TileConfig(16, 16)  # tests/test_isolation.py's tile
# The plain versions run many tiny ops: intra-op threads only contend with
# the other test workers.
torch.set_num_threads(1)


def _image(shape, dtype, seed, smooth=True):
    rng = np.random.default_rng(seed)
    hi = np.iinfo(dtype).max
    if smooth:
        img = np.cumsum(np.cumsum(rng.integers(-6, 7, shape), 0), 1) + hi // 2
        return np.clip(img, 0, hi).astype(dtype)
    return rng.integers(0, hi + 1, shape).astype(dtype)


# ---------------------------------------------------------------------------
# The stream pair
# ---------------------------------------------------------------------------

def _gray8_pairs(seed):
    return [[_image((16, 16), np.uint8, seed + 2 * i),
             _image((16, 16), np.uint8, seed + 2 * i + 1, False)] for i in range(3)]


# Each case's batches share one shape, so the reference compiles its chain
# once per case.
STREAMS = {
    "gray8": _gray8_pairs(1),
    "rgb16": [[_image((8, 8, 3), np.uint16, 7 + i, i % 2 == 0)] for i in range(2)],
    # Four geometries in one batch (a gray8 image that clamps the tile to
    # 5x8, rgb8, gray16), then a batch of one. The reference's stream takes
    # one depth and colour a batch: here the per-image call is the yardstick.
    "mixed": [
        [_image((16, 16), np.uint8, 8), _image((5, 19), np.uint8, 9),
         _image((16, 16, 3), np.uint8, 10), _image((16, 16), np.uint16, 11)],
        [_image((17, 24), np.uint8, 12, False)],
    ],
    "empty": [[], _gray8_pairs(13)[0], [], [np.zeros((0, 5), np.uint8)]],
}


@pytest.mark.parametrize("case", list(STREAMS))
def test_stream_bytes_equal_batches_and_reference(case):
    """At depths 1, 2 and 3 the stream gives, batch by batch, the bytes of
    compress_tiled_batch, which are the reference stream's (for the mixed
    case, the port's per-image call's, which tests/test_torch_tiling.py
    holds to the reference); the decode stream gives the images back."""
    batches = STREAMS[case]
    want = [batch.compress_tiled_batch(b, TC, device=CPU) for b in batches]
    if case == "mixed":
        ref = [[ft.compress_tiled_bytes(im, TC, device=CPU) for im in b] for b in batches]
    else:
        ref = ref_batch.compress_tiled_stream(batches, TC, engine="xla")
    assert want == ref
    for depth in (1, 2, 3):
        got = ft.compress_tiled_stream(iter(batches), TC, depth=depth, device=CPU)
        assert got == want
    outs = ft.decompress_tiled_stream(iter(want), depth=2, device=CPU)
    assert [len(o) for o in outs] == [len(b) for b in batches]
    for b, o in zip(batches, outs):
        for im, out in zip(b, o):
            assert out.dtype == im.dtype and out.shape == im.shape
            assert np.array_equal(out, im)


def test_stream_consumes_lazily_and_keeps_depth(monkeypatch):
    """No more than ``depth`` batches are dispatched and not finished, and
    the oldest is finished before the next is dispatched."""
    events, live = [], []
    real_dispatch, real_finish = batch._encode_dispatch, batch._encode_finish

    def dispatch(images, tile, dev):
        live.append(len(images))
        events.append(("d", len(live)))
        return real_dispatch(images, tile, dev)

    def finish(state):
        live.pop(0)
        events.append(("f", len(live)))
        return real_finish(state)

    monkeypatch.setattr(batch, "_encode_dispatch", dispatch)
    monkeypatch.setattr(batch, "_encode_finish", finish)
    images = [_image((8, 8), np.uint8, 20 + i) for i in range(5)]
    pulled = []

    def gen():
        for im in images:
            pulled.append(len(events))
            yield [im]

    out = ft.compress_tiled_stream(gen(), TC, depth=2, device=CPU)
    # Two in flight at most: each later batch is dispatched right after
    # the oldest is finished, and pulled from the generator only then.
    assert events == [("d", 1), ("d", 2)] + [("f", 1), ("d", 2)] * 3 + [("f", 1), ("f", 0)]
    assert pulled == [0, 1, 2, 4, 6]
    assert out == [batch.compress_tiled_batch([im], TC, device=CPU) for im in images]


def test_stream_argument_checks():
    with pytest.raises(ValueError, match="depth"):
        ft.compress_tiled_stream([], depth=0, device=CPU)
    with pytest.raises(ValueError, match="depth"):
        ft.decompress_tiled_stream([], depth=0, device=CPU)
    with pytest.raises(ValueError, match="on_error"):
        ft.decompress_tiled_stream([], on_error="ignore", device=CPU)
    assert ft.compress_tiled_stream([], device=CPU) == []
    assert ft.decompress_tiled_stream([[]], device=CPU) == [[]]


# ---------------------------------------------------------------------------
# Redo paths of the finish half
# ---------------------------------------------------------------------------


def _count_calls(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def wrapper(*args, **kw):
        calls.append(args)
        return real(*args, **kw)

    monkeypatch.setattr(module, name, wrapper)
    return calls


@pytest.mark.parametrize("force", ["width", "capacity", "both"])
def test_forced_redo_gives_the_same_bytes(monkeypatch, force):
    """A width hint of one word makes every stream outgrow it (finish
    relaunches K1 at the exact width); a capacity hint of one word makes
    the payload outgrow it (finish compacts again at the exact size). The
    bytes equal the unforced call's."""
    images = [_image((16, 16), np.uint8, 30), _image((16, 16), np.uint8, 31, False),
              _image((16, 16, 3), np.uint16, 32)]
    want = batch.compress_tiled_batch(images, TC, device=CPU)
    monkeypatch.setattr(tcd, "_w_hints", {})
    monkeypatch.setattr(tiling, "_cap_hints", {})
    if force in ("width", "both"):
        monkeypatch.setattr(tcd, "width_hint", lambda cfg, t, c: 1)
    if force in ("capacity", "both"):
        monkeypatch.setattr(tiling, "payload_cap_hint", lambda cfg, nt, t, c: 1)
    encodes = _count_calls(monkeypatch, tcd, "encode_tiles")
    compactions = _count_calls(monkeypatch, tiling, "byte_payload")
    assert batch.compress_tiled_batch(images, TC, device=CPU) == want
    widths = [args[4] for args in encodes]  # two groups, dispatched first
    if force == "capacity":
        assert len(widths) == 2 and min(widths) > 1
    else:
        assert widths[:2] == [1, 1] and len(widths) == 4 and min(widths[2:]) > 1
    assert len(compactions) == 4


def test_hints_learn_from_finish(monkeypatch):
    monkeypatch.setattr(tcd, "_w_hints", {})
    monkeypatch.setattr(tiling, "_cap_hints", {})
    img = _image((16, 16), np.uint8, 33)
    cfg = tiling.tiled_config_for_depth(ft.PixelDepth.EIGHT)
    first = tiling.payload_cap_hint(cfg, 4, 64, 1)
    batch.compress_tiled_batch([img], TC, device=CPU)
    assert (64, 1, ft.PixelDepth.EIGHT) in tcd._w_hints
    assert tiling.payload_cap_hint(cfg, 4, 64, 1) <= first


# ---------------------------------------------------------------------------
# on_error="isolate", mirrored from tests/test_isolation.py
# ---------------------------------------------------------------------------


def _iso_images():
    rng = np.random.default_rng(40)
    out = []
    for _ in range(6):
        img = np.cumsum(np.cumsum(rng.integers(-6, 7, (40, 48)), 0), 1) + 128
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


# tests/test_isolation.py's images (48x40 gray8 at tile 16), shared by every
# case below so that the reference compiles its decode once per batch size.
ISO_IMAGES = _iso_images()
ISO_BLOBS = batch.compress_tiled_batch(ISO_IMAGES, ISO_TC, device=CPU)


def _outcome(fn):
    """The call's list, or the name of the exception it raised."""
    try:
        return fn()
    except (errors.DecompressionError, felics_tpu.DecompressionError, ValueError) as e:
        return type(e).__name__


def _same(port, ref):
    """Member by member: equal arrays, or exceptions of the same class name."""
    if isinstance(ref, str) or isinstance(port, str):
        assert port == ref
        return
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        if isinstance(r, np.ndarray):
            assert isinstance(p, np.ndarray) and p.dtype == r.dtype
            assert np.array_equal(p, r)
        else:
            assert isinstance(p, errors.DecompressionError)
            assert type(p).__name__ == type(r).__name__


def _batch_both(datas, on_error):
    port = _outcome(lambda: ft.decompress_tiled_batch(datas, device=CPU, on_error=on_error))
    ref = _outcome(lambda: ref_batch.decompress_tiled_batch(
        datas, engine="xla", on_error=on_error))
    _same(port, ref)
    return port


ISOLATION_CASES = ["truncated_raise", "truncated_isolate", "corrupt_header",
                   "all_good", "bad_on_error"]


@pytest.mark.parametrize("case", ISOLATION_CASES)
def test_batch_isolation_matches_reference(case):
    imgs, datas = ISO_IMAGES[:3], ISO_BLOBS[:3]
    if case == "truncated_raise":
        assert _batch_both([datas[0], datas[1][:-5]], "raise") == "IoError"
    elif case == "truncated_isolate":
        out = _batch_both([datas[0], datas[1][:-5], datas[2]], "isolate")
        assert isinstance(out[1], errors.IoError)
        assert np.array_equal(out[0], imgs[0]) and np.array_equal(out[2], imgs[2])
    elif case == "corrupt_header":
        bad = datas[0][:14] + b"\x00\x00" + datas[0][16:]  # tile_w = 0
        out = _batch_both([bad, datas[1]], "isolate")
        assert isinstance(out[0], errors.DecompressionError)
        assert np.array_equal(out[1], imgs[1])
    elif case == "all_good":
        a = _batch_both(datas, "raise")
        b = _batch_both(datas, "isolate")
        _same(b, a)
    else:
        assert _batch_both([], "ignore") == "ValueError"
        assert ft.decompress_tiled_batch([], device=CPU, on_error="isolate") == []


def test_batch_isolate_random_corruption_matches_reference():
    """Random bit flips under on_error='isolate': every member is what the
    reference makes of it, and good members stay exact."""
    imgs, datas = ISO_IMAGES[:3], ISO_BLOBS[:3]
    rng = np.random.default_rng(42)
    for _ in range(8):
        victim = int(rng.integers(0, 3))
        pos = int(rng.integers(0, len(datas[victim])))
        flip = bytes([datas[victim][pos] ^ (1 << int(rng.integers(0, 8)))])
        bad = datas[victim][:pos] + flip + datas[victim][pos + 1:]
        blobs = [bad if i == victim else datas[i] for i in range(3)]
        out = _batch_both(blobs, "isolate")
        for i in range(3):
            if i != victim:
                assert np.array_equal(out[i], imgs[i])


def test_batch_isolate_flags_bad_pixels_per_member():
    """A payload whose values leave the depth (an all-zero tail after the
    first pixels of a tile at 0) gives that member InvalidValue, as in the
    reference, and leaves the others exact."""
    imgs = [ISO_IMAGES[0], np.zeros_like(ISO_IMAGES[1])]
    datas = [ISO_BLOBS[0], batch.compress_tiled_batch(imgs[1:], ISO_TC, device=CPU)[0]]
    hd = tiling.flct.read_tiled_header(datas[1])
    bad = bytearray(datas[1])
    bad[hd.payload_off + 2 : hd.payload_off + int(hd.tile_lengths[0])] = bytes(
        int(hd.tile_lengths[0]) - 2)
    bad[hd.payload_off + 2] = 0x3F  # marker 00 (below), then a long unary run
    out = _batch_both([datas[0], bytes(bad)], "isolate")
    assert isinstance(out[1], errors.InvalidValue)
    assert np.array_equal(out[0], imgs[0])
    assert _batch_both([datas[0], bytes(bad)], "raise") == "InvalidValue"


def test_group_failure_falls_back_to_members(monkeypatch):
    """A group whose decode fails as a whole while isolating is decoded
    member by member (the reference's residual fallback)."""
    datas = ISO_BLOBS[:2]

    def boom(p):
        raise errors.InvalidValue("whole group")

    monkeypatch.setattr(tiling, "decode_finish", boom)
    calls = _count_calls(monkeypatch, batch, "_decompress_one_isolated")
    with pytest.raises(errors.InvalidValue):
        ft.decompress_tiled_batch(datas, device=CPU)
    out = ft.decompress_tiled_batch(datas, device=CPU, on_error="isolate")
    assert len(calls) == 2
    assert all(isinstance(o, errors.InvalidValue) for o in out)  # per image, boom again


def test_stream_isolation_matches_reference():
    imgs, datas = ISO_IMAGES, ISO_BLOBS
    batches = [
        [datas[0], datas[1][:-5], datas[2]],       # truncated member
        [datas[3][:10], datas[4]],                 # truncated header
        [datas[5]],
    ]
    ref = ref_batch.decompress_tiled_stream(batches, engine="xla", on_error="isolate")
    for depth in (1, 2):
        port = ft.decompress_tiled_stream(batches, depth=depth, on_error="isolate",
                                          device=CPU)
        assert [len(b) for b in port] == [3, 2, 1]
        for p, r in zip(port, ref):
            _same(p, r)
    assert np.array_equal(port[2][0], imgs[5])
    good = [[datas[0], datas[2]], [datas[4]]]
    a = ft.decompress_tiled_stream(good, device=CPU)
    b = ft.decompress_tiled_stream(good, on_error="isolate", device=CPU)
    for ba, bb in zip(a, b):
        _same(bb, ba)
    with pytest.raises(errors.IoError):
        ft.decompress_tiled_stream([[datas[0], datas[1][:-5]]], device=CPU)


# ---------------------------------------------------------------------------
# K2's position width, the device helpers of the dispatch halves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c,th,tw", [(1, 32, 32), (3, 64, 64), (1, 2, 2), (3, 8192, 8192)])
def test_decode_wide_positions_threshold(c, th, tw):
    """The 32-bit K2 is taken while 32 * W + 20 bits a step + 64 stays
    within int32, the 64-bit one from the first word past that."""
    limit = (2**31 - 1) - 64 - 20 * c * th * tw
    if limit < 0:  # 8192x8192 rgb: 60 bits a pixel alone pass 2^31
        assert tcd.decode_wide_positions(1, c, th, tw)
        return
    w0 = limit // 32
    assert not tcd.decode_wide_positions(w0, c, th, tw)
    assert tcd.decode_wide_positions(w0 + 1, c, th, tw)
    assert not tcd.decode_wide_positions(64, c, th, tw)


def test_decode_wide_positions_for_the_long_row_containers():
    """The rows that the 32-bit kernel refused: one 10240x10240 gray8
    tile at a bit a pixel, and one 12800x12800 gray16 tile of noise."""
    assert tcd.decode_wide_positions(10240 * 10240 // 32, 1, 10240, 10240)
    assert tcd.decode_wide_positions(12800 * 12800 * 15 // 32, 1, 12800, 12800)


@pytest.mark.parametrize("h,w", [(1, 1), (1, 5), (5, 1), (2, 2), (7, 9), (3, 2), (32, 32)])
def test_device_neighbours_match_numpy(h, w):
    a, b = neighbours(h, w, CPU)
    ra, rb = neighbour_indices(h, w)
    assert a.dtype == torch.int64 and np.array_equal(a.numpy(), ra)
    assert np.array_equal(b.numpy(), rb)


def test_upload_and_host_copy_round_trip():
    arrays = [np.arange(5, dtype=np.uint8), np.array([65535, 1, 0], np.uint16),
              np.arange(6, dtype=np.int64).reshape(2, 3), np.zeros(0, np.int32),
              np.array([True, False])]
    ts = upload(arrays, torch.device(CPU))
    assert ts[1].dtype == torch.int16 and ts[1].tolist() == [-1, 1, 0]
    back = HostCopy(*ts).wait()
    for a, t, h in zip(arrays, ts, back):
        assert h.shape == a.shape and np.array_equal(h.view(a.dtype), a)


# ---------------------------------------------------------------------------
# Native FLCT decoder binding, package surface
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def native_lib():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, os.path.join(repo, "native", "build.py")], check=True)
    return native


@pytest.mark.parametrize("idx", range(3))
def test_native_decompress_tiled_reads_port_containers(native_lib, idx):
    img = [_image((24, 20), np.uint8, 50), _image((9, 11, 3), np.uint16, 51, False),
           _image((1, 7), np.uint8, 52)][idx]
    blob = ft.compress_tiled_bytes(img, TC, device=CPU)
    for n_threads in (1, 0):
        out = native_lib.decompress_tiled(blob, n_threads)
        assert out.dtype == img.dtype and np.array_equal(out, img)
    with pytest.raises(errors.IoError):
        native_lib.decompress_tiled(blob[:-1])
    with pytest.raises(errors.InvalidSignature):
        native_lib.decompress_tiled(b"FLCS" + blob[4:])


@pytest.mark.parametrize("shape,dtype", [((9, 11), np.uint8), ((7, 5, 3), np.uint16),
                                         ((0, 3), np.uint8)])
def test_write_header_equals_reference(shape, dtype):
    img = np.zeros(shape, dtype)
    hd = ft.header_for_array(img)
    ref_hd = felics_tpu.api.header_for_array(img)
    got, want = io.BytesIO(), io.BytesIO()
    ft.write_header(hd, got)
    ref_format.write_header(ref_hd, want)
    assert got.getvalue() == want.getvalue()
    assert ft.read_header(io.BytesIO(got.getvalue())) == hd
    tiled, ref_tiled = io.BytesIO(), io.BytesIO()
    ft.write_header(hd, tiled, magic=b"FLCT")
    ref_format.write_header(ref_hd, ref_tiled, magic=b"FLCT")
    assert tiled.getvalue() == ref_tiled.getvalue()


def test_package_exports_the_reference_names():
    for name in ("__version__", "Header", "ColorType", "PixelDepth", "MAGIC",
                 "read_header", "write_header", "CodingConfig", "CONFIG_8BIT",
                 "CONFIG_16BIT", "compress_tiled_stream", "decompress_tiled_stream"):
        assert name in ft.__all__ and hasattr(ft, name)
    assert ft.__version__ == felics_tpu.__version__ and ft.MAGIC == felics_tpu.MAGIC
    for port_cfg, ref_cfg in ((ft.CONFIG_8BIT, felics_tpu.CONFIG_8BIT),
                              (ft.CONFIG_16BIT, felics_tpu.CONFIG_16BIT)):
        assert (port_cfg.k_values, port_cfg.max_context, port_cfg.count_scaling) == (
            ref_cfg.k_values, ref_cfg.max_context, ref_cfg.count_scaling)
        assert int(port_cfg.pixel_depth) == int(ref_cfg.pixel_depth)
