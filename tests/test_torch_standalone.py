"""The port's own copies of what it once imported from felics_tpu (errors,
the FLCS header, the coding configs, the context model, YCoCg-R and the
raw path of images under two pixels) against the reference modules they
copy. On the CPU; tolerance zero (bytes, integers, class names).
"""

import inspect
import io
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from felics_tpu import api as ref_api
from felics_tpu import config as ref_config
from felics_tpu import errors as ref_errors
from felics_tpu import format as ref_format
from felics_tpu.core import color as ref_color
from felics_tpu.core import context as ref_context
from felics_tpu_torch import api, config, errors, format, native
from felics_tpu_torch.core import color, context

CPU = "cpu"

REF_ERRORS = sorted(
    name for name, cls in vars(ref_errors).items()
    if inspect.isclass(cls) and issubclass(cls, Exception)
)


@pytest.mark.parametrize("name", REF_ERRORS)
def test_error_classes_match_reference(name):
    ref_cls, port_cls = getattr(ref_errors, name), getattr(errors, name)
    assert port_cls.__module__ == "felics_tpu_torch.errors"
    assert [c.__name__ for c in port_cls.__mro__] == [c.__name__ for c in ref_cls.__mro__]
    assert issubclass(port_cls, errors.DecompressionError)


def test_port_errors_are_its_own():
    assert not issubclass(errors.DecompressionError, ref_errors.DecompressionError)
    import felics_tpu_torch
    assert felics_tpu_torch.DecompressionError is errors.DecompressionError


HEADER_IMAGES = [
    np.zeros((3, 5), np.uint8), np.zeros((1, 70000), np.uint16),
    np.zeros((2, 4, 3), np.uint8), np.zeros((6, 1, 3), np.uint16),
]


@pytest.mark.parametrize("idx", range(len(HEADER_IMAGES)))
def test_header_bytes_match_reference(idx):
    img = HEADER_IMAGES[idx]
    port_hd, ref_hd = format.header_for_array(img), ref_api.header_for_array(img)
    blob = format.header_bytes(port_hd)
    assert blob == ref_format.header_bytes(ref_hd)
    back = format.read_header_bytes(blob + b"\x01\x02")
    want = ref_format.read_header_bytes(blob)
    assert (back.color_type, back.pixel_depth, back.width, back.height) == (
        want.color_type, want.pixel_depth, want.width, want.height)
    assert back.num_channels == want.num_channels
    assert back.pixel_depth.bits == want.pixel_depth.bits


BAD_HEADERS = [
    b"FLCS\x00\x00\x00\x00", b"FLCT" + bytes(10), b"FLCS\x02\x00" + bytes(8),
    b"FLCS\x00\x05" + bytes(8),
]


@pytest.mark.parametrize("idx", range(len(BAD_HEADERS)))
def test_bad_headers_raise_like_reference(idx):
    data = BAD_HEADERS[idx]
    with pytest.raises(ref_errors.DecompressionError) as want:
        ref_format.read_header_bytes(data)
    with pytest.raises(errors.DecompressionError) as got:
        format.read_header_bytes(data)
    assert type(got.value).__name__ == type(want.value).__name__


def test_header_for_array_rejects_what_the_reference_rejects():
    for bad in (np.zeros((2, 2), np.int32), np.zeros((2, 2, 4), np.uint8)):
        with pytest.raises(ValueError):
            ref_api.header_for_array(bad)
        with pytest.raises(ValueError):
            format.header_for_array(bad)


@pytest.mark.parametrize("depth", [0, 1])
def test_coding_configs_match_reference(depth):
    for fn in ("config_for_depth", "tiled_config_for_depth"):
        port = getattr(config, fn)(format.PixelDepth(depth))
        ref = getattr(ref_config, fn)(ref_format.PixelDepth(depth))
        for field in ("k_values", "max_context", "count_scaling", "num_k",
                      "depth_bits", "max_phase_in_bits"):
            assert getattr(port, field) == getattr(ref, field), (fn, field)
        assert int(port.pixel_depth) == int(ref.pixel_depth)
    assert config.QCTX_CAP == ref_config.QCTX_CAP
    assert config.TileConfig() == config.TileConfig(
        ref_config.TileConfig().tile_h, ref_config.TileConfig().tile_w)


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (1, 50), (50, 1), (2, 2), (3, 7), (7, 3), (5, 5)])
def test_neighbour_indices_match_reference(shape):
    for port, ref in zip(context.neighbour_indices(*shape),
                         ref_context.neighbour_indices(*shape)):
        assert port.dtype == ref.dtype and np.array_equal(port, ref)


@pytest.mark.parametrize("bound", [255, 65535, 1 << 24])
def test_ycocg_matches_reference(bound):
    rng = np.random.default_rng(bound)
    r, g, b = (rng.integers(-bound, bound + 1, (17, 9)).astype(np.int32) for _ in range(3))
    want = ref_color.rgb_to_ycocg(r, g, b)
    for xp, conv in ((np, np.asarray), (torch, lambda t: t.numpy())):
        args = [xp.asarray(v) for v in (r, g, b)]
        got = color.rgb_to_ycocg(*args, xp=xp)
        assert all(np.array_equal(conv(x), y) for x, y in zip(got, want))
        back = color.ycocg_to_rgb(*got, xp=xp)
        assert all(np.array_equal(conv(x), y) for x, y in zip(back, (r, g, b)))
        assert all(np.array_equal(conv(x), y) for x, y in
                   zip(back, ref_color.ycocg_to_rgb(*want)))


TINY = [
    np.array([[7]], np.uint8), np.array([[65000]], np.uint16),
    np.array([[[1, 200, 3]]], np.uint8), np.array([[[0, 65535, 9]]], np.uint16),
    np.zeros((0, 5), np.uint8), np.zeros((4, 0), np.uint16),
    np.zeros((0, 0, 3), np.uint8), np.zeros((0, 2, 3), np.uint16),
]


@pytest.mark.parametrize("idx", range(len(TINY)))
def test_tiny_images_match_oracle(idx):
    """Fewer than 2 pixels: the port's raw path gives the oracle's bytes,
    and decodes the oracle's container to the oracle's pixels."""
    img = TINY[idx]
    blob = ref_api.compress_image_bytes(img, backend="oracle")
    assert api.compress_image_bytes(img, device=CPU) == blob
    assert api.compress_images_bytes([img, img], device=CPU) == [blob, blob]
    want = ref_api.decompress_image_bytes(blob, backend="oracle")
    for got in (api.decompress_image_bytes(blob, device=CPU),
                api.decompress_images_bytes([blob], device=CPU)[0]):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want)


def _tiny_bad():
    gray = ref_api.compress_image_bytes(np.array([[7]], np.uint8), backend="oracle")
    rgb = ref_api.compress_image_bytes(np.zeros((1, 1, 3), np.uint8), backend="oracle")
    over = gray[:14] + struct.pack(">iI", 300, 0)
    negative = gray[:14] + struct.pack(">iI", -1, 0)
    rgb_over = rgb[:14] + struct.pack(">iIiIiI", 0, 0, 255, 0, 0, 0)
    return [gray[:-1], gray[:14], rgb[:-5], over, negative, rgb_over, gray + b"\xff"]


@pytest.mark.parametrize("idx", range(7))
def test_tiny_corrupt_containers_raise_like_oracle(idx):
    data = _tiny_bad()[idx]

    def outcome(fn, errors_module):
        try:
            return fn()
        except errors_module.DecompressionError as e:
            return type(e).__name__

    want = outcome(lambda: ref_api.decompress_image_bytes(data, backend="oracle"), ref_errors)
    got = outcome(lambda: api.decompress_image_bytes(data, device=CPU), errors)
    if isinstance(want, str):
        assert got == want
    else:
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.fixture(scope="module")
def native_lib():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, os.path.join(repo, "native", "build.py")], check=True)
    from felics_tpu.native import runtime
    assert runtime.available()
    return runtime


@pytest.mark.parametrize("idx", range(3))
def test_native_binding_matches_reference_runtime(native_lib, idx):
    """felics_tpu_torch.native gives the reference runtime's containers and
    pixels, and its error classes by name."""
    rng = np.random.default_rng(idx)
    img = [rng.integers(0, 256, (9, 11)).astype(np.uint8),
           rng.integers(0, 65536, (7, 5, 3)).astype(np.uint16),
           np.array([[3]], np.uint8)][idx]
    hd = format.header_for_array(img)
    ref_hd = ref_api.header_for_array(img)
    blob = native.compress(img, hd)
    assert blob == native_lib.compress(img, ref_hd)
    out = native.decompress(blob)
    assert out.dtype == img.dtype and np.array_equal(out, img)
    tiled = native.compress_tiled(img, hd, 4, 4)
    assert tiled == native_lib.compress_tiled(img, ref_hd, 4, 4)
    with pytest.raises(errors.IoError):
        native.decompress(blob[:-1] if idx < 2 else blob[:15])
    with pytest.raises(ref_errors.IoError):
        native_lib.decompress(blob[:-1] if idx < 2 else blob[:15], ref_hd)


GRIDS = [((16, 16), 0, 5), ((16, 16), 5, 0), ((16, 16), 0, 0), ((4, 3), 9, 7),
         ((64, 64), 1, 1), ((2, 2), 20, 20), ((7, 5), 14, 15), ((64, 64), 100, 3)]


@pytest.mark.parametrize("tile,height,width", GRIDS)
def test_tile_grid_matches_reference(tile, height, width):
    """TileConfig.grid: ceil-divide, and 0 along a zero dimension."""
    got = config.TileConfig(*tile).grid(height, width)
    assert got == ref_config.TileConfig(*tile).grid(height, width)


MAGICS = [format.MAGIC, b"FLCT", b"TEST"]


@pytest.mark.parametrize("magic", MAGICS)
def test_read_header_magic_matches_reference(magic):
    """read_header / read_header_bytes take the signature to expect, and
    raise InvalidSignature on any other, as felics_tpu's do."""
    img = np.zeros((3, 4, 3), np.uint16)
    blob = format.header_bytes(format.header_for_array(img), magic)
    assert blob == ref_format.header_bytes(ref_api.header_for_array(img), magic)
    for read, ref_read, arg in (
        (format.read_header_bytes, ref_format.read_header_bytes, blob),
        (format.read_header, ref_format.read_header, None),
    ):
        got = read(io.BytesIO(blob) if arg is None else arg, magic=magic)
        want = ref_read(io.BytesIO(blob) if arg is None else arg, magic=magic)
        assert (int(got.color_type), int(got.pixel_depth), got.width, got.height) == (
            int(want.color_type), int(want.pixel_depth), want.width, want.height)
        other = b"XXXX" if magic != b"XXXX" else b"YYYY"
        with pytest.raises(ref_errors.InvalidSignature):
            ref_read(io.BytesIO(blob) if arg is None else arg, magic=other)
        with pytest.raises(errors.InvalidSignature):
            read(io.BytesIO(blob) if arg is None else arg, magic=other)


def test_native_available_matches_reference(native_lib, monkeypatch, tmp_path):
    """native.available() is a probe: true once the library is built, as
    felics_tpu's runtime says; without the library it is false, and
    backend="native" still raises rather than pick another codec."""
    assert native.available() is native_lib.available() is True
    img = np.zeros((2, 3), np.uint8)
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "missing.so")
    monkeypatch.setattr(native, "_lib", None)
    assert native.available() is False and native.qoi_available() is False
    with pytest.raises(RuntimeError, match="not built"):
        api.compress_image_bytes(img, backend="native")


@pytest.mark.parametrize("idx", range(4))
def test_native_decompress_takes_the_reference_call(native_lib, idx):
    """native.decompress(data, header) as felics_tpu's runtime takes it:
    the header argument is not read, so a wrong one changes nothing, and
    the one-argument call gives the same image."""
    rng = np.random.default_rng(40 + idx)
    shape, dtype = [((9, 11), np.uint8), ((7, 5, 3), np.uint16), ((1, 1), np.uint8),
                    ((2, 40, 3), np.uint8)][idx]
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    hd, ref_hd = format.header_for_array(img), ref_api.header_for_array(img)
    blob = native.compress(img, hd)
    other = format.header_for_array(np.zeros((3, 3), np.uint8))
    want = native_lib.decompress(blob, ref_hd)
    for got in (native.decompress(blob, hd), native.decompress(blob, other),
                native.decompress(blob)):
        assert got.dtype == want.dtype == img.dtype
        assert np.array_equal(got, want) and np.array_equal(got, img)
    with pytest.raises(errors.IoError):
        native.decompress(blob[:13], hd)
