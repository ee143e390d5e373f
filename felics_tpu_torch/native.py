"""ctypes binding of the repository's native C++ codec, the port's comparator,
and of its QOI codec.

Counterpart: the ``available``, ``compress``, ``decompress``,
``compress_tiled``, ``decompress_tiled``, ``qoi_available``, ``qoi_encode``
and ``qoi_decode`` calls of felics_tpu/native/runtime.py. The library is
``native/build/libfelics_core.so``, built by ``python native/build.py`` from
native/src/felics_core.cpp. The device codecs never reach it: the API's
``backend="native"`` calls it by name, ``chip_smoke.py`` holds the port's
containers and images against it, and ``bfelics`` takes its QOI column
from it.

C ABI (0 = ok; a negative code names the error class):
    int fel_compress(const int32_t* pixels, uint32_t width, uint32_t height,
                     int color_type, int pixel_depth, uint8_t** out, size_t* out_len);
    int fel_compress_tiled(const int32_t* pixels, uint32_t width, uint32_t height,
                           int color_type, int pixel_depth, uint16_t tile_w,
                           uint16_t tile_h, int n_threads, uint8_t** out, size_t* out_len);
    int fel_decompress(const uint8_t* data, size_t len, int32_t** out_pixels,
                       uint32_t* width, uint32_t* height, int* color_type,
                       int* pixel_depth);
    int fel_decompress_tiled(const uint8_t* data, size_t len, int n_threads,
                             int32_t** out_pixels, uint32_t* width,
                             uint32_t* height, int* color_type, int* pixel_depth);
    int fel_qoi_encode(const uint8_t* pixels, uint32_t width, uint32_t height,
                       int channels, uint8_t** out, size_t* out_len);
    int fel_qoi_decode(const uint8_t* data, size_t len, uint8_t** out,
                       uint32_t* width, uint32_t* height, int* channels);
    void fel_free(void* ptr);
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import Optional

import numpy as np

from felics_tpu_torch import errors
from felics_tpu_torch.format import ColorType, Header, PixelDepth

LIB_PATH = Path(__file__).resolve().parent.parent / "native" / "build" / "libfelics_core.so"

_ERRORS = {
    -1: errors.IoError,
    -2: errors.InvalidValue,
    -3: errors.ValueOverflow,
    -4: errors.InvalidDimensions,
    -5: errors.InvalidColorType,
    -6: errors.InvalidPixelDepth,
    -7: errors.InvalidSignature,
    -8: MemoryError,
}

_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        if not LIB_PATH.exists():
            raise RuntimeError(f"{LIB_PATH} not built; run python native/build.py")
        lib = ctypes.CDLL(str(LIB_PATH))
        u8p, i32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)
        u32, i32, size = ctypes.c_uint32, ctypes.c_int, ctypes.c_size_t
        lib.fel_compress.restype = i32
        lib.fel_compress.argtypes = [
            i32p, u32, u32, i32, i32, ctypes.POINTER(u8p), ctypes.POINTER(size),
        ]
        lib.fel_compress_tiled.restype = i32
        lib.fel_compress_tiled.argtypes = [
            i32p, u32, u32, i32, i32, ctypes.c_uint16, ctypes.c_uint16, i32,
            ctypes.POINTER(u8p), ctypes.POINTER(size),
        ]
        lib.fel_decompress.restype = i32
        lib.fel_decompress.argtypes = [
            u8p, size, ctypes.POINTER(i32p), ctypes.POINTER(u32),
            ctypes.POINTER(u32), ctypes.POINTER(i32), ctypes.POINTER(i32),
        ]
        lib.fel_decompress_tiled.restype = i32
        lib.fel_decompress_tiled.argtypes = [
            u8p, size, i32, ctypes.POINTER(i32p), ctypes.POINTER(u32),
            ctypes.POINTER(u32), ctypes.POINTER(i32), ctypes.POINTER(i32),
        ]
        if hasattr(lib, "fel_qoi_encode"):  # a library built before QOI lacks it
            lib.fel_qoi_encode.restype = i32
            lib.fel_qoi_encode.argtypes = [
                u8p, u32, u32, i32, ctypes.POINTER(u8p), ctypes.POINTER(size),
            ]
            lib.fel_qoi_decode.restype = i32
            lib.fel_qoi_decode.argtypes = [
                u8p, size, ctypes.POINTER(u8p), ctypes.POINTER(u32),
                ctypes.POINTER(u32), ctypes.POINTER(i32),
            ]
        lib.fel_free.restype = None
        lib.fel_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def _check(code: int) -> None:
    if code != 0:
        raise _ERRORS.get(code, errors.DecompressionError)(f"native codec error {code}")


def _take_bytes(lib: ctypes.CDLL, out_ptr, out_len) -> bytes:
    try:
        return ctypes.string_at(out_ptr, out_len.value)
    finally:
        lib.fel_free(out_ptr)


def compress(image: np.ndarray, header: Header) -> bytes:
    """FLCS container of ``image``."""
    lib = _load()
    flat = np.ascontiguousarray(image.reshape(-1), dtype=np.int32)
    out_ptr, out_len = ctypes.POINTER(ctypes.c_uint8)(), ctypes.c_size_t()
    _check(lib.fel_compress(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), header.width,
        header.height, int(header.color_type), int(header.pixel_depth),
        ctypes.byref(out_ptr), ctypes.byref(out_len),
    ))
    return _take_bytes(lib, out_ptr, out_len)


def compress_tiled(
    image: np.ndarray, header: Header, tile_w: int, tile_h: int, n_threads: int = 0
) -> bytes:
    """FLCT container of ``image``; ``n_threads`` 0 takes every host core."""
    lib = _load()
    flat = np.ascontiguousarray(image.reshape(-1), dtype=np.int32)
    out_ptr, out_len = ctypes.POINTER(ctypes.c_uint8)(), ctypes.c_size_t()
    _check(lib.fel_compress_tiled(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), header.width,
        header.height, int(header.color_type), int(header.pixel_depth),
        tile_w, tile_h, n_threads or os.cpu_count() or 1,
        ctypes.byref(out_ptr), ctypes.byref(out_len),
    ))
    return _take_bytes(lib, out_ptr, out_len)


def decompress(data: bytes, header: Optional[Header] = None) -> np.ndarray:
    """(H, W[, 3]) uint8/uint16 image of an FLCS container. ``header`` is
    the reference runtime's second argument and, as there, is not read:
    the container's own header gives the shape and depth."""
    return _decode(data, lambda lib, buf, *out: lib.fel_decompress(buf, len(data), *out))


def decompress_tiled(data: bytes, n_threads: int = 0) -> np.ndarray:
    """(H, W[, 3]) uint8/uint16 image of an FLCT container; ``n_threads``
    0 (or less) takes every host core."""
    n = n_threads if n_threads > 0 else os.cpu_count() or 1
    return _decode(
        data, lambda lib, buf, *out: lib.fel_decompress_tiled(buf, len(data), n, *out))


def _decode(data: bytes, call) -> np.ndarray:
    """Run a native decoder ``call(lib, buf, *out pointers)`` and take its
    pixels."""
    lib = _load()
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    out_ptr = ctypes.POINTER(ctypes.c_int32)()
    width, height = ctypes.c_uint32(), ctypes.c_uint32()
    color, depth = ctypes.c_int(), ctypes.c_int()
    _check(call(
        lib, buf, ctypes.byref(out_ptr), ctypes.byref(width),
        ctypes.byref(height), ctypes.byref(color), ctypes.byref(depth),
    ))
    try:
        nchan = 1 if color.value == int(ColorType.GRAY) else 3
        n = width.value * height.value * nchan
        arr = np.ctypeslib.as_array(out_ptr, shape=(n,)).copy() if n else np.zeros(0, np.int32)
    finally:
        lib.fel_free(out_ptr)
    dtype = np.uint8 if depth.value == int(PixelDepth.EIGHT) else np.uint16
    shape = (height.value, width.value) + ((3,) if nchan == 3 else ())
    return arr.astype(dtype).reshape(shape)


def available() -> bool:
    """Whether the native library is built and loads. A probe only: the
    codec calls raise without the library, and the API never takes this as
    a cue to pick another codec."""
    if not LIB_PATH.exists():
        return False
    _load()
    return True


def qoi_available() -> bool:
    """Whether the native library is built and has the QOI codec."""
    return available() and hasattr(_load(), "fel_qoi_encode")


def _qoi_lib() -> ctypes.CDLL:
    if not qoi_available():
        raise RuntimeError("native library with QOI not built; run python native/build.py")
    return _load()


def qoi_encode(image: np.ndarray) -> bytes:
    """QOI file of an (H, W, 3|4) uint8 image (gray callers expand to RGB
    first, as the reference's corpus benchmark does)."""
    lib = _qoi_lib()
    if image.ndim != 3 or image.shape[2] not in (3, 4) or image.dtype != np.uint8:
        raise ValueError("QOI input must be (H, W, 3|4) uint8")
    h, w, ch = image.shape
    flat = np.ascontiguousarray(image.reshape(-1))
    out_ptr, out_len = ctypes.POINTER(ctypes.c_uint8)(), ctypes.c_size_t()
    _check(lib.fel_qoi_encode(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h, ch,
        ctypes.byref(out_ptr), ctypes.byref(out_len),
    ))
    return _take_bytes(lib, out_ptr, out_len)


def qoi_decode(data: bytes) -> np.ndarray:
    """(H, W, channels) uint8 image of a QOI file."""
    lib = _qoi_lib()
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    out_ptr = ctypes.POINTER(ctypes.c_uint8)()
    w, h, ch = ctypes.c_uint32(), ctypes.c_uint32(), ctypes.c_int()
    _check(lib.fel_qoi_decode(
        buf, len(data), ctypes.byref(out_ptr), ctypes.byref(w), ctypes.byref(h),
        ctypes.byref(ch),
    ))
    try:
        n = w.value * h.value * ch.value
        arr = np.ctypeslib.as_array(out_ptr, shape=(n,)).copy()
    finally:
        lib.fel_free(out_ptr)
    return arr.reshape(h.value, w.value, ch.value)
