"""Image file IO for the port's CLIs.

Counterpart: felics_tpu/io/images.py (``UnsupportedImageFormat``,
``load_image``, ``save_image``): load any imageio/PIL-readable file into
the four supported array shapes (Luma8/Luma16/Rgb8/Rgb16), save by output
extension; imageio first, then PIL, with the same modes and errors.

Where imageio is not installed, PIL alone would narrow a 16-bit RGB TIFF to
8 bits without a word (it has no 48-bit mode), and cannot write one. So
16-bit TIFFs then go through a small reader and writer of uncompressed,
chunky baseline TIFF here; any other 16-bit file PIL cannot hold raises
``UnsupportedImageFormat``.
"""

from __future__ import annotations

import os
import struct

import numpy as np


class UnsupportedImageFormat(Exception):
    pass


def _imageio():
    try:
        import imageio.v3 as iio
    except ImportError:
        return None
    return iio


def load_image(path: str) -> np.ndarray:
    """Load to (H, W) or (H, W, 3) uint8/uint16.

    Grayscale and RGB at 8/16 bits are supported; palette and bilevel
    sources decode to Rgb8/Luma8; anything else (alpha, float) raises
    UnsupportedImageFormat.
    """
    arr = None
    iio = _imageio()
    if iio is not None:
        try:
            arr = np.asarray(iio.imread(path))
            if arr.dtype in (np.uint8, np.uint16):
                if arr.ndim == 2:
                    return arr
                if arr.ndim == 3 and arr.shape[2] == 3:
                    return arr
                if arr.ndim == 3 and arr.shape[2] == 1:
                    return arr[..., 0]
            if arr.dtype == np.int32 and arr.ndim == 2:
                if 0 <= arr.min(initial=0) and arr.max(initial=0) <= 65535:
                    return arr.astype(np.uint16)
        except FileNotFoundError:
            raise
        except Exception:
            arr = None

    from PIL import Image

    with Image.open(path) as im:
        mode = im.mode
        if iio is None and im.format == "TIFF" and _tiff_bits(im) == 16:
            return _read_tiff16(path, im)
        if mode == "L":
            return np.asarray(im, dtype=np.uint8)
        if mode in ("I;16", "I;16B", "I;16L"):
            return np.asarray(im, dtype=np.uint16)
        if mode == "RGB":
            return np.asarray(im, dtype=np.uint8)
        if mode in ("P", "1"):
            target = "L" if mode == "1" else "RGB"
            return np.asarray(im.convert(target), dtype=np.uint8)
    raise UnsupportedImageFormat(
        f"unsupported image format: {mode if arr is None else (arr.dtype, arr.shape)}"
    )


def save_image(path: str, image: np.ndarray) -> None:
    """Save by extension."""
    if image.dtype == np.uint8:
        from PIL import Image

        mode = "L" if image.ndim == 2 else "RGB"
        Image.fromarray(image, mode=mode).save(path)
        return
    iio = _imageio()
    if iio is not None:
        iio.imwrite(path, image)
    elif os.path.splitext(path)[1].lower() in (".tif", ".tiff"):
        _write_tiff16(path, image)
    elif image.ndim == 2:
        from PIL import Image

        Image.fromarray(image).save(path)  # mode I;16
    else:
        raise UnsupportedImageFormat(
            f"16-bit RGB {os.path.splitext(path)[1]!r} needs imageio; write a .tiff")


# Baseline TIFF tags of the 16-bit fallback.
_WIDTH, _LENGTH, _BITS, _COMPRESSION, _PHOTOMETRIC = 256, 257, 258, 259, 262
_STRIP_OFFSETS, _SAMPLES, _ROWS_PER_STRIP, _STRIP_BYTES, _PLANAR = 273, 277, 278, 279, 284


def _tiff_bits(im) -> int:
    bits = im.tag_v2.get(_BITS, (1,))
    return int(bits[0] if isinstance(bits, tuple) else bits)


def _read_tiff16(path: str, im) -> np.ndarray:
    """A 16-bit gray or RGB TIFF's pixels, read from its strips (PIL has
    parsed the tags)."""
    tags = im.tag_v2
    c = int(tags.get(_SAMPLES, 1))
    if (int(tags.get(_COMPRESSION, 1)) != 1 or int(tags.get(_PLANAR, 1)) != 1
            or c not in (1, 3)):
        raise UnsupportedImageFormat(
            "16-bit TIFF that is compressed, planar or not gray/RGB needs imageio")
    w, h = im.size
    with open(path, "rb") as f:
        order = "<" if f.read(2) == b"II" else ">"
        raw = b""
        for off, n in zip(tags[_STRIP_OFFSETS], tags[_STRIP_BYTES]):
            f.seek(off)
            raw += f.read(n)
    px = np.frombuffer(raw, dtype=order + "u2", count=h * w * c).astype(np.uint16)
    return px.reshape((h, w) if c == 1 else (h, w, 3))


def _write_tiff16(path: str, image: np.ndarray) -> None:
    """An uncompressed little-endian baseline TIFF of (H, W[, 3]) uint16
    pixels, in one strip."""
    h, w = image.shape[:2]
    c = 1 if image.ndim == 2 else 3
    data = np.ascontiguousarray(image, dtype="<u2").tobytes()
    n_tags = 10
    bits_off = 8 + 2 + 12 * n_tags + 4  # BitsPerSample's 3 values follow the IFD
    data_off = bits_off + 6
    short, long_ = 3, 4
    entries = [
        (_WIDTH, long_, 1, w), (_LENGTH, long_, 1, h),
        (_BITS, short, c, 16 if c == 1 else bits_off), (_COMPRESSION, short, 1, 1),
        (_PHOTOMETRIC, short, 1, 1 if c == 1 else 2),
        (_STRIP_OFFSETS, long_, 1, data_off), (_SAMPLES, short, 1, c),
        (_ROWS_PER_STRIP, long_, 1, h), (_STRIP_BYTES, long_, 1, len(data)),
        (_PLANAR, short, 1, 1),
    ]
    ifd = struct.pack("<H", n_tags)
    for tag, typ, count, value in entries:
        inline = typ == short and count == 1
        ifd += struct.pack("<HHI", tag, typ, count)
        ifd += struct.pack("<HH", value, 0) if inline else struct.pack("<I", value)
    ifd += struct.pack("<I", 0)
    with open(path, "wb") as f:
        f.write(b"II*\x00" + struct.pack("<I", 8) + ifd + struct.pack("<3H", 16, 16, 16))
        f.write(data)
