"""The FLCS container header.

Counterpart: felics_tpu/format.py (reference: src/compression/format.rs:44-84):
4-byte magic ``FLCS``, 1-byte color type (0 = gray, 1 = RGB), 1-byte pixel
depth (0 = 8-bit, 1 = 16-bit), big-endian u32 width and u32 height, a
14-byte header followed by the bit-packed payload. The FLCT header lives in
``parallel/flct.py``.
"""

from __future__ import annotations

import enum
import io
import struct
from dataclasses import dataclass
from typing import BinaryIO

import numpy as np

from felics_tpu_torch import errors

MAGIC = b"FLCS"
_HEADER_STRUCT = struct.Struct(">4sBBII")
HEADER_SIZE = _HEADER_STRUCT.size  # 14 bytes


class ColorType(enum.IntEnum):
    GRAY = 0
    RGB = 1

    @classmethod
    def from_byte(cls, value: int) -> "ColorType":
        try:
            return cls(value)
        except ValueError:
            raise errors.InvalidColorType(f"invalid color type byte: {value}")


class PixelDepth(enum.IntEnum):
    EIGHT = 0
    SIXTEEN = 1

    @classmethod
    def from_byte(cls, value: int) -> "PixelDepth":
        try:
            return cls(value)
        except ValueError:
            raise errors.InvalidPixelDepth(f"invalid pixel depth byte: {value}")

    @property
    def bits(self) -> int:
        return 8 if self == PixelDepth.EIGHT else 16


@dataclass
class Header:
    color_type: ColorType
    pixel_depth: PixelDepth
    width: int
    height: int

    @property
    def num_channels(self) -> int:
        return 1 if self.color_type == ColorType.GRAY else 3


def header_bytes(header: Header, magic: bytes = MAGIC) -> bytes:
    """The 14-byte FLCS header (reference: src/compression/format.rs:51-61)."""
    return _HEADER_STRUCT.pack(
        magic, int(header.color_type), int(header.pixel_depth),
        header.width, header.height,
    )


def write_header(header: Header, to: BinaryIO, magic: bytes = MAGIC) -> None:
    """Write the 14-byte header to a file object (felics_tpu/format.py::
    write_header)."""
    to.write(header_bytes(header, magic))


def read_header(from_: BinaryIO, magic: bytes = MAGIC) -> Header:
    """Parse and validate a 14-byte header whose signature must be
    ``magic``, reading nothing past it (reference:
    src/compression/format.rs:63-84)."""
    raw = from_.read(HEADER_SIZE)
    if len(raw) < HEADER_SIZE:
        raise errors.IoError("unexpected end of stream while reading header")
    got_magic, color_byte, depth_byte, width, height = _HEADER_STRUCT.unpack(raw)
    if got_magic != magic:
        raise errors.InvalidSignature(f"bad magic: {got_magic!r}")
    return Header(
        color_type=ColorType.from_byte(color_byte),
        pixel_depth=PixelDepth.from_byte(depth_byte),
        width=width,
        height=height,
    )


def read_header_bytes(data: bytes, magic: bytes = MAGIC) -> Header:
    return read_header(io.BytesIO(data), magic)


def header_for_array(image: np.ndarray) -> Header:
    """The header of an (H, W) gray or (H, W, 3) RGB uint8/uint16 image
    (felics_tpu/api.py::header_for_array)."""
    if image.ndim == 2:
        color = ColorType.GRAY
    elif image.ndim == 3 and image.shape[2] == 3:
        color = ColorType.RGB
    else:
        raise ValueError("image must be (H, W) grayscale or (H, W, 3) RGB")
    if image.dtype == np.uint8:
        depth = PixelDepth.EIGHT
    elif image.dtype == np.uint16:
        depth = PixelDepth.SIXTEEN
    else:
        raise ValueError(f"unsupported dtype {image.dtype}; use uint8 or uint16")
    h, w = image.shape[:2]
    return Header(color, depth, w, h)
