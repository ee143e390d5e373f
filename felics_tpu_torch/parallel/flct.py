"""FLCT container layout on the host (numpy and bytes, no device work).

Counterpart: the header, prior and packing helpers of
felics_tpu/parallel/tiling.py; the byte layout is the one in
docs/FORMATS.md:

    0:4    magic "FLCT"
    4      color type      (0 = gray, 1 = rgb)
    5      pixel depth     (0 = 8-bit, 1 = 16-bit)
    6:10   width  u32,  10:14 height u32
    14:16  tile_w u16,  16:18 tile_h u16
    18:20  flags  u16      (bit 0: u16 length table; bit 1: k-prior block)
    20:24  n_tiles u32
    24:..  [flags bit 1] one 4-bit k0 per (channel, bucket), high nibble
           first, zero-padded to a whole byte
    ..     per-tile payload byte length x n_tiles (u16 or u32)
    ..     payload: the tiles' byte-aligned streams, concatenated

v2 containers carry the k-prior and take the u16 table whenever every
tile fits; v0 containers (``k_prior=False``) have flags 0, a u32 table and
all-zero priors. All integers are big-endian.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from functools import cached_property
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np

from felics_tpu_torch import errors
from felics_tpu_torch.config import CodingConfig, TileConfig, tiled_config_for_depth
from felics_tpu_torch.format import ColorType, Header, PixelDepth
from felics_tpu_torch.ops.tile_codec import num_buckets

MAGIC_TILED = b"FLCT"
FIXED_HEADER = struct.Struct(">4sBBIIHHHI")  # 24 bytes
FLAG_TABLE_U16 = 0x0001
FLAG_K_PRIOR = 0x0002
KNOWN_FLAGS = FLAG_TABLE_U16 | FLAG_K_PRIOR
# Every (tile, channel) k-table of a v2 stream starts at
# PRIOR_WEIGHT * |k - k0[channel][bucket]|.
PRIOR_WEIGHT = 4


@dataclass
class TiledHeader:
    color_type: ColorType
    pixel_depth: PixelDepth
    width: int
    height: int
    tile_w: int
    tile_h: int
    n_tiles: int
    # Payload bytes per tile: the container's big-endian table, viewed in
    # place (any integer array when built by hand).
    table: np.ndarray
    flags: int = 0
    k0: Optional[np.ndarray] = None  # (C, nb) int32, v2 only
    payload_off: int = FIXED_HEADER.size

    @property
    def num_channels(self) -> int:
        return 1 if self.color_type == ColorType.GRAY else 3

    @property
    def tile_lengths(self) -> np.ndarray:
        """Payload bytes per tile, int64 (a copy of ``table``)."""
        return self.table.astype(np.int64)

    @cached_property
    def payload_bytes(self) -> int:
        return int(self.table.sum())


def read_tiled_header(data: bytes) -> TiledHeader:
    """Parse and validate the header, prior block and length table of a
    bytes-like container; the table and k0 nibbles are read in place."""
    if len(data) < FIXED_HEADER.size:
        raise errors.IoError("truncated FLCT header")
    magic, color, depth, w, h, tw, th, flags, n_tiles = FIXED_HEADER.unpack_from(data)
    if magic != MAGIC_TILED:
        raise errors.InvalidSignature(f"bad magic {magic!r}")
    if flags & ~KNOWN_FLAGS:
        raise errors.InvalidValue(f"unsupported FLCT flags {flags:#06x}")
    color_type = ColorType.from_byte(color)
    pixel_depth = PixelDepth.from_byte(depth)
    # Encoders never emit tile dims < 2, and the grid the dims imply must
    # match n_tiles: a corrupt field would otherwise mis-slice the payload.
    if tw < 2 or th < 2:
        raise errors.InvalidDimensions(f"invalid tile dims {tw}x{th}")
    expect_tiles = -(-h // th) * -(-w // tw)  # TileConfig(th, tw).grid(h, w)'s tiles
    if n_tiles != expect_tiles:
        raise errors.InvalidDimensions(
            f"tile grid mismatch: header says {n_tiles} tiles, dims imply "
            f"{expect_tiles}"
        )
    pos = FIXED_HEADER.size
    k0 = None
    if flags & FLAG_K_PRIOR:
        c = 1 if color_type == ColorType.GRAY else 3
        consts = _DEPTHS[pixel_depth]
        nbytes = (c * consts.nb + 1) // 2
        if len(data) < pos + nbytes:
            raise errors.IoError("truncated FLCT k-prior block")
        nibs = np.frombuffer(data, np.uint8, nbytes, pos)
        k0 = consts.nibbles[nibs].reshape(-1)[: c * consts.nb].reshape(c, consts.nb)
        pos += nbytes
    entry = 2 if flags & FLAG_TABLE_U16 else 4
    end = pos + entry * n_tiles
    if len(data) < end:
        raise errors.IoError("truncated FLCT tile table")
    table = np.frombuffer(data, ">u2" if flags & FLAG_TABLE_U16 else ">u4", n_tiles, pos)
    return TiledHeader(
        color_type=color_type, pixel_depth=pixel_depth, width=w, height=h,
        tile_w=tw, tile_h=th, n_tiles=n_tiles, table=table,
        flags=flags, k0=k0, payload_off=end,
    )


def prior_from_k0(k0: Optional[np.ndarray], cfg: CodingConfig, c: int):
    """(C, nb, K) int32 k-table seed; None (v0 stream) gives zeros."""
    nb = num_buckets(cfg)
    kv = np.asarray(cfg.k_values, np.int32)
    if k0 is None:
        return np.zeros((c, nb, len(kv)), np.int32)
    k0 = np.minimum(np.asarray(k0, np.int32), kv[-1])
    return (PRIOR_WEIGHT * np.abs(kv[None, None, :] - k0[..., None])).astype(
        np.int32
    )


class _DepthConstants(NamedTuple):
    """What reading a header and seeding its priors need of a pixel depth,
    made once at import (``_DEPTHS``)."""

    nb: int  # context buckets of a k-table
    nibbles: np.ndarray  # (256, 2) int32: a prior byte's two k0, clamped to the largest k
    # (_V0_ROW + 1, K) int32: row k is prior_from_k0's row for k0 = k (0..15),
    # row _V0_ROW a v0 member's zeros.
    prior_rows: np.ndarray


_V0_ROW = 16  # prior_rows' row of a v0 member: past every 4-bit k0


def _depth_constants(depth: PixelDepth) -> _DepthConstants:
    cfg = tiled_config_for_depth(depth)
    byte = np.arange(256)
    # A nibble past the largest k only shapes the prior: clamp it.
    nibbles = np.minimum(np.stack([byte >> 4, byte & 0x0F], 1), cfg.k_values[-1])
    rows = prior_from_k0(np.arange(_V0_ROW)[None], cfg, 1)[0]
    return _DepthConstants(num_buckets(cfg), nibbles.astype(np.int32),
                           np.concatenate([rows, np.zeros_like(rows[:1])]))


_DEPTHS = {depth: _depth_constants(depth) for depth in PixelDepth}


def priors_into(out: np.ndarray, k0s: Sequence[Optional[np.ndarray]],
                depth: PixelDepth) -> None:
    """Write a group's (n, C, nb, K) int32 k-table seeds into ``out``: each
    member's ``prior_from_k0`` of its (C, nb) k0 values (None: a v0
    member, zeros), in one gather of the depth's prior rows over them all."""
    rows = [np.full(out.shape[1:3], _V0_ROW) if k is None else k for k in k0s]
    np.take(_DEPTHS[depth].prior_rows, rows, axis=0, out=out)


def pack_tiled_container(
    header: Header, tw: int, th: int, tile_bytes: np.ndarray, payload: bytes,
    k0: Optional[np.ndarray],
) -> bytes:
    """Header + k-prior block + length table + payload. ``k0`` None writes
    the v0 layout (flags 0, u32 table, no prior block)."""
    n_tiles = len(tile_bytes)
    flags = 0
    prior_blob = b""
    dt = ">u4"
    if k0 is not None:
        flags |= FLAG_K_PRIOR
        nib = np.asarray(k0, np.uint8).reshape(-1)
        if nib.size % 2:
            nib = np.append(nib, np.uint8(0))
        prior_blob = ((nib[0::2] << 4) | nib[1::2]).astype(np.uint8).tobytes()
        if n_tiles == 0 or int(tile_bytes.max(initial=0)) < (1 << 16):
            flags |= FLAG_TABLE_U16
            dt = ">u2"
    fixed = FIXED_HEADER.pack(
        MAGIC_TILED, int(header.color_type), int(header.pixel_depth),
        header.width, header.height, tw, th, flags, n_tiles,
    )
    return fixed + prior_blob + tile_bytes.astype(dt).tobytes() + payload


def empty_container(header: Header, tile: TileConfig) -> bytes:
    """The header-only container of a zero-area image."""
    return FIXED_HEADER.pack(
        MAGIC_TILED, int(header.color_type), int(header.pixel_depth),
        header.width, header.height, max(2, tile.tile_w), max(2, tile.tile_h),
        0, 0,
    )


def clamped_tile_dims(h: int, w: int, tile: TileConfig) -> Tuple[int, int]:
    """Tile dims clamped to the image, never below 2x2."""
    return max(2, min(tile.tile_h, h)), max(2, min(tile.tile_w, w))
