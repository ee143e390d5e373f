"""The sequential, bit-exact oracle codec of one channel (numpy and Python
ints).

Counterpart: felics_tpu/core/oracle.py, the behavioural twin of the
reference's channel codec (src/compression.rs:76-248) and its trait impls
(:250-410). It walks the pixels one by one, as the specification reads,
with the scalar coders of ``felics_tpu_torch.coding`` and the
``KEstimator``. It is slow (tens of thousands of pixels a second) and
shares no code with the device codecs, which is what makes it a check of
them: the API's ``backend="oracle"`` and the card's phase 9 of
``chip_smoke.py`` hold K1, K2 and K4 to it.

Stream layout of a channel (bit-continuous; an RGB image's channels follow
each other with one byte-align at the very end, so later channels start at
any bit offset, src/compression.rs:365-369):

  * zero-area image: two raw preamble words of zero;
  * 1x1 image: the pixel, then a raw zero;
  * otherwise: the first two raster pixels raw, then for each pixel
    i in 2..W*H a 1-2 bit range marker (IN = 1, ABOVE = 01, BELOW = 00,
    src/compression.rs:29-45), then either the phase-in code of ``p - L``
    over ``n = context + 1`` (in range) or the Rice code of ``L - p - 1`` /
    ``p - H - 1`` (below / above) at the context's adaptive k, which the
    encoded value then updates.

``compress_image_bytes`` / ``decompress_image_bytes`` wrap the channel
codec into FLCS containers (felics_tpu/api.py's "oracle" backend), and
``compress_tile`` / ``decompress_tile`` into one FLCT tile stream. The
preamble words are signed 32-bit in FLCS. The FLCT tile format
(``bucketed_k``) writes them ``pre_bits`` wide (the depth, plus one for the
signed Co/Cg planes, two's complement truncated), indexes the k-estimator
by ``min(bit_length(context), QCTX_CAP)`` and may seed it with the
container's k-prior.
"""

from __future__ import annotations

import io
from typing import Tuple

import numpy as np

from felics_tpu_torch import errors
from felics_tpu_torch.coding.bitio import BitReader, BitWriter
from felics_tpu_torch.coding.phase_in import PhaseInCoder
from felics_tpu_torch.coding.rice import RiceCoder
from felics_tpu_torch.config import QCTX_CAP, CodingConfig, config_for_depth
from felics_tpu_torch.core.color import rgb_to_ycocg, ycocg_to_rgb
from felics_tpu_torch.core.context import nearest_neighbours
from felics_tpu_torch.core.kestimator import KEstimator
from felics_tpu_torch.format import HEADER_SIZE, ColorType, Header, PixelDepth, write_header

# Range-marker (value, nbits) (reference: src/compression.rs:29-61).
_IN_RANGE = (1, 1)
_ABOVE_RANGE = (0b01, 2)
_BELOW_RANGE = (0b00, 2)


def compress_channel(
    channel: np.ndarray,
    width: int,
    height: int,
    config: CodingConfig,
    bitwriter: BitWriter,
    bucketed_k: bool = False,
    pre_bits: int = 32,
    prior=None,
) -> None:
    """Write one channel (``width * height`` raster values) to ``bitwriter``.

    ``bucketed_k``: index the k-estimator by bit_length(context), the FLCT
    rule, instead of the exact context (FLCS). ``pre_bits``: the raw
    preamble's width (32 for FLCS). ``prior``: an (nb, K) k-table seed,
    the FLCT v2 k-prior (bucketed mode); None = zeros."""
    channel = np.asarray(channel, dtype=np.int64)
    total = width * height
    if total > channel.size:
        raise ValueError("channel is not big enough")
    mask = (1 << pre_bits) - 1

    if width == 0 or height == 0:
        bitwriter.write(pre_bits, 0)
        bitwriter.write(pre_bits, 0)
        return
    pixels = channel[:total].tolist()
    if width == 1 and height == 1:
        bitwriter.write(pre_bits, pixels[0] & mask)
        bitwriter.write(pre_bits, 0)
        return
    bitwriter.write(pre_bits, pixels[0] & mask)
    bitwriter.write(pre_bits, pixels[1] & mask)

    estimator = KEstimator(config.max_context, config.k_values, config.count_scaling, prior)
    coders = {k: RiceCoder(k) for k in config.k_values}

    for i in range(2, total):
        a, b = nearest_neighbours(i, width)
        p = pixels[i]
        v1, v2 = pixels[a], pixels[b]
        h, l = max(v1, v2), min(v1, v2)
        context = h - l
        kctx = min(context.bit_length(), QCTX_CAP) if bucketed_k else context
        k = estimator.get_k(kctx)

        if l <= p <= h:
            bitwriter.write(_IN_RANGE[1], _IN_RANGE[0])
            PhaseInCoder(context + 1).encode(bitwriter, p - l)
        elif p < l:
            bitwriter.write(_BELOW_RANGE[1], _BELOW_RANGE[0])
            coders[k].encode(bitwriter, l - p - 1)
            estimator.update(kctx, l - p - 1)
        else:
            bitwriter.write(_ABOVE_RANGE[1], _ABOVE_RANGE[0])
            coders[k].encode(bitwriter, p - h - 1)
            estimator.update(kctx, p - h - 1)


def decompress_channel(
    width: int,
    height: int,
    config: CodingConfig,
    bitreader: BitReader,
    bucketed_k: bool = False,
    pre_bits: int = 32,
    pre_signed: bool = False,
    prior=None,
) -> np.ndarray:
    """Read one channel from ``bitreader``: an int64 array of
    ``width * height`` raster values. The modes are ``compress_channel``'s;
    ``pre_signed`` sign-extends a preamble narrower than 32 bits (the FLCT
    Co/Cg planes). A corrupt stream raises a ``DecompressionError``."""

    def read_pre() -> int:
        raw = bitreader.read(pre_bits)
        if pre_bits == 32 or pre_signed:
            sign = 1 << (pre_bits - 1)
            return (raw ^ sign) - sign
        return raw

    pixel1 = read_pre()
    pixel2 = read_pre()

    if width == 0 or height == 0:
        return np.zeros(0, dtype=np.int64)
    if width == 1 and height == 1:
        return np.array([pixel1], dtype=np.int64)

    total = width * height
    if total > 2**31:
        raise errors.InvalidDimensions("image too large")
    buf = [0] * total
    buf[0], buf[1] = pixel1, pixel2

    estimator = KEstimator(config.max_context, config.k_values, config.count_scaling, prior)
    coders = {k: RiceCoder(k) for k in config.k_values}
    i32_min, i32_max = -(2**31), 2**31 - 1

    for i in range(2, total):
        a, b = nearest_neighbours(i, width)
        v1, v2 = buf[a], buf[b]
        h, l = max(v1, v2), min(v1, v2)
        context = h - l
        if context > config.max_context:
            # Only a corrupt stream gets here: valid pixels keep H - L
            # within MAX_CONTEXT (the reference panics instead).
            raise errors.InvalidValue("context exceeds MAX_CONTEXT")
        kctx = min(context.bit_length(), QCTX_CAP) if bucketed_k else context
        k = estimator.get_k(kctx)

        if bitreader.read_bit():  # in range
            value = PhaseInCoder(context + 1).decode(bitreader) + l
        else:
            above = bitreader.read_bit()
            encoded = coders[k].decode(bitreader)
            estimator.update(kctx, encoded)
            if encoded > i32_max:
                raise errors.InvalidValue("decoded residual does not fit i32")
            value = encoded + h + 1 if above else l - encoded - 1
        if not i32_min <= value <= i32_max:
            raise errors.ValueOverflow("decoded pixel overflows i32")
        buf[i] = value
    return np.array(buf, dtype=np.int64)


# One FLCT tile stream on the oracle: the tile's planes one after the other,
# each in bucketed-k mode with a depth-wide preamble (plus one bit, signed,
# for the Co/Cg planes) and its plane's slice of the k-prior
# (docs/FORMATS.md; tests/test_tiled.py::scalar_decode_tile_stream).


def _tile_modes(cfg: CodingConfig, plane: int, prior) -> dict:
    return {"bucketed_k": True, "pre_bits": cfg.depth_bits + (1 if plane else 0),
            "prior": None if prior is None else prior[plane]}


def compress_tile(
    planes, th: int, tw: int, cfg: CodingConfig, prior=None,
) -> Tuple[bytes, int]:
    """The stream of one (C, th*tw) tile under the tiled config ``cfg`` and
    a (C, nb, K) k-prior (None for v0): its bytes, zero-padded to a byte,
    and its exact bit count."""
    writer = BitWriter()
    for ch, plane in enumerate(planes):
        compress_channel(plane, tw, th, cfg, writer, **_tile_modes(cfg, ch, prior))
    bits = writer.bit_length
    writer.byte_align()
    return writer.getvalue(), bits


def decompress_tile(
    data: bytes, th: int, tw: int, channels: int, cfg: CodingConfig, prior=None,
) -> Tuple[np.ndarray, int]:
    """The (C, th*tw) int64 planes of one tile stream, and the bit it ended
    at; ``compress_tile``'s inverse."""
    reader = BitReader(data)
    planes = [
        decompress_channel(
            tw, th, cfg, reader, pre_signed=ch > 0, **_tile_modes(cfg, ch, prior))
        for ch in range(channels)
    ]
    return np.stack(planes), reader.bit_position


# The FLCS container on the oracle: felics_tpu/api.py's "oracle" backend
# (:155-171, :255-270).
_DTYPES = {PixelDepth.EIGHT: np.uint8, PixelDepth.SIXTEEN: np.uint16}


def compress_image_bytes(image: np.ndarray, header: Header) -> bytes:
    """The FLCS container of ``image`` (``header`` is its header): gray as
    one channel, RGB as Y, Co, Cg one after the other, one byte-align at
    the end."""
    config = config_for_depth(header.pixel_depth)
    out = io.BytesIO()
    write_header(header, out)
    writer = BitWriter()
    if header.color_type == ColorType.GRAY:
        channels = [image.reshape(-1)]
    else:
        planes = image.reshape(-1, 3).astype(np.int32)
        channels = rgb_to_ycocg(planes[:, 0], planes[:, 1], planes[:, 2])
    for chan in channels:
        compress_channel(chan, header.width, header.height, config, writer)
    writer.byte_align()
    out.write(writer.getvalue())
    return out.getvalue()


def decompress_image_bytes(data: bytes, header: Header) -> np.ndarray:
    """The (H, W[, 3]) uint8/uint16 image of an FLCS container whose
    header, already read, is ``header``."""
    config = config_for_depth(header.pixel_depth)
    dtype = _DTYPES[header.pixel_depth]
    reader = BitReader(data, start_bit=HEADER_SIZE * 8)
    w, h = header.width, header.height

    if header.color_type == ColorType.GRAY:
        channel = decompress_channel(w, h, config, reader)
        return _to_dtype(channel, dtype).reshape(h, w)

    y, co, cg = (decompress_channel(w, h, config, reader) for _ in range(3))
    for chan in (y, co, cg):
        _check_i32(chan)
    r, g, b = ycocg_to_rgb(y.astype(np.int32), co.astype(np.int32), cg.astype(np.int32))
    rgb = np.stack([_to_dtype(r, dtype), _to_dtype(g, dtype), _to_dtype(b, dtype)], axis=-1)
    return rgb.reshape(h, w, 3)


def _check_i32(arr: np.ndarray) -> None:
    if arr.size and (arr.min() < -(2**31) or arr.max() > 2**31 - 1):
        raise errors.ValueOverflow("channel value overflows i32")


def _to_dtype(channel: np.ndarray, dtype) -> np.ndarray:
    info = np.iinfo(dtype)
    if channel.size and (channel.min() < info.min or channel.max() > info.max):
        raise errors.InvalidValue("decoded value does not fit the pixel depth")
    return channel.astype(dtype)
