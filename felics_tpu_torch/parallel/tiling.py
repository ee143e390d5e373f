"""FLCT tiled container on one device, both directions.

Counterpart: felics_tpu/parallel/tiling.py (``compress_tiled_bytes``,
``decompress_tiled_bytes`` and the one-pass device chains behind them).

Encode: upload the image, edge-pad, YCoCg and cut tiles on the device; one
exact int64 k0/prior pass; the encode kernel (relaunched at the exact width
if a stream outgrew the first); word-aligned compaction; one device-to-host
copy; header. Decode: length table; one upload of the payload; (n, wd)
word rows; the decode kernel; crop, inverse YCoCg and a range check on the
device; one device-to-host copy.

Every function takes ``device``; nothing falls back to another engine or to
the CPU. The k0 sums are int64 at both depths, so the reference's 16-bit
hi/lo split and its ``k0_device_exact`` gate have no counterpart here.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from felics_tpu_torch import errors
from felics_tpu_torch.config import CodingConfig, TileConfig, tiled_config_for_depth
from felics_tpu_torch.core.color import rgb_to_ycocg, ycocg_to_rgb
from felics_tpu_torch.device import (
    neighbours, resolve_device, to_host, upload_image,
)
from felics_tpu_torch.format import ColorType, Header, PixelDepth, header_for_array
from felics_tpu_torch.ops import tile_codec
from felics_tpu_torch.ops.bits import bit_length, words_to_bytes
from felics_tpu_torch.parallel import flct


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------


def image_tiles(imgs: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """(N, H, W[, 3]) int32 images -> (N*ty*tx, C, th*tw) int32 tiles:
    edge-pad to whole tiles, YCoCg-R for RGB, row-major tile order (the
    device mirror of the reference's _image_tiles_device/_prepare_tiles)."""
    n, h, w = imgs.shape[:3]
    ty, tx = -(-h // th), -(-w // tw)
    rows = torch.arange(ty * th, device=imgs.device).clamp(max=h - 1)
    cols = torch.arange(tx * tw, device=imgs.device).clamp(max=w - 1)
    x = imgs[:, rows][:, :, cols]
    if imgs.dim() == 4:
        y, co, cg = rgb_to_ycocg(x[..., 0], x[..., 1], x[..., 2], xp=torch)
        chans = torch.stack([y, co, cg], dim=1)
    else:
        chans = x[:, None]
    c = chans.shape[1]
    return (
        chans.reshape(n, c, ty, th, tx, tw)
        .permute(0, 2, 4, 1, 3, 5)
        .reshape(n * ty * tx, c, th * tw)
        .contiguous()
    )


def k0_prior(
    tiles: torch.Tensor, counts: Sequence[int], th: int, tw: int,
    cfg: CodingConfig,
):
    """Per-image globally best Rice k per (channel, bucket) and the per-tile
    k-table seed: (k0 (n_imgs, C, nb) int32, prior (nt, C, nb, K) int32).

    Exact int64 sums over each image's out-of-range pixels; ties go to the
    largest k, and a bucket no pixel reached gets the largest k (the native
    codec's uint64 sums and the reference's host pass pick the same)."""
    nt, c, t = tiles.shape
    dev = tiles.device
    nb, K = tile_codec.num_buckets(cfg), cfg.num_k
    a_idx, b_idx = neighbours(th, tw, dev)
    x = tiles.to(torch.int64)
    v1, v2 = x[..., a_idx], x[..., b_idx]
    low = torch.minimum(v1, v2)
    ctx = (v1 - v2).abs()
    coded = torch.arange(t, device=dev) >= 2
    below = (x < low) & coded
    above = (x > low + ctx) & coded
    res = torch.where(below, low - x, x - low - ctx) - 1
    qctx = bit_length(ctx, nb - 1)  # min(bit_length(ctx), nb - 1)
    ks = torch.arange(K, dtype=torch.int64, device=dev)
    wts = torch.where(
        (below | above).unsqueeze(-1), (res.unsqueeze(-1) >> ks) + 1 + ks, 0
    )  # (nt, C, t, K)
    per_tile = torch.stack(
        [(wts * (qctx == b).unsqueeze(-1)).sum(dim=2) for b in range(nb)],
        dim=2,
    )  # (nt, C, nb, K)
    img = torch.repeat_interleave(
        torch.arange(len(counts), device=dev),
        torch.as_tensor(list(counts), device=dev),
    )
    totals = torch.zeros((len(counts), c, nb, K), dtype=torch.int64, device=dev)
    totals.index_add_(0, img, per_tile)
    minv = totals.min(dim=-1, keepdim=True).values
    k0 = torch.where(totals == minv, ks, -1).max(dim=-1).values  # (n, C, nb)
    prior = flct.PRIOR_WEIGHT * (ks - k0.unsqueeze(-1)).abs()
    return k0.to(torch.int32), prior[img].to(torch.int32)


def encode_words(
    tiles: torch.Tensor, prior: torch.Tensor, cfg: CodingConfig, th: int,
    tw: int,
):
    """Encode kernel at the width hint; when a stream outgrew it, relaunch
    once at the exact width its bit count asks for. Returns (words, bits)."""
    nt, c, t = tiles.shape
    W = tile_codec.width_hint(cfg, t, c)
    words, bits = tile_codec.encode_tiles(tiles, cfg, th, tw, W, prior)
    max_bits = int(bits.max())
    if max_bits > 32 * W:
        W = tile_codec.bucket_words(-(-max_bits // 32))
        words, bits = tile_codec.encode_tiles(tiles, cfg, th, tw, W, prior)
    tile_codec.observe_width(cfg, t, c, max_bits)
    return words, bits


def aligned_payload(words: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Word-aligned compaction on the device: each tile's used words, in
    tile order, as big-endian bytes (every tile starts on a 4-byte
    boundary; ``flct.strip_word_alignment`` drops the pad bytes)."""
    n, W = words.shape
    used = (bits + 31) // 32
    keep = torch.arange(W, device=words.device).unsqueeze(0) < used.unsqueeze(1)
    return words_to_bytes(words[keep])


def encode_group(
    images: Sequence[np.ndarray], headers: Sequence[Header], th: int, tw: int,
    k_prior: bool, device: torch.device,
) -> List[bytes]:
    """FLCT containers of same-geometry images (same tile dims, channel
    count and depth) with one k0 pass, one encode launch (two if a stream
    outgrew the first width) and one device-to-host copy."""
    cfg = tiled_config_for_depth(headers[0].pixel_depth)
    c = headers[0].num_channels
    nb, K = tile_codec.num_buckets(cfg), cfg.num_k
    tiles = torch.cat(
        [image_tiles(upload_image(im, device)[None], th, tw) for im in images]
    )
    counts = [(-(-hd.height // th)) * (-(-hd.width // tw)) for hd in headers]
    if k_prior:
        k0, prior = k0_prior(tiles, counts, th, tw, cfg)
    else:
        k0 = torch.zeros((len(images), c, nb), dtype=torch.int32, device=device)
        prior = torch.zeros((c, nb, K), dtype=torch.int32, device=device)
    words, bits = encode_words(tiles, prior, cfg, th, tw)
    bits_np, k0_np, pay_np = to_host(bits, k0, aligned_payload(words, bits))
    tile_bytes = (bits_np + 7) // 8
    payload = flct.strip_word_alignment(pay_np, tile_bytes)
    out, t0, p0 = [], 0, 0
    for i, (hd, n_t) in enumerate(zip(headers, counts)):
        tb = tile_bytes[t0 : t0 + n_t]
        p1 = p0 + int(tb.sum())
        out.append(flct.pack_tiled_container(
            hd, tw, th, tb, payload[p0:p1], k0_np[i] if k_prior else None,
        ))
        t0, p0 = t0 + n_t, p1
    return out


def compress_tiled_bytes(
    image: np.ndarray, tile: Optional[TileConfig] = None, k_prior: bool = True,
    device="cuda",
) -> bytes:
    """One (H, W) or (H, W, 3) uint8/uint16 image -> FLCT container bytes.
    ``k_prior=False`` writes a v0 container (no k-prior, u32 table)."""
    dev = resolve_device(device)
    header = header_for_array(image)
    tile = tile or TileConfig()
    if header.height == 0 or header.width == 0:
        return flct.empty_container(header, tile)
    th, tw = flct.clamped_tile_dims(header.height, header.width, tile)
    return encode_group([image], [header], th, tw, k_prior, dev)[0]


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def word_rows(
    payload: torch.Tensor, lens: np.ndarray, wd: int
) -> torch.Tensor:
    """Concatenated tile streams (uint8 on the device) -> (n, wd) int32 rows
    of big-endian words, zero past each tile's byte length (the reference's
    _expand_columns_jit)."""
    dev = payload.device
    lens_t = torch.from_numpy(np.asarray(lens, np.int64)).to(dev)
    starts = torch.cumsum(lens_t, 0) - lens_t
    off = torch.arange(wd * 4, device=dev)
    idx = (starts.unsqueeze(1) + off).clamp(max=max(payload.numel() - 1, 0))
    b = torch.where(
        off < lens_t.unsqueeze(1), payload[idx].to(torch.int64), 0
    ).reshape(-1, wd, 4)
    w = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)


def assemble_image(
    bufs: torch.Tensor, hd: flct.TiledHeader
):
    """(n_tiles, C, t) planes of one image -> ((H, W[, 3]) int32 pixels,
    valid flag). Raw plane values outside the depth's plane bounds flag the
    image too, even where they sit in tile padding, so a corrupt container
    is rejected the same way whichever image it lands in."""
    th, tw, c = hd.tile_h, hd.tile_w, hd.num_channels
    ty, tx = -(-hd.height // th), -(-hd.width // tw)
    bound = (1 << hd.pixel_depth.bits) - 1
    lo = 0 if c == 1 else -bound
    planes_ok = ((bufs >= lo) & (bufs <= bound)).all()
    planes = (
        bufs.reshape(ty, tx, c, th, tw)
        .permute(2, 0, 3, 1, 4)
        .reshape(c, ty * th, tx * tw)[:, : hd.height, : hd.width]
    )
    if c == 1:
        out = planes[0]
    else:
        r, g, b = ycocg_to_rgb(planes[0], planes[1], planes[2], xp=torch)
        out = torch.stack([r, g, b], dim=-1)
    valid = planes_ok & ((out >= 0) & (out <= bound)).all()
    return out, valid


def payload_of(data: bytes, hd: flct.TiledHeader) -> bytes:
    """The container's tile streams, exactly; IoError when truncated."""
    expected = int(hd.tile_lengths.sum())
    if len(data) - hd.payload_off < expected:
        raise errors.IoError("truncated FLCT payload")
    return data[hd.payload_off : hd.payload_off + expected]


def empty_image(hd: flct.TiledHeader) -> np.ndarray:
    dtype = np.uint8 if hd.pixel_depth == PixelDepth.EIGHT else np.uint16
    shape = (hd.height, hd.width)
    if hd.color_type == ColorType.RGB:
        shape += (3,)
    return np.zeros(shape, dtype)


def decode_group(
    headers: Sequence[flct.TiledHeader], payloads: Sequence[bytes],
    device: torch.device,
) -> List[np.ndarray]:
    """Images of same-geometry containers (same tile dims, channel count
    and depth): one payload upload, one decode launch, device assembly and
    one device-to-host copy. Raises InvalidValue for any member whose
    decoded values do not fit its depth."""
    h0 = headers[0]
    cfg = tiled_config_for_depth(h0.pixel_depth)
    c, th, tw = h0.num_channels, h0.tile_h, h0.tile_w
    lens = np.concatenate([hd.tile_lengths for hd in headers])
    wd = tile_codec.bucket_words(int(-(-lens.max(initial=1) // 4)))
    blob = bytearray(b"".join(payloads)) or bytearray(4)
    payload = torch.frombuffer(blob, dtype=torch.uint8).to(device)
    priors = torch.from_numpy(
        np.stack([flct.prior_from_k0(hd.k0, cfg, c) for hd in headers])
    ).to(device)
    if len(headers) == 1:
        prior = priors[0]
    else:
        counts = torch.as_tensor([hd.n_tiles for hd in headers], device=device)
        prior = priors[torch.repeat_interleave(
            torch.arange(len(headers), device=device), counts
        )]
    bufs = tile_codec.decode_tiles(
        word_rows(payload, lens, wd), cfg, th, tw, c, prior
    )
    narrow = torch.uint8 if h0.pixel_depth == PixelDepth.EIGHT else torch.int32
    imgs, flags, t0 = [], [], 0
    for hd in headers:
        out, valid = assemble_image(bufs[t0 : t0 + hd.n_tiles], hd)
        imgs.append(out.clamp(0, (1 << h0.pixel_depth.bits) - 1).to(narrow))
        flags.append(valid)
        t0 += hd.n_tiles
    host = to_host(torch.stack(flags), *imgs)
    if not host[0].all():
        raise errors.InvalidValue("decoded value does not fit the pixel depth")
    dtype = np.uint8 if h0.pixel_depth == PixelDepth.EIGHT else np.uint16
    return [im.astype(dtype) for im in host[1:]]


def decompress_tiled_bytes(data: bytes, device="cuda") -> np.ndarray:
    """FLCT container bytes (v0 or v2) -> (H, W[, 3]) uint8/uint16 image."""
    dev = resolve_device(device)
    hd = flct.read_tiled_header(data)
    if hd.height == 0 or hd.width == 0:
        return empty_image(hd)
    return decode_group([hd], [payload_of(data, hd)], dev)[0]
