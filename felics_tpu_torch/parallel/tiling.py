"""FLCT tiled container on one device, both directions.

Counterpart: felics_tpu/parallel/tiling.py (``compress_tiled_bytes``,
``decompress_tiled_bytes``, the dispatch/finish halves of its device
chains, ``encode_container_dispatch``/``encode_container_finish`` and
``decode_container_dispatch``/``decode_container_finish``, and its
single-dispatch same-shape chains ``encode_images_dispatch`` /
``decode_images_dispatch``).

Each direction is a dispatch half, which enqueues the whole device chain and
never waits on the device, and a finish half, which waits on the chain's
event and works on the host. Encode dispatch: one staged upload of a
group's images, edge-pad, YCoCg and cut tiles on the device; one exact
k0/prior pass (``k0_prior``: kernel K5 on CUDA, its plain version on the
CPU); the encode kernel at the width hint; exact-byte
compaction (the tiles' byte streams back to back) into a buffer of hinted
capacity; one copy to pinned host memory. Encode finish: relaunch at the
exact width if a stream outgrew the hint, redo the compaction at the exact
size if it outgrew the capacity, then take the payload as one slice of the
pinned buffer and pack the containers. Decode dispatch: one
staged upload of the payload, length table, priors and tile owners; (n,
wd) word rows; the decode kernel; crop, inverse YCoCg and a range check on
the device (one pass over a same-shape batch); one copy to pinned host
memory. Decode finish: wait, and hand back the images with a validity flag
each. ``*_group`` runs the two halves back to back; the batched and
streamed calls in ``batch.py`` interleave them. Container bytes do not
depend on the hints.

``encode_dispatch`` / ``decode_dispatch`` are the eager chains. The entry
points go through ``encode_group_dispatch`` / ``decode_group_dispatch``:
on CUDA a same-shape group has a key (``encode_key`` / ``decode_key``,
the reference's jit keys), runs the eager chain the first time the key is
seen, and from the second time replays the key's CUDA graph of the same
chain (``graphs.py``), fed from and copied back into static pinned
buffers; other groups, and the CPU, run the eager chain.

The halves are built from pieces the sharded paths (``mesh.py``,
``multihost.py``) run on slices of tiles: ``encode_prepare`` (upload,
tiles, k0/prior), ``shard_dispatch`` / ``shard_finish`` (from tiles and
prior on a device to the tiles' byte streams, relaunch and recompaction
included), ``pack_containers``; ``upload_rows`` (payload to word rows on
a device) and ``assemble_dispatch`` (planes to images and flags).

Every function takes ``device``; nothing falls back to another engine or to
the CPU. The k0 sums are int64 at both depths, so the reference's 16-bit
hi/lo split and its ``k0_device_exact`` gate have no counterpart here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from felics_tpu_torch import errors
from felics_tpu_torch.config import CodingConfig, TileConfig, tiled_config_for_depth
from felics_tpu_torch.core.color import rgb_to_ycocg, ycocg_to_rgb
from felics_tpu_torch.core.context import neighbour_indices
from felics_tpu_torch.device import (
    HostCopy, as_pixels, on_device, resolve_device, stage,
    staged_views, upload,
)
from felics_tpu_torch.format import ColorType, Header, PixelDepth, header_for_array
from felics_tpu_torch.ops import _build, tile_codec
from felics_tpu_torch.ops.bits import bit_length
from felics_tpu_torch.parallel import flct, graphs
from felics_tpu_torch.spans import span

# Geometry groups that ran the eager chain, per direction (beside
# graphs.REPLAYS, the groups that replayed a graph), and the synchronous
# redos of ``shard_finish``; callers reset them to 0 to see what a run did.
EAGER = {"encode": 0, "decode": 0}
REDOS = {"width": 0, "capacity": 0}
# The span of each redo's host bookkeeping, by its REDOS key.
REDO_SPANS = {kind: f"felics.finish.redo.{kind}" for kind in REDOS}

# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------


def image_tiles(imgs: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """(N, H, W[, 3]) int32 images -> (N*ty*tx, C, th*tw) int32 tiles:
    edge-pad to whole tiles, YCoCg-R for RGB, row-major tile order (the
    device mirror of the reference's _image_tiles_device/_prepare_tiles)."""
    n, h, w = imgs.shape[:3]
    ty, tx = TileConfig(th, tw).grid(h, w)
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


def image_of_tile(counts: Sequence[int], device: torch.device) -> torch.Tensor:
    """(nt,) int64 owner image of each tile, ``counts[i]`` tiles for image
    i, on ``device``: made there when every image has the same count, else
    uploaded."""
    if len(set(counts)) == 1:
        return torch.arange(len(counts) * counts[0], device=device) // counts[0]
    (img,) = upload([np.repeat(np.arange(len(counts)), counts)], device)
    return img


def k0_prior(
    tiles: torch.Tensor, counts: Sequence[int], th: int, tw: int,
    cfg: CodingConfig,
):
    """Per-image globally best Rice k per (channel, bucket) and the per-tile
    k-table seed: (k0 (n_imgs, C, nb) int32, prior (nt, C, nb, K) int32),
    for (nt, C, th*tw) int32 tiles of which image i owns ``counts[i]``, in
    order.

    Exact int64 sums over each image's out-of-range pixels; ties go to the
    largest k, and a bucket no pixel reached gets the largest k (the native
    codec's uint64 sums and the reference's host pass pick the same). CUDA
    tensors launch K5 (``csrc/flct_k0_prior.cu``: the sums on chip, then
    the pick), on the current stream and without waiting; CPU tensors run
    ``k0_prior_ref``, its plain version."""
    if tiles.dim() != 3 or tiles.dtype != torch.int32:
        raise ValueError("tiles must be an (nt, C, t) int32 tensor")
    nt, c, t = tiles.shape
    if t != th * tw:
        raise ValueError(f"tile planes hold {t} pixels, not {th}x{tw}")
    if sum(counts) != nt or any(n < 0 for n in counts):
        raise ValueError(f"tile counts {list(counts)} do not split {nt} tiles")
    if tiles.device.type == "cpu":
        return k0_prior_ref(tiles, counts, th, tw, cfg)
    if tiles.device.type != "cuda":
        raise ValueError(f"unsupported device {tiles.device}")
    nb, K = tile_codec.num_buckets(cfg), cfg.num_k
    _build.check_kernel_k(K)
    dev, n = tiles.device, len(counts)
    tiles = tiles.contiguous()
    uniform = len(set(counts)) <= 1  # owners tile // counts[0]: no upload
    owners = None if uniform else image_of_tile(counts, dev)
    totals = torch.zeros((n, c, nb, K), dtype=torch.int64, device=dev)
    prior = torch.empty((nt, c, nb, K), dtype=torch.int32, device=dev)
    k0 = torch.empty((n, c, nb), dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.flct_k0_prior(
            tiles.data_ptr(), None if owners is None else owners.data_ptr(),
            counts[0] if uniform and n else 1, totals.data_ptr(), prior.data_ptr(),
            k0.data_ptr(), nt, n, c, th, tw, nb, K, flct.PRIOR_WEIGHT,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "flct_k0_prior")
    tile_codec.launched(prior=int(nt > 0) + int(max(nt, n) > 0))
    return k0, prior


def k0_prior_ref(
    tiles: torch.Tensor, counts: Sequence[int], th: int, tw: int,
    cfg: CodingConfig,
):
    """Plain PyTorch version of K5 (``k0_prior``'s contract): one
    scatter-add of every pixel's K Rice lengths into its tile's bucket row
    (the reference's one-hot reduction in compute_k0_prior_jax), then one
    of the tiles' rows into their images."""
    nt, c, t = tiles.shape
    dev = tiles.device
    nb, K = tile_codec.num_buckets(cfg), cfg.num_k
    a_idx, b_idx = (torch.from_numpy(i.astype(np.int64)).to(dev)
                    for i in neighbour_indices(th, tw))
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
    # (nt, C, t, K), built in place
    wts = (res.unsqueeze(-1) >> ks).add_(ks + 1)
    wts.masked_fill_(~(below | above).unsqueeze(-1), 0)
    row = torch.arange(nt * c, device=dev).reshape(nt, c, 1) * nb + qctx
    per_tile = torch.zeros((nt * c * nb, K), dtype=torch.int64, device=dev)
    per_tile.index_add_(0, row.reshape(-1), wts.reshape(-1, K))
    img = image_of_tile(counts, dev)
    totals = torch.zeros((len(counts), c, nb, K), dtype=torch.int64, device=dev)
    totals.index_add_(0, img, per_tile.reshape(nt, c, nb, K))
    minv = totals.min(dim=-1, keepdim=True).values
    k0 = torch.where(totals == minv, ks, -1).max(dim=-1).values  # (n, C, nb)
    prior = flct.PRIOR_WEIGHT * (ks - k0.unsqueeze(-1)).abs()
    return k0.to(torch.int32), prior[img].to(torch.int32)


def exact_width(max_bits: int) -> int:
    """The bucketed word width that holds a stream of ``max_bits`` bits."""
    return tile_codec.bucket_words(-(-int(max_bits) // 32))


_cap_hints: dict = {}  # (t, c, depth) -> most words a tile used on average in one call


def payload_cap_hint(cfg: CodingConfig, nt: int, t: int, c: int) -> int:
    """Words of the device buffer the compaction writes into: the raw
    planes' size a tile until this shape has been seen, then 1.2x the
    largest mean a tile has used (the reference's payload_cap_hint). A
    payload that outgrows it is compacted again at its exact size, so the
    hint costs a copy's size, never the bytes."""
    key = (t, c, cfg.pixel_depth)
    raw = -(-c * t * cfg.depth_bits // 32) + 2
    hint = _cap_hints.get(key)
    per_tile = raw if hint is None else min(raw, hint + hint // 5 + 16)
    return tile_codec.bucket_words(nt * per_tile)


def observe_payload(cfg: CodingConfig, t: int, c: int, total_words: int, nt: int) -> None:
    key = (t, c, cfg.pixel_depth)
    _cap_hints[key] = max(_cap_hints.get(key, 0), -(-int(total_words) // nt))


def byte_payload(words: torch.Tensor, bits: torch.Tensor, cap: int):
    """Exact-byte compaction on the device, without waiting on it: each
    tile's first (bits + 7) // 8 bytes of its big-endian words, in tile
    order, gathered into ``4 * cap`` bytes (zero past the last used one),
    and the used byte count (1,). A tile's byte count is clamped to its
    row's 4 * W, so a stream that outgrew the width reads no word past its
    row. Bytes past ``4 * cap`` are dropped: the caller compares the count
    with ``4 * cap``. Indices are int32 while every one fits."""
    n, W = words.shape
    narrow = 4 * max(cap, n * W) < 2**31
    idx = torch.int32 if narrow else torch.int64
    lens = ((bits + 7) // 8).clamp(max=4 * W).to(idx)
    ends = torch.cumsum(lens, 0, dtype=idx)
    j = torch.arange(4 * cap, dtype=idx, device=words.device)
    tile = torch.searchsorted(ends, j, right=True, out_int32=narrow).clamp_(max=n - 1)
    o = (j - (ends - lens).index_select(0, tile)).clamp_(0, 4 * W - 1)
    w = words.reshape(-1).index_select(0, tile * W + (o >> 2))
    b = (w >> (24 - 8 * (o & 3))) & 255
    return torch.where(j < ends[-1], b, 0).to(torch.uint8), ends[-1:]


def tile_priors(tiles, counts, th, tw, cfg, k_prior: bool):
    """(k0 (n_imgs, C, nb), prior): ``k0_prior``'s, or zeros (a (C, nb, K)
    prior shared by every tile) without ``k_prior``."""
    if k_prior:
        return k0_prior(tiles, counts, th, tw, cfg)
    c, dev = tiles.shape[1], tiles.device
    nb, K = tile_codec.num_buckets(cfg), cfg.num_k
    return (torch.zeros((len(counts), c, nb), dtype=torch.int32, device=dev),
            torch.zeros((c, nb, K), dtype=torch.int32, device=dev))


def encode_prepare(
    images: Sequence[np.ndarray], headers: Sequence[Header], th: int, tw: int,
    k_prior: bool, device: torch.device,
):
    """The encode chain up to the kernel, for same-geometry images (same
    tile dims, channel count and depth), enqueued on ``device``'s current
    stream: one staged upload, the tiles, and one k0 pass. Returns (tiles
    (nt, C, t), prior (nt, C, nb, K) per tile, or (C, nb, K) zeros without
    ``k_prior``, k0 (n_imgs, C, nb), each image's tile count, cfg). Never
    waits on the device."""
    cfg = tiled_config_for_depth(headers[0].pixel_depth)
    views = upload(images, device)
    if all(im.shape == images[0].shape for im in images):
        tiles = image_tiles(as_pixels(torch.stack(views)), th, tw)
    else:
        tiles = torch.cat([image_tiles(as_pixels(v)[None], th, tw) for v in views])
    tc = TileConfig(th, tw)
    counts = [math.prod(tc.grid(hd.height, hd.width)) for hd in headers]
    k0, prior = tile_priors(tiles, counts, th, tw, cfg, k_prior)
    return tiles, prior, k0, counts, cfg


@dataclass
class ShardPending:
    """The encode chain of a set of tiles in flight, from the kernel to the
    copy to the host: what finish needs to wait on it and redo its width or
    compaction. After finish, ``W``, ``words`` and ``bits`` are those the
    payload was compacted from (the relaunch's when there was one)."""

    cfg: CodingConfig
    th: int
    tw: int
    tiles: torch.Tensor
    prior: torch.Tensor
    W: int
    words: torch.Tensor
    bits: torch.Tensor
    cap: int
    # bits, used byte count, payload bytes, then the extras: a HostCopy, or
    # the lease of a graph replay
    result: HostCopy


@dataclass
class EncodePending(ShardPending):
    """A group's encode chain in flight: its one shard (every tile of the
    group; its one extra is k0) and what finish needs to pack the
    containers."""

    headers: List[Header]
    counts: List[int]
    k_prior: bool


def shard_dispatch(
    tiles: torch.Tensor, prior: torch.Tensor, cfg: CodingConfig, th: int, tw: int,
    *extra: torch.Tensor,
) -> ShardPending:
    """Enqueue the encode chain of tiles and their prior on their device's
    current stream: one encode launch at the width hint, the exact-byte
    compaction into a buffer of hinted capacity and one copy to the host of
    the bit counts, the used byte count, the payload and ``extra`` (tensors
    on the same device). Never waits on the device. The step every shard of a
    sharded encode runs."""
    nt, c, t = tiles.shape
    W = tile_codec.width_hint(cfg, t, c)
    words, bits = tile_codec.encode_tiles(tiles, cfg, th, tw, W, prior)
    cap = payload_cap_hint(cfg, nt, t, c)
    pay, total = byte_payload(words, bits, cap)
    return ShardPending(
        cfg, th, tw, tiles, prior, W, words, bits, cap,
        HostCopy(bits, total, pay, *extra),
    )


def shard_finish(p: ShardPending) -> Tuple[np.ndarray, bytes, List[np.ndarray]]:
    """Wait on a dispatched shard: (each tile's byte length, int64; the
    tiles' byte streams, concatenated; the extras as numpy arrays). A
    stream longer than the width hint is encoded again at its exact width,
    and a payload larger than the capacity compacted again at its exact
    size, both synchronously on the shard's device. Releases the result's
    buffers."""
    try:
        bits_np, total_np, pay_np, *extra = p.result.wait()
        nt, c, t = p.tiles.shape
        max_bits = int(bits_np.max())
        tile_bytes = (bits_np + 7) // 8
        total = int(tile_bytes.sum())
        with on_device(p.tiles.device):
            redo = max_bits > 32 * p.W
            if redo:
                with span(REDO_SPANS["width"]):
                    REDOS["width"] += 1
                    p.W = exact_width(max_bits)
                p.words, p.bits = tile_codec.encode_tiles(
                    p.tiles, p.cfg, p.th, p.tw, p.W, p.prior)
            elif int(total_np[0]) > 4 * p.cap:
                with span(REDO_SPANS["capacity"]):
                    REDOS["capacity"] += 1
                redo = True
            if redo:
                exact = byte_payload(p.words, p.bits, -(-total // 4))[0]
                (pay_np,) = HostCopy(exact).wait()
        tile_codec.observe_width(p.cfg, t, c, max_bits)
        observe_payload(p.cfg, t, c, int(((bits_np + 31) // 32).sum()), nt)
        with span("felics.finish.strip"):
            payload = pay_np[:total].tobytes()
        return tile_bytes, payload, [e.copy() for e in extra]
    finally:
        p.result.release()


def encode_dispatch(
    images: Sequence[np.ndarray], headers: Sequence[Header], th: int, tw: int,
    k_prior: bool, device: torch.device,
) -> EncodePending:
    """Enqueue the encode chain of same-geometry images on the current
    stream: ``encode_prepare``, then ``shard_dispatch`` over all the tiles.
    Never waits on the device."""
    tiles, prior, k0, counts, cfg = encode_prepare(images, headers, th, tw, k_prior, device)
    shard = shard_dispatch(tiles, prior, cfg, th, tw, k0)
    return EncodePending(**vars(shard), headers=list(headers), counts=counts,
                         k_prior=k_prior)


def pack_containers(
    headers: Sequence[Header], counts: Sequence[int], th: int, tw: int,
    tile_bytes: np.ndarray, payload: bytes, k0: Optional[np.ndarray],
) -> List[bytes]:
    """One container per image from the tiles' byte lengths and streams in
    tile order (``counts[i]`` tiles for image i); ``k0`` None writes v0."""
    out, t0, p0 = [], 0, 0
    with span("felics.finish.pack"):
        for i, (hd, n_t) in enumerate(zip(headers, counts)):
            tb = tile_bytes[t0 : t0 + n_t]
            p1 = p0 + int(tb.sum())
            out.append(flct.pack_tiled_container(
                hd, tw, th, tb, payload[p0:p1], None if k0 is None else k0[i],
            ))
            t0, p0 = t0 + n_t, p1
    return out


def encode_finish(p: EncodePending) -> List[bytes]:
    """Wait on a dispatched encode (``shard_finish``) and pack its
    containers."""
    tile_bytes, payload, (k0_np,) = shard_finish(p)
    return pack_containers(p.headers, p.counts, p.th, p.tw, tile_bytes, payload,
                           k0_np if p.k_prior else None)


def encode_key(
    images: Sequence[np.ndarray], headers: Sequence[Header], th: int, tw: int,
    k_prior: bool, device: torch.device,
) -> Optional[tuple]:
    """The graph key of a geometry group's encode, as the reference keys
    its jitted chain: (direction, tile dims, channels, depth, images, image
    dims, width hint, capacity hint, k_prior); None for a group that runs
    eagerly (mixed shapes, or not on CUDA)."""
    if device.type != "cuda" or any(im.shape != images[0].shape for im in images):
        return None
    h0 = headers[0]
    cfg = tiled_config_for_depth(h0.pixel_depth)
    c, t = h0.num_channels, th * tw
    nt = len(images) * math.prod(TileConfig(th, tw).grid(h0.height, h0.width))
    return ("encode", th, tw, c, h0.pixel_depth, len(images), h0.height, h0.width,
            tile_codec.width_hint(cfg, t, c), payload_cap_hint(cfg, nt, t, c), k_prior)


def encode_group_dispatch(
    images: Sequence[np.ndarray], headers: Sequence[Header], th: int, tw: int,
    k_prior: bool, device: torch.device,
) -> EncodePending:
    """A geometry group's encode chain, enqueued: a group with a key
    (``encode_key``) goes through the graph cache, eager the first time
    its key is seen, then one replay of the key's graph; any other group
    through ``encode_dispatch``, the eager chain. A hint that moves makes
    a new key. ``encode_finish`` finishes either. Never waits on the
    device."""
    with span("felics.stage.key"):
        key = encode_key(images, headers, th, tw, k_prior, device)
    lease = None if key is None else graphs.cache(device).acquire(
        key, lambda: _capture_encode(key, device))
    if lease is None:
        EAGER["encode"] += 1
        return encode_dispatch(images, headers, th, tw, k_prior, device)
    _, _, _, _, depth, n, h, w, W, cap, _ = key
    g = lease.graph
    host = g.host_in.numpy().view(images[0].dtype).reshape((n,) + images[0].shape)
    with span("felics.stage.fill"):
        np.stack(images, out=host)
    with on_device(device):
        g.replay()
    o = g.outputs
    per = math.prod(TileConfig(th, tw).grid(h, w))
    return EncodePending(tiled_config_for_depth(depth), th, tw, o["tiles"], o["prior"],
                         W, o["words"], o["bits"], cap, lease, headers=list(headers),
                         counts=[per] * n, k_prior=k_prior)


def _capture_encode(key, device: torch.device) -> graphs.Graph:
    """The graph of a same-shape encode key: from the images' bytes to the
    copy ``encode_dispatch`` makes (bit counts, used byte count, payload,
    k0), through the same ops."""
    _, th, tw, c, depth, n, h, w, W, cap, k_prior = key
    cfg = tiled_config_for_depth(depth)
    narrow = torch.uint8 if depth == PixelDepth.EIGHT else torch.int16
    shape = (n, h, w) + ((3,) if c == 3 else ())
    per = math.prod(TileConfig(th, tw).grid(h, w))

    def body(dev_in):
        tiles = image_tiles(as_pixels(dev_in.view(narrow).reshape(shape)), th, tw)
        k0, prior = tile_priors(tiles, [per] * n, th, tw, cfg, k_prior)
        words, bits = tile_codec.encode_tiles(tiles, cfg, th, tw, W, prior)
        pay, total = byte_payload(words, bits, cap)
        return [bits, total, pay, k0], {"tiles": tiles, "prior": prior,
                                        "words": words, "bits": bits}

    in_bytes = n * h * w * c * (1 if depth == PixelDepth.EIGHT else 2)
    return graphs.capture(key, device, in_bytes, body)


def encode_group(
    images: Sequence[np.ndarray], headers: Sequence[Header], th: int, tw: int,
    k_prior: bool, device: torch.device,
) -> List[bytes]:
    """FLCT containers of same-geometry images: dispatch, then finish."""
    return encode_finish(encode_group_dispatch(images, headers, th, tw, k_prior, device))


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
    payload: torch.Tensor, lens: torch.Tensor, wd: int
) -> torch.Tensor:
    """Concatenated tile streams (uint8) and their byte lengths (int64, on
    the same device) -> (n, wd) int32 rows of big-endian words, zero past
    each tile's byte length (the reference's _expand_columns_jit)."""
    dev = payload.device
    starts = torch.cumsum(lens, 0) - lens
    off = torch.arange(wd * 4, device=dev)
    idx = (starts.unsqueeze(1) + off).clamp(max=max(payload.numel() - 1, 0))
    b = torch.where(
        off < lens.unsqueeze(1), payload[idx].to(torch.int64), 0
    ).reshape(-1, wd, 4)
    w = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)


def plane_bounds(hd: flct.TiledHeader) -> Tuple[int, int]:
    """The least and the largest value a decoded plane may hold: 0 (the
    chroma planes of RGB: minus the depth's maximum) and the maximum."""
    bound = (1 << hd.pixel_depth.bits) - 1
    return (0 if hd.num_channels == 1 else -bound), bound


def assemble_images(bufs: torch.Tensor, hd: flct.TiledHeader, n: int):
    """(n * n_tiles, C, t) planes of n images of ``hd``'s shape, image after
    image -> ((n, H, W[, 3]) int32 pixels, (n,) valid flags), in one pass
    over the batch (the reference's vmapped _assemble_image_body). Raw plane
    values outside the depth's plane bounds flag their image too, even where
    they sit in tile padding, so a corrupt container is rejected the same
    way whichever image it lands in."""
    th, tw, c = hd.tile_h, hd.tile_w, hd.num_channels
    ty, tx = TileConfig(th, tw).grid(hd.height, hd.width)
    lo, bound = plane_bounds(hd)
    planes_ok = ((bufs >= lo) & (bufs <= bound)).reshape(n, -1).all(dim=1)
    planes = (
        bufs.reshape(n, ty, tx, c, th, tw)
        .permute(0, 3, 1, 4, 2, 5)
        .reshape(n, c, ty * th, tx * tw)[:, :, : hd.height, : hd.width]
    )
    if c == 1:
        out = planes[:, 0]
    else:
        r, g, b = ycocg_to_rgb(planes[:, 0], planes[:, 1], planes[:, 2], xp=torch)
        out = torch.stack([r, g, b], dim=-1)
    valid = planes_ok & ((out >= 0) & (out <= bound)).reshape(n, -1).all(dim=1)
    return out, valid


def assemble_image(
    bufs: torch.Tensor, hd: flct.TiledHeader
):
    """(n_tiles, C, t) planes of one image -> ((H, W[, 3]) int32 pixels,
    valid flag): ``assemble_images`` of a batch of one."""
    out, valid = assemble_images(bufs, hd, 1)
    return out[0], valid[0]


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


def row_width(lens: np.ndarray) -> int:
    """The bucketed word width of rows that hold tile streams of ``lens``
    bytes."""
    return tile_codec.bucket_words(int(-(-lens.max(initial=1) // 4)))


def upload_rows(
    lens: np.ndarray, payloads: Sequence[bytes], wd: int,
    arrays: Sequence[np.ndarray], device: torch.device,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Tile streams (``payloads`` back to back) and their byte lengths
    (int64) -> ((n, wd) int32 word rows on ``device``, ``arrays`` as tensors
    there): one staged upload, then ``word_rows``. Never waits on the
    device."""
    pays = [np.frombuffer(p, np.uint8) for p in payloads]
    pays = pays if sum(p.size for p in pays) else [np.zeros(4, np.uint8)]
    arrays = [lens] + list(arrays)
    buf, offs = stage(arrays + pays, device)
    views = staged_views(buf, offs, arrays)
    # The uint8 payloads lie back to back after the arrays.
    return word_rows(buf[offs[len(arrays)] :], views[0], wd), views[1:]


def assembled(
    headers: Sequence[flct.TiledHeader], bufs: torch.Tensor
) -> List[torch.Tensor]:
    """Decoded planes of same-geometry containers, in tile order -> [the
    validity flags, then each image narrowed (uint8, or uint16 bit patterns
    as int16)], assembled, range-checked and cropped on the planes' device:
    one pass over a same-shape batch (``assemble_images``), image by image
    otherwise."""
    h0 = headers[0]
    maxv = (1 << h0.pixel_depth.bits) - 1
    narrow = torch.uint8 if h0.pixel_depth == PixelDepth.EIGHT else torch.int16
    if all((hd.height, hd.width) == (h0.height, h0.width) for hd in headers):
        out, valid = assemble_images(bufs, h0, len(headers))
        return [valid, *out.clamp(0, maxv).to(narrow).unbind(0)]
    imgs, flags, t0 = [], [], 0
    for hd in headers:
        out, valid = assemble_image(bufs[t0 : t0 + hd.n_tiles], hd)
        imgs.append(out.clamp(0, maxv).to(narrow))
        flags.append(valid)
        t0 += hd.n_tiles
    return [torch.stack(flags), *imgs]


def assemble_dispatch(
    headers: Sequence[flct.TiledHeader], bufs: torch.Tensor
) -> HostCopy:
    """One copy to the host of ``assembled(headers, bufs)``. Never waits
    on the device."""
    return HostCopy(*assembled(headers, bufs))


def decode_dispatch(
    headers: Sequence[flct.TiledHeader], payloads: Sequence[bytes],
    device: torch.device,
) -> HostCopy:
    """Enqueue the decode chain of same-geometry containers (same tile dims,
    channel count and depth) on the current stream: one staged upload of
    the payloads, length table, priors and tile owners (``upload_rows``),
    one decode launch, then ``assemble_dispatch``. Never waits on the
    device."""
    h0 = headers[0]
    cfg = tiled_config_for_depth(h0.pixel_depth)
    lens = np.concatenate([hd.tile_lengths for hd in headers])
    priors = np.stack([flct.prior_from_k0(hd.k0, cfg, h0.num_channels) for hd in headers])
    owner = np.repeat(np.arange(len(headers)), [hd.n_tiles for hd in headers])
    rows, (priors_t, owner_t) = upload_rows(
        lens, payloads, row_width(lens), [priors, owner], device)
    prior = priors_t[0] if len(headers) == 1 else priors_t[owner_t]
    bufs = tile_codec.decode_tiles(
        rows, cfg, h0.tile_h, h0.tile_w, h0.num_channels, prior)
    return assemble_dispatch(headers, bufs)


def decode_key(
    headers: Sequence[flct.TiledHeader], device: torch.device
) -> Optional[tuple]:
    """The graph key of a geometry group's decode, as the reference keys
    its jitted chain: (direction, tile dims, channels, depth, images, image
    dims, row width, bucketed payload bytes); None for a group that runs
    eagerly (mixed shapes, or not on CUDA)."""
    h0 = headers[0]
    if device.type != "cuda" or any(
            (hd.height, hd.width) != (h0.height, h0.width) for hd in headers):
        return None
    lens = np.concatenate([hd.tile_lengths for hd in headers])
    return ("decode", h0.tile_h, h0.tile_w, h0.num_channels, h0.pixel_depth,
            len(headers), h0.height, h0.width, row_width(lens),
            payload_bucket(int(lens.sum())))


def decode_group_dispatch(
    headers: Sequence[flct.TiledHeader], payloads: Sequence[bytes],
    device: torch.device,
):
    """A geometry group's decode chain, enqueued: a group with a key
    (``decode_key``) goes through the graph cache, eager the first time
    its key is seen, then one replay of the key's graph; any other group
    through ``decode_dispatch``, the eager chain. ``decode_finish``
    finishes either. Never waits on the device."""
    with span("felics.stage.key"):
        key = decode_key(headers, device)
    h0 = headers[0]
    lease = None if key is None else graphs.cache(device).acquire(
        key, lambda: _capture_decode(key, h0, device))
    if lease is None:
        EAGER["decode"] += 1
        return decode_dispatch(headers, payloads, device)
    host = lease.graph.host_in.numpy()
    with span("felics.stage.fill"):
        cfg = tiled_config_for_depth(h0.pixel_depth)
        lens = np.concatenate([hd.tile_lengths for hd in headers]).astype(np.int64)
        priors = np.stack([flct.prior_from_k0(hd.k0, cfg, h0.num_channels)
                           for hd in headers])
        o1 = lens.nbytes
        o2 = o1 + priors.nbytes
        host[:o1].view(np.int64)[:] = lens
        host[o1:o2].view(np.int32)[:] = priors.reshape(-1)
        for p in payloads:
            host[o2 : o2 + len(p)] = np.frombuffer(p, np.uint8)
            o2 += len(p)
    with on_device(device):
        lease.graph.replay()
    return lease


def payload_bucket(nbytes: int) -> int:
    """A payload's byte count rounded up to a coarse bucket, the size a
    decode graph uploads (the reference's _bucket_bytes)."""
    n = max(1 << 12, int(nbytes))
    gran = 1 << max(10, n.bit_length() - 3)
    return -(-n // gran) * gran


def _capture_decode(key, hd: flct.TiledHeader, device: torch.device) -> graphs.Graph:
    """The graph of a same-shape decode key: from the tile lengths, priors
    and bucketed payload to the copy ``decode_dispatch`` makes (flags, then
    the images), through the same ops."""
    _, th, tw, c, depth, n, _, _, wd, size = key
    cfg = tiled_config_for_depth(depth)
    nb, K = tile_codec.num_buckets(cfg), cfg.num_k
    nt = n * hd.n_tiles
    o1 = 8 * nt
    o2 = o1 + 4 * n * c * nb * K

    def body(dev_in):
        lens = dev_in[:o1].view(torch.int64)
        priors = dev_in[o1:o2].view(torch.int32).reshape(n, c, nb, K)
        rows = word_rows(dev_in[o2:], lens, wd)
        prior = priors[0] if n == 1 else (
            priors.unsqueeze(1).expand(n, hd.n_tiles, c, nb, K).reshape(nt, c, nb, K))
        bufs = tile_codec.decode_tiles(rows, cfg, th, tw, c, prior)
        return assembled([hd] * n, bufs), {}

    return graphs.capture(key, device, o2 + size, body)


def decode_finish(p) -> Tuple[List[np.ndarray], np.ndarray]:
    """Wait on a dispatched decode (a HostCopy, or a graph replay's lease):
    (images, validity flag of each). An image whose flag is False held a
    value outside its depth, and its pixels are clamped garbage. The images
    are copied out of the pinned buffer, which is then released."""
    try:
        flags, *imgs = p.wait()
        with span("felics.finish.copy_out"):
            imgs = [(im if im.dtype == np.uint8 else im.view(np.uint16)).copy()
                    for im in imgs]
            flags = flags.copy()
        return imgs, flags
    finally:
        p.release()


def decode_group(
    headers: Sequence[flct.TiledHeader], payloads: Sequence[bytes],
    device: torch.device,
) -> Tuple[List[np.ndarray], np.ndarray]:
    """Images of same-geometry containers and their validity flags:
    dispatch, then finish."""
    return decode_finish(decode_group_dispatch(headers, payloads, device))


def decompress_tiled_bytes(data: bytes, device="cuda") -> np.ndarray:
    """FLCT container bytes (v0 or v2) -> (H, W[, 3]) uint8/uint16 image."""
    dev = resolve_device(device)
    hd = flct.read_tiled_header(data)
    if hd.height == 0 or hd.width == 0:
        return empty_image(hd)
    (img,), ok = decode_group([hd], [payload_of(data, hd)], dev)
    if not ok[0]:
        raise errors.InvalidValue("decoded value does not fit the pixel depth")
    return img
