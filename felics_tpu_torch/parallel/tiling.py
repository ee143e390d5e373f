"""FLCT tiled container on one device, both directions.

Counterpart: felics_tpu/parallel/tiling.py (``compress_tiled_bytes``,
``decompress_tiled_bytes``, the dispatch/finish halves of its device chains
and its single-dispatch same-shape chains ``encode_images_dispatch`` /
``decode_images_dispatch``).

A geometry group's dispatch plans it once (``encode_plan`` /
``decode_plan``: shapes and hints, the reference's jit key), fills one
uint8 input with its bytes (``fill_images`` / ``fill_containers``) and
enqueues the direction's one chain body on it without waiting. Encode
(``encode_chain``): views of the images, edge-pad, YCoCg and tiles; one
exact k0/prior pass (``k0_prior``: K5 on CUDA, its plain version on the
CPU); K1 at the width hint; exact-byte compaction into a buffer of hinted
capacity. Decode (``decode_chain``): word rows of the payload, K2, crop,
inverse YCoCg and a range check. The finish halves wait on the chain's
event; encode's relaunches K1 at the exact width, or compacts again at the
exact size, where a hint was short (bytes never depend on the hints) and
packs the containers; decode's hands back the images and a validity flag
each.

The body runs eagerly (``encode_dispatch`` / ``decode_dispatch``: the input
staged and uploaded, the results copied back in one ``HostCopy``) or in a
CUDA graph: through ``encode_group_dispatch`` / ``decode_group_dispatch`` a
same-shape group on CUDA has its plan for key, runs eagerly at the key's
first sighting and replays the key's graph of the same body after
(``graphs.py``). The sharded paths (``mesh.py``, ``multihost.py``) run the
bodies' halves on slices of tiles: ``encode_images`` then ``shard_dispatch``
/ ``shard_finish``; ``decode_planes`` then ``assembled``.

Every function takes ``device``; nothing falls back to another engine or to
the CPU. The k0 sums are int64 at both depths, so the reference's 16-bit
hi/lo split and its ``k0_device_exact`` gate have no counterpart here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from felics_tpu_torch import errors
from felics_tpu_torch.config import CodingConfig, TileConfig, tiled_config_for_depth
from felics_tpu_torch.core.color import rgb_to_ycocg, ycocg_to_rgb
from felics_tpu_torch.core.context import neighbour_indices
from felics_tpu_torch.device import (
    HostCopy, as_pixels, on_device, resolve_device, upload, upload_filled,
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
# Plans: what both directions share
# ---------------------------------------------------------------------------


def same_shape(dims: Sequence[Tuple[int, int]]) -> bool:
    return dims.count(dims[0]) == len(dims)


def tile_counts(th: int, tw: int, dims: Sequence[Tuple[int, int]]) -> List[int]:
    """The tiles of each (height, width) image at th x tw tiles, in order."""
    grid = TileConfig(th, tw).grid
    if same_shape(dims):
        return [math.prod(grid(*dims[0]))] * len(dims)
    return [math.prod(grid(h, w)) for h, w in dims]


def keyed(plan, device: torch.device) -> bool:
    """A same-shape group on CUDA: its plan keys a graph."""
    return device.type == "cuda" and same_shape(plan.dims)


def run_chain(plan, device: torch.device, fill: Callable, chain: Callable, graph: bool):
    """Enqueue ``chain(input, plan)``, ``fill(host)`` writing its input into
    a uint8 host array: with ``graph``, a ``keyed`` plan's graph of it from
    ``device``'s cache, its static input filled, replayed; else (counted in
    ``EAGER`` with ``graph``) the input staged and uploaded, the chain run
    eagerly and one ``HostCopy`` of its results. Returns (the lease or the
    HostCopy, the chain's kept tensors). Never waits on the device."""
    lease = None
    if graph and keyed(plan, device):
        lease = graphs.cache(device).acquire(plan, lambda: graphs.capture(
            plan, device, plan.in_bytes(), lambda buf: chain(buf, plan)))
    if lease is None:
        if graph:
            EAGER[plan.direction] += 1
        copied, kept = chain(upload_filled(plan.in_bytes(), device, fill), plan)
        return HostCopy(*copied), kept
    host = lease.graph.host_in.numpy()
    with span("felics.stage.fill"):
        fill(host)
    with on_device(device):
        lease.graph.replay()
    return lease, lease.graph.outputs


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


class EncodePlan(NamedTuple):
    """A geometry group's encode, planned once a call (``encode_plan``): the
    key of its graph, and the shapes and hints its chain and finish read."""

    direction: str  # "encode", the counters' key (graphs.REPLAYS)
    tile_h: int
    tile_w: int
    num_channels: int
    pixel_depth: PixelDepth
    dims: Tuple[Tuple[int, int], ...]  # (height, width) of each image
    W: int  # width hint, words of a tile's stream
    cap: int  # capacity hint, words of the compacted payload
    k_prior: bool

    @property
    def cfg(self) -> CodingConfig:
        return tiled_config_for_depth(self.pixel_depth)

    def in_bytes(self) -> int:  # the images back to back
        px = sum(h * w for h, w in self.dims) * self.num_channels
        return px * (1 if self.pixel_depth == PixelDepth.EIGHT else 2)


def encode_plan(
    headers: Sequence[Header], th: int, tw: int, k_prior: bool, shards: int = 1,
) -> EncodePlan:
    """The plan of a geometry group's encode (same tile dims, channels and
    depth): the one read of the width hint, and of the capacity hint for
    the tiles one of ``shards`` equal shards holds."""
    h0 = headers[0]
    cfg = tiled_config_for_depth(h0.pixel_depth)
    c, t = h0.num_channels, th * tw
    dims = tuple((hd.height, hd.width) for hd in headers)
    nt = -(-sum(tile_counts(th, tw, dims)) // shards)
    return EncodePlan("encode", th, tw, c, h0.pixel_depth, dims,
                      tile_codec.width_hint(cfg, t, c), payload_cap_hint(cfg, nt, t, c),
                      k_prior)


def fill_images(host: np.ndarray, plan: EncodePlan, images: Sequence[np.ndarray]) -> None:
    """The encode input's layout, written into a uint8 host array: the
    images back to back, in either RGB memory layout (one ``np.stack`` for
    a same-shape group)."""
    if same_shape(plan.dims):
        im0 = images[0]
        np.stack(images, out=host.view(im0.dtype).reshape((len(images),) + im0.shape))
        return
    off = 0
    for im in images:
        host[off : off + im.nbytes].view(im.dtype).reshape(im.shape)[...] = im
        off += im.nbytes


def image_views(buf: torch.Tensor, plan: EncodePlan) -> List[torch.Tensor]:
    """The images ``fill_images`` wrote into ``buf``, as views of it
    (uint16 as int16 bit patterns): one (n, H, W[, 3]) batch for a
    same-shape group, else one (1, H, W[, 3]) batch an image."""
    px = buf.view(torch.uint8 if plan.pixel_depth == PixelDepth.EIGHT else torch.int16)
    c = plan.num_channels
    chans = (3,) if c == 3 else ()
    if same_shape(plan.dims):
        return [px.reshape((len(plan.dims),) + plan.dims[0] + chans)]
    out, off = [], 0
    for h, w in plan.dims:
        out.append(px[off : off + h * w * c].reshape((1, h, w) + chans))
        off += h * w * c
    return out


def encode_images(buf: torch.Tensor, plan: EncodePlan):
    """The encode chain's first half, on ``buf``'s device: the images'
    tiles (N*ty*tx, C, t), k0 (n_imgs, C, nb) and the per-tile prior of
    ``k0_prior``; without ``k_prior``, zeros and one (C, nb, K) prior."""
    th, tw, cfg = plan.tile_h, plan.tile_w, plan.cfg
    parts = [image_tiles(as_pixels(v), th, tw) for v in image_views(buf, plan)]
    tiles = parts[0] if len(parts) == 1 else torch.cat(parts)
    if plan.k_prior:
        return (tiles, *k0_prior(tiles, tile_counts(th, tw, plan.dims), th, tw, cfg))
    c, nb, dev = plan.num_channels, tile_codec.num_buckets(cfg), tiles.device
    return (tiles, torch.zeros((len(plan.dims), c, nb), dtype=torch.int32, device=dev),
            torch.zeros((c, nb, cfg.num_k), dtype=torch.int32, device=dev))


def encode_payload(tiles: torch.Tensor, prior: torch.Tensor, plan: EncodePlan):
    """The encode chain's second half: one encode launch at the plan's
    width, the exact-byte compaction into its capacity. Returns ([bit
    counts, used byte count, payload bytes], the tensors finish keeps)."""
    words, bits = tile_codec.encode_tiles(tiles, plan.cfg, plan.tile_h, plan.tile_w,
                                          plan.W, prior)
    pay, total = byte_payload(words, bits, plan.cap)
    return [bits, total, pay], {"tiles": tiles, "prior": prior, "words": words,
                                "bits": bits}


def encode_chain(buf: torch.Tensor, plan: EncodePlan):
    """A group's encode chain from its input bytes, eager or captured:
    ([bit counts, used byte count, payload bytes, k0], the tensors finish
    keeps)."""
    tiles, k0, prior = encode_images(buf, plan)
    copied, kept = encode_payload(tiles, prior, plan)
    return copied + [k0], kept


@dataclass
class EncodePending:
    """An encode chain in flight: what finish needs to wait on it, redo its
    width or compaction and pack a group's containers. After finish, ``W``,
    ``words`` and ``bits`` are those the payload was compacted from (the
    relaunch's when there was one)."""

    plan: EncodePlan
    W: int
    tiles: torch.Tensor
    prior: torch.Tensor
    words: torch.Tensor
    bits: torch.Tensor
    # bits, used byte count, payload bytes, then the extras (a group's k0):
    # a HostCopy, or the lease of a graph replay
    result: HostCopy
    headers: Sequence[Header] = ()


def shard_dispatch(
    tiles: torch.Tensor, prior: torch.Tensor, plan: EncodePlan, *extra: torch.Tensor,
) -> EncodePending:
    """``encode_payload`` on tiles and their prior, then one copy to the
    host of its results and ``extra`` (tensors on the same device), on
    their device's current stream: what every shard of a sharded encode
    runs. Never waits on the device."""
    copied, kept = encode_payload(tiles, prior, plan)
    return EncodePending(plan, plan.W, result=HostCopy(*copied, *extra), **kept)


def shard_finish(p: EncodePending) -> Tuple[np.ndarray, bytes, List[np.ndarray]]:
    """Wait on a dispatched shard: (each tile's byte length, int64; the
    tiles' byte streams, concatenated; the extras as numpy arrays). A
    stream longer than the width hint is encoded again at its exact width,
    and a payload larger than the capacity compacted again at its exact
    size, both synchronously on the shard's device. Releases the result's
    buffers."""
    plan = p.plan
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
                    p.tiles, plan.cfg, plan.tile_h, plan.tile_w, p.W, p.prior)
            elif int(total_np[0]) > 4 * plan.cap:
                with span(REDO_SPANS["capacity"]):
                    REDOS["capacity"] += 1
                redo = True
            if redo:
                exact = byte_payload(p.words, p.bits, -(-total // 4))[0]
                (pay_np,) = HostCopy(exact).wait()
        tile_codec.observe_width(plan.cfg, t, c, max_bits)
        observe_payload(plan.cfg, t, c, int(((bits_np + 31) // 32).sum()), nt)
        with span("felics.finish.strip"):
            payload = pay_np[:total].tobytes()
        return tile_bytes, payload, [e.copy() for e in extra]
    finally:
        p.result.release()


def _encode(images, headers, th, tw, k_prior, device, graph: bool) -> EncodePending:
    with span("felics.stage.key"):
        plan = encode_plan(headers, th, tw, k_prior)
    result, kept = run_chain(plan, device, lambda host: fill_images(host, plan, images),
                             encode_chain, graph)
    return EncodePending(plan, plan.W, result=result, headers=headers, **kept)


def encode_dispatch(
    images: Sequence[np.ndarray], headers: Sequence[Header], th: int, tw: int,
    k_prior: bool, device: torch.device,
) -> EncodePending:
    """Enqueue the encode chain of same-geometry images eagerly on the
    current stream. Never waits on the device."""
    return _encode(images, headers, th, tw, k_prior, device, False)


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
    plan = p.plan
    return pack_containers(
        p.headers, tile_counts(plan.tile_h, plan.tile_w, plan.dims), plan.tile_h,
        plan.tile_w, tile_bytes, payload, k0_np if plan.k_prior else None)


def encode_group_dispatch(
    images: Sequence[np.ndarray], headers: Sequence[Header], th: int, tw: int,
    k_prior: bool, device: torch.device,
) -> EncodePending:
    """A geometry group's encode chain, enqueued: a ``keyed`` group goes
    through the graph cache, eager the first time its plan is seen, then
    one replay of the plan's graph; any other group eagerly. A hint that
    moves makes a new plan. ``encode_finish`` finishes either. Never waits
    on the device."""
    return _encode(images, headers, th, tw, k_prior, device, True)


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
    return encode_finish(encode_group_dispatch([image], [header], th, tw, k_prior, dev))[0]


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


def assemble_images(bufs: torch.Tensor, plan: DecodePlan):
    """(nt, C, t) planes of a same-shape plan's n images, image after image
    -> ((n, H, W[, 3]) int32 pixels, (n,) valid flags), in one pass over the
    batch (the reference's vmapped _assemble_image_body). Raw plane values
    outside the depth's plane bounds flag their image too, even where they
    sit in tile padding, so a corrupt container is rejected the same way
    whichever image it lands in."""
    th, tw, c = plan.tile_h, plan.tile_w, plan.num_channels
    n, (h, w) = len(plan.dims), plan.dims[0]
    ty, tx = TileConfig(th, tw).grid(h, w)
    lo, bound = plane_bounds(plan)
    planes_ok = ((bufs >= lo) & (bufs <= bound)).reshape(n, -1).all(dim=1)
    planes = (
        bufs.reshape(n, ty, tx, c, th, tw)
        .permute(0, 3, 1, 4, 2, 5)
        .reshape(n, c, ty * th, tx * tw)[:, :, :h, :w]
    )
    if c == 1:
        out = planes[:, 0]
    else:
        r, g, b = ycocg_to_rgb(planes[:, 0], planes[:, 1], planes[:, 2], xp=torch)
        out = torch.stack([r, g, b], dim=-1)
    valid = planes_ok & ((out >= 0) & (out <= bound)).reshape(n, -1).all(dim=1)
    return out, valid


def payload_of(data: bytes, hd: flct.TiledHeader) -> memoryview:
    """The container's tile streams, exactly, as a view of ``data`` (no
    copy); IoError when truncated."""
    expected = hd.payload_bytes
    if len(data) - hd.payload_off < expected:
        raise errors.IoError("truncated FLCT payload")
    return memoryview(data)[hd.payload_off : hd.payload_off + expected]


def empty_image(hd: flct.TiledHeader) -> np.ndarray:
    dtype = np.uint8 if hd.pixel_depth == PixelDepth.EIGHT else np.uint16
    shape = (hd.height, hd.width)
    if hd.color_type == ColorType.RGB:
        shape += (3,)
    return np.zeros(shape, dtype)


def row_width(*tables: np.ndarray) -> int:
    """The bucketed word width of rows that hold tile streams of the byte
    lengths in ``tables``."""
    return tile_codec.bucket_words(-(-max(int(t.max(initial=1)) for t in tables) // 4))


class DecodePlan(NamedTuple):
    """A geometry group's decode, planned once a call (``decode_plan``): the
    key of its graph and its input's layout."""

    direction: str  # "decode", the counters' key (graphs.REPLAYS)
    tile_h: int
    tile_w: int
    num_channels: int
    pixel_depth: PixelDepth
    dims: Tuple[Tuple[int, int], ...]  # (height, width) of each image
    nt: int  # tile streams, the length table's entries
    wd: int  # words of a row
    size: int  # payload bytes the input holds (``payload_bucket``)

    @property
    def cfg(self) -> CodingConfig:
        return tiled_config_for_depth(self.pixel_depth)

    def offsets(self) -> Tuple[int, int]:
        """The decode input's layout: the (nt,) int64 length table at 0,
        then the priors, (n, C, nb, K) int32, and the payload at these two
        byte offsets."""
        cfg = self.cfg
        o1 = 8 * self.nt
        return o1, o1 + 4 * len(self.dims) * self.num_channels * (
            tile_codec.num_buckets(cfg) * cfg.num_k)

    def in_bytes(self) -> int:
        return self.offsets()[1] + self.size


def decode_plan(
    headers: Sequence[flct.TiledHeader], lens: Optional[np.ndarray] = None,
) -> DecodePlan:
    """The plan of a decode of same-geometry containers' tile streams of
    ``lens`` bytes (one integer array over the group; None reads each
    header's own table)."""
    h0 = headers[0]
    if lens is None:
        tables = [hd.table for hd in headers]
        nbytes = sum(hd.payload_bytes for hd in headers)
    else:
        tables, nbytes = [lens], int(lens.sum())
    return DecodePlan("decode", h0.tile_h, h0.tile_w, h0.num_channels, h0.pixel_depth,
                      tuple((hd.height, hd.width) for hd in headers),
                      sum(len(t) for t in tables), row_width(*tables),
                      payload_bucket(nbytes))


def fill_containers(
    host: np.ndarray, plan: DecodePlan, headers: Sequence[flct.TiledHeader],
    lens: Optional[np.ndarray], payloads: Sequence[bytes],
) -> None:
    """The decode input's layout (``DecodePlan.offsets``), written into a
    uint8 host array: the length table (``lens``, or with None each
    header's big-endian table in turn), every header's prior in one pass,
    the payloads back to back, each copied once from its bytes-like."""
    o1, o2 = plan.offsets()
    table = host[:o1].view(np.int64)
    at = 0
    for t in [hd.table for hd in headers] if lens is None else [lens]:
        table[at : at + len(t)] = t
        at += len(t)
    cfg = plan.cfg
    flct.priors_into(
        host[o1:o2].view(np.int32).reshape(
            len(headers), plan.num_channels, tile_codec.num_buckets(cfg), cfg.num_k),
        [hd.k0 for hd in headers], plan.pixel_depth)
    for p in payloads:
        n = len(p)
        host[o2 : o2 + n] = np.frombuffer(p, np.uint8)
        o2 += n


def container_views(buf: torch.Tensor, plan: DecodePlan):
    """What ``fill_containers`` wrote into ``buf``, as views of it: (lens,
    priors, payload bytes)."""
    o1, o2 = plan.offsets()
    cfg = plan.cfg
    priors = buf[o1:o2].view(torch.int32).reshape(
        len(plan.dims), plan.num_channels, tile_codec.num_buckets(cfg), cfg.num_k)
    return buf[:o1].view(torch.int64), priors, buf[o2:]


def decode_planes(buf: torch.Tensor, plan: DecodePlan) -> torch.Tensor:
    """The decode chain's first half, on ``buf``'s device: word rows, each
    tile's prior (the image's, expanded over a same-shape batch) and the
    decode launch. Returns the (nt, C, t) planes."""
    lens, priors, payload = container_views(buf, plan)
    rows = word_rows(payload, lens, plan.wd)
    n, nt = priors.shape[0], plan.nt
    if n == 1:
        prior = priors[0]
    elif same_shape(plan.dims):
        prior = priors.unsqueeze(1).expand(n, nt // n, *priors.shape[1:]).reshape(
            nt, *priors.shape[1:])
    else:
        prior = priors[image_of_tile(tile_counts(plan.tile_h, plan.tile_w, plan.dims),
                                     buf.device)]
    return tile_codec.decode_tiles(rows, plan.cfg, plan.tile_h, plan.tile_w,
                                   plan.num_channels, prior)


def assembled(plan: DecodePlan, bufs: torch.Tensor) -> List[torch.Tensor]:
    """Decoded planes of a plan's images, in tile order -> [the validity
    flags, then each image narrowed (uint8, or uint16 bit patterns as
    int16)], assembled, range-checked and cropped on the planes' device:
    one pass over a same-shape batch (``assemble_images``), image by image
    otherwise."""
    maxv = (1 << plan.pixel_depth.bits) - 1
    narrow = torch.uint8 if plan.pixel_depth == PixelDepth.EIGHT else torch.int16
    if same_shape(plan.dims):
        out, valid = assemble_images(bufs, plan)
        return [valid, *out.clamp(0, maxv).to(narrow).unbind(0)]
    imgs, flags, t0 = [], [], 0
    for dims, n_t in zip(plan.dims, tile_counts(plan.tile_h, plan.tile_w, plan.dims)):
        out, valid = assemble_images(bufs[t0 : t0 + n_t], plan._replace(dims=(dims,), nt=n_t))
        imgs.append(out[0].clamp(0, maxv).to(narrow))
        flags.append(valid[0])
        t0 += n_t
    return [torch.stack(flags), *imgs]


def decode_chain(buf: torch.Tensor, plan: DecodePlan):
    """A group's decode chain from its input bytes, eager or captured:
    ([flags, then the images], nothing kept)."""
    return assembled(plan, decode_planes(buf, plan)), {}


def _decode(headers, payloads, device, graph: bool):
    with span("felics.stage.key"):
        plan = decode_plan(headers)
    return run_chain(
        plan, device, lambda host: fill_containers(host, plan, headers, None, payloads),
        decode_chain, graph)[0]


def decode_dispatch(
    headers: Sequence[flct.TiledHeader], payloads: Sequence[bytes],
    device: torch.device,
) -> HostCopy:
    """Enqueue the decode chain of same-geometry containers (same tile dims,
    channel count and depth) eagerly on the current stream. Never waits on
    the device."""
    return _decode(headers, payloads, device, False)


def decode_group_dispatch(
    headers: Sequence[flct.TiledHeader], payloads: Sequence[bytes],
    device: torch.device,
):
    """A geometry group's decode chain, enqueued: a ``keyed`` group goes
    through the graph cache, eager the first time its plan is seen, then
    one replay of the plan's graph; any other group eagerly.
    ``decode_finish`` finishes either. Never waits on the device."""
    return _decode(headers, payloads, device, True)


def payload_bucket(nbytes: int) -> int:
    """A payload's byte count rounded up to a coarse bucket, the size a
    decode graph uploads (the reference's _bucket_bytes)."""
    n = max(1 << 12, int(nbytes))
    gran = 1 << max(10, n.bit_length() - 3)
    return -(-n // gran) * gran


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


def decompress_tiled_bytes(data: bytes, device="cuda") -> np.ndarray:
    """FLCT container bytes (v0 or v2) -> (H, W[, 3]) uint8/uint16 image."""
    dev = resolve_device(device)
    hd = flct.read_tiled_header(data)
    if hd.height == 0 or hd.width == 0:
        return empty_image(hd)
    (img,), ok = decode_finish(decode_group_dispatch([hd], [payload_of(data, hd)], dev))
    if not ok[0]:
        raise errors.InvalidValue("decoded value does not fit the pixel depth")
    return img
