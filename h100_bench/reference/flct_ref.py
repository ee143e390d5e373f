"""Plain FLCT v2 encoder and container reader: the reference that the
benchmark holds the port's containers to.

Written from the FLCT layout (magic, header, k-prior block, tile-length
table, byte-aligned tile streams) and FELICS coding with a per-tile
adaptive Rice k, in plain PyTorch. It imports nothing of the code under
test and nothing of JAX. Every sample of an image is coded at once: no
loop over pixels, so it runs at full size on the card within a second a
batch. Works on CPU and CUDA tensors alike.

Coding of one tile, plane after plane (gray; or Y, Co, Cg of YCoCg-R):

* the first two raster pixels raw, ``depth`` bits (Co/Cg: ``depth + 1``
  bits, two's complement);
* each later pixel ``p`` with neighbours giving ``L <= H`` and the context
  ``d = H - L``: ``1`` + phase-in of ``p - L`` over ``d + 1`` values when
  ``L <= p <= H``; else ``00`` (below) or ``01`` (above), then the Rice
  code with parameter ``k`` of ``L - p - 1`` or ``p - H - 1``: ``q`` ones,
  a zero and the ``k`` low bits;
* ``k`` is the last minimum of the tile's k-table row of the pixel's bucket
  ``min(bit_length(d), 5)``; the row starts at ``4 * |k - k0|`` and gains
  ``(v >> k) + 1 + k`` for every earlier out-of-range pixel ``v`` of that
  bucket (uint32 sums, never halved); ``k0`` per image, channel and bucket
  is the last minimum of the image's total Rice length.
"""

from __future__ import annotations

import struct
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

MAGIC = b"FLCT"
FIXED = struct.Struct(">4sBBIIHHHI")  # magic, color, depth, W, H, tile_w, tile_h, flags, n_tiles
FLAG_TABLE_U16 = 0x0001
FLAG_K_PRIOR = 0x0002
PRIOR_WEIGHT = 4
BUCKETS = 6  # min(bit_length(max context), 5) + 1, at both depths
NUM_K = {8: 6, 16: 15}  # k = 0 .. NUM_K - 1
MASK32 = 0xFFFFFFFF
_POW2 = [1 << i for i in range(63)]


def bit_length(x: torch.Tensor) -> torch.Tensor:
    """Exact bit length of int64 ``x >= 0``."""
    pow2 = torch.tensor(_POW2, dtype=torch.int64, device=x.device)
    return torch.searchsorted(pow2, x.contiguous(), right=True)


def last_argmin(rows: torch.Tensor) -> torch.Tensor:
    """Index of the last minimum along the last axis."""
    ks = torch.arange(rows.shape[-1], device=rows.device)
    low = rows.min(dim=-1, keepdim=True).values
    return torch.where(rows == low, ks, -1).max(dim=-1).values


def tile_dims(h: int, w: int, tile: Tuple[int, int]) -> Tuple[int, int]:
    """(th, tw): the tile clamped to the image, never below 2 x 2."""
    return max(2, min(tile[0], h)), max(2, min(tile[1], w))


def neighbours(th: int, tw: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two causal neighbours of each raster pixel of a th x tw tile:
    (left, above) inside; (left, left-left) on the top row; (above,
    above-above) down the left column, (above, above-right) on its second
    row. The first two pixels have none (they point at themselves)."""
    i = torch.arange(th * tw, device=device)
    x, y = i % tw, i // tw
    inner, top = (x > 0) & (y > 0), (y == 0) & (x >= 2)
    deep, second = (x == 0) & (y >= 2), (x == 0) & (y == 1) & (tw > 1)
    a = torch.where(inner | top, i - 1, torch.where(deep | second, i - tw, i))
    b = torch.where(inner, i - tw, torch.where(top, i - 2, torch.where(
        deep, i - 2 * tw, torch.where(second, i - tw + 1, i))))
    return a, b


def _half(x: torch.Tensor) -> torch.Tensor:
    """x / 2 truncated toward zero."""
    return torch.where(x < 0, -((-x) >> 1), x >> 1)


def planes(image: np.ndarray, th: int, tw: int, device) -> torch.Tensor:
    """(H, W[, 3]) image -> (tiles, C, th*tw) int64 planes: edge-padded to
    whole tiles, YCoCg-R for RGB, tiles row-major."""
    h, w = image.shape[:2]
    ty, tx = -(-h // th), -(-w // tw)
    x = torch.from_numpy(image.astype(np.int64)).to(device)
    x = x[torch.arange(ty * th, device=device).clamp(max=h - 1)]
    x = x[:, torch.arange(tx * tw, device=device).clamp(max=w - 1)]
    if x.dim() == 3:
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        co = r - b
        t = b + _half(co)
        cg = g - t
        x = torch.stack([t + _half(cg), co, cg])
    else:
        x = x[None]
    c = x.shape[0]
    return x.reshape(c, ty, th, tx, tw).permute(1, 3, 0, 2, 4).reshape(ty * tx, c, th * tw)


class Symbols(NamedTuple):
    """Each sample's code: a field, a run of ones, a second field (values
    and bit lengths), flattened tile-major, plane after plane."""

    f1: torch.Tensor
    n1: torch.Tensor
    run: torch.Tensor
    f2: torch.Tensor
    n2: torch.Tensor


def k_of_image(x: torch.Tensor, a, b, depth: int, v0: bool = False):
    """(k0 (C, BUCKETS), per-sample facts): the image's k0 and every
    sample's k, context, bucket and range flags. ``v0``: every k-table
    starts at zero (no prior)."""
    nt, c, t = x.shape
    K = NUM_K[depth]
    dev = x.device
    va, vb = x[..., a], x[..., b]
    hi, lo = torch.maximum(va, vb), torch.minimum(va, vb)
    ctx = hi - lo
    coded = torch.arange(t, device=dev) >= 2
    below = (x < lo) & coded
    oor = below | ((x > hi) & coded)
    v = torch.where(below, lo - x - 1, x - hi - 1)
    qc = bit_length(ctx).clamp(max=BUCKETS - 1)
    ks = torch.arange(K, dtype=torch.int64, device=dev)
    rows = torch.where(oor.unsqueeze(-1), (v.unsqueeze(-1) >> ks) + 1 + ks, 0)
    totals = rice_totals(rows, qc)
    k0 = last_argmin(totals)  # ties to the largest k
    prior = PRIOR_WEIGHT * (ks - k0.unsqueeze(-1)).abs() * (not v0)  # (C, BUCKETS, K)
    k = torch.full((nt, c, t), K - 1, dtype=torch.int64, device=dev)
    for q in range(BUCKETS):
        mine = (qc == q) & oor
        part = torch.where(mine.unsqueeze(-1), rows, 0)
        table = (torch.cumsum(part, dim=2) - part + prior[None, :, q, None, :]) & MASK32
        k = torch.where(mine, last_argmin(table), k)
    return k0, dict(lo=lo, ctx=ctx, below=below, oor=oor, v=v, k=k, coded=coded)


def rice_totals(rows: torch.Tensor, qc: torch.Tensor) -> torch.Tensor:
    """(C, BUCKETS, K) total Rice lengths of out-of-range samples (rows are
    zero elsewhere) by channel and bucket."""
    nt, c, t, K = rows.shape
    idx = torch.arange(c, device=rows.device).reshape(1, c, 1) * BUCKETS + qc
    tot = torch.zeros((c * BUCKETS, K), dtype=torch.int64, device=rows.device)
    tot.index_add_(0, idx.reshape(-1), rows.reshape(-1, K))
    return tot.reshape(c, BUCKETS, K)


def symbols(x: torch.Tensor, f: dict, depth: int) -> Symbols:
    """Each sample's code from its facts (``k_of_image``)."""
    nt, c, t = x.shape
    dev = x.device
    lo, ctx, below, oor, v, k, coded = (
        f["lo"], f["ctx"], f["below"], f["oor"], f["v"], f["k"], f["coded"])
    one = torch.ones((), dtype=torch.int64, device=dev)
    # in range: '1' then phase-in of p - L over nn = d + 1 values
    nn = ctx + 1
    m = bit_length(nn) - 1
    left = nn - (one << m)
    right = (one << (m + 1)) - nn
    r = x - lo + nn - left
    r = torch.where(r >= nn, r - nn, r)
    short = r < right
    off = r - right
    in_val = torch.where(short, (one << m) | r,
                         (((one << m) | ((off >> 1) + right)) << 1) | (off & 1))
    in_len = 1 + m + (~short).to(torch.int64)
    # out of range: '0', the above bit; q ones; '0' and k low bits
    chroma = (torch.arange(c, device=dev) > 0).reshape(1, c, 1)
    pw = depth + chroma.to(torch.int64)
    raw_val = x & ((one << pw) - 1)
    f1 = torch.where(~coded, raw_val, torch.where(oor, (~below).to(torch.int64), in_val))
    n1 = torch.where(~coded, pw.expand_as(x), torch.where(oor, 2, in_len))
    run = torch.where(oor, v >> k, 0)
    f2 = torch.where(oor, v & ((one << k) - 1), 0)
    n2 = torch.where(oor, 1 + k, 0)
    flat = lambda z: z.reshape(nt, c * t)
    return Symbols(flat(f1), flat(n1), flat(run), flat(f2), flat(n2))


def _put(words: torch.Tensor, pos, val, n) -> None:
    """OR fields of n <= 32 bits into 32-bit big-endian words (held as
    int64); fields never overlap, so adding is OR."""
    keep = n > 0
    pos, val, n = pos[keep], val[keep], n[keep]
    w, end = pos >> 5, (pos & 31) + n
    spill = (end - 32).clamp(min=0)
    words.index_add_(0, w, torch.where(end <= 32, val << (32 - end).clamp(min=0), val >> spill))
    s = end > 32
    words.index_add_(0, w[s] + 1, (val[s] & ((1 << spill[s]) - 1)) << (64 - end[s]))


def pack_streams(sym: Symbols) -> Tuple[np.ndarray, bytes]:
    """(each tile's byte length, the tiles' byte-aligned streams back to
    back)."""
    lens = sym.n1 + sym.run + sym.n2
    tile_bits = lens.sum(dim=1)
    tile_bytes = (tile_bits + 7) // 8
    start = (torch.cumsum(tile_bytes, 0) - tile_bytes) * 8
    pos = start.unsqueeze(1) + torch.cumsum(lens, 1) - lens
    total = int(tile_bytes.sum())
    nwords = -(-total // 4) + 1
    dev = lens.device
    words = torch.zeros(nwords + 1, dtype=torch.int64, device=dev)
    p1 = pos.reshape(-1)
    n1, run = sym.n1.reshape(-1), sym.run.reshape(-1)
    _put(words, p1, sym.f1.reshape(-1), n1)
    _put(words, p1 + n1 + run, sym.f2.reshape(-1), sym.n2.reshape(-1))
    # runs of ones: +1 at each start, -1 past each end, summed up
    has = run > 0
    edge = torch.zeros(32 * (nwords + 1) + 1, dtype=torch.int32, device=dev)
    starts = (p1 + n1)[has]
    edge.index_add_(0, starts, torch.ones_like(starts, dtype=torch.int32))
    edge.index_add_(0, starts + run[has], torch.full_like(starts, -1, dtype=torch.int32))
    ones = (torch.cumsum(edge[:-1], 0) > 0).reshape(nwords + 1, 32).to(torch.int64)
    words += (ones << torch.arange(31, -1, -1, device=dev)).sum(dim=1)
    words &= MASK32
    be = torch.stack([(words >> s) & 255 for s in (24, 16, 8, 0)], dim=1)
    payload = be.to(torch.uint8).reshape(-1)[:total].cpu().numpy().tobytes()
    return tile_bytes.cpu().numpy(), payload


def container(image: np.ndarray, tile_bytes: np.ndarray, payload: bytes,
              k0: Optional[np.ndarray], th: int, tw: int) -> bytes:
    """Header, k-prior block, tile-length table and payload; ``k0`` None
    writes the v0 layout (flags 0, no k-prior block, u32 table)."""
    h, w = image.shape[:2]
    rgb = image.ndim == 3
    depth = 16 if image.dtype == np.uint16 else 8
    flags, table, block = 0, ">u4", b""
    if k0 is not None:
        nib = np.asarray(k0, np.uint8).reshape(-1)
        if nib.size % 2:
            nib = np.append(nib, np.uint8(0))
        block = ((nib[0::2] << 4) | nib[1::2]).astype(np.uint8).tobytes()
        flags = FLAG_K_PRIOR
        if int(tile_bytes.max(initial=0)) < (1 << 16):
            flags |= FLAG_TABLE_U16
            table = ">u2"
    head = FIXED.pack(MAGIC, int(rgb), int(depth == 16), w, h, tw, th, flags, len(tile_bytes))
    return head + block + np.asarray(tile_bytes).astype(table).tobytes() + payload


def depth_of(image: np.ndarray) -> int:
    if image.dtype == np.uint8:
        return 8
    if image.dtype == np.uint16:
        return 16
    raise ValueError(f"unsupported dtype {image.dtype}")


def encode_image(image: np.ndarray, tile: Tuple[int, int], device,
                 v0: bool = False) -> bytes:
    """The FLCT v2 container of one (H, W[, 3]) uint8/uint16 image with at
    least 2 x 2 pixels; ``v0``: the v0 container (no k-prior)."""
    h, w = image.shape[:2]
    if h < 2 or w < 2:
        raise ValueError("the reference codes images of at least 2 x 2 pixels")
    depth = depth_of(image)
    th, tw = tile_dims(h, w, tile)
    x = planes(image, th, tw, device)
    a, b = neighbours(th, tw, device)
    k0, facts = k_of_image(x, a, b, depth, v0=v0)
    tile_bytes, payload = pack_streams(symbols(x, facts, depth))
    return container(image, tile_bytes, payload, None if v0 else k0.cpu().numpy(), th, tw)


class Tiled(NamedTuple):
    width: int
    height: int
    channels: int
    depth: int
    tile_w: int
    tile_h: int
    tile_lengths: np.ndarray
    payload_bytes: int


def read_container(data: bytes) -> Tiled:
    """The header facts of an FLCT container (the check of its bytes is
    the comparison with ``encode_image``)."""
    magic, color, depth, w, h, tw, th, flags, n = FIXED.unpack(data[: FIXED.size])
    if magic != MAGIC:
        raise ValueError(f"not an FLCT container: {magic!r}")
    c = 3 if color == 1 else 1
    pos = FIXED.size + ((c * BUCKETS + 1) // 2 if flags & FLAG_K_PRIOR else 0)
    dt = ">u2" if flags & FLAG_TABLE_U16 else ">u4"
    lens = np.frombuffer(data[pos: pos + n * np.dtype(dt).itemsize], dt).astype(np.int64)
    return Tiled(w, h, c, 16 if depth == 1 else 8, tw, th, lens, int(lens.sum()))
