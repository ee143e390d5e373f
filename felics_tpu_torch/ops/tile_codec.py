"""The FLCT tile codec: CUDA kernels, their plain PyTorch versions and the
stream-width helpers.

Counterpart: felics_tpu/ops/pallas_codec.py. ``encode_tiles`` and
``decode_tiles`` launch the hand-written kernels in ``csrc/`` on CUDA
tensors; on CPU tensors they run ``encode_tiles_ref`` / ``decode_tiles_ref``,
the plain versions, which walk the pixels in a Python loop with every tile
a lane of the tensors. A wrapper never swaps a failed kernel for its plain
version: a CUDA tensor gets the kernel or an exception.

Contract shared by both sides (and by the Pallas kernels):

* tiles: (n, C, t) int32 planes, t = th*tw >= 4, C in {1, 3} (Y/Co/Cg for
  RGB), values within the plane's range for the depth;
* prior: (C, nb, K) int32 k-table seed shared by every tile, or
  (n, C, nb, K) per tile (zeros = v0 streams);
* words: (n, W) int32 holding uint32 bit patterns, MSB-first, zero past the
  last bit; bits: (n,) int64, exact even where it exceeds 32*W (words past
  W are dropped, so the caller relaunches at the exact width).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from felics_tpu_torch.config import QCTX_CAP, CodingConfig
from felics_tpu_torch.core.context import neighbour_indices
from felics_tpu_torch.ops import _build
from felics_tpu_torch.ops.bits import (
    MASK32, bit_length, k_select, shl32, shr32, to_i32_bits, to_u32_value,
)

# Kernel launches made by encode_tiles / decode_tiles and by
# parallel/tiling.py::k0_prior (K5, PRIOR_LAUNCHES: two kernels a call);
# plain-version calls are not counted. DECODE_WIDE_LAUNCHES counts the
# decode launches that took the 64-bit-position instantiation
# (decode_wide_positions). Callers reset them to 0 to see what a run
# launched. A launch made while a CUDA graph is captured is recorded into
# the graph, not run: it goes into CAPTURED instead, and the graph counts it
# at each replay (parallel/graphs.py).
ENCODE_LAUNCHES = 0
DECODE_LAUNCHES = 0
DECODE_WIDE_LAUNCHES = 0
PRIOR_LAUNCHES = 0
CAPTURED = {"encode": 0, "decode": 0, "wide": 0, "prior": 0}

DECODE_MIN_BLOCKS = 384  # flct_decode.cu: blocks to aim for (~3 per SM of an H100)

_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1
_SPILL = 16  # word-count alignment of encode_width_bound (reference format)


def count_launches(encode: int = 0, decode: int = 0, wide: int = 0, prior: int = 0) -> None:
    """Add kernel runs to the launch counts."""
    global ENCODE_LAUNCHES, DECODE_LAUNCHES, DECODE_WIDE_LAUNCHES, PRIOR_LAUNCHES
    ENCODE_LAUNCHES += encode
    DECODE_LAUNCHES += decode
    DECODE_WIDE_LAUNCHES += wide
    PRIOR_LAUNCHES += prior


def launched(**counts: int) -> None:
    """Count kernel launches just made: into CAPTURED under a capture, else
    into the launch counts."""
    if torch.cuda.is_current_stream_capturing():
        for k, v in counts.items():
            CAPTURED[k] += v
    else:
        count_launches(**counts)


def num_buckets(cfg: CodingConfig) -> int:
    """Context buckets of the FLCT k-table: min(bit_length(max_context),
    QCTX_CAP) + 1 = 6 at both depths."""
    return min(int(cfg.max_context).bit_length(), QCTX_CAP) + 1


# ---------------------------------------------------------------------------
# Stream width (words per tile row)
# ---------------------------------------------------------------------------


def bucket_words(w: int) -> int:
    """Round a word count up to a coarse bucket (at least 64 words)."""
    w = max(64, w)
    gran = max(32, 1 << max(0, w.bit_length() - 3))
    return -(-w // gran) * gran


def encode_width_bound(cfg: CodingConfig, t: int, c: int) -> int:
    """Pessimistic words per tile: raw preambles plus a generous per-pixel
    ceiling. A sizing bound, not a correctness one: the kernel counts bits
    exactly, so a longer stream is relaunched at its exact width."""
    per_pixel = cfg.max_phase_in_bits + 2
    per_pixel = max(per_pixel, 2 + 1 + max(cfg.k_values) + 8)
    bits = c * (64 + t * (per_pixel + 8))
    w = -(-bits // 32)
    return -(-w // _SPILL) * _SPILL


_w_hints: dict = {}  # (t, c, depth) -> most words a tile has needed so far


def width_hint(cfg: CodingConfig, t: int, c: int) -> int:
    """First width to launch the encoder at: about 20 bits a pixel until a
    stream of this shape has been seen, then 1.25x the widest one seen."""
    key = (t, c, cfg.pixel_depth)
    cap = encode_width_bound(cfg, t, c)
    hint = _w_hints.get(key)
    if hint is None:
        return bucket_words(min(cap, 64 + (t * c * 20) // 32))
    return min(bucket_words(hint + hint // 4), bucket_words(cap))


def observe_width(cfg: CodingConfig, t: int, c: int, max_bits: int) -> None:
    key = (t, c, cfg.pixel_depth)
    _w_hints[key] = max(_w_hints.get(key, 0), -(-int(max_bits) // 32))


# ---------------------------------------------------------------------------
# Argument checks shared by the kernels and the plain versions
# ---------------------------------------------------------------------------


def _check_geometry(th: int, tw: int, c: int, cfg: CodingConfig):
    if th < 2 or tw < 2:
        raise ValueError(
            "FLCT tile planes need >= 2 pixels (the raw preamble is two "
            f"pixels per plane) and tiles are at least 2x2; got {th}x{tw}"
        )
    if c not in (1, 3):
        raise ValueError(f"tiles must have 1 or 3 channel planes; got {c}")
    nb, K = num_buckets(cfg), cfg.num_k
    if list(cfg.k_values) != list(range(K)) or K > 15 or nb > 6:
        raise ValueError("the FLCT kernels take k values 0..K-1, K <= 15")
    return nb, K


def _check_prior(prior: torch.Tensor, n: int, c: int, nb: int, K: int, device):
    if prior.dtype != torch.int32 or prior.device != device:
        raise ValueError(f"prior must be int32 on {device}")
    if tuple(prior.shape) == (c, nb, K):
        return prior.contiguous(), 0
    if tuple(prior.shape) == (n, c, nb, K):
        return prior.contiguous(), c * nb * K
    raise ValueError(
        f"prior shape {tuple(prior.shape)} is neither {(c, nb, K)} nor "
        f"{(n, c, nb, K)}"
    )


def _per_tile_prior(prior: torch.Tensor, n: int, c: int, nb: int, K: int):
    if prior.dim() == 3:
        prior = prior.unsqueeze(0).expand(n, c, nb, K)
    return prior.to(torch.int64)


def _pow2(e: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(e) << e


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------


class _BitWriter:
    """Lane-parallel MSB-first writer of (n, W) rows. Column W of the
    buffer is a sink for words of lanes that emit nothing or overflow W."""

    def __init__(self, n: int, W: int, device):
        self.W = W
        self.lanes = torch.arange(n, device=device)
        self.words = torch.zeros((n, W + 1), dtype=torch.int64, device=device)
        self.acc = torch.zeros(n, dtype=torch.int64, device=device)
        self.nbits = torch.zeros(n, dtype=torch.int64, device=device)
        self.wi = torch.zeros(n, dtype=torch.int64, device=device)

    def put(self, val, ln) -> None:
        """Append ``ln`` <= 32 bits of ``val`` (val < 2^ln) per lane."""
        ln = torch.as_tensor(ln, dtype=torch.int64, device=self.acc.device)
        self.acc = (self.acc << ln) | val
        nbits = self.nbits + ln
        emit = nbits >= 32
        rest = torch.where(emit, nbits - 32, nbits)
        col = torch.where(emit & (self.wi < self.W), self.wi, self.W)
        self.words[self.lanes, col] = (self.acc >> rest) & MASK32
        self.acc = torch.where(emit, self.acc & (_pow2(rest) - 1), self.acc)
        self.nbits = rest
        self.wi = self.wi + emit.to(torch.int64)

    def finish(self):
        col = torch.where((self.nbits > 0) & (self.wi < self.W), self.wi, self.W)
        self.words[self.lanes, col] = (self.acc << (32 - self.nbits)) & MASK32
        return to_i32_bits(self.words[:, : self.W]), self.wi * 32 + self.nbits


def encode_tiles_ref(
    tiles: torch.Tensor, cfg: CodingConfig, th: int, tw: int, W: int,
    prior: torch.Tensor,
):
    """Plain PyTorch version of the encode kernel (same contract)."""
    n, c, t = tiles.shape
    nb, K = _check_geometry(th, tw, c, cfg)
    dev = tiles.device
    _check_prior(prior, n, c, nb, K, dev)
    pr = _per_tile_prior(prior, n, c, nb, K)
    a_idx, b_idx = neighbour_indices(th, tw)
    ks = torch.arange(K, dtype=torch.int64, device=dev)
    lanes = torch.arange(n, device=dev)
    wr = _BitWriter(n, W, dev)
    x = tiles.to(torch.int64)
    nn_bits = 34  # ctx + 1 <= 2^32 for any int32 planes
    for ci in range(c):
        plane = x[:, ci]
        pw = cfg.depth_bits + (1 if ci > 0 else 0)
        wr.put(plane[:, 0] & ((1 << pw) - 1), pw)
        wr.put(plane[:, 1] & ((1 << pw) - 1), pw)
        table = pr[:, ci].clone()  # (n, nb, K)
        for j in range(2, t):
            p = plane[:, j]
            va, vb = plane[:, int(a_idx[j])], plane[:, int(b_idx[j])]
            h, l = torch.maximum(va, vb), torch.minimum(va, vb)
            ctx = h - l
            qc = bit_length(ctx, nb - 1)  # = min(bit_length(ctx), nb - 1)
            row = table[lanes, qc]
            k = k_select(row, ks)
            in_r = (p >= l) & (p <= h)
            below = p < l
            v = torch.where(below, l - p - 1, p - h - 1)
            upd = (row + (v.unsqueeze(1) >> ks) + 1 + ks) & MASK32
            table[lanes, qc] = torch.where(in_r.unsqueeze(1), row, upd)

            # Marker: '1' in range, '00' below, '01' above.
            wr.put((in_r | ~below).to(torch.int64), torch.where(in_r, 1, 2))
            q = torch.where(in_r, torch.zeros_like(v), v >> k)
            while True:  # the rare Rice symbol longer than a word
                big = q >= 32
                if not bool(big.any()):
                    break
                step = torch.where(big, 32, 0)
                wr.put(torch.where(big, MASK32, 0), step)
                q = q - step
            nn = ctx + 1
            m = bit_length(nn, nn_bits) - 1
            left = nn - _pow2(m)
            right = _pow2(m + 1) - nn
            xx = p - l + nn - left
            r = torch.where(xx >= nn, xx - nn, xx)
            short = r < right
            off2 = r - right
            # Then q ones + '0' and k remainder bits, or the phase-in code
            # (m bits, plus one more bit for the long codes).
            rem = v & (_pow2(k) - 1)
            wr.put(
                torch.where(in_r, torch.where(short, r, (off2 >> 1) + right),
                            (_pow2(q) - 1) << 1),
                torch.where(in_r, m, q + 1),
            )
            wr.put(
                torch.where(in_r, torch.where(short, 0, off2 & 1), rem),
                torch.where(in_r, (~short).to(torch.int64), k),
            )
    return wr.finish()


def tile_k_ref(
    tiles: torch.Tensor, cfg: CodingConfig, th: int, tw: int, prior: torch.Tensor,
) -> torch.Tensor:
    """(n, C, t) k of every pixel, as the encode kernel finds it: the
    k-table just before pixel i is the prior plus the exclusive prefix sum
    (uint32, wrapping) of the Rice-length rows (v >> k) + 1 + k of the
    earlier out-of-range pixels of its bucket; k is the row's last minimum.
    Pixels that are not out of range get the largest k (as
    felics_tpu/ops/kscan_tiled.py::kscan_tiled does)."""
    n, c, t = tiles.shape
    nb, K = _check_geometry(th, tw, c, cfg)
    dev = tiles.device
    _check_prior(prior, n, c, nb, K, dev)
    pr = _per_tile_prior(prior, n, c, nb, K) & MASK32  # (n, C, nb, K)
    a_idx, b_idx = (torch.from_numpy(i.astype(np.int64)).to(dev)
                    for i in neighbour_indices(th, tw))
    x = tiles.to(torch.int64)
    va, vb = x[..., a_idx], x[..., b_idx]
    h, l = torch.maximum(va, vb), torch.minimum(va, vb)
    coded = torch.arange(t, device=dev) >= 2
    below = (x < l) & coded
    oor = below | ((x > h) & coded)
    v = torch.where(below, l - x - 1, x - h - 1)
    qc = bit_length(h - l, nb - 1)  # min(bit_length(ctx), nb - 1)
    ks = torch.arange(K, dtype=torch.int64, device=dev)
    rows = (v.unsqueeze(-1) >> ks) + 1 + ks  # (n, C, t, K)
    k = torch.full((n, c, t), K - 1, dtype=torch.int64, device=dev)
    for b in range(nb):
        mask = (qc == b) & oor
        contrib = torch.where(mask.unsqueeze(-1), rows, 0)
        table = (torch.cumsum(contrib, dim=2) - contrib + pr[:, :, b, None, :]) & MASK32
        k = torch.where(mask, k_select(table, ks), k)
    return k


def encode_tiles(
    tiles: torch.Tensor, cfg: CodingConfig, th: int, tw: int, W: int,
    prior: torch.Tensor,
):
    """Encode (n, C, t) int32 tiles into (words (n, W) int32, bits (n,)
    int64). CUDA tensors launch flct_encode.cu; CPU tensors run
    ``encode_tiles_ref``."""
    if tiles.dim() != 3 or tiles.dtype != torch.int32:
        raise ValueError("tiles must be an (n, C, t) int32 tensor")
    n, c, t = tiles.shape
    nb, K = _check_geometry(th, tw, c, cfg)
    if t != th * tw:
        raise ValueError(f"tile planes hold {t} pixels, not {th}x{tw}")
    if W < 1:
        raise ValueError("W must be >= 1")
    if tiles.device.type == "cpu":
        return encode_tiles_ref(tiles, cfg, th, tw, W, prior)
    if tiles.device.type != "cuda":
        raise ValueError(f"unsupported device {tiles.device}")
    _build.check_kernel_k(K)
    prior, stride = _check_prior(prior, n, c, nb, K, tiles.device)
    tiles = tiles.contiguous()
    words = torch.zeros((n, W), dtype=torch.int32, device=tiles.device)
    bits = torch.empty((n,), dtype=torch.int64, device=tiles.device)
    if n == 0:
        return words, bits
    lib = _build.library()
    with torch.cuda.device(tiles.device):
        code = lib.flct_encode(
            tiles.data_ptr(), prior.data_ptr(), stride, words.data_ptr(),
            bits.data_ptr(), n, c, th, tw, cfg.depth_bits, nb, K, W,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "flct_encode")
    launched(encode=1)
    return words, bits


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def decode_tiles_ref(
    words: torch.Tensor, cfg: CodingConfig, th: int, tw: int, c: int,
    prior: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version of the decode kernel (same contract)."""
    n, W = words.shape
    nb, K = _check_geometry(th, tw, c, cfg)
    dev = words.device
    _check_prior(prior, n, c, nb, K, dev)
    pr = _per_tile_prior(prior, n, c, nb, K)
    t = th * tw
    a_idx, b_idx = neighbour_indices(th, tw)
    ks = torch.arange(K, dtype=torch.int64, device=dev)
    lanes = torch.arange(n, device=dev)
    zero2 = torch.zeros((n, 2), dtype=torch.int64, device=dev)
    wpad = torch.cat([to_u32_value(words), zero2], dim=1)  # reads past W: 0
    limit = 32 * W
    max_ctx = int(cfg.max_context)
    nn_bits = (max_ctx + 1).bit_length()

    def peek32(pos):
        wi = (pos >> 5).clamp(max=W)
        off = pos & 31
        return shl32(wpad[lanes, wi], off) | shr32(wpad[lanes, wi + 1], 32 - off)

    def get(pos, nbits):
        return shr32(peek32(pos), 32 - torch.as_tensor(nbits, device=dev))

    out = torch.zeros((n, c, t), dtype=torch.int64, device=dev)
    pos = torch.zeros(n, dtype=torch.int64, device=dev)
    for ci in range(c):
        pw = cfg.depth_bits + (1 if ci > 0 else 0)
        for j in range(2):
            raw = get(pos, pw)
            pos = pos + pw
            if ci > 0:  # Co/Cg: pw-bit two's complement
                raw = torch.where(raw >= (1 << (pw - 1)), raw - (1 << pw), raw)
            out[:, ci, j] = raw
        table = pr[:, ci].clone()
        for j in range(2, t):
            va, vb = out[:, ci, int(a_idx[j])], out[:, ci, int(b_idx[j])]
            h, l = torch.maximum(va, vb), torch.minimum(va, vb)
            ctx = (h - l).clamp(max=max_ctx)
            qc = bit_length(ctx, nb - 1)
            first = get(pos, 1) == 1

            # In range: phase-in over nn = ctx + 1.
            nn = ctx + 1
            m = bit_length(nn, nn_bits) - 1
            left = nn - _pow2(m)
            right = _pow2(m + 1) - nn
            fm = get(pos + 1, m)
            short = fm < right
            extra = get(pos + 1 + m, 1)
            number = torch.where(short, fm, (fm - right) * 2 + right + extra)
            xs = number + left
            xs = torch.where(xs >= nn, xs - nn, xs)
            in_value = l + xs
            in_pos = pos + 1 + m + (~short).to(torch.int64)

            # Out of range: sign bit, unary run (stops at 32*W), k bits.
            above = get(pos + 1, 1) == 1
            row = table[lanes, qc]
            k = k_select(row, ks)
            q = torch.zeros_like(pos)
            p = pos + 2
            active = ~first
            while True:
                live = active & (p < limit)
                if not bool(live.any()):
                    break
                inv = (~peek32(p)) & MASK32
                ones = 32 - bit_length(inv, 32)
                fin = ones < 32
                q = torch.where(live, q + ones, q)
                p = torch.where(live, p + ones + fin.to(torch.int64), p)
                active = active & ~(live & fin)
            encoded = (q << k) + get(p, k)
            upd = (row + (encoded.unsqueeze(1) >> ks) + 1 + ks) & MASK32
            table[lanes, qc] = torch.where(first.unsqueeze(1), row, upd)
            oor_value = torch.where(above, encoded + h + 1, l - encoded - 1)

            value = torch.where(first, in_value, oor_value)
            out[:, ci, j] = value.clamp(_I32_MIN, _I32_MAX)
            pos = torch.where(first, in_pos, p + k)
    return out.to(torch.int32)


def decode_tiles_per_block(n: int) -> int:
    """Tiles (threads) of one flct_decode.cu block: 32 (a full warp) while
    that still gives DECODE_MIN_BLOCKS blocks, else halved until it does.
    A tile is one serial chain, and a warp issues its step's instructions
    once for all its tiles: more tiles a warp cost fewer instructions in
    all, more warps an SM hide more latency. On an H100 the best of 1-32
    tiles a block was 8 for gray8 (3072 tiles at tile 32), 4 for rgb8
    (2048), 2 for gray16 (1024) and for gray8 at tile 64 (768): ~384
    blocks each time."""
    tpb = 32
    while tpb > 1 and -(-n // tpb) < DECODE_MIN_BLOCKS:
        tpb //= 2
    return tpb


def decode_smem_bytes(K: int, tw: int, tpb: int) -> int:
    """Shared memory of one flct_decode.cu block of ``tpb`` tiles with its
    rings shared: the k-table (6 x K entries a tile) and the rings of the
    row above (tw + 1 entries a tile, at a stride of tpb + 1). Rings that
    do not fit go to global scratch."""
    return 4 * (6 * K * tpb + (tw + 1) * (tpb + 1))


def decode_wide_positions(W: int, c: int, th: int, tw: int) -> bool:
    """Whether flct_decode.cu needs its 64-bit-position instantiation for
    rows of W words: a step reads at most 20 bits past the last word
    (c * th * tw steps, plus slack), and the 32-bit one keeps every position
    below 2^31."""
    return 32 * W + 20 * c * th * tw + 64 > _I32_MAX


def decode_tiles(
    words: torch.Tensor, cfg: CodingConfig, th: int, tw: int, c: int,
    prior: torch.Tensor, *, slow_steps: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode (n, W) int32 word rows into (n, C, t) int32 planes. CUDA
    tensors launch flct_decode.cu (its 64-bit-position instantiation for
    rows that ``decode_wide_positions`` calls long); CPU tensors run
    ``decode_tiles_ref``.

    ``slow_steps``, a (1,) int64 tensor on the words' CUDA device, gets the
    kernel's slow-path steps added to it (codes that do not fit its 32-bit
    window); the main path passes none."""
    if words.dim() != 2 or words.dtype != torch.int32:
        raise ValueError("words must be an (n, W) int32 tensor")
    n, W = words.shape
    nb, K = _check_geometry(th, tw, c, cfg)
    if words.device.type == "cpu":
        if slow_steps is not None:
            raise ValueError("slow_steps counts the CUDA kernel's steps")
        return decode_tiles_ref(words, cfg, th, tw, c, prior)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    if slow_steps is not None and (
            slow_steps.dtype != torch.int64 or slow_steps.numel() != 1
            or slow_steps.device != words.device or not slow_steps.is_contiguous()):
        raise ValueError(f"slow_steps must be one int64 on {words.device}")
    _build.check_kernel_k(K)
    wide = decode_wide_positions(W, c, th, tw)
    prior, stride = _check_prior(prior, n, c, nb, K, words.device)
    words = words.contiguous()
    out = torch.empty((n, c, th * tw), dtype=torch.int32, device=words.device)
    if n == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(words.device):
        tpb = decode_tiles_per_block(n)
        ring_shared = decode_smem_bytes(K, tw, tpb) <= lib.flcs_decode_smem_limit()
        rings = None if ring_shared else torch.empty(
            (-(-n // tpb), (tw + 1) * (tpb + 1)), dtype=torch.int32, device=words.device)
        code = lib.flct_decode(
            words.data_ptr(), prior.data_ptr(), stride, out.data_ptr(), n, c,
            th, tw, cfg.depth_bits, nb, K, int(cfg.max_context), W,
            tpb, int(ring_shared), int(wide),
            None if rings is None else rings.data_ptr(),
            None if slow_steps is None else slow_steps.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "flct_decode")
    launched(decode=1, wide=int(wide))
    return out
