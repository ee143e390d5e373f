"""Packing FLCS symbols into a big-endian bitstream, on any device.

Counterpart: felics_tpu/ops/bitpack.py (``symbol_offsets``,
``count_big_symbols``, ``pack_bits_scatter``). Words are int64 tensors
holding uint32 values, because PyTorch's uint32 lacks most operators;
contributions to a word are bit-disjoint, so ``index_add_`` equals OR.

* Fast path: a symbol whose whole codeword fits 32 bits is composed into
  one part and added to the two words it can straddle.
* Slow path: the few longer symbols (raw preambles, long unary runs) are
  compacted to an array of the host-known count; their a and b parts are
  added like the fast path, the head and tail words of their runs of ones
  get masks, and the whole words inside a run come from a difference array
  and a prefix sum.
"""

from __future__ import annotations

import torch

from felics_tpu_torch.ops.analysis import Symbols
from felics_tpu_torch.ops.bits import MASK32, shl32, shr32


def symbol_offsets(symbols: Symbols):
    """Exclusive prefix sum of the symbol lengths of a flat stream; returns
    (offsets, total_bits), the total as a 0-d tensor."""
    lens = symbols.total_len
    ends = torch.cumsum(lens, dim=0)
    total = ends[-1] if lens.numel() else lens.new_zeros(())
    return ends - lens, total


def count_big_symbols(symbols: Symbols) -> torch.Tensor:
    """Number of symbols whose codeword exceeds 32 bits (0-d tensor)."""
    return (symbols.total_len > 32).sum()


def _add_part(words, value, length, start, active):
    """Add ``length`` <= 32 bits of ``value`` at bit ``start`` (MSB first)
    where ``active``; the last word of ``words`` is a sink."""
    sink = words.shape[0] - 1
    aligned = torch.where(active & (length > 0), shl32(value, 32 - length), 0)
    w0 = torch.where(active, start >> 5, sink)
    off = start & 31
    c0 = aligned >> off
    c1 = (aligned & ((torch.ones_like(off) << off) - 1)) << (32 - off)
    words.index_add_(0, w0, c0)
    words.index_add_(0, torch.where(active, w0 + 1, sink), c1)


def pack_bits_scatter(
    symbols: Symbols, offsets: torch.Tensor, num_words: int, n_big: int
) -> torch.Tensor:
    """(num_words,) int64 words of a flat symbol stream. ``n_big`` is
    ``count_big_symbols(symbols)`` read on the host; ``num_words`` covers
    the total bit count."""
    dev = offsets.device
    words = torch.zeros(num_words + 2, dtype=torch.int64, device=dev)
    total_len = symbols.total_len
    small = total_len <= 32

    # Fast path: the whole symbol as one part (q < 32 here).
    ones_q = shl32(torch.ones_like(symbols.q), symbols.q) - 1
    merged = shl32(shl32(symbols.a_val, symbols.q) | ones_q, symbols.b_len) | symbols.b_val
    _add_part(words, merged, total_len, offsets, small)

    # Slow path on the compacted long symbols.
    big = ~small
    n = big.shape[0]
    dst = torch.where(big, torch.cumsum(big, 0) - 1, n_big)
    sel = torch.zeros(n_big + 1, dtype=torch.int64, device=dev).scatter_(
        0, dst, torch.arange(n, device=dev)
    )[:n_big]
    a_val, a_len, q = symbols.a_val[sel], symbols.a_len[sel], symbols.q[sel]
    b_val, b_len, off = symbols.b_val[sel], symbols.b_len[sel], offsets[sel]
    on = torch.ones_like(q, dtype=torch.bool)
    _add_part(words, a_val, a_len, off, on)
    _add_part(words, b_val, b_len, off + a_len + q, on)

    sink = num_words + 1
    rs = off + a_len
    re = rs + q
    has = q > 0
    ones = torch.full_like(rs, MASK32)
    head_w = rs >> 5
    head_cap = torch.clamp(re - (head_w << 5), max=32)
    head_mask = shr32(ones, rs & 31) & ~shr32(ones, head_cap) & MASK32
    words.index_add_(0, torch.where(has, head_w, sink), torch.where(has, head_mask, 0))
    tail_w = re >> 5
    tail_end = re & 31
    tail_ok = has & (tail_w > head_w) & (tail_end > 0)
    tail_mask = ~shr32(ones, tail_end) & MASK32
    words.index_add_(0, torch.where(tail_ok, tail_w, sink), torch.where(tail_ok, tail_mask, 0))
    full_lo = (rs + 31) >> 5
    span = has & (tail_w > full_lo)
    diff = torch.zeros(num_words + 2, dtype=torch.int64, device=dev)
    diff.index_add_(0, torch.where(span, full_lo, sink), span.to(torch.int64))
    diff.index_add_(0, torch.where(span, tail_w, sink), -span.to(torch.int64))
    full = torch.cumsum(diff[:num_words], 0) > 0
    return words[:num_words] | torch.where(full, MASK32, 0)

