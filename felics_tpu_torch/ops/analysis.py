"""Per-pixel analysis and codeword symbols of the FLCS encoder.

Counterpart: felics_tpu/ops/analysis.py. The reference writes each function
for one channel and vmaps it; here every function takes a (G, n) stack of
lanes (G = every channel of every image of one shape group, n = H*W) and
works on all of them at once. Values are int64; ``a_val``/``b_val`` hold
uint32 bit patterns in [0, 2^32).

    symbol = (a_val, a_len) ++ (q ones) ++ (b_val, b_len)

* in range: a = '1', q = 0, b = phase-in code of p - L over n = ctx + 1;
* below / above: a = '00' / '01', v = L-p-1 / p-H-1, q = v >> k,
  b = '0' + the k low bits of v (k + 1 bits);
* raw preamble: symbol 0 carries both first pixels as 32-bit two's
  complement (a = p0, b = p1); symbol 1 is empty.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from felics_tpu_torch.device import neighbours
from felics_tpu_torch.ops.bits import MASK32, bit_length

# n = ctx + 1 <= 2^17 for every FLCS plane (16-bit Co/Cg contexts reach
# 131070), so 18 bits hold its bit length.
PHASE_IN_BITS = 18


class Analysis(NamedTuple):
    context: torch.Tensor  # (G, n) H - L (0 for the first two pixels)
    low: torch.Tensor
    high: torch.Tensor
    oor: torch.Tensor  # bool: out of range (Rice coded)
    residual: torch.Tensor  # L-p-1 or p-H-1 (0 in range)
    in_range: torch.Tensor  # bool
    above: torch.Tensor  # bool


class Symbols(NamedTuple):
    a_val: torch.Tensor  # (G, n) uint32 values
    a_len: torch.Tensor
    q: torch.Tensor  # length of the implicit run of one-bits
    b_val: torch.Tensor  # uint32 values
    b_len: torch.Tensor

    @property
    def total_len(self) -> torch.Tensor:
        return self.a_len + self.q + self.b_len


def analyze_channel(chans: torch.Tensor, height: int, width: int) -> Analysis:
    """Context and classification of every pixel of (G, H*W) planes."""
    x = chans.to(torch.int64)
    n = height * width
    a_idx, b_idx = neighbours(height, width, x.device)
    v1, v2 = x[:, a_idx], x[:, b_idx]
    high = torch.maximum(v1, v2)
    low = torch.minimum(v1, v2)
    coded = torch.arange(n, device=x.device) >= 2
    in_range = (x >= low) & (x <= high) & coded
    below = (x < low) & coded
    above = (x > high) & coded
    residual = torch.where(
        below, low - x - 1, torch.where(above, x - high - 1, torch.zeros_like(x))
    )
    return Analysis(high - low, low, high, below | above, residual, in_range, above)


def phase_in_code(n: torch.Tensor, value: torch.Tensor):
    """Phase-in codeword (val, len) of ``value`` over [0, n-1], elementwise
    (felics_tpu.coding.phase_in.PhaseInCoder.encode)."""
    m = bit_length(n, PHASE_IN_BITS) - 1
    one = torch.ones_like(n)
    left_p = n - (one << m)
    right_p = (one << (m + 1)) - n
    r = (value + n - left_p) % n
    short = r < right_p
    off = r - right_p
    long_val = (((off >> 1) + right_p) << 1) | (off & 1)
    return torch.where(short, r, long_val), torch.where(short, m, m + 1)


def symbolize(
    analysis: Analysis, chans: torch.Tensor, k: torch.Tensor, height: int,
    width: int,
) -> Symbols:
    """Codeword symbols of every pixel given the adaptive k per pixel.
    Assumes H*W >= 2 (the caller takes degenerate dims elsewhere)."""
    x = chans.to(torch.int64)
    k = k.to(torch.int64)
    ir, oor = analysis.in_range, analysis.oor
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    a_val = torch.where(ir | analysis.above, one, zero)
    a_len = torch.where(ir, one, 2 * one)
    phase_val, phase_len = phase_in_code(analysis.context + 1, x - analysis.low)
    v = analysis.residual
    q = torch.where(oor, v >> k, zero)
    b_val = torch.where(ir, phase_val, v & ((one << k) - 1))
    b_len = torch.where(ir, phase_len, k + 1)

    # Symbol 0 carries both raw 32-bit first pixels; symbol 1 is empty.
    a_val[:, 0], a_len[:, 0] = x[:, 0] & MASK32, 32
    b_val[:, 0], b_len[:, 0] = x[:, 1] & MASK32, 32
    q[:, :2] = 0
    a_val[:, 1] = a_len[:, 1] = b_val[:, 1] = b_len[:, 1] = 0
    return Symbols(a_val, a_len, q, b_val, b_len)
