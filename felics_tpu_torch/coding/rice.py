"""Golomb-Rice coding with a power-of-two divisor M = 2^k.

Counterpart: felics_tpu/coding/rice.py (reference:
src/coding/rice_coding.rs:19-58). The code of ``n`` at parameter ``k`` is
the quotient ``n >> k`` in unary (that many one-bits, then a zero bit),
then the low ``k`` bits of ``n`` MSB-first: ``(n >> k) + 1 + k`` bits.
"""

from __future__ import annotations

from felics_tpu_torch import errors


def rice_code_length(value: int, k: int) -> int:
    return (value >> k) + 1 + k


class RiceCoder:
    __slots__ = ("k", "m", "mask")

    def __init__(self, k: int) -> None:
        if not 0 <= k <= 31:
            raise ValueError("k must be in [0, 31]")
        self.k = k
        self.m = 1 << k
        self.mask = self.m - 1

    def encode(self, bitwrite, value: int) -> None:
        bitwrite.write_unary0(value >> self.k)
        bitwrite.write(self.k, value & self.mask)

    def decode(self, bitread) -> int:
        quotient = bitread.read_unary0()
        remainder = bitread.read(self.k)
        result = quotient * self.m + remainder
        if result > 0xFFFFFFFF:
            # The reference panics here (rice_coding.rs:49, checked_mul);
            # a corrupt stream is a decode error instead.
            raise errors.ValueOverflow("rice quotient overflows u32")
        return result

    def code_length(self, value: int) -> int:
        return rice_code_length(value, self.k)
