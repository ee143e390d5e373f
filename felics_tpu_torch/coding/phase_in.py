"""Phased-in (truncated binary) codes over the domain ``[0, n-1]``.

Counterpart: felics_tpu/coding/phase_in.py (reference:
src/coding/phase_in_coding.rs:23-112). With ``m = floor(log2 n)`` there
are ``right_p = 2^(m+1) - n`` short (m-bit) codewords and ``2*left_p``
long (m+1-bit) ones, ``left_p = n - 2^m``. Values are rotated right by
``left_p`` before coding, so the short codewords fall mid-range, where the
in-range residuals are most likely.

A rotated value ``r`` codes as:
  * ``r <  right_p``: the m-bit value ``r``;
  * ``r >= right_p``: the m-bit value ``right_p + (r - right_p)//2``, then
    one bit ``(r - right_p) % 2``.
"""

from __future__ import annotations

from felics_tpu_torch import errors


class PhaseInCoder:
    __slots__ = ("n", "m", "left_p", "right_p")

    def __init__(self, n: int) -> None:
        if n <= 0:
            raise ValueError("n must be positive")
        if n >= 1 << 31:
            raise ValueError("n is too big")
        m = n.bit_length() - 1  # floor(log2 n)
        self.n = n
        self.m = m
        self.left_p = n - (1 << m)
        self.right_p = (1 << (m + 1)) - n

    def _rotate_right(self, value: int) -> int:
        return (value + self.n - self.left_p) % self.n

    def _rotate_left(self, value: int) -> int:
        return (value + self.left_p) % self.n

    def encode(self, bitwrite, value: int) -> None:
        if not 0 <= value < self.n:
            raise ValueError("value out of range")
        r = self._rotate_right(value)
        if r < self.right_p:
            bitwrite.write(self.m, r)
        else:
            pair, last = divmod(r - self.right_p, 2)
            bitwrite.write(self.m, pair + self.right_p)
            bitwrite.write_bit(last)

    def decode(self, bitread) -> int:
        first_m = bitread.read(self.m)
        if first_m < self.right_p:
            return self._rotate_left(first_m)
        number = (first_m - self.right_p) * 2 + self.right_p
        if bitread.read_bit():
            number += 1
        if number >= self.n:
            raise errors.InvalidValue("phase-in codeword out of domain")
        return self._rotate_left(number)

    def code_length(self, value: int) -> int:
        r = self._rotate_right(value)
        return self.m if r < self.right_p else self.m + 1
