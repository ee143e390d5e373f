"""Bit helpers for the plain PyTorch versions of the kernels.

Torch's uint32 lacks most operators on the CPU (no ``>>``, ``<<``, ``+``,
``>`` or ``min``) and its int32 ``>>`` is arithmetic, so the plain versions
hold 32-bit words as int64 values in [0, 2^32) and mask with ``MASK32``.
Counterparts: ``_shl``/``_shr``/``_bitlen`` in felics_tpu/ops/pallas_codec.py
and ``_shl``/``_shr`` in felics_tpu/ops/bitpack.py.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def shl32(v: torch.Tensor, s) -> torch.Tensor:
    """(v << s) & MASK32 for int64 v in [0, 2^32); 0 where s >= 32."""
    s = torch.as_tensor(s, dtype=torch.int64, device=v.device)
    out = (v << s.clamp(0, 31)) & MASK32
    return torch.where(s < 32, out, torch.zeros_like(out))


def shr32(v: torch.Tensor, s) -> torch.Tensor:
    """v >> s for int64 v in [0, 2^32); 0 where s >= 32."""
    s = torch.as_tensor(s, dtype=torch.int64, device=v.device)
    out = v >> s.clamp(0, 31)
    return torch.where(s < 32, out, torch.zeros_like(out))


def bit_length(x: torch.Tensor, max_bits: int) -> torch.Tensor:
    """Exact bit_length of int64 x in [0, 2^max_bits), as int64. The shifts
    are made on x's device: no host copy, so no wait on the device."""
    shifts = torch.arange(max_bits, dtype=torch.int64, device=x.device)
    return ((x.unsqueeze(-1) >> shifts) > 0).sum(-1)


def to_i32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same 32 bits."""
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def to_u32_value(v: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their unsigned values as int64."""
    return v.to(torch.int64) & MASK32


def words_to_bytes(words: torch.Tensor) -> torch.Tensor:
    """Integer words holding 32-bit patterns -> their big-endian uint8
    bytes, word after word."""
    be = torch.stack([(words >> s) & 255 for s in (24, 16, 8, 0)], dim=-1)
    return be.to(torch.uint8).reshape(-1)


def wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 v reduced to int32 two's-complement range (still int64): the
    wrap-around of the reference's int32 arithmetic."""
    return ((v + (1 << 31)) & MASK32) - (1 << 31)


def k_select(row: torch.Tensor, ks: torch.Tensor) -> torch.Tensor:
    """Per-lane column of the smallest cost; ties go to the LARGEST k (the
    reference's ``(K-1) - argmin(row[::-1])``, which torch.argmin does not
    promise)."""
    minv = row.min(dim=-1, keepdim=True).values
    return torch.where(row == minv, ks, torch.full_like(row, -1)).max(-1).values
