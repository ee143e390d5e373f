"""Bit helpers for the plain PyTorch versions of the tile codec.

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
    """Exact bit_length of int64 x in [0, 2^max_bits), as int64."""
    powers = torch.tensor(
        [1 << b for b in range(max_bits)], dtype=torch.int64, device=x.device
    )
    return (x.unsqueeze(-1) >= powers).sum(-1)


def to_i32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same 32 bits."""
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def to_u32_value(v: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their unsigned values as int64."""
    return v.to(torch.int64) & MASK32
