"""Reversible YCoCg-R color transform (lifting form).

Counterpart: felics_tpu/core/color.py (reference:
src/compression/color_transform.rs:11-26):

    co = r - b;  t = b + co/2;  cg = g - t;  y = t + cg/2

with the inverse mirrored. The halvings are Rust ``i32`` divisions, which
truncate toward zero; ``//`` floors, so ``trunc_div2(x) = (x + (x >>> 31 &
1)) >> 1`` adds one before the shift iff x is negative. Elementwise on numpy
or torch int32 arrays (pass ``xp``).
"""

from __future__ import annotations

import numpy as np


def _div2_trunc(x, xp=np):
    """x / 2 with truncation toward zero, for int32 arrays."""
    x = xp.asarray(x, dtype=xp.int32)
    return (x + ((x >> 31) & 1)) >> 1


def rgb_to_ycocg(r, g, b, xp=np):
    r = xp.asarray(r, dtype=xp.int32)
    g = xp.asarray(g, dtype=xp.int32)
    b = xp.asarray(b, dtype=xp.int32)
    co = r - b
    t = b + _div2_trunc(co, xp)
    cg = g - t
    y = t + _div2_trunc(cg, xp)
    return y, co, cg


def ycocg_to_rgb(y, co, cg, xp=np):
    y = xp.asarray(y, dtype=xp.int32)
    co = xp.asarray(co, dtype=xp.int32)
    cg = xp.asarray(cg, dtype=xp.int32)
    t = y - _div2_trunc(cg, xp)
    g = cg + t
    b = t - _div2_trunc(co, xp)
    r = b + co
    return r, g, b
