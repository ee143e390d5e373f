"""Two-nearest-causal-neighbour context model.

Counterpart: felics_tpu/core/context.py (reference: src/compression/misc.rs:6-24).
For a pixel at flat raster index ``i`` of an image of width ``w``:

  * interior (x>0, y>0):        (left, above)           = (i-1, i-w)
  * top row (y==0, x>=2):       (left, left-left)       = (i-1, i-2)
  * left column (x==0, y>=2):   (above, above-above)    = (i-w, i-2w)
  * left column (x==0, y==1):   (above, above-right)    = (i-w, i-w+1)
  * otherwise (the first two raster pixels): no neighbours.

``nearest_neighbours`` is the scalar form the oracle walks with (``None``
for the first two pixels); ``neighbour_indices`` gives every pixel's at
once, for the device codecs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def nearest_neighbours(i: int, width: int) -> Optional[Tuple[int, int]]:
    """The two neighbours of raster pixel ``i``, or None for the first two
    pixels; the reference's rule exactly."""
    x, y = i % width, i // width
    if x > 0 and y > 0:
        return (i - 1, i - width)
    if y == 0:
        if x >= 2:
            return (i - 1, i - 2)
        return None
    if y >= 2:
        return (i - width, i - 2 * width)
    if (x + 1) < width:
        return (i - width, i - width + 1)
    return None


def neighbour_indices(height: int, width: int) -> Tuple[np.ndarray, np.ndarray]:
    """int32 arrays ``(a, b)`` of shape (height*width,): the two neighbours
    of every raster pixel. The first two pixels point at themselves; callers
    mask indices < 2."""
    n = height * width
    i = np.arange(n, dtype=np.int32)
    w = width
    x = i % w
    y = i // w

    interior = (x > 0) & (y > 0)
    top_row = (y == 0) & (x >= 2)
    left_col_deep = (x == 0) & (y >= 2)
    left_col_y1 = (x == 0) & (y == 1) & (w > 1)

    a = np.where(interior | top_row, i - 1, np.where(left_col_deep | left_col_y1, i - w, i))
    b = np.where(
        interior,
        i - w,
        np.where(
            top_row,
            i - 2,
            np.where(left_col_deep, i - 2 * w, np.where(left_col_y1, i - w + 1, i)),
        ),
    )
    return a.astype(np.int32), b.astype(np.int32)


def context_of(v1, v2, xp=np):
    """``(low, high, context)`` of two neighbour values, context = H - L;
    elementwise on numpy or torch arrays (pass ``xp``) or on ints."""
    h = xp.maximum(v1, v2)
    low = xp.minimum(v1, v2)
    return low, h, (h - low)
