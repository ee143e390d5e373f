"""Adaptive Rice-parameter (k) selection, one context at a time.

Counterpart: felics_tpu/core/kestimator.py (reference:
src/compression/parameter_selection.rs:5-86). Per context C,
``table[C][ki]`` holds the total Rice code length the stream would have
cost had ``k_values[ki]`` coded every out-of-range residual seen so far in
C. The rules below shape the bitstream, so they are the reference's
exactly:

  * ``update`` adds ``(v >> k) + 1 + k`` to every column; then, with count
    scaling on (``halve_at``), when the row's **minimum** is **strictly
    greater** than ``halve_at``, every entry of the row is halved (integer).
  * ``get_k`` scans the columns in ascending order with ``<=``, so a tie
    picks the **largest** k: an all-zero row gives the largest k.

This is the scalar form the oracle codec uses; the device codecs compute
the same k for every pixel at once (``ops/kscan.py``, ``csrc/flcs_kscan.cu``
and, per bucket, ``ops/tile_codec.py::tile_k_ref``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class KEstimator:
    def __init__(
        self,
        max_context: int,
        k_values: Sequence[int],
        halve_at: Optional[int],
        prior: Optional[np.ndarray] = None,
    ) -> None:
        """``prior``: a (rows, len(k_values)) seed of the first ``rows``
        contexts' tables (the FLCT v2 per-image k-prior, where contexts are
        buckets); None starts every table at zero (FLCS, FLCT v0)."""
        if len(k_values) == 0:
            raise ValueError("the list of k values is empty")
        self.max_context = max_context
        self.k_values = np.asarray(k_values, dtype=np.int64)
        self.table = np.zeros((max_context + 1, len(k_values)), dtype=np.int64)
        if prior is not None:
            prior = np.asarray(prior, dtype=np.int64)
            self.table[: prior.shape[0]] = prior
        self.halve_at = halve_at

    def update(self, context: int, encoded: int) -> None:
        assert context <= self.max_context
        row = self.table[context]
        row += (encoded >> self.k_values) + 1 + self.k_values
        if self.halve_at is not None and row.min() > self.halve_at:
            row //= 2

    def get_k(self, context: int) -> int:
        assert context <= self.max_context
        row = self.table[context]
        # The last index that reaches the minimum (ascending scan with '<=').
        best = len(row) - 1 - int(np.argmin(row[::-1]))
        return int(self.k_values[best])
