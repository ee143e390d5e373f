"""Ingest of FLCS: ``compress_images_bytes(..., container="flcs")`` on
each call's images, one call after another. A call's outputs are its FLCS
containers. FLCS has no tile: the harness hands this driver none."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

DIRECTION = "encode"


class Driver:
    def __init__(self, pool: Sequence[np.ndarray], mix: dict, device):
        from felics_tpu_torch import compress_images_bytes

        self.pool, self.device = pool, device
        self._encode = compress_images_bytes

    def chunks(self, items: Sequence[int]) -> List[List[int]]:
        """The batches one call hands the entry point."""
        return [list(items)]

    def call(self, items: Sequence[int]) -> List[bytes]:
        return self._encode([self.pool[i] for i in items], container="flcs",
                            device=self.device)
