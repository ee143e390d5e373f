"""Ingest: ``compress_tiled_batch`` on each call's images, one call after
another. A call's outputs are its FLCT containers."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

DIRECTION = "encode"


class Driver:
    def __init__(self, pool: Sequence[np.ndarray], tile, mix: dict, device):
        from felics_tpu_torch import compress_tiled_batch
        from felics_tpu_torch.config import TileConfig

        self.pool, self.device = pool, device
        self.tile = TileConfig(*tile)
        self._encode = compress_tiled_batch

    def chunks(self, items: Sequence[int]) -> List[List[int]]:
        """The batches one call hands the entry point."""
        return [list(items)]

    def call(self, items: Sequence[int]) -> List[bytes]:
        return self._encode([self.pool[i] for i in items], self.tile, device=self.device)
