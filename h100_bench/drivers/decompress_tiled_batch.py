"""Serve: ``decompress_tiled_batch`` on each call's containers, one call
after another. Set-up encodes the pool once with ``compress_tiled_batch``;
a call's outputs are its images."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

DIRECTION = "decode"


def encode_pool(pool: Sequence[np.ndarray], tile, device, batch: int) -> List[bytes]:
    """The pool's containers, made by the code under test in calls of
    ``batch`` images."""
    from felics_tpu_torch import compress_tiled_batch
    from felics_tpu_torch.config import TileConfig

    tc = TileConfig(*tile)
    out: List[bytes] = []
    for i in range(0, len(pool), batch):
        out.extend(compress_tiled_batch(list(pool[i : i + batch]), tc, device=device))
    return out


class Driver:
    def __init__(self, pool: Sequence[np.ndarray], tile, mix: dict, device):
        from felics_tpu_torch import decompress_tiled_batch

        self.pool, self.device = pool, device
        self.containers = encode_pool(pool, tile, device, mix["batch"])
        self._decode = decompress_tiled_batch

    def chunks(self, items: Sequence[int]) -> List[List[int]]:
        return [list(items)]

    def call(self, items: Sequence[int]) -> List[np.ndarray]:
        return self._decode([self.containers[i] for i in items], device=self.device)
