"""Serve of FLCS: ``decompress_images_bytes`` on each call's containers,
one call after another. Set-up encodes the pool once with
``compress_images_bytes(..., container="flcs")``, the code under test, in
calls of the mix's ``batch``; a call's outputs are its images."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

DIRECTION = "decode"


class Driver:
    def __init__(self, pool: Sequence[np.ndarray], mix: dict, device):
        from felics_tpu_torch import compress_images_bytes, decompress_images_bytes

        self.pool, self.device = pool, device
        batch = mix["batch"]
        self.containers: List[bytes] = []
        for i in range(0, len(pool), batch):
            self.containers.extend(compress_images_bytes(list(pool[i : i + batch]),
                                                         container="flcs", device=device))
        self._decode = decompress_images_bytes

    def chunks(self, items: Sequence[int]) -> List[List[int]]:
        return [list(items)]

    def call(self, items: Sequence[int]) -> List[np.ndarray]:
        return self._decode([self.containers[i] for i in items], device=self.device)
