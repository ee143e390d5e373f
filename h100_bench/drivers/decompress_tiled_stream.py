"""Serve a stream: one ``decompress_tiled_stream`` call a call, over the
call's containers in ``chunks`` batches of ``chunk``, ``depth`` in flight.
Set-up encodes the pool once with ``compress_tiled_batch``; a call's
outputs are its images, batch after batch."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from h100_bench.drivers.decompress_tiled_batch import encode_pool

DIRECTION = "decode"


class Driver:
    def __init__(self, pool: Sequence[np.ndarray], tile, mix: dict, device):
        from felics_tpu_torch import decompress_tiled_stream

        self.pool, self.device = pool, device
        self.chunk, self.depth = mix["chunk"], mix["depth"]
        self.containers = encode_pool(pool, tile, device, mix["batch"])
        self._decode = decompress_tiled_stream

    def chunks(self, items: Sequence[int]) -> List[List[int]]:
        items = list(items)
        return [items[i : i + self.chunk] for i in range(0, len(items), self.chunk)]

    def call(self, items: Sequence[int]) -> List[np.ndarray]:
        batches = [[self.containers[i] for i in c] for c in self.chunks(items)]
        out = self._decode(iter(batches), depth=self.depth, device=self.device)
        return [im for batch in out for im in batch]
