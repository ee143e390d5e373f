"""Ingest as ``compress_tiled_batch.py``, on each pool image laid out as an
image decoder hands it over: C-contiguous (H, W) or (H, W, 3), samples
interleaved (PIL's ``np.asarray``, OpenCV's ``imread``, libpng's rows).
``traffic/images.py`` gives rgb images as (H, W, 3) views of (3, H, W)
data; each is copied to the decoders' layout once, before the window."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from h100_bench.drivers import compress_tiled_batch

DIRECTION = compress_tiled_batch.DIRECTION


class Driver(compress_tiled_batch.Driver):
    def __init__(self, pool: Sequence[np.ndarray], tile, mix: dict, device):
        super().__init__([np.ascontiguousarray(im) for im in pool], tile, mix, device)
