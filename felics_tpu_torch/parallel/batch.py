"""Batched FLCT encode/decode: the serving pair.

Counterpart: felics_tpu/parallel/batch.py (``compress_tiled_batch``,
``decompress_tiled_batch`` with ``on_error="raise"``). Members are grouped
by geometry (tile dims, channel count, depth); each group runs one k0 pass
and one kernel launch over all its tiles, with per-tile priors, and one
device-to-host copy. Every container equals the one
``tiling.compress_tiled_bytes`` makes for that image alone.

Not ported yet: ``on_error="isolate"`` and the pipelined streaming pair
(``compress_tiled_stream`` / ``decompress_tiled_stream``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from felics_tpu_torch.config import TileConfig
from felics_tpu_torch.device import resolve_device
from felics_tpu_torch.format import header_for_array
from felics_tpu_torch.parallel import flct, tiling


def compress_tiled_batch(
    images: Sequence[np.ndarray], tile: Optional[TileConfig] = None,
    device="cuda",
) -> List[bytes]:
    """FLCT v2 containers of a list of (H, W[, 3]) uint8/uint16 images."""
    dev = resolve_device(device)
    tile = tile or TileConfig()
    headers = [header_for_array(im) for im in images]
    out: List[Optional[bytes]] = [None] * len(images)
    groups: Dict[Tuple, List[int]] = {}
    for i, hd in enumerate(headers):
        if hd.height == 0 or hd.width == 0:
            out[i] = flct.empty_container(hd, tile)
            continue
        th, tw = flct.clamped_tile_dims(hd.height, hd.width, tile)
        key = (th, tw, hd.color_type, hd.pixel_depth)
        groups.setdefault(key, []).append(i)
    for (th, tw, _, _), idx in groups.items():
        blobs = tiling.encode_group(
            [images[i] for i in idx], [headers[i] for i in idx], th, tw,
            True, dev,
        )
        for i, blob in zip(idx, blobs):
            out[i] = blob
    return out


def decompress_tiled_batch(datas: Sequence[bytes], device="cuda") -> List:
    """Images of a list of FLCT containers. Any corrupt member raises (a
    ``felics_tpu_torch.errors.DecompressionError``), as the per-image call does."""
    dev = resolve_device(device)
    headers = [flct.read_tiled_header(d) for d in datas]
    payloads = [tiling.payload_of(d, hd) for d, hd in zip(datas, headers)]
    out: List[Optional[np.ndarray]] = [None] * len(datas)
    groups: Dict[Tuple, List[int]] = {}
    for i, hd in enumerate(headers):
        if hd.height == 0 or hd.width == 0:
            out[i] = tiling.empty_image(hd)
            continue
        key = (hd.tile_h, hd.tile_w, hd.color_type, hd.pixel_depth)
        groups.setdefault(key, []).append(i)
    for idx in groups.values():
        imgs = tiling.decode_group(
            [headers[i] for i in idx], [payloads[i] for i in idx], dev
        )
        for i, im in zip(idx, imgs):
            out[i] = im
    return out
