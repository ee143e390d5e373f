"""FLCT, the tiled container: the port's K1 and K2, its per-tile payloads,
its geometry groups and its controls, for the harness (``harness.py``), the
check (``check.py``) and the controls' runs (``control.py``). A
configuration of this container gives its ``tile``."""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np

from h100_bench.reference import controls, flct_ref

KERNELS = {"encode": "flct_encode_kernel", "decode": "flct_decode_kernel"}


def launches(direction: str) -> int:
    """The program's count of launches of the direction's kernel."""
    from felics_tpu_torch.ops import tile_codec

    return tile_codec.ENCODE_LAUNCHES if direction == "encode" else tile_codec.DECODE_LAUNCHES


def payload_bytes(blob: bytes) -> int:
    """The bytes of a container's tile streams."""
    return flct_ref.read_container(blob).payload_bytes


def reference(pool: Sequence[np.ndarray], config: Dict, device) -> Callable[[List[int]], List[bytes]]:
    """The reference's containers of pool indices, each made once."""
    tile = tuple(config["tile"])
    made: Dict[int, bytes] = {}

    def get(indices: List[int]) -> List[bytes]:
        for i in indices:
            if i not in made:
                made[i] = flct_ref.encode_image(pool[i], tile, device)
        return [made[i] for i in indices]
    return get


def groups(images: Sequence[np.ndarray], config: Dict) -> int:
    """Geometry groups one batch dispatches: the distinct (clamped tile
    dims, channels, depth)."""
    tile = tuple(config["tile"])
    return len({(flct_ref.tile_dims(*im.shape[:2], tile), im.ndim, im.dtype.str)
                for im in images})


def control(direction: str, config: Dict, device):
    """The control's stand-in for a driver's call (``harness.run_cell``):
    v0 containers (no k-prior) for encode, the images one bit coarser for
    decode (``reference/controls.py``)."""
    tile = tuple(config["tile"])
    if direction == "encode":
        return lambda driver, items: controls.v0_encode([driver.pool[i] for i in items], tile,
                                                        device)
    return lambda driver, items: controls.lossy_decode([driver.pool[i] for i in items])
