"""FLCS, the single stream bit-exact with the Rust ``cfelics``: the port's
K3 (the k scan) and K4 (the decoder), its payloads, its shape groups and
its controls, for the harness (``harness.py``), the check (``check.py``)
and the controls' runs (``control.py``). FLCS has no tile."""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np

from h100_bench.reference import controls, flcs_ref

KERNELS = {"encode": "flcs_kscan_kernel", "decode": "flcs_decode_kernel"}


def launches(direction: str) -> int:
    """The program's count of launches of the direction's kernel."""
    if direction == "encode":
        from felics_tpu_torch.ops import kscan

        return kscan.LAUNCHES
    from felics_tpu_torch.core import codec

    return codec.DECODE_LAUNCHES


def payload_bytes(blob: bytes) -> int:
    """The bytes of a container's bitstream: all but its 14-byte header."""
    return flcs_ref.read_header(blob).payload_bytes


def reference(pool: Sequence[np.ndarray], config: Dict, device) -> Callable[[List[int]], List[bytes]]:
    """The reference's containers of pool indices, each made once; the
    indices not made yet are coded in one call, same-shape images together."""
    made: Dict[int, bytes] = {}

    def get(indices: List[int]) -> List[bytes]:
        new = sorted({i for i in indices if i not in made})
        made.update(zip(new, flcs_ref.encode_images([pool[i] for i in new], device)))
        return [made[i] for i in indices]
    return get


def groups(images: Sequence[np.ndarray], config: Dict) -> int:
    """Shape groups one batch dispatches to the device: the distinct (H, W,
    colour, depth) of the images of two pixels or more (smaller ones are
    raw words, coded on the host)."""
    return len({(im.shape, im.dtype.str) for im in images if im.shape[0] * im.shape[1] >= 2})


def control(direction: str, config: Dict, device):
    """The control's stand-in for a driver's call (``harness.run_cell``):
    for encode the reference with its k-tables never halved, the shortcut
    FLCT's estimator takes (a decoder that takes it too reads them back,
    but they are not the bytes ``dfelics`` expects); for decode the images one bit coarser
    (``reference/controls.py``)."""
    if direction == "encode":
        return lambda driver, items: flcs_ref.encode_images(
            [driver.pool[i] for i in items], device, count_scaling=None)
    return lambda driver, items: controls.lossy_decode([driver.pool[i] for i in items])
