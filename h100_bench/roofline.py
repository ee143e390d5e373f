"""The work an FLCT call has to do, counted from its images and containers
alone, and the least time an H100 could take for it.

The counts measure the same work whatever implements the codec: the raw
image bytes handed in (or handed back), the container payload bytes
produced (or read), and a fixed count of integer operations per coded
sample. Nothing here reads a buffer of the code under test.
"""

from __future__ import annotations

from typing import Sequence, Tuple

# H100 SXM peaks (NVIDIA's data sheet, at a 700 W power limit): HBM3 bytes a
# second, and 32-bit operations a second outside the tensor cores (the
# float32 rate, the nearest published entry to the codec's integer work).
HBM_BYTES_S = 3.35e12
SCALAR_OPS_S = 67e12
# Integer operations per coded sample: neighbours, context, marker, code and
# k-table (frozen; the same count for encode and decode).
OPS_PER_SAMPLE = 10


def samples(shape: Tuple[int, ...]) -> int:
    """Coded samples of an (H, W) or (H, W, 3) image."""
    n = 1
    for d in shape:
        n *= int(d)
    return n


def image_work(shape: Tuple[int, ...], sample_bytes: int, payload_bytes: int) -> Tuple[int, int]:
    """(bytes, operations) of coding one image either way: its raw samples
    once and its container payload once, and OPS_PER_SAMPLE a sample."""
    s = samples(shape)
    return s * sample_bytes + int(payload_bytes), OPS_PER_SAMPLE * s


def least_seconds(nbytes: float, ops: float) -> float:
    """The larger of the bytes at HBM_BYTES_S and the operations at
    SCALAR_OPS_S."""
    return max(nbytes / HBM_BYTES_S, ops / SCALAR_OPS_S)


def call_least_seconds(shapes: Sequence[Tuple[int, ...]], sample_bytes: int,
                       payloads: Sequence[int]) -> float:
    """Least seconds of one call over these images: their bytes and
    operations summed, then bounded."""
    nbytes = ops = 0
    for shape, pay in zip(shapes, payloads):
        b, o = image_work(shape, sample_bytes, pay)
        nbytes, ops = nbytes + b, ops + o
    return least_seconds(nbytes, ops)
