"""felics_tpu_torch: the FLCT tiled codec on PyTorch and CUDA.

The port of ``felics_tpu`` (JAX/Pallas, the reference) to an NVIDIA H100.
The two Pallas kernels of the FLCT tile codec are hand-written CUDA kernels
here (``csrc/``, built for ``sm_90a`` at first use); the byte format, the
errors and the configs are shared with ``felics_tpu`` and imported from
it. This package imports ``torch`` and never ``jax``.

Entry points, each taking ``device`` (default ``"cuda"``, which raises on a
host without CUDA; pass ``device="cpu"`` for the plain PyTorch versions):

* ``compress_tiled_bytes`` / ``decompress_tiled_bytes`` — one image;
* ``compress_tiled_batch`` / ``decompress_tiled_batch`` — a batch.
"""

from felics_tpu_torch.device import resolve_device
from felics_tpu_torch.parallel.batch import (
    compress_tiled_batch,
    decompress_tiled_batch,
)
from felics_tpu_torch.parallel.tiling import (
    compress_tiled_bytes,
    decompress_tiled_bytes,
)

__all__ = [
    "compress_tiled_batch",
    "compress_tiled_bytes",
    "decompress_tiled_batch",
    "decompress_tiled_bytes",
    "resolve_device",
]
