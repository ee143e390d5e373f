"""felics_tpu_torch: the FELICS codec on PyTorch and CUDA.

The port of ``felics_tpu`` (JAX/Pallas, the reference) to an NVIDIA H100:
the reference-compatible FLCS single stream and the FLCT tiled container,
both directions, one image or a batch. The two Pallas kernels of the FLCT
tile codec and the two serial scans of FLCS (the adaptive-k scan and the
per-pixel decoder) are hand-written CUDA kernels here (``csrc/``, built
for ``sm_90a`` at first use); the byte formats, the errors and the configs
are shared with ``felics_tpu`` and imported from it. This package imports
``torch`` and never ``jax``.

Entry points, each taking ``device`` (default ``"cuda"``, which raises on a
host without CUDA; pass ``device="cpu"`` for the plain PyTorch versions):

* ``compress_image_bytes`` / ``decompress_image_bytes``,
  ``compress_image`` / ``decompress_image`` (file objects) — one image,
  ``container="flcs"`` (default) or ``"flct"``; decode reads the container
  kind from the bytes;
* ``compress_images_bytes`` / ``decompress_images_bytes`` — a batch;
* ``probe`` — header-only metadata;
* ``compress_tiled_bytes`` / ``decompress_tiled_bytes`` and
  ``compress_tiled_batch`` / ``decompress_tiled_batch`` — the FLCT
  pipeline directly.
"""

from felics_tpu_torch.api import (
    compress_image,
    compress_image_bytes,
    compress_images_bytes,
    decompress_image,
    decompress_image_bytes,
    decompress_images_bytes,
    header_for_array,
    probe,
)
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
    "compress_image",
    "compress_image_bytes",
    "compress_images_bytes",
    "compress_tiled_batch",
    "compress_tiled_bytes",
    "decompress_image",
    "decompress_image_bytes",
    "decompress_images_bytes",
    "decompress_tiled_batch",
    "decompress_tiled_bytes",
    "header_for_array",
    "probe",
    "resolve_device",
]
