"""felics_tpu_torch: the FELICS codec on PyTorch and CUDA.

The port of ``felics_tpu`` (JAX/Pallas, the reference) to an NVIDIA H100:
the reference-compatible FLCS single stream and the FLCT tiled container,
both directions, one image or a batch. The two Pallas kernels of the FLCT
tile codec and the two serial scans of FLCS (the adaptive-k scan and the
per-pixel decoder) are hand-written CUDA kernels here (``csrc/``, built
for ``sm_90a`` at first use). The byte formats, the errors and the coding
configs are the port's own copies (``format``, ``errors``, ``config``):
this package imports ``torch`` and nothing of ``jax`` or ``felics_tpu``.
Corrupt input raises ``DecompressionError`` (``felics_tpu_torch.errors``).

Entry points, each taking ``device`` (default ``"cuda"``, which raises on a
host without CUDA; pass ``device="cpu"`` for the plain PyTorch versions)
and ``backend`` (``"device"``, the default; ``"oracle"``, the scalar codec
of ``core/oracle.py``; ``"native"``, the repository's C++ codec):

* ``compress_image_bytes`` / ``decompress_image_bytes``,
  ``compress_image`` / ``decompress_image`` (file objects) — one image,
  ``container="flcs"`` (default) or ``"flct"``; decode reads the container
  kind from the bytes;
* ``compress_images_bytes`` / ``decompress_images_bytes`` — a batch;
* ``probe`` — header-only metadata;
* ``compress_tiled_bytes`` / ``decompress_tiled_bytes``,
  ``compress_tiled_batch`` / ``decompress_tiled_batch`` (``on_error``
  ``"raise"`` or ``"isolate"``) and the pipelined
  ``compress_tiled_stream`` / ``decompress_tiled_stream`` — the FLCT
  pipeline directly;
* ``Header``, ``ColorType``, ``PixelDepth``, ``MAGIC``, ``read_header``,
  ``write_header`` and ``CodingConfig`` / ``CONFIG_8BIT`` /
  ``CONFIG_16BIT`` — the FLCS header and the coding configs, as the
  reference package exports them.
"""

__version__ = "0.1.0"

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
from felics_tpu_torch.config import CONFIG_8BIT, CONFIG_16BIT, CodingConfig
from felics_tpu_torch.device import resolve_device
from felics_tpu_torch.errors import DecompressionError
from felics_tpu_torch.format import (
    MAGIC,
    ColorType,
    Header,
    PixelDepth,
    read_header,
    write_header,
)
from felics_tpu_torch.parallel.batch import (
    compress_tiled_batch,
    compress_tiled_stream,
    decompress_tiled_batch,
    decompress_tiled_stream,
)
from felics_tpu_torch.parallel.tiling import (
    compress_tiled_bytes,
    decompress_tiled_bytes,
)

__all__ = [
    "__version__",
    "CONFIG_16BIT",
    "CONFIG_8BIT",
    "CodingConfig",
    "ColorType",
    "DecompressionError",
    "Header",
    "MAGIC",
    "PixelDepth",
    "compress_image",
    "compress_image_bytes",
    "compress_images_bytes",
    "compress_tiled_batch",
    "compress_tiled_bytes",
    "compress_tiled_stream",
    "decompress_image",
    "decompress_image_bytes",
    "decompress_images_bytes",
    "decompress_tiled_batch",
    "decompress_tiled_bytes",
    "decompress_tiled_stream",
    "header_for_array",
    "probe",
    "read_header",
    "resolve_device",
    "write_header",
]
