"""The FLCT container on PyTorch: host layout, device chains and batching,
and the tile axis sharded over devices (``mesh``) or processes
(``multihost``)."""

from felics_tpu_torch.parallel.flct import TiledHeader, read_tiled_header
from felics_tpu_torch.parallel.tiling import (
    compress_tiled_bytes,
    decompress_tiled_bytes,
)
from felics_tpu_torch.parallel.batch import (
    compress_tiled_batch,
    compress_tiled_stream,
    decompress_tiled_batch,
    decompress_tiled_stream,
)

__all__ = [
    "compress_tiled_bytes",
    "decompress_tiled_bytes",
    "read_tiled_header",
    "TiledHeader",
    "compress_tiled_batch",
    "decompress_tiled_batch",
    "compress_tiled_stream",
    "decompress_tiled_stream",
]
