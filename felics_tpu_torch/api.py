"""Top-level image compress/decompress API of the port.

Counterpart: felics_tpu/api.py. Images are numpy arrays, ``(H, W)``
uint8/uint16 gray or ``(H, W, 3)`` RGB. ``container`` is ``"flcs"`` (the
reference-compatible single stream, the default) or ``"flct"`` (the tiled
container, with ``tile``). In place of the reference's ``backend`` every
function takes ``device`` (default ``"cuda"``, which raises on a host
without CUDA; ``"cpu"`` runs the plain PyTorch versions): this package is
the device backend; the reference's scalar oracle is not ported.
"""

from __future__ import annotations

import io
from typing import BinaryIO, List, Optional

import numpy as np

from felics_tpu_torch.config import TileConfig
from felics_tpu_torch.core import codec
from felics_tpu_torch.format import header_for_array, read_header
from felics_tpu_torch.parallel import batch, flct, tiling

__all__ = [
    "compress_image",
    "compress_image_bytes",
    "compress_images_bytes",
    "decompress_image",
    "decompress_image_bytes",
    "decompress_images_bytes",
    "header_for_array",
    "probe",
]


def _check_container(container: str) -> None:
    if container not in ("flcs", "flct"):
        raise ValueError(f"unknown container {container!r}")


def compress_image(
    image: np.ndarray, to: BinaryIO, container: str = "flcs",
    tile: Optional[TileConfig] = None, device="cuda",
) -> None:
    to.write(compress_image_bytes(image, container, tile, device))


def compress_image_bytes(
    image: np.ndarray, container: str = "flcs",
    tile: Optional[TileConfig] = None, device="cuda",
) -> bytes:
    """One image -> FLCS (``tile`` ignored) or FLCT container bytes."""
    _check_container(container)
    image = np.ascontiguousarray(image)
    if container == "flct":
        return tiling.compress_tiled_bytes(image, tile, device=device)
    return codec.compress_image_bytes(image, header_for_array(image), device)


def compress_images_bytes(
    images, container: str = "flcs", tile: Optional[TileConfig] = None,
    device="cuda",
) -> List[bytes]:
    """A batch -> one container per image, each equal to the per-image
    call's; same-shape (FLCS) or same-geometry (FLCT) images share one
    device pass."""
    _check_container(container)
    images = [np.ascontiguousarray(im) for im in images]
    if container == "flct":
        return batch.compress_tiled_batch(images, tile, device=device)
    return codec.compress_images_bytes(images, device)


def decompress_image(from_: BinaryIO, device="cuda") -> np.ndarray:
    return decompress_image_bytes(from_.read(), device)


def decompress_image_bytes(data: bytes, device="cuda") -> np.ndarray:
    """FLCS or FLCT container bytes -> (H, W[, 3]) uint8/uint16 image."""
    if data[:4] == b"FLCT":
        return tiling.decompress_tiled_bytes(data, device=device)
    return codec.decompress_image_bytes(data, device)


def decompress_images_bytes(datas, device="cuda") -> List[np.ndarray]:
    """A batch of containers -> images, each equal to the per-image call's.
    An all-FLCT batch takes the batched tile pipeline, an all-FLCS batch
    the batched scan; a mixed batch decodes image by image, as the
    reference routes it."""
    datas = list(datas)
    if not datas:
        return []
    if all(d[:4] == b"FLCT" for d in datas):
        return batch.decompress_tiled_batch(datas, device=device)
    if all(d[:4] == b"FLCS" for d in datas):
        return codec.decompress_images_bytes(datas, device=device)
    return [decompress_image_bytes(d, device) for d in datas]


def probe(data: bytes) -> dict:
    """Header-only metadata of an FLCS or FLCT container (no decode)."""
    if data[:4] == b"FLCT":
        h = flct.read_tiled_header(data)
        return {
            "container": "flct",
            "color_type": h.color_type.name.lower(),
            "pixel_depth": h.pixel_depth.bits,
            "width": h.width,
            "height": h.height,
            "tile_w": h.tile_w,
            "tile_h": h.tile_h,
            "n_tiles": h.n_tiles,
            "payload_bytes": int(h.tile_lengths.sum()),
        }
    h = read_header(io.BytesIO(data))
    return {
        "container": "flcs",
        "color_type": h.color_type.name.lower(),
        "pixel_depth": h.pixel_depth.bits,
        "width": h.width,
        "height": h.height,
    }
