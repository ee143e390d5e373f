"""Top-level image compress/decompress API of the port.

Counterpart: felics_tpu/api.py. Images are numpy arrays, ``(H, W)``
uint8/uint16 gray or ``(H, W, 3)`` RGB. ``container`` is ``"flcs"`` (the
reference-compatible single stream, the default) or ``"flct"`` (the tiled
container, with ``tile``). Every function takes ``device`` (default
``"cuda"``, which raises on a host without CUDA; ``"cpu"`` runs the plain
PyTorch versions) and ``backend``:

  * ``"device"`` (default) — this package's codecs on ``device``;
  * ``"oracle"`` — FLCS on the sequential scalar codec (``core.oracle``,
    numpy and Python ints, tens of thousands of pixels a second). It has no
    tiled form: FLCT takes the device pipeline on ``device``, as the
    reference's oracle backend takes its JAX pipeline;
  * ``"native"`` — the repository's C++ codec (``native``: ``compress`` /
    ``decompress`` for FLCS, ``compress_tiled`` / ``decompress_tiled`` for
    FLCT). It raises when the library is not built.

A host backend codes a batch image by image. The reference's ``"auto"``,
which picks the accelerator when one is live and a host codec otherwise,
has no counterpart: every outcome of it is one of the three by name, and
a backend never gives way to another.
"""

from __future__ import annotations

import io
from typing import BinaryIO, List, Optional

import numpy as np

from felics_tpu_torch import native
from felics_tpu_torch.config import TileConfig
from felics_tpu_torch.core import codec, oracle
from felics_tpu_torch.format import header_for_array, read_header
from felics_tpu_torch.parallel import batch, flct, tiling

__all__ = [
    "BACKENDS",
    "compress_image",
    "compress_image_bytes",
    "compress_images_bytes",
    "decompress_image",
    "decompress_image_bytes",
    "decompress_images_bytes",
    "header_for_array",
    "probe",
]

BACKENDS = ("device", "oracle", "native")


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; use one of {BACKENDS}")


def _check(container: str, backend: str) -> None:
    if container not in ("flcs", "flct"):
        raise ValueError(f"unknown container {container!r}")
    _check_backend(backend)


def compress_image(
    image: np.ndarray, to: BinaryIO, container: str = "flcs",
    tile: Optional[TileConfig] = None, device="cuda", backend: str = "device",
) -> None:
    to.write(compress_image_bytes(image, container, tile, device, backend))


def compress_image_bytes(
    image: np.ndarray, container: str = "flcs",
    tile: Optional[TileConfig] = None, device="cuda", backend: str = "device",
) -> bytes:
    """One image -> FLCS (``tile`` ignored) or FLCT container bytes."""
    _check(container, backend)
    image = np.ascontiguousarray(image)
    if container == "flct":
        if backend == "native":
            tile = tile or TileConfig()
            return native.compress_tiled(
                image, header_for_array(image), tile.tile_w, tile.tile_h)
        return tiling.compress_tiled_bytes(image, tile, device=device)
    header = header_for_array(image)
    if backend == "native":
        return native.compress(image, header)
    if backend == "oracle":
        return oracle.compress_image_bytes(image, header)
    return codec.compress_image_bytes(image, header, device)


def compress_images_bytes(
    images, container: str = "flcs", tile: Optional[TileConfig] = None,
    device="cuda", backend: str = "device",
) -> List[bytes]:
    """A batch -> one container per image, each equal to the per-image
    call's; on the device, same-shape (FLCS) or same-geometry (FLCT) images
    share one pass."""
    _check(container, backend)
    images = [np.ascontiguousarray(im) for im in images]
    if backend == "native" or (backend == "oracle" and container == "flcs"):
        return [compress_image_bytes(im, container, tile, device, backend)
                for im in images]
    if container == "flct":
        return batch.compress_tiled_batch(images, tile, device=device)
    return codec.compress_images_bytes(images, device)


def decompress_image(from_: BinaryIO, device="cuda", backend: str = "device") -> np.ndarray:
    return decompress_image_bytes(from_.read(), device, backend)


def decompress_image_bytes(data: bytes, device="cuda", backend: str = "device") -> np.ndarray:
    """FLCS or FLCT container bytes -> (H, W[, 3]) uint8/uint16 image."""
    _check_backend(backend)
    if data[:4] == b"FLCT":
        if backend == "native":
            return native.decompress_tiled(data)
        return tiling.decompress_tiled_bytes(data, device=device)
    if backend == "device":
        return codec.decompress_image_bytes(data, device)
    # The header first, for every host backend: its faults raise as the
    # reference's do.
    header = read_header(io.BytesIO(data))
    if backend == "native":
        return native.decompress(data)
    return oracle.decompress_image_bytes(data, header)


def decompress_images_bytes(datas, device="cuda", backend: str = "device") -> List[np.ndarray]:
    """A batch of containers -> images, each equal to the per-image call's.
    On the device an all-FLCT batch takes the batched tile pipeline and an
    all-FLCS batch the batched scan; a mixed batch, or a host backend,
    decodes image by image, as the reference routes it."""
    _check_backend(backend)
    datas = list(datas)
    if not datas:
        return []
    if all(d[:4] == b"FLCT" for d in datas) and backend != "native":
        return batch.decompress_tiled_batch(datas, device=device)
    if all(d[:4] == b"FLCS" for d in datas) and backend == "device":
        return codec.decompress_images_bytes(datas, device=device)
    return [decompress_image_bytes(d, device, backend) for d in datas]


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
            "payload_bytes": h.payload_bytes,
        }
    h = read_header(io.BytesIO(data))
    return {
        "container": "flcs",
        "color_type": h.color_type.name.lower(),
        "pixel_depth": h.pixel_depth.bits,
        "width": h.width,
        "height": h.height,
    }
