"""Device selection for the port, explicit and with no hidden fallback, and
the device helpers both containers (FLCT and FLCS) share: image upload, one
batched copy back to the host, and the causal neighbour indices."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from felics_tpu_torch.core.context import neighbour_indices

_NP_DTYPES = {
    torch.bool: np.bool_, torch.uint8: np.uint8, torch.int32: np.int32,
    torch.int64: np.int64,
}


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA on a host
    without CUDA, instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def upload_image(image: np.ndarray, device: torch.device) -> torch.Tensor:
    """(..., H, W[, 3]) uint8/uint16 images -> int32 tensor on ``device``,
    moving the images' own bytes (uint16 travels as int16 and is masked
    back)."""
    image = np.ascontiguousarray(image)
    if image.dtype == np.uint16:
        t = torch.from_numpy(image.view(np.int16)).to(device)
        return t.to(torch.int32) & 0xFFFF
    return torch.from_numpy(image).to(device).to(torch.int32)


def to_host(*tensors: torch.Tensor) -> List[np.ndarray]:
    """Copy several tensors to the host in ONE transfer (their bytes are
    concatenated on the device), as numpy arrays of their own dtype/shape."""
    flat = [t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    buf = torch.cat(flat).cpu().numpy()
    out, off = [], 0
    for t, f in zip(tensors, flat):
        n = f.numel()
        out.append(buf[off : off + n].view(_NP_DTYPES[t.dtype]).reshape(t.shape))
        off += n
    return out


def neighbours(height: int, width: int, device) -> tuple:
    """The two causal neighbour indices of every raster pixel, as int64
    tensors on ``device`` (first two pixels point at themselves)."""
    return tuple(
        torch.from_numpy(i.astype(np.int64)).to(device)
        for i in neighbour_indices(height, width)
    )
