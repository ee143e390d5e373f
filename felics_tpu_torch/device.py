"""Device selection for the port, explicit and with no hidden fallback, and
the device helpers both containers (FLCT and FLCS) share: uploads through
one staging buffer, copies back to the host, and the causal neighbour
indices.

On CUDA no helper here waits on the device: uploads go from pinned host
memory with ``non_blocking=True`` on the current stream, and ``HostCopy``
starts a copy into pinned memory and records an event that its ``wait``
blocks on. PyTorch's caching host allocator hands a pinned block out again
only once the copies recorded on it have completed, so a staging buffer is
never overwritten while a copy still reads it, and it rounds sizes up to
powers of two, so batches of similar sizes find their blocks again. On the
CPU the same calls run without streams or pinning.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from felics_tpu_torch.core.context import neighbour_indices
from felics_tpu_torch.spans import span

_NP_DTYPES = {
    torch.bool: np.bool_, torch.uint8: np.uint8, torch.int16: np.int16,
    torch.int32: np.int32, torch.int64: np.int64,
}
# uint16 travels as int16 bit patterns (as_pixels masks them back).
_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool, np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint16): torch.int16, np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
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


def on_device(device: torch.device):
    """A context in which ``device`` is the current CUDA device, so that the
    streams, events and copies the helpers here use are that device's; a
    no-op for the CPU. A chain dispatched to a device that is not the
    current one runs under it."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def upload_filled(
    nbytes: int, device: torch.device, fill: Callable[[np.ndarray], None]
) -> torch.Tensor:
    """A uint8 buffer of ``nbytes`` on ``device`` holding what ``fill(host)``
    writes into a host staging buffer (a uint8 numpy array; pinned on
    CUDA): one copy, never waiting."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=device.type == "cuda")
    flat = host.numpy()  # outside the span: it records an aten::to
    with span("felics.stage.fill"):
        fill(flat)
    return host.to(device, non_blocking=True)


def upload(arrays: Sequence[np.ndarray], device: torch.device) -> List[torch.Tensor]:
    """numpy arrays -> tensors of their shapes on ``device``: views of one
    staged buffer (``upload_filled``), each array at a multiple of its item
    size; uint16 arrives as int16 bit patterns."""
    arrays = [np.asarray(a) for a in arrays]
    offsets, total = [], 0
    for a in arrays:
        total = -(-total // a.itemsize) * a.itemsize
        offsets.append(total)
        total += a.nbytes

    def fill(flat):
        for a, off in zip(arrays, offsets):
            flat[off : off + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(np.uint8)

    buf = upload_filled(total, device, fill)
    return [
        buf[off : off + a.nbytes].view(_TORCH_DTYPES[a.dtype]).reshape(a.shape)
        for a, off in zip(arrays, offsets)
    ]


def as_pixels(t: torch.Tensor) -> torch.Tensor:
    """Uploaded uint8 pixels, or uint16 ones as int16 bit patterns, as int32."""
    if t.dtype == torch.int16:
        return t.to(torch.int32) & 0xFFFF
    return t.to(torch.int32)


def upload_image(image: np.ndarray, device: torch.device) -> torch.Tensor:
    """(..., H, W[, 3]) uint8/uint16 images -> int32 tensor on ``device``,
    moving the images' own bytes."""
    return as_pixels(upload([image], device)[0])


def pack(*tensors: torch.Tensor) -> Tuple[torch.Tensor, List[Tuple]]:
    """Several tensors' bytes, concatenated on their device (one op), and
    the (dtype, shape, byte count) of each, for ``unpack``."""
    flat = [t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    specs = [(t.dtype, tuple(t.shape), f.numel()) for t, f in zip(tensors, flat)]
    return torch.cat(flat), specs


def unpack(buf: np.ndarray, specs: Sequence[Tuple]) -> List[np.ndarray]:
    """numpy views of the tensors ``pack`` concatenated into ``buf``."""
    out, off = [], 0
    for dtype, shape, n in specs:
        out.append(buf[off : off + n].view(_NP_DTYPES[dtype]).reshape(shape))
        off += n
    return out


class HostCopy:
    """Several device tensors copied to the host in ONE transfer (their
    bytes are concatenated on the device). On CUDA the copy goes into
    pinned memory without waiting, followed by an event; ``wait()`` blocks
    on that event and returns numpy arrays of the tensors' dtypes and
    shapes. ``release()`` says the caller is done with those arrays (a
    no-op here; a graph replay's result hands its buffers back then)."""

    def __init__(self, *tensors: torch.Tensor):
        dev_buf, self.specs = pack(*tensors)
        self.event = None
        if dev_buf.is_cuda:
            self.buf = torch.empty(dev_buf.numel(), dtype=torch.uint8, pin_memory=True)
            self.buf.copy_(dev_buf, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.buf = dev_buf

    def wait(self) -> List[np.ndarray]:
        if self.event is not None:
            with span("felics.wait"):
                self.event.synchronize()
        return unpack(self.buf.numpy(), self.specs)

    def release(self) -> None:
        pass


def to_host(*tensors: torch.Tensor) -> List[np.ndarray]:
    """Copy several tensors to the host in one transfer and wait for it."""
    return HostCopy(*tensors).wait()


def neighbours(height: int, width: int, device) -> tuple:
    """The two causal neighbour indices of every raster pixel, as int64
    tensors on ``device``, uploaded without waiting (the first two pixels
    point at themselves)."""
    return tuple(upload([i.astype(np.int64) for i in neighbour_indices(height, width)],
                        torch.device(device)))
