"""FLCT sharded over a group of processes on ``torch.distributed``.

Counterpart: felics_tpu/parallel/multihost.py (``init_process``,
``global_tile_mesh``, ``encode_tiled_multihost``,
``encode_corpus_multihost``, ``decode_tiled_multihost``). Every rank
passes the same image(s) or container and gets the same container bytes or
image back, equal to the one-process ``tiling.compress_tiled_bytes`` /
``batch.compress_tiled_batch`` / ``tiling.decompress_tiled_bytes``. Each
rank encodes or decodes only its own contiguous slice of the tiles, on its
own ``device``, through the steps of ``mesh.py`` (``encode_shards``,
``decode_shards``); the tiles and the exact k0/prior pass are made on every
rank alike (a deterministic integer pass over the same pixels), so the
headers agree without an exchange.

The shards run without collectives; the only ones are the gathers of the
results: the per-tile byte counts, the streams, and the decoded planes.
The host assembles the offsets. A gather's shape must be the same on every
rank, and the width and capacity hints of ``tile_codec`` and ``tiling``
are per process, so nothing gathered is shaped by them: the tile counts
are fixed by the image and the rank count, and the streams are gathered
after their sizes, each rank's padded to the largest. A rank's hints only
decide whether it relaunches its own kernel.

Backends: gloo gathers host tensors, so under gloo the results are copied
to the host (``HostCopy``), gathered there, and the gathered planes copied
back to the rank's device, where the image is assembled as on one device;
NCCL gathers device tensors on the rank's device. Every gather moves the
tensors' bytes (uint8 views), whatever their dtype, and the planes travel
narrowed (``mesh.narrow_planes``). The backend is the one ``init_process``
was given and is never switched.

Devices: a bare ``"cuda"`` means ``cuda:<local rank>`` modulo the card
count (the local rank from ``LOCAL_RANK``, as torchrun sets it, else the
group rank), made the current device. NCCL takes one rank a GPU; two
ranks that share one GPU (as on a one-GPU machine) need gloo.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from felics_tpu_torch.config import TileConfig
from felics_tpu_torch.device import on_device, resolve_device, to_host
from felics_tpu_torch.parallel import mesh


def init_process(
    coordinator_address: str, num_processes: int, process_id: int,
    backend: str = "nccl",
) -> None:
    """Join the default ``torch.distributed`` process group, with
    ``coordinator_address`` ("host:port" of rank 0) as its TCP store.
    Idempotent: a second call with the same group returns; one with another
    raises."""
    want = (backend, num_processes, process_id)
    if dist.is_initialized():
        have = (dist.get_backend(), dist.get_world_size(), dist.get_rank())
        if have != want:
            raise RuntimeError(f"already in process group {have}, not {want}")
        return
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
    )


class ProcessMesh(NamedTuple):
    """This rank's place in the group: its rank, the rank count, the device
    its shard runs on and the group's backend."""

    rank: int
    world: int
    device: torch.device
    backend: str

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (same shape and dtype on every rank), in rank
        order: host tensors under gloo, tensors on this rank's device
        under NCCL."""
        if self.backend == "gloo":
            t = torch.from_numpy(to_host(t)[0]) if t.is_cuda else t
        else:
            t = t.to(self.device)
        flat = t.contiguous().reshape(-1).view(torch.uint8)
        out = [torch.empty_like(flat) for _ in range(self.world)]
        with on_device(self.device):
            dist.all_gather(out, flat)
        return [o.view(t.dtype).reshape(t.shape) for o in out]

    def gather_streams(self, tile_bytes: np.ndarray, payload: bytes):
        """Every rank's (tile byte lengths, streams), in rank order: the
        lengths first, then the streams padded to the longest rank's."""
        lens = np.concatenate(
            [to_host(x)[0] for x in self.all_gather(torch.from_numpy(tile_bytes))])
        sizes = lens.reshape(self.world, -1).sum(axis=1)
        buf = np.zeros(max(1, int(sizes.max())), np.uint8)
        buf[: len(payload)] = np.frombuffer(payload, np.uint8)
        streams = self.all_gather(torch.from_numpy(buf))
        return lens, b"".join(
            to_host(s)[0][: int(n)].tobytes() for s, n in zip(streams, sizes))

    def gather_planes(self, planes: Sequence[torch.Tensor]) -> torch.Tensor:
        """Every rank's planes, in rank order, as one tensor on this rank's
        device."""
        (local,) = planes
        return torch.cat(self.all_gather(local)).to(self.device)

    def shards(self) -> dict:
        return {"devices": (self.device,), "first": self.rank, "total": self.world}


def rank_device(device, rank: int) -> torch.device:
    """The device a rank's shard runs on: ``device`` when it is the CPU or
    names a card; for a bare ``"cuda"``, ``cuda:<local rank>`` modulo the
    card count, the local rank read from ``LOCAL_RANK`` or else ``rank``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def global_tile_mesh(device="cuda") -> ProcessMesh:
    """This rank's ``ProcessMesh`` in the default group (``init_process``
    first); its shard runs on ``rank_device(device, rank)``, made the
    current CUDA device."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_process first")
    rank = dist.get_rank()
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return ProcessMesh(rank, dist.get_world_size(), dev, dist.get_backend())


def encode_tiled_multihost(
    image: np.ndarray, tile: Optional[TileConfig] = None, device="cuda"
) -> bytes:
    """FLCT container of one image, its tiles sharded over the ranks."""
    pm = global_tile_mesh(device)
    return mesh.encode_groups([image], tile, gather=pm.gather_streams, **pm.shards())[0]


def encode_corpus_multihost(
    images: Sequence[np.ndarray], tile: Optional[TileConfig] = None, device="cuda"
) -> List[bytes]:
    """FLCT containers of a corpus: every geometry group's tiles, with
    per-tile priors, sharded over the ranks; equal to
    ``batch.compress_tiled_batch``."""
    pm = global_tile_mesh(device)
    return mesh.encode_groups(images, tile, gather=pm.gather_streams, **pm.shards())


def decode_tiled_multihost(data: bytes, device="cuda") -> np.ndarray:
    """The image of an FLCT container, each rank decoding only its own
    tiles' rows and the planes gathered to every rank."""
    pm = global_tile_mesh(device)
    return mesh.decode_shards(data, gather=pm.gather_planes, **pm.shards())


__all__ = [
    "ProcessMesh",
    "decode_tiled_multihost",
    "encode_corpus_multihost",
    "encode_tiled_multihost",
    "global_tile_mesh",
    "init_process",
    "rank_device",
]
