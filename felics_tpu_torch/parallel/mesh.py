"""FLCT with the tile axis sharded over several devices of one process.

Counterpart: felics_tpu/parallel/mesh.py (``make_tile_mesh``,
``encode_tiled_sharded``, ``decode_tiled_sharded``) and the corpus encode
its tests run over a mesh (``multihost.encode_corpus_multihost`` given a
mesh; here ``encode_corpus_sharded``). A mesh is a tuple of
``torch.device``s; one device may appear more than once.

Encode: the one-device chain's first half (``tiling.encode_images``: tiles
and the exact k0/prior pass) runs once, on the mesh's first device; the
tile count is padded with zero tiles to a multiple of the mesh size; each
device gets a contiguous slice of the tiles and its priors and dispatches
the second half under itself without waiting (``tiling.shard_dispatch``);
then every shard is finished (``tiling.shard_finish``: the relaunch at the
exact width and the recompaction stay shared with the one-device path), and one
container is packed from the per-tile byte counts and streams gathered in
tile order, the padding tiles dropped. A tile's stream depends on nothing
but its pixels and its prior, so the bytes equal
``tiling.compress_tiled_bytes`` on one device.

Decode: each device stages only its own tiles' streams (a padding slot
repeats tile 0, a valid stream) and runs the one-device chain's first half
on them (``tiling.decode_planes``: word rows, K2); the planes are gathered
onto the first device in tile order and assembled, range-checked and
cropped there (the process groups gather them narrowed, ``narrow_planes``).
A truncated payload raises ``IoError``, a value outside the depth
``InvalidValue``, as the one-device path does.

There are no collectives: the gathers are copies between devices of one
process. ``multihost.py`` runs the same steps (``encode_shards``,
``decode_shards``) with one shard a process and ``torch.distributed``
gathers. The reference's engine plumbing (``fused_encode_step``,
``worst_case_payload_bits``, ``xla_row_width``, ``LAST_ENGINE``, the
``engine`` argument, the shard_map engines) has no counterpart: the port
has one engine, the kernels of each device.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from felics_tpu_torch import errors
from felics_tpu_torch.config import TileConfig
from felics_tpu_torch.device import HostCopy, on_device, resolve_device, upload_filled
from felics_tpu_torch.format import Header, PixelDepth
from felics_tpu_torch.parallel import batch, flct, tiling

Mesh = Tuple[torch.device, ...]


def make_tile_mesh(devices=None) -> Mesh:
    """The devices to shard tiles over, as ``torch.device``s: every CUDA
    device when ``devices`` is None (raises on a host without CUDA), else
    the given ones (e.g. ``["cpu"] * 8``, or ``["cuda:0", "cuda:0"]``)."""
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        mesh.append(dev)
    if not mesh:
        raise ValueError("a tile mesh needs at least one device")
    return tuple(mesh)


def encode_shards(
    images: Sequence[np.ndarray], headers: Sequence[Header], th: int, tw: int,
    devices: Sequence[torch.device], first: int = 0, total: Optional[int] = None,
    gather: Optional[Callable] = None,
) -> List[bytes]:
    """Containers of same-geometry images, their tiles cut into ``total``
    (default ``len(devices)``) equal contiguous shards, of which this
    process runs ``first``, ``first + 1``, ... on ``devices``.
    ``gather(tile_bytes, payload)``, when given, returns every process's
    (tile byte lengths, streams) in shard order from this process's own."""
    total = total or len(devices)
    dev0 = devices[0]
    plan = tiling.encode_plan(headers, th, tw, True, shards=total)
    with on_device(dev0):
        buf = upload_filled(plan.in_bytes(), dev0,
                            lambda host: tiling.fill_images(host, plan, images))
        tiles, k0, prior = tiling.encode_images(buf, plan)
        nt = tiles.shape[0]
        per = -(-nt // total)
        pad = per * total - nt
        if pad:
            tiles = torch.cat([tiles, tiles.new_zeros((pad,) + tiles.shape[1:])])
            prior = torch.cat([prior, prior.new_zeros((pad,) + prior.shape[1:])])
    pending = []
    for i, dev in enumerate(devices):
        lo = (first + i) * per
        with on_device(dev):
            pending.append(tiling.shard_dispatch(
                tiles[lo : lo + per].to(dev, non_blocking=True),
                prior[lo : lo + per].to(dev, non_blocking=True),
                plan, *([k0] if i == 0 else [])))
    done = [tiling.shard_finish(p) for p in pending]
    (k0_np,) = done[0][2]
    tile_bytes = np.concatenate([d[0] for d in done])
    payload = b"".join(d[1] for d in done)
    if gather is not None:
        tile_bytes, payload = gather(tile_bytes, payload)
    tile_bytes = tile_bytes[:nt]  # the padding tiles come last
    payload = payload[: int(tile_bytes.sum())]
    return tiling.pack_containers(headers, tiling.tile_counts(th, tw, plan.dims), th, tw,
                                  tile_bytes, payload, k0_np)


def encode_groups(
    images: Sequence[np.ndarray], tile: Optional[TileConfig], **shards,
) -> List[bytes]:
    """One container per image: the zero-area members' header-only ones,
    and each geometry group through ``encode_shards(..., **shards)``, the
    groups in the order their first members come."""
    images = [np.ascontiguousarray(im) for im in images]
    headers, out, groups = batch.geometry_groups(images, tile or TileConfig())
    for (th, tw, _, _), idx in groups.items():
        blobs = encode_shards([images[i] for i in idx], [headers[i] for i in idx],
                              th, tw, **shards)
        for i, blob in zip(idx, blobs):
            out[i] = blob
    return out


def encode_tiled_sharded(
    image: np.ndarray, mesh: Mesh, tile: Optional[TileConfig] = None
) -> bytes:
    """FLCT container of one image with its tiles sharded over ``mesh``;
    byte-identical to ``tiling.compress_tiled_bytes`` on one device."""
    return encode_groups([image], tile, devices=mesh)[0]


def encode_corpus_sharded(
    images: Sequence[np.ndarray], mesh: Mesh, tile: Optional[TileConfig] = None
) -> List[bytes]:
    """FLCT containers of a corpus, every geometry group's tiles (with
    per-tile priors) sharded over ``mesh``; equal to
    ``batch.compress_tiled_batch``."""
    return encode_groups(images, tile, devices=mesh)


def narrow_planes(planes: torch.Tensor, hd) -> torch.Tensor:
    """A shard's decoded planes as they travel between processes: at 8 bits,
    clamped to one past the depth's plane bounds and narrowed to int16 (a
    value out of range stays out of range, so the assembly flags the image
    as it would have); 16-bit planes stay int32. Runs on the planes'
    device."""
    if hd.pixel_depth != PixelDepth.EIGHT:
        return planes
    lo, hi = tiling.plane_bounds(hd)
    return planes.clamp(lo - 1, hi + 1).to(torch.int16)


def decode_shards(
    data: bytes, devices: Sequence[torch.device], first: int = 0,
    total: Optional[int] = None, gather: Optional[Callable] = None,
) -> np.ndarray:
    """The image of an FLCT container, its tiles cut into ``total``
    (default ``len(devices)``) equal contiguous shards, of which this
    process decodes ``first``, ``first + 1``, ... on ``devices``.
    ``gather(planes)``, when given, returns every process's planes in shard
    order, as one tensor on the first device, from this process's list of
    them (narrowed by ``narrow_planes``)."""
    total = total or len(devices)
    hd = flct.read_tiled_header(data)
    if hd.height == 0 or hd.width == 0:
        return tiling.empty_image(hd)
    payload = bytes(tiling.payload_of(data, hd))  # shards join slices of it
    n, lens = hd.n_tiles, hd.tile_lengths
    plan = tiling.decode_plan([hd], lens)
    starts = np.concatenate([[0], np.cumsum(lens)])
    per = -(-n // total)
    planes = []
    for i, dev in enumerate(devices):
        lo = min((first + i) * per, n)
        hi = min(lo + per, n)
        pad = per - (hi - lo)  # padding slots repeat tile 0
        shard_lens = np.concatenate([lens[lo:hi], np.repeat(lens[:1], pad)])
        shard_pay = payload[starts[lo] : starts[hi]] + payload[: int(lens[0])] * pad
        shard = tiling.decode_plan([hd], shard_lens)._replace(wd=plan.wd)  # the image's rows
        with on_device(dev):
            buf = upload_filled(shard.in_bytes(), dev, lambda host: tiling.fill_containers(
                host, shard, [hd], shard_lens, [shard_pay]))
            planes.append(tiling.decode_planes(buf, shard))
    dev0 = devices[0]
    with on_device(dev0):
        if gather is not None:
            bufs = gather([narrow_planes(p, hd) for p in planes]).to(torch.int32)
        else:
            bufs = torch.cat([p.to(dev0, non_blocking=True) for p in planes])
        (img,), ok = tiling.decode_finish(HostCopy(*tiling.assembled(plan, bufs[:n])))
    if not ok[0]:
        raise errors.InvalidValue("decoded value does not fit the pixel depth")
    return img


def decode_tiled_sharded(data: bytes, mesh: Mesh) -> np.ndarray:
    """FLCT decode with the tiles sharded over ``mesh``: each device holds
    and decodes only its own tiles' rows."""
    return decode_shards(data, mesh)


__all__ = [
    "Mesh",
    "decode_tiled_sharded",
    "encode_corpus_sharded",
    "encode_tiled_sharded",
    "make_tile_mesh",
]
