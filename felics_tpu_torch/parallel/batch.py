"""Batched and streamed FLCT encode/decode: the serving calls.

Counterpart: felics_tpu/parallel/batch.py (``compress_tiled_batch``,
``decompress_tiled_batch`` with ``on_error="raise"`` or ``"isolate"``, and
the pipelined pair ``compress_tiled_stream`` / ``decompress_tiled_stream``).
Members are grouped by geometry (tile dims, channel count, depth); each
group runs one k0 pass and one kernel launch over all its tiles, with
per-tile priors, and one copy back to the host; on CUDA a same-shape group
replays its key's CUDA graph from the key's second sighting on
(``graphs.py``). A call dispatches every group
(``tiling.encode_group_dispatch`` / ``decode_group_dispatch``, which never
wait on the device) before it finishes any, and the stream keeps up to
``depth`` batches dispatched and unfinished, each on a CUDA stream of its
own, so one batch's copies and host work overlap another's kernels; two
batches in flight under one key replay two graphs. Every container equals
the one ``tiling.compress_tiled_bytes`` makes for that image alone.
"""

from __future__ import annotations

import contextlib
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from felics_tpu_torch import errors
from felics_tpu_torch.config import TileConfig
from felics_tpu_torch.device import resolve_device
from felics_tpu_torch.format import header_for_array
from felics_tpu_torch.parallel import flct, tiling
from felics_tpu_torch.spans import span


def _check_on_error(on_error: str) -> bool:
    if on_error not in ("raise", "isolate"):
        raise ValueError("on_error must be 'raise' or 'isolate'")
    return on_error == "isolate"


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------


def geometry_groups(images: Sequence[np.ndarray], tile: TileConfig):
    """(headers, out holding the containers of the zero-area members and
    None elsewhere, {(th, tw, color, depth): member indices} in the order
    the members come)."""
    with span("felics.stage.group"):
        headers = [header_for_array(im) for im in images]
        out: List[Optional[bytes]] = [None] * len(images)
        groups: Dict[Tuple, List[int]] = {}
        for i, hd in enumerate(headers):
            if hd.height == 0 or hd.width == 0:
                out[i] = flct.empty_container(hd, tile)
                continue
            th, tw = flct.clamped_tile_dims(hd.height, hd.width, tile)
            key = (th, tw, hd.color_type, hd.pixel_depth)
            groups.setdefault(key, []).append(i)
    return headers, out, groups


def _encode_dispatch(images: Sequence[np.ndarray], tile: TileConfig, dev):
    """Containers of the zero-area members, and every geometry group's
    encode dispatched: (out, [(member indices, pending)])."""
    headers, out, groups = geometry_groups(images, tile)
    pending = [
        (idx, tiling.encode_group_dispatch(
            [images[i] for i in idx], [headers[i] for i in idx], th, tw, True, dev))
        for (th, tw, _, _), idx in groups.items()
    ]
    return out, pending


def _encode_finish(state) -> List[bytes]:
    out, pending = state
    for idx, p in pending:
        for i, blob in zip(idx, tiling.encode_finish(p)):
            out[i] = blob
    return out


def compress_tiled_batch(
    images: Sequence[np.ndarray], tile: Optional[TileConfig] = None,
    device="cuda",
) -> List[bytes]:
    """FLCT v2 containers of a list of (H, W[, 3]) uint8/uint16 images."""
    dev = resolve_device(device)
    return _encode_finish(_encode_dispatch(list(images), tile or TileConfig(), dev))


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _read_members(datas: Sequence[bytes], isolate: bool) -> List:
    """(header, payload) of each container, read and checked on the host,
    both views of the container's bytes (the payload is copied once, into
    the chain's input, before the dispatch returns). ``isolate`` keeps a
    bad member's DecompressionError in its place; otherwise every header
    is read before any payload is checked, and the first failure raises."""
    if not isolate:
        headers = [flct.read_tiled_header(d) for d in datas]
        return [(hd, tiling.payload_of(d, hd)) for d, hd in zip(datas, headers)]
    members: List = []
    for d in datas:
        try:
            hd = flct.read_tiled_header(d)
            members.append((hd, tiling.payload_of(d, hd)))
        except errors.DecompressionError as e:
            members.append(e)
    return members


def _decompress_one_isolated(data: bytes, dev):
    try:
        return tiling.decompress_tiled_bytes(data, device=dev)
    except errors.DecompressionError as e:
        return e


def _decode_dispatch(datas: Sequence[bytes], dev, isolate: bool):
    """Host checks, then every geometry group's decode dispatched:
    (out, [(member indices, pending or the group's DecompressionError)],
    datas)."""
    out: List = [None] * len(datas)
    groups: Dict[Tuple, List[int]] = {}
    with span("felics.stage.group"):
        members = _read_members(datas, isolate)
        for i, m in enumerate(members):
            if isinstance(m, errors.DecompressionError):
                out[i] = m
                continue
            hd = m[0]
            if hd.height == 0 or hd.width == 0:
                out[i] = tiling.empty_image(hd)
                continue
            key = (hd.tile_h, hd.tile_w, hd.color_type, hd.pixel_depth)
            groups.setdefault(key, []).append(i)
    pending = []
    for idx in groups.values():
        try:
            p = tiling.decode_group_dispatch(
                [members[i][0] for i in idx], [members[i][1] for i in idx], dev)
        except errors.DecompressionError as e:
            if not isolate:
                raise
            p = e
        pending.append((idx, p))
    return out, pending, datas


def _decode_finish(state, dev, isolate: bool) -> List:
    """Each group's images; an image whose values do not fit its depth gets
    InvalidValue (raised, or kept in its place when isolating). A group
    that fails as a whole while isolating is decoded member by member."""
    out, pending, datas = state
    for idx, p in pending:
        try:
            if isinstance(p, errors.DecompressionError):
                raise p
            imgs, ok = tiling.decode_finish(p)
        except errors.DecompressionError:
            if not isolate:
                raise
            for i in idx:
                out[i] = _decompress_one_isolated(datas[i], dev)
            continue
        for i, im, good in zip(idx, imgs, ok):
            if good:
                out[i] = im
                continue
            e = errors.InvalidValue("decoded value does not fit the pixel depth")
            if not isolate:
                raise e
            out[i] = e
    return out


def decompress_tiled_batch(
    datas: Sequence[bytes], device="cuda", on_error: str = "raise"
) -> List:
    """Images of a list of FLCT containers. ``on_error="raise"``: any
    corrupt member raises its ``felics_tpu_torch.errors.DecompressionError``,
    as the per-image call does. ``on_error="isolate"``: the list holds the
    image of each good member and the error instance of each bad one;
    headers and truncation are checked on the host first, and the survivors
    decode in one pass per geometry group."""
    isolate = _check_on_error(on_error)
    dev = resolve_device(device)
    return _decode_finish(_decode_dispatch(list(datas), dev, isolate), dev, isolate)


# ---------------------------------------------------------------------------
# Streams
# ---------------------------------------------------------------------------


def _check_depth(depth: int) -> None:
    if depth < 1:
        raise ValueError(f"depth must be >= 1; got {depth}")


_slot_streams: Dict[int, List] = {}  # device index -> the streams of in-flight slots


def _streams(dev, depth: int) -> List:
    """The first ``depth`` slot streams of ``dev``, made once and kept: the
    caching allocator keeps freed device blocks per stream, so streams that
    last from call to call find their blocks again."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    kept = _slot_streams.setdefault(index, [])
    while len(kept) < depth:
        kept.append(torch.cuda.Stream(index))
    return kept[:depth]


def _pipeline(
    batches: Iterable, depth: int, dev, dispatch: Callable, finish: Callable,
) -> List[List]:
    """Dispatch batches as they come, with at most ``depth`` dispatched and
    not finished; the oldest is finished before the next is dispatched.
    On CUDA, in-flight slot s runs on a stream of its own (batch n takes
    slot n % depth, free again by then): its uploads, kernels and copies,
    and any redo at finish, stay on that stream, so no tensor crosses
    streams. Results come back in input order."""
    if dev.type == "cuda":
        slots = _streams(dev, depth)
        on = torch.cuda.stream
    else:
        slots, on = [None] * depth, lambda _: contextlib.nullcontext()
    pending: deque = deque()
    results: List[List] = []

    def finish_oldest():
        slot, state = pending.popleft()
        with on(slot):
            results.append(finish(state))

    for n, batch in enumerate(batches):
        while len(pending) >= depth:
            finish_oldest()
        slot = slots[n % depth]
        with on(slot):
            pending.append((slot, dispatch(list(batch))))
    while pending:
        finish_oldest()
    return results


def compress_tiled_stream(
    batches: Iterable[Sequence[np.ndarray]], tile: Optional[TileConfig] = None,
    depth: int = 2, device="cuda",
) -> List[List[bytes]]:
    """Encode a stream of image batches with at most ``depth`` batches in
    flight. ``batches`` is consumed lazily (a generator works; only the
    in-flight batches are held). Returns one list of FLCT containers per
    input batch, in input order, each equal to ``compress_tiled_batch`` of
    that batch."""
    _check_depth(depth)
    dev = resolve_device(device)
    tile = tile or TileConfig()
    return _pipeline(
        batches, depth, dev, lambda b: _encode_dispatch(b, tile, dev), _encode_finish)


def decompress_tiled_stream(
    batches: Iterable[Sequence[bytes]], depth: int = 2, on_error: str = "raise",
    device="cuda",
) -> List[List]:
    """Decode a stream of container batches with at most ``depth`` batches
    in flight (the lazy mirror of ``compress_tiled_stream``); ``on_error``
    as in ``decompress_tiled_batch``, batch by batch."""
    isolate = _check_on_error(on_error)
    _check_depth(depth)
    dev = resolve_device(device)
    return _pipeline(
        batches, depth, dev, lambda b: _decode_dispatch(b, dev, isolate),
        lambda s: _decode_finish(s, dev, isolate))
