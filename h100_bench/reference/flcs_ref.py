"""Plain FLCS encoder and header reader: the reference that the benchmark
holds the port's FLCS containers to.

Written from the FLCS layout (``docs/FORMATS.md`` §FLCS, the Rust
``cfelics``' ``src/compression/format.rs:44-84``) in plain PyTorch. It
imports nothing of the code under test and nothing of JAX; from the FLCT
reference it takes only what the two formats share: the causal neighbours,
the phase-in and Rice symbols, exact bit lengths and the MSB-first packer.
Works on CPU and CUDA tensors alike. Every sample of a same-shape batch is
coded at once; only the k-tables' halvings are taken one after another.

An FLCS container is the 14-byte header (magic ``FLCS``, colour byte,
depth byte, big-endian u32 width and height) and one bitstream an image:
each channel (gray; or Y, Co, Cg of YCoCg-R) coded back to back, one
byte alignment after the last. A channel of an image with fewer than two
pixels is its pixel (0 when there is none) and a 0, raw signed 32-bit
words. Otherwise:

* the first two raster pixels raw, signed 32-bit each;
* each later pixel ``p`` with neighbours giving ``L <= H`` and the context
  ``d = H - L``: ``1`` + phase-in of ``p - L`` over ``d + 1`` values when
  ``L <= p <= H``; else ``00`` (below) or ``01`` (above), then the Rice
  code with parameter ``k`` of ``L - p - 1`` or ``p - H - 1``;
* ``k`` is the last minimum of the k-table row of the exact context ``d``
  (one table a channel, rows starting at zero); every out-of-range value
  ``v`` adds ``(v >> k) + 1 + k`` to each entry ``k`` of its row, and a row
  whose least entry then exceeds ``COUNT_SCALING`` is halved.
"""

from __future__ import annotations

import struct
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from h100_bench.reference.flct_ref import (
    MASK32, depth_of, last_argmin, neighbours, pack_streams, symbols,
)

MAGIC = b"FLCS"
HEADER = struct.Struct(">4sBBII")  # magic, colour, depth, width, height
HEADER_SIZE = HEADER.size
NUM_K = {8: 6, 16: 15}  # k = 0 .. NUM_K - 1
COUNT_SCALING = 1024
# Images a call of ``encode_group`` codes at once in ``encode_images``.
BLOCK = 132


class Header(NamedTuple):
    width: int
    height: int
    channels: int
    depth: int
    payload_bytes: int


def read_header(data: bytes) -> Header:
    """The header facts of an FLCS container (the check of its bytes is
    the comparison with ``encode_images``)."""
    if len(data) < HEADER_SIZE:
        raise ValueError("an FLCS container holds at least its 14-byte header")
    magic, color, depth, w, h = HEADER.unpack_from(data)
    if magic != MAGIC or color > 1 or depth > 1:
        raise ValueError(f"not an FLCS header: {bytes(data[:6])!r}")
    return Header(w, h, 3 if color else 1, 16 if depth else 8, len(data) - HEADER_SIZE)


def header(image: np.ndarray) -> bytes:
    h, w = image.shape[:2]
    return HEADER.pack(MAGIC, int(image.ndim == 3), int(depth_of(image) == 16), w, h)


def planes(images: Sequence[np.ndarray], device) -> torch.Tensor:
    """Same-shape (H, W[, 3]) images -> (N * C, H * W) int64 channel planes,
    image-major (gray; or Y, Co, Cg of YCoCg-R, halvings truncated toward
    zero)."""
    stack = np.stack(images)
    x = torch.from_numpy(stack.astype(np.int32) if stack.dtype == np.uint16 else stack)
    x = x.to(device).to(torch.int64)
    n = len(images)
    if x.dim() == 3:
        return x.reshape(n, -1)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    co = r - b
    t = b + torch.div(co, 2, rounding_mode="trunc")
    cg = g - t
    y = t + torch.div(cg, 2, rounding_mode="trunc")
    return torch.stack([y, co, cg], dim=1).reshape(n * 3, -1)


def segment_prefix(key: torch.Tensor, cost: torch.Tensor):
    """(first slot of each segment, its end, the inclusive prefix sums of
    ``cost`` within its segment) for slots sorted by ``key``, a segment
    being a run of one key."""
    U = key.numel()
    start = torch.ones(U, dtype=torch.bool, device=key.device)
    start[1:] = key[1:] != key[:-1]
    first = start.nonzero().reshape(-1)
    ends = torch.cat([first[1:], torch.tensor([U], device=key.device)])
    seg = torch.cumsum(start, 0) - 1
    incl = torch.cumsum(cost, 0)
    incl -= (incl[first] - cost[first])[seg]
    return first, ends, incl


def halved_bases(first, ends, incl, count_scaling: int):
    """(U, K) base of each slot's table and the number of halvings: a slot's
    k-table before its update is its base plus the segment's prefix sums
    before it. A row's entries only grow between halvings, so the next
    halving of every segment is found at once by a binary search over its
    prefix sums; the segments are walked from halving to halving."""
    U, K = incl.shape
    dev = incl.device
    base = torch.zeros((U, K), dtype=torch.int64, device=dev)
    marked = torch.zeros(U, dtype=torch.bool, device=dev)
    marked[first] = True
    lo_all, cur = first.clone(), torch.zeros((first.numel(), K), dtype=torch.int64, device=dev)
    active = torch.arange(first.numel(), device=dev)
    steps = int((ends - first).max()).bit_length()
    halvings = 0
    while active.numel():
        lo, hi, b = lo_all[active], ends[active], cur[active]
        for _ in range(steps):  # the first slot whose updated row is halved
            mid = (lo + hi) >> 1
            over = (b + incl[mid.clamp(max=U - 1)]).min(dim=1).values > count_scaling
            open_ = lo < hi
            hi = torch.where(open_ & over, mid, hi)
            lo = torch.where(open_ & ~over, mid + 1, lo)
        found = lo < ends[active]
        seg, j = active[found], lo[found]
        halvings += int(seg.numel())
        row = incl[j]
        cur[seg] = ((cur[seg] + row) >> 1) - row
        lo_all[seg] = j + 1
        more = j + 1 < ends[seg]
        base[j[more] + 1] = cur[seg[more]]
        marked[j[more] + 1] = True
        active = seg[more]
    src = torch.cummax(torch.where(marked, torch.arange(U, device=dev), 0), dim=0).values
    return base[src], halvings


def adaptive_k(ctx: torch.Tensor, oor: torch.Tensor, v: torch.Tensor, K: int,
               count_scaling: Optional[int]) -> Tuple[torch.Tensor, int]:
    """((L, n) k of every out-of-range sample, K - 1 elsewhere; the number of
    halvings). ``count_scaling`` None: the rows are never halved (uint32
    sums), the FLCT estimator's shortcut."""
    lane, pix = oor.nonzero(as_tuple=True)  # lane-major, raster order within
    c = ctx[lane, pix]
    key = lane * (int(ctx.max()) + 1) + c
    key, order = torch.sort(key, stable=True)
    lane, pix = lane[order], pix[order]
    ks = torch.arange(K, dtype=torch.int64, device=ctx.device)
    cost = (v[lane, pix].unsqueeze(1) >> ks) + 1 + ks
    k = torch.full(ctx.shape, K - 1, dtype=torch.int64, device=ctx.device)
    if not cost.shape[0]:
        return k, 0
    first, ends, incl = segment_prefix(key, cost)
    if count_scaling is None:
        table, halvings = (incl - cost) & MASK32, 0
    else:
        base, halvings = halved_bases(first, ends, incl, count_scaling)
        table = base + incl - cost
    k[lane, pix] = last_argmin(table)  # ties to the largest k
    return k, halvings


def raw_payload(image: np.ndarray) -> bytes:
    """Payload of an image of fewer than two pixels: per channel its pixel
    (0 when there is none) and a 0, signed 32-bit big-endian."""
    c = 3 if image.ndim == 3 else 1
    words = np.zeros((c, 2), ">i4")
    if image.size:
        words[:, 0] = planes([image], "cpu")[:, 0].numpy()
    return words.tobytes()


def encode_group(images: Sequence[np.ndarray], device,
                 count_scaling: Optional[int] = COUNT_SCALING) -> Tuple[List[bytes], int]:
    """(the FLCS containers of same-shape images of at least two pixels,
    the k-table halvings counted over them)."""
    h, w = images[0].shape[:2]
    n, depth = h * w, depth_of(images[0])
    x = planes(images, device).reshape(len(images), -1, n)  # (N, C, n)
    a, b = neighbours(h, w, device)
    va, vb = x[..., a], x[..., b]
    hi, lo = torch.maximum(va, vb), torch.minimum(va, vb)
    ctx = hi - lo
    coded = torch.arange(n, device=x.device) >= 2
    below = (x < lo) & coded
    oor = below | ((x > hi) & coded)
    v = torch.where(below, lo - x - 1, x - hi - 1)
    k, halvings = adaptive_k(ctx.reshape(-1, n), oor.reshape(-1, n), v.reshape(-1, n),
                             NUM_K[depth], count_scaling)
    facts = dict(lo=lo, ctx=ctx, below=below, oor=oor, v=v, k=k.reshape(x.shape), coded=coded)
    # a row an image, its channels back to back (one alignment an image);
    # FLCS's preamble is the first two pixels as raw signed 32-bit words
    sym = symbols(x, facts, depth)
    raw = (~coded).expand(x.shape).reshape(len(images), -1)
    sym = sym._replace(f1=torch.where(raw, x.reshape(len(images), -1) & MASK32, sym.f1),
                       n1=torch.where(raw, 32, sym.n1))
    lens, payload = pack_streams(sym)
    pos = np.concatenate([[0], np.cumsum(lens)])
    return [header(im) + payload[pos[i]: pos[i + 1]] for i, im in enumerate(images)], halvings


def encode_images(images: Sequence[np.ndarray], device,
                  count_scaling: Optional[int] = COUNT_SCALING) -> List[bytes]:
    """The FLCS container of each (H, W[, 3]) uint8/uint16 image: same-shape
    images coded together, ``BLOCK`` at a time. ``count_scaling`` None: the
    k-tables are never halved (the control)."""
    out: List[Optional[bytes]] = [None] * len(images)
    groups: Dict[Tuple, List[int]] = {}
    for i, im in enumerate(images):
        if im.shape[0] * im.shape[1] < 2:
            out[i] = header(im) + raw_payload(im)
        else:
            groups.setdefault((im.shape, im.dtype.str), []).append(i)
    for idx in groups.values():
        for s in range(0, len(idx), BLOCK):
            part = idx[s: s + BLOCK]
            blobs, _ = encode_group([images[i] for i in part], device, count_scaling)
            for i, blob in zip(part, blobs):
                out[i] = blob
    return out
