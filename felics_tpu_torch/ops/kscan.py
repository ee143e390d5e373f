"""Adaptive Rice k per pixel of the FLCS encoder: kernel K3 and its plain
version.

Counterpart: felics_tpu/ops/kscan.py. The k used at an out-of-range pixel
depends on every earlier out-of-range residual of the same context, and
contexts evolve independently. So each lane's out-of-range pixels are
stable-sorted by context (raster order is kept within a context), and:

* ``kscan_ref`` (plain version, the CPU path) walks ranks: step r advances
  every (lane, context) table by its r-th update at once;
* ``kscan`` launches ``csrc/flcs_kscan.cu`` on CUDA tensors over the
  residuals gathered into sorted order: the thread of each segment's first
  slot walks the segment in order with the table in registers, and k is
  scattered back to raster order.

Both emit the k chosen BEFORE each update (the last index of the row's
minimum), add the Rice length row ``(v >> k) + 1 + k`` and halve the row
when its minimum exceeds ``count_scaling``. Pixels that are not out of
range get the largest k. The reference's (contexts x ranks) queue matrix,
its padding buckets and lane budget are XLA shape devices and have no
counterpart here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from felics_tpu_torch.config import CodingConfig
from felics_tpu_torch.ops import _build
from felics_tpu_torch.ops.bits import k_select

# Kernel launches made by ``kscan`` (plain-version calls are not counted).
# Callers reset it to 0 to see what a run launched.
LAUNCHES = 0

_BIG = 0x7FFFFFFF
_MAX_K = 15


class SortedUpdates(NamedTuple):
    order: torch.Tensor  # (G, n) int64 stable order of (oor ? context : BIG)
    compact: torch.Tensor  # (G, n) compact context id per sorted slot
    rank: torch.Tensor  # (G, n) rank within its context per sorted slot
    num_oor: torch.Tensor  # (G,) out-of-range pixels per lane
    num_contexts: torch.Tensor  # (G,) distinct contexts among them
    max_rank: torch.Tensor  # (G,) most updates in one context


def sort_updates(context: torch.Tensor, oor: torch.Tensor) -> SortedUpdates:
    """Per-lane stable sort of the out-of-range pixels by context, with
    segment ids and ranks."""
    G, n = context.shape
    key = torch.where(oor, context.to(torch.int64), _BIG)
    sorted_key, order = torch.sort(key, dim=1, stable=True)
    valid = sorted_key != _BIG
    prev = torch.cat(
        [torch.full((G, 1), -1, dtype=torch.int64, device=key.device),
         sorted_key[:, :-1]], dim=1,
    )
    is_start = (sorted_key != prev) & valid
    compact = torch.cumsum(is_start, dim=1) - 1
    idx = torch.arange(n, device=key.device).expand(G, n)
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=1).values
    rank = idx - seg_start
    return SortedUpdates(
        order, compact, rank, valid.sum(1), is_start.sum(1),
        torch.where(valid, rank, -1).max(dim=1).values + 1,
    )


def kscan_ref(
    residual: torch.Tensor, su: SortedUpdates, cfg: CodingConfig
) -> torch.Tensor:
    """Plain version: (G, n) k per pixel (int64), rank by rank."""
    G, n = residual.shape
    dev = residual.device
    kv = torch.tensor(cfg.k_values, dtype=torch.int64, device=dev)
    ks = torch.arange(cfg.num_k, device=dev)
    valid = torch.arange(n, device=dev) < su.num_oor.unsqueeze(1)
    values = residual.to(torch.int64).gather(1, su.order).reshape(-1)
    compact = su.compact.reshape(-1)
    # Valid slots grouped by rank: every (lane, context) appears at most
    # once per rank, so each step's gather and scatter never collide.
    rank_key = torch.where(valid, su.rank, _BIG).reshape(-1)
    by_rank = torch.sort(rank_key, stable=True).indices
    counts = torch.bincount(su.rank[valid], minlength=1).tolist()
    table = torch.zeros(
        (G, max(int(su.num_contexts.max()), 1), cfg.num_k),
        dtype=torch.int64, device=dev,
    )
    k_sorted = torch.zeros(G * n, dtype=torch.int64, device=dev)
    start = 0
    for count in counts:
        slot = by_rank[start : start + count]
        start += count
        lane, ctx = slot // n, compact[slot]
        row = table[lane, ctx]
        k_sorted[slot] = kv[k_select(row, ks)]
        row = row + (values[slot].unsqueeze(1) >> kv) + 1 + kv
        if cfg.count_scaling is not None:
            halve = row.min(dim=1, keepdim=True).values > cfg.count_scaling
            row = torch.where(halve, row >> 1, row)
        table[lane, ctx] = row
    k_pix = torch.full((G * n,), cfg.k_values[-1], dtype=torch.int64, device=dev)
    pixel = (torch.arange(G, device=dev).unsqueeze(1) * n + su.order)[valid]
    k_pix[pixel] = k_sorted[valid.reshape(-1)]
    return k_pix.reshape(G, n)


def check_cfg(cfg: CodingConfig) -> int:
    K = cfg.num_k
    if list(cfg.k_values) != list(range(K)) or K > _MAX_K:
        raise ValueError("the FLCS kernels take k values 0..K-1, K <= 15")
    return K


def kscan(
    residual: torch.Tensor, su: SortedUpdates, cfg: CodingConfig
) -> torch.Tensor:
    """(G, n) k per pixel. CUDA tensors launch flcs_kscan.cu (int32 out);
    CPU tensors run ``kscan_ref``."""
    global LAUNCHES
    if residual.dim() != 2:
        raise ValueError("residual must be a (G, n) tensor")
    G, n = residual.shape
    K = check_cfg(cfg)
    if residual.device.type == "cpu":
        return kscan_ref(residual, su, cfg)
    if residual.device.type != "cuda":
        raise ValueError(f"unsupported device {residual.device}")
    _build.check_kernel_k(K)
    dev = residual.device
    # The kernel reads each segment as a contiguous run and writes k in
    # sorted order; slots that are not out of range keep the largest k.
    k_sorted = torch.full((G, n), K - 1, dtype=torch.int32, device=dev)
    if G * n == 0:
        return k_sorted
    res_sorted = residual.to(torch.int32).gather(1, su.order).contiguous()
    rank = su.rank.to(torch.int64).contiguous()
    num_oor = su.num_oor.to(torch.int64).contiguous()
    cs = -1 if cfg.count_scaling is None else int(cfg.count_scaling)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.flcs_kscan(
            res_sorted.data_ptr(), rank.data_ptr(), num_oor.data_ptr(),
            k_sorted.data_ptr(), G, n, K, cs,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "flcs_kscan")
    LAUNCHES += 1
    return torch.empty_like(k_sorted).scatter_(1, su.order, k_sorted)


def compute_k(
    context: torch.Tensor, oor: torch.Tensor, residual: torch.Tensor,
    cfg: CodingConfig,
) -> torch.Tensor:
    """Sort, then scan; every lane without an out-of-range pixel gets the
    largest k, and a group with none skips the scan."""
    su = sort_updates(context, oor)
    if int(su.num_oor.max()) == 0:
        return torch.full(
            context.shape, cfg.k_values[-1], dtype=torch.int64,
            device=context.device,
        )
    return kscan(residual, su, cfg)
