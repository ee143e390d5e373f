"""State that crosses between the JAX reference and the port.

The codec has no weights. What the two packages share is the container
bytes, the FLCT k-table seed and the FLCS codeword symbols; this module
turns the reference's numpy forms of the last two into the port's device
tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from felics_tpu_torch.device import resolve_device
from felics_tpu_torch.ops.analysis import Symbols


def prior_from_reference(prior_np: np.ndarray, n_tiles: int, device="cuda"):
    """The reference's (C, nb, K) or (n_tiles, C, nb, K) int32 k-table seed
    (felics_tpu.parallel.tiling.prior_from_k0, or a stack of them indexed
    per tile) as the port's per-tile (n_tiles, C, nb, K) int32 tensor."""
    prior = np.asarray(prior_np)
    if prior.ndim == 3:
        prior = np.broadcast_to(prior[None], (n_tiles,) + prior.shape)
    if prior.ndim != 4 or prior.shape[0] != n_tiles:
        raise ValueError(
            f"prior shape {prior.shape} is neither (C, nb, K) nor "
            f"({n_tiles}, C, nb, K)"
        )
    if not np.array_equal(prior, prior.astype(np.int32)):
        raise ValueError("prior values do not fit int32")
    host = torch.from_numpy(np.ascontiguousarray(prior, dtype=np.int32))
    return host.to(resolve_device(device))


def symbols_from_reference(symbols, device="cuda") -> Symbols:
    """The reference's FLCS ``Symbols`` (felics_tpu.ops.analysis; fields
    as numpy arrays, uint32 values and int32 lengths, any shape) as the
    port's int64 ``Symbols`` on ``device``."""
    dev = resolve_device(device)
    return Symbols(*(
        torch.from_numpy(np.asarray(f).astype(np.int64)).to(dev) for f in symbols
    ))
