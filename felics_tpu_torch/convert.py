"""State that crosses between the JAX reference and the port.

The codec has no weights. What the two packages share is the FLCT bytes
and the k-table seed; this module turns the reference's numpy seed into
the port's device tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from felics_tpu_torch.device import resolve_device


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
