"""The comparison that decides ``correct``: a sample of the window's calls
against the plain reference of the configuration's container
(``containers/<container>.reference``: ``reference/flct_ref.py``,
``reference/flcs_ref.py``).

Ingest: every sampled container must equal, byte for byte, the one the
reference encodes from the same image. Serve: the sampled calls' containers
(made by the code under test at set-up) must equal the reference's of
their images, and every decoded sample must equal the image's: both
containers are lossless, so the reference's decode of its own container
is the image itself. A missing or failed output counts in full (every byte or sample).
Each number is exact and its limit is 0.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

LIMITS = {"bad_containers": 0, "bad_samples": 0}


def compare(direction: str, sample: Sequence, pool: Sequence[np.ndarray],
            reference: Callable[[List[int]], List[bytes]],
            containers: Optional[List[bytes]]) -> Dict:
    """{name: {"value", "limit"}} of each number compared, and how many
    containers and images it covered; ``reference(indices)`` gives the
    reference's containers of pool indices."""
    wanted = sorted({i for items, _ in sample for i in items})
    ref = dict(zip(wanted, reference(wanted)))
    bad_containers = bad_samples = images = 0
    if direction == "encode":
        for items, out in sample:
            ok = isinstance(out, list) and len(out) == len(items)
            for n, i in enumerate(items):
                images += 1
                bad_containers += not (ok and out[n] == ref[i])
    else:
        for i in wanted:
            bad_containers += containers[i] != ref[i]
        for items, out in sample:
            ok = isinstance(out, list) and len(out) == len(items)
            for n, i in enumerate(items):
                images += 1
                want = pool[i]
                got = out[n] if ok else None
                if got is None or got.shape != want.shape or got.dtype != want.dtype:
                    bad_samples += want.size
                else:
                    bad_samples += int(np.count_nonzero(got != want))
    out = {"images_compared": {"value": images, "limit": None}}
    out["bad_containers"] = {"value": int(bad_containers), "limit": LIMITS["bad_containers"]}
    if direction == "decode":
        out["bad_samples"] = {"value": int(bad_samples), "limit": LIMITS["bad_samples"]}
    return out


def correct(checks: Dict) -> bool:
    """Every number within its limit, over at least one image."""
    return checks["images_compared"]["value"] > 0 and all(
        c["value"] <= c["limit"] for c in checks.values() if c["limit"] is not None)


def lines(checks: Dict) -> List[str]:
    """One line a number: its name, value and limit."""
    return [f"check {name} {c['value']} limit {c['limit']}" for name, c in checks.items()]
