"""The controls: the reference in the place of the code under test, with
one guarantee of the configuration broken, each the step a later change
could be tempted to take. A sound comparison reads them as not correct.
Each container's module (``containers/<container>.py``) picks its own.

* FLCT ingest: the k-prior pass skipped (the device chain's largest step):
  every k-table starts at zero and the container is written as v0. It
  still decodes, but its bytes are no longer the FLCT v2 bytes the
  configuration promises;
* FLCS ingest: the k-tables never halved (``flcs_ref.encode_images`` with
  ``count_scaling=None``), the shortcut FLCT's estimator takes; the bytes
  are no longer those ``dfelics`` expects;
* serve: the image with the least significant bit of every sample dropped,
  what a near-lossless coding one bit coarser hands back.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from h100_bench.reference import flct_ref


def v0_encode(images: Sequence[np.ndarray], tile, device) -> List[bytes]:
    """FLCT containers without the k-prior (v0)."""
    return [flct_ref.encode_image(im, tile, device, v0=True) for im in images]


def lossy_decode(images: Sequence[np.ndarray]) -> List[np.ndarray]:
    """The images with the lowest bit of every sample cleared."""
    return [im & ~np.array(1, im.dtype) for im in images]

