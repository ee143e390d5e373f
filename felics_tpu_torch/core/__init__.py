"""Codec core of the port: the context model, the k-estimator, the color
transform, and the channel codecs.

Counterpart: felics_tpu/core/ (reference: the private functions of
src/compression.rs and src/compression/{misc,parameter_selection,
color_transform}.rs). Two codecs live here:

  * ``oracle`` — the sequential, bit-exact scalar codec (numpy and Python
    ints). Slow; the independent check of everything else.
  * ``codec``  — the FLCS single-stream codec on PyTorch: encode, the scan
    decoder (K4 on the card) and containers.
"""

from felics_tpu_torch.core.color import rgb_to_ycocg, ycocg_to_rgb
from felics_tpu_torch.core.context import nearest_neighbours, neighbour_indices
from felics_tpu_torch.core.kestimator import KEstimator

__all__ = [
    "nearest_neighbours",
    "neighbour_indices",
    "KEstimator",
    "rgb_to_ycocg",
    "ycocg_to_rgb",
]
