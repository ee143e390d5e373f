"""Coding configuration of the port.

Counterpart: felics_tpu/config.py (reference: src/compression/traits.rs:7-43).
The constants must match the reference bit-exactly for FLCS interop:

  8-bit:  K_VALUES = 0..=5,  MAX_CONTEXT = 510,    COUNT_SCALING = 1024
  16-bit: K_VALUES = 0..=14, MAX_CONTEXT = 131070, COUNT_SCALING = 1024
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

from felics_tpu_torch.format import PixelDepth


@dataclass(frozen=True)
class CodingConfig:
    """Everything the channel codec needs to know, independent of image size."""

    pixel_depth: PixelDepth
    k_values: Tuple[int, ...]
    max_context: int
    # Halve all cumulative code lengths in a context when the smallest exceeds
    # this (strictly '>', reference: src/compression/parameter_selection.rs:58-63).
    count_scaling: Optional[int] = 1024

    @property
    def num_k(self) -> int:
        return len(self.k_values)

    @property
    def depth_bits(self) -> int:
        return self.pixel_depth.bits

    @property
    def max_phase_in_bits(self) -> int:
        # phase-in over n = context + 1 <= max_context + 1: at most m + 1
        # bits, m = floor(log2(n)).
        n = self.max_context + 1
        return n.bit_length() - 1 + 1


# FLCT context-bucket cap: the tiled k-estimator is indexed by
# min(bit_length(context), QCTX_CAP). A format-level constant shared with
# every FLCT codec (docs/FORMATS.md).
QCTX_CAP = 5

CONFIG_8BIT = CodingConfig(
    pixel_depth=PixelDepth.EIGHT,
    k_values=tuple(range(6)),
    max_context=510,
    count_scaling=1024,
)

CONFIG_16BIT = CodingConfig(
    pixel_depth=PixelDepth.SIXTEEN,
    k_values=tuple(range(15)),
    max_context=131070,
    count_scaling=1024,
)


def config_for_depth(depth: PixelDepth) -> CodingConfig:
    return CONFIG_8BIT if depth == PixelDepth.EIGHT else CONFIG_16BIT


_TILED_CONFIGS = {
    depth: replace(config_for_depth(depth), count_scaling=None) for depth in PixelDepth
}


def tiled_config_for_depth(depth: PixelDepth) -> CodingConfig:
    """FLCT coding parameters: the FLCS ones without count scaling (tiles
    restart the estimator, so the k-tables are plain prefix sums); one
    instance a depth, made at import."""
    return _TILED_CONFIGS[depth]


@dataclass(frozen=True)
class TileConfig:
    """FLCT tile geometry: each tile is an independent bitstream."""

    tile_h: int = 64
    tile_w: int = 64

    def grid(self, height: int, width: int) -> Tuple[int, int]:
        """(tile rows, tile columns) of a height x width image; 0 along a
        zero dimension."""
        th = -(-height // self.tile_h) if height else 0
        tw = -(-width // self.tile_w) if width else 0
        return th, tw
