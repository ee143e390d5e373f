"""Bit I/O and the scalar entropy coders of the port.

Counterpart: felics_tpu/coding/ (reference: src/coding/ over the
``bitstream-io`` crate's big-endian bit writer and reader). Each coder
writes and reads one codeword at a time against ``BitWriter`` /
``BitReader``: this is the sequential form the oracle codec
(``felics_tpu_torch.core.oracle``) is built from. The device codecs
materialise codewords in parallel instead (``ops/``, ``csrc/``).
"""

from felics_tpu_torch.coding.bitio import BitReader, BitStringLogger, BitWriter
from felics_tpu_torch.coding.phase_in import PhaseInCoder
from felics_tpu_torch.coding.rice import RiceCoder, rice_code_length

__all__ = [
    "BitWriter",
    "BitReader",
    "BitStringLogger",
    "RiceCoder",
    "rice_code_length",
    "PhaseInCoder",
]
