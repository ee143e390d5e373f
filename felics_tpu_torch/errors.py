"""Decompression errors of the port.

Counterpart: felics_tpu/errors.py, with the same class names and the same
hierarchy (reference: src/compression/error.rs:4-25), so a caller matches a
failure mode by name whichever package decoded. Every malformed input the
port decodes raises a ``DecompressionError``.
"""


class DecompressionError(Exception):
    """Base class for all decompression failures."""


class IoError(DecompressionError):
    """The underlying stream ended prematurely or could not be read."""


class InvalidValue(DecompressionError):
    """A decoded value does not fit the image bit-depth."""


class ValueOverflow(DecompressionError):
    """An overflow occurred during arithmetic on decoded values."""


class InvalidDimensions(DecompressionError):
    """The channel dimensions are invalid."""


class InvalidColorType(DecompressionError):
    """The file declares a color type we do not support."""


class InvalidPixelDepth(DecompressionError):
    """The file declares a pixel depth we do not support."""


class InvalidSignature(DecompressionError):
    """The file signature does not match a felics file."""
