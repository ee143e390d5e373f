"""MSB-first (big-endian) bit I/O.

Counterpart: felics_tpu/coding/bitio.py. The semantics of the
``bitstream-io`` crate's ``BitWriter<W, BigEndian>`` /
``BitReader<R, BigEndian>`` as the reference uses them
(src/compression.rs:270,296,358,385): bits fill each byte from the most
significant bit down, a multi-bit write emits the value's bits MSB-first,
``write_signed32`` emits the 32-bit two's complement pattern, and
``byte_align`` pads the current byte with zero bits.

``BitStringLogger`` records written bits as a '0'/'1' string in stream
order, for tests of the coders.
"""

from __future__ import annotations

from felics_tpu_torch import errors


class BitWriter:
    """Accumulates bits MSB-first into a bytearray."""

    __slots__ = ("_buf", "_acc", "_nbits")

    def __init__(self) -> None:
        self._buf = bytearray()
        self._acc = 0  # bit accumulator, MSB side = oldest
        self._nbits = 0  # number of bits currently in _acc

    def write_bit(self, bit: int) -> None:
        self._acc = (self._acc << 1) | (bit & 1)
        self._nbits += 1
        if self._nbits == 8:
            self._buf.append(self._acc)
            self._acc = 0
            self._nbits = 0

    def write(self, nbits: int, value: int) -> None:
        """Write the low ``nbits`` bits of ``value``, MSB-first."""
        if nbits == 0:
            return
        value &= (1 << nbits) - 1
        self._acc = (self._acc << nbits) | value
        self._nbits += nbits
        while self._nbits >= 8:
            self._nbits -= 8
            self._buf.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def write_unary0(self, value: int) -> None:
        """``value`` one-bits, then a terminating zero bit (reference golden:
        src/coding/rice_coding.rs:76-77, k=0, v=12 -> ``1111111111110``)."""
        while value >= 32:
            self.write(32, 0xFFFFFFFF)
            value -= 32
        self.write(value + 1, ((1 << value) - 1) << 1)

    def write_signed32(self, value: int) -> None:
        self.write(32, value & 0xFFFFFFFF)

    def byte_align(self) -> None:
        if self._nbits:
            self.write(8 - self._nbits, 0)

    @property
    def bit_length(self) -> int:
        return len(self._buf) * 8 + self._nbits

    def getvalue(self) -> bytes:
        """The written bytes; the stream must be byte-aligned."""
        if self._nbits:
            raise ValueError("stream not byte-aligned; call byte_align()")
        return bytes(self._buf)


class BitReader:
    """Reads bits MSB-first from a bytes-like object."""

    __slots__ = ("_data", "_pos", "_bitlen")

    def __init__(self, data: bytes, start_bit: int = 0) -> None:
        self._data = data
        self._pos = start_bit
        self._bitlen = len(data) * 8

    @property
    def bit_position(self) -> int:
        return self._pos

    def read_bit(self) -> int:
        if self._pos >= self._bitlen:
            raise errors.IoError("unexpected end of bitstream")
        byte = self._data[self._pos >> 3]
        bit = (byte >> (7 - (self._pos & 7))) & 1
        self._pos += 1
        return bit

    def read(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        if self._pos + nbits > self._bitlen:
            raise errors.IoError("unexpected end of bitstream")
        result = 0
        pos = self._pos
        data = self._data
        remaining = nbits
        while remaining > 0:
            bit_off = pos & 7
            take = min(8 - bit_off, remaining)
            chunk = (data[pos >> 3] >> (8 - bit_off - take)) & ((1 << take) - 1)
            result = (result << take) | chunk
            pos += take
            remaining -= take
        self._pos = pos
        return result

    def read_unary0(self) -> int:
        count = 0
        while self.read_bit():
            count += 1
        return count

    def read_signed32(self) -> int:
        raw = self.read(32)
        return raw - (1 << 32) if raw & (1 << 31) else raw


class BitStringLogger:
    """Records written bits as a '0'/'1' string in stream order."""

    __slots__ = ("_bits",)

    def __init__(self) -> None:
        self._bits = []

    def write_bit(self, bit: int) -> None:
        self._bits.append("1" if bit & 1 else "0")

    def write(self, nbits: int, value: int) -> None:
        for shift in range(nbits - 1, -1, -1):
            self.write_bit((value >> shift) & 1)

    def write_unary0(self, value: int) -> None:
        self._bits.append("1" * value)
        self._bits.append("0")

    def write_signed32(self, value: int) -> None:
        self.write(32, value & 0xFFFFFFFF)

    def content(self) -> str:
        return "".join(self._bits)
