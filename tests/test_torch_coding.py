"""The port's scalar coding layer (felics_tpu_torch.coding: BitWriter,
BitReader, BitStringLogger, RiceCoder, rice_code_length, PhaseInCoder), its
KEstimator and its scalar context functions against felics_tpu's, on the
cases of tests/test_rice.py, test_phase_in.py and test_kestimator.py and on
seeded numpy sequences. Tolerance zero: bytes, decoded values, tables,
get_k and the names of the error classes are equal.
"""

import numpy as np
import pytest

from felics_tpu.coding import bitio as ref_bitio
from felics_tpu.coding import phase_in as ref_phase_in
from felics_tpu.coding import rice as ref_rice
from felics_tpu.core import context as ref_context
from felics_tpu.core import kestimator as ref_kestimator
from felics_tpu_torch import coding, errors
from felics_tpu_torch.coding import (
    BitReader, BitStringLogger, BitWriter, PhaseInCoder, RiceCoder, rice_code_length,
)
from felics_tpu_torch.core import KEstimator, context, nearest_neighbours


def _outcome(fn):
    """fn()'s value, or the name of the exception class it raised."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - the class name is the result
        return type(e).__name__


def _ops(seed, n=300):
    """A seeded sequence of bit-writer calls: (method, args)."""
    rng = np.random.default_rng(seed)
    ops = []
    for kind in rng.integers(0, 5, n):
        if kind == 0:
            ops.append(("write_bit", (int(rng.integers(0, 2)),)))
        elif kind == 1:
            nbits = int(rng.integers(0, 33))
            ops.append(("write", (nbits, int(rng.integers(0, 2**33)))))
        elif kind == 2:
            ops.append(("write_unary0", (int(rng.integers(0, 80)),)))
        elif kind == 3:
            ops.append(("write_signed32", (int(rng.integers(-(2**31), 2**31)),)))
        else:
            ops.append(("byte_align", ()))
    return ops


def _read_back(reader, ops):
    """Read what ``ops`` wrote, call by call."""
    out = []
    for name, args in ops:
        if name == "write_bit":
            out.append(reader.read_bit())
        elif name == "write":
            out.append(reader.read(args[0]))
        elif name == "write_unary0":
            out.append(reader.read_unary0())
        elif name == "write_signed32":
            out.append(reader.read_signed32())
        else:
            pad = -reader.bit_position % 8
            out.append(reader.read(pad))
    return out


def test_exports_are_the_references():
    from felics_tpu import coding as ref_coding
    from felics_tpu import core as ref_core

    from felics_tpu_torch import core

    assert coding.__all__ == ref_coding.__all__
    assert core.__all__ == ref_core.__all__


@pytest.mark.parametrize("seed", range(4))
def test_bit_writer_and_reader_match_reference(seed):
    ops = _ops(seed)
    port, ref = BitWriter(), ref_bitio.BitWriter()
    for name, args in ops:
        getattr(port, name)(*args)
        getattr(ref, name)(*args)
        assert port.bit_length == ref.bit_length
    port.byte_align()
    ref.byte_align()
    data = port.getvalue()
    assert data == ref.getvalue()
    got = _read_back(BitReader(data), ops)
    assert got == _read_back(ref_bitio.BitReader(data), ops)


@pytest.mark.parametrize("seed", range(2))
def test_bit_string_logger_matches_reference(seed):
    port, ref = BitStringLogger(), ref_bitio.BitStringLogger()
    for name, args in _ops(seed + 10, 120):
        if name == "byte_align":
            continue
        getattr(port, name)(*args)
        getattr(ref, name)(*args)
    assert port.content() == ref.content()


def test_unaligned_getvalue_raises_value_error():
    for writer in (BitWriter(), ref_bitio.BitWriter()):
        writer.write(3, 5)
        with pytest.raises(ValueError, match="byte-aligned"):
            writer.getvalue()


@pytest.mark.parametrize("call", ["read_bit", "read", "read_unary0", "read_signed32"])
def test_read_past_the_end_raises_io_error(call):
    data = b"\xff\xff\xff"
    args = {"read": (25,)}.get(call, ())

    def run(reader_cls):
        reader = reader_cls(data, start_bit=20 if call == "read_signed32" else 0)
        if call == "read_bit":
            reader.read(24)
        return getattr(reader, call)(*args)

    assert _outcome(lambda: run(BitReader)) == "IoError"
    assert _outcome(lambda: run(ref_bitio.BitReader)) == "IoError"
    with pytest.raises(errors.IoError):
        run(BitReader)


# Rice: tests/test_rice.py's goldens (MSB-first stream order).
@pytest.mark.parametrize("k,value,bits", [(4, 7, "00111"), (0, 12, "1111111111110"),
                                          (3, 10, "10010")])
def test_rice_golden(k, value, bits):
    port, ref = BitStringLogger(), ref_bitio.BitStringLogger()
    RiceCoder(k).encode(port, value)
    ref_rice.RiceCoder(k).encode(ref, value)
    assert port.content() == ref.content() == bits


@pytest.mark.parametrize("k", [-1, 32])
def test_rice_k_out_of_range(k):
    with pytest.raises(ValueError):
        RiceCoder(k)
    with pytest.raises(ValueError):
        ref_rice.RiceCoder(k)


@pytest.mark.parametrize("k", [0, 3, 8, 14])
def test_rice_round_trip_matches_reference(k):
    rng = np.random.default_rng(k)
    values = [int(v) for v in rng.integers(0, 2 * 65536 if k >= 8 else 2000, 1500)]
    port, ref = BitWriter(), ref_bitio.BitWriter()
    for v in values:
        RiceCoder(k).encode(port, v)
        ref_rice.RiceCoder(k).encode(ref, v)
    port.byte_align()
    ref.byte_align()
    data = port.getvalue()
    assert data == ref.getvalue()
    reader = BitReader(data)
    assert [RiceCoder(k).decode(reader) for _ in values] == values


@pytest.mark.parametrize("k", [0, 1, 5, 13, 31])
def test_rice_code_length_matches_encoding(k):
    for number in range(0, 3000, 7):
        logger = BitStringLogger()
        RiceCoder(k).encode(logger, number)
        assert len(logger.content()) == rice_code_length(number, k)
        assert rice_code_length(number, k) == ref_rice.rice_code_length(number, k)
        assert RiceCoder(k).code_length(number) == rice_code_length(number, k)


def test_rice_long_unary():
    writer = BitWriter()
    RiceCoder(0).encode(writer, 70000)
    writer.byte_align()
    assert RiceCoder(0).decode(BitReader(writer.getvalue())) == 70000


def test_rice_quotient_past_u32_raises_value_overflow():
    # k = 31, quotient 2: 2 * 2^31 does not fit u32.
    writer = BitWriter()
    writer.write_unary0(2)
    writer.write(31, 0)
    writer.byte_align()
    data = writer.getvalue()
    assert _outcome(lambda: RiceCoder(31).decode(BitReader(data))) == "ValueOverflow"
    assert _outcome(lambda: ref_rice.RiceCoder(31).decode(ref_bitio.BitReader(data))) == \
        "ValueOverflow"


# Phase-in: tests/test_phase_in.py's cases.
@pytest.mark.parametrize("n,m,left_p,right_p", [(1, 0, 0, 1), (7, 2, 3, 1), (15, 3, 7, 1),
                                                (32, 5, 0, 32)])
def test_phase_in_constructor_internals(n, m, left_p, right_p):
    coder = PhaseInCoder(n)
    assert (coder.n, coder.m, coder.left_p, coder.right_p) == (n, m, left_p, right_p)


@pytest.mark.parametrize("n", [0, -3, 1 << 31])
def test_phase_in_invalid_n(n):
    with pytest.raises(ValueError):
        PhaseInCoder(n)
    with pytest.raises(ValueError):
        ref_phase_in.PhaseInCoder(n)


def test_phase_in_out_of_range_value():
    with pytest.raises(ValueError):
        PhaseInCoder(15).encode(BitWriter(), 15)


@pytest.mark.parametrize("n", [7, 8, 9, 15, 16, 17, 100, 511, 1000])
def test_phase_in_code_tables_match_reference(n):
    for v in range(n):
        port, ref = BitStringLogger(), ref_bitio.BitStringLogger()
        PhaseInCoder(n).encode(port, v)
        ref_phase_in.PhaseInCoder(n).encode(ref, v)
        assert port.content() == ref.content()
        assert len(port.content()) == PhaseInCoder(n).code_length(v)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 9, 100, 511, 1000, 131071])
def test_phase_in_round_trip_matches_reference(n):
    rng = np.random.default_rng(n)
    domain = [int(v) for v in rng.integers(0, n, 600)]
    port, ref = BitWriter(), ref_bitio.BitWriter()
    for v in domain:
        PhaseInCoder(n).encode(port, v)
        ref_phase_in.PhaseInCoder(n).encode(ref, v)
    port.byte_align()
    ref.byte_align()
    data = port.getvalue()
    assert data == ref.getvalue()
    reader = BitReader(data)
    assert [PhaseInCoder(n).decode(reader) for _ in domain] == domain


def test_phase_in_out_of_domain_codeword_raises_invalid_value():
    """Every codeword of a well-formed coder is in its domain; a coder whose
    domain was cut after construction meets one past it."""
    def cut(cls):
        coder = cls(7)  # m = 2, left_p = 3, right_p = 1
        coder.n = 5
        return coder

    data = b"\xe0"  # '11' then '1': number 6
    assert _outcome(lambda: cut(PhaseInCoder).decode(BitReader(data))) == "InvalidValue"
    assert _outcome(lambda: cut(ref_phase_in.PhaseInCoder).decode(
        ref_bitio.BitReader(data))) == "InvalidValue"


def test_phase_in_n_one_zero_length_code():
    logger = BitStringLogger()
    PhaseInCoder(1).encode(logger, 0)
    assert logger.content() == ""
    assert PhaseInCoder(1).decode(BitReader(b"")) == 0


# KEstimator: tests/test_kestimator.py's cases, on both classes.
ESTIMATORS = [KEstimator, ref_kestimator.KEstimator]


@pytest.mark.parametrize("cls", ESTIMATORS, ids=["port", "reference"])
def test_kestimator_context_map_contents(cls):
    k_values = [0, 1, 2, 4, 8, 16]
    est = cls(300, k_values, None)
    updates = {
        100: [4, 8, 13, 45, 85],
        80: [7, 800, 1000, 1273, 85],
        75: [7, 13, 1000, 200, 85],
        255: [1, 4, 142, 563, 1246, 2464],
        0: [0, 100, 3],
    }
    for ctx, values in updates.items():
        for v in values:
            est.update(ctx, v)
    for ctx, values in updates.items():
        for i, k in enumerate(k_values):
            assert est.table[ctx][i] == sum(rice_code_length(v, k) for v in values)


def test_kestimator_get_k():
    est = KEstimator(400, [0, 1, 2, 4, 5, 16], None)
    for v in (10, 40, 5):
        est.update(100, v)
    assert est.get_k(100) == 4
    for v in (1000, 200, 1250, 300):
        est.update(255, v)
    assert est.get_k(255) == 16


def test_kestimator_ties_pick_largest_k():
    assert KEstimator(10, [0, 1, 2, 3], None).get_k(5) == 3


def test_kestimator_empty_k_values():
    with pytest.raises(ValueError):
        KEstimator(100, [], None)


def test_kestimator_periodic_count_scaling():
    est = KEstimator(120, [0, 1, 2], 1024)
    for v in (400, 531, 2000, 1733):
        est.update(43, v)
    assert list(est.table[43]) == [2334, 1169, 588]


def test_kestimator_halving_strictly_greater():
    est = KEstimator(5, [0], 10)
    est.update(0, 9)
    assert est.table[0][0] == 10
    est.update(0, 0)
    assert est.table[0][0] == 5


@pytest.mark.parametrize("halve_at,with_prior", [(None, False), (1024, False), (300, False),
                                                 (None, True)],
                         ids=["no scaling", "1024", "300", "prior"])
def test_kestimator_sequences_match_reference(halve_at, with_prior):
    rng = np.random.default_rng(7)
    k_values = list(range(6))
    prior = rng.integers(0, 200, (6, 6)) if with_prior else None
    port = KEstimator(40, k_values, halve_at, prior)
    ref = ref_kestimator.KEstimator(40, k_values, halve_at, prior)
    for ctx, v in zip(rng.integers(0, 41, 2000), rng.integers(0, 3000, 2000)):
        ctx, v = int(ctx), int(v)
        assert port.get_k(ctx) == ref.get_k(ctx)
        port.update(ctx, v)
        ref.update(ctx, v)
    assert np.array_equal(port.table, ref.table)


@pytest.mark.parametrize("width", [1, 2, 3, 17])
def test_nearest_neighbours_match_reference(width):
    n = width * 6
    got = [nearest_neighbours(i, width) for i in range(n)]
    assert got == [ref_context.nearest_neighbours(i, width) for i in range(n)]
    a, b = context.neighbour_indices(6, width)
    for i in range(2, n):
        assert got[i] == (a[i], b[i])


def test_context_of_matches_reference():
    rng = np.random.default_rng(3)
    v1, v2 = rng.integers(0, 65536, 500), rng.integers(0, 65536, 500)
    for got, want in zip(context.context_of(v1, v2), ref_context.context_of(v1, v2)):
        assert np.array_equal(got, want)
    assert context.context_of(9, 4) == (4, 9, 5)
