"""Decode's host stage on the CPU: each container's bytes are read once.

The stage (``batch._read_members``, ``tiling.decode_plan``,
``tiling.fill_containers``) reads each header in place, hands each payload
on as a view of its container, and writes the group's length table,
priors and payloads into the chain's input with one copy of each payload.
These cases hold the input it fills to the layout built here member by
member (``read_tiled_header``, one ``prior_from_k0`` a header, the payload
sliced out of its container), keep its checks and their order, and decode
``bytes``, ``bytearray`` and ``memoryview`` containers alike. Tolerance
zero: bytes and pixels.
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

from felics_tpu_torch import errors
from felics_tpu_torch.config import tiled_config_for_depth
from felics_tpu_torch.format import PixelDepth, header_for_array
from felics_tpu_torch.parallel import batch, flct, tiling

CPU = torch.device("cpu")
# The plain versions run many tiny ops: intra-op threads only contend with
# the other test workers.
torch.set_num_threads(1)


def _image(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    hi = np.iinfo(dtype).max
    img = np.cumsum(np.cumsum(rng.integers(-6, 7, shape), 0), 1) + hi // 2
    return np.clip(img, 0, hi).astype(dtype)


# name -> (tile, [(image shape, k_prior)]): one geometry group each; no
# image is smaller than its tile.
GROUPS = {
    "gray8 t64 same shape": ((64, 64), [((70, 130), True)] * 3),
    "gray8 t64 mixed shapes": ((64, 64), [((70, 130), True), ((129, 64), True)]),
    "rgb8 t32 same shape": ((32, 32), [((40, 70, 3), True)] * 2),
    "rgb8 t32 mixed shapes": ((32, 32), [((40, 70, 3), True), ((33, 32, 3), True)]),
    "gray16 t32 same shape": ((32, 32), [((50, 40), True)] * 4),
    "gray16 t32 mixed shapes": ((32, 32), [((50, 40), True), ((64, 65), True)]),
    "gray8 t64 v0 and v2": ((64, 64), [((70, 130), False), ((70, 130), True),
                                       ((70, 130), False)]),
    "rgb8 t32 v0 and v2 mixed shapes": ((32, 32), [((40, 70, 3), True),
                                                   ((33, 32, 3), False)]),
    # small tiles for the cases about checks and bytes-likes: the plain
    # decode's steps grow with the tile's pixels
    "gray8 t8 v0 and v2 mixed shapes": ((8, 8), [((24, 24), True), ((17, 30), False),
                                                 ((24, 24), True)]),
}


@lru_cache(maxsize=None)
def _containers(name):
    """(images, containers) of a group: the v2 members encoded in one
    pass, the v0 members in another (the per-image call's bytes)."""
    (th, tw), members = GROUPS[name]
    dtype = np.uint16 if name.startswith("gray16") else np.uint8
    images = [_image(100 + i, shape, dtype) for i, (shape, _) in enumerate(members)]
    blobs = [None] * len(images)
    for k_prior in (True, False):
        idx = [i for i, (_, k) in enumerate(members) if k == k_prior]
        if idx:
            ims = [images[i] for i in idx]
            p = tiling.encode_dispatch(ims, [header_for_array(im) for im in ims], th, tw,
                                       k_prior, CPU)
            for i, blob in zip(idx, tiling.encode_finish(p)):
                blobs[i] = blob
    return images, blobs


def _member_layout(blobs):
    """The decode input's bytes up to the payload's end, built member by
    member: the int64 length tables joined, one ``prior_from_k0`` a
    header, the payloads sliced out of their containers."""
    headers = [flct.read_tiled_header(b) for b in blobs]
    cfg = tiled_config_for_depth(headers[0].pixel_depth)
    lens = np.concatenate([hd.tile_lengths for hd in headers]).astype(np.int64)
    priors = np.stack([flct.prior_from_k0(hd.k0, cfg, hd.num_channels)
                       for hd in headers]).astype(np.int32)
    payloads = [b[hd.payload_off : hd.payload_off + int(hd.tile_lengths.sum())]
                for b, hd in zip(blobs, headers)]
    return lens.tobytes() + priors.tobytes() + b"".join(payloads)


@pytest.fixture
def fills(monkeypatch):
    """Every ``fill_containers`` call of the decode: (its ``lens``
    argument, its payloads, the input's bytes it wrote)."""
    seen = []
    real = tiling.fill_containers

    def spy(host, plan, headers, lens, payloads):
        real(host, plan, headers, lens, payloads)
        seen.append((lens, list(payloads), bytes(host[: plan.offsets()[1] + sum(
            len(p) for p in payloads)])))

    monkeypatch.setattr(tiling, "fill_containers", spy)
    return seen


def _shares(view, data) -> bool:
    return np.shares_memory(np.frombuffer(view, np.uint8), np.frombuffer(data, np.uint8))


@pytest.mark.parametrize("name", list(GROUPS))
def test_filled_input_is_the_member_by_member_layout(name, fills):
    """The batched decode fills one input a group, byte for byte the
    layout built member by member, from views of the containers (no
    payload copied before the fill), and decodes every image exactly."""
    images, blobs = _containers(name)
    outs = batch.decompress_tiled_batch(blobs, device=CPU)
    assert len(fills) == 1
    lens, payloads, filled = fills[0]
    assert lens is None  # the headers' own tables, written in place
    assert all(isinstance(p, memoryview) and _shares(p, b) for p, b in zip(payloads, blobs))
    assert filled == _member_layout(blobs)
    for im, out in zip(images, outs):
        assert out.dtype == im.dtype and np.array_equal(out, im)


@pytest.mark.parametrize("name", ["gray8 t64 v0 and v2", "gray16 t32 same shape"])
def test_plan_reads_the_tables_as_the_joined_lengths_do(name):
    """``decode_plan`` over the headers' own tables is the plan of their
    int64 lengths joined, and ``fill_containers`` writes the same input
    from either."""
    _, blobs = _containers(name)
    headers = [flct.read_tiled_header(b) for b in blobs]
    payloads = [tiling.payload_of(b, hd) for b, hd in zip(blobs, headers)]
    lens = np.concatenate([hd.tile_lengths for hd in headers])
    plan = tiling.decode_plan(headers)
    assert plan == tiling.decode_plan(headers, lens)
    a, b = (np.zeros(plan.in_bytes(), np.uint8) for _ in range(2))
    tiling.fill_containers(a, plan, headers, None, payloads)
    tiling.fill_containers(b, plan, headers, lens, [bytes(p) for p in payloads])
    assert np.array_equal(a, b)


@pytest.mark.parametrize("name", ["gray8 t64 same shape", "rgb8 t32 v0 and v2 mixed shapes",
                                  "gray16 t32 same shape"])
def test_header_is_read_in_place_as_before(name):
    """The header's table and k0 are views of the container (or of a
    table made once a depth), and equal the values read member by member:
    the int64 lengths, the payload's size, the clamped nibbles."""
    _, blobs = _containers(name)
    for b in blobs:
        hd = flct.read_tiled_header(b)
        assert _shares(hd.table, b)
        assert hd.tile_lengths.dtype == np.int64 and hd.payload_bytes == int(hd.table.sum())
        assert hd.payload_off + hd.payload_bytes == len(b)
        if hd.k0 is None:
            continue
        c, nb = hd.k0.shape
        nibs = np.frombuffer(b[24 : 24 + (c * nb + 1) // 2], np.uint8)
        want = np.stack([nibs >> 4, nibs & 15], 1).reshape(-1)[: c * nb]
        kmax = tiled_config_for_depth(hd.pixel_depth).k_values[-1]
        assert np.array_equal(hd.k0, np.minimum(want, kmax).reshape(c, nb))


@pytest.mark.parametrize("k0", ["all 15", "mixed"])
def test_group_priors_clamp_like_prior_from_k0(k0):
    """Nibbles past the largest k give ``prior_from_k0``'s clamped rows in
    the group's one pass; a v0 member gets zeros."""
    for depth in PixelDepth:
        cfg = tiled_config_for_depth(depth)
        rng = np.random.default_rng(int(depth))
        k0s = [np.full((3, 6), 15, np.int32) if k0 == "all 15"
               else rng.integers(0, 16, (3, 6)).astype(np.int32), None,
               rng.integers(0, 16, (3, 6)).astype(np.int32)]
        out = np.full((3, 3, 6, cfg.num_k), -1, np.int32)
        flct.priors_into(out, k0s, cfg.pixel_depth)
        assert np.array_equal(out, np.stack([flct.prior_from_k0(k, cfg, 3) for k in k0s]))


def test_payload_of_is_a_view_and_checks_truncation():
    _, blobs = _containers(SMALL)
    data = blobs[0]
    hd = flct.read_tiled_header(data)
    view = tiling.payload_of(data, hd)
    assert _shares(view, data) and bytes(view) == data[hd.payload_off :]
    with pytest.raises(errors.IoError):
        tiling.payload_of(data[:-1], flct.read_tiled_header(data[:-1]))


def _bad_magic(blob):
    return b"FLCX" + blob[4:]


SMALL = "gray8 t8 v0 and v2 mixed shapes"


def test_raise_reads_every_header_before_any_payload():
    """With ``on_error="raise"``, a bad header after a truncated member
    raises the header's error, in the batch and in the stream."""
    _, blobs = _containers(SMALL)
    datas = [blobs[0], blobs[1][:-5], _bad_magic(blobs[2])]
    with pytest.raises(errors.InvalidSignature):
        batch.decompress_tiled_batch(datas, device=CPU)
    with pytest.raises(errors.InvalidSignature):
        batch.decompress_tiled_stream([datas], device=CPU)
    with pytest.raises(errors.IoError):
        batch.decompress_tiled_batch(datas[:2], device=CPU)


def test_isolate_keeps_each_error_in_its_place():
    images, blobs = _containers(SMALL)
    hd = flct.read_tiled_header(blobs[0])
    cut_table = blobs[0][: hd.payload_off - 1]
    datas = [blobs[0][:-5], _bad_magic(blobs[1]), blobs[2], cut_table,
             bytearray(blobs[1])]
    outs = batch.decompress_tiled_batch(datas, device=CPU, on_error="isolate")
    assert isinstance(outs[0], errors.IoError) and "payload" in str(outs[0])
    assert isinstance(outs[1], errors.InvalidSignature)
    assert np.array_equal(outs[2], images[2])
    assert isinstance(outs[3], errors.IoError) and "table" in str(outs[3])
    assert np.array_equal(outs[4], images[1])


KINDS = {"bytes": bytes, "bytearray": bytearray, "memoryview": memoryview}


@pytest.mark.parametrize("kind", list(KINDS))
def test_bytes_like_containers_decode_alike(kind):
    """``bytes``, ``bytearray`` and ``memoryview`` containers give the same
    images through the batch, the stream and the one-image call."""
    images, blobs = _containers(SMALL)
    datas = [KINDS[kind](b) for b in blobs]
    stream = batch.decompress_tiled_stream([datas[:1], datas[1:]], device=CPU)
    for outs in (batch.decompress_tiled_batch(datas, device=CPU),
                 [im for b in stream for im in b],
                 [tiling.decompress_tiled_bytes(d, device=CPU) for d in datas]):
        assert all(np.array_equal(o, im) for o, im in zip(outs, images))
