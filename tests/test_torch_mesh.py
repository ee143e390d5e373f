"""The port's sharded FLCT (felics_tpu_torch.parallel.mesh) on a mesh of 8
CPU devices, mirroring tests/test_mesh.py: bytes equal to the one-device
``compress_tiled_bytes`` of the port and of felics_tpu (and to felics_tpu's
``encode_tiled_sharded(engine="xla")`` on its 8 virtual devices), exact
decodes, rows sharded not replicated, a corpus against
``compress_tiled_batch``, worst-case tiles, and corrupt containers raising
the reference's error subclasses. Tolerance zero: bytes and pixels equal.
"""

import numpy as np
import pytest
import torch

from felics_tpu.config import TileConfig
from felics_tpu.parallel import tiling as ref_tiling
from felics_tpu_torch import compress_tiled_batch, compress_tiled_bytes
from felics_tpu_torch import errors
from felics_tpu_torch.parallel import flct, mesh, tiling

TILE8 = TileConfig(tile_h=8, tile_w=8)
TILE4 = TileConfig(tile_h=4, tile_w=4)
MESH = mesh.make_tile_mesh(["cpu"] * 8)
# Outcomes that do not depend on the shard count run on a smaller mesh:
# every shard of the plain versions walks its tiles' pixels in Python.
PAIR = mesh.make_tile_mesh(["cpu"] * 2)
# The plain versions run many tiny ops: intra-op threads only contend with
# the other test workers.
torch.set_num_threads(1)


def smooth_image(rng, width, height, dtype=np.uint8, channels=None):
    shape = (height, width) if channels is None else (height, width, channels)
    steps = rng.integers(-6, 7, size=shape)
    img = np.cumsum(np.cumsum(steps, axis=0), axis=1) + 128
    return np.clip(img, 0, np.iinfo(dtype).max).astype(dtype)


def test_make_tile_mesh():
    assert MESH == (torch.device("cpu"),) * 8
    assert mesh.make_tile_mesh(["cpu"]) == (torch.device("cpu"),)
    with pytest.raises(ValueError):
        mesh.make_tile_mesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            mesh.make_tile_mesh()
        with pytest.raises(RuntimeError, match="cuda"):
            mesh.make_tile_mesh(["cpu", "cuda:0"])


def test_sharded_encode_matches_single_device_and_reference(rng):
    from felics_tpu.parallel import mesh as ref_mesh

    img = smooth_image(rng, 32, 16)  # 8 tiles of 8x8, one a device
    sharded = mesh.encode_tiled_sharded(img, MESH, TILE8)
    assert sharded == compress_tiled_bytes(img, TILE8, device="cpu")
    assert sharded == ref_tiling.compress_tiled_bytes(img, TILE8)
    ref_sharded = ref_mesh.encode_tiled_sharded(
        img, ref_mesh.make_tile_mesh(), TILE8, engine="xla")
    assert sharded == ref_sharded
    np.testing.assert_array_equal(mesh.decode_tiled_sharded(sharded, MESH), img)


def test_sharded_encode_with_tile_padding(rng):
    img = smooth_image(rng, 24, 16)  # 6 tiles -> padded to 8 for the mesh
    sharded = mesh.encode_tiled_sharded(img, MESH, TILE8)
    assert sharded == compress_tiled_bytes(img, TILE8, device="cpu")
    np.testing.assert_array_equal(mesh.decode_tiled_sharded(sharded, MESH), img)


@pytest.mark.parametrize("devices", [1, 3, 5], ids=lambda n: f"{n}dev")
def test_mesh_sizes_agree(rng, devices):
    img = smooth_image(rng, 40, 24)  # 15 tiles of 8x8
    m = mesh.make_tile_mesh(["cpu"] * devices)
    data = mesh.encode_tiled_sharded(img, m, TILE8)
    assert data == compress_tiled_bytes(img, TILE8, device="cpu")
    np.testing.assert_array_equal(mesh.decode_tiled_sharded(data, m), img)


def test_sharded_decode_matches_rgb8(rng):
    img = smooth_image(rng, 16, 12, channels=3)
    data = ref_tiling.compress_tiled_bytes(img, TILE4)
    out = mesh.decode_tiled_sharded(data, MESH)
    assert out.dtype == img.dtype
    np.testing.assert_array_equal(out, img)


def test_sharded_rgb16_both_ways(rng):
    img = smooth_image(rng, 12, 10, np.uint16, 3)
    single = ref_tiling.compress_tiled_bytes(img, TILE4)
    data = mesh.encode_tiled_sharded(img, MESH, TILE4)
    assert data == single
    out = mesh.decode_tiled_sharded(data, MESH)
    assert out.dtype == np.uint16
    np.testing.assert_array_equal(out, img)


def test_sharded_decode_rows_are_sharded(rng, monkeypatch):
    """Each device gets only its own tiles' streams (and, past the last
    tile, padding copies of tile 0), not the whole payload, in the
    one-device decode input's layout, rows as wide as the image's."""
    img = smooth_image(rng, 40, 32)  # 20 tiles of 8x8 over 8 devices: 3 each
    data = compress_tiled_bytes(img, TILE8, device="cpu")
    lens = ref_tiling.read_tiled_header(data).tile_lengths
    seen = []
    real = tiling.fill_containers

    def spy(host, plan, headers, shard_lens, payloads):
        seen.append((shard_lens.copy(), sum(len(p) for p in payloads), plan, host.size))
        return real(host, plan, headers, shard_lens, payloads)

    monkeypatch.setattr(tiling, "fill_containers", spy)
    np.testing.assert_array_equal(mesh.decode_tiled_sharded(data, MESH), img)
    assert len(seen) == 8
    padded = np.concatenate([lens, np.repeat(lens[:1], 4)])
    for i, (shard_lens, n_bytes, plan, size) in enumerate(seen):
        assert np.array_equal(shard_lens, padded[3 * i : 3 * i + 3])
        assert n_bytes == int(shard_lens.sum())
        assert plan.nt == 3 and plan.wd == tiling.row_width(lens)
        assert size == plan.in_bytes()


def test_corpus_encode_sharded_matches_batch(rng):
    from felics_tpu.parallel.batch import compress_tiled_batch as ref_batch

    gray = [smooth_image(rng, 32, 24), smooth_image(rng, 24, 32), smooth_image(rng, 16, 16)]
    got = mesh.encode_corpus_sharded(gray, MESH, TILE8)
    assert got == compress_tiled_batch(gray, TILE8, device="cpu")
    assert got == ref_batch(gray, TILE8, "xla")
    # Geometry groups (here rgb8 and zero-area members beside the gray
    # ones) each shard over the mesh.
    mixed = gray[:1] + [smooth_image(rng, 8, 8, channels=3), np.zeros((0, 5), np.uint8)]
    got = mesh.encode_corpus_sharded(mixed, MESH, TILE4)
    assert got == compress_tiled_batch(mixed, TILE4, device="cpu")


def test_zero_area_image(rng):
    img = np.zeros((0, 7), np.uint16)
    data = mesh.encode_tiled_sharded(img, MESH, TILE8)
    assert data == ref_tiling.compress_tiled_bytes(img, TILE8)
    out = mesh.decode_tiled_sharded(data, MESH)
    assert out.shape == (0, 7) and out.dtype == np.uint16


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_worst_case_tiles(rng, dtype):
    """Uniform noise and a checkerboard of extremes (maximal contexts and
    residuals): the sharded bytes equal the unsharded encoders', and the
    streams decode exactly."""
    hi = np.iinfo(dtype).max
    noise = rng.integers(0, hi + 1, (8, 32)).astype(dtype)
    checker = np.zeros((8, 32), dtype)
    checker[::2, 1::2] = hi
    checker[1::2, ::2] = hi
    for img in (noise, checker):
        data = mesh.encode_tiled_sharded(img, PAIR, TILE8)
        assert data == ref_tiling.compress_tiled_bytes(img, TILE8, engine="xla")
        np.testing.assert_array_equal(mesh.decode_tiled_sharded(data, PAIR), img)


def _same_outcome(data):
    """The port's sharded decode and felics_tpu's one-device decode on the
    same bytes: both raise errors of one subclass name, or both give the
    same image. Returns the subclass name or "image"."""
    try:
        want = ref_tiling.decompress_tiled_bytes(data, engine="xla")
    except Exception as e:  # noqa: BLE001 - compared by class name below
        with pytest.raises(errors.DecompressionError) as got:
            mesh.decode_tiled_sharded(data, PAIR)
        assert type(got.value).__name__ == type(e).__name__
        return type(e).__name__
    np.testing.assert_array_equal(mesh.decode_tiled_sharded(data, PAIR), want)
    return "image"


def test_corrupt_containers_raise_reference_errors(rng):
    img = smooth_image(rng, 24, 16)  # 6 tiles of 8x8
    data = compress_tiled_bytes(img, TILE8, device="cpu")
    hd = ref_tiling.read_tiled_header(data)
    outcomes = {
        "truncated": _same_outcome(data[:-3]),
        "bad magic": _same_outcome(b"FLCX" + data[4:]),
        "zero tile width": _same_outcome(data[:14] + b"\x00\x00" + data[16:]),
        "cut table": _same_outcome(data[: hd.payload_off - 1]),
    }
    assert outcomes == {
        "truncated": "IoError", "bad magic": "InvalidSignature",
        "zero tile width": "InvalidDimensions", "cut table": "IoError",
    }
    # Every byte of one tile's stream inverted: the gray8 image may still
    # decode (to other pixels); an rgb8 image's YCoCg planes leave the
    # depth, in both decoders alike.
    rgb8 = smooth_image(np.random.default_rng(1234), 12, 8, channels=3)
    for img, tc in ((img, TILE8), (rgb8, TILE4)):
        data = compress_tiled_bytes(img, tc, device="cpu")
        hd = ref_tiling.read_tiled_header(data)
        flipped = bytearray(data)
        for i in range(hd.payload_off, hd.payload_off + int(hd.tile_lengths[0])):
            flipped[i] ^= 0xFF
        outcome = _same_outcome(bytes(flipped))
    assert outcome == "InvalidValue"


def test_sharded_redo_paths(rng, monkeypatch):
    """Width and capacity hints far too small: every shard relaunches its
    encode at the exact width (the finish step the one-device path uses),
    and the bytes still equal the one-device container."""
    from felics_tpu_torch.ops import tile_codec as tcd

    img = rng.integers(0, 256, (16, 24)).astype(np.uint8)  # noise, 6 tiles of 8x8
    want = compress_tiled_bytes(img, TILE8, device="cpu")
    monkeypatch.setattr(tcd, "width_hint", lambda cfg, t, c: 1)
    monkeypatch.setattr(tiling, "payload_cap_hint", lambda cfg, nt, t, c: 1)
    relaunches = []
    real = tiling.exact_width
    monkeypatch.setattr(tiling, "exact_width",
                        lambda max_bits: relaunches.append(max_bits) or real(max_bits))
    assert mesh.encode_tiled_sharded(img, mesh.make_tile_mesh(["cpu"] * 3), TILE8) == want
    assert len(relaunches) == 3


@pytest.mark.parametrize("channels, dtype", [(None, np.uint8), (3, np.uint8),
                                             (None, np.uint16)])
def test_narrowed_planes_keep_the_range_check(rng, channels, dtype):
    """The planes the process groups gather (``narrow_planes``: int16 at 8
    bits) assemble to the same image, and a value outside the plane bounds,
    near or far, still flags the image."""
    img = smooth_image(rng, 16, 8, dtype, channels)
    hd = flct.read_tiled_header(compress_tiled_bytes(img, TILE8, device="cpu"))
    planes = tiling.image_tiles(torch.from_numpy(img.astype(np.int32))[None], 8, 8)
    narrow = mesh.narrow_planes(planes, hd)
    assert narrow.dtype == (torch.int16 if dtype == np.uint8 else torch.int32)
    plan = tiling.decode_plan([hd], hd.tile_lengths)
    out, ok = tiling.assemble_images(narrow.to(torch.int32), plan)
    assert bool(ok[0]) and np.array_equal(out[0].numpy(), img)
    lo, hi = tiling.plane_bounds(hd)
    for bad in (lo - 1, hi + 1, lo - 100000, hi + 100000):
        corrupt = planes.clone()
        corrupt[1, -1, 5] = bad
        narrowed = mesh.narrow_planes(corrupt, hd).to(torch.int32)
        assert not bool(tiling.assemble_images(narrowed, plan)[1][0])
