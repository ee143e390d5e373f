"""The port's oracle codec (felics_tpu_torch.core.oracle) and the API's and
CLIs' host backends against felics_tpu's: FLCS bytes and pixels of the
reference's ``backend="oracle"`` over every pixel kind and awkward sizes,
corrupt and truncated containers (the same error class, by name),
``"device"`` (on the CPU), ``"oracle"`` and ``"native"`` giving the same
bytes one image at a time and in batches, the bucketed-k decode of the
port's FLCT tile streams against tests/test_tiled.py's scalar decoder, and
``cfelics`` / ``dfelics --backend`` against the reference CLI's. Tolerance
zero: bytes and pixels are equal.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import felics_tpu
from felics_tpu.config import TileConfig as RefTileConfig
from felics_tpu.config import tiled_config_for_depth as ref_tiled_config
from felics_tpu_torch import api, native
from felics_tpu_torch.cli import cfelics, dfelics
from felics_tpu_torch.config import TileConfig, tiled_config_for_depth
from felics_tpu_torch.core import oracle
from felics_tpu_torch.device import upload_image
from felics_tpu_torch.io.images import load_image, save_image
from felics_tpu_torch.parallel import flct, tiling
from test_tiled import scalar_decode_tile_stream

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKENDS = ("device", "oracle", "native")
# The plain versions run many tiny ops: intra-op threads only contend with
# the other test workers.
torch.set_num_threads(1)

KINDS = {"gray8": (np.uint8, ()), "gray16": (np.uint16, ()), "rgb8": (np.uint8, (3,)),
         "rgb16": (np.uint16, (3,))}
SIZES = [(0, 0), (1, 1), (1, 17), (13, 1), (2, 2), (29, 35), (64, 57)]


def _image(kind, hw, smooth, seed=0):
    dtype, chans = KINDS[kind]
    shape = tuple(hw) + chans
    rng = np.random.default_rng(seed)
    hi = np.iinfo(dtype).max
    if smooth and min(hw) > 0:
        img = np.cumsum(np.cumsum(rng.integers(-6, 7, shape), 0), 1) + hi // 2
        return np.clip(img, 0, hi).astype(dtype)
    return rng.integers(0, hi + 1, shape).astype(dtype)


def _outcome(fn):
    """("image", array) of fn(), or the name of the error class it raised."""
    try:
        return ("image", fn())
    except Exception as e:  # noqa: BLE001 - the class name is the result
        return type(e).__name__


def _same_outcome(got, want):
    if isinstance(want, str) or isinstance(got, str):
        assert got == want
    else:
        assert got[1].dtype == want[1].dtype and np.array_equal(got[1], want[1])


@pytest.fixture(scope="module")
def built_native():
    if not native.LIB_PATH.exists():
        subprocess.run([sys.executable, os.path.join(REPO, "native", "build.py")],
                       check=True)


FLCS_CASES = [(k, hw, s) for k in KINDS for hw in SIZES for s in (True, False)]


@pytest.mark.parametrize(
    "kind,hw,smooth", FLCS_CASES,
    ids=[f"{k}-{h}x{w}-{'smooth' if s else 'noise'}" for k, (h, w), s in FLCS_CASES])
def test_flcs_matches_reference_oracle(kind, hw, smooth):
    img = _image(kind, hw, smooth, seed=hw[0] * 100 + hw[1])
    blob = api.compress_image_bytes(img, backend="oracle")
    assert blob == felics_tpu.compress_image_bytes(img, backend="oracle")
    out = api.decompress_image_bytes(blob, backend="oracle")
    assert out.dtype == img.dtype and out.shape == img.shape
    assert np.array_equal(out, img)
    assert np.array_equal(out, felics_tpu.decompress_image_bytes(blob, backend="oracle"))


def _corrupt(name):
    """Bytes of a damaged FLCS container."""
    gray = api.compress_image_bytes(_image("gray8", (12, 10), True), backend="oracle")
    rgb16 = api.compress_image_bytes(_image("rgb16", (7, 9), False), backend="oracle")
    if name == "header only":
        return gray[:14]
    if name == "header cut":
        return gray[:9]
    if name == "empty":
        return b""
    if name == "bad magic":
        return b"FLCX" + gray[4:]
    if name == "bad color":
        return gray[:4] + b"\x07" + gray[5:]
    if name == "bad depth":
        return gray[:5] + b"\x09" + gray[6:]
    if name == "oversized dims":
        return gray[:6] + (1 << 16).to_bytes(4, "big") * 2 + gray[14:]
    if name == "gray8 half payload":
        return gray[: 14 + (len(gray) - 14) // 2]
    if name == "rgb16 half payload":
        return rgb16[: 14 + (len(rgb16) - 14) // 2]
    kind, seed = name.split(" flip ")
    blob = {"gray8": gray, "rgb16": rgb16}[kind]
    rng = np.random.default_rng(int(seed))
    data = bytearray(blob)
    for pos in rng.integers(14, len(data), 2):
        data[int(pos)] ^= int(rng.integers(1, 256))
    return bytes(data)


CORRUPT = ["header only", "header cut", "empty", "bad magic", "bad color", "bad depth",
           "oversized dims", "gray8 half payload", "rgb16 half payload"]
CORRUPT += [f"{k} flip {s}" for k in ("gray8", "rgb16") for s in range(4)]


@pytest.mark.parametrize("name", CORRUPT)
def test_corrupt_containers_fail_as_reference(name):
    data = _corrupt(name)
    want = _outcome(lambda: felics_tpu.decompress_image_bytes(data, backend="oracle"))
    got = _outcome(lambda: api.decompress_image_bytes(data, backend="oracle"))
    _same_outcome(got, want)
    if name == "header only":
        assert got == "IoError"


def _stream(depth, *writes):
    """An FLCS container of a 3x1 image of ``depth`` bits whose payload is
    ``writes``, (nbits, value) pairs or ("unary", n)."""
    from felics_tpu_torch.coding import BitWriter
    from felics_tpu_torch.format import ColorType, Header, PixelDepth, header_bytes

    writer = BitWriter()
    for nbits, value in writes:
        if nbits == "unary":
            writer.write_unary0(value)
        else:
            writer.write(nbits, value)
    writer.byte_align()
    pd = PixelDepth.EIGHT if depth == 8 else PixelDepth.SIXTEEN
    return header_bytes(Header(ColorType.GRAY, pd, 3, 1)) + writer.getvalue()


DECODER_FAULTS = {
    # neighbours 0 and 1000: a context past MAX_CONTEXT (510) -> InvalidValue
    "context above MAX_CONTEXT": (_stream(8, (32, 0), (32, 1000), (1, 1), (9, 0)),
                                  "InvalidValue"),
    # above range of 2^31 - 1 by one -> ValueOverflow
    "pixel past i32": (_stream(8, (32, 2**31 - 1), (32, 2**31 - 1), (2, 0b01), (1, 0),
                              (5, 0)), "ValueOverflow"),
    # 16-bit, k = 14: a quotient of 2^17 codes a residual of 2^31 -> InvalidValue
    "residual past i32": (_stream(16, (32, 0), (32, 0), (2, 0b01), ("unary", 1 << 17),
                                 (14, 0)), "InvalidValue"),
}


@pytest.mark.parametrize("name", list(DECODER_FAULTS))
def test_decoder_faults_raise_as_reference(name):
    data, want = DECODER_FAULTS[name]
    ref = _outcome(lambda: felics_tpu.decompress_image_bytes(data, backend="oracle"))
    assert ref == want
    assert _outcome(lambda: api.decompress_image_bytes(data, backend="oracle")) == want


SMALL = {kind: _image(kind, (9, 11), True, seed=i) for i, kind in enumerate(KINDS)}


@pytest.mark.parametrize("kind", list(KINDS))
def test_backends_give_identical_bytes(built_native, kind):
    img = SMALL[kind]
    blobs = {b: api.compress_image_bytes(img, device=CPU, backend=b) for b in BACKENDS}
    assert blobs["device"] == blobs["oracle"] == blobs["native"]
    for b in BACKENDS:
        out = api.decompress_image_bytes(blobs["oracle"], device=CPU, backend=b)
        assert out.dtype == img.dtype and np.array_equal(out, img), b


@pytest.mark.parametrize("kind", ["gray8", "rgb16"])
def test_flct_under_every_backend(built_native, kind):
    """FLCT: "oracle" takes the device pipeline, "native" the C++ tiled
    codec; the same bytes as the reference's, decoding exactly under every
    backend."""
    img, tc = SMALL[kind], TileConfig(4, 4)
    blobs = {b: api.compress_image_bytes(img, "flct", tc, CPU, b) for b in BACKENDS}
    assert blobs["device"] == blobs["oracle"] == blobs["native"]
    assert blobs["native"] == felics_tpu.compress_image_bytes(
        img, backend="native", container="flct", tile=RefTileConfig(4, 4))
    for b in BACKENDS:
        out = api.decompress_image_bytes(blobs["device"], device=CPU, backend=b)
        assert out.dtype == img.dtype and np.array_equal(out, img), b


def test_batches_under_every_backend(built_native):
    images = list(SMALL.values())
    tc = TileConfig(4, 4)
    flcs = {b: api.compress_images_bytes(images, device=CPU, backend=b) for b in BACKENDS}
    assert flcs["device"] == flcs["oracle"] == flcs["native"]
    assert flcs["oracle"] == felics_tpu.compress_images_bytes(images, backend="oracle")
    flct_ = {b: api.compress_images_bytes(images, "flct", tc, CPU, b) for b in BACKENDS}
    assert flct_["device"] == flct_["oracle"] == flct_["native"]
    mixed = [flcs["device"][0], flct_["device"][1], flcs["device"][2], flct_["device"][3]]
    for b in BACKENDS:
        for blobs in (flcs["device"], flct_["device"], mixed):
            outs = api.decompress_images_bytes(blobs, device=CPU, backend=b)
            for im, out in zip(images, outs):
                assert out.dtype == im.dtype and np.array_equal(out, im), b
        assert api.decompress_images_bytes([], device=CPU, backend=b) == []


CALLS = {
    "flcs encode": lambda img, blobs: api.compress_image_bytes(img, backend="native"),
    "flcs decode": lambda img, blobs: api.decompress_image_bytes(blobs[0], backend="native"),
    "flct encode": lambda img, blobs: api.compress_image_bytes(
        img, container="flct", backend="native"),
    "flct decode": lambda img, blobs: api.decompress_image_bytes(blobs[1], backend="native"),
    "batch encode": lambda img, blobs: api.compress_images_bytes([img], backend="native"),
    "batch decode": lambda img, blobs: api.decompress_images_bytes(blobs, backend="native"),
}


@pytest.mark.parametrize("call", list(CALLS))
def test_native_without_its_library_raises(monkeypatch, tmp_path, call):
    """"native" with no library built raises; it never gives way to the
    oracle or the device."""
    img = SMALL["gray8"]
    blobs = [api.compress_image_bytes(img, backend="oracle"),
             api.compress_image_bytes(img, container="flct", device=CPU)]
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "missing.so")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="not built"):
        CALLS[call](img, blobs)


@pytest.mark.parametrize("backend", ["auto", "jax", "ORACLE"])
def test_unknown_backend_raises(backend):
    img = SMALL["gray8"]
    with pytest.raises(ValueError, match="backend"):
        api.compress_image_bytes(img, backend=backend)
    with pytest.raises(ValueError, match="backend"):
        api.compress_images_bytes([img], container="flct", backend=backend)
    with pytest.raises(ValueError, match="backend"):
        api.decompress_images_bytes([b"FLCT"], backend=backend)


def test_oracle_needs_no_device():
    """FLCS on the oracle runs on a host without CUDA whatever ``device``
    says; FLCT under "oracle" is the device pipeline, so on such a host the
    default device raises."""
    img = SMALL["rgb8"]
    blob = api.compress_image_bytes(img, backend="oracle")  # device="cuda"
    assert np.array_equal(api.decompress_image_bytes(blob, backend="oracle"), img)
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        api.compress_image_bytes(img, container="flct", backend="oracle")


TILE_CASES = [(k, v) for k in KINDS for v in ("v2", "v0")]


@pytest.mark.parametrize("kind,version", TILE_CASES, ids=[f"{k}-{v}" for k, v in TILE_CASES])
def test_tile_streams_decode_as_reference_scalar(kind, version):
    """Each tile stream of the port's FLCT container: the port's oracle in
    bucketed-k mode decodes the planes the reference's scalar tile decoder
    does, which are the tile's planes as the encoder cut them, ends inside
    the tile's bytes, and encodes them back to the same bytes."""
    img = _image(kind, (21, 35), True, seed=5)
    tc = TileConfig(8, 16)
    data = tiling.compress_tiled_bytes(img, tc, k_prior=version == "v2", device=CPU)
    hd = flct.read_tiled_header(data)
    cfg = tiled_config_for_depth(hd.pixel_depth)
    c, th, tw = hd.num_channels, hd.tile_h, hd.tile_w
    prior = flct.prior_from_k0(hd.k0, cfg, c) if hd.k0 is not None else None
    tiles = tiling.image_tiles(upload_image(img, torch.device(CPU))[None], th, tw).numpy()
    offsets = np.concatenate([[0], np.cumsum(hd.tile_lengths)]) + hd.payload_off
    assert len(tiles) == hd.n_tiles
    for t in range(hd.n_tiles):
        stream = data[offsets[t]:offsets[t + 1]]
        planes, end = oracle.decompress_tile(stream, th, tw, c, cfg, prior)
        want = scalar_decode_tile_stream(stream, th, tw, c, ref_tiled_config(hd.pixel_depth),
                                         prior)
        assert np.array_equal(planes, np.stack(want)), t
        assert np.array_equal(planes, tiles[t]), t
        assert end <= 8 * len(stream)
        again, bits = oracle.compress_tile(tiles[t], th, tw, cfg, prior)
        assert bits == end and again == stream[:len(again)], t


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


CLI_CASES = [(b, case) for b in ("oracle", "native") for case in ("gray8", "rgb16", "flct")]


@pytest.mark.parametrize("backend,case", CLI_CASES, ids=[f"{b}-{c}" for b, c in CLI_CASES])
def test_cli_backends_match_reference_cli(built_native, tmp_path, backend, case):
    from felics_tpu.cli import cfelics as ref_cfelics
    from felics_tpu.cli import dfelics as ref_dfelics

    img = _image("rgb16" if case == "rgb16" else "gray8", (14, 19), False, seed=3)
    ext = ".tiff" if case == "rgb16" else ".png"
    src = str(tmp_path / "in.tiff")
    save_image(src, img)
    flags = ["--container", "flct", "--tile-size", "8"] if case == "flct" else []
    side = {}
    for who, c_main, d_main, extra in (
            ("port", cfelics.main, dfelics.main, ["--device", CPU]),
            ("ref", ref_cfelics.main, ref_dfelics.main, [])):
        fel, out = str(tmp_path / f"{who}.fel"), str(tmp_path / f"{who}{ext}")
        assert c_main(["-i", src, "-o", fel, *flags, "--backend", backend, *extra]) == 0
        # each side decodes the other's file
        side[who] = (fel, out, d_main, extra)
    assert _read(side["port"][0]) == _read(side["ref"][0])
    for who, other in (("port", "ref"), ("ref", "port")):
        _, out, d_main, extra = side[who]
        assert d_main(["-i", side[other][0], "-o", out, "--backend", backend, *extra]) == 0
    # The decoded files are compared by their pixels: a TIFF writer may
    # stamp the time.
    got, want = load_image(side["port"][1]), load_image(side["ref"][1])
    assert got.dtype == want.dtype == img.dtype
    assert np.array_equal(got, img) and np.array_equal(want, img)


@pytest.mark.parametrize("backend", ["oracle", "native"])
def test_bfelics_backend_writes_the_reference_files(built_native, tmp_path, backend):
    from felics_tpu_torch.cli import bfelics

    corpus = tmp_path / "corpus"
    corpus.mkdir()
    ims = [_image("gray8", (12, 15), True, seed=i) for i in range(2)]
    for i, im in enumerate(ims):
        save_image(str(corpus / f"im{i}.tiff"), im)
    out = tmp_path / "out"
    assert bfelics.main(["--corpus", str(corpus), "--out", str(out), "--backend", backend,
                         "--device", CPU]) == 0
    fels = sorted((out / "to_felics").glob("*.fel"))
    assert [f.read_bytes() for f in fels] == [
        felics_tpu.compress_image_bytes(im, backend=backend) for im in ims]
