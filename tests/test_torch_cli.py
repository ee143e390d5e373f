"""The port's CLIs (felics_tpu_torch.cli), image IO and QOI binding against
felics_tpu's: tests/test_cli.py's behaviours through the real argv surface
with ``--device cpu`` (the .fel bytes equal felics_tpu's ``cfelics --backend
jax`` on the same file), the default ``--device cuda`` on a host without
CUDA, the bfelics smoke of tests/test_more_coverage.py, and tests/test_qoi.py's
cases for ``felics_tpu_torch.native.qoi_*``. Tolerance zero: bytes and
pixels equal.
"""

import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from felics_tpu_torch import errors, native, read_header
from felics_tpu_torch.cli import bfelics, cfelics, dfelics, vfelics
from felics_tpu_torch.io import images
from felics_tpu_torch.io.images import UnsupportedImageFormat, load_image, save_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]
# The plain versions run many tiny ops: intra-op threads only contend with
# the other test workers.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def built_native():
    subprocess.run([sys.executable, os.path.join(REPO, "native", "build.py")], check=True)
    assert native.qoi_available()


@pytest.fixture
def gray_tiff(tmp_path, rng):
    img = rng.integers(0, 256, size=(24, 31)).astype(np.uint8)
    path = str(tmp_path / "in.tiff")
    save_image(path, img)
    return path, img


@pytest.fixture
def rgb16_tiff(tmp_path, rng):
    img = rng.integers(0, 65536, size=(9, 13, 3)).astype(np.uint16)
    path = str(tmp_path / "in16.tiff")
    save_image(path, img)
    return path, img


def _reference_fel(tmp_path, path, *flags) -> bytes:
    from felics_tpu.cli import cfelics as ref_cfelics

    out = str(tmp_path / "ref.fel")
    assert ref_cfelics.main(["-i", path, "-o", out, "--backend", "jax", *flags]) == 0
    with open(out, "rb") as f:
        return f.read()


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize(
    "fixture,out_name,flags",
    [
        ("gray_tiff", "out.png", []),
        ("rgb16_tiff", "out.tiff", []),
        ("gray_tiff", "out.png", ["--container", "flct", "--tile-size", "16"]),
    ],
    ids=["gray8", "rgb16", "flct-tile16"],
)
def test_round_trip_cli(request, tmp_path, fixture, out_name, flags):
    path, img = request.getfixturevalue(fixture)
    fel = str(tmp_path / "out.fel")
    out = str(tmp_path / out_name)
    assert cfelics.main(["-i", path, "-o", fel, *flags, *CPU]) == 0
    blob = _read(fel)
    assert blob[:4] == (b"FLCT" if flags else b"FLCS")
    assert blob == _reference_fel(tmp_path, path, *flags)
    assert dfelics.main(["-i", fel, "-o", out, *CPU]) == 0
    got = load_image(out)
    assert got.dtype == img.dtype and np.array_equal(got, img)


def test_cfelics_messages(tmp_path, gray_tiff, capsys):
    path, _ = gray_tiff
    assert cfelics.main(["-i", path, "-o", str(tmp_path / "x.fel"), *CPU]) == 0
    assert "Compressing 8-bit grayscale image..." in capsys.readouterr().out


def test_cfelics_missing_input(tmp_path, capsys):
    rc = cfelics.main(
        ["-i", str(tmp_path / "nope.tiff"), "-o", str(tmp_path / "x.fel"), *CPU])
    assert rc == 1
    assert "Cannot open file" in capsys.readouterr().out


def test_cfelics_unsupported_input(tmp_path, capsys):
    from PIL import Image

    path = str(tmp_path / "rgba.png")
    Image.fromarray(np.zeros((4, 5, 4), np.uint8), mode="RGBA").save(path)
    assert cfelics.main(["-i", path, "-o", str(tmp_path / "x.fel"), *CPU]) == 1
    assert "Unsupported image format" in capsys.readouterr().out


def test_dfelics_garbage_input(tmp_path, capsys):
    bad = tmp_path / "bad.fel"
    bad.write_bytes(b"not a felics file at all")
    rc = dfelics.main(["-i", str(bad), "-o", str(tmp_path / "x.png"), *CPU])
    assert rc == 1
    out = capsys.readouterr().out
    assert "Error while decompressing" in out and "InvalidSignature" in out


def test_vfelics_export(tmp_path, gray_tiff, capsys):
    path, img = gray_tiff
    fel = str(tmp_path / "v.fel")
    assert cfelics.main(["-i", path, "-o", fel, *CPU]) == 0
    png = str(tmp_path / "v.png")
    assert vfelics.main([fel, "--export", png, *CPU]) == 0
    np.testing.assert_array_equal(load_image(png), img)
    out = capsys.readouterr().out
    assert "v.fel: 31x24 uint8 grayscale" in out and f"Wrote {png}" in out


def test_header_probe_tool(tmp_path, gray_tiff):
    path, _ = gray_tiff
    fel = str(tmp_path / "h.fel")
    assert cfelics.main(["-i", path, "-o", fel, *CPU]) == 0
    with open(fel, "rb") as f:
        h = read_header(f)
    assert (h.width, h.height) == (31, 24)


def test_default_cuda_device_without_cuda_fails(tmp_path, gray_tiff, capsys):
    """The default --device cuda on a host without CUDA: a message, rc 1,
    and no output; nothing carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    path, _ = gray_tiff
    fel = tmp_path / "x.fel"
    assert cfelics.main(["-i", path, "-o", str(fel)]) == 1
    out = capsys.readouterr().out
    assert "Cannot compress image:" in out and "cuda" in out
    assert not fel.exists()
    assert cfelics.main(["-i", path, "-o", str(fel), *CPU]) == 0
    assert dfelics.main(["-i", str(fel), "-o", str(tmp_path / "x.png")]) == 1
    assert "Error while decompressing the image" in capsys.readouterr().out
    assert not (tmp_path / "x.png").exists()


def test_bfelics_smoke(tmp_path, rng, built_native, capsys):
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    ims = []
    for i in range(3):
        steps = rng.integers(-6, 7, size=(16, 20))
        im = np.clip(np.cumsum(np.cumsum(steps, 0), 1) + 128, 0, 255).astype(np.uint8)
        ims.append(im)
        save_image(str(corpus / f"im{i}.tiff"), im)
    out = tmp_path / "out"
    assert bfelics.main(["--corpus", str(corpus), "--out", str(out), *CPU]) == 0
    fels = sorted((out / "to_felics").glob("*.fel"))
    assert len(fels) == 3
    from felics_tpu import compress_image_bytes as ref_compress

    for im, fel in zip(ims, fels):
        assert fel.read_bytes() == ref_compress(im, backend="jax")
    qois = sorted((out / "to_qoi").glob("*.qoi"))
    assert len(qois) == 3
    assert np.array_equal(native.qoi_decode(qois[0].read_bytes())[..., 0], ims[0])
    printed = capsys.readouterr().out
    assert "Benchmarking 3 images" in printed
    assert "  .fel: enc" in printed and "  .qoi: enc" in printed
    from PIL import features

    if features.check("jpg_2000"):
        out_jp2 = sorted((out / "to_jp2").glob("*.jp2"))
        assert len(out_jp2) == 3
        from PIL import Image

        assert np.array_equal(np.asarray(Image.open(str(out_jp2[0]))), ims[0])


def test_bfelics_empty_corpus(tmp_path, capsys):
    assert bfelics.main(["--corpus", str(tmp_path), *CPU]) == 1
    assert "No TIFFs found" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Image IO
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,dtype", [((7, 5), np.uint16), ((6, 9, 3), np.uint16),
                                         ((6, 9, 3), np.uint8), ((4, 3), np.uint8)])
def test_io_matches_reference(tmp_path, shape, dtype):
    from felics_tpu.io import images as ref

    img = np.random.default_rng(3).integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    for ext in (".tiff", ".png") if (dtype == np.uint8 or len(shape) == 2) else (".tiff",):
        mine, theirs = str(tmp_path / f"m{ext}"), str(tmp_path / f"r{ext}")
        save_image(mine, img)
        ref.save_image(theirs, img)
        for p in (mine, theirs):
            for load in (load_image, ref.load_image):
                got = load(p)
                assert got.dtype == img.dtype and np.array_equal(got, img)


@pytest.mark.parametrize("shape", [(7, 5), (6, 9, 3)], ids=["gray16", "rgb16"])
def test_tiff16_without_imageio(tmp_path, monkeypatch, shape):
    """Without imageio, PIL alone narrows 16-bit RGB TIFFs: the port reads
    and writes 16-bit TIFFs itself then, and files of either writer load
    back exactly."""
    import imageio.v3 as iio

    img = np.random.default_rng(4).integers(0, 65536, shape).astype(np.uint16)
    theirs = str(tmp_path / "imageio.tiff")
    iio.imwrite(theirs, img)
    monkeypatch.setattr(images, "_imageio", lambda: None)
    mine = str(tmp_path / "own.tiff")
    save_image(mine, img)
    for p in (mine, theirs):
        got = load_image(p)
        assert got.dtype == np.uint16 and np.array_equal(got, img)
    monkeypatch.undo()
    assert np.array_equal(iio.imread(mine), img)
    if len(shape) == 3:
        with pytest.raises(UnsupportedImageFormat):
            monkeypatch.setattr(images, "_imageio", lambda: None)
            save_image(str(tmp_path / "x.png"), img)


def test_unsupported_format_matches_reference(tmp_path):
    from PIL import Image

    from felics_tpu.io import images as ref

    path = str(tmp_path / "la.png")
    Image.fromarray(np.zeros((3, 4, 2), np.uint8), mode="LA").save(path)
    with pytest.raises(ref.UnsupportedImageFormat):
        ref.load_image(path)
    with pytest.raises(UnsupportedImageFormat):
        load_image(path)
    with pytest.raises(FileNotFoundError):
        load_image(str(tmp_path / "missing.tiff"))


# ---------------------------------------------------------------------------
# QOI (tests/test_qoi.py's cases)
# ---------------------------------------------------------------------------


def test_qoi_header_layout(built_native):
    img = np.zeros((2, 3, 3), np.uint8)
    data = native.qoi_encode(img)
    assert data[:4] == b"qoif"
    assert struct.unpack(">II", data[4:12]) == (3, 2)
    assert data[12] == 3 and data[13] == 0
    assert data[-8:] == b"\x00" * 7 + b"\x01"


def test_qoi_run_and_index_chunks(built_native):
    body = native.qoi_encode(np.full((1, 124, 3), 9, np.uint8))[14:-8]
    assert body[0] & 0xC0 == 0x80 and len(body) == 4
    assert body[2] == 0xC0 | 61 and body[3] == 0xC0 | 60
    px = np.array([[10, 20, 30], [50, 60, 70], [10, 20, 30]], np.uint8)
    assert native.qoi_encode(px.reshape(1, 3, 3))[14:-8][-1] & 0xC0 == 0x00


@pytest.mark.parametrize("channels", [3, 4])
def test_qoi_round_trip_random(built_native, channels):
    from felics_tpu.native import runtime

    img = np.random.default_rng(5).integers(0, 256, (37, 23, channels)).astype(np.uint8)
    data = native.qoi_encode(img)
    assert data == runtime.qoi_encode(img)
    np.testing.assert_array_equal(native.qoi_decode(data), img)


def test_qoi_round_trip_smooth_and_gray_expansion(built_native):
    from felics_tpu.native import runtime

    rng = np.random.default_rng(6)
    gray = np.clip(
        np.cumsum(np.cumsum(rng.integers(-4, 5, (40, 52)), 0), 1) + 128, 0, 255
    ).astype(np.uint8)
    rgb = np.stack([gray] * 3, axis=-1)
    data = native.qoi_encode(rgb)
    assert data == runtime.qoi_encode(rgb)
    assert len(data) < rgb.nbytes
    np.testing.assert_array_equal(native.qoi_decode(data), rgb)


def test_qoi_corrupt_streams(built_native):
    from felics_tpu import errors as ref_errors
    from felics_tpu.native import runtime

    data = bytearray(native.qoi_encode(np.full((4, 4, 3), 5, np.uint8)))
    for bad, name in ((b"nope" + bytes(data[4:]), "InvalidSignature"),
                      (bytes(data[:10]), "IoError")):
        with pytest.raises(errors.DecompressionError) as mine:
            native.qoi_decode(bad)
        with pytest.raises(ref_errors.DecompressionError) as theirs:
            runtime.qoi_decode(bad)
        assert type(mine.value).__name__ == type(theirs.value).__name__ == name
    try:
        assert native.qoi_decode(bytes(data[:-9])).shape == (4, 4, 3)
    except errors.DecompressionError:
        pass
    with pytest.raises(ValueError, match="QOI input"):
        native.qoi_encode(np.zeros((2, 2), np.uint8))
