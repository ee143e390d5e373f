"""The port's top-level API (felics_tpu_torch.api) against felics_tpu.api:
container routing (FLCS / FLCT, per image and batched, mixed batches),
probe, the device rule, and that the port never imports JAX. On the CPU
with the plain PyTorch versions; tolerance zero (bytes and pixels).
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import felics_tpu
import felics_tpu_torch
from felics_tpu import errors
from felics_tpu.config import TileConfig
from felics_tpu_torch import api
from felics_tpu_torch import errors as port_errors

CPU = "cpu"
TC = TileConfig(8, 8)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The plain versions run many tiny ops: intra-op threads only contend with
# the other test workers.
torch.set_num_threads(1)


def _image(shape, dtype=np.uint8, seed=0):
    rng = np.random.default_rng(seed)
    hi = np.iinfo(dtype).max
    img = np.cumsum(np.cumsum(rng.integers(-6, 7, shape), 0), 1) + hi // 2
    return np.clip(img, 0, hi).astype(dtype)


IMAGES = [
    _image((12, 10)), _image((9, 11), np.uint16, 1), _image((7, 6, 3), seed=2),
    _image((6, 5, 3), np.uint16, 3),
]


@pytest.mark.parametrize("idx", range(len(IMAGES)))
def test_flcs_bytes_equal_reference_backends(idx):
    img = IMAGES[idx]
    blob = api.compress_image_bytes(img, device=CPU)
    assert blob == felics_tpu.compress_image_bytes(img, backend="oracle")
    assert blob == felics_tpu.compress_image_bytes(img, backend="jax")
    out = api.decompress_image_bytes(blob, device=CPU)
    assert out.dtype == img.dtype and np.array_equal(out, img)


def test_flct_routes_to_the_tiled_pipeline():
    img = IMAGES[0]
    blob = api.compress_image_bytes(img, container="flct", tile=TC, device=CPU)
    assert blob[:4] == b"FLCT"
    assert blob == felics_tpu_torch.compress_tiled_bytes(img, TC, device=CPU)
    assert blob == felics_tpu.compress_image_bytes(img, container="flct", tile=TC, backend="jax")
    assert np.array_equal(api.decompress_image_bytes(blob, device=CPU), img)
    default = api.compress_image_bytes(img, container="flct", device=CPU)
    assert default == felics_tpu_torch.compress_tiled_bytes(img, TileConfig(), device=CPU)


def test_batched_routing():
    flcs = api.compress_images_bytes(IMAGES, device=CPU)
    assert flcs == [api.compress_image_bytes(im, device=CPU) for im in IMAGES]
    flct = api.compress_images_bytes(IMAGES, container="flct", tile=TC, device=CPU)
    assert flct == [
        api.compress_image_bytes(im, container="flct", tile=TC, device=CPU)
        for im in IMAGES
    ]
    for blobs in (flcs, flct, [flcs[0], flct[1], flcs[2], flct[3]]):
        outs = api.decompress_images_bytes(blobs, device=CPU)
        for im, out in zip(IMAGES, outs):
            assert out.dtype == im.dtype and np.array_equal(out, im)
    assert api.decompress_images_bytes([], device=CPU) == []


def test_mixed_batch_with_a_bad_member_raises_like_reference():
    blobs = [
        api.compress_image_bytes(IMAGES[0], device=CPU),
        api.compress_image_bytes(IMAGES[1], container="flct", tile=TC, device=CPU),
        b"NOPE" + bytes(20),
    ]
    with pytest.raises(errors.InvalidSignature):
        felics_tpu.decompress_images_bytes(blobs, backend="jax")
    with pytest.raises(port_errors.InvalidSignature):
        api.decompress_images_bytes(blobs, device=CPU)


def test_file_objects_and_probe():
    img = IMAGES[2]
    buf = io.BytesIO()
    api.compress_image(img, buf, device=CPU)
    assert np.array_equal(api.decompress_image(io.BytesIO(buf.getvalue()), device=CPU), img)
    flcs = buf.getvalue()
    flct = api.compress_image_bytes(img, container="flct", tile=TC, device=CPU)
    for blob in (flcs, flct):
        assert api.probe(blob) == felics_tpu.probe(blob)


def test_argument_checks():
    with pytest.raises(ValueError, match="container"):
        api.compress_image_bytes(IMAGES[0], container="png", device=CPU)
    with pytest.raises(ValueError, match="container"):
        api.compress_images_bytes(IMAGES, container="png", device=CPU)
    with pytest.raises(ValueError, match="uint8 or uint16"):
        api.compress_image_bytes(IMAGES[0].astype(np.int32), device=CPU)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        api.compress_image_bytes(IMAGES[0])
    blob = api.compress_image_bytes(IMAGES[0], device=CPU)
    with pytest.raises(RuntimeError, match="cuda"):
        api.decompress_image_bytes(blob)
    with pytest.raises(RuntimeError, match="cuda"):
        api.compress_images_bytes(IMAGES)


def test_port_imports_no_jax():
    """Importing every module of the port and running CPU round trips of an
    FLCS, an FLCT and a 1x1 image, on the device codecs and through
    backend="oracle", loads no module of JAX and none of the reference
    package felics_tpu."""
    code = (
        "import importlib, pkgutil, sys, numpy as np\n"
        "import felics_tpu_torch as ft\n"
        "for m in pkgutil.walk_packages(ft.__path__, 'felics_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "img = np.arange(30, dtype=np.uint8).reshape(5, 6)\n"
        "for im, kw in ((img, {}), (img, {'container': 'flct'}),\n"
        "               (np.array([[[9, 8, 7]]], np.uint16), {})):\n"
        "    b = ft.compress_image_bytes(im, device='cpu', **kw)\n"
        "    assert (ft.decompress_image_bytes(b, device='cpu') == im).all()\n"
        "    o = ft.compress_image_bytes(im, device='cpu', backend='oracle', **kw)\n"
        "    assert o == b\n"
        "    assert (ft.decompress_image_bytes(o, device='cpu', backend='oracle') == im).all()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'felics_tpu')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
