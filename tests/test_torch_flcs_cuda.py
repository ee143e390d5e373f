"""The FLCS kernels K3 (felics_tpu_torch/csrc/flcs_kscan.cu) and K4
(felics_tpu_torch/csrc/flcs_decode.cu) against their plain versions, and
the two plain versions of K4 against each other.

This module imports no JAX, so it runs on a card as well as here: inputs
are made with numpy from a seed and encoded by the port itself. The kernel
cases carry the ``cuda`` marker and skip where torch.cuda.is_available() is
False; the plain-version cases run on the CPU. Tolerance zero: every output
is an integer. On a host without JAX, skip tests/conftest.py (it sets JAX
up):

    python3 -m pytest --noconftest tests/test_torch_flcs_cuda.py -q
"""

import numpy as np
import pytest
import torch

from felics_tpu.api import header_for_array
from felics_tpu.config import config_for_depth
from felics_tpu_torch import api
from felics_tpu_torch.core import codec
from felics_tpu_torch.ops import analysis, kscan

CPU = torch.device("cpu")
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the FLCS kernels have no CPU mode")
    return torch.device("cuda")


def _image(seed, shape, dtype, smooth):
    rng = np.random.default_rng(seed)
    hi = np.iinfo(dtype).max
    if smooth:
        img = np.cumsum(np.cumsum(rng.integers(-6, 7, shape), 0), 1) + hi // 2
        return np.clip(img, 0, hi).astype(dtype)
    return rng.integers(0, hi + 1, shape).astype(dtype)


def _halving():
    """0/255 noise: large residuals in few contexts, heavy count scaling."""
    rng = np.random.default_rng(0)
    return (rng.integers(0, 2, (40, 40)) * 255).astype(np.uint8)


CASES = [
    ("gray8 smooth 23x17", _image(1, (23, 17), np.uint8, True)),
    ("gray8 random 16x16", _image(2, (16, 16), np.uint8, False)),
    ("gray8 halving 40x40", _halving()),
    ("gray16 smooth 16x16", _image(3, (16, 16), np.uint16, True)),
    ("gray16 random 9x7", _image(4, (9, 7), np.uint16, False)),
    ("rgb8 8x6", _image(5, (8, 6, 3), np.uint8, False)),
    ("rgb16 8x6", _image(6, (8, 6, 3), np.uint16, False)),
    ("gray8 1x50", _image(7, (1, 50), np.uint8, True)),
    ("gray8 50x1", _image(8, (50, 1), np.uint8, True)),
]
IDS = [c[0] for c in CASES]


def _planes(img, device):
    """(C, H*W) int32 planes of one image on ``device``, and its shape."""
    hd = header_for_array(img)
    return (codec._image_channels([img], hd, device), hd.height, hd.width,
            config_for_depth(hd.pixel_depth))


def _word_rows(img, device):
    """The image's payload, the payload with three flipped bytes, and
    all-ones words after a '00' marker, as (3, W) int32 word rows."""
    payload = api.compress_image_bytes(img, device=CPU)[14:]
    corrupt = bytearray(payload)
    mid = len(corrupt) // 2
    corrupt[mid : mid + 3] = bytes(b ^ 0xA5 for b in corrupt[mid : mid + 3])
    rows = codec.payload_words([payload, bytes(corrupt), b"\x3f" + b"\xff" * 11])
    return torch.from_numpy(rows.view(np.int32)).to(device)


@pytest.mark.parametrize("name,img", CASES, ids=IDS)
def test_scalar_decode_scan_matches_tensor_version(name, img):
    planes, h, w, cfg = _planes(img, CPU)
    words = _word_rows(img, CPU)
    c = planes.shape[0]
    want = codec.decode_scan_ref(words, h, w, cfg, c)
    got = codec.decode_scan_scalar(words, h, w, cfg, c)
    for g, r in zip(got, want):
        assert torch.equal(g, r)
    assert torch.equal(got[0][0], planes)


@pytest.mark.cuda
@pytest.mark.parametrize("name,img", CASES, ids=IDS)
def test_cuda_kscan_matches_plain_version(cuda, name, img):
    planes, h, w, cfg = _planes(img, cuda)
    port = analysis.analyze_channel(planes, h, w)
    su = kscan.sort_updates(port.context, port.oor)
    got = kscan.kscan(port.residual, su, cfg)
    want = kscan.kscan_ref(port.residual, su, cfg)
    assert torch.equal(got.long(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("name,img", CASES, ids=IDS)
def test_cuda_decode_scan_matches_plain_version(cuda, name, img):
    planes, h, w, cfg = _planes(img, cuda)
    words = _word_rows(img, cuda)
    c = planes.shape[0]
    got = codec.decode_scan(words, h, w, cfg, c)
    for plain in (codec.decode_scan_ref, codec.decode_scan_scalar):
        for g, r in zip(got, plain(words, h, w, cfg, c)):
            assert torch.equal(g, r)
    assert torch.equal(got[0][0], planes)
