"""The FLCS kernels K3 (felics_tpu_torch/csrc/flcs_kscan.cu) and K4
(felics_tpu_torch/csrc/flcs_decode.cu) against their plain versions, K4
and its plain version against the port's scalar oracle (core/oracle.py),
the two plain versions of K4 against each other, and where K4 keeps its
state.

This module imports no JAX and nothing of felics_tpu, so it runs on a card
as well as here: inputs
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

from felics_tpu_torch import api
from felics_tpu_torch.config import config_for_depth
from felics_tpu_torch.coding import BitReader
from felics_tpu_torch.core import codec, oracle
from felics_tpu_torch.format import header_for_array
from felics_tpu_torch.ops import _build, analysis, kscan

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
    ("gray8 2x2", _image(9, (2, 2), np.uint8, False)),
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


def _oracle_decode(img, h, w, cfg, c):
    """The image's FLCS payload decoded channel by channel on the port's
    oracle: (C, H*W) int32 planes and the bit it ended at."""
    payload = api.compress_image_bytes(img, backend="oracle")[14:]
    reader = BitReader(payload)
    planes = [oracle.decompress_channel(w, h, cfg, reader) for _ in range(c)]
    return torch.from_numpy(np.stack(planes).astype(np.int32)), reader.bit_position


@pytest.mark.parametrize("name,img", CASES, ids=IDS)
def test_oracle_decodes_as_the_plain_scan(name, img):
    planes, h, w, cfg = _planes(img, CPU)
    words = _word_rows(img, CPU)
    c = planes.shape[0]
    got = codec.decode_scan_scalar(words, h, w, cfg, c)
    want, end = _oracle_decode(img, h, w, cfg, c)
    assert torch.equal(got[0][0], want) and torch.equal(want, planes)
    assert int(got[1][0]) == end


@pytest.mark.cuda
@pytest.mark.parametrize("name,img", CASES, ids=IDS)
def test_cuda_decode_scan_matches_the_oracle(cuda, name, img):
    planes, h, w, cfg = _planes(img, cuda)
    words = _word_rows(img, cuda)
    c = planes.shape[0]
    got = codec.decode_scan(words, h, w, cfg, c)
    want, end = _oracle_decode(img, h, w, cfg, c)
    assert torch.equal(got[0][0].cpu(), want) and int(got[1][0]) == end


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


@pytest.mark.parametrize("K,max_context,width,limit,want", [
    (6, 510, 512, 232448, (8, True, True)),
    (6, 510, 60000, 232448, (8, True, False)),
    (15, 131070, 512, 232448, (16, False, True)),
    (15, 131070, 58111, 232448, (16, False, True)),
    (15, 131070, 58112, 232448, (16, False, False)),
    (6, 510, 512, 48 * 1024, (8, True, True)),
])
def test_decode_layout(K, max_context, width, limit, want):
    """The 8-bit k-table (16,352 bytes) sits in shared memory, the 16-bit
    one (8.4 MB) does not; the row ring takes what is left, up to the
    block's limit, and a wider row goes to global scratch."""
    assert codec.decode_layout(K, max_context, width, limit) == want


def _decode_against_scalar(words, h, w, cfg, c, plains):
    got = codec.decode_scan(words, h, w, cfg, c)
    for plain in plains:
        for g, r in zip(got, plain(words, h, w, cfg, c)):
            assert torch.equal(g, r)
    return got


@pytest.mark.cuda
def test_cuda_decode_scan_wide_row(cuda):
    """A row too wide for the shared ring: K4 keeps it in global scratch."""
    from felics_tpu_torch.ops import _build

    img = _image(10, (2, 60000), np.uint8, True)
    planes, h, w, cfg = _planes(img, cuda)
    limit = _build.library().flcs_decode_smem_limit()
    assert not codec.decode_layout(cfg.num_k, cfg.max_context, w, limit)[2]
    payload = api.compress_image_bytes(img, device=cuda)[14:]
    words = torch.from_numpy(codec.payload_words([payload]).view(np.int32)).to(cuda)
    got = _decode_against_scalar(words, h, w, cfg, 1, (codec.decode_scan_scalar,))
    assert torch.equal(got[0][0], planes)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_cuda_decode_scan_unequal_lanes(cuda, dtype):
    """Lanes of unequal payload length in one launch, plus a corrupt row."""
    imgs = [_image(11, (20, 30), dtype, True), _image(12, (20, 30), dtype, False),
            np.zeros((20, 30), dtype)]
    payloads = [api.compress_image_bytes(im, device=cuda)[14:] for im in imgs]
    assert len({len(p) for p in payloads}) == 3
    corrupt = bytearray(payloads[1])
    corrupt[len(corrupt) // 3] ^= 0x5A
    rows = codec.payload_words(payloads + [bytes(corrupt)])
    words = torch.from_numpy(rows.view(np.int32)).to(cuda)
    cfg = config_for_depth(header_for_array(imgs[0]).pixel_depth)
    got = _decode_against_scalar(words, 20, 30, cfg, 1,
                                 (codec.decode_scan_ref, codec.decode_scan_scalar))
    for i, im in enumerate(imgs):
        assert np.array_equal(got[0][i, 0].cpu().numpy(), im.reshape(-1).astype(np.int32))


def _one_context_updates(cuda, contexts, seed):
    rng = np.random.default_rng(seed)
    G, n = contexts.shape
    residual = torch.from_numpy(rng.integers(0, 256, (G, n)).astype(np.int32)).to(cuda)
    context = torch.from_numpy(contexts).to(cuda)
    oor = torch.ones((G, n), dtype=torch.bool, device=cuda)
    return residual, kscan.sort_updates(context, oor)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["one long segment", "one-update segments"])
def test_cuda_kscan_segment_shapes(cuda, shape):
    """K3 on a single segment of 5,000 updates per lane, and on 5,000
    segments of one update each."""
    from felics_tpu_torch.config import CONFIG_8BIT

    G, n = 2, 5000
    contexts = (np.zeros((G, n), np.int64) if shape == "one long segment"
                else np.tile(np.arange(n, dtype=np.int64)[::-1], (G, 1)))
    residual, su = _one_context_updates(cuda, contexts, 3)
    assert int(su.max_rank.max()) == (n if shape == "one long segment" else 1)
    got = kscan.kscan(residual, su, CONFIG_8BIT)
    assert torch.equal(got.long(), kscan.kscan_ref(residual, su, CONFIG_8BIT))


@pytest.mark.parametrize("K,ok", [(5, False), (6, True), (15, True), (16, False)])
def test_kernels_take_the_shipped_k_counts(K, ok):
    """The CUDA kernels are compiled for K = 6 (8-bit) and K = 15 (16-bit)
    only; any other K raises before a launch."""
    if ok:
        _build.check_kernel_k(K)
    else:
        with pytest.raises(ValueError, match="K in"):
            _build.check_kernel_k(K)


# The edges of the 0..20 x 0..20 grid: rows 0, 1, 2 and 20, every width
# 0..20, per class. Images of fewer than 2 pixels take the raw path and
# launch nothing.
EDGE_ROWS = (0, 1, 2, 20)
EDGE_CLASSES = {"gray8": (np.uint8, ()), "gray16": (np.uint16, ()),
                "rgb8": (np.uint8, (3,)), "rgb16": (np.uint16, (3,))}


def _edge_row(h, cls):
    dtype, extra = EDGE_CLASSES[cls]
    rng = np.random.default_rng([h, list(EDGE_CLASSES).index(cls)])
    hi = np.iinfo(dtype).max + 1
    return [rng.integers(0, hi, (h, w) + extra).astype(dtype) for w in range(21)]


@pytest.mark.parametrize("cls", list(EDGE_CLASSES))
@pytest.mark.parametrize("h", EDGE_ROWS)
def test_plain_versions_on_edge_rows(h, cls):
    """The batched API on the CPU writes the oracle's bytes for the whole
    row, and the scalar plain version of K4 decodes each payload of 2 or
    more pixels to its planes, ending where the oracle ends."""
    images = _edge_row(h, cls)
    blobs = api.compress_images_bytes(images, device=CPU)
    for img, blob in zip(images, blobs):
        assert blob == api.compress_image_bytes(img, backend="oracle"), img.shape
        if img.shape[0] * img.shape[1] < 2:
            continue
        planes, ih, iw, cfg = _planes(img, CPU)
        words = torch.from_numpy(codec.payload_words([blob[14:]]).view(np.int32))
        got = codec.decode_scan_scalar(words, ih, iw, cfg, planes.shape[0])
        want, end = _oracle_decode(img, ih, iw, cfg, planes.shape[0])
        assert torch.equal(got[0][0], planes) and torch.equal(want, planes)
        assert int(got[1][0]) == end and not bool(got[2][0])


@pytest.mark.cuda
@pytest.mark.parametrize("cls", list(EDGE_CLASSES))
@pytest.mark.parametrize("h", EDGE_ROWS)
def test_cuda_kernels_on_edge_rows(cuda, h, cls):
    """K3 and K4 on every shape of the row equal their plain versions (K4
    the scalar one, and the tensor one up to 40 pixels), to the k, plane,
    end bit and overrun flag; the batched API on the card
    writes the oracle's bytes and decodes them exactly, and a row with no
    image of 2 or more pixels launches no kernel."""
    images = _edge_row(h, cls)
    before = kscan.LAUNCHES, codec.DECODE_LAUNCHES
    blobs = api.compress_images_bytes(images, device=cuda)
    outs = api.decompress_images_bytes(blobs, device=cuda)
    scans = sum(im.shape[0] * im.shape[1] >= 2 for im in images)
    assert codec.DECODE_LAUNCHES - before[1] == scans
    assert (kscan.LAUNCHES - before[0] == 0) if scans == 0 else (kscan.LAUNCHES > before[0])
    for img, blob, out in zip(images, blobs, outs):
        assert blob == api.compress_image_bytes(img, backend="oracle"), img.shape
        assert out.dtype == img.dtype and np.array_equal(out, img)
        if img.shape[0] * img.shape[1] < 2:
            continue
        planes, ih, iw, cfg = _planes(img, cuda)
        c = planes.shape[0]
        port = analysis.analyze_channel(planes, ih, iw)
        su = kscan.sort_updates(port.context, port.oor)
        assert torch.equal(kscan.kscan(port.residual, su, cfg).long(),
                           kscan.kscan_ref(port.residual, su, cfg))
        words = torch.from_numpy(codec.payload_words([blob[14:]]).view(np.int32)).to(cuda)
        # the tensor plain version takes milliseconds a pixel on a card
        plains = (codec.decode_scan_scalar,) + ((codec.decode_scan_ref,) if ih * iw <= 40 else ())
        got = _decode_against_scalar(words, ih, iw, cfg, c, plains)
        assert torch.equal(got[0][0], planes)
