"""The roofline's counts come from the images and the container bytes
alone: the same images give the same counts whatever width, capacity or
tile layout the code under test picks on the way."""

import numpy as np

from h100_bench import roofline
from h100_bench.reference import flct_ref
from h100_bench.traffic import images


def counts(ims, blobs):
    b = o = 0
    for im, blob in zip(ims, blobs):
        nb, no = roofline.image_work(im.shape, im.dtype.itemsize,
                                     flct_ref.read_container(blob).payload_bytes)
        b, o = b + nb, o + no
    return b, o


def test_counts_do_not_depend_on_the_ports_widths(monkeypatch):
    from felics_tpu_torch import compress_tiled_batch
    from felics_tpu_torch.config import TileConfig
    from felics_tpu_torch.ops import tile_codec
    from felics_tpu_torch.parallel import tiling

    ims = images.make_pool(8, [(20, 28)], [2], True, 8, "cpu")
    first = compress_tiled_batch(ims, TileConfig(8, 8), device="cpu")
    # a width and a capacity far too small: the port relaunches and
    # compacts again, and its planes take another width
    monkeypatch.setattr(tile_codec, "width_hint", lambda *a: 64)
    monkeypatch.setattr(tiling, "payload_cap_hint", lambda *a: 64)
    second = compress_tiled_batch(ims, TileConfig(8, 8), device="cpu")
    assert second == first
    assert counts(ims, first) == counts(ims, second)


def test_counts_are_the_images_and_the_payload():
    (im,) = images.make_pool(2, [(16, 24)], [1], False, 16, "cpu")
    blob = flct_ref.encode_image(im, (8, 8), "cpu")
    pay = flct_ref.read_container(blob).payload_bytes
    assert roofline.image_work(im.shape, 2, pay) == (16 * 24 * 2 + pay,
                                                     roofline.OPS_PER_SAMPLE * 16 * 24)
    # tile padding is not counted: a larger tile on the same image
    blob64 = flct_ref.encode_image(im, (64, 64), "cpu")
    assert roofline.image_work(im.shape, 2, 0) == roofline.image_work(im.shape, 2, 0)
    assert flct_ref.read_container(blob64).payload_bytes > 0


def test_least_seconds_is_the_larger_term():
    assert roofline.least_seconds(3.35e12, 0) == 1.0
    assert roofline.least_seconds(0, 67e12) == 1.0
    assert np.isclose(roofline.call_least_seconds([(10, 10)], 1, [50]),
                      max(150 / 3.35e12, 1000 / 67e12))
