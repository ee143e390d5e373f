"""The generator and the draws: the same seed gives the same work."""

import numpy as np

from h100_bench import harness
from h100_bench.traffic import images


def pool(seed, rgb=False, depth=8):
    return images.make_pool(seed, [(24, 32), (16, 16)], [3, 2], rgb, depth, "cpu")


def test_generator_is_deterministic_per_seed():
    for rgb, depth in ((False, 8), (True, 8), (False, 16)):
        a, b = pool(2**31 + 7, rgb, depth), pool(2**31 + 7, rgb, depth)
        extra = (3,) if rgb else ()
        assert [im.shape for im in a] == [(24, 32) + extra] * 3 + [(16, 16) + extra] * 2
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
        assert all(x.dtype == (np.uint8 if depth == 8 else np.uint16) for x in a)


def test_pools_differ_between_seeds():
    a, b = pool(11), pool(12)
    assert not any(np.array_equal(x, y) for x, y in zip(a, b))


def test_rgb_channels_are_correlated_but_differ():
    (im,) = images.make_pool(5, [(64, 64)], [1], True, 8, "cpu")
    r, g, b = (im[..., c].astype(float).ravel() for c in range(3))
    assert np.corrcoef(r, g)[0, 1] > 0.8 and np.corrcoef(r, b)[0, 1] > 0.8
    assert not np.array_equal(r, g) and not np.array_equal(r, b)


def test_images_are_not_saturated():
    (im,) = images.make_pool(9, [(128, 128)], [1], False, 8, "cpu")
    assert np.mean((im == 0) | (im == 255)) < 0.05
    assert im.std() > 20


def test_draws_code_every_image_once_a_pass():
    def take(seed, n):
        stream = harness.draws(seed, 12, 3)
        return [next(stream) for _ in range(n)]

    s = take(2**33 + 1, 12)
    assert s == take(2**33 + 1, 12)
    assert s != take(2**33 + 2, 12)
    for p in range(3):
        assert sorted(i for call in s[4 * p : 4 * p + 4] for i in call) == list(range(12))
    assert s[:4] != s[4:8]  # every pass groups the pool afresh


def test_draws_refuse_ragged_mixes():
    import pytest

    with pytest.raises(harness.RunError):
        next(harness.draws(1, 10, 3))
