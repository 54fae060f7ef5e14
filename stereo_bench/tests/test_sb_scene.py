"""The pairs come from the seed: the same seed gives the same pairs,
another seed other pairs, and every seed the same disparity range."""

import numpy as np
import torch

from stereo_bench import scene

DISP = {"h_px": [0, 32], "v_px": [-4, 4], "at_width": 4928, "h_waves": 2,
        "cycles": [0.5, 2.0]}


def test_same_seed_same_pairs_other_seed_other_pairs():
    a = scene.make_pool(2, 1, (48, 64), 2 ** 31 + 11, DISP, "cpu")
    b = scene.make_pool(2, 1, (48, 64), 2 ** 31 + 11, DISP, "cpu")
    c = scene.make_pool(2, 1, (48, 64), 2 ** 31 + 12, DISP, "cpu")
    for (la, ra), (lb, rb) in zip(a, b):
        assert la.dtype == np.uint8 and la.shape == (48, 64, 3)
        assert np.array_equal(la, lb) and np.array_equal(ra, rb)
    assert not np.array_equal(a[0][0], c[0][0])
    # the pool's entries differ from each other
    assert not np.array_equal(a[0][0], a[1][0])


def test_a_batch_entry_holds_distinct_pairs():
    (lft, rgt), = scene.make_pool(1, 3, (32, 48), 5, DISP, "cpu")
    assert lft.shape == (3, 32, 48, 3) and rgt.shape == lft.shape
    assert not np.array_equal(lft[0], lft[1])


def test_the_field_spans_the_mix_range_scaled_with_the_width():
    for seed in (1, 2, 3):
        gen = scene.generator(seed, "cpu")
        params = torch.rand(10, generator=gen)
        f = scene._field(40, 1232, params, 2, 0.0, 8.0, (0.5, 2.0))
        assert abs(f.min().item()) < 1e-5
        assert abs(f.max().item() - 8.0) < 1e-4


def test_the_right_image_is_the_left_shifted():
    """A constant 3 px field: right(x + 3) == left(x) inside the frame."""
    disp = dict(DISP, h_px=[3, 3 + 1e-6], v_px=[0, 1e-6], at_width=64)
    (lft, rgt), = scene.make_pool(1, 1, (32, 64), 9, disp, "cpu")
    lft, rgt = lft.astype(int), rgt.astype(int)
    assert np.abs(rgt[:, 3 + 4:60] - lft[:, 4:57]).max() <= 1
