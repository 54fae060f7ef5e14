"""kernels.roofline_pct's count, by hand at one small shape."""

import pytest

from stereo_bench import work

MATCHER = {"max_level": 14}


def test_direction_count_is_the_frozen_one():
    # per channel: W^2 and its blur (1 + 18), per move the cross product,
    # its blur, the ratio's three operations and the sum (1 + 18 + 4);
    # then two parabola fits and the update (34)
    assert work.DIRECTION_OPS == 3 * (19 + 5 * 23) + 34 == 436
    assert work.SMOOTH_PASS_OPS == 34 and work.AVERAGE_OPS == 30


def test_least_time_by_hand_at_40x60():
    # dims 40x60, 28x42, 19x29, 13x20, 9x14; 8 is below min_dim (6x9)
    dims = [(40, 60), (28, 42), (19, 29), (13, 20), (9, 14)]
    iters = [2, 4, 6, 8, 10]
    passes = [10, 10, 5, 5, 5]
    expect = 0.0
    for (h, w), it, p in zip(dims, iters, passes):
        px = h * w
        per_iter = 6 + 436 + 34 * p + 30
        ops = px * (57 + it * per_iter)
        expect += max(48 * px / 3.35e12, ops / 67e12)
    # blurs of levels 0 .. 2 (6 planes, 18 operations a plane and pixel,
    # 8 bytes a plane and pixel), resamples into levels 1 .. 4 (8 bytes a
    # plane and pixel), upsamples out of levels 1 .. 4 into 0 .. 3
    # (3 planes, 8 bytes and 1 operation a plane and pixel)
    for i, (h, w) in enumerate(dims):
        px = h * w
        if i <= 2:
            expect += max(48 * px / 3.35e12, 108 * px / 67e12)
        if i >= 1:
            expect += 48 * px / 3.35e12
    for (h, w) in dims[:-1]:
        expect += max(24 * h * w / 3.35e12, 3 * h * w / 67e12)
    got = work.match_least_s(MATCHER, (40, 60), False)
    assert len(got["levels"]) == 5
    assert got["least_s"] == pytest.approx(expect, rel=1e-12)


def test_foveated_levels_take_the_fovea_size():
    fov = work.match_least_s({"fovea_level": 3}, (40, 60), True)
    full = work.match_least_s({"fovea_level": 3}, (40, 60), False)
    # levels 0 and 1 run at level 2's 19 x 29
    assert fov["levels"][0] < full["levels"][0]
    assert fov["levels"][2:] == full["levels"][2:]


def test_16mp_levels_are_about_a_millisecond_and_a_half():
    """The levels alone: about 1.4 ms, bound by operations at every
    level (2 iterations of about 810 operations a pixel at 16 MP)."""
    t = work.match_least_s({}, (3264, 4928), False)
    assert 1.3e-3 < sum(t["levels"]) < 1.6e-3
    assert 2.0e-3 < t["least_s"] < 2.8e-3
