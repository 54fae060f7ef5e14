"""The resample wrapper's host side on the CPU: the packed tap upload, the
bilinear kernel's launch shapes, the size limit of its 32-bit offsets,
and resample_tex (windows included) against the JAX package's
interpret-mode kernel.

Nearest is exact against the interpret-mode kernel; bilinear matches it
to 2e-6 (its one-hot matmuls add the same terms in another order, as in
tests/test_torch_kernels.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ug_stereomatcher_tpu.ops.pallas.resample import resample_tex as p_resample
from ug_stereomatcher_tpu_torch.config import MatcherConfig
from ug_stereomatcher_tpu_torch.ops.cuda import resample
from ug_stereomatcher_tpu_torch.ops.resample import (
    bilinear_taps,
    nearest_indices,
    resample_static_plain,
)

SCALE = 1.41421356
H100_SMS = 132


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------ packed upload
def test_packed_taps_round_trip_bit_for_bit():
    (iy, wy), (ix, wx) = (bilinear_taps(97, 68, lambda v: v / SCALE),
                          bilinear_taps(211, 149, lambda v: v / SCALE))
    # weights whose bits a float round trip could change
    wx = wx.copy()
    wx[:6] = np.array([-0.0, np.nan, np.inf, 1e-45, -3.5, 0.999999],
                      dtype=np.float32)
    out = resample.upload_taps(torch.device("cpu"), (iy, ix, wy, wx))
    assert [t.dtype for t in out] == [torch.int32, torch.int32,
                                      torch.float32, torch.float32]
    for t, a in zip(out, (iy, ix, wy, wx)):
        assert t.is_contiguous() and t.shape == a.shape
        np.testing.assert_array_equal(t.numpy().view(np.int32),
                                      a.view(np.int32))


def test_packed_nearest_taps_round_trip():
    iy = nearest_indices(5, 9, lambda v: v * 2.0)
    ix = nearest_indices(300, 600, lambda v: v * 2.0, 7)
    a, b = resample.upload_taps(torch.device("cpu"), (iy, ix))
    np.testing.assert_array_equal(a.numpy(), iy)
    np.testing.assert_array_equal(b.numpy(), ix)


@pytest.mark.parametrize("bad", [np.zeros(4), np.zeros((2, 2), np.int32),
                                 np.zeros(3, np.int64)])
def test_packed_upload_refuses_other_arrays(bad):
    with pytest.raises(ValueError, match="upload_taps"):
        resample.upload_taps(torch.device("cpu"),
                             (np.zeros(3, np.int32), bad))


# ------------------------------------------------------ launch shapes
def main_path_outputs():
    """Every (C, H2, W2) bilinear output of a 16 MP match (the sqrt(2) and
    x2 subsamples of the 6-plane stack, the 3-plane upsample), the range
    map of a resized cloud and the fovea window."""
    cfg = MatcherConfig()
    chain = cfg.dims_chain(3264, 4928)
    outs = {(6,) + chain[i] for i in range(1, len(chain))}
    outs |= {(6,) + chain[i] for i in range(2, len(chain))}
    outs |= {(3,) + chain[i] for i in range(len(chain) - 1)}
    outs |= {(1, 652, 985), (3,) + cfg.fovea_dims(3264, 4928)}
    return sorted(outs)


def blocks(c, h2, w2, shape):
    rows, planes, warps = shape
    return (-(-w2 // resample.COLUMN_SPAN)
            * min(-(-h2 // (rows * warps)), resample.MAX_GRID_Y)
            * -(-c // planes))


def test_launch_shape_fills_the_card_at_every_main_path_shape():
    """Two blocks an SM at the 16 MP levels down to level 10 (100 x 152;
    the three coarsest levels hold too few rows and columns), the range
    map and the fovea window."""
    for c, h2, w2 in main_path_outputs():
        shape = resample.bilinear_launch(c, h2, w2, H100_SMS)
        rows, planes, warps = shape
        assert rows in resample.STRIP_ROWS and warps in resample.BLOCK_WARPS
        assert 1 <= planes <= c
        if h2 * w2 >= 100 * 152:
            assert blocks(c, h2, w2, shape) >= 2 * H100_SMS, (c, h2, w2)


def test_launch_shape_at_16mp_is_the_tallest_strip_over_every_plane():
    cfg = MatcherConfig()
    chain = cfg.dims_chain(3264, 4928)
    for c, (h2, w2) in ((6, chain[1]), (6, chain[2]), (3, chain[0])):
        assert resample.bilinear_launch(c, h2, w2, H100_SMS) == (4, c, 8)
    # the range map: shorter strips, one plane
    assert resample.bilinear_launch(1, 652, 985, H100_SMS) == (2, 1, 8)


def test_launch_shape_gives_up_work_in_order():
    """Shorter strips first, then fewer planes a block, then fewer warps;
    the smallest shape where nothing fills the card."""
    seen = [resample.bilinear_launch(6, h2, 4928, H100_SMS)
            for h2 in (3000, 500, 130, 70, 8, 2)]
    assert seen[0] == (4, 6, 8) and seen[-1] == (1, 1, 1)
    assert resample.bilinear_launch(6, 101, 153, H100_SMS) == (1, 1, 4)
    for c, h2, w2 in ((6, 2307, 3484), (1, 652, 985), (6, 101, 153)):
        shape = resample.bilinear_launch(c, h2, w2, H100_SMS)
        assert blocks(c, h2, w2, shape) >= 2 * H100_SMS


def test_bilinear_kernel_refuses_planes_past_32_bit_offsets():
    """Checked before any allocation or launch (meta tensors hold no
    memory)."""
    meta = torch.device("meta")
    iy = torch.empty(8, dtype=torch.int32, device=meta)
    ix = torch.empty(8, dtype=torch.int32, device=meta)
    w = torch.empty(8, dtype=torch.float32, device=meta)
    big = torch.empty((2, 2 ** 15, 2 ** 15), device=meta)
    with pytest.raises(ValueError, match="2\\^31"):
        resample._launch(big, iy, ix, 1.0, w, w)
    img = torch.empty((2, 8, 8), device=meta)
    tall = torch.empty(2 ** 16, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="2\\^31"):
        resample._launch(img, tall, tall, 1.0,
                         tall.float(), tall.float())


def test_resample_static_checks_its_arguments():
    x = torch.zeros(3, 8, 10)
    i = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="both"):
        resample.resample_static(x, i, i, 1.0, torch.zeros(4))
    with pytest.raises(ValueError, match="expected"):
        resample.resample_static(x[0], i, i)
    with pytest.raises(ValueError, match="expected"):
        resample.resample_tex(x[0], 4, 5, lambda v: v * 2.0)


# ------------------------------------------- resample_tex against JAX
WINDOW_CASES = {
    # (source shape, window shape, row_off, col_off, coordinate scale,
    # value scale)
    "fovea_centre": ((3, 37, 53), (37, 53), 7, 11, 1.0 / SCALE, SCALE),
    "fovea_corner": ((3, 37, 53), (37, 53), 15, 22, 1.0 / SCALE, SCALE),
    "subsample_window": ((6, 97, 211), (20, 70), 13, 40, SCALE, 1.0),
    "range_map_x5": ((1, 163, 247), (32, 49), 0, 0, 5.0, 1.0),
}


@pytest.mark.parametrize("method", ["nearest", "bilinear"])
@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_resample_tex_window_matches_pallas(case, method):
    shape, (h2, w2), r0, c0, s, vs = WINDOW_CASES[case]
    img = np.random.RandomState(5).uniform(-3, 3, shape).astype(np.float32)

    def coord_of(v):
        return v * s
    ref = np.asarray(p_resample(jnp.asarray(img), h2, w2, coord_of, vs,
                                method, interpret=True, row_off=r0,
                                col_off=c0))
    out = resample.resample_tex(torch.from_numpy(img), h2, w2, coord_of, vs,
                                method, row_off=r0, col_off=c0).numpy()
    if method == "nearest":
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=2e-6, atol=2e-6)
    # the CPU path is the plain version on the host taps
    (iy, wy), (ix, wx) = (bilinear_taps(h2, shape[1], coord_of, r0),
                          bilinear_taps(w2, shape[2], coord_of, c0))
    if method == "bilinear":
        plain = resample_static_plain(
            torch.from_numpy(img), *(torch.from_numpy(a)
                                     for a in (iy, ix)), vs,
            *(torch.from_numpy(a) for a in (wy, wx))).numpy()
        np.testing.assert_array_equal(out, plain)
