"""The port's plain ops against ``ug_stereomatcher_tpu.ops`` on the same
numpy inputs.  Nearest gathers, shifts and resamples are exact; blurs,
pointwise ops and the bilinear gathers are held to rtol=atol=1e-6 (the
<= 1 ulp FMA contract of the JAX blur, ops/pallas/blur.py:12-18, and the
JAX package's own bound for its bilinear warp,
tests/test_pallas_kernels.py:74)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ug_stereomatcher_tpu import ops as J
from ug_stereomatcher_tpu.config import MOVES, average_kernel, gaussian_kernel
from ug_stereomatcher_tpu.ops.pallas.resample import _bilinear_taps
from ug_stereomatcher_tpu_torch.ops import conv as tconv
from ug_stereomatcher_tpu_torch.ops import pointwise as tpw
from ug_stereomatcher_tpu_torch.ops import resample as trs
from ug_stereomatcher_tpu_torch.ops import smooth as tsm

SCALE = 1.41421356
TOL = dict(rtol=1e-6, atol=1e-6)


def rand(*shape, seed=0, lo=0.0, hi=1.0):
    rng = np.random.RandomState(seed)
    return (lo + (hi - lo) * rng.rand(*shape)).astype(np.float32)


def port(fn, *arrays, **kw):
    out = fn(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
               for a in arrays), **kw)
    return out.numpy()


def ref(fn, *arrays, **kw):
    return np.asarray(fn(*(jnp.asarray(a) if isinstance(a, np.ndarray)
                           else a for a in arrays), **kw))


@pytest.mark.parametrize("boundary", ["zero", "clamp"])
@pytest.mark.parametrize("axis", [-1, -2])
@pytest.mark.parametrize("taps", ["gauss", "average"])
def test_conv1d(boundary, axis, taps):
    k = gaussian_kernel() if taps == "gauss" else average_kernel()
    x = rand(3, 17, 23, seed=1)
    np.testing.assert_allclose(
        port(tconv.conv1d, x, kernel=k, axis=axis, boundary=boundary),
        ref(J.conv.conv1d, x, kernel=k, axis=axis, boundary=boundary), **TOL)


@pytest.mark.parametrize("name", ["blur_gaussian_zero", "blur_gaussian_clamp",
                                  "blur_average_clamp"])
@pytest.mark.parametrize("shape", [(3, 19, 26), (6, 9, 41), (12, 10)])
def test_blurs(name, shape):
    x = rand(*shape, seed=2, hi=255.0)
    np.testing.assert_allclose(port(getattr(tconv, name), x),
                               ref(getattr(J, name), x), **TOL)


@pytest.mark.parametrize("dx,dy", list(MOVES) + [(2, -3), (-4, 1)])
def test_shift_image_exact(dx, dy):
    x = rand(3, 11, 14, seed=3)
    np.testing.assert_array_equal(port(trs.shift_image, x, dx=dx, dy=dy),
                                  ref(J.shift_image, x, dx=dx, dy=dy))


@pytest.mark.parametrize("scale,h2,w2", [
    (SCALE, int(97 / SCALE), int(211 / SCALE)),
    (2.0, 48, 105),
])
def test_subsample_exact(scale, h2, w2):
    x = rand(6, 97, 211, seed=4)
    np.testing.assert_array_equal(
        port(trs.subsample, x, out_h=h2, out_w=w2, scale=scale),
        ref(J.subsample, x, out_h=h2, out_w=w2, scale=scale))


@pytest.mark.parametrize("h,w,h2,w2", [(34, 49, 48, 70), (9, 13, 13, 18)])
def test_upsample_disp_exact(h, w, h2, w2):
    d = rand(3, h, w, seed=5, lo=-4.0, hi=4.0)
    kw = dict(out_h=h2, out_w=w2, scale=1.0 / SCALE, value_scale=SCALE)
    np.testing.assert_array_equal(port(trs.upsample_disp, d, **kw),
                                  ref(J.upsample_disp, d, **kw))


def test_resample_coords_window_exact():
    d = rand(3, 30, 40, seed=6)
    kw = dict(out_h=12, out_w=15, coord_of=lambda t: t / SCALE,
              value_scale=SCALE, row_off=9, col_off=13)
    np.testing.assert_array_equal(port(trs.resample_coords, d, **kw),
                                  ref(J.resample.resample_coords, d, **kw))


def test_value_scale_matches_jax_rounding():
    """`1.41421356 * t` rounds the Python double to float32 as JAX does."""
    t = rand(1000, seed=7, lo=-50.0, hi=50.0)
    np.testing.assert_array_equal((SCALE * torch.from_numpy(t)).numpy(),
                                  np.asarray(SCALE * jnp.asarray(t)))


WARP_FIELDS = {
    "in_range": lambda h, w, r: ((r.rand(h, w) - 0.5) * 6,
                                 (r.rand(h, w) - 0.5) * 3),
    "off_left": lambda h, w, r: (-w - 5 + r.rand(h, w), r.rand(h, w) - 0.5),
    "off_right": lambda h, w, r: (w + 5 + r.rand(h, w), r.rand(h, w) - 0.5),
    "off_top": lambda h, w, r: (r.rand(h, w) - 0.5, -h - 3 + r.rand(h, w)),
    "off_bottom": lambda h, w, r: (r.rand(h, w) - 0.5, h + 3 + r.rand(h, w)),
    "wild": lambda h, w, r: ((r.rand(h, w) - 0.5) * 4 * w,
                             (r.rand(h, w) - 0.5) * 4 * h),
    "half_texel": lambda h, w, r: (np.round(r.rand(h, w) * 8) / 2 - 2,
                                   np.round(r.rand(h, w) * 8) / 2 - 2),
}


@pytest.mark.parametrize("field", sorted(WARP_FIELDS))
def test_warp_by_disparity_exact(field):
    h, w = 21, 33
    rng = np.random.RandomState(8)
    img = rand(3, h, w, seed=9)
    dh, dv = (a.astype(np.float32) for a in WARP_FIELDS[field](h, w, rng))
    np.testing.assert_array_equal(port(trs.warp_by_disparity, img, dh, dv),
                                  ref(J.warp_by_disparity, img, dh, dv))


def test_tex_gather_exact():
    img = rand(2, 10, 12, seed=10)
    rng = np.random.RandomState(11)
    x = (rng.rand(5, 7) * 16 - 2).astype(np.float32)
    y = (rng.rand(5, 7) * 14 - 2).astype(np.float32)
    np.testing.assert_array_equal(port(trs.tex_gather, img, x, y),
                                  ref(J.tex_gather, img, x, y))


def test_cubic_raises():
    """The kernel wrappers refuse cubic, as the JAX package's Pallas
    kernels do; the plain ops compute it, as the JAX package's ops do
    (the geometry's range-map resize)."""
    from ug_stereomatcher_tpu_torch.ops.cuda import resample as cres
    from ug_stereomatcher_tpu_torch.ops.cuda import warp as cwarp
    img = torch.zeros(3, 4, 4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cwarp.warp(img, img[0], img[0], "cubic")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cres.resample_tex(img, 2, 2, lambda t: t * 2.0, method="cubic")
    x = rand(3, 9, 11, seed=24, hi=8.0)
    dh, dv = rand(9, 11, seed=25, lo=-2, hi=2), rand(9, 11, seed=26)
    np.testing.assert_allclose(
        port(trs.warp_by_disparity, x, dh, dv, "cubic"),
        ref(J.warp_by_disparity, x, dh, dv, "cubic"), **TOL)
    np.testing.assert_allclose(port(trs.subsample, x, 4, 5, 2.0, "cubic"),
                               ref(J.subsample, x, 4, 5, 2.0, "cubic"),
                               **TOL)


@pytest.mark.parametrize("field", sorted(WARP_FIELDS))
def test_warp_by_disparity_bilinear(field):
    h, w = 21, 33
    rng = np.random.RandomState(22)
    img = rand(3, h, w, seed=23, hi=255.0)
    dh, dv = (a.astype(np.float32) for a in WARP_FIELDS[field](h, w, rng))
    np.testing.assert_allclose(
        port(trs.warp_by_disparity, img, dh, dv, method="bilinear"),
        ref(J.warp_by_disparity, img, dh, dv, method="bilinear"), **TOL)


def test_tex_gather_bilinear():
    img = rand(2, 10, 12, seed=24, hi=4.0)
    rng = np.random.RandomState(25)
    x = (rng.rand(5, 7) * 16 - 2).astype(np.float32)
    y = (rng.rand(5, 7) * 14 - 2).astype(np.float32)
    np.testing.assert_allclose(port(trs.tex_gather, img, x, y, "bilinear"),
                               ref(J.tex_gather, img, x, y, "bilinear"), **TOL)


@pytest.mark.parametrize("scale,h2,w2", [
    (SCALE, int(97 / SCALE), int(211 / SCALE)),
    (2.0, 48, 105),
])
def test_subsample_bilinear(scale, h2, w2):
    x = rand(6, 97, 211, seed=26, hi=255.0)
    kw = dict(out_h=h2, out_w=w2, scale=scale, method="bilinear")
    np.testing.assert_allclose(port(trs.subsample, x, **kw),
                               ref(J.subsample, x, **kw), **TOL)


@pytest.mark.parametrize("h,w,h2,w2", [(34, 49, 48, 70), (9, 13, 13, 18)])
def test_upsample_disp_bilinear(h, w, h2, w2):
    d = rand(3, h, w, seed=27, lo=-4.0, hi=4.0)
    kw = dict(out_h=h2, out_w=w2, scale=1.0 / SCALE, value_scale=SCALE,
              method="bilinear")
    np.testing.assert_allclose(port(trs.upsample_disp, d, **kw),
                               ref(J.upsample_disp, d, **kw), **TOL)


def test_resample_coords_window_bilinear():
    d = rand(3, 30, 40, seed=28)
    kw = dict(out_h=12, out_w=15, coord_of=lambda t: t / SCALE,
              value_scale=SCALE, method="bilinear", row_off=9, col_off=13)
    np.testing.assert_allclose(port(trs.resample_coords, d, **kw),
                               ref(J.resample.resample_coords, d, **kw), **TOL)


@pytest.mark.parametrize("n_out,n_in,coord", [
    (68, 97, lambda t: t * SCALE),       # subsample, collapse at the end
    (48, 97, lambda t: t * 2.0),
    (97, 68, lambda t: t / SCALE),       # upsample, collapse at both ends
    (3, 2, lambda t: t * 0.4),
])
def test_bilinear_taps_equal_jax(n_out, n_in, coord):
    i0, w = trs.bilinear_taps(n_out, n_in, coord)
    j0, jw = _bilinear_taps(n_out, n_in, coord)
    assert i0.dtype == j0.dtype == np.int32 and w.dtype == jw.dtype
    np.testing.assert_array_equal(i0, j0)
    np.testing.assert_array_equal(w, jw)
    assert ((0 <= i0) & (i0 < n_in)).all()


def test_correlation_ratio_with_zero_denominators():
    bc = rand(3, 8, 9, seed=12, lo=-2.0, hi=2.0)
    l2 = rand(3, 8, 9, seed=13)
    w2 = rand(3, 8, 9, seed=14)
    l2[0, :2] = 0.0   # x/0 -> inf -> 1
    bc[1, :2] = 0.0
    w2[1, :2] = 0.0   # 0/0 -> NaN passes through
    out = port(tpw.correlation_ratio, bc, l2, w2)
    np.testing.assert_allclose(out, ref(J.correlation_ratio, bc, l2, w2),
                               equal_nan=True, **TOL)
    assert np.isnan(out[1, :2]).all() and (out[0, :2][bc[0, :2] != 0] == 1).all()


@pytest.mark.parametrize("threshold", [1.0, 0.55, 0.1])
def test_parabola_fit(threshold):
    l, c, r = (rand(9, 31, seed=s) for s in (15, 16, 17))
    c[0, :5] = np.nan     # NaN -> no peak -> (0, conf_no_peak)
    c[1, :5] = 1.0        # cstar > 1 branch
    consts = (0.35, 0.25, 0.75)  # non-default on purpose
    ours = tpw.parabola_fit(*(torch.from_numpy(v) for v in (l, c, r)),
                            threshold, *consts)
    theirs = J.parabola_fit(*(jnp.asarray(v) for v in (l, c, r)),
                            jnp.float32(threshold), *consts)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    offset, conf = (x.numpy() for x in ours)
    assert (offset[0, :5] == 0).all() and (conf[0, :5] == np.float32(0.35)).all()


def test_blend_confidence():
    new = rand(6, 7, seed=18, lo=-0.5, hi=1.5)
    old = rand(6, 7, seed=19, lo=-0.5, hi=1.5)
    np.testing.assert_allclose(
        port(tpw.blend_confidence, new, old, w_new=0.7, w_old=0.3),
        ref(J.blend_confidence, new, old, w_new=0.7, w_old=0.3), **TOL)


@pytest.mark.parametrize("shape", [(3, 12, 17), (12, 17)])
def test_weighted_smooth(shape):
    disp = rand(*shape, seed=20, lo=-3.0, hi=3.0)
    conf = rand(*shape[-2:], seed=21, lo=0.05, hi=1.0)
    np.testing.assert_allclose(port(tsm.weighted_smooth, disp, conf),
                               ref(J.weighted_smooth, disp, conf), **TOL)
