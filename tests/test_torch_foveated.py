"""Mode 2 of the port (the foveated stack, the hierarchical map and the
foveated batch) against the JAX package on the CPU.

Shapes stay small (72 x 96 and 96 x 128 with ``fovea_level`` = 3, inputs
from numpy seeds).  Tolerances, as in tests/test_torch_match.py:

* the foveated pyramid, the windowed resample, the nearest fovea
  transition and the nearest hierarchical map: bit for bit;
* the bilinear fovea transition and hierarchical map: 5e-5 (and 5e-5
  relative on the hierarchical map, whose values grow by SCALE a
  level), the port's host float64 taps against the JAX CPU path's
  float32 ``tex_gather`` (ops/cuda/resample.py);
* whole levels in lockstep, and free-running stacks, under the repo's
  quantile rule;
* the foveated batch on every route, and the row-sharded foveated pair,
  against the port's own unsharded mode 2: bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_match import (
    assert_lockstep_close,
    jax_level_body_unjitted,
    synthetic_pair,
)
from ug_stereomatcher_tpu import StereoEngine as JaxEngine
from ug_stereomatcher_tpu import match as jmatch
from ug_stereomatcher_tpu import pyramid as jpyr
from ug_stereomatcher_tpu.config import MatcherConfig as JaxConfig
from ug_stereomatcher_tpu.ops import resample as jres
from ug_stereomatcher_tpu_torch import MatcherConfig, StereoEngine
from ug_stereomatcher_tpu_torch import match as tmatch
from ug_stereomatcher_tpu_torch import parallel as par
from ug_stereomatcher_tpu_torch import pyramid as tpyr
from ug_stereomatcher_tpu_torch.engine import _check_fovea
from ug_stereomatcher_tpu_torch.ops import resample as tres
from ug_stereomatcher_tpu_torch.ops.cuda.resample import resample_tex

FOVEA = 3
SCALE = 1.41421356


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores
    (eight threads a worker oversubscribe them many times over)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(**kw):
    """The same algorithm configuration in both packages."""
    jcfg = JaxConfig(**{"fovea_level": FOVEA, **kw})
    return jcfg, MatcherConfig.from_reference(dataclasses.asdict(jcfg))


def t(a):
    return torch.from_numpy(np.array(a))  # a writable, contiguous copy


def hwc(x):
    return np.moveaxis(x, 0, -1)


def random_disp(seed, *shape):
    d = (np.random.RandomState(seed).rand(3, *shape).astype(np.float32)
         - 0.5) * 6
    d[2] = np.abs(d[2]) + 0.1
    return d


# ------------------------------------------------------------ config
@pytest.mark.parametrize("fovea_level", [3, 7])
def test_fovea_dims_and_from_reference_keep_fovea_level(fovea_level):
    jcfg = JaxConfig(fovea_level=fovea_level)
    tcfg = MatcherConfig.from_reference(dataclasses.asdict(jcfg))
    assert tcfg.fovea_level == fovea_level
    for h, w in ((72, 96), (3264, 4928)):
        assert tcfg.fovea_dims(h, w) == jcfg.fovea_dims(h, w)
    assert MatcherConfig().fovea_dims(3264, 4928) == (407, 615)


# ----------------------------------------------------------- pyramid
@pytest.mark.parametrize("h,w", [(72, 96), (96, 128), (75, 101)])
def test_foveate_pyramid_bit_exact_and_contiguous(h, w):
    jcfg, tcfg = configs()
    left, _ = synthetic_pair(h, w)
    n = tcfg.num_levels(h, w)
    jl = jpyr.foveate_pyramid(jpyr.build_pyramid(jnp.asarray(left), jcfg, n),
                              jcfg, (h, w))
    tl = tpyr.foveate_pyramid(tpyr.build_pyramid(t(left), tcfg, n), tcfg,
                              (h, w))
    fov = tcfg.fovea_dims(h, w)
    assert len(tl) == n
    for i, (a, b) in enumerate(zip(tl, jl)):
        assert a.is_contiguous(), i
        assert tuple(a.shape) == b.shape
        if i < FOVEA - 1:
            assert tuple(a.shape[-2:]) == fov
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# (source shape, full destination grid, window shape, window offset,
#  coordinate map, value scale): odd sizes; windows at the centre, at a
#  corner and reaching the far edge of the grid.
WINDOW_CASES = {
    "upsample_centre": ((3, 23, 37), (33, 53), (17, 29), (8, 12),
                        lambda v: v * (1.0 / SCALE), SCALE),
    "upsample_far_edge": ((3, 47, 63), (67, 89), (31, 41), (36, 48),
                          lambda v: v * (1.0 / SCALE), SCALE),
    "part_corner": ((2, 19, 27), (27, 39), (13, 20), (0, 0),
                    lambda v: v / SCALE, 1.0),
}


@pytest.mark.parametrize("method", ["nearest", "bilinear"])
@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_windowed_resample_equals_crop_of_whole(case, method):
    src_shape, (bh, bw), (wh, ww), (r0, c0), coord_of, vs = \
        WINDOW_CASES[case]
    img = t(np.random.RandomState(5).rand(*src_shape).astype(np.float32))
    whole = resample_tex(img, bh, bw, coord_of, vs, method)
    win = resample_tex(img, wh, ww, coord_of, vs, method, row_off=r0,
                       col_off=c0)
    assert torch.equal(win, whole[:, r0:r0 + wh, c0:c0 + ww])


@pytest.mark.parametrize("scale_conf", [True, False])
@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
def test_foveated_upsample_matches_jax(interp, scale_conf):
    jcfg, tcfg = configs(interp=interp, scale_conf_on_upsample=scale_conf)
    d = random_disp(9, 35, 47)
    big = (50, 67)
    ours = tpyr.foveated_upsample(t(d), *big, tcfg).numpy()
    ref = np.asarray(jpyr.foveated_upsample(jnp.asarray(d), *big, jcfg))
    assert ours.shape == ref.shape == d.shape
    if interp == "nearest":
        np.testing.assert_array_equal(ours, ref)
    else:
        np.testing.assert_allclose(ours, ref, rtol=0, atol=5e-5)


@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
def test_part_upsample_disp_matches_jax(interp):
    d = random_disp(10, 23, 33)
    ours = tres.part_upsample_disp(t(d), 33, 47, SCALE, interp).numpy()
    ref = np.asarray(jres.part_upsample_disp(jnp.asarray(d), 33, 47, SCALE,
                                             interp))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    if interp == "nearest":
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("h,w", [(72, 96), (96, 128)])
@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
def test_hierarchical_disparity_matches_jax(interp, h, w):
    jcfg, tcfg = configs(interp=interp)
    fov = tcfg.fovea_dims(h, w)
    stack = [random_disp(20 + i, *fov) for i in range(FOVEA)]
    ours = tpyr.hierarchical_disparity([t(s) for s in stack], tcfg, (h, w))
    ref = np.asarray(jpyr.hierarchical_disparity(
        [jnp.asarray(s) for s in stack], jcfg, (h, w)))
    assert tuple(ours.shape) == ref.shape == (3, h, w)
    if interp == "nearest":
        np.testing.assert_array_equal(ours.numpy(), ref)
    else:   # values grow by SCALE a level: 5e-5 relative as well
        np.testing.assert_allclose(ours.numpy(), ref, rtol=5e-5, atol=5e-5)
    # the stack levels are pasted, never written through
    for i, s in enumerate(stack[:FOVEA - 1]):
        assert np.array_equal(s, random_disp(20 + i, *fov))


# ------------------------------------------------------ match_pyramid
@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
def test_match_pyramid_foveated_lockstep_level_by_level(interp):
    """Each level starts both engines from the JAX state; nearest
    transitions, mode-1 and fovea-to-fovea alike, are bit-exact.  A
    bilinear level equals the JAX package's level body run without jit
    bit for bit, as in mode 1 (tests/test_torch_match.py): the jitted
    JAX match_level differs from that body by XLA's fusion rounding,
    amplified past the quantile rule on the 24 x 33 level of this
    scene."""
    jcfg, tcfg = configs(interp=interp)
    h, w = 72, 96
    left, right = synthetic_pair(h, w, shift_x=1)
    n = tcfg.num_levels(h, w)
    jl, jr = (jpyr.foveate_pyramid(jpyr.build_pyramid(jnp.asarray(x), jcfg,
                                                      n), jcfg, (h, w))
              for x in (left, right))
    dims = tmatch.level_dims_for_matching(tcfg, h, w, n, True)
    assert dims == jmatch.level_dims_for_matching(jcfg, h, w, n, True)
    assert dims[0] == dims[FOVEA - 1] == tcfg.fovea_dims(h, w)
    big = tcfg.dims_chain(h, w)[FOVEA - 2]
    disp = np.zeros((3,) + dims[n - 1], np.float32)
    for i in range(n - 1, -1, -1):
        out = tmatch.match_level(t(jl[i]), t(jr[i]), t(disp), i, tcfg,
                                 i == n - 1).numpy()
        if interp == "nearest":
            ref = np.asarray(jmatch.match_level(
                jl[i], jr[i], jnp.asarray(disp), i, jcfg, i == n - 1))
            assert_lockstep_close(out, ref)
        else:
            ref = jax_level_body_unjitted(jl[i], jr[i], disp, i, jcfg,
                                          i == n - 1)
            np.testing.assert_array_equal(out, ref)
        if i == 0:
            break
        if i >= FOVEA:
            up_ref = jpyr.upsample_to_level(jnp.asarray(ref), *dims[i - 1],
                                            jcfg)
            up = tpyr.upsample_to_level(t(ref), *dims[i - 1], tcfg)
        else:
            up_ref = jpyr.foveated_upsample(jnp.asarray(ref), *big, jcfg)
            up = tpyr.foveated_upsample(t(ref), *big, tcfg)
        if interp == "nearest":
            np.testing.assert_array_equal(up.numpy(), np.asarray(up_ref))
        else:
            np.testing.assert_allclose(up.numpy(), np.asarray(up_ref),
                                       rtol=5e-5, atol=5e-5)
        disp = np.array(up_ref)


# ------------------------------------------------------------ engine
def test_match_foveated_matches_jax_engine():
    """Free-running against the JAX engine under the quantile rule, with
    the stack layout and its accessors."""
    jcfg, tcfg = configs()
    h, w = 72, 96
    left, right = (hwc(x) for x in synthetic_pair(h, w, shift_x=1))
    ref = JaxEngine(jcfg).match_foveated(left, right)
    eng = StereoEngine(tcfg, device="cpu")
    out = eng.match_foveated(left, right)
    fh, fw = tcfg.fovea_dims(h, w)
    assert (out.roi_height, out.roi_width) == (ref.roi_height, ref.roi_width)
    assert (out.im_height, out.im_width, out.num_levels) == (h, w, FOVEA)
    assert tuple(out.stack_h.shape) == (FOVEA * fh, fw)
    assert tuple(out.stack_left.shape) == (FOVEA * 3 * fh, fw)
    d = np.abs(np.stack([out.stack_h, out.stack_v, out.stack_c]) - np.stack(
        [np.asarray(ref.stack_h), np.asarray(ref.stack_v),
         np.asarray(ref.stack_c)]))
    assert np.median(d) < 1e-3 and (d > 0.02).mean() < 0.02
    # image stacks: the jitted JAX pyramid rounds its fused blur to 1 ulp
    # of the op-by-op one, which the port equals bit for bit
    # (test_foveate_pyramid_bit_exact_and_contiguous)
    for side in ("left", "right"):
        np.testing.assert_allclose(
            getattr(out, f"stack_{side}").numpy(),
            np.asarray(getattr(ref, f"stack_{side}")), rtol=1e-6, atol=0)
    for lv in range(FOVEA):
        planes = out.level_disparity(lv)
        assert all(tuple(p.shape) == (fh, fw) for p in planes)
        assert torch.equal(planes[0], out.stack_h[lv * fh:(lv + 1) * fh])
        img = out.level_image(lv, "right")
        assert tuple(img.shape) == (3, fh, fw)
        np.testing.assert_allclose(img.numpy(),
                                   np.asarray(ref.level_image(lv, "right")),
                                   rtol=1e-6, atol=0)
    dh0 = out.level_disparity(0)[0].numpy()
    assert abs(np.median(dh0[6:-6, 6:-6]) - 1) < 0.5
    assert eng.metrics["match_foveated_s"] > 0


def test_match_hierarchical_window_is_stack_level_zero():
    h, w = 96, 128
    left, right = (hwc(x) for x in synthetic_pair(h, w, shift_x=2))
    eng = StereoEngine(MatcherConfig(fovea_level=FOVEA), device="cpu")
    res = eng.match_hierarchical(left, right)
    stack = eng.match_foveated(left, right)
    assert res.disparity_h.shape == (h, w)
    fh, fw = stack.roi_height, stack.roi_width
    top, lft = h // 2 - fh // 2, w // 2 - fw // 2
    assert torch.equal(res.triplet[:, top:top + fh, lft:lft + fw],
                       torch.stack(stack.level_disparity(0)))
    assert torch.isfinite(res.triplet).all()
    assert abs(res.disparity_h[12:-12, 12:-12].median().item() - 2) < 0.5
    assert eng.metrics["match_hierarchical_s"] > 0
    # the measurement-only gate override: the same plain loop on the CPU
    off = StereoEngine(MatcherConfig(fovea_level=FOVEA), device="cpu",
                       resident_max_pixels=0).match_hierarchical(left, right)
    assert torch.equal(off.triplet, res.triplet)


# -------------------------------------------------- batch and sharding
@pytest.mark.parametrize("layout", ["no_mesh", "round_robin", "rows"])
def test_match_batch_foveated_equals_match_foveated(layout):
    """B = 2 pairs: in turn, round robin on a 2 x 1 mesh, and row-sharded
    on a 1 x 4 mesh of CPU devices."""
    h, w = 72, 96
    pairs = [synthetic_pair(h, w, shift_x=1 + s, seed=30 + s)
             for s in range(2)]
    left = np.stack([p[0] for p in pairs])
    right = np.stack([p[1] for p in pairs])
    mesh = {"no_mesh": None,
            "round_robin": par.make_mesh(2, 1, devices=["cpu"] * 2),
            "rows": par.make_mesh(1, 4, devices=["cpu"] * 4)}[layout]
    eng = StereoEngine(MatcherConfig(fovea_level=FOVEA), device="cpu")
    res = eng.match_batch(left, right, mesh=mesh, foveated=True)
    fh, fw = eng.config.fovea_dims(h, w)
    assert tuple(res.stack_h.shape) == (2, FOVEA * fh, fw)
    assert res.stack_left is None and res.stack_right is None
    with pytest.raises(ValueError, match="not produced"):
        res.level_image(0)
    assert tuple(res.level_disparity(1)[2].shape) == (2, fh, fw)
    for i in range(2):
        single = eng.match_foveated(left[i], right[i])
        for name in ("stack_h", "stack_v", "stack_c"):
            assert torch.equal(getattr(res, name)[i],
                               getattr(single, name)), (i, name)
    if mesh is not None:   # the one-shot form
        out = par.batch_match(t(left), t(right), eng.config, mesh,
                              foveated=True)
        assert torch.equal(out[:, 0], res.stack_h)


@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
def test_sharded_foveated_pair_equals_unsharded(interp):
    """Eight rows a shard at least: the 47-row fovea levels are
    row-sharded (12 rows each), their crops taken shard by shard."""
    h, w = 96, 128
    cfg = MatcherConfig(fovea_level=FOVEA, interp=interp)
    left, right = (t(x) for x in synthetic_pair(h, w, shift_x=2, seed=41))
    n = cfg.num_levels(h, w)
    lp, rp = tpyr.build_pyramid_pair(left, right, cfg, n)
    ref = tmatch.match_pyramid(tpyr.foveate_pyramid(lp, cfg, (h, w)),
                               tpyr.foveate_pyramid(rp, cfg, (h, w)), cfg,
                               (h, w), foveated=True)
    mesh = par.make_mesh(1, 4, devices=["cpu"] * 4)
    out = par.sharded_match_pair(left, right, cfg, mesh,
                                 min_rows_per_shard=8, foveated=True)
    assert out.levels[0].sharded and out.levels[0].height == 47
    assert not out.levels[n - 1].sharded
    for i, (a, b) in enumerate(zip(out.levels, ref.levels)):
        assert torch.equal(a.gather("cpu"), b), i


def test_check_fovea_raises():
    cfg = MatcherConfig(fovea_level=9)
    msg = "supports only 7 pyramid levels but fovea_level=9"
    with pytest.raises(ValueError, match=msg):
        _check_fovea(cfg, 96, 128)
    eng = StereoEngine(cfg, device="cpu")
    x = np.zeros((96, 128, 3), np.uint8)
    for call in (eng.match_foveated, eng.match_hierarchical,
                 lambda a, b: eng.match_batch(a[None], b[None],
                                              foveated=True)):
        with pytest.raises(ValueError, match=msg):
            call(x, x)
    _check_fovea(MatcherConfig(fovea_level=7), 96, 128)
