"""Each kernel module of the port against the JAX package's Pallas kernel.

On the CPU a wrapper runs its plain PyTorch version, which is held here
against the Pallas kernel run in interpret mode (as
tests/test_pallas_kernels.py runs it).  Tolerances:

* warp and resample (nearest gathers): exact;
* bilinear warp: rtol=atol=1e-6 (the JAX package's bound for its
  bilinear warp kernel, tests/test_pallas_kernels.py:74);
* bilinear resample: against the interpret-mode two-hot kernel (the same
  float64 host taps, but the weighted sums run through XLA:CPU's float32
  matmul, which rounds differently) rtol=atol=2e-6; the largest
  difference measured on these inputs is 9.5e-7, about 2 ulp of values
  below 6 (the subsample by 2 is exact).  Against the JAX float32
  ``tex_gather`` path 5e-5 (tests/test_pallas_kernels.py:666);
* blur: rtol=atol=1e-6 (the <= 1 ulp FMA contract, ops/pallas/blur.py);
* smooth: rtol=atol=1e-5;
* direction: rtol=atol=1e-5 against the JAX package's unfused chain
  (direction_maps + parabola_fit + blend, op by op).  Against the
  interpret-mode kernel the bound is the one the JAX package holds that
  kernel to (tests/test_pallas_kernels.py:583, 5e-4): XLA:CPU contracts
  multiply-adds in the compiled kernel, and the parabola fit divides by
  the curvature c1, which amplifies that 1-ulp difference where the
  correlation peak is flat.

The CUDA kernels themselves are held against their plain versions on the
card by tests/test_torch_gpu.py, which imports no jax.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ug_stereomatcher_tpu import match as jmatch
from ug_stereomatcher_tpu import ops as J
from ug_stereomatcher_tpu.config import MatcherConfig as JaxConfig
from ug_stereomatcher_tpu.ops.pallas.blur import fused_blur_gaussian as p_blur
from ug_stereomatcher_tpu.ops.pallas.direction import (
    fused_direction_update as p_direction)
from ug_stereomatcher_tpu.ops.pallas.resample import resample_tex as p_resample
from ug_stereomatcher_tpu.ops.pallas.smooth import (
    fused_smooth_average as p_smooth)
from ug_stereomatcher_tpu_torch.ops.cuda import _build
from ug_stereomatcher_tpu_torch.ops.cuda import blur, direction, resample, smooth, warp

SCALE = 1.41421356
RNG = np.random.RandomState(17)


def t(a):
    return torch.from_numpy(np.array(a))  # a writable, contiguous copy


def rand(*shape, scale=1.0):
    return (RNG.rand(*shape) * scale).astype(np.float32)


# --------------------------------------------------------------- blur
@pytest.mark.parametrize("boundary,channels", [("zero", 6), ("clamp", 3)])
def test_blur_matches_pallas(boundary, channels):
    x = rand(channels, 37, 210)
    ref = np.asarray(p_blur(jnp.asarray(x), boundary=boundary, tile_rows=16,
                            tile_cols=128, interpret=True))
    out = blur.fused_blur_gaussian(t(x), boundary).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_blur_rejects_planes_without_channel_axis():
    with pytest.raises(ValueError, match="C, H, W"):
        blur.fused_blur_gaussian(t(rand(24, 140)), "zero")


# ----------------------------------------------------------- resample
RESAMPLE_CASES = {
    "subsample_sqrt2": ((6, 97, 211), (int(97 / SCALE), int(211 / SCALE)),
                        lambda v: v * SCALE, 1.0),
    "subsample_2": ((6, 97, 211), (48, 105), lambda v: v * 2.0, 1.0),
    "upsample": ((3, 68, 149), (97, 211), lambda v: v * (1.0 / SCALE), SCALE),
}


@pytest.mark.parametrize("case", sorted(RESAMPLE_CASES))
def test_resample_matches_pallas_exactly(case):
    shape, (h2, w2), coord_of, vs = RESAMPLE_CASES[case]
    img = rand(*shape, scale=4.0)
    ref = np.asarray(p_resample(jnp.asarray(img), h2, w2, coord_of, vs,
                                "nearest", interpret=True))
    out = resample.resample_tex(t(img), h2, w2, coord_of, vs).numpy()
    np.testing.assert_array_equal(out, ref)


def test_resample_cubic_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        resample.resample_tex(torch.zeros(3, 8, 8), 4, 4, lambda v: v * 2,
                              method="cubic")


def test_resample_bilinear_matches_pallas():
    """One interpret-mode case over the three pyramid resamples."""
    for case in sorted(RESAMPLE_CASES):
        shape, (h2, w2), coord_of, vs = RESAMPLE_CASES[case]
        img = rand(*shape, scale=4.0)
        ref = np.asarray(p_resample(jnp.asarray(img), h2, w2, coord_of, vs,
                                    "bilinear", interpret=True))
        out = resample.resample_tex(t(img), h2, w2, coord_of, vs,
                                    "bilinear").numpy()
        np.testing.assert_allclose(out, ref, rtol=2e-6, atol=2e-6,
                                   err_msg=case)


@pytest.mark.parametrize("case", sorted(RESAMPLE_CASES))
def test_resample_bilinear_matches_jax_tex_gather(case):
    shape, (h2, w2), _, vs = RESAMPLE_CASES[case]
    img = rand(*shape, scale=4.0)
    if case == "upsample":
        ref = J.upsample_disp(jnp.asarray(img), h2, w2, 1.0 / SCALE, vs,
                              "bilinear")
        coord_of = lambda v: v * (1.0 / SCALE)  # noqa: E731
    else:
        scale = SCALE if case == "subsample_sqrt2" else 2.0
        ref = J.subsample(jnp.asarray(img), h2, w2, scale, "bilinear")
        coord_of = lambda v: v * scale  # noqa: E731
    out = resample.resample_tex(t(img), h2, w2, coord_of, vs,
                                "bilinear").numpy()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=5e-5, atol=5e-5)


# --------------------------------------------------------------- warp
WARP_FIELDS = {
    "in_window": (lambda h, w: (RNG.rand(h, w) - 0.5) * 60,
                  lambda h, w: (RNG.rand(h, w) - 0.5) * 6),
    "beyond_window": (lambda h, w: RNG.rand(h, w) * 80 + 300,
                      lambda h, w: RNG.rand(h, w) * 10 + 12),
    "off_every_edge": (lambda h, w: (RNG.rand(h, w) - 0.5) * 3 * w,
                       lambda h, w: (RNG.rand(h, w) - 0.5) * 3 * h),
}


@pytest.mark.parametrize("field", sorted(WARP_FIELDS))
def test_warp_matches_pallas_level_warp_exactly(field):
    h, w = 32, 384
    img = rand(3, h, w)
    fh, fv = WARP_FIELDS[field]
    dh, dv = fh(h, w).astype(np.float32), fv(h, w).astype(np.float32)
    ref = np.asarray(jmatch.warp_for_level(
        jnp.asarray(img), jnp.asarray(dh), jnp.asarray(dv), JaxConfig(), 0,
        interpret=True))
    out = warp.warp_nearest(t(img), t(dh), t(dv)).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("field", sorted(WARP_FIELDS))
def test_warp_bilinear_matches_jax_gather(field):
    h, w = 32, 384
    img = rand(3, h, w)
    fh, fv = WARP_FIELDS[field]
    dh, dv = fh(h, w).astype(np.float32), fv(h, w).astype(np.float32)
    ref = np.asarray(J.warp_by_disparity(jnp.asarray(img), jnp.asarray(dh),
                                         jnp.asarray(dv), "bilinear"))
    out = warp.warp(t(img), t(dh), t(dv), "bilinear").numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_warp_checks_shapes():
    with pytest.raises(ValueError):
        warp.warp_nearest(torch.zeros(3, 4, 5), torch.zeros(4, 4),
                          torch.zeros(4, 5))


# ---------------------------------------------------------- direction
def _direction_inputs(h=36, w=140):
    left = rand(3, h, w, scale=255.0)
    warped = rand(3, h, w, scale=255.0)
    bl2 = np.asarray(J.blur_gaussian_clamp(jnp.asarray(left)
                                           * jnp.asarray(left)))
    disp = rand(3, h, w) - 0.5
    return left, warped, bl2, disp


CONSTS = (0.3, 0.2, 0.8, 0.9, 0.1)  # non-default on purpose


@pytest.mark.parametrize("threshold,replace", [(1.0, 0), (0.55, 1)])
def test_direction_matches_pallas(threshold, replace):
    left, warped, bl2, disp = _direction_inputs()
    ref = np.asarray(p_direction(
        *(jnp.asarray(a) for a in (left, warped, bl2, disp)), threshold,
        replace, tile_rows=16, tile_cols=128, consts=CONSTS, interpret=True))
    out = direction.fused_direction_update(
        t(left), t(warped), t(bl2), t(disp), threshold, bool(replace),
        CONSTS).numpy()
    np.testing.assert_allclose(out, ref, rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("threshold,replace", [(1.0, 0), (0.55, 1)])
def test_direction_matches_unfused_jax_chain(threshold, replace):
    left, warped, bl2, disp = _direction_inputs()
    no_peak, aff_s, aff_b, w_new, w_old = CONSTS
    dirs = jmatch.direction_maps(jnp.asarray(left), jnp.asarray(warped),
                                 jnp.asarray(bl2))
    thr = jnp.float32(threshold)
    ih, ch = J.parabola_fit(dirs[0], dirs[4], dirs[1], thr, no_peak, aff_s,
                            aff_b)
    iv, cv = J.parabola_fit(dirs[2], dirs[4], dirs[3], thr, no_peak, aff_s,
                            aff_b)
    cn = ch * cv
    conf = cn if replace else J.blend_confidence(cn, jnp.asarray(disp[2]),
                                                 w_new, w_old)
    ref = np.asarray(jnp.stack([ih + disp[0], iv + disp[1], conf]))
    out = direction.fused_direction_update(
        t(left), t(warped), t(bl2), t(disp), threshold, bool(replace),
        CONSTS).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_direction_maps_match_jax_exactly():
    left, warped, bl2, _ = _direction_inputs(20, 30)
    ours = direction.direction_maps(t(left), t(warped), t(bl2))
    theirs = jmatch.direction_maps(jnp.asarray(left), jnp.asarray(warped),
                                   jnp.asarray(bl2))
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ------------------------------------------------------------- smooth
@pytest.mark.parametrize("n", [5, 10])
def test_smooth_matches_pallas(n):
    st = rand(3, 40, 150) + 0.05
    ref = np.asarray(p_smooth(jnp.asarray(st), n_passes=n, tile_rows=16,
                              tile_cols=128, interpret=True))
    out = smooth.fused_smooth_average(t(st), n).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


# ------------------------------------------------- wrappers and build
def test_cpu_tensors_take_plain_version_and_count_no_launch():
    _build.reset_launch_counts()
    x = t(rand(3, 12, 20))
    blur.fused_blur_gaussian(x, "clamp")
    smooth.fused_smooth_average(x, 2)
    warp.warp_nearest(x, x[0], x[1])
    warp.warp(x, x[0], x[1], "bilinear")
    resample.resample_tex(x, 6, 10, lambda v: v * 2.0, method="bilinear")
    assert _build.launch_counts() == {}


@pytest.mark.parametrize("bad", ["float64", "strided"])
def test_wrappers_reject_bad_tensors(bad):
    x = torch.zeros(3, 8, 10)
    if bad == "float64":
        x, exc = x.double(), TypeError
    else:
        x, exc = x.transpose(1, 2), ValueError
    with pytest.raises(exc):
        blur.fused_blur_gaussian(x)
    with pytest.raises(exc):
        smooth.fused_smooth_average(x, 1)


def test_build_command_targets_sm90a_from_csrc_only():
    cmds = _build.build_command("nvcc", _build.BUILD_DIR / "x.so")
    for cmd in cmds:   # one compile per source, then the link
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert "--fmad=false" in cmd
        assert not any("fast_math" in a or "fast-math" in a for a in cmd)
    assert cmds[-1][-len(cmds) + 1:] == [c[-1] for c in cmds[:-1]]
    srcs = [a for cmd in cmds for a in cmd if a.endswith((".cu", ".cuh"))]
    assert len(srcs) == len(cmds) - 1
    assert {p.rsplit("/", 1)[-1] for p in srcs} == {
        "blur.cu", "convergence.cu", "direction.cu", "level.cu",
        "resample.cu", "smooth.cu", "warp.cu"}
    for s in srcs:
        assert s.startswith(str(_build.CSRC_DIR) + "/")


def test_build_hash_covers_every_source():
    names = {p.name for p in _build.sources()}
    assert {"common.cuh", "stencils.cuh"} <= names and len(names) == 9


def test_missing_nvcc_raises_clear_error(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_entry_point_signatures_use_void_p_for_pointers():
    import ctypes
    for name, argtypes in _build.SIGNATURES.items():
        assert argtypes[-1] is ctypes.c_void_p, name   # the stream
        assert ctypes.c_void_p in argtypes[:2], name


def test_consts_follow_matcher_config():
    from ug_stereomatcher_tpu_torch.config import MatcherConfig
    cfg = dataclasses.replace(MatcherConfig(), conf_no_peak=0.3,
                              conf_blend_old=0.1)
    assert cfg.conf_consts == (0.3, 0.3, 0.7, 0.75, 0.1)
