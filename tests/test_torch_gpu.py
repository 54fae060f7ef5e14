"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here is marked ``gpu`` and skips where torch finds no CUDA
device.  The file imports no jax (the card's machine has none), so on the
card it runs without the JAX test configuration:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

warp, resample and blur must be bit-exact in both interpolation modes;
so must direction, smooth and the level-resident kernel, since the
kernels are built with --fmad=false and keep the plain versions' term
order.  The row-sharded forms of warp, direction and smooth must equal
their plain versions and the unsharded kernels' rows, on the top, middle
and bottom shards, and the sharded level and batch on a mesh of one
card repeated must equal the unsharded engine.  Mode 2: the windowed
resample and the level kernel at the fovea schedules are bit-exact; the
foveated stack and hierarchical map on the card agree with the plain
engine under the quantile rule and with the per-iteration route bit for
bit, and the row-sharded foveated batch equals the unsharded stack.
Extras and geometry: early exit on the card against the CPU engine under
the quantile rule, the left-right check through one warp launch on a
2-plane stack, profile_match equal to match bit for bit, triangulation
under a relative-quantile rule and the range-map resizes against the CPU.
Host layers: dumps, the service, epe_metrics and the colour panel on
results that lie on the card, BatchRunner's dumps equal to match, and
``python -m ug_stereomatcher_tpu_torch match --device cuda``.
"""

import numpy as np
import pytest
import torch

from ug_stereomatcher_tpu_torch import MatcherConfig, StereoEngine
from ug_stereomatcher_tpu_torch import match as match_mod
from ug_stereomatcher_tpu_torch import parallel as par
from ug_stereomatcher_tpu_torch import scene
from ug_stereomatcher_tpu_torch.ops.cuda import (
    _build, blur, direction, level, resample, smooth, warp)

SCALE = 1.41421356
CONSTS = (0.3, 0.2, 0.8, 0.9, 0.1)  # non-default on purpose

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def rand(dev, *shape, lo=0.0, hi=1.0, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return lo + (hi - lo) * torch.rand(*shape, generator=gen, device=dev)


def assert_same(kernel, plain, *args):
    out = kernel(*args)
    torch.cuda.synchronize()
    ref = plain(*args)
    assert out.shape == ref.shape
    assert torch.equal(out, ref), (out - ref).abs().max().item()


# The blur's warps own 128-column strips and runs of 16-64 rows: shapes
# below the 5-tap stencil, W at every residue mod 4 (16-byte rows only
# where W % 4 == 0), one strip, several strips with a partial one, and
# runs with interior strips.
BLUR_SHAPES = [(1, 1), (2, 3), (4, 4), (3, 130), (203, 307), (40, 128),
               (67, 129), (33, 258), (130, 515), (300, 700)]


@pytest.mark.parametrize("h,w", BLUR_SHAPES)
@pytest.mark.parametrize("channels", [1, 3, 6])
@pytest.mark.parametrize("boundary", ["zero", "clamp"])
def test_blur_bit_exact(cuda, boundary, channels, h, w):
    x = rand(cuda, channels, h, w, hi=255.0)
    assert_same(blur.fused_blur_gaussian, blur.fused_blur_gaussian_plain, x,
                boundary)


@pytest.mark.parametrize("w", [128, 131])
@pytest.mark.parametrize("boundary", ["zero", "clamp"])
def test_blur_unaligned_start_bit_exact(cuda, boundary, w):
    """A contiguous input one float into its storage: no 16-byte loads."""
    buf = rand(cuda, 3 * 37 * w + 1, hi=255.0)
    x = buf[1:].view(3, 37, w)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    assert_same(blur.fused_blur_gaussian, blur.fused_blur_gaussian_plain, x,
                boundary)


@pytest.mark.parametrize("rows", [61, 150])
@pytest.mark.parametrize("boundary", ["zero", "clamp"])
def test_blur_band_equals_rows_of_whole(cuda, boundary, rows):
    """The sharded blur (the whole-image kernel on each shard's rows with 2
    halo rows) against the rows of the whole image's blur."""
    x = rand(cuda, 3, rows, COLS, hi=255.0, seed=7)
    mesh = par.make_mesh(1, 4, devices=[cuda] * 4)
    out = par.sharded_blur(x, boundary, mesh, min_rows_per_shard=1)
    assert len(out.shards) == 4
    whole = blur.fused_blur_gaussian(x, boundary)
    assert torch.equal(out.gather(cuda), whole)
    assert torch.equal(whole, blur.fused_blur_gaussian_plain(x, boundary))


RESAMPLE_CASES = {
    "subsample_sqrt2": ((6, 97, 211), (int(97 / SCALE), int(211 / SCALE)),
                        lambda v: v * SCALE, 1.0),
    "subsample_2": ((6, 97, 211), (48, 105), lambda v: v * 2.0, 1.0),
    "upsample": ((3, 68, 149), (97, 211), lambda v: v * (1.0 / SCALE), SCALE),
}
# One output row, every residue of W2 mod 4 (a row start is rarely 16-byte
# aligned) on both sides of the nearest kernel's 128-column chunks, 1, 3
# and 6 planes, scaled values.
RESAMPLE_CASES.update({
    f"row_w{w2}_c{c}": ((c, 3, 2 * w2 + 3), (1, w2), lambda v: v * 2.0, 0.5)
    for c in (1, 3, 6) for w2 in (128, 129, 130, 131, 261)})


@pytest.mark.parametrize("case", sorted(RESAMPLE_CASES))
def test_resample_bit_exact(cuda, case):
    shape, (h2, w2), coord_of, vs = RESAMPLE_CASES[case]
    img = rand(cuda, *shape, hi=4.0)
    iy, ix = (torch.from_numpy(resample.nearest_indices(n, m, coord_of)).to(
        cuda) for n, m in ((h2, shape[1]), (w2, shape[2])))
    assert_same(resample.resample_static, resample.resample_static_plain,
                img, iy, ix, vs)
    out = resample.resample_tex(img, h2, w2, coord_of, vs)
    assert torch.equal(out, resample.resample_static_plain(img, iy, ix, vs))


@pytest.mark.parametrize("case", sorted(RESAMPLE_CASES))
def test_resample_bilinear_bit_exact(cuda, case):
    shape, (h2, w2), coord_of, vs = RESAMPLE_CASES[case]
    img = rand(cuda, *shape, hi=4.0)
    (iy, wy), (ix, wx) = (
        (torch.from_numpy(a).to(cuda) for a in resample.bilinear_taps(
            n, m, coord_of)) for n, m in ((h2, shape[1]), (w2, shape[2])))
    assert_same(resample.resample_static, resample.resample_static_plain,
                img, iy, ix, vs, wy, wx)
    out = resample.resample_tex(img, h2, w2, coord_of, vs, "bilinear")
    assert torch.equal(out, resample.resample_static_plain(img, iy, ix, vs,
                                                           wy, wx))


def smooth_field(dev, h, w, row0=0, seed=0):
    """The bench scene's 3 px shift plus a sinusoid of a few pixels in
    each axis, as a matcher's field is: (dh, dv) of rows row0 .. row0 + h
    (an image of 2 h rows at most)."""
    rng = np.random.RandomState(seed)
    a, b, ph, pv = rng.uniform(1.0, 4.0), rng.uniform(0.5, 2.0), *rng.uniform(
        0.0, 6.28, 2)
    ys = torch.arange(row0, row0 + h, device=dev, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    t = 6.2831853 * (xs / max(w, 2) + ys / max(2 * h, 2))
    return (3.0 + a * torch.sin(t + ph)).contiguous(), (
        b * torch.cos(1.7 * t + pv)).contiguous()


# Random fields of each spread (dv a quarter of dh's), or smooth.
WARP_FIELDS = ["random0.75", "random6", "random60", "random900", "smooth"]
# Every W mod 4, below one warp's 32 columns and below a thread's K * 32
# (K = 4 nearest, 2 bilinear), one row, and several blocks.
WARP_SHAPES = [(64, 300), (9, 29), (9, 30), (9, 31), (9, 32), (5, 63),
               (7, 97), (3, 126), (3, 127), (3, 129), (1, 300), (1, 5),
               (40, 261)]


def warp_args(dev, h, w, field):
    img = rand(dev, 3, h, w)
    if field == "smooth":
        dh, dv = smooth_field(dev, h, w)
    else:
        spread = float(field[len("random"):])
        dh = rand(dev, h, w, lo=-spread, hi=spread, seed=1)
        dv = rand(dev, h, w, lo=-spread / 4, hi=spread / 4, seed=2)
    return img, dh, dv


@pytest.mark.parametrize("h,w", WARP_SHAPES)
@pytest.mark.parametrize("field", WARP_FIELDS)
def test_warp_bit_exact(cuda, field, h, w):
    assert_same(warp.warp_nearest, warp.warp_nearest_plain,
                *warp_args(cuda, h, w, field))


@pytest.mark.parametrize("h,w", WARP_SHAPES)
@pytest.mark.parametrize("field", WARP_FIELDS)
def test_warp_bilinear_bit_exact(cuda, field, h, w):
    assert_same(warp.warp, warp.warp_plain,
                *warp_args(cuda, h, w, field), "bilinear")


@pytest.mark.parametrize("method", ["nearest", "bilinear"])
@pytest.mark.parametrize("channels", [1, 3, 4, 6])
def test_warp_source_at_odd_offset_bit_exact(cuda, method, channels):
    """A source that is a view one float into its storage (4-byte, never
    8-byte aligned), and channel counts that are not a multiple of 3."""
    h, w = 23, 77
    store = rand(cuda, channels * h * w + 1)
    img = store[1:].view(channels, h, w)
    assert img.is_contiguous() and img.data_ptr() % 8 == 4
    dh, dv = smooth_field(cuda, h, w)
    assert_same(warp.warp, warp.warp_plain, img, dh, dv, method)


def _level_inputs(dev, h, w, seed=0):
    """A textured pair with a 3 px shift and a noisy start state."""
    left_np, right_np = scene.make_pair(h, w, seed=seed)
    left, right = (torch.from_numpy(np.moveaxis(a, -1, 0).astype(
        np.float32)).to(dev).contiguous() for a in (left_np, right_np))
    state = torch.stack([rand(dev, h, w, lo=1.0, hi=4.0, seed=seed + 1),
                         rand(dev, h, w, lo=-0.5, hi=0.5, seed=seed + 2),
                         rand(dev, h, w, lo=0.2, hi=1.0, seed=seed + 3)])
    return left, right, state


@pytest.mark.parametrize("method", ["nearest", "bilinear"])
@pytest.mark.parametrize("replace", [False, True])
@pytest.mark.parametrize("n_smooth", [0, 5, 10])
@pytest.mark.parametrize("h,w", [(7, 9), (17, 33), (34, 53), (101, 153)])
def test_level_resident_bit_exact(cuda, method, h, w, n_smooth, replace):
    """Shapes below one 16 x 32 tile, one pixel past a tile edge in each
    axis, and several tiles."""
    cfg = MatcherConfig(level_cutoff=6)
    left, right, state = _level_inputs(cuda, h, w)
    thresholds = cfg.threshold_schedule(6)
    assert_same(level.level_resident_match, level.level_resident_match_plain,
                left, right, state, thresholds, n_smooth, replace, CONSTS,
                method)


def test_level_resident_grid_too_large_raises(cuda):
    left, right, state = _level_inputs(cuda, 34, 53)
    too_many = level.max_coresident_blocks("nearest", 5) + 1
    with pytest.raises(RuntimeError, match="ugsm_level_resident"):
        level.level_resident_match(left, right, state, (1.0,), 5, True,
                                   grid_blocks=too_many)


@pytest.mark.parametrize("method", ["nearest", "bilinear"])
def test_level_resident_window_too_large_raises(cuda, method):
    left, right, state = _level_inputs(cuda, 34, 53)
    most = level.max_smooth_passes(method)
    assert most >= 10
    assert level.max_coresident_blocks(method, most) >= 1
    with pytest.raises(ValueError, match="at most"):
        level.level_resident_match(left, right, state, (1.0,), most + 1,
                                   True, method=method)


@pytest.mark.parametrize("mi", [1, 6])
def test_level_resident_two_barriers_per_iteration(cuda, mi):
    left, right, state = _level_inputs(cuda, 101, 153)
    thresholds = MatcherConfig(level_cutoff=6).threshold_schedule(mi)
    prof = level.profile_level(left, right, state, thresholds, 5, False)
    assert prof["grid_barriers"] == 2 * mi - 1
    assert set(prof["cycles"]) == set(level.PHASES)
    assert all(c > 0 for c in prof["cycles"].values()), prof


# The tile is 16 x 64: shapes far below it, one row and one column past
# it (and past two tiles' rows), below one tile, and several tiles with a
# partial one each way.
DIRECTION_SHAPES = [(1, 1), (2, 3), (5, 7), (17, 64), (16, 65), (17, 65),
                    (33, 65), (12, 40), (67, 131), (100, 200)]


@pytest.mark.parametrize("h,w", DIRECTION_SHAPES)
@pytest.mark.parametrize("threshold,replace", [(1.0, False), (0.55, True)])
def test_direction_bit_exact(cuda, threshold, replace, h, w):
    left = rand(cuda, 3, h, w, hi=255.0, seed=3)
    warped = rand(cuda, 3, h, w, hi=255.0, seed=4)
    bl2 = blur.fused_blur_gaussian_plain(left * left, "clamp")
    disp = rand(cuda, 3, h, w, lo=-0.5, hi=0.5, seed=5)
    assert_same(direction.fused_direction_update,
                direction.fused_direction_update_plain, left, warped, bl2,
                disp, threshold, replace, CONSTS)


def passes(n):
    """n as a count or in terms of the kernel's passes per launch K."""
    k = smooth.max_chunk()
    return {"K": k, "K+1": k + 1, "2K+3": 2 * k + 3}.get(n, n)


SMOOTH_PASSES = [0, 1, 5, 10, "K", "K+1", "2K+3"]
# The tile is 64 x 64 with a halo of up to K + 1: one row or column, two,
# below the halo, one tile, one past a tile edge each way, and several
# tiles with a partial one each way.
SMOOTH_SHAPES = [(1, 1), (1, 70), (70, 1), (2, 2), (7, 9), (33, 65),
                 (64, 64), (65, 65), (70, 133), (97, 200), (150, 260)]


@pytest.mark.parametrize("h,w", SMOOTH_SHAPES)
@pytest.mark.parametrize("n", SMOOTH_PASSES)
def test_smooth_bit_exact(cuda, n, h, w):
    st = rand(cuda, 3, h, w, lo=0.05, hi=1.05, seed=6)
    assert_same(smooth.fused_smooth_average,
                smooth.fused_smooth_average_plain, st, passes(n))


def test_smooth_bit_exact_over_wide_magnitudes(cuda):
    """Confidences and values over twelve decades, zeros and a row of
    tiny confidences: every division of a pass, in and out of the range
    of the kernel's short division, rounds as IEEE division does."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    h, w = 300, 500
    mag = 10.0 ** (12.0 * torch.rand(3, h, w, generator=gen,
                                     device=cuda) - 6.0)
    sign = torch.where(torch.rand(3, h, w, generator=gen, device=cuda)
                       < 0.5, -1.0, 1.0)
    st = mag * sign
    st[2] = st[2].abs()
    st[:, 7] = 0.0
    st[2, 11] = 1e-30
    assert_same(smooth.fused_smooth_average,
                smooth.fused_smooth_average_plain, st, 1)
    assert_same(smooth.fused_smooth_average,
                smooth.fused_smooth_average_plain, st, 4)


def test_smooth_one_launch_up_to_k_passes(cuda):
    st = rand(cuda, 3, 40, 70, lo=0.05, hi=1.05, seed=6)
    k = smooth.max_chunk()
    assert k >= 10  # the default configs' 5 and 10 passes: one launch
    _build.reset_launch_counts()
    smooth.fused_smooth_average(st, k)
    smooth.fused_smooth_average(st, 2 * k + 3)
    torch.cuda.synchronize()
    assert _build.launch_counts() == {"smooth": 2}


def test_each_wrapper_counts_one_launch_per_call(cuda):
    _build.reset_launch_counts()
    x = rand(cuda, 3, 20, 40, lo=0.1, hi=1.0)
    blur.fused_blur_gaussian(x)
    smooth.fused_smooth_average(x, 3)
    warp.warp_nearest(x, x[0], x[1])
    warp.warp(x, x[0], x[1], "bilinear")
    direction.fused_direction_update(x, x, x, x, 1.0, False)
    resample.resample_tex(x, 10, 20, lambda v: v * 2.0)
    resample.resample_tex(x, 10, 20, lambda v: v * 2.0, method="bilinear")
    level.level_resident_match(x, x, x, (1.0, 0.5), 3, True)
    torch.cuda.synchronize()
    assert _build.launch_counts() == {
        "blur": 1, "smooth": 1, "warp": 1, "warp_bilinear": 1,
        "direction": 1, "resample": 1, "resample_bilinear": 1, "level": 1}


@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
def test_engine_on_card_matches_plain_engine(cuda, interp):
    rng = np.random.RandomState(21)
    base = rng.rand(96, 136, 3).astype(np.float32) * 255
    for _ in range(3):   # smooth the texture so correlation is informative
        base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) / 3
    left, right = base[:, 4:132], base[:, 2:130]   # shift of 2 px
    cfg = MatcherConfig(interp=interp)
    gpu = StereoEngine(cfg, device="cuda").match(left, right)
    cpu = StereoEngine(cfg, device="cpu").match(left, right)
    d = (gpu.triplet.cpu() - cpu.triplet).abs().numpy()
    assert np.median(d) < 1e-3 and (d > 0.02).mean() < 0.02
    assert abs(np.median(gpu.disparity_h.cpu().numpy()[12:-12, 12:-12]) - 2) < 0.5


# ------------------------------------------------ row-sharded forms
ROWS, COLS = 61, 300                     # 4 shards: 16, 16, 16, 13 rows
SHARDS = {"top": 0, "middle": 1, "bottom": 3}


def band(x, lo, hi):
    """Rows [lo, hi) of x (..., H, W) clamped to the image."""
    idx = torch.arange(lo, hi, device=x.device).clamp(0, x.shape[-2] - 1)
    return x.index_select(-2, idx).contiguous()


@pytest.mark.parametrize("field", ["random", "smooth"])
@pytest.mark.parametrize("shard", sorted(SHARDS))
@pytest.mark.parametrize("method", ["nearest", "bilinear"])
def test_warp_row_halo_bit_exact(cuda, method, shard, field):
    a, b = par.row_splits(ROWS, 4)[SHARDS[shard]]
    img = rand(cuda, 3, ROWS, COLS)
    if field == "smooth":
        dh, dv = smooth_field(cuda, ROWS, COLS)
    else:
        dh = rand(cuda, ROWS, COLS, lo=-60.0, hi=60.0, seed=1)
        dv = rand(cuda, ROWS, COLS, lo=-20.0, hi=20.0, seed=2)
    args = (img, dh[a:b].contiguous(), dv[a:b].contiguous(), method, a)
    assert_same(warp.warp, warp.warp_plain, *args)
    assert torch.equal(warp.warp(*args), warp.warp(img, dh, dv, method)[:, a:b])


@pytest.mark.parametrize("rows", [ROWS, 150])
@pytest.mark.parametrize("shard", sorted(SHARDS))
def test_direction_row_halo_bit_exact(cuda, shard, rows):
    """Shards as tall as the 16-row tile or shorter (61 rows: 16, 16, 16
    and 13) and taller (150 rows: 38 and 36)."""
    a, b = par.row_splits(rows, 4)[SHARDS[shard]]
    h = direction.HALO
    left = rand(cuda, 3, rows, COLS, hi=255.0, seed=3)
    warped = rand(cuda, 3, rows, COLS, hi=255.0, seed=4)
    bl2 = blur.fused_blur_gaussian_plain(left * left, "clamp")
    disp = rand(cuda, 3, rows, COLS, lo=-0.5, hi=0.5, seed=5)
    args = (band(left, a - h, b + h), band(warped, a - h, b + h),
            bl2[:, a:b].contiguous(), disp[:, a:b].contiguous(), 0.55,
            shard == "top", CONSTS, a, rows)
    assert_same(direction.fused_direction_update,
                direction.fused_direction_update_plain, *args)
    whole = direction.fused_direction_update(left, warped, bl2, disp, 0.55,
                                             shard == "top", CONSTS)
    assert torch.equal(direction.fused_direction_update(*args), whole[:, a:b])


@pytest.mark.parametrize("rows", [ROWS, 30])
@pytest.mark.parametrize("shard", sorted(SHARDS))
@pytest.mark.parametrize("n", [0, 1, 5, 10, "K+1", "2K+3"])
def test_smooth_row_halo_bit_exact(cuda, n, shard, rows):
    """Shards of 16 or 13 rows (61) and of 8 or 6 (30): from 10 passes on
    a shard is shorter than its halo."""
    n = passes(n)
    a, b = par.row_splits(rows, 4)[SHARDS[shard]]
    h = smooth.smooth_halo_rows(n)
    st = rand(cuda, 3, rows, COLS, lo=0.05, hi=1.05, seed=6)
    args = (band(st, a - h, b + h), n, a, rows)
    assert_same(smooth.fused_smooth_average,
                smooth.fused_smooth_average_plain, *args)
    whole = smooth.fused_smooth_average(st, n)
    assert torch.equal(smooth.fused_smooth_average(*args), whole[:, a:b])


def test_row_halo_wrappers_count_under_their_own_names(cuda):
    _build.reset_launch_counts()
    x = rand(cuda, 3, 20, 40, lo=0.1, hi=1.0)
    warp.warp(x, x[0, 4:9].contiguous(), x[1, 4:9].contiguous(), row0=4)
    warp.warp(x, x[0, :5].contiguous(), x[1, :5].contiguous(), "bilinear", 0)
    direction.fused_direction_update(x, x, x[:, 3:17].contiguous(),
                                     x[:, 3:17].contiguous(), 1.0, False,
                                     row0=3, global_h=20)
    smooth.fused_smooth_average(x, 2, row0=3, global_h=20)
    torch.cuda.synchronize()
    assert _build.launch_counts() == {
        "warp_row_halo": 1, "warp_bilinear_row_halo": 1,
        "direction_row_halo": 1, "smooth_row_halo": 1}


@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
@pytest.mark.parametrize("h,w,level_index,replace",
                         [(130, 200, 1, False), (301, 250, 6, True)])
def test_sharded_level_on_card_equals_match_level(cuda, interp, h, w,
                                                  level_index, replace):
    """Four shards on one card against the unsharded level (130 x 200 runs
    level-resident unsharded, 301 x 250 per iteration)."""
    cfg = MatcherConfig(interp=interp)
    left, right, state = _level_inputs(cuda, h, w)
    mesh = par.make_mesh(1, 4, devices=[cuda] * 4)
    ref = match_mod.match_level(left, right, state, level_index, cfg, replace)
    out = par.sharded_match_level(left, right, state, level_index, cfg,
                                  replace, mesh)
    assert torch.equal(out.gather(cuda), ref)


@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
def test_smoothing_beyond_level_kernel_runs_per_iteration(cuda, interp):
    """More passes than the level kernel's window holds: match_level takes
    the per-iteration route instead of raising, so its default gate and
    resident_max_pixels=0 give the same bits, and the engine returns."""
    cfg = MatcherConfig(interp=interp,
                        smooth_passes=level.max_smooth_passes(interp) + 1)
    left, right, state = _level_inputs(cuda, 34, 53)
    gated = match_mod.match_level(left, right, state, 6, cfg, True)
    per_iter = match_mod.match_level(left, right, state, 6, cfg, True,
                                     resident_max_pixels=0)
    assert torch.equal(gated, per_iter)
    l_np, r_np = scene.make_pair(96, 136)
    res = StereoEngine(cfg, device="cuda").match(l_np, r_np)
    assert torch.isfinite(res.triplet).all()


def test_match_batch_on_card_mesh_equals_match(cuda):
    pairs = [scene.make_pair(96, 136, seed=s) for s in (0, 1)]
    left = np.stack([p[0] for p in pairs])
    right = np.stack([p[1] for p in pairs])
    eng = StereoEngine(device="cuda")
    mesh = par.make_mesh(2, 2, devices=[cuda] * 4)
    res = eng.match_batch(left, right, mesh=mesh)
    for i in range(2):
        single = eng.match(left[i], right[i])
        assert torch.equal(res.disparity_h[i], single.disparity_h)
        assert torch.equal(res.disparity_v[i], single.disparity_v)
        assert torch.equal(res.confidence[i], single.confidence)


# ---------------------------------------------------------------- mode 2
# (source shape, full destination grid, window shape): the 16 MP fovea
# upsample (407 x 615 onto the 576 x 870 grid of level 5) and small odd
# ones; each window at the centre of its grid, as foveated_upsample
# takes it, and at the far corner.
WINDOWED_CASES = {"fovea16mp": ((3, 407, 615), (576, 870), (407, 615)),
                  "odd": ((3, 37, 53), (52, 75), (37, 53)),
                  "odd1": ((1, 23, 131), (33, 185), (17, 129))}


@pytest.mark.parametrize("where", ["centre", "far_corner"])
@pytest.mark.parametrize("method", ["nearest", "bilinear"])
@pytest.mark.parametrize("case", sorted(WINDOWED_CASES))
def test_resample_windowed_bit_exact(cuda, case, method, where):
    shape, (bh, bw), (wh, ww) = WINDOWED_CASES[case]
    r0, c0 = ((bh // 2 - wh // 2, bw // 2 - ww // 2) if where == "centre"
              else (bh - wh, bw - ww))
    img = rand(cuda, *shape, lo=-3.0, hi=3.0)

    def coord_of(v):
        return v * (1.0 / SCALE)
    if method == "nearest":
        iy, ix = (torch.from_numpy(resample.nearest_indices(n, m, coord_of,
                                                            off)).to(cuda)
                  for n, m, off in ((wh, shape[1], r0), (ww, shape[2], c0)))
        weights = ()
    else:
        (iy, wy), (ix, wx) = (
            (torch.from_numpy(a).to(cuda) for a in resample.bilinear_taps(
                n, m, coord_of, off))
            for n, m, off in ((wh, shape[1], r0), (ww, shape[2], c0)))
        weights = (wy, wx)
    win = resample.resample_tex(img, wh, ww, coord_of, SCALE, method,
                                row_off=r0, col_off=c0)
    assert torch.equal(win, resample.resample_static_plain(
        img, iy, ix, SCALE, *weights))
    whole = resample.resample_tex(img, bh, bw, coord_of, SCALE, method)
    assert torch.equal(win, whole[:, r0:r0 + wh, c0:c0 + ww])


@pytest.mark.parametrize("method", ["nearest", "bilinear"])
@pytest.mark.parametrize("level_index", [0, 1])
def test_level_resident_fovea_schedule_bit_exact(cuda, level_index, method):
    """Levels 0 and 1 of a 16 MP foveated match: 407 x 615, 2 and 4
    iterations of 10 smoothing passes, schedules mode 1 never gives the
    level kernel; through match_level both routes give the same bits."""
    cfg = MatcherConfig(interp=method)
    mi = cfg.iters_for_level(level_index)
    n = cfg.smooth_passes_for_level(level_index)
    assert (mi, n) == ((level_index + 1) * 2, 10)
    left, right, state = _level_inputs(cuda, 407, 615, seed=level_index)
    assert_same(level.level_resident_match, level.level_resident_match_plain,
                left, right, state, cfg.threshold_schedule(mi), n, False,
                cfg.conf_consts, method)
    assert match_mod.uses_level_resident(407, 615, None, n, mi, method, cuda)
    _build.reset_launch_counts()
    resident = match_mod.match_level(left, right, state, level_index, cfg,
                                     False)
    torch.cuda.synchronize()
    assert _build.launch_counts() == {"level": 1}
    assert torch.equal(resident, match_mod.match_level(
        left, right, state, level_index, cfg, False, resident_max_pixels=0))


@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
def test_foveated_engine_on_card_matches_plain_engine(cuda, interp):
    """match_foveated and match_hierarchical on the card against the CPU
    engine (each kernel's plain version) under the quantile rule; the
    per-iteration route gives the same bits; the hierarchical map's
    centred fovea window is stack level 0."""
    cfg = MatcherConfig(interp=interp, fovea_level=3)
    left, right = scene.make_pair(120, 168)
    gpu = StereoEngine(cfg, device="cuda")
    stack = gpu.match_foveated(left, right)
    cpu = StereoEngine(cfg, device="cpu").match_foveated(left, right)
    d = (torch.stack([stack.stack_h, stack.stack_v, stack.stack_c]).cpu()
         - torch.stack([cpu.stack_h, cpu.stack_v, cpu.stack_c])).abs()
    assert np.median(d.numpy()) < 1e-3 and (d > 0.02).float().mean() < 0.02
    torch.testing.assert_close(stack.stack_left.cpu(), cpu.stack_left,
                               rtol=1e-6, atol=1e-4)
    per_iter = StereoEngine(cfg, device="cuda", resident_max_pixels=0)
    assert torch.equal(per_iter.match_foveated(left, right).stack_h,
                       stack.stack_h)
    hier = gpu.match_hierarchical(left, right)
    ref = StereoEngine(cfg, device="cpu").match_hierarchical(left, right)
    d = (hier.triplet.cpu() - ref.triplet).abs().numpy()
    assert np.median(d) < 1e-3 and (d > 0.02).mean() < 0.02
    fh, fw = stack.roi_height, stack.roi_width
    top, lft = 120 // 2 - fh // 2, 168 // 2 - fw // 2
    assert torch.equal(hier.triplet[:, top:top + fh, lft:lft + fw],
                       torch.stack(stack.level_disparity(0)))
    dh0 = stack.level_disparity(0)[0].cpu().numpy()
    assert abs(np.median(dh0[8:-8, 8:-8]) - scene.SHIFT_PX) < 0.5


@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
def test_match_batch_foveated_on_card_mesh_equals_match_foveated(cuda,
                                                                 interp):
    """240 x 320 with fovea_level 3: the 120-row fovea levels run
    row-sharded (30 rows a shard) through the row-halo kernels on a 1 x 4
    mesh of this card, and the stack equals match_foveated bit for bit."""
    cfg = MatcherConfig(interp=interp, fovea_level=3)
    left, right = scene.make_pair(240, 320, seed=2)
    eng = StereoEngine(cfg, device="cuda")
    ref = eng.match_foveated(left, right)
    mesh = par.make_mesh(1, 4, devices=[cuda] * 4)
    _build.reset_launch_counts()
    res = eng.match_batch(left[None], right[None], mesh=mesh, foveated=True)
    torch.cuda.synchronize()
    assert _build.launch_counts().get("direction_row_halo", 0) > 0
    for name in ("stack_h", "stack_v", "stack_c"):
        assert torch.equal(getattr(res, name)[0], getattr(ref, name)), name


# ------------------------------------------------ extras and geometry
@pytest.mark.parametrize("interp,thr", [("nearest", 0.1), ("bilinear", 0.02)])
def test_early_exit_on_card_matches_plain_engine(cuda, interp, thr):
    """Early exit (the bench's thresholds) on the card against the CPU
    engine's per-iteration route under the quantile rule; the iterations
    that ran (warp launches) and the host reads are printed."""
    cfg = MatcherConfig(interp=interp, fovea_level=3, early_exit_delta=thr)
    left, right = scene.make_pair(120, 168)
    _build.reset_launch_counts()
    match_mod.reset_host_syncs()
    gpu = StereoEngine(cfg, device="cuda", resident_max_pixels=0).match(
        left, right)
    torch.cuda.synchronize()
    counts, syncs = _build.launch_counts(), match_mod.host_syncs()
    cpu = StereoEngine(cfg, device="cpu", resident_max_pixels=0).match(
        left, right)
    n = cfg.num_levels(120, 168)
    full = sum(cfg.iters_for_level(i) for i in range(n))
    form = "" if interp == "nearest" else "_bilinear"
    print(f"early exit {interp} {thr}: {counts[f'warp{form}']} of {full} "
          f"iterations, {syncs} host reads")
    assert counts[f"warp{form}"] == syncs <= full
    d = (gpu.triplet.cpu() - cpu.triplet).abs().numpy()
    assert np.median(d) < 1e-3 and (d > 0.02).mean() < 0.02


@pytest.mark.parametrize("method", ["nearest", "bilinear"])
def test_consistency_on_card_one_warp_of_two_planes(cuda, method):
    from ug_stereomatcher_tpu_torch.ops import consistency
    fh, fv, bh, bv = (rand(cuda, 61, 300, lo=-3.0, hi=3.0, seed=s)
                      for s in range(4))
    _build.reset_launch_counts()
    mask, err = consistency.lr_consistency_mask(fh, fv, bh, bv, 1.0, method)
    torch.cuda.synchronize()
    assert _build.launch_counts() == {COUNTERS[method]: 1}
    back = warp.warp_plain(torch.stack([bh, bv]), fh, fv, method)
    eh, ev = fh + back[0], fv + back[1]
    assert torch.equal(err, torch.sqrt(eh * eh + ev * ev))
    ref_mask, ref_err = consistency.lr_consistency_mask(
        *(x.cpu() for x in (fh, fv, bh, bv)), 1.0, method)
    torch.testing.assert_close(err.cpu(), ref_err, rtol=2.5e-7, atol=0)
    away = (ref_err - 1.0).abs() > 1e-5
    assert torch.equal(mask.cpu()[away], ref_mask[away])


COUNTERS = {"nearest": "warp", "bilinear": "warp_bilinear"}


def test_profile_match_on_card_equals_match(cuda):
    left, right = scene.make_pair(120, 168)
    for gate in (None, 0):
        eng = StereoEngine(MatcherConfig(fovea_level=3), device="cuda",
                           resident_max_pixels=gate)
        res, prof = eng.profile_match(left, right)
        assert torch.equal(res.triplet, eng.match(left, right).triplet)
        assert len(prof["levels"]) == MatcherConfig().num_levels(120, 168)


def test_geometry_on_card_matches_cpu(cuda):
    """Triangulation on the card against the CPU under the relative
    quantile rule; the bilinear range-map resize (the resample kernel)
    equals its plain version, the cubic one (plain torch) the CPU's."""
    from ug_stereomatcher_tpu_torch import geom
    from ug_stereomatcher_tpu_torch.geom.pointcloud import _resize
    th = 0.03
    K = np.array([[5390.0, 0, 2464.0], [0, 5313.0, 1632.0], [0, 0, 1.0]])
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                  [-np.sin(th), 0, np.cos(th)]])
    P1 = np.c_[K, np.zeros(3)]
    P2 = K @ np.c_[R, [-0.1, 0.0, 0.0]]
    dh = rand(cuda, 326, 492, lo=150.0, hi=170.0, seed=1)
    dv = rand(cuda, 326, 492, lo=-0.5, hi=0.5, seed=2)
    out = geom.triangulate_disparity(P1, P2, dh, dv)
    ref = geom.triangulate_disparity(P1, P2, dh.cpu(), dv.cpu())
    for o, r in zip(out, ref):
        assert o.is_cuda
        rel = ((o.cpu() - r).abs() / r.abs().clamp_min(1e-12)).double()
        assert torch.isfinite(o).all()
        assert rel.quantile(0.5) <= 1e-5 and rel.quantile(0.99) <= 1e-3
    z = out[2]
    _build.reset_launch_counts()
    zb = _resize(z, 65, 98, 5.0, "bilinear")
    torch.cuda.synchronize()
    assert _build.launch_counts() == {"resample_bilinear": 1}
    assert torch.equal(zb.cpu(), _resize(z.cpu(), 65, 98, 5.0, "bilinear"))
    zc = _resize(z, 65, 98, 5.0, "cubic")
    torch.testing.assert_close(zc.cpu(), _resize(z.cpu(), 65, 98, 5.0,
                                                 "cubic"),
                               rtol=1e-6, atol=0)


# ------------------------------------------- host layers on card results
def test_host_layers_take_results_on_the_card(cuda, tmp_path):
    """Dumps, the service, epe_metrics and the colour panel bring CUDA
    planes to the host (np.asarray of a CUDA tensor raises)."""
    from ug_stereomatcher_tpu_torch import eval as tev
    from ug_stereomatcher_tpu_torch import io as tio
    from ug_stereomatcher_tpu_torch.io import viz
    from ug_stereomatcher_tpu_torch.pipeline import DisparityService
    from ug_stereomatcher_tpu_torch.pipeline.messages import (
        GetDisparitiesRequest)
    left, right, gh, gv = tev.synthetic_scene("sine", 120, 168)
    eng = StereoEngine(MatcherConfig(fovea_level=3), device="cuda")
    res = eng.match(left, right)
    assert res.disparity_h.is_cuda
    paths = tio.save_disparity_maps(res, str(tmp_path / "d"), ext=".npy")
    planes = (res.disparity_h, res.disparity_v, res.confidence)
    for tag, plane in zip("HVC", planes):
        assert np.array_equal(np.load(paths[tag]), plane.cpu().numpy())
    rsp = DisparityService(eng)(GetDisparitiesRequest(left=left,
                                                      right=right))
    for msg, plane in zip((rsp.disp_h, rsp.disp_v, rsp.disp_c), planes):
        assert np.array_equal(msg.image, plane.cpu().numpy())
    st = eng.match_foveated(left, right)
    rsp = DisparityService(eng, foveated=True)(
        GetDisparitiesRequest(left=left, right=right))
    assert np.array_equal(rsp.fdisp_h.image_stack, st.stack_h.cpu().numpy())
    rep = tev.epe_metrics(res.disparity_h, res.disparity_v, gh, gv,
                          margin=16)
    assert rep == tev.epe_metrics(res.disparity_h.cpu(),
                                  res.disparity_v.cpu(), gh, gv, margin=16)
    panel = np.load(viz.render_panel(res, str(tmp_path / "p.npy")))
    assert panel.shape == (120, 3 * 168, 3)


def test_batch_runner_on_card_dumps_equal_match(cuda, tmp_path):
    from ug_stereomatcher_tpu_torch.pipeline import (BatchRunner,
                                                     ImageListCapture)
    paths, pairs = [], []
    for seed in (0, 1):
        pair = scene.make_pair(816, 1232, seed=seed)
        for side, img in zip("lr", pair):
            p = str(tmp_path / f"{side}{seed}.npy")
            np.save(p, img)
            paths.append(p)
        pairs.append(pair)
    man = tmp_path / "pairs.txt"
    man.write_text("\n".join(paths))
    eng = StereoEngine(device="cuda")
    out = BatchRunner(eng, out_dir=str(tmp_path / "o"), dump_ext=".npy").run(
        ImageListCapture(str(man)))
    assert [r.index for r in out] == [0, 1]
    for r, (left, right) in zip(out, pairs):
        ref = eng.match(left, right)
        for tag, plane in zip("HVC", (ref.disparity_h, ref.disparity_v,
                                      ref.confidence)):
            assert np.array_equal(np.load(r.dump_paths[tag]),
                                  plane.cpu().numpy())


def test_cli_on_card(cuda, tmp_path):
    """python -m ug_stereomatcher_tpu_torch match --device cuda in a fresh
    process writes the planes of StereoEngine.match on the card."""
    import json
    import os
    import subprocess
    import sys
    left, right = scene.make_pair(240, 320)
    np.save(tmp_path / "l.npy", left)
    np.save(tmp_path / "r.npy", right)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "ug_stereomatcher_tpu_torch", "match",
         str(tmp_path / "l.npy"), str(tmp_path / "r.npy"), "-o",
         str(tmp_path / "o"), "--ext", ".npy", "--device", "cuda"],
        cwd=repo, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    outputs = json.loads(proc.stdout.strip().splitlines()[-1])["outputs"]
    ref = StereoEngine(device="cuda").match(left, right)
    assert np.array_equal(np.load(outputs["H"]),
                          ref.disparity_h.cpu().numpy())
