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
Early exit: the convergence kernel against its plain version (1e-5
relative; 2e-6 of float64) and its flag, the guarded warp, direction and
smooth writing nothing with the flag set and bit-equal with it clear.
Extras and geometry: early exit on the card with no host read, each level
equal to the host-read loop on the card, against the CPU engine under
the quantile rule, the left-right check through one warp launch on a
2-plane stack, profile_match equal to match bit for bit, triangulation
under a relative-quantile rule and the range-map resizes against the CPU.
Host layers: dumps, the service, epe_metrics and the colour panel on
results that lie on the card, BatchRunner's dumps equal to match, and
``python -m ug_stereomatcher_tpu_torch match --device cuda``.  The
scaling harness: measure_throughput dp on the card repeated.  The bench:
BENCH_MODE=mode1 at 816 x 1232 through bench.main(), its gates passed.
The CUDA graphs (graphs.py): every captured entry point bit-equal to the
eager module path with the same launch counts, early-exit iterations
and no host read, on the capture and on replays with other inputs; a
graph per key and engine, fresh outputs, the level kernel's cooperative
launch captured alone, and a capture that reads the host, or finds
taps not yet on the card, raising.  The mesh route's graphs: dp [cuda:0]
* 2, sp 1 x 4 and hybrid 2 x 2 of this card, modes 1 and 2, with and
without early exit (on the replicated levels), bit-equal to the eager
matcher with its counts, on the capture and on a replay of another
scene, and to match per pair where no level is sharded under early
exit; measure_throughput's dp and sp points at 408 x 616 replaying;
profile_match's stage graphs bit-equal to the eager match with its
counts; a dp mesh across two cards (a graph per card) and a rows-group
across them (one graph across both).  A rows-group across cards at 16
MP (1 x 2, 1 x 4, the 2 x 2 hybrid over four; nearest, bilinear,
foveated, early exit): one graph a group, bit-equal to the eager matcher
with its counts and to one card's match; 20 replays with another card
asleep each time, bit-equal; a failed capture across cards naming them.
These skip on a machine with too few cards:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py \
        -k "across or sleeping"
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
# The point cloud's range map: the x5 downsample of one plane.
RESAMPLE_CASES["range_map_x5"] = ((1, 163, 247), (32, 49), lambda v: v * 5.0,
                                  1.0)


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


# (rows, planes, warps) of the bilinear kernel, forced: each strip height
# with all planes in a block and 8 warps, fewer planes a block, fewer
# warps (resample.bilinear_launch picks one of these for each output).
LAUNCH_SHAPES = [(4, 6, 8), (2, 6, 8), (2, 3, 8), (1, 2, 8), (1, 1, 4),
                 (4, 2, 1), (1, 1, 1)]
# (coordinate scale, value scale): the sqrt(2) and x2 subsamples of the
# pyramid, the value-scaled sqrt(2) upsample of the state.
BILINEAR_MAPS = [(SCALE, 1.0), (2.0, 0.5), (1.0 / SCALE, SCALE)]


def bilinear_case(dev, c, h2, w2, s, seed=0):
    """A source for an (h2, w2) output at coordinate scale ``s``, its
    taps on the card."""
    h, w = max(2, int(np.ceil(h2 * s)) + 2), max(2, int(np.ceil(w2 * s)) + 2)
    img = rand(dev, c, h, w, hi=4.0, seed=seed)
    (iy, wy), (ix, wx) = (
        (torch.from_numpy(a).to(dev) for a in resample.bilinear_taps(
            n, m, lambda v: v * s)) for n, m in ((h2, h), (w2, w)))
    return img, iy, ix, wy, wx


@pytest.mark.parametrize("shape", LAUNCH_SHAPES)
@pytest.mark.parametrize("channels", [1, 3, 6])
def test_resample_bilinear_every_launch_shape_bit_exact(cuda, monkeypatch,
                                                        shape, channels):
    """Outputs one row short of a strip, at one strip and one row past
    it, and the same about a block's rows, at each forced launch shape."""
    rows, planes, warps = shape
    planes = min(planes, channels)
    monkeypatch.setattr(resample, "bilinear_launch",
                        lambda *a: (rows, planes, warps))
    for h2 in sorted({rows - 1, rows, rows + 1, rows * warps - 1,
                      rows * warps, rows * warps + 1} - {0}):
        for s, vs in BILINEAR_MAPS:
            img, iy, ix, wy, wx = bilinear_case(cuda, channels, h2, 131, s)
            assert_same(resample.resample_static,
                        resample.resample_static_plain, img, iy, ix, vs, wy,
                        wx)


def test_resample_bilinear_every_column_residue_bit_exact(cuda, monkeypatch):
    """W2 at every residue modulo the 128 columns a warp covers."""
    for shape in ((4, 3, 8), (1, 1, 1)):
        monkeypatch.setattr(resample, "bilinear_launch", lambda *a: shape)
        for w2 in range(128, 256):
            img, iy, ix, wy, wx = bilinear_case(cuda, 3, 9, w2, 2.0)
            assert_same(resample.resample_static,
                        resample.resample_static_plain, img, iy, ix, 0.5, wy,
                        wx)


@pytest.mark.parametrize("forced", [False, True])
def test_resample_bilinear_strip_loop_second_wave(cuda, monkeypatch, forced):
    """More strips than the grid's 65535 rows of blocks: the strip loop
    runs a second time (forced to one row and one warp a block, or the
    launch bilinear_launch picks for a tall, narrow output)."""
    if forced:
        monkeypatch.setattr(resample, "bilinear_launch",
                            lambda *a: (1, 1, 1))
        h2 = resample.MAX_GRID_Y + 37
    else:
        rows, _, warps = resample.bilinear_launch(
            1, 70 * resample.MAX_GRID_Y, 2, 132)
        h2 = resample.MAX_GRID_Y * rows * warps + 37
    img, iy, ix, wy, wx = bilinear_case(cuda, 2 if forced else 1, h2, 3,
                                        0.001)
    assert_same(resample.resample_static, resample.resample_static_plain,
                img, iy, ix, 1.0, wy, wx)


def test_packed_tap_upload_equals_separate_uploads(cuda):
    """One copy of the packed taps gives the tensors four copies give."""
    (iy, wy), (ix, wx) = (resample.bilinear_taps(97, 68, lambda v: v / SCALE),
                          resample.bilinear_taps(211, 149,
                                                 lambda v: v / SCALE))
    packed = resample.upload_taps(cuda, (iy, ix, wy, wx))
    for a, host in zip(packed, (iy, ix, wy, wx)):
        b = torch.from_numpy(host).to(cuda)
        assert a.device == b.device and a.dtype == b.dtype
        assert a.shape == b.shape and a.is_contiguous()
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


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


# ------------------------------------------- early exit on the card
def conv_states(dev, h, w, seed=0):
    new = torch.stack([rand(dev, h, w, lo=-3.0, hi=3.0, seed=seed),
                       rand(dev, h, w, lo=-1.0, hi=1.0, seed=seed + 1),
                       rand(dev, h, w, lo=0.0, hi=1.0, seed=seed + 2)])
    old = new + torch.stack([rand(dev, h, w, lo=-0.2, hi=0.2, seed=seed + s)
                             for s in (3, 4, 5)])
    return new, old


def changes_f64(new, old):
    """(dh, dv) in float64 from the float32 products, as the kernel and
    the plain version round them."""
    c = new[2]
    return [((new[k] - old[k]).abs() * c).double().sum().item()
            / c.double().sum().item() for k in (0, 1)]


# a ragged pixel count (no 16-byte loads), one block, many blocks (the
# grid capped, each thread several float4s), level 5 of 16 MP
@pytest.mark.parametrize("h,w", [(1, 1), (7, 13), (33, 64), (301, 517),
                                 (576, 870)])
def test_convergence_kernel_matches_plain(cuda, h, w):
    """(dh, dv) within 1e-5 relative of the plain version (float32 sums)
    and 2e-6 of float64, the same bits on a second run; the flag set as
    the plain version sets it, and nothing done once it is set."""
    from ug_stereomatcher_tpu_torch.ops.cuda import convergence as conv
    new, old = conv_states(cuda, h, w)
    gold = changes_f64(new, old)
    for thr in (None, 0.0, max(gold) * 1.01, float("inf")):
        got = conv.convergence_step(new, old, 1, conv.level_buffer(3, cuda),
                                    thr)
        again = conv.convergence_step(new, old, 1,
                                      conv.level_buffer(3, cuda), thr)
        ref = conv.convergence_step_plain(new, old, 1,
                                          conv.level_buffer(3, cuda), thr)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        d, dref = conv.deltas(got), conv.deltas(ref)
        torch.testing.assert_close(d, dref, rtol=1e-5, atol=0)
        np.testing.assert_allclose(d[1].cpu().numpy(), gold, rtol=2e-6)
        assert (d[[0, 2]] == 0).all()
        assert got[:2].tolist() == ref[:2].tolist() == [
            int(thr is not None and thr > max(gold)), 1]
        assert got[2].item() == 0   # the ticket, back to 0
    before = got.clone()
    conv.convergence_step(old, new, 2, got, 0.0)   # the flag is set
    torch.cuda.synchronize()
    assert torch.equal(got, before)


@pytest.mark.parametrize("case", ["nan_change", "zero_confidence"])
def test_convergence_kernel_nan_and_zero_confidence(cuda, case):
    """A NaN change stops the level at any threshold (the max carries it);
    an all-zero confidence gives 0: both as the plain version."""
    from ug_stereomatcher_tpu_torch.ops.cuda import convergence as conv
    new, old = conv_states(cuda, 40, 64, seed=3)
    if case == "nan_change":
        new[1, 5, 6] = float("nan")
    else:
        new[2] = 0.0
    for thr in (0.0, 0.1):
        got = conv.convergence_step(new, old, 0, conv.level_buffer(1, cuda),
                                    thr)
        ref = conv.convergence_step_plain(new, old, 0,
                                          conv.level_buffer(1, cuda), thr)
        torch.cuda.synchronize()
        torch.testing.assert_close(conv.deltas(got), conv.deltas(ref),
                                   rtol=1e-5, atol=0, equal_nan=True)
        assert got[0].item() == ref[0].item() == int(
            case == "nan_change" or thr > 0)


def guarded_kernel_cases(dev, h, w):
    left = rand(dev, 3, h, w, hi=255.0, seed=1)
    warped = torch.clamp(left + rand(dev, 3, h, w, lo=-20.0, hi=20.0,
                                     seed=2), 0, 255)
    state = torch.stack([rand(dev, h, w, lo=-2.0, hi=5.0, seed=3),
                         rand(dev, h, w, lo=-1.0, hi=1.0, seed=4),
                         rand(dev, h, w, lo=0.05, hi=1.0, seed=5)])
    bl2 = blur.fused_blur_gaussian_plain(left * left, "clamp")
    return [(warp.warp, (left, state[0], state[1], m))
            for m in ("nearest", "bilinear")] + [
        (direction.fused_direction_update,
         (left, warped, bl2, state, 0.55, False, CONSTS)),
        (smooth.fused_smooth_average, (state, 5)),
        (smooth.fused_smooth_average, (state, 2 * smooth.max_chunk() + 3))]


@pytest.mark.parametrize("h,w", [(37, 53), (202, 306)])
def test_guarded_kernels(cuda, h, w):
    """With the flag set, warp, direction and smooth (one launch and
    several) leave their output as it was (a NaN sentinel); with it clear
    they write what the unguarded launch writes, bit for bit, and count
    one launch a call either way."""
    for fn, args in guarded_kernel_cases(cuda, h, w):
        ref = fn(*args)
        flag = torch.ones(1, dtype=torch.int32, device=cuda)
        out = torch.full_like(ref, float("nan"))
        _build.reset_launch_counts()
        assert fn(*args, stop=flag, out=out) is out
        torch.cuda.synchronize()
        assert torch.isnan(out).all(), fn.__name__
        flag.zero_()
        assert torch.equal(fn(*args, stop=flag, out=out), ref)
        torch.cuda.synchronize()
        assert sum(_build.launch_counts().values()) == 2


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
                  "odd1": ((1, 23, 131), (33, 185), (17, 129)),
                  "wide6": ((6, 70, 300), (99, 424), (70, 300))}


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
    """Early exit (the bench's thresholds) on the card: no host read, the
    whole schedule launched (a convergence test an iteration), and each
    level driven alone stops where the host-read loop stops on the card,
    with the same bits; against the CPU engine's per-iteration route under
    the quantile rule."""
    from ug_stereomatcher_tpu_torch import pyramid as pyr
    cfg = MatcherConfig(interp=interp, fovea_level=3, early_exit_delta=thr)
    left, right = scene.make_pair(120, 168)
    _build.reset_launch_counts()
    match_mod.reset_host_syncs()
    gpu = StereoEngine(cfg, device="cuda", resident_max_pixels=0).match(
        left, right)
    torch.cuda.synchronize()
    counts, syncs = _build.launch_counts(), match_mod.host_syncs()
    iters = match_mod.iterations_run()
    cpu = StereoEngine(cfg, device="cpu", resident_max_pixels=0).match(
        left, right)
    n = cfg.num_levels(120, 168)
    full = sum(cfg.iters_for_level(i) for i in range(n))
    form = "" if interp == "nearest" else "_bilinear"
    print(f"early exit {interp} {thr}: {iters} of {full} iterations, "
          f"{syncs} host reads")
    assert syncs == 0 and 0 < iters <= full
    assert counts[f"warp{form}"] == counts["direction"] == full
    assert counts["convergence"] == sum(
        cfg.iters_for_level(i) for i in range(n)
        if cfg.iters_for_level(i) > 1)
    d = (gpu.triplet.cpu() - cpu.triplet).abs().numpy()
    assert np.median(d) < 1e-3 and (d > 0.02).mean() < 0.02

    lp, rp = pyr.build_pyramid_pair(
        *(torch.from_numpy(x).to(cuda).movedim(-1, 0).float().contiguous()
          for x in (left, right)), cfg, n)
    state = torch.zeros((3,) + tuple(lp[n - 1].shape[-2:]), device=cuda)
    total = 0
    for i in range(n - 1, -1, -1):
        match_mod.reset_host_syncs()
        ref = match_mod.match_level(lp[i], rp[i], state, i, cfg, i == n - 1,
                                    0, exit_loop="host")
        host_iters = match_mod.host_syncs()
        match_mod.reset_host_syncs()
        state = match_mod.match_level(lp[i], rp[i], state, i, cfg,
                                      i == n - 1, 0)
        assert match_mod.iterations_run() == host_iters, i
        assert torch.equal(state, ref), i
        total += host_iters
        if i:
            state = pyr.upsample_to_level(state, *lp[i - 1].shape[-2:], cfg)
    assert total == iters and torch.equal(state, gpu.triplet)


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


# ------------------------------------------------------ scaling harness
def test_measure_throughput_dp_on_one_card_repeated(cuda):
    pts = par.measure_throughput(96, 128, device_counts=[1, 2], repeats=1,
                                 devices=[cuda] * 2)
    assert [p.mesh_shape for p in pts] == [(1, 1), (2, 1)]
    assert all(p.pairs_per_second > 0 for p in pts)
    assert [p.oversubscribed for p in pts] == [False, True]


# ------------------------------------------------------------- the bench
def test_bench_mode1_on_card(cuda, monkeypatch, capsys):
    """bench.main() with BENCH_MODE=mode1 at 816 x 1232 on the card: rc
    0, the value gates passed, and the line names the card."""
    import json

    from ug_stereomatcher_tpu_torch import bench
    monkeypatch.delenv("BENCH_PLATFORM", raising=False)
    for k, v in {"BENCH_MODE": "mode1", "BENCH_H": "816", "BENCH_W": "1232",
                 "BENCH_REPEATS": "3"}.items():
        monkeypatch.setenv(k, v)
    assert bench.main() == 0
    (out,) = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out)
    assert line["metric"] == "mode1_disparity_latency_816x1232"
    extra = line["extra"]
    assert extra["device"] == torch.cuda.get_device_name()
    assert extra["power_limit_w"] > 0
    v = extra["values"]
    assert v["med_abs_dh_err"] < 0.5 and v["mean_abs_dv"] < 0.5
    assert v["frac_dh_err_lt_1"] > 0.9
    assert line["value"] == min(extra["all_runs_s"]) > 0


# ------------------------------------------------ compile once, replay
GH, GW = 192, 256        # 10 levels; fovea_level=3 gives a 96 x 128 fovea
GRAPH_CASES = {
    # (entry, config fields, resident_max_pixels)
    "mode1_nearest": ("match", {}, None),
    "mode1_nearest_per_iteration": ("match", {}, 0),
    "mode1_bilinear": ("match", {"interp": "bilinear"}, None),
    "mode1_nearest_ee": ("match", {"early_exit_delta": 0.1}, 0),
    "mode1_bilinear_ee": ("match", {"interp": "bilinear",
                                    "early_exit_delta": 0.02}, 0),
    "mode2_nearest": ("match_foveated", {}, None),
    "mode2_bilinear": ("match_foveated", {"interp": "bilinear"}, None),
    "hierarchical": ("match_hierarchical", {}, None),
    "batch": ("match_batch", {}, None),
    "batch_foveated": ("match_batch_foveated", {}, None),
}


def chw(dev, img):
    return torch.from_numpy(img).to(dev).movedim(-1, 0).float().contiguous()


def graph_inputs(entry, seed):
    """The entry point's inputs (host uint8, as a caller passes them)."""
    if entry.startswith("match_batch"):
        pairs = [scene.make_pair(GH, GW, seed=seed + k) for k in range(2)]
        return tuple(np.stack([p[i] for p in pairs]) for i in (0, 1))
    return scene.make_pair(GH, GW, seed=seed)


def eager_call(dev, entry, cfg, gate, inputs):
    """The eager module path of one entry point on the card, as one
    tensor (or a tuple for mode 2's stacks)."""
    from ug_stereomatcher_tpu_torch import pyramid as pyr
    from ug_stereomatcher_tpu_torch.parallel.batch import make_batch_matcher
    if entry.startswith("match_batch"):
        lb, rb = (torch.stack([chw(dev, x) for x in b]) for b in inputs)
        return make_batch_matcher(cfg, None, dev, entry.endswith("foveated"),
                                  capture=False)(lb, rb)
    left, right = (chw(dev, x) for x in inputs)
    if entry == "match":
        n = cfg.num_levels(GH, GW)
        lp, rp = pyr.build_pyramid_pair(left, right, cfg, n)
        return match_mod.match_pyramid(lp, rp, cfg, (GH, GW),
                                       resident_max_pixels=gate).levels[0]
    levels, lf, rf = match_mod.match_foveated_pair(left, right, cfg, gate)
    if entry == "match_hierarchical":
        return pyr.hierarchical_disparity(levels, cfg, (GH, GW))
    k = cfg.fovea_level
    return (torch.cat(levels[:k], dim=-2),
            *(torch.cat([x.flatten(0, 1) for x in f[:k]]) for f in (lf, rf)))


def engine_call(eng, entry, inputs):
    """The engine's entry point, as eager_call returns it."""
    if entry.startswith("match_batch"):
        res = eng.match_batch(*inputs, foveated=entry.endswith("foveated"))
        planes = ((res.stack_h, res.stack_v, res.stack_c)
                  if entry.endswith("foveated") else
                  (res.disparity_h, res.disparity_v, res.confidence))
        return torch.stack(planes, dim=1)
    res = getattr(eng, entry)(*inputs)
    if entry == "match_foveated":
        return (torch.stack([res.stack_h, res.stack_v, res.stack_c]),
                res.stack_left, res.stack_right)
    return res.triplet


def n_graphs(eng):
    """The engine's CUDA graphs: its entry points' and its batch
    matchers' (one a batch shape and card)."""
    return len(eng.graphs) + sum(len(calls) for m in eng.matchers.values()
                                 for calls in m.graphs.values())


def counted(call):
    """call()'s result, launch counts and early-exit counts, the counters
    set to 0 just before it and read after a synchronise."""
    _build.reset_launch_counts()
    match_mod.reset_host_syncs()
    out = call()
    torch.cuda.synchronize()
    return (out, _build.launch_counts(), match_mod.iterations_run(),
            match_mod.host_syncs(), _build.graph_replays())


def assert_bits(a, b):
    a, b = (x if isinstance(x, tuple) else (x,) for x in (a, b))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape and torch.equal(x, y), (
            (x - y).abs().max().item())


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_entry_point_graph_equals_eager_bit_for_bit(cuda, case):
    """Each captured entry point against the eager module path on the
    same inputs: bit for bit, the same launch counts, early-exit
    iterations and no host read, on the first call (the capture) and on
    a replay with other inputs; a replay leaves earlier results as they
    were, and the key's graph is captured once."""
    entry, fields, gate = GRAPH_CASES[case]
    cfg = MatcherConfig(fovea_level=3, **fields)
    eng = StereoEngine(cfg, device="cuda", resident_max_pixels=gate)
    results = []
    for seed, replays in ((0, 1), (5, 1), (0, 1)):
        inputs = graph_inputs(entry, seed)
        ref, ref_counts, ref_iters, _, _ = counted(
            lambda: eager_call(cuda, entry, cfg, gate, inputs))
        out, counts, iters, syncs, n_replays = counted(
            lambda: engine_call(eng, entry, inputs))
        assert_bits(out, ref)
        assert counts == ref_counts and iters == ref_iters
        assert syncs == 0 and n_replays == replays
        results.append((out, ref))
    for out, ref in results:     # no later call changed an earlier result
        assert_bits(out, ref)
    assert_bits(results[0][0], results[2][0])
    assert n_graphs(eng) == 1
    if cfg.early_exit_delta is not None:   # some level exits early
        assert 0 < ref_iters < sum(cfg.iters_for_level(i)
                                   for i in range(cfg.num_levels(GH, GW)))


def test_warmup_captures_the_served_graph(cuda):
    cfg = MatcherConfig(fovea_level=3)
    eng = StereoEngine(cfg, device="cuda")
    eng.warmup(GH, GW)
    eng.warmup(GH, GW, foveated=True)
    assert len(eng.graphs) == 2
    left, right = scene.make_pair(GH, GW)
    _build.reset_launch_counts()
    d1 = eng.get_disparities(left, right)
    d2 = eng.get_disparities(left, right, foveated=True)
    assert _build.graph_replays() == 2 and len(eng.graphs) == 2
    assert_bits(d1.triplet, eager_call(cuda, "match", cfg, None,
                                       (left, right)))
    assert_bits(torch.stack([d2.stack_h, d2.stack_v, d2.stack_c]),
                eager_call(cuda, "match_foveated", cfg, None,
                           (left, right))[0])


def test_a_new_shape_or_config_captures_a_new_graph(cuda):
    cfg = MatcherConfig(fovea_level=3)
    eng = StereoEngine(cfg, device="cuda")
    a = scene.make_pair(GH, GW)
    b = scene.make_pair(GH + 8, GW - 8)
    for pair, n_graphs in ((a, 1), (a, 1), (b, 2), (a, 2), (b, 2)):
        eng.match(*pair)
        assert len(eng.graphs) == n_graphs
    eng.match_foveated(*a)
    assert len(eng.graphs) == 3
    # a float CHW tensor on the card takes the uint8 HWC pair's graph
    eng.match(chw(cuda, a[0]), chw(cuda, a[1]))
    assert len(eng.graphs) == 3
    other = StereoEngine(MatcherConfig(fovea_level=3, interp="bilinear"),
                         device="cuda")
    other.match(*a)
    assert len(other.graphs) == 1 and len(eng.graphs) == 3
    keys = set(eng.graphs) | set(other.graphs)
    assert len(keys) == 4


def test_two_engines_share_no_outputs(cuda):
    cfg = MatcherConfig(fovea_level=3)
    e1, e2 = (StereoEngine(cfg, device="cuda") for _ in range(2))
    a, b = scene.make_pair(GH, GW, seed=0), scene.make_pair(GH, GW, seed=3)
    r1 = e1.match(*a).triplet
    r2 = e2.match(*a).triplet
    assert torch.equal(r1, r2) and r1.data_ptr() != r2.data_ptr()
    keep = r1.clone()
    e2.match(*b)
    e1.match(*b)
    assert torch.equal(r1, keep)
    r2.zero_()
    assert torch.equal(e1.match(*a).triplet, keep)


def test_level_kernel_captured_alone_bit_exact(cuda):
    """The cooperative launch inside a CUDA graph: the level kernel's
    replay equals its eager launch, on other inputs too."""
    from ug_stereomatcher_tpu_torch.graphs import CapturedCall
    thr = (1.0, 0.8, 0.6)
    for method in ("nearest", "bilinear"):
        def fn(left, right, disp):
            return level.level_resident_match(left, right, disp, thr, 5,
                                              True, CONSTS, method)
        call = CapturedCall(fn, [(3, 101, 153)] * 3, cuda)
        for seed in (0, 1):
            args = _level_inputs(cuda, 101, 153, seed)
            want = fn(*args)
            _build.reset_launch_counts()
            got = call(*args)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
            assert _build.launch_counts() == {"level": 1}


# The failed captures last: a capture that a call refuses ends that
# capture, and the tests above need none.
def test_taps_not_on_the_card_refuse_a_capture(cuda):
    from ug_stereomatcher_tpu_torch.graphs import CapturedCall
    from ug_stereomatcher_tpu_torch.ops.resample import ScaleMap

    x = rand(cuda, 3, 40, 60)
    seen = []

    def fn(img):
        # a new key on each run: the capture finds no taps on the card
        seen.append(len(seen))
        return resample.resample_tex(img, 20 + len(seen), 30,
                                     ScaleMap(2.0))
    call = CapturedCall(fn, [(3, 40, 60)], cuda)
    with pytest.raises(RuntimeError, match="capture"):
        call(x)
    assert call.graph is None


def test_a_host_read_in_the_capture_raises(cuda, monkeypatch):
    """A call that reads the host during capture makes the engine raise,
    on every call: nothing runs eagerly in its place."""
    eng = StereoEngine(MatcherConfig(fovea_level=3), device="cuda")
    real = match_mod.match_pyramid

    def reads_host(*args, **kwargs):
        res = real(*args, **kwargs)
        res.levels[0].sum().item()
        return res
    monkeypatch.setattr(match_mod, "match_pyramid", reads_host)
    left, right = scene.make_pair(GH, GW)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capture"):
            eng.match(left, right)
    (call,) = eng.graphs.values()
    assert call.graph is None


# ------------------------------------ the mesh route and profile_match
MESH_ROUTES = {"dp": (2, 1, 3), "sp": (1, 4, 1), "hybrid": (2, 2, 3)}


def batch_on(dev, b, seed):
    """b scene pairs as uint8 (B, H, W, 3) batches on ``dev``, and their
    float32 (B, 3, H, W) form."""
    pairs = [scene.make_pair(GH, GW, seed=seed + k) for k in range(b)]
    raw = [torch.from_numpy(np.stack([p[i] for p in pairs])).to(dev)
           for i in (0, 1)]
    return raw, [x.movedim(-1, 1).float().contiguous() for x in raw]


def batch_planes(res, foveated):
    names = (("stack_h", "stack_v", "stack_c") if foveated else
             ("disparity_h", "disparity_v", "confidence"))
    return torch.stack([getattr(res, n) for n in names], dim=1)


@pytest.mark.parametrize("ee", [False, True])
@pytest.mark.parametrize("foveated", [False, True])
@pytest.mark.parametrize("route", sorted(MESH_ROUTES))
def test_mesh_route_graph_equals_eager_bit_for_bit(cuda, route, foveated,
                                                   ee):
    """The engine's mesh route on this card against the eager matcher:
    bit for bit, the same launch counts, early-exit iterations and no
    host read, one replay a call, on the capture and on a replay of
    another scene, the first result unchanged; each pair equal to match
    (match_foveated) where no level is sharded under early exit, and the
    sharded warning on every call, replays included."""
    import warnings

    from ug_stereomatcher_tpu_torch.parallel.batch import make_batch_matcher
    p, r, b = MESH_ROUTES[route]
    cfg = MatcherConfig(fovea_level=3, early_exit_delta=0.1 if ee else None)
    mesh = par.make_mesh(p, r, devices=[cuda] * (p * r))
    eng = StereoEngine(cfg, device="cuda")
    eager = make_batch_matcher(cfg, mesh, foveated=foveated, capture=False)
    warns = ee and r > 1
    results = []
    for seed in (0, 5):
        raw, (lb, rb) = batch_on(cuda, b, seed)
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            ref, want, want_it, _, _ = counted(lambda: eager(lb, rb))
            out, got, got_it, syncs, replays = counted(
                lambda: batch_planes(eng.match_batch(
                    *raw, mesh=mesh, foveated=foveated), foveated))
        n_warned = sum("early_exit_delta" in str(w.message) for w in seen)
        assert n_warned == (2 if warns else 0)   # eager's and the engine's
        assert_bits(out, ref)
        assert got == want and got_it == want_it
        assert syncs == 0 and replays == 1
        assert eng.metrics["match_batch_route"] == "graph"
        if not warns:
            for i in range(b):
                if foveated:
                    res = eng.match_foveated(raw[0][i], raw[1][i])
                    single = torch.stack([res.stack_h, res.stack_v,
                                          res.stack_c])
                else:
                    single = eng.match(raw[0][i], raw[1][i]).triplet
                assert_bits(out[i], single)
        results.append((out, ref))
    for out, ref in results:
        assert_bits(out, ref)
    (matcher,) = eng.matchers.values()
    assert len(matcher.graphs) == 1
    card = torch.device("cuda", torch.cuda.current_device())
    assert [list(c) for c in matcher.graphs.values()] == [[card]]


@pytest.mark.parametrize("mode", ["dp", "sp"])
def test_measure_throughput_replays_at_408x616(cuda, mode):
    """The harness's point at 4 entries of this card: its warm-up call
    captures and every timed call replays the one graph."""
    _build.reset_launch_counts()
    (pt,) = par.measure_throughput(408, 616, device_counts=[4], repeats=2,
                                   mode=mode, devices=[cuda] * 4)
    torch.cuda.synchronize()
    assert _build.graph_replays() == 3
    assert pt.mesh_shape == ((4, 1) if mode == "dp" else (1, 4))
    assert pt.pairs_per_second > 0 and pt.oversubscribed


def test_profile_match_replays_one_graph_per_stage(cuda):
    """profile_match's stages (the build, each level, each upsample) as
    chained graphs: bit-equal to the eager match with its launch counts,
    on the capture and on a replay of another scene, the breakdown's
    keys those of the eager profile."""
    cfg = MatcherConfig(fovea_level=3)
    n = cfg.num_levels(GH, GW)
    for gate in (None, 0):
        eng = StereoEngine(cfg, device="cuda", resident_max_pixels=gate)
        for seed in (0, 3):
            inputs = scene.make_pair(GH, GW, seed=seed)
            ref, want, _, _, _ = counted(
                lambda: eager_call(cuda, "match", cfg, gate, inputs))
            (res, prof), got, _, syncs, replays = counted(
                lambda: eng.profile_match(*inputs))
            assert_bits(res.triplet, ref)
            assert got == want and syncs == 0 and replays == 2 * n
            assert sorted(prof["levels"]) == [f"level_{i:02d}"
                                              for i in range(n)]
            assert "upsample_s" not in prof["levels"]["level_00"]
        assert len(eng.graphs) == 2 * n
        assert sum(k[0] == "prof_level" for k in eng.graphs) == n


def test_dp_mesh_across_two_cards_replays_a_graph_per_card(cuda):
    """Two cards: a dp mesh replays one graph on each card and returns the
    batch on card 0, equal to match per pair; a rows-group across the
    two cards replays one graph across them, equal to match.  Skips with
    one card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    cards = [torch.device("cuda", k) for k in range(2)]
    eng = StereoEngine(MatcherConfig(fovea_level=3), device=cards[0])
    for seed in (0, 7):
        raw, _ = batch_on(cards[0], 3, seed)
        out, _, _, _, replays = counted(lambda: eng.match_batch(
            *raw, mesh=par.make_mesh(2, 1, devices=cards)).triplet)
        assert replays == 2 and eng.metrics["match_batch_route"] == "graph"
        assert out.device == cards[0]
        for i in range(3):
            assert_bits(out[:, i], eng.match(raw[0][i], raw[1][i]).triplet)
    rows, _, _, _, replays = counted(lambda: eng.match_batch(
        raw[0][:1], raw[1][:1], mesh=par.make_mesh(1, 2, devices=cards)))
    assert eng.metrics["match_batch_route"] == "graph" and replays == 1
    assert_bits(rows.triplet[:, 0], eng.match(raw[0][0], raw[1][0]).triplet)


# ------------------------------------ a rows-group across cards (16 MP)
XH, XW = 3264, 4928      # the published 16 MP frame, as chip_smoke.py
# mesh -> (pairs, rows, cards a rows-group spans, batch)
CROSS_MESHES = {"rows_1x2": (1, 2, 1), "rows_1x4": (1, 4, 1),
                "hybrid_2x2": (2, 2, 2)}
CROSS_CASES = {"nearest": ({}, False), "bilinear": ({"interp": "bilinear"},
                                                    False),
               "foveated": ({}, True), "early_exit": ({"early_exit_delta":
                                                       0.1}, False)}
_SCENES = {}


def scenes_16mp(dev, b):
    """b 16 MP scene pairs (seeds 0, 1, ...) as uint8 (B, H, W, 3) batches
    on ``dev``, made once for the module."""
    if b not in _SCENES:
        pairs = [scene.make_pair(XH, XW, seed=k) for k in range(b)]
        _SCENES[b] = [np.stack([p[i] for p in pairs]) for i in (0, 1)]
    return [torch.from_numpy(x).to(dev) for x in _SCENES[b]]


def cards_or_skip(n):
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA cards, found "
                    f"{torch.cuda.device_count()}")
    return [torch.device("cuda", k) for k in range(n)]


@pytest.mark.parametrize("case", sorted(CROSS_CASES))
@pytest.mark.parametrize("name", sorted(CROSS_MESHES))
def test_rows_group_across_cards_replays_a_graph(cuda, name, case):
    """A 16 MP pair row-sharded over cards: one graph a rows-group (one
    replay a call on 1 x N, two on the 2 x 2 hybrid), bit-equal to the
    eager matcher on the same mesh with the same launch counts and
    early-exit iterations, on the capture and on a replay; each pair
    equal to one card's match (match_foveated), or with early exit (the
    sharded levels' fixed schedule) to the same mesh on one card."""
    import warnings

    from ug_stereomatcher_tpu_torch.parallel.batch import make_batch_matcher
    from ug_stereomatcher_tpu_torch.parallel.mesh import mesh_key
    p, r, b = CROSS_MESHES[name]
    cards = cards_or_skip(p * r)
    fields, foveated = CROSS_CASES[case]
    cfg = MatcherConfig(**fields)
    mesh = par.make_mesh(p, r, devices=cards)
    eng = StereoEngine(cfg, device=cards[0])
    eager = make_batch_matcher(cfg, mesh, foveated=foveated, capture=False)
    raw = scenes_16mp(cards[0], b)
    lb, rb = (x.movedim(-1, 1).float().contiguous() for x in raw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # early exit's sharded warning
        ref, want, want_it, _, _ = counted(lambda: eager(lb, rb))
        for _ in range(2):   # the capture, then a replay
            out, got, got_it, syncs, replays = counted(
                lambda: batch_planes(eng.match_batch(
                    *raw, mesh=mesh, foveated=foveated), foveated))
            assert eng.metrics["match_batch_route"] == "graph"
            assert replays == p and syncs == 0
            assert got == want and got_it == want_it
            assert_bits(out, ref)
        if fields.get("early_exit_delta") is not None:
            one = par.make_mesh(p, r, devices=[cards[0]] * (p * r))
            single = batch_planes(eng.match_batch(*raw, mesh=one), False)
            assert_bits(out, single)
    (calls,) = eng.matchers[(mesh_key(mesh), foveated)].graphs.values()
    assert list(calls) == [tuple(cards[g * r:(g + 1) * r]) for g in range(p)]
    if fields.get("early_exit_delta") is not None:
        return
    for i in range(b):
        if foveated:
            res = eng.match_foveated(raw[0][i], raw[1][i])
            single = torch.stack([res.stack_h, res.stack_v, res.stack_c])
        else:
            single = eng.match(raw[0][i], raw[1][i]).triplet
        assert_bits(out[i], single)


def test_rows_group_across_cards_survives_a_sleeping_card(cuda):
    """20 replays of a rows-group over every card (up to 4), each after a
    torch.cuda._sleep on another card's current stream, the inputs
    alternating between two scenes: every result equal to its scene's
    eager result bit for bit (a halo read before its copy, or a band
    overwritten while read, would show)."""
    from ug_stereomatcher_tpu_torch.parallel.batch import make_batch_matcher
    n = min(4, torch.cuda.device_count())
    cards = cards_or_skip(max(n, 2))
    cfg = MatcherConfig(fovea_level=3)
    mesh = par.make_mesh(1, n, devices=cards)
    graph = make_batch_matcher(cfg, mesh)
    eager = make_batch_matcher(cfg, mesh, capture=False)
    inputs, refs = [], []
    for seed in (2, 3):
        _, (lb, rb) = batch_on(cards[0], 1, seed)
        inputs.append((lb, rb))
        refs.append(eager(lb, rb))
    _build.reset_launch_counts()
    for k in range(20):
        with torch.cuda.device(cards[k % n]):
            torch.cuda._sleep(2_000_000)
        out = graph(*inputs[k % 2])
        assert_bits(out, refs[k % 2])
    assert _build.graph_replays() == 20 and graph.route == "graph"


def test_a_failed_capture_across_cards_names_them(cuda):
    """A call that reads the host on the second card inside a capture
    across two cards raises, naming both cards: nothing runs eagerly in
    its place."""
    from ug_stereomatcher_tpu_torch.graphs import CapturedCall
    cards = cards_or_skip(2)

    def fn(x):
        y = x.to(cards[1]) * 2
        y.sum().item()
        return y.to(cards[0])
    call = CapturedCall(fn, [(3, 8, 8)], cards[0], cards[1:])
    with pytest.raises(RuntimeError, match="cuda:0, cuda:1"):
        call(torch.ones(3, 8, 8, device=cards[0]))
    assert call.graph is None


# ------------------------------------------------------------ the spans
SPAN_ENTRIES = {
    "match": (None, ["entry.upload", "graph.load", "graph.replay",
                     "graph.clone"]),
    "match_batch": (None, ["entry.upload", "graph.load", "graph.replay",
                           "graph.clone"]),
    "match_batch_mesh": ((2, 1), ["entry.upload", "mesh.scatter",
                                  "graph.load", "graph.replay",
                                  "mesh.gather"]),
}


@pytest.mark.parametrize("entry", sorted(SPAN_ENTRIES))
def test_spans_time_the_card_with_no_extra_synchronise(cuda, monkeypatch,
                                                       entry):
    """Spans on: the device seconds of each timed span are positive and
    were read when the request ended, after the entry's own synchronise:
    the call makes as many synchronises as with spans off."""
    from ug_stereomatcher_tpu_torch import profiling

    grid, timed = SPAN_ENTRIES[entry]
    eng = StereoEngine(MatcherConfig(fovea_level=3), device="cuda")
    left, right = scene.make_pair(GH, GW)
    mesh = par.make_mesh(*grid, devices=[cuda] * 2) if grid else None

    def call():
        if entry == "match":
            eng.match(left, right)
        else:
            eng.match_batch(np.stack([left] * 2), np.stack([right] * 2),
                            mesh=mesh)
    call()   # the capture
    syncs = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: syncs.append(a) or real(*a))
    call()
    off = len(syncs)
    profiling.reset_spans()
    try:
        with profiling.collecting():
            call()
        assert off > 0 and len(syncs) == 2 * off
        assert not profiling._REG.pending   # read at the request's end
        totals = profiling.span_totals()
    finally:
        profiling.reset_spans()
    assert totals["entry.request"]["count"] == 1
    assert totals["entry.request"]["pairs"] == (1 if entry == "match" else 2)
    for name in timed:
        assert totals[name]["device_s"] > 0, name
    assert totals["entry.sync"]["device_s"] == 0


def test_graph_captures_count_one_a_key(cuda):
    eng = StereoEngine(MatcherConfig(fovea_level=3), device="cuda")
    left, right = scene.make_pair(GH, GW)
    _build.reset_launch_counts()
    eng.match(left, right)
    assert _build.graph_captures() == 1
    eng.match_foveated(left, right)
    assert _build.graph_captures() == 2
    _build.reset_launch_counts()
    for _ in range(2):
        eng.match(left, right)
        eng.match_foveated(left, right)
    assert _build.graph_captures() == 0 and _build.graph_replays() == 4
