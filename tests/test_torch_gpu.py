"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here is marked ``gpu`` and skips where torch finds no CUDA
device.  The file imports no jax (the card's machine has none), so on the
card it runs without the JAX test configuration:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

warp, resample and blur must be bit-exact in both interpolation modes;
so must direction, smooth and the level-resident kernel, since the
kernels are built with --fmad=false and keep the plain versions' term
order.
"""

import numpy as np
import pytest
import torch

from ug_stereomatcher_tpu_torch import MatcherConfig, StereoEngine
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


@pytest.mark.parametrize("boundary,channels", [("zero", 6), ("clamp", 3)])
def test_blur_bit_exact(cuda, boundary, channels):
    x = rand(cuda, channels, 203, 307, hi=255.0)
    assert_same(blur.fused_blur_gaussian, blur.fused_blur_gaussian_plain, x,
                boundary)


RESAMPLE_CASES = {
    "subsample_sqrt2": ((6, 97, 211), (int(97 / SCALE), int(211 / SCALE)),
                        lambda v: v * SCALE, 1.0),
    "subsample_2": ((6, 97, 211), (48, 105), lambda v: v * 2.0, 1.0),
    "upsample": ((3, 68, 149), (97, 211), lambda v: v * (1.0 / SCALE), SCALE),
}


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


@pytest.mark.parametrize("spread", [6.0, 60.0, 900.0])
def test_warp_bit_exact(cuda, spread):
    h, w = 64, 300
    args = (rand(cuda, 3, h, w), rand(cuda, h, w, lo=-spread, hi=spread, seed=1),
            rand(cuda, h, w, lo=-spread / 4, hi=spread / 4, seed=2))
    assert_same(warp.warp_nearest, warp.warp_nearest_plain, *args)


@pytest.mark.parametrize("spread", [0.75, 6.0, 900.0])
def test_warp_bilinear_bit_exact(cuda, spread):
    h, w = 64, 300
    args = (rand(cuda, 3, h, w), rand(cuda, h, w, lo=-spread, hi=spread, seed=1),
            rand(cuda, h, w, lo=-spread / 4, hi=spread / 4, seed=2),
            "bilinear")
    assert_same(warp.warp, warp.warp_plain, *args)


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
@pytest.mark.parametrize("h,w,replace", [(34, 53, True), (101, 153, False)])
def test_level_resident_bit_exact(cuda, method, h, w, replace):
    cfg = MatcherConfig(level_cutoff=6)
    left, right, state = _level_inputs(cuda, h, w)
    thresholds = cfg.threshold_schedule(6)
    assert_same(level.level_resident_match, level.level_resident_match_plain,
                left, right, state, thresholds, 5, replace, CONSTS, method)


def test_level_resident_grid_too_large_raises(cuda):
    left, right, state = _level_inputs(cuda, 34, 53)
    too_many = level.max_coresident_blocks("nearest") + 1
    with pytest.raises(RuntimeError, match="ugsm_level_resident"):
        level.level_resident_match(left, right, state, (1.0,), 5, True,
                                   grid_blocks=too_many)


@pytest.mark.parametrize("threshold,replace", [(1.0, False), (0.55, True)])
def test_direction_bit_exact(cuda, threshold, replace):
    h, w = 67, 131
    left = rand(cuda, 3, h, w, hi=255.0, seed=3)
    warped = rand(cuda, 3, h, w, hi=255.0, seed=4)
    bl2 = blur.fused_blur_gaussian_plain(left * left, "clamp")
    disp = rand(cuda, 3, h, w, lo=-0.5, hi=0.5, seed=5)
    assert_same(direction.fused_direction_update,
                direction.fused_direction_update_plain, left, warped, bl2,
                disp, threshold, replace, CONSTS)


@pytest.mark.parametrize("n", [0, 5, 10])
def test_smooth_bit_exact(cuda, n):
    st = rand(cuda, 3, 70, 133, lo=0.05, hi=1.05, seed=6)
    assert_same(smooth.fused_smooth_average,
                smooth.fused_smooth_average_plain, st, n)


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
