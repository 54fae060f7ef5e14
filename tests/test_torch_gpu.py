"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here is marked ``gpu`` and skips where torch finds no CUDA
device.  The file imports no jax (the card's machine has none), so on the
card it runs without the JAX test configuration:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

warp, resample and blur must be bit-exact; so must direction and smooth,
since the kernels are built with --fmad=false and keep the plain
versions' term order.
"""

import numpy as np
import pytest
import torch

from ug_stereomatcher_tpu_torch import MatcherConfig, StereoEngine
from ug_stereomatcher_tpu_torch.ops.cuda import (
    _build, blur, direction, resample, smooth, warp)

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


@pytest.mark.parametrize("spread", [6.0, 60.0, 900.0])
def test_warp_bit_exact(cuda, spread):
    h, w = 64, 300
    args = (rand(cuda, 3, h, w), rand(cuda, h, w, lo=-spread, hi=spread, seed=1),
            rand(cuda, h, w, lo=-spread / 4, hi=spread / 4, seed=2))
    assert_same(warp.warp_nearest, warp.warp_nearest_plain, *args)


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
    direction.fused_direction_update(x, x, x, x, 1.0, False)
    resample.resample_tex(x, 10, 20, lambda v: v * 2.0)
    torch.cuda.synchronize()
    assert _build.launch_counts() == {"blur": 1, "smooth": 1, "warp": 1,
                                      "direction": 1, "resample": 1}


def test_engine_on_card_matches_plain_engine(cuda):
    rng = np.random.RandomState(21)
    base = rng.rand(96, 136, 3).astype(np.float32) * 255
    for _ in range(3):   # smooth the texture so correlation is informative
        base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) / 3
    left, right = base[:, 4:132], base[:, 2:130]   # shift of 2 px
    gpu = StereoEngine(MatcherConfig(), device="cuda").match(left, right)
    cpu = StereoEngine(MatcherConfig(), device="cpu").match(left, right)
    d = (gpu.triplet.cpu() - cpu.triplet).abs().numpy()
    assert np.median(d) < 1e-3 and (d > 0.02).mean() < 0.02
    assert abs(np.median(gpu.disparity_h.cpu().numpy()[12:-12, 12:-12]) - 2) < 0.5
