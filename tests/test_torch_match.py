"""The port's pyramid, level engine and StereoEngine against the JAX
package on the CPU.  Pyramids and upsamples are bit-exact; levels are
compared in lockstep (each level from the same input state) under the
repo's quantile rule, because a nearest warp flips gather indices on
float noise (tests/test_level_kernel.py:51-57)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.gold import gold_ops
from ug_stereomatcher_tpu import match as jmatch
from ug_stereomatcher_tpu import pyramid as jpyr
from ug_stereomatcher_tpu.config import MatcherConfig as JaxConfig
from ug_stereomatcher_tpu_torch import StereoEngine
from ug_stereomatcher_tpu_torch import match as tmatch
from ug_stereomatcher_tpu_torch import pyramid as tpyr
from ug_stereomatcher_tpu_torch.config import MatcherConfig


def configs(**kw):
    """The same algorithm configuration in both packages."""
    jcfg = JaxConfig(**kw)
    return jcfg, MatcherConfig.from_reference(dataclasses.asdict(jcfg))


def synthetic_pair(h, w, shift_x=0, shift_y=0, pad=6, seed=21):
    """Smooth random pair with right(x + shift) == left(x) (as in
    tests/test_match.py)."""
    base = np.random.RandomState(seed).rand(
        3, h + 2 * pad, w + 2 * pad).astype(np.float32) * 255
    base = np.stack([gold_ops.conv_sep_zero(c, gold_ops.GAUSS) for c in base])
    left = base[:, pad:pad + h, pad:pad + w]
    right = base[:, pad - shift_y:pad - shift_y + h,
                 pad - shift_x:pad - shift_x + w]
    return np.ascontiguousarray(left), np.ascontiguousarray(right)


def assert_lockstep_close(out, ref, *, q99=2e-3, cap=0.05):
    d = np.abs(out - ref)
    assert np.quantile(d, 0.99) <= q99, (np.quantile(d, 0.99), d.max())
    assert d.max() <= cap, d.max()


@pytest.mark.parametrize("h,w", [(48, 64), (37, 53), (20, 27)])
def test_build_pyramid_pair_bit_exact(h, w):
    jcfg, tcfg = configs()
    left, right = synthetic_pair(h, w, shift_x=1)
    n = tcfg.num_levels(h, w)
    jl, jr = jpyr.build_pyramid_pair(jnp.asarray(left), jnp.asarray(right),
                                     jcfg, n)
    tl, tr = tpyr.build_pyramid_pair(torch.from_numpy(left),
                                     torch.from_numpy(right), tcfg, n)
    assert len(tl) == len(jl) == n
    for a, b in zip(tl + tr, jl + jr):
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("scale_conf", [True, False])
@pytest.mark.parametrize("hw,out", [((23, 33), (33, 47)), ((47, 67), (67, 96))])
def test_upsample_to_level_bit_exact(scale_conf, hw, out):
    jcfg, tcfg = configs(scale_conf_on_upsample=scale_conf)
    d = (np.random.RandomState(4).rand(3, *hw).astype(np.float32) - 0.5) * 8
    ours = tpyr.upsample_to_level(torch.from_numpy(d), *out, tcfg).numpy()
    ref = np.asarray(jpyr.upsample_to_level(jnp.asarray(d), *out, jcfg))
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("level_index,is_coarsest", [(0, False), (1, True)])
def test_match_level_lockstep(level_index, is_coarsest):
    jcfg, tcfg = configs()
    h, w = 36, 52
    left, right = synthetic_pair(h, w, shift_x=1)
    disp = (np.random.RandomState(33).rand(3, h, w).astype(np.float32) - 0.5)
    disp[2] = np.abs(disp[2]) + 0.2
    ref = np.asarray(jmatch.match_level(
        jnp.asarray(left), jnp.asarray(right), jnp.asarray(disp),
        level_index, jcfg, is_coarsest))
    out = tmatch.match_level(torch.from_numpy(left), torch.from_numpy(right),
                             torch.from_numpy(disp), level_index, tcfg,
                             is_coarsest).numpy()
    assert_lockstep_close(out, ref)


def test_match_pyramid_lockstep_level_by_level():
    """Each level starts both engines from the JAX state; the upsample to
    the next level is exact."""
    jcfg, tcfg = configs()
    h, w = 48, 64
    left, right = synthetic_pair(h, w, shift_x=1)
    n = tcfg.num_levels(h, w)
    jl, jr = jpyr.build_pyramid_pair(jnp.asarray(left), jnp.asarray(right),
                                     jcfg, n)
    tl, tr = tpyr.build_pyramid_pair(torch.from_numpy(left),
                                     torch.from_numpy(right), tcfg, n)
    dims = tmatch.level_dims_for_matching(tcfg, h, w, n, False)
    assert dims == jmatch.level_dims_for_matching(jcfg, h, w, n, False)
    disp = np.zeros((3,) + dims[n - 1], np.float32)
    for i in range(n - 1, -1, -1):
        ref = np.asarray(jmatch.match_level(jl[i], jr[i], jnp.asarray(disp),
                                            i, jcfg, i == n - 1))
        out = tmatch.match_level(tl[i], tr[i], torch.from_numpy(disp), i,
                                 tcfg, i == n - 1).numpy()
        assert_lockstep_close(out, ref)
        if i > 0:
            up_ref = np.asarray(jpyr.upsample_to_level(
                jnp.asarray(ref), *dims[i - 1], jcfg))
            up = tpyr.upsample_to_level(torch.from_numpy(np.array(ref)),
                                        *dims[i - 1], tcfg).numpy()
            np.testing.assert_array_equal(up, up_ref)
            disp = np.array(up_ref)


def test_match_pyramid_free_running_close():
    """End to end, free-running: quantile agreement, never maxima."""
    jcfg, tcfg = configs()
    h, w = 48, 64
    left, right = synthetic_pair(h, w, shift_x=1)
    n = tcfg.num_levels(h, w)
    jl, jr = jpyr.build_pyramid_pair(jnp.asarray(left), jnp.asarray(right),
                                     jcfg, n)
    tl, tr = tpyr.build_pyramid_pair(torch.from_numpy(left),
                                     torch.from_numpy(right), tcfg, n)
    ref = np.asarray(jmatch.match_pyramid(jl, jr, jcfg, (h, w)).levels[0])
    out = tmatch.match_pyramid(tl, tr, tcfg, (h, w)).levels[0].numpy()
    d = np.abs(out - ref)
    assert np.median(d) < 1e-3 and (d > 0.02).mean() < 0.02


@pytest.mark.parametrize("axis,shift", [("h", 2), ("v", 1)])
def test_engine_recovers_constant_shift(axis, shift):
    h, w = 96, 128
    left, right = synthetic_pair(h, w, shift_x=shift if axis == "h" else 0,
                                 shift_y=shift if axis == "v" else 0)
    eng = StereoEngine(MatcherConfig(), device="cpu")
    res = eng.match(np.moveaxis(left, 0, -1), np.moveaxis(right, 0, -1))
    dh = res.disparity_h.numpy()[12:-12, 12:-12]
    dv = res.disparity_v.numpy()[12:-12, 12:-12]
    assert res.disparity_h.shape == (h, w)
    if axis == "h":
        assert abs(np.median(dh) - shift) < 0.5
        assert abs(np.median(dv)) < 0.3
        assert res.confidence.numpy().mean() > 0.7
    else:
        assert abs(np.median(dv) - shift) < 0.5
    assert eng.metrics["match_s"] > 0


def test_engine_accepts_hwc_uint8_and_chw_float_alike():
    left, right = synthetic_pair(40, 56, shift_x=1)
    eng = StereoEngine(MatcherConfig(), device="cpu")
    u8 = [np.moveaxis(np.clip(x, 0, 255), 0, -1).astype(np.uint8)
          for x in (left, right)]
    a = eng.match(*u8).triplet
    b = eng.match(*(torch.from_numpy(np.moveaxis(x, -1, 0).astype(np.float32))
                    for x in u8)).triplet
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="differ"):
        eng.match(u8[0], u8[1][:-1])


def test_engine_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        StereoEngine(MatcherConfig(), device="cuda")


@pytest.mark.parametrize("kw", [{"interp": "bilinear"},
                                {"early_exit_delta": 0.02}])
def test_engine_unported_modes_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        StereoEngine(MatcherConfig(**kw), device="cpu")


def test_foveated_raises():
    cfg = MatcherConfig()
    x = torch.zeros(3, 16, 16)
    with pytest.raises(NotImplementedError, match="mode 2"):
        tmatch.match_pyramid([x], [x], cfg, (16, 16), foveated=True)
    with pytest.raises(NotImplementedError, match="mode 2"):
        tmatch.level_dims_for_matching(cfg, 16, 16, 1, True)
