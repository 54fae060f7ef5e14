"""The port's pyramid, level engine and StereoEngine against the JAX
package on the CPU.  Nearest pyramids and upsamples are bit-exact; levels
are compared in lockstep (each level from the same input state) under the
repo's quantile rule, because a nearest warp flips gather indices on
float noise (tests/test_level_kernel.py:51-57).  Bilinear pyramids and
upsamples take the host float64 taps on every level, where the JAX
package's CPU path takes its float32 ``tex_gather``: they agree to 5e-5
(tests/test_pallas_kernels.py:666)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.gold import gold_ops
from ug_stereomatcher_tpu import StereoEngine as JaxEngine
from ug_stereomatcher_tpu import match as jmatch
from ug_stereomatcher_tpu import pyramid as jpyr
from ug_stereomatcher_tpu.config import MatcherConfig as JaxConfig
from ug_stereomatcher_tpu_torch import StereoEngine
from ug_stereomatcher_tpu_torch import match as tmatch
from ug_stereomatcher_tpu_torch import pyramid as tpyr
from ug_stereomatcher_tpu_torch.config import MatcherConfig


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


@pytest.mark.parametrize("h,w", [(48, 64), (37, 53)])
def test_build_pyramid_pair_bilinear_close(h, w):
    jcfg, tcfg = configs(interp="bilinear")
    left, right = synthetic_pair(h, w, shift_x=1)
    n = tcfg.num_levels(h, w)
    jl, jr = jpyr.build_pyramid_pair(jnp.asarray(left), jnp.asarray(right),
                                     jcfg, n)
    tl, tr = tpyr.build_pyramid_pair(torch.from_numpy(left),
                                     torch.from_numpy(right), tcfg, n)
    for a, b in zip(tl + tr, jl + jr):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-5,
                                   atol=5e-5)


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


def jax_level_body_unjitted(left, right, disp, i, cfg, is_coarsest):
    """The JAX package's own per-iteration level body, run op by op
    without jit (its CPU path: XLA gather warp, unfused stencils)."""
    mi = cfg.iters_for_level(i)
    thr = cfg.threshold_schedule(mi)
    body = jmatch._make_level_body(
        left, right, jmatch._level_blurred_l2(left, cfg), cfg, i,
        is_coarsest, cfg.smooth_passes_for_level(i), False, False)
    state = tuple(jnp.asarray(p) for p in disp)
    for m in range(mi):
        state, _ = body(state, (jnp.int32(m), jnp.float32(thr[m])))
    return np.stack([np.asarray(p) for p in state])


def test_bilinear_levels_bit_exact_against_jax_level_body():
    """Where the bilinear engines' free-running gap comes from: on the JAX
    package's pyramid, each level of a 64x96 bilinear match started from
    the state the jitted JAX engine hands it equals the JAX level body run
    without jit bit for bit, and the jitted JAX match_level differs from
    both by XLA's fusion rounding only, within the lockstep rule.  So the
    port computes the JAX package's per-iteration arithmetic exactly; what
    is left between the free-running engines is that fusion rounding and
    the bilinear resample form (host float64 taps against the JAX CPU
    path's float32 ``tex_gather``), amplified by the iteration."""
    jcfg, tcfg = configs(interp="bilinear")
    h, w = 64, 96
    left, right = synthetic_pair(h, w, shift_x=2)
    n = tcfg.num_levels(h, w)
    jl, jr = jpyr.build_pyramid_pair(jnp.asarray(left), jnp.asarray(right),
                                     jcfg, n)
    dims = tmatch.level_dims_for_matching(tcfg, h, w, n, False)
    disp = np.zeros((3,) + dims[n - 1], np.float32)
    for i in range(n - 1, -1, -1):
        coarsest = i == n - 1
        out = tmatch.match_level(torch.from_numpy(np.array(jl[i])),
                                 torch.from_numpy(np.array(jr[i])),
                                 torch.from_numpy(disp), i, tcfg,
                                 coarsest).numpy()
        np.testing.assert_array_equal(
            out, jax_level_body_unjitted(jl[i], jr[i], disp, i, jcfg,
                                         coarsest))
        ref = jmatch.match_level(jl[i], jr[i], jnp.asarray(disp), i, jcfg,
                                 coarsest)
        assert_lockstep_close(out, np.asarray(ref))
        if i > 0:
            disp = np.array(jpyr.upsample_to_level(ref, *dims[i - 1], jcfg))


def test_engine_bilinear_matches_jax_engine():
    """Bilinear end to end, free-running, against the JAX engine, under
    the quantile rule of the nearest free-running test (the same scene
    size: larger free-running scenes diverge in either mode)."""
    jcfg, tcfg = configs(interp="bilinear")
    h, w = 48, 64
    left, right = (np.moveaxis(x, 0, -1)
                   for x in synthetic_pair(h, w, shift_x=2))
    ref = JaxEngine(jcfg).match(left, right)
    out = StereoEngine(tcfg, device="cpu").match(left, right)
    d = np.abs(out.triplet.numpy() - np.stack(
        [np.asarray(ref.disparity_h), np.asarray(ref.disparity_v),
         np.asarray(ref.confidence)]))
    assert np.median(d) < 1e-3 and (d > 0.02).mean() < 0.02
    assert abs(np.median(out.disparity_h.numpy()[8:-8, 8:-8]) - 2) < 0.1


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


@pytest.mark.parametrize("kw", [{"interp": "cubic"}])
def test_engine_unported_modes_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        StereoEngine(MatcherConfig(**kw), device="cpu")
