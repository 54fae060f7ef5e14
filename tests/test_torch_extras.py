"""The port's engine extras against the JAX package on the CPU: the
convergence metric, early exit, the convergence trace, the left-right
consistency check, match_with_consistency, profile_match, warmup,
get_disparities and the sharded early-exit warning.

Levels are compared under the repo's lockstep quantile rule and whole
matches under the free-running one (tests/test_torch_match.py), since a
nearest warp flips gather indices on float noise.  Early exit reads a
sum over the level: torch adds in another order than XLA, so a change
within about 1e-6 of the threshold could stop a level one iteration
sooner or later.  The thresholds here are checked to lie at least 1e-3
(relative) away from every iteration's change."""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_match import (
    assert_lockstep_close,
    configs,
    synthetic_pair,
)
from ug_stereomatcher_tpu import StereoEngine as JaxEngine
from ug_stereomatcher_tpu import match as jmatch
from ug_stereomatcher_tpu import pyramid as jpyr
from ug_stereomatcher_tpu.ops import consistency as jcons
from ug_stereomatcher_tpu.ops import convergence as jconv
from ug_stereomatcher_tpu_torch import StereoEngine, scene
from ug_stereomatcher_tpu_torch import match as tmatch
from ug_stereomatcher_tpu_torch import parallel as par
from ug_stereomatcher_tpu_torch import pyramid as tpyr
from ug_stereomatcher_tpu_torch.config import MatcherConfig
from ug_stereomatcher_tpu_torch.ops import consistency as tcons
from ug_stereomatcher_tpu_torch.ops import convergence as tconv
from ug_stereomatcher_tpu_torch.ops.cuda.warp import warp
from ug_stereomatcher_tpu_torch.parallel import spatial


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores
    (eight threads a worker oversubscribe them many times over)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def level_inputs(h=36, w=52, seed=33):
    """A pair with a 1 px shift and a random (3, h, w) state."""
    left, right = synthetic_pair(h, w, shift_x=1)
    disp = (np.random.RandomState(seed).rand(3, h, w).astype(np.float32)
            - 0.5)
    disp[2] = np.abs(disp[2]) + 0.2
    return left, right, disp


# ---------------------------------------------------------- convergence
@pytest.mark.parametrize("seed", [0, 1])
def test_weighted_difference_and_has_converged_match_jax(seed):
    rng = np.random.RandomState(seed)
    new, old, new_v, old_v = (rng.randn(17, 23).astype(np.float32)
                              for _ in range(4))
    conf = rng.rand(17, 23).astype(np.float32)
    ref = float(jconv.weighted_difference(jnp.asarray(new), jnp.asarray(old),
                                          jnp.asarray(conf)))
    out = tconv.weighted_difference(t(new), t(old), t(conf))
    assert out.dim() == 0 and out.dtype == torch.float32
    np.testing.assert_allclose(out.item(), ref, rtol=1e-6)
    gold = (np.abs(new.astype(np.float64) - old) * conf).sum() / conf.sum()
    np.testing.assert_allclose(out.item(), gold, rtol=1e-5)
    for thr in (0.1, 10.0):
        jc, jh, jv = jconv.has_converged(*(jnp.asarray(a) for a in (
            new, old, new_v, old_v, conf)), thr)
        tc, th, tv = tconv.has_converged(*(t(a) for a in (
            new, old, new_v, old_v, conf)), thr)
        assert bool(tc) == bool(jc) == (thr == 10.0)
        np.testing.assert_allclose([th.item(), tv.item()],
                                   [float(jh), float(jv)], rtol=1e-6)


def test_weighted_difference_all_zero_confidence_is_zero():
    a = torch.ones(5, 7)
    out = tconv.weighted_difference(a, -a, torch.zeros(5, 7))
    assert out.item() == 0.0
    converged, dh, dv = tconv.has_converged(a, -a, a, a, torch.zeros(5, 7),
                                            1e-9)
    assert bool(converged) and dh.item() == 0.0 and dv.item() == 0.0


# ----------------------------------------------------------- early exit
def run_level(tcfg, left, right, disp, level_index, is_coarsest, gate=0):
    tmatch.reset_host_syncs()
    out = tmatch.match_level(t(left), t(right), t(disp), level_index, tcfg,
                             is_coarsest, resident_max_pixels=gate)
    return out.numpy(), tmatch.host_syncs()


@pytest.mark.parametrize("level_index,is_coarsest", [(1, False), (2, True)])
def test_early_exit_threshold_zero_is_the_fixed_schedule(level_index,
                                                         is_coarsest):
    """Threshold 0 never stops a level: the per-iteration route equals
    its fixed schedule bit for bit, reading the change once an
    iteration; against the JAX while loop under the lockstep rule."""
    jcfg, tcfg = configs(early_exit_delta=0.0)
    left, right, disp = level_inputs()
    fixed, syncs0 = run_level(dataclasses.replace(tcfg, early_exit_delta=None),
                              left, right, disp, level_index, is_coarsest)
    out, syncs = run_level(tcfg, left, right, disp, level_index, is_coarsest)
    np.testing.assert_array_equal(out, fixed)
    assert syncs0 == 0 and syncs == tcfg.iters_for_level(level_index)
    ref = np.asarray(jmatch.match_level(jnp.asarray(left), jnp.asarray(right),
                                        jnp.asarray(disp), level_index, jcfg,
                                        is_coarsest))
    assert_lockstep_close(out, ref)


@pytest.mark.parametrize("level_index,is_coarsest", [(1, False), (6, True)])
def test_early_exit_large_threshold_runs_one_iteration(level_index,
                                                       is_coarsest):
    """delta starts at +inf, so one iteration always runs; a threshold of
    1e9 then stops the level: the result is one iteration of the fixed
    body, bit for bit, and within the lockstep rule of the JAX level
    (tests/test_match.py:273-300)."""
    jcfg, tcfg = configs(early_exit_delta=1e9)
    left, right, disp = level_inputs()
    out, syncs = run_level(tcfg, left, right, disp, level_index, is_coarsest)
    assert syncs == 1
    base = dataclasses.replace(tcfg, early_exit_delta=None)
    body = tmatch._make_level_body(
        t(left), t(right), tmatch._level_blurred_l2(t(left)), base,
        is_coarsest, base.smooth_passes_for_level(level_index))
    mi = base.iters_for_level(level_index)
    one = body(t(disp), 0, base.threshold_schedule(mi)[0]).numpy()
    np.testing.assert_array_equal(out, one)
    ref = np.asarray(jmatch.match_level(jnp.asarray(left), jnp.asarray(right),
                                        jnp.asarray(disp), level_index, jcfg,
                                        is_coarsest))
    assert_lockstep_close(out, ref)


def test_early_exit_stops_where_the_jax_trace_says():
    """At a threshold between two iterations' changes, the port stops the
    level at the iteration the JAX convergence trace of the same level
    gives, and agrees with the JAX early-exit level under the lockstep
    rule."""
    jcfg, tcfg = configs()
    left, right, disp = level_inputs()
    level_index = 6   # 22 iterations
    _, deltas = jmatch.level_convergence_trace(
        jnp.asarray(left), jnp.asarray(right), jnp.asarray(disp),
        level_index, jcfg, False)
    change = np.asarray(deltas).max(axis=1)
    thr = float(np.sqrt(change[4] * change[5])) if change[5] < change[4] \
        else None
    assert thr is not None, change
    assert np.min(np.abs(change / thr - 1)) > 1e-3, (change, thr)
    stop = int(np.argmax(change < thr)) + 1
    out, syncs = run_level(dataclasses.replace(tcfg, early_exit_delta=thr),
                           left, right, disp, level_index, False)
    assert syncs == stop
    ref = np.asarray(jmatch.match_level(
        jnp.asarray(left), jnp.asarray(right), jnp.asarray(disp),
        level_index, dataclasses.replace(jcfg, early_exit_delta=thr), False))
    assert_lockstep_close(out, ref)


def test_early_exit_leaves_the_level_resident_route_alone():
    """A level on the level-resident route runs its full schedule under
    any threshold, as the JAX package's level kernel does: the result
    equals the fixed schedule bit for bit, and no change is read."""
    _, tcfg = configs(early_exit_delta=1e9)
    left, right, disp = level_inputs()
    assert tmatch.uses_level_resident(*left.shape[-2:])
    out, syncs = run_level(tcfg, left, right, disp, 6, False, gate=None)
    fixed, _ = run_level(dataclasses.replace(tcfg, early_exit_delta=None),
                         left, right, disp, 6, False, gate=None)
    np.testing.assert_array_equal(out, fixed)
    assert syncs == 0


@pytest.mark.parametrize("thr", [0.02, 0.2])
def test_early_exit_end_to_end_close_to_jax(thr):
    """End to end, free-running, against the JAX pyramid (the CPU runs
    every JAX level per iteration; the port's per-iteration route is held
    to it), under the quantile rule; both recover the shift.  At 0.02 px
    (the bench's threshold) no level of this 48 x 64 pyramid changes that
    little, so every iteration runs (the smallest last change is 0.04);
    at 0.2 px each level stops early."""
    jcfg, tcfg = configs(early_exit_delta=thr)
    h, w = 48, 64
    left, right = synthetic_pair(h, w, shift_x=1)
    n = tcfg.num_levels(h, w)
    jl, jr = jpyr.build_pyramid_pair(jnp.asarray(left), jnp.asarray(right),
                                     jcfg, n)
    ref = np.asarray(jmatch.match_pyramid(jl, jr, jcfg, (h, w)).levels[0])
    tmatch.reset_host_syncs()
    tl, tr = tpyr.build_pyramid_pair(t(left), t(right), tcfg, n)
    out = tmatch.match_pyramid(tl, tr, tcfg, (h, w),
                               resident_max_pixels=0).levels[0].numpy()
    full = sum(tcfg.iters_for_level(i) for i in range(n))
    assert (tmatch.host_syncs() == full) == (thr == 0.02)
    assert tmatch.host_syncs() >= n
    d = np.abs(out - ref)
    assert np.median(d) < 1e-3 and (d > 0.02).mean() < 0.02
    assert abs(np.median(out[0, 8:-8, 8:-8]) - 1) < 0.5


def test_engine_accepts_early_exit():
    left, right = (np.moveaxis(x, 0, -1) for x in synthetic_pair(40, 56, 1))
    cfg = MatcherConfig(early_exit_delta=0.05)
    eng = StereoEngine(cfg, device="cpu", resident_max_pixels=0)
    res = eng.match(left, right)
    assert res.disparity_h.shape == (40, 56)
    assert torch.isfinite(res.triplet).all()


# -------------------------------------------------------- convergence trace
def jax_trace_unjitted(left, right, disp, level_index, cfg, is_coarsest):
    """The JAX package's own level body and weighted_difference, run op by
    op without jit (as tests/test_torch_match.py's
    jax_level_body_unjitted): (triplet, (mi, 2) deltas)."""
    mi = cfg.iters_for_level(level_index)
    thr = cfg.threshold_schedule(mi)
    body = jmatch._make_level_body(
        jnp.asarray(left), jnp.asarray(right),
        jmatch._level_blurred_l2(jnp.asarray(left), cfg), cfg, level_index,
        is_coarsest, cfg.smooth_passes_for_level(level_index), False, False)
    state = tuple(jnp.asarray(p) for p in disp)
    deltas = []
    for m in range(mi):
        new, _ = body(state, (jnp.int32(m), jnp.float32(thr[m])))
        deltas.append([float(jconv.weighted_difference(new[k], state[k],
                                                       new[2]))
                       for k in (0, 1)])
        state = new
    return np.stack([np.asarray(p) for p in state]), np.array(deltas)


@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
@pytest.mark.parametrize("level_index,is_coarsest", [(2, False), (6, True)])
def test_level_convergence_trace_matches_jax(level_index, is_coarsest,
                                             interp):
    """The port's trace runs the per-iteration route in full, whatever the
    threshold: its triplet equals match_level's per-iteration route bit
    for bit, and the JAX level body run without jit bit for bit; its
    (mi, 2) deltas equal that body's weighted_difference at rtol 1e-4
    (they differ only in the sum's order).  The jitted JAX trace rounds
    its fused iteration differently, and over 22 nearest iterations the
    gather flips carry that far beyond the lockstep rule, so only its
    first iteration's deltas are held to rtol 1e-4."""
    jcfg, tcfg = configs(early_exit_delta=1e9, interp=interp)
    left, right, disp = level_inputs(20, 28)
    trip, deltas = tmatch.level_convergence_trace(
        t(left), t(right), t(disp), level_index, tcfg, is_coarsest)
    mi = tcfg.iters_for_level(level_index)
    assert deltas.shape == (mi, 2) and deltas.dtype == torch.float32
    fixed, _ = run_level(dataclasses.replace(tcfg, early_exit_delta=None),
                         left, right, disp, level_index, is_coarsest)
    np.testing.assert_array_equal(trip.numpy(), fixed)
    ref_trip, ref_deltas = jax_trace_unjitted(left, right, disp, level_index,
                                              jcfg, is_coarsest)
    np.testing.assert_array_equal(trip.numpy(), ref_trip)
    np.testing.assert_allclose(deltas.numpy(), ref_deltas, rtol=1e-4)
    jtrip, jdeltas = jmatch.level_convergence_trace(
        jnp.asarray(left), jnp.asarray(right), jnp.asarray(disp),
        level_index, jcfg, is_coarsest)
    np.testing.assert_allclose(deltas.numpy()[0], np.asarray(jdeltas)[0],
                               rtol=1e-4)
    assert jtrip.shape == trip.shape


# ---------------------------------------------------------- consistency
def assert_consistency_close(mask, err, jmask, jerr, tau=1.0):
    """The port's error equals the JAX package's within one float32
    rounding (torch's vectorised square root on the CPU is not always
    correctly rounded: a few values differ in the last bit), and the
    masks agree wherever the error is not within 1e-5 of tau."""
    jerr = np.asarray(jerr)
    np.testing.assert_allclose(err.numpy(), jerr, rtol=2.5e-7, atol=0)
    away = np.abs(jerr - tau) > 1e-5
    np.testing.assert_array_equal(mask.numpy()[away], np.asarray(jmask)[away])


@pytest.mark.parametrize("method", ["nearest", "bilinear"])
def test_lr_consistency_mask_matches_jax(method):
    """The backward fields sampled through the warp's (2, H, W) stack
    equal the JAX warp_by_disparity's bit for bit, and the error and mask
    follow."""
    rng = np.random.RandomState(4)
    h, w = 19, 31
    fwd_h = (rng.rand(h, w) * 6 - 3).astype(np.float32)
    fwd_v = (rng.rand(h, w) - 0.5).astype(np.float32)
    bwd_h = (-fwd_h + rng.randn(h, w) * 0.7).astype(np.float32)
    bwd_v = (rng.randn(h, w) * 0.5).astype(np.float32)
    jm, je = jcons.lr_consistency_mask(
        *(jnp.asarray(a) for a in (fwd_h, fwd_v, bwd_h, bwd_v)), tau=1.0,
        method=method)
    tm, te = tcons.lr_consistency_mask(
        *(t(a) for a in (fwd_h, fwd_v, bwd_h, bwd_v)), tau=1.0,
        method=method)
    assert tm.dtype == torch.bool
    from ug_stereomatcher_tpu.ops.resample import warp_by_disparity
    back = np.asarray(warp_by_disparity(
        jnp.stack([jnp.asarray(bwd_h), jnp.asarray(bwd_v)]),
        jnp.asarray(fwd_h), jnp.asarray(fwd_v), method))
    np.testing.assert_array_equal(
        warp(t(np.stack([bwd_h, bwd_v])), t(fwd_h), t(fwd_v),
             method).numpy(), back)
    assert_consistency_close(tm, te, jm, je)
    assert 0.05 < tm.float().mean().item() < 0.95


def test_consistency_fields_and_apply():
    d = torch.full((20, 30), 3.0)
    z = torch.zeros(20, 30)
    mask, err = tcons.lr_consistency_mask(d, z, -d, z)
    assert bool(mask.all()) and err.abs().max().item() == 0.0
    mask, err = tcons.lr_consistency_mask(d, z, torch.full((20, 30), 2.0), z)
    assert not bool(mask.any())
    torch.testing.assert_close(err, torch.full((20, 30), 5.0))
    m = torch.from_numpy(np.eye(4, 5, dtype=bool))
    out = tcons.apply_consistency(torch.ones(4, 5), m)
    assert out[0, 0].item() == 1.0 and torch.isnan(out[0, 1])
    ref = np.asarray(jcons.apply_consistency(jnp.ones((4, 5)),
                                             jnp.asarray(m.numpy()), -1.0))
    np.testing.assert_array_equal(
        tcons.apply_consistency(torch.ones(4, 5), m, -1.0).numpy(), ref)


@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
def test_match_with_consistency(interp):
    """Forward equals match, the mask is mostly consistent on the scene,
    and the JAX package's check of the port's two fields gives the same
    mask and error."""
    left, right = scene.make_pair(96, 128)
    eng = StereoEngine(MatcherConfig(interp=interp, fovea_level=3),
                       device="cpu")
    fwd, mask, err = eng.match_with_consistency(left, right, tau=1.0)
    assert torch.equal(fwd.triplet, eng.match(left, right).triplet)
    bwd = eng.match(right, left)
    assert mask[12:-12, 12:-12].float().mean().item() > 0.9
    jm, je = jcons.lr_consistency_mask(
        *(jnp.asarray(p.numpy()) for p in (
            fwd.disparity_h, fwd.disparity_v, bwd.disparity_h,
            bwd.disparity_v)), tau=1.0, method=interp)
    assert_consistency_close(mask, err, jm, je)


# ------------------------------------------------------------- engine
def test_profile_match_equals_match_with_the_jax_keys():
    """profile_match's triplet equals match's bit for bit (both routes of
    the level gate), and its breakdown has the JAX breakdown's keys and
    level dims."""
    h, w = 64, 96
    rng = np.random.RandomState(3)
    left = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    right = np.roll(left, 2, axis=1)
    _, jprof = JaxEngine(configs()[0]).profile_match(left, right)
    for gate in (None, 0):
        eng = StereoEngine(MatcherConfig(), device="cpu",
                           resident_max_pixels=gate)
        res, prof = eng.profile_match(left, right)
        assert torch.equal(res.triplet, eng.match(left, right).triplet)
        assert eng.metrics["profile"] is prof
        assert set(prof) == set(jprof)
        assert set(prof["levels"]) == set(jprof["levels"])
        for name, lvl in prof["levels"].items():
            ref = jprof["levels"][name]
            assert set(lvl) == set(ref), name
            assert [lvl[k] for k in ("height", "width", "iterations")] == \
                [ref[k] for k in ("height", "width", "iterations")]
            assert lvl["match_s"] > 0
        assert prof["total_s"] >= prof["match_total_s"] > 0


def test_warmup_and_get_disparities():
    cfg = MatcherConfig(fovea_level=3)
    eng = StereoEngine(cfg, device="cpu")
    eng.warmup(96, 128)
    eng.warmup(96, 128, foveated=True)
    assert eng.timings.summary()["match"]["count"] == 1
    assert eng.timings.summary()["match_foveated"]["count"] == 1
    left, right = scene.make_pair(96, 128)
    res = eng.get_disparities(left, right)
    assert torch.equal(res.triplet, eng.match(left, right).triplet)
    st = eng.get_disparities(left, right, foveated=True)
    ref = eng.match_foveated(left, right)
    for name in ("stack_h", "stack_v", "stack_c", "stack_left"):
        assert torch.equal(getattr(st, name), getattr(ref, name)), name


def test_sharded_early_exit_warns_and_runs_the_fixed_schedule():
    """A mesh runs the row-sharded levels on the fixed schedule and warns;
    at this size the levels it runs whole are on the level-resident route,
    which has no exit either, so the result equals the match without early
    exit bit for bit and no change is read on the host."""
    cfg = MatcherConfig(fovea_level=3, early_exit_delta=1e9)
    left, right = (t(np.moveaxis(x, -1, 0).astype(np.float32))
                   for x in scene.make_pair(96, 128))
    mesh = par.make_mesh(1, 4, devices=["cpu"] * 4)
    tmatch.reset_host_syncs()
    with pytest.warns(UserWarning, match="early_exit_delta"):
        res = spatial.sharded_match_pair(left, right, cfg, mesh,
                                         min_rows_per_shard=8)
    assert tmatch.host_syncs() == 0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ref = spatial.sharded_match_pair(
            left, right, dataclasses.replace(cfg, early_exit_delta=None),
            mesh, min_rows_per_shard=8)
    cpu = torch.device("cpu")
    assert torch.equal(res.levels[0].gather(cpu), ref.levels[0].gather(cpu))
