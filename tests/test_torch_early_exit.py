"""Early exit's device loop against its host-read loop on the CPU, and the
convergence step against the JAX package.

``match.device_exit_loop`` is the loop that runs on the card: a level's
whole schedule enqueued, each iteration guarded by the level's flag, a
convergence step after each, one device-side select at the end.  On the
CPU it runs with the plain ops (the kernels' plain versions), and it must
equal ``match.host_exit_loop``, which reads each change on the host, bit
for bit: the two compute the same changes with the same sums, so they stop
at the same iteration.  The thresholds: 0 (never stops), 1e9 (stops after
the first iteration) and one between two iterations' changes of the JAX
``level_convergence_trace`` of the same level, checked to lie at least
1e-3 (relative) from every change of the port's own trace.  The
convergence step is held to the JAX ``has_converged`` and to the JAX
while loop's condition (``jnp.maximum`` of the two changes, which carries
a NaN)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_match import configs, synthetic_pair
from ug_stereomatcher_tpu import match as jmatch
from ug_stereomatcher_tpu.ops import convergence as jconv
from ug_stereomatcher_tpu_torch import match as tmatch
from ug_stereomatcher_tpu_torch.ops.cuda import convergence as conv
from ug_stereomatcher_tpu_torch.ops.cuda import direction, smooth, warp

H, W = 20, 28
# (level, coarsest): 4 iterations of 10 passes; 22 iterations of 5 passes
LEVELS = [(1, False), (6, True)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def level_inputs(seed=33):
    """A pair with a 1 px shift and a random (3, H, W) state."""
    left, right = synthetic_pair(H, W, shift_x=1)
    disp = (np.random.RandomState(seed).rand(3, H, W).astype(np.float32)
            - 0.5)
    disp[2] = np.abs(disp[2]) + 0.2
    return left, right, disp


@functools.lru_cache(maxsize=None)
def between_threshold(level_index, is_coarsest, interp):
    """A threshold between two successive changes of the JAX trace of the
    level, where the change falls by more than 1 %, and the iteration
    after which the level stops."""
    jcfg, tcfg = configs(interp=interp)
    left, right, disp = level_inputs()
    _, jd = jmatch.level_convergence_trace(
        jnp.asarray(left), jnp.asarray(right), jnp.asarray(disp),
        level_index, jcfg, is_coarsest)
    change = np.asarray(jd).max(axis=1)
    k = next(k for k in range(len(change) - 1)
             if change[k + 1] < 0.99 * change[k]
             and (change[:k + 1] > change[k + 1]).all())
    thr = float(np.float32(np.sqrt(change[k] * change[k + 1])))
    _, td = tmatch.level_convergence_trace(t(left), t(right), t(disp),
                                           level_index, tcfg, is_coarsest)
    port = td.numpy().max(axis=1)
    assert np.min(np.abs(port / thr - 1)) > 1e-3, (port, thr)
    return thr, int(np.argmax(port < thr)) + 1


def run(tcfg, level_index, is_coarsest, loop):
    left, right, disp = level_inputs()
    tmatch.reset_host_syncs()
    out = tmatch.match_level(t(left), t(right), t(disp), level_index, tcfg,
                             is_coarsest, resident_max_pixels=0,
                             exit_loop=loop)
    return out, tmatch.host_syncs(), tmatch.iterations_run()


@pytest.mark.parametrize("kind", ["zero", "large", "between"])
@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
@pytest.mark.parametrize("level_index,is_coarsest", LEVELS)
def test_device_loop_equals_host_loop(level_index, is_coarsest, interp,
                                      kind):
    """The device loop (the kernels' wrappers, which run their plain
    versions on the CPU) reads nothing on the host and stops where the
    host-read loop stops, with the same bits."""
    _, tcfg = configs(interp=interp)
    mi = tcfg.iters_for_level(level_index)
    if kind == "zero":
        thr, stop = 0.0, mi
    elif kind == "large":
        thr, stop = 1e9, 1
    else:
        thr, stop = between_threshold(level_index, is_coarsest, interp)
        assert 1 < stop < mi
    cfg = dataclasses.replace(tcfg, early_exit_delta=thr)
    out, syncs, iters = run(cfg, level_index, is_coarsest, "device")
    ref, ref_syncs, ref_iters = run(cfg, level_index, is_coarsest, "host")
    assert syncs == 0 and iters == ref_syncs == ref_iters == stop
    assert torch.equal(out, ref)


@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
def test_device_loop_runs_with_the_ops_passed_in(interp):
    """device_exit_loop with PLAIN_OPS and the plain convergence step, as
    written once for the card: the level buffer says which iteration ran
    last, and the triplet is that iteration's state of the fixed
    schedule."""
    _, tcfg = configs(interp=interp)
    level_index, is_coarsest = LEVELS[1]
    thr, stop = between_threshold(level_index, is_coarsest, interp)
    left, right, disp = (t(a) for a in level_inputs())
    body = tmatch._make_level_body(
        left, right, tmatch._level_blurred_l2(left), tcfg, is_coarsest,
        tcfg.smooth_passes_for_level(level_index), tmatch.PLAIN_OPS)
    schedule = tcfg.threshold_schedule(tcfg.iters_for_level(level_index))
    tmatch.reset_host_syncs()
    out, buf = tmatch.device_exit_loop(body, conv.convergence_step_plain,
                                       disp, schedule, thr)
    assert tmatch.host_syncs() == 0
    assert int(conv.stop_flag(buf)) == 1
    assert int(conv.last_iteration(buf)) == stop - 1
    state = disp
    for m in range(stop):
        state = body(state, m, schedule[m])
    assert torch.equal(out, state)
    d = conv.deltas(buf)
    assert (d[:stop] > 0).all() and (d[stop:] == 0).all()


# ----------------------------------------------------- convergence step
def states(seed, h=17, w=23):
    rng = np.random.RandomState(seed)
    new = rng.randn(3, h, w).astype(np.float32)
    new[2] = rng.rand(h, w)
    old = rng.randn(3, h, w).astype(np.float32)
    return new, old


def jax_step(new, old, thr):
    """The JAX while loop's test of one iteration: (dh, dv, stop)."""
    conv_, dh, dv = jconv.has_converged(*(jnp.asarray(a) for a in (
        new[0], old[0], new[1], old[1], new[2])), thr)
    stop = not bool(jnp.maximum(dh, dv) >= jnp.float32(thr))
    return float(dh), float(dv), stop, bool(conv_)


@pytest.mark.parametrize("seed", [0, 1])
def test_convergence_step_matches_jax_has_converged(seed):
    new, old = states(seed)
    mi = 3
    for thr in (0.1, 10.0):
        buf = conv.level_buffer(mi, "cpu")
        conv.convergence_step(t(new), t(old), 1, buf, thr)
        jh, jv, jstop, jconverged = jax_step(new, old, thr)
        np.testing.assert_allclose(conv.deltas(buf)[1].numpy(), [jh, jv],
                                   rtol=1e-6)
        assert bool(conv.stop_flag(buf)) == jstop == jconverged \
            == (thr == 10.0)
        assert int(conv.last_iteration(buf)) == 1
        assert (conv.deltas(buf)[[0, 2]] == 0).all()
    # the trace's step (no threshold) never sets the flag
    buf = conv.level_buffer(mi, "cpu")
    conv.convergence_step(t(new), t(old), 2, buf)
    assert int(conv.stop_flag(buf)) == 0
    np.testing.assert_allclose(conv.deltas(buf)[2].numpy(), [jh, jv],
                               rtol=1e-6)


@pytest.mark.parametrize("case", ["nan_change", "zero_confidence"])
@pytest.mark.parametrize("thr", [0.0, 0.1])
def test_convergence_step_nan_and_zero_confidence_as_jax(case, thr):
    """A NaN change gives NaN and stops the level at any threshold (the
    max carries it); an all-zero confidence gives 0, which stops it unless
    the threshold is 0: both as in JAX."""
    new, old = states(2)
    if case == "nan_change":
        new[0, 3, 4] = np.nan
    else:
        new[2] = 0.0
    buf = conv.level_buffer(2, "cpu")
    conv.convergence_step(t(new), t(old), 0, buf, thr)
    jh, jv, jstop, _ = jax_step(new, old, thr)
    np.testing.assert_allclose(conv.deltas(buf)[0].numpy(), [jh, jv],
                               rtol=1e-6)   # NaN where JAX has NaN
    assert bool(conv.stop_flag(buf)) == jstop
    assert jstop == (case == "nan_change" or thr > 0)


def test_convergence_step_after_the_exit_does_nothing():
    new, old = states(3)
    buf = conv.level_buffer(4, "cpu")
    conv.convergence_step(t(new), t(old), 0, buf, 1e9)
    before = buf.clone()
    conv.convergence_step(t(old), t(new), 1, buf, 0.0)
    assert int(conv.stop_flag(buf)) == 1 and torch.equal(buf, before)


def test_convergence_step_checks_its_buffer():
    new, old = states(4)
    with pytest.raises(ValueError):
        conv.convergence_step(t(new), t(old), 2, conv.level_buffer(2, "cpu"))
    with pytest.raises(ValueError):
        conv.convergence_step(t(new), t(old[:2]), 0,
                              conv.level_buffer(2, "cpu"))
    with pytest.raises(ValueError):
        tmatch.match_level(t(new), t(new), t(old), 1, configs()[1], False,
                           exit_loop="sometimes")


# --------------------------------------------------------------- guards
def guarded_cases():
    rng = np.random.RandomState(5)
    left = t(rng.rand(3, 11, 13).astype(np.float32) * 255)
    warped = t(rng.rand(3, 11, 13).astype(np.float32) * 255)
    state = t(np.stack([rng.rand(11, 13) * 4 - 2, rng.rand(11, 13) - 0.5,
                        rng.rand(11, 13) + 0.1]).astype(np.float32))
    bl2 = left * left
    return {
        "warp_nearest": (warp.warp, (left, state[0], state[1], "nearest")),
        "warp_bilinear": (warp.warp, (left, state[0], state[1],
                                      "bilinear")),
        "direction": (direction.fused_direction_update,
                      (left, warped, bl2, state, 0.55, False)),
        "smooth": (smooth.fused_smooth_average, (state, 3)),
    }


@pytest.mark.parametrize("name", ["warp_nearest", "warp_bilinear",
                                  "direction", "smooth"])
def test_guarded_plain_ops(name):
    """With the flag set a guarded op computes nothing and leaves its
    output as it was (a NaN sentinel); with it clear it writes what the
    unguarded op returns, bit for bit."""
    fn, args = guarded_cases()[name]
    ref = fn(*args)
    flag = torch.ones(1, dtype=torch.int32)
    out = torch.full_like(ref, float("nan"))
    assert fn(*args, stop=flag, out=out) is out
    assert torch.isnan(out).all()
    flag.zero_()
    assert torch.equal(fn(*args, stop=flag, out=out), ref)
    assert torch.equal(fn(*args, stop=flag), ref)
    with pytest.raises(ValueError):
        fn(*args, stop=torch.ones(1, dtype=torch.int64))
    with pytest.raises(ValueError):
        fn(*args, out=torch.empty(1))
