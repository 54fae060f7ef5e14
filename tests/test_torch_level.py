"""The port's level-resident matcher against the JAX package's.

On the CPU ``level_resident_match`` runs its plain version, the
per-iteration loop; it is held here against the JAX package's
``match_level`` with ``level_backend="interpret"``, which runs the
level-resident Pallas kernel in interpret mode.  Tolerances are those of
tests/test_level_kernel.py:51-79: rtol=atol=1e-4 for bilinear, and for
nearest the quantile rule (q99 <= 2e-3, max <= 0.05), since a nearest warp
flips gather indices on float noise.

The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_gpu.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ug_stereomatcher_tpu import match as jmatch
from ug_stereomatcher_tpu.config import MatcherConfig as JaxConfig
from ug_stereomatcher_tpu_torch import match as tmatch
from ug_stereomatcher_tpu_torch.config import MatcherConfig
from ug_stereomatcher_tpu_torch.ops.cuda import _build, level


def smooth_scene(h, w, shift=1.5, seed=3):
    """The correlated random pair of tests/test_level_kernel.py, numpy."""
    rng = np.random.RandomState(seed)
    base = rng.rand(3, h + 8, w + 8).astype(np.float32)
    for axis in (1, 2):  # crude blur for spatial correlation
        base = 0.25 * np.roll(base, 1, axis) + 0.5 * base \
            + 0.25 * np.roll(base, -1, axis)
    s = int(round(shift))
    left = np.ascontiguousarray(base[:, 4:4 + h, 4:4 + w])
    right = np.ascontiguousarray(base[:, 4:4 + h, 4 + s:4 + s + w])
    return left, right


def assert_lockstep_close(out, ref, *, q99=2e-3, cap=0.05):
    d = np.abs(out - ref)
    assert np.quantile(d, 0.99) <= q99, (np.quantile(d, 0.99), d.max())
    assert d.max() <= cap, d.max()


@pytest.mark.parametrize("method", ["nearest", "bilinear"])
def test_level_resident_matches_jax_interpret(method):
    """Both values of is_coarsest in one case, to keep the interpret-mode
    runs few."""
    h, w = 36, 52
    left, right = smooth_scene(h, w)
    level_index = 6
    jcfg = JaxConfig(interp=method, level_cutoff=6, level_backend="interpret")
    cfg = MatcherConfig.from_reference(dataclasses.asdict(jcfg))
    mi = cfg.iters_for_level(level_index)
    for is_coarsest in (True, False):
        disp = np.zeros((3, h, w), np.float32)
        if not is_coarsest:
            disp[2] = 0.5  # non-trivial confidence carry-in
        ref = np.asarray(jmatch.match_level(
            jnp.asarray(left), jnp.asarray(right), jnp.asarray(disp),
            level_index, jcfg, is_coarsest))
        out = level.level_resident_match(
            torch.from_numpy(left), torch.from_numpy(right),
            torch.from_numpy(disp), cfg.threshold_schedule(mi),
            cfg.smooth_passes_for_level(level_index), is_coarsest,
            cfg.conf_consts, method).numpy()
        if method == "bilinear":
            np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4,
                                       err_msg=f"is_coarsest={is_coarsest}")
        else:
            assert_lockstep_close(out, ref)


@pytest.mark.parametrize("method", ["nearest", "bilinear"])
def test_match_level_routes_agree_on_cpu(method):
    """Both routes of match_level are the same plain loop on the CPU."""
    cfg = MatcherConfig(interp=method, level_cutoff=4)
    left, right = (torch.from_numpy(a) for a in smooth_scene(20, 31, seed=5))
    disp = torch.zeros(3, 20, 31)
    _build.reset_launch_counts()
    resident = tmatch.match_level(left, right, disp, 7, cfg, True)
    per_iter = tmatch.match_level(left, right, disp, 7, cfg, True,
                                  resident_max_pixels=0)
    assert torch.equal(resident, per_iter)
    assert _build.launch_counts() == {}


def test_gate_admits_levels_8_to_13_at_16mp():
    """Levels 8-13 and, since the gate was set anew by measurement, 6-7."""
    dims = MatcherConfig().dims_chain(3264, 4928)
    resident = [i for i, (h, w) in enumerate(dims)
                if tmatch.uses_level_resident(h, w)]
    assert resident == list(range(6, 14))
    assert dims[6] == (407, 615) and dims[5] == (576, 870)
    assert not tmatch.uses_level_resident(*dims[8], resident_max_pixels=0)


def test_gate_declines_schedules_beyond_the_level_kernel():
    """More iterations than the kernel takes go per iteration on any
    device; the smoothing-pass limit is the card's, asked only on one."""
    assert tmatch.uses_level_resident(20, 31, None, 5, level.MAX_ITERS)
    assert not tmatch.uses_level_resident(20, 31, None, 5,
                                          level.MAX_ITERS + 1)
    assert tmatch.uses_level_resident(20, 31, None, 10 ** 6, 22, "nearest",
                                      torch.device("cpu"))
    # the route the gate picks runs: no ValueError from the level op
    cfg = MatcherConfig(level_cutoff=level.MAX_ITERS + 1)
    left, right = (torch.from_numpy(a) for a in smooth_scene(6, 8, seed=5))
    out = tmatch.match_level(left, right, torch.zeros(3, 6, 8), 7, cfg, True)
    assert out.shape == (3, 6, 8) and torch.isfinite(out).all()


def test_many_smoothing_passes_match_jax_per_iteration_chain():
    """40 passes (beyond the level kernel's window on an H100) at a coarse
    level, against the JAX package's per-iteration chain (level_backend
    "xla"), two iterations; nearest, so the quantile rule."""
    h, w = 32, 48
    left, right = smooth_scene(h, w, seed=7)
    jcfg = JaxConfig(smooth_passes=40, level_cutoff=2, level_backend="xla")
    cfg = MatcherConfig.from_reference(dataclasses.asdict(jcfg))
    level_index = 6
    assert cfg.smooth_passes_for_level(level_index) == 40
    assert cfg.iters_for_level(level_index) == 2
    disp = np.zeros((3, h, w), np.float32)
    disp[2] = 0.5
    ref = np.asarray(jmatch.match_level(
        jnp.asarray(left), jnp.asarray(right), jnp.asarray(disp),
        level_index, jcfg, False))
    out = tmatch.match_level(torch.from_numpy(left), torch.from_numpy(right),
                             torch.from_numpy(disp), level_index, cfg,
                             False).numpy()
    assert_lockstep_close(out, ref)


def test_level_resident_checks_arguments():
    x = torch.zeros(3, 8, 10)
    with pytest.raises(ValueError, match="state"):
        level.level_resident_match(x, x, x[:2], (1.0,), 5, True)
    with pytest.raises(ValueError, match="right"):
        level.level_resident_match(x, x[:, :4], x, (1.0,), 5, True)
    with pytest.raises(ValueError, match="at most"):
        level.level_resident_match(x, x, x, (1.0,) * (level.MAX_ITERS + 1),
                                   5, True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        level.level_resident_match(x, x, x, (1.0,), 5, True, method="cubic")
