"""The port's MatcherConfig against the JAX package's: defaults, tap
tables, dimension chains and schedules agree, ``from_reference`` carries a
JAX config across, and importing the port never loads jax."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from ug_stereomatcher_tpu import config as jcfg
from ug_stereomatcher_tpu_torch import config as tcfg

SHARED_FIELDS = [f.name for f in dataclasses.fields(tcfg.MatcherConfig)]
SIZES = [(3264, 4928), (96, 128), (1536, 2048), (37, 53), (8, 8)]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", SHARED_FIELDS)
def test_shared_default_equals_jax(name):
    assert getattr(tcfg.MatcherConfig(), name) == \
        getattr(jcfg.MatcherConfig(), name)


def test_dropped_fields_are_the_tpu_only_ones():
    jax_fields = {f.name for f in dataclasses.fields(jcfg.MatcherConfig)}
    assert jax_fields - set(SHARED_FIELDS) == tcfg.TPU_ONLY_FIELDS
    assert set(SHARED_FIELDS) <= jax_fields


def test_tap_tables_bitwise_equal():
    for fn in ("gaussian_kernel", "average_kernel"):
        a, b = getattr(tcfg, fn)(), getattr(jcfg, fn)()
        assert a.dtype == b.dtype == np.float32
        assert a.tobytes() == b.tobytes(), fn
    assert tcfg.MOVES == jcfg.MOVES
    assert tcfg.REFERENCE_SCALE == jcfg.REFERENCE_SCALE


@pytest.mark.parametrize("sigma,radius,precision", [
    (1.1, 2, 5), (0.7, 1, 3), (2.5, 4, 9), (1.0, 3, 2)])
def test_analytic_gaussian_kernel_bitwise_equal(sigma, radius, precision):
    a = tcfg.analytic_gaussian_kernel(sigma, radius, precision)
    b = jcfg.analytic_gaussian_kernel(sigma, radius, precision)
    assert a.dtype == b.dtype == np.float32
    assert a.shape == (2 * radius + 1,)
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("threshold", [1.0, 0.35, 2.0])
def test_moves_equal_jax(threshold):
    t = tcfg.MatcherConfig(threshold_init=threshold)
    j = jcfg.MatcherConfig(threshold_init=threshold)
    assert t.moves == j.moves
    assert [m[0] / threshold for m in t.moves] == [m[0] for m in tcfg.MOVES]


@pytest.mark.parametrize("h,w", SIZES)
def test_dims_chain_and_num_levels(h, w):
    t, j = tcfg.MatcherConfig(), jcfg.MatcherConfig()
    assert t.dims_chain(h, w) == j.dims_chain(h, w)
    assert t.num_levels(h, w) == j.num_levels(h, w)


@pytest.mark.parametrize("level", range(14))
def test_iteration_schedule(level):
    t, j = tcfg.MatcherConfig(), jcfg.MatcherConfig()
    mi = t.iters_for_level(level)
    assert mi == j.iters_for_level(level)
    assert t.smooth_passes_for_level(level) == \
        j.smooth_passes_for_level(level)
    assert t.threshold_schedule(mi) == j.threshold_schedule(mi)


def test_sixteen_mp_schedule_totals():
    """The mode-1 slice at 16 MP: 14 levels and 218 iterations."""
    cfg = tcfg.MatcherConfig()
    n = cfg.num_levels(3264, 4928)
    assert n == 14
    assert sum(cfg.iters_for_level(i) for i in range(n)) == 218


def test_from_reference_round_trips():
    ref = jcfg.MatcherConfig(level_cutoff=9, conf_no_peak=0.3,
                             warp_backend="xla", level_backend="xla",
                             scale_conf_on_upsample=False)
    port = tcfg.MatcherConfig.from_reference(dataclasses.asdict(ref))
    assert port == tcfg.MatcherConfig(level_cutoff=9, conf_no_peak=0.3,
                                      scale_conf_on_upsample=False)
    back = {k: v for k, v in dataclasses.asdict(ref).items()
            if k not in tcfg.TPU_ONLY_FIELDS}
    assert dataclasses.asdict(port) == back


@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
def test_interp_modes_are_supported_and_carried(interp):
    ref = jcfg.MatcherConfig(interp=interp, level_backend="interpret")
    port = tcfg.MatcherConfig.from_reference(dataclasses.asdict(ref))
    assert port.interp == interp
    tcfg.check_supported(port)


def test_from_reference_rejects_unknown_fields():
    mapping = dataclasses.asdict(jcfg.MatcherConfig())
    mapping["not_a_field"] = 1
    with pytest.raises(ValueError, match="not_a_field"):
        tcfg.MatcherConfig.from_reference(mapping)


@pytest.mark.parametrize("kw,exc", [
    ({"interp": "linear"}, ValueError),
    ({"interp": "cubic"}, NotImplementedError),
    ({"interp": "lanczos"}, ValueError),
    ({"dtype": "bfloat16"}, NotImplementedError),
])
def test_unported_modes_raise(kw, exc):
    with pytest.raises(exc) as info:
        tcfg.check_supported(tcfg.MatcherConfig(**kw))
    if exc is NotImplementedError and "dtype" not in kw:
        assert "ROADMAP.md" in str(info.value)


def test_import_leaves_jax_out():
    code = ("import sys, ug_stereomatcher_tpu_torch, "
            "ug_stereomatcher_tpu_torch.match, "
            "ug_stereomatcher_tpu_torch.ops.cuda._build, "
            "ug_stereomatcher_tpu_torch.ops.consistency, "
            "ug_stereomatcher_tpu_torch.ops.convergence, "
            "ug_stereomatcher_tpu_torch.geom, "
            "ug_stereomatcher_tpu_torch.eval, ug_stereomatcher_tpu_torch.io, "
            "ug_stereomatcher_tpu_torch.io.viz, "
            "ug_stereomatcher_tpu_torch.native, "
            "ug_stereomatcher_tpu_torch.pipeline, "
            "ug_stereomatcher_tpu_torch.cli, "
            "ug_stereomatcher_tpu_torch.__main__, "
            "ug_stereomatcher_tpu_torch.parallel.multihost, "
            "ug_stereomatcher_tpu_torch.parallel.throughput, "
            "ug_stereomatcher_tpu_torch.profiling; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'ug_stereomatcher_tpu.'))"
            " or m == 'ug_stereomatcher_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
