"""The compile-once cache's host side on the CPU (graphs.py): the cache
key, the resample taps kept on the device per call site, the launch and
early-exit counts a replay adds, and the CPU engine, which captures
nothing.

The taps are bit-exact against the per-call numpy computation; a
resample from them is exact against the JAX package's interpret-mode
``resample_tex`` for nearest and within 2e-6 for bilinear (its one-hot
matmuls add the same terms in another order, as in
tests/test_torch_resample.py).  The CUDA graphs themselves run on the
card only (tests/test_torch_gpu.py)."""

import collections
import dataclasses
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ug_stereomatcher_tpu.ops.pallas.resample import resample_tex as p_resample
from ug_stereomatcher_tpu_torch import MatcherConfig, StereoEngine, scene
from ug_stereomatcher_tpu_torch import match as match_mod
from ug_stereomatcher_tpu_torch import pyramid as pyr
from ug_stereomatcher_tpu_torch.graphs import graph_key
from ug_stereomatcher_tpu_torch.ops.cuda import _build, resample
from ug_stereomatcher_tpu_torch.ops.resample import (
    ScaleMap,
    bilinear_taps,
    nearest_indices,
    resample_static_plain,
)
from ug_stereomatcher_tpu_torch.parallel.batch import make_batch_matcher

H, W = 96, 128
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ the key
def _other(value):
    """A value of the field's kind that differs from ``value``."""
    if value is None:
        return 0.1
    if isinstance(value, bool):
        return not value
    if isinstance(value, (int, float)):
        return value + 1
    return value + "_other"


@pytest.mark.parametrize("field", [f.name for f in
                                   dataclasses.fields(MatcherConfig)])
def test_graph_key_changes_with_every_config_field(field):
    cfg = MatcherConfig()
    same = MatcherConfig(**dataclasses.asdict(cfg))
    assert graph_key("match", (3, H, W), cfg) == graph_key("match", (3, H, W),
                                                         same)
    other = dataclasses.replace(cfg, **{field: _other(getattr(cfg, field))})
    assert graph_key("match", (3, H, W), other) != graph_key(
        "match", (3, H, W), cfg)


def test_graph_key_changes_with_entry_shape_gate_and_foveated():
    cfg = MatcherConfig()
    base = graph_key("match_batch", (2, 3, H, W), cfg, None, False)
    assert base == graph_key("match_batch", [2, 3, H, W], MatcherConfig(),
                             None, False)
    others = [graph_key("match", (2, 3, H, W), cfg, None, False),
              graph_key("match_batch", (3, 3, H, W), cfg, None, False),
              graph_key("match_batch", (2, 3, H + 1, W), cfg, None, False),
              graph_key("match_batch", (2, 3, H, W), cfg, 0, False),
              graph_key("match_batch", (2, 3, H, W), cfg, None, True)]
    assert len({base, *others}) == 1 + len(others)
    hash(base)


# ------------------------------------------------------------ the taps
def record_resample_calls(monkeypatch, run):
    """Every resample_tex call that ``run()`` makes through pyramid.py:
    (method, out_h, out_w, h, w, coord_of, row_off, col_off)."""
    calls = []
    real = pyr.resample_tex

    def spy(img, out_h, out_w, coord_of, value_scale=1.0,
            method="nearest", row_off=0, col_off=0):
        calls.append((method, out_h, out_w, img.shape[-2], img.shape[-1],
                      coord_of, row_off, col_off))
        return real(img, out_h, out_w, coord_of, value_scale, method,
                    row_off, col_off)
    monkeypatch.setattr(pyr, "resample_tex", spy)
    run()
    return calls


def as_lambda(m: ScaleMap):
    """The lambda each call site passed before ScaleMap."""
    f = m.factor
    return (lambda t: t / f) if m.divide else (lambda t: t * f)


@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
@pytest.mark.parametrize("entry", ["match", "match_foveated",
                                   "match_hierarchical"])
def test_cached_taps_equal_per_call_taps(monkeypatch, entry, interp):
    eng = StereoEngine(MatcherConfig(fovea_level=3, interp=interp),
                       device="cpu")
    left, right = scene.make_pair(H, W)
    calls = record_resample_calls(
        monkeypatch, lambda: getattr(eng, entry)(left, right))
    assert len(calls) >= 2 * (eng.config.num_levels(H, W) - 1)
    windowed = 0
    for method, oh, ow, h, w, coord, r0, c0 in calls:
        assert isinstance(coord, ScaleMap) and method == interp
        windowed += bool(r0 or c0)
        fn = as_lambda(coord)
        if method == "nearest":
            want = (nearest_indices(oh, h, fn, r0),
                    nearest_indices(ow, w, fn, c0))
        else:
            (iy, wy), (ix, wx) = (bilinear_taps(oh, h, fn, r0),
                                  bilinear_taps(ow, w, fn, c0))
            want = (iy, ix, wy, wx)
        got = resample.device_taps(CPU, method, oh, ow, h, w, coord, r0, c0)
        assert len(got) == len(want)
        for t, a in zip(got, want):
            assert t.dtype == torch.from_numpy(a).dtype
            np.testing.assert_array_equal(t.numpy().view(np.int32),
                                          a.view(np.int32))
        # one copy per key: the same tensors again
        again = resample.device_taps(CPU, method, oh, ow, h, w,
                                     ScaleMap(coord.factor, coord.divide),
                                     r0, c0)
        assert all(a is b for a, b in zip(got, again))
    # the fovea-to-fovea transitions are windowed
    assert windowed == (eng.config.fovea_level - 1 if entry != "match"
                        else 0)


@pytest.mark.parametrize("method", ["nearest", "bilinear"])
@pytest.mark.parametrize("case", ["subsample", "upsample", "fovea_window",
                                  "hierarchical"])
def test_repeated_resample_tex_matches_pallas(case, method):
    cfg = MatcherConfig()
    inv = 1.0 / cfg.scale
    shape, (h2, w2), r0, c0, coord, vs = {
        "subsample": ((6, 97, 131), (68, 92), 0, 0, ScaleMap(cfg.scale),
                      1.0),
        "upsample": ((3, 34, 53), (48, 75), 0, 0, ScaleMap(inv), cfg.scale),
        "fovea_window": ((3, 37, 53), (37, 53), 7, 11, ScaleMap(inv),
                         cfg.scale),
        "hierarchical": ((3, 37, 53), (52, 75), 0, 0,
                         ScaleMap(cfg.scale, divide=True), cfg.scale),
    }[case]
    img = np.random.RandomState(7).uniform(-3, 3, shape).astype(np.float32)
    ref = np.asarray(p_resample(jnp.asarray(img), h2, w2, as_lambda(coord),
                                vs, method, interpret=True, row_off=r0,
                                col_off=c0))
    src = torch.from_numpy(img)
    outs = [resample.resample_tex(src, h2, w2, coord, vs, method,
                                  row_off=r0, col_off=c0) for _ in range(2)]
    # the kept taps through the plain version: what the card's kernel reads
    taps = resample.device_taps(CPU, method, h2, w2, shape[1], shape[2],
                                coord, r0, c0)
    outs.append(resample_static_plain(src, taps[0], taps[1], vs, *taps[2:]))
    for out in outs:
        assert torch.equal(out, outs[0])
        if method == "nearest":
            np.testing.assert_array_equal(out.numpy(), ref)
        else:
            np.testing.assert_allclose(out.numpy(), ref, rtol=2e-6,
                                       atol=2e-6)


def test_scale_map_equals_its_lambda_bit_for_bit():
    t = np.arange(5000) + 0.5
    for m in (ScaleMap(1.41421356), ScaleMap(1 / 1.41421356), ScaleMap(2.0),
              ScaleMap(1.41421356, divide=True)):
        np.testing.assert_array_equal(m(t), as_lambda(m)(t))
    assert ScaleMap(2.0) == ScaleMap(2.0) and hash(ScaleMap(2.0)) == hash(
        ScaleMap(2.0))
    assert ScaleMap(2.0) != ScaleMap(2.0, divide=True)


# ------------------------------------------------------------ the counts
@pytest.fixture
def fake_entry(monkeypatch):
    """_build.launch with a C entry that does nothing (no library, no
    card): only its counting runs."""
    monkeypatch.setitem(_build._ENTRIES, "ugsm_fake", lambda *a: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda i: 0, raising=False)
    _build.reset_launch_counts()
    yield
    _build.reset_launch_counts()


def test_capture_counts_go_to_the_call_and_replays_add_them(fake_entry):
    _build.launch("ugsm_fake", "warp")
    captured = collections.Counter()
    with _build.counting_into(captured):
        for _ in range(3):
            _build.launch("ugsm_fake", "direction")
        _build.launch("ugsm_fake", "warp")
    assert _build.launch_counts() == {"warp": 1}
    assert captured == {"direction": 3, "warp": 1}
    for _ in range(2):
        _build.record_replay(captured)
    assert _build.launch_counts() == {"warp": 3, "direction": 6}
    assert _build.graph_replays() == 2
    _build.reset_launch_counts()
    assert _build.launch_counts() == {} and _build.graph_replays() == 0


def test_capture_counts_are_per_thread(fake_entry):
    captured = collections.Counter()
    with _build.counting_into(captured):
        t = threading.Thread(target=_build.launch, args=("ugsm_fake",
                                                         "blur"))
        t.start()
        t.join()
        _build.launch("ugsm_fake", "smooth")
    assert captured == {"smooth": 1}
    assert _build.launch_counts() == {"blur": 1}


def level_args(seed=0):
    rng = np.random.RandomState(seed)
    h, w = 24, 32
    left = torch.from_numpy(rng.uniform(0, 255, (3, h, w)).astype(np.float32))
    right = torch.roll(left, 2, dims=-1)
    disp = torch.zeros((3, h, w))
    return left, right, disp


def test_replayed_iteration_counts_equal_the_eager_loop():
    cfg = MatcherConfig(early_exit_delta=0.5)
    left, right, disp = level_args()

    def level():
        return match_mod.match_level(left, right, disp, 3, cfg, True,
                                     resident_max_pixels=0,
                                     exit_loop="device")
    match_mod.reset_host_syncs()
    eager = level()
    want = match_mod.iterations_run()
    assert 1 <= want <= cfg.iters_for_level(3)
    match_mod.reset_host_syncs()
    counts = match_mod.IterationCounts()
    with match_mod.counting_iterations_into(counts):
        out = level()
    assert torch.equal(out, eager)
    assert match_mod.iterations_run() == 0 and counts.levels == 1
    for replays in (1, 2, 3):
        match_mod.add_iterations(counts)
        assert match_mod.iterations_run() == replays * want
    assert match_mod.host_syncs() == 0
    match_mod.reset_host_syncs()
    match_mod.add_iterations(counts)
    assert match_mod.iterations_run() == want
    match_mod.reset_host_syncs()


def test_no_early_exit_level_adds_nothing():
    counts = match_mod.IterationCounts()
    left, right, disp = level_args()
    with match_mod.counting_iterations_into(counts):
        match_mod.match_level(left, right, disp, 3, MatcherConfig(), True,
                              resident_max_pixels=0)
    match_mod.reset_host_syncs()
    match_mod.add_iterations(counts)
    assert counts.last is None and match_mod.iterations_run() == 0


# ------------------------------------------------------------ CPU engine
@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
def test_cpu_engine_builds_no_graph_and_equals_the_module_path(interp):
    cfg = MatcherConfig(fovea_level=3, interp=interp)
    eng = StereoEngine(cfg, device="cpu")
    left, right = scene.make_pair(H, W)
    lt, rt = (torch.from_numpy(x).permute(2, 0, 1).float().contiguous()
              for x in (left, right))
    n = cfg.num_levels(H, W)
    lp, rp = pyr.build_pyramid_pair(lt, rt, cfg, n)
    mode1 = match_mod.match_pyramid(lp, rp, cfg, (H, W)).levels[0]
    levels, _, _ = match_mod.match_foveated_pair(lt, rt, cfg)
    stack = torch.cat(levels[:cfg.fovea_level], dim=-2)
    hier = pyr.hierarchical_disparity(levels, cfg, (H, W))
    batch = make_batch_matcher(cfg, None, "cpu")(
        torch.stack([lt, rt]), torch.stack([rt, lt]))
    for _ in range(2):   # a second call is computed anew, the same
        assert torch.equal(eng.match(left, right).triplet, mode1)
        fov = eng.match_foveated(left, right)
        assert torch.equal(torch.stack([fov.stack_h, fov.stack_v,
                                        fov.stack_c]), stack)
        assert torch.equal(eng.match_hierarchical(left, right).triplet, hier)
        res = eng.match_batch(np.stack([left, right]),
                              np.stack([right, left]))
        assert torch.equal(torch.stack([res.disparity_h, res.disparity_v,
                                        res.confidence], dim=1), batch)
    assert eng.graphs == {}
