"""Early exit in the benchmark's reference, its check and its work model,
at small frames on the CPU.  A small frame has no level above the
configuration's gate of 256 Ki pixels, so these tests lower the gate to
0 on both sides (the reference's ``exit_above_px``, the port's
``LEVEL_RESIDENT_MAX_PIXELS``): every level then exits as levels 0-5 of
a 16 MP frame do."""

import json
import shutil

import pytest
import torch

from stereo_bench import check, scene, spec, work
from stereo_bench.reference import match_pair
from stereo_bench.reference import matcher as M
from stereo_bench.tests.helpers import cpu_run
from ug_stereomatcher_tpu_torch import MatcherConfig, StereoEngine
from ug_stereomatcher_tpu_torch import match as match_mod

CELL = "ugsm_mode1_bilinear_ee.single"
DISP = {"h_px": [0, 32], "v_px": [-4, 4], "at_width": 4928 // 16,
        "h_waves": 2, "cycles": [0.5, 2.0]}


def _pair(frame=(96, 128), seed=2 ** 31 + 5):
    ((lft, rgt),) = scene.make_pool(1, 1, frame, seed, DISP, "cpu")
    return lft, rgt


def _chw(x):
    return torch.from_numpy(x).permute(2, 0, 1)


@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
def test_no_early_exit_is_the_fixed_schedule_bit_for_bit(interp):
    """A threshold of 0 never stops a level (no change is below it), and
    a gate above every level lets none exit: both are the fixed
    schedule, bit for bit, with its iterations."""
    lft, rgt = (_chw(x) for x in _pair())
    fixed = match_pair(lft, rgt, {"interp": interp}, False)
    s = M.Schedule({})
    full = [s.iters(i) for i in range(len(fixed["iterations"]))]
    assert fixed["iterations"] == full and fixed["exit_levels"] == []
    never = match_pair(lft, rgt, {"interp": interp, "early_exit_delta": 0.0},
                       False, exit_above_px=0)
    gated = match_pair(lft, rgt, {"interp": interp, "early_exit_delta": 0.5},
                       False, exit_above_px=10 ** 9)
    for other in (never, gated):
        assert torch.equal(other["triplet"], fixed["triplet"])
        assert other["iterations"] == full
    assert never["exit_levels"] == list(range(len(full)))


@pytest.mark.parametrize("delta", [0.02, 0.04])
def test_the_port_exits_where_the_reference_does(monkeypatch, delta):
    """The port's host_exit_loop runs the same iterations level by level
    as the reference, and then the same answer."""
    monkeypatch.setattr(match_mod, "LEVEL_RESIDENT_MAX_PIXELS", 0)
    lft, rgt = _pair()
    fields = {"interp": "bilinear", "early_exit_delta": delta}
    ref = match_pair(_chw(lft), _chw(rgt), fields, False, exit_above_px=0)
    per_level = []
    orig = match_mod.host_exit_loop

    def counted(*a, **k):
        before = match_mod.iterations_run()
        out = orig(*a, **k)
        per_level.append(match_mod.iterations_run() - before)
        return out
    monkeypatch.setattr(match_mod, "host_exit_loop", counted)
    res = StereoEngine(MatcherConfig(**fields), device="cpu").match(lft, rgt)
    assert per_level[::-1] == ref["iterations"]
    assert torch.equal(res.triplet, ref["triplet"])
    if delta == 0.04:   # the frame's levels stop early at 0.04
        assert sum(ref["iterations"]) < sum(M.Schedule({}).iters(i) for i
                                            in range(len(per_level)))


def test_a_level_whose_confidence_sums_to_zero_exits_after_one(monkeypatch):
    def no_confidence(left, warped, bl2, state, *a):
        out = state.clone()
        out[0] += 1.0
        out[2] = 0.0
        return out
    monkeypatch.setattr(M, "direction_update", no_confidence)
    monkeypatch.setattr(M, "smooth", lambda state, passes: state)
    s = M.Schedule({"early_exit_delta": 0.02})
    img = torch.rand(3, 8, 12)
    state, n = M.match_level(img, img, torch.zeros(3, 8, 12), 3, s, False,
                             exits=True)
    assert n == 1 and s.iters(3) == 8
    assert M.weighted_difference(state[0], state[0] - 1, state[2]) == 0.0


def test_a_nan_change_stops_a_level():
    nan = float("nan")
    assert not M.changed_enough(nan, 1.0, 0.02)
    assert not M.changed_enough(0.01, 0.019, 0.02)
    assert M.changed_enough(0.01, 0.02, float(torch.tensor(0.02).item()))


def test_work_counts_the_reference_iterations():
    frame = (3264, 4928)
    fields = dict(spec.load(CELL).config["matcher"])
    s = M.Schedule(fields)
    exit_levels = spec.load(CELL).config["guarantees"][
        "exit_levels_at_frame"]
    full = {i: float(s.iters(i)) for i in exit_levels}
    at_full = work.match_least_s(fields, frame, False, full)["least_s"]
    fixed = dict(fields, early_exit_delta=None)
    plain = work.match_least_s(fixed, frame, False)["least_s"]
    # at full iterations only the convergence test's work is added
    tests = sum(work.bound(*work.level_work(
        a * b, s.iters(i), s.passes(i), "bilinear", True))[0]
        - work.bound(*work.level_work(a * b, s.iters(i), s.passes(i),
                                      "bilinear"))[0]
        for i, (a, b) in enumerate(s.dims_chain(*frame)) if i in full)
    assert at_full == pytest.approx(plain + tests, rel=1e-12)
    fewer = work.match_least_s(fields, frame, False,
                               {i: 2.0 for i in exit_levels})["least_s"]
    assert fewer < at_full
    with pytest.raises(ValueError):
        work.match_least_s(fields, frame, False)


def test_bilinear_resamples_read_the_whole_source():
    """The kernel table's bound of the bilinear subsamples at 16 MP:
    0.1728 ms for the sqrt(2) step and 0.1439 ms for the x2 step."""
    s = M.Schedule({})
    dims = s.dims_chain(3264, 4928)
    px = [a * b for a, b in dims]
    root2 = work.resample_bytes(px[0], px[1], 6, "bilinear")
    two = work.resample_bytes(px[0], px[2], 6, "bilinear")
    assert root2 / work.HBM_BYTES_PER_S == pytest.approx(0.1728e-3, rel=2e-3)
    assert two / work.HBM_BYTES_PER_S == pytest.approx(0.1439e-3, rel=2e-3)
    assert work.resample_bytes(px[0], px[1], 6, "nearest") == 48 * px[1]


def test_the_configuration_states_levels_0_to_5():
    cfg = spec.load(CELL).config
    g = cfg["guarantees"]
    s = M.Schedule(cfg["matcher"])
    dims = s.dims_chain(*cfg["frame"])[:s.num_levels(*cfg["frame"])]
    assert [i for i, (a, b) in enumerate(dims)
            if s.exits(i, a * b, g["exit_levels_above_px"])] == \
        g["exit_levels_at_frame"] == [0, 1, 2, 3, 4, 5]


def _gate_zero(tmp_path):
    """A copy of the benchmark whose early-exit configuration lets every
    level exit."""
    shutil.copytree(spec.ROOT / spec.PACKAGE, tmp_path / spec.PACKAGE)
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    path = tmp_path / spec.PACKAGE / "configs" / "ugsm_mode1_bilinear_ee.json"
    cfg = json.load(open(path))
    cfg["guarantees"]["exit_levels_above_px"] = 0
    json.dump(cfg, open(path, "w"))
    return tmp_path


@pytest.mark.parametrize("cell", [CELL, CELL + "_resident"])
def test_iterations_gap_fails_an_exit_at_twice_the_delta(monkeypatch,
                                                         tmp_path, cell):
    monkeypatch.setattr(match_mod, "LEVEL_RESIDENT_MAX_PIXELS", 0)
    root = _gate_zero(tmp_path)
    over = {"frame": [96, 128], "disparity": DISP}
    sound = cpu_run(cell, root=root, overrides=over)
    assert sound["correct"] is True, sound["check"]
    assert sound["check"]["iterations_gap"]["value"] == 0.0
    doubled = cpu_run(cell, root=root, overrides=over,
                      program_fields={"early_exit_delta": 0.04})
    assert doubled["correct"] is False
    gap = doubled["check"]["iterations_gap"]
    assert gap["value"] > gap["limit"], gap


def test_iterations_per_pair_reads_the_window(monkeypatch, tmp_path):
    monkeypatch.setattr(match_mod, "LEVEL_RESIDENT_MAX_PIXELS", 0)
    root = _gate_zero(tmp_path)
    res = cpu_run(CELL, seed=7, root=root, traced=True,
                  overrides={"frame": [96, 128], "disparity": DISP,
                             "pool": 1})
    lft, rgt = _pair(seed=7)
    ref = match_pair(_chw(lft), _chw(rgt), spec.load(CELL).config["matcher"],
                     False, exit_above_px=0)
    assert res["metrics"]["level.iterations_per_pair"]["value"] == \
        sum(ref["iterations"]) < 64


def test_no_counter_nothing_to_read():
    import types
    read = spec.reader("level.iterations_per_pair")
    assert read(types.SimpleNamespace(pairs=10)) is None
    assert read(types.SimpleNamespace(pairs=10, iterations=None)) is None
    assert read(types.SimpleNamespace(pairs=10, iterations=120)) == 12.0
    assert spec.reader("level.iterations_per_pair.resident")(
        types.SimpleNamespace(pairs=4, iterations=48)) == 12.0


def test_a_gap_is_read_for_the_whole_call():
    ans = {"iterations": [2, 3, 6, 22], "exit_levels": [0, 1, 2]}
    assert check.iterations_of(ans) == 11
    assert check.iterations_gap(12, 11) == check.iterations_gap(10, 11) == 1
    ok, numbers = check.judge([{"iterations_gap": 1.0}, {}],
                              {"iterations_gap": 2})
    assert ok and numbers["iterations_gap"]["value"] == 1.0
    ok, _ = check.judge([{}], {"iterations_gap": 2})
    assert not ok
