"""A run with the timed path broken underneath comes out not correct:
the look for a card is skipped and the rest of a run is driven on the
CPU at a tiny frame, once for each fault the cells can have."""

import pytest
import torch

from stereo_bench import spec
from stereo_bench.tests.helpers import cpu_run, with_cell
from ug_stereomatcher_tpu_torch import match as match_mod
from ug_stereomatcher_tpu_torch.parallel import batch as batch_mod


def test_sound_runs_are_correct():
    for cell in ("ugsm_mode1.single", "ugsm_foveated.single",
                 "ugsm_mode1.single_resident",
                 "ugsm_mode1_bilinear_ee.single",
                 "ugsm_mode1_bilinear_ee.single_resident"):
        assert cpu_run(cell)["correct"] is True


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    monkeypatch.setattr(match_mod, "match_level",
                        lambda left, right, disp, *a, **k: disp)
    for cell in ("ugsm_mode1.single", "ugsm_foveated.single",
                 "ugsm_mode1_bilinear_ee.single"):
        res = cpu_run(cell)
        assert res["correct"] is False, res["check"]


def test_half_of_the_batch_left_out(monkeypatch):
    orig = batch_mod.BatchMatcher.__call__

    def half(self, lb, rb):
        h = lb.shape[0] // 2
        out = orig(self, lb[:h], rb[:h])
        return torch.cat([out, out])   # the rest: the matched half again
    monkeypatch.setattr(batch_mod.BatchMatcher, "__call__", half)
    # the 16 MP field's range in pixels, so that two pairs' answers
    # differ as much as at the cell's size
    disp = dict(spec.load("ugsm_mode1.batch8").traffic["disparity"],
                at_width=96)
    res = cpu_run("ugsm_mode1.batch8",
                  overrides={"pairs_per_call": 4, "disparity": disp})
    assert res["correct"] is False, res["check"]


def test_the_exchange_between_cards_left_out(monkeypatch, tmp_path):
    """On the data-parallel mix, whose cell waits in PERF.md's open
    questions: added here as a cell of a copy of the benchmark."""
    root = with_cell(tmp_path, "ugsm_mode1.dp4", "ugsm_mode1", "dp4", 4)
    orig = batch_mod._group_matcher

    def local_only(cfg, mesh, foveated):
        fn = orig(cfg, mesh, foveated)

        def group(left, right, g, out):
            res = fn(left, right, g, out)
            # groups past the first never reach the gathering device
            return res if g == 0 else torch.zeros_like(res)
        return group
    monkeypatch.setattr(batch_mod, "_group_matcher", local_only)
    res = cpu_run("ugsm_mode1.dp4", root=root)
    assert res["correct"] is False, res["check"]


@pytest.mark.parametrize("cell", ["ugsm_mode1.single",
                                  "ugsm_foveated.single",
                                  "ugsm_mode1.batch8",
                                  "ugsm_mode1_bilinear_ee.single"])
def test_an_answer_altered_where_it_is_produced(monkeypatch, cell):
    orig = match_mod.match_pyramid

    def altered(*a, **k):
        res = orig(*a, **k)
        lv = list(res.levels)
        # a whole-pixel offset of the horizontal plane, as a wrong
        # centre or border convention gives
        lv[0] = lv[0] + torch.tensor([2.0, 0.0, 0.0])[:, None, None]
        return match_mod.PyramidMatchResult(levels=tuple(lv))
    monkeypatch.setattr(match_mod, "match_pyramid", altered)
    res = cpu_run(cell, overrides={"pairs_per_call": 2})
    assert res["correct"] is False, res["check"]
