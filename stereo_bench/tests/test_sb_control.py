"""The limits of the check sit between their two readings: the sound
float32 variants (the reference with its sums in another order,
``stereo_bench.sound``) come out correct, and the lower-precision
control (the reference computed in bfloat16, put in the program's
place) does not, for every configuration.  Here at a small size on the
CPU, where the early-exit configuration's gate is lowered to 0 so that
its levels exit as a 16 MP frame's levels 0-5 do; PERF.md gives both
readings at the cells' sizes on the card."""

import pytest
import torch

from stereo_bench import check, scene, sound, spec
from stereo_bench.reference import match_pair

CELLS = ["ugsm_mode1.single", "ugsm_foveated.single",
         "ugsm_mode1_bilinear_ee.single"]


def _judge(workload, seed, variant=None, dtype=torch.float32):
    cell = spec.load(workload)
    ((lft, rgt),) = scene.make_pool(1, 1, (192, 256), seed,
                                    cell.traffic["disparity"], "cpu")
    ins = [torch.from_numpy(x).permute(2, 0, 1) for x in (lft, rgt)]
    m = cell.config["matcher"]
    gate = 0 if m["early_exit_delta"] is not None else None
    ref = match_pair(*ins, m, cell.foveated, exit_above_px=gate)
    if variant is None:
        got = match_pair(*ins, m, cell.foveated, dtype, exit_above_px=gate)
    else:
        with sound.variant(variant):
            got = match_pair(*ins, m, cell.foveated, exit_above_px=gate)
    reading = check.compare(got, ref, m["fovea_level"])
    if gate is not None:
        reading[check.ITERATIONS_GAP] = check.iterations_gap(
            check.iterations_of(got), check.iterations_of(ref))
    return check.judge([reading], cell.config["limits"])


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_bfloat16_control_is_not_correct(workload, seed):
    ok, numbers = _judge(workload, seed, dtype=torch.bfloat16)
    assert not ok, numbers
    ok, numbers = _judge(workload, seed)
    assert ok and all(v["value"] == 0.0 for v in numbers.values())


@pytest.mark.parametrize("workload,variant", [
    (w, v) for w in CELLS for v in sound.VARIANTS
    if v not in sound.EXIT_VARIANTS
    or spec.load(w).config["matcher"]["early_exit_delta"] is not None])
def test_a_sound_reordering_is_correct(workload, variant):
    ok, numbers = _judge(workload, 4, variant)
    assert ok, numbers
    # the float32 exit sums move an answer only where a level's change
    # lies within rounding of the threshold
    assert variant in sound.EXIT_VARIANTS or any(
        v["value"] > 0.0 for v in numbers.values())


def test_the_variants_leave_the_reference_as_it_was():
    def now():
        return (sound.M.conv1d, sound.M.smooth, sound.M._clip01,
                sound.M.weighted_difference)
    before = now()
    for v in sound.VARIANTS:
        with sound.variant(v):
            assert now() != before
    assert now() == before
