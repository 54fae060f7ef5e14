"""The port's plain path against the benchmark's plain reference, at a
tiny size on the CPU: bit for bit, in both modes and both samplings.
(The test is the port's; the reference imports nothing of it.)"""

import pytest
import torch

from stereo_bench import scene as sb_scene
from stereo_bench.reference import match_pair
from ug_stereomatcher_tpu_torch import MatcherConfig, StereoEngine

DISP = {"h_px": [0, 32], "v_px": [-4, 4], "at_width": 4928 // 16,
        "h_waves": 2, "cycles": [0.5, 2.0]}


@pytest.fixture(scope="module")
def pair():
    ((lft, rgt),) = sb_scene.make_pool(1, 1, (96, 128), 2 ** 31 + 5, DISP,
                                       "cpu")
    return lft, rgt


def chw(x):
    return torch.from_numpy(x).permute(2, 0, 1)


@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
def test_mode1_bit_for_bit(pair, interp):
    lft, rgt = pair
    res = StereoEngine(MatcherConfig(interp=interp), device="cpu").match(
        lft, rgt)
    ref = match_pair(chw(lft), chw(rgt), {"interp": interp}, False)
    assert torch.equal(res.triplet, ref["triplet"])


@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
def test_mode2_bit_for_bit(pair, interp):
    lft, rgt = pair
    res = StereoEngine(MatcherConfig(interp=interp),
                       device="cpu").match_foveated(lft, rgt)
    ref = match_pair(chw(lft), chw(rgt), {"interp": interp}, True)
    assert torch.equal(torch.stack([res.stack_h, res.stack_v, res.stack_c]),
                       ref["stack"])
    assert torch.equal(res.stack_left, ref["stack_left"])
    assert torch.equal(res.stack_right, ref["stack_right"])


def test_the_reference_imports_nothing_of_the_program():
    import ast
    import pathlib

    import stereo_bench.reference as r
    for path in pathlib.Path(r.__file__).parent.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module:
                assert not node.module.startswith("ug_stereomatcher"), path
            if isinstance(node, ast.Import):
                assert not any(a.name.startswith("ug_stereomatcher")
                               for a in node.names), path
