"""How ``correct`` is decided: the program's answers against the plain
reference, by numbers that each have a limit.

An answer is one pair's output as the timed call handed it over: mode 1
its (3, H, W) triplet [disparity_h, disparity_v, confidence]; mode 2
its fovea stack, judged level by level, and its two image stacks.  For
every part of every sampled answer (a NaN agrees only with a NaN):

* ``far_share_px``: the share of the two disparity planes' values that
  lie more than ``FAR_PX`` from the reference's;
* ``mean_abs_conf``: the mean absolute gap of the confidence plane;
* ``mean_abs_grey``: the mean absolute gap of an image stack (mode 2),
  in grey levels;
* ``mean_abs_px``: the mean absolute gap of the two disparity planes,
  read for ``control`` and compared with no limit: a sound reordering
  moves a few regions into another match, so it swings from seed to
  seed to within three times of the control's (PERF.md).

In an early-exit configuration one more number, for each sampled call:

* ``iterations_gap``: |program - reference| in the iterations that the
  early-exit levels ran, the program's read from its own counter
  (``match.iterations_run()`` before and after the call), the
  reference's summed over the call's pairs (``iterations_of``).  A change
  of the convergence test's sums within rounding flips a level whose
  change lies within about 1e-6 of the threshold by one iteration; an
  exit at another threshold moves every level.

Each number is the worst over the parts and answers.  The limits are the
configuration file's ``limits``, set from the readings of
``stereo_bench.control``: the sound float32 variants of
``stereo_bench.sound`` below them, the bfloat16 control above.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Mapping, Tuple

import numpy as np
import torch

FAR_PX = 1.0
NUMBERS = ("far_share_px", "mean_abs_conf", "mean_abs_grey", "mean_abs_px")
ITERATIONS_GAP = "iterations_gap"


def parts(answer: Mapping[str, torch.Tensor], levels: int
          ) -> Iterable[Tuple[str, torch.Tensor, bool]]:
    """(name, tensor, is_triplet) of each judged part of an answer."""
    if "triplet" in answer:
        yield "triplet", answer["triplet"], True
        return
    stack = answer["stack"]
    rows = stack.shape[-2] // levels
    for i in range(levels):
        yield f"level_{i}", stack[:, i * rows:(i + 1) * rows], True
    for side in ("stack_left", "stack_right"):
        if side in answer:   # a batch's mode-2 answer has no image stacks
            yield side, answer[side], False


def _worst(values: List[float]) -> float:
    """The largest value; NaN if there is none, or if any is NaN."""
    if not values or any(math.isnan(v) for v in values):
        return float("nan")
    return max(values)


def compare(answer: Mapping[str, torch.Tensor],
            ref: Mapping[str, torch.Tensor], levels: int) -> Dict[str, float]:
    """The numbers of one answer against the reference's."""
    got = {name: t for name, t, _ in parts(answer, levels)}
    worst = {n: 0.0 for n in NUMBERS}

    def keep(name, value):
        worst[name] = _worst([worst[name], value])

    for name, want, triplet in parts(ref, levels):
        a = got[name].to(want.device, torch.float32)
        b = want.to(torch.float32)
        if a.shape != b.shape:
            raise ValueError(f"{name}: shape {tuple(a.shape)} against the "
                             f"reference's {tuple(b.shape)}")
        both_nan = torch.isnan(a) & torch.isnan(b)
        gap = torch.where(both_nan, 0.0, (a - b).abs())
        if triplet:
            keep("mean_abs_px", gap[:2].double().mean().item())
            keep("mean_abs_conf", gap[2].double().mean().item())
            keep("far_share_px", (~(gap[:2] <= FAR_PX)).float().mean().item())
        else:
            keep("mean_abs_grey", gap.double().mean().item())
    return worst


def iterations_of(answer: Mapping[str, object]) -> int:
    """The iterations that a reference answer's early-exit levels ran."""
    return sum(answer["iterations"][i] for i in answer["exit_levels"])


def iterations_gap(program: int, reference: int) -> float:
    """|program - reference| in the iterations of the early-exit levels."""
    return float(abs(int(program) - int(reference)))


def judge(readings: List[Dict[str, float]], limits: Mapping[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(correct, {number: {"value", "limit"}}) over every answer's
    readings that hold it, for each number that ``limits`` names; no
    answer, or a number that no answer holds, is not correct."""
    out = {}
    for n, limit in limits.items():
        value = _worst([r[n] for r in readings if n in r])
        out[n] = {"value": value, "limit": float(limit)}
    ok = bool(readings) and all(
        np.isfinite(v["value"]) and v["value"] <= v["limit"]
        for v in out.values())
    return ok, out
