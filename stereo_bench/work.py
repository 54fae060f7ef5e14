"""The least time one match can take on the card: the yardstick of
``kernels.roofline_pct``.

The peaks and the per-pixel operation counts are frozen copies of
chip_smoke.py:185-248 (``HBM_BYTES_PER_S``, ``FP32_OPS_PER_S``,
``PASS5_OPS``, ``DIRECTION_OPS``, ``SMOOTH_PASS_OPS``, ``AVERAGE_OPS``,
``WARP_OPS`` and ``bound()``), counted from the plain versions'
arithmetic.  They are reckoned here per pyramid level, not per kernel
launch, so the count reads the same work whoever implements it and no
fusion of kernels can push a share past 100 %:

* a level of the schedule (``dims_chain``, ``iters``, ``passes``) takes
  the larger of its operations (G(L^2) once, then per iteration the warp,
  the direction update, the smoothing passes and the average) over the
  float32 peak, and its own inputs read once and outputs written once
  (left, right and the state in, the state out: 12 planes) over the
  memory bandwidth;
* each pyramid blur (6 planes, two 5-tap passes) and each resample or
  upsample between levels by the same rule, a resample by its bytes
  alone: its output read from the source once and written once, or with
  bilinear filtering the whole source read once and the output written
  once (the bound of PERF.md's kernel table for the bilinear forms).

With early exit, a level that may exit counts the iterations that the
plain reference ran there (``iterations``: for the sampled pairs, their
mean), never the fixed schedule's and never the program's own count, so
no implementation moves the yardstick and skipped work cannot push a
share past 100 %; each of those iterations also counts the convergence
test, its operations and its reads of the two states (5 planes).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

from stereo_bench.reference.matcher import Schedule

# NVIDIA's data sheet, H100 SXM at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

PASS5_OPS = 9
DIRECTION_OPS = 3 * (1 + 2 * PASS5_OPS + 5 * (1 + 2 * PASS5_OPS + 4)) + 34
SMOOTH_PASS_OPS = 4 + 3 * 10
AVERAGE_OPS = 3 * 2 * 5
WARP_OPS = {"nearest": 6, "bilinear": 10 + 3 * 12}
# G(L^2) once a level: a square and two 5-tap passes on each of 3 planes
BLURRED_L2_OPS = 3 * (1 + 2 * PASS5_OPS)
# early exit's test a pixel: per axis a difference, its absolute value,
# the product with the confidence and its sum; and the confidence's sum
CONVERGENCE_OPS = 2 * 4 + 1
CONVERGENCE_PLANES = 5
F32 = 4


def bound(nbytes: float, ops: float) -> Tuple[float, str]:
    """The least seconds the card needs to move ``nbytes`` and do ``ops``
    float32 operations, and which of the two sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / FP32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def level_work(px: int, iters: float, passes: int, interp: str,
               exit_test: bool = False) -> Tuple[float, float]:
    """(bytes, operations) of one level of ``px`` pixels; ``exit_test``:
    each iteration also runs early exit's convergence test."""
    per_iter = (WARP_OPS[interp] + DIRECTION_OPS + passes * SMOOTH_PASS_OPS
                + AVERAGE_OPS)
    nbytes = 12 * F32 * px
    if exit_test:
        per_iter += CONVERGENCE_OPS
        nbytes += iters * CONVERGENCE_PLANES * F32 * px
    return nbytes, px * (BLURRED_L2_OPS + iters * per_iter)


def resample_bytes(src_px: int, out_px: int, planes: int, interp: str
                   ) -> float:
    """A subsample's bytes: the output's samples read and the output
    written; bilinear reads the whole source once."""
    read = src_px if interp == "bilinear" else out_px
    return planes * F32 * (read + out_px)


def match_least_s(fields: Mapping[str, object], frame: Tuple[int, int],
                  foveated: bool,
                  iterations: Optional[Mapping[int, float]] = None
                  ) -> Dict[str, object]:
    """The least seconds of one match of a ``frame`` pair, with the terms
    it sums (``levels``, ``pyramid``, ``upsample``).  With early exit,
    ``iterations`` maps each level that may exit to the iterations the
    reference ran there (their mean over the sampled pairs); the other
    levels take their fixed schedule."""
    s = Schedule(fields)
    if s.exit_threshold is None:
        iterations = {}
    elif iterations is None:
        raise ValueError("an early-exit schedule counts the reference's "
                         "iterations")
    h, w = frame
    n = s.num_levels(h, w)
    full = s.dims_chain(h, w)[:n]
    dims: List[Tuple[int, int]] = list(full)
    k = int(s.p["fovea_level"])
    if foveated:
        dims = [full[k - 1]] * (k - 1) + full[k - 1:]
    levels = [bound(*level_work(a * b, iterations.get(i, s.iters(i)),
                                s.passes(i), s.interp,
                                i in iterations))[0]
              for i, (a, b) in enumerate(dims)]
    # the pyramid: blurs of levels 0 .. n - 3 (6 planes), and one
    # resample into each level 1 .. n - 1
    pyramid = 0.0
    for i, (a, b) in enumerate(full):
        if i <= max(0, n - 3) and n > 1:
            pyramid += bound(2 * 6 * F32 * a * b, 6 * 2 * PASS5_OPS * a * b)[0]
        if i >= 1:
            sa, sb = full[0 if i == 1 else i - 2]
            pyramid += bound(resample_bytes(sa * sb, a * b, 6, s.interp),
                             0)[0]
    # each upsample of the state to the next finer level (3 planes)
    upsample = sum(bound(2 * 3 * F32 * a * b, 3 * a * b)[0]
                   for (a, b) in dims[:-1])
    return {"least_s": sum(levels) + pyramid + upsample, "levels": levels,
            "pyramid_s": pyramid, "upsample_s": upsample}
