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
  alone (its output read from the source once and written once).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

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
F32 = 4


def bound(nbytes: float, ops: float) -> Tuple[float, str]:
    """The least seconds the card needs to move ``nbytes`` and do ``ops``
    float32 operations, and which of the two sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / FP32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def level_work(px: int, iters: int, passes: int, interp: str
               ) -> Tuple[float, float]:
    """(bytes, operations) of one level of ``px`` pixels."""
    per_iter = (WARP_OPS[interp] + DIRECTION_OPS + passes * SMOOTH_PASS_OPS
                + AVERAGE_OPS)
    return 12 * F32 * px, px * (BLURRED_L2_OPS + iters * per_iter)


def match_least_s(fields: Mapping[str, object], frame: Tuple[int, int],
                  foveated: bool) -> Dict[str, object]:
    """The least seconds of one match of a ``frame`` pair, with the terms
    it sums (``levels``, ``pyramid``, ``upsample``)."""
    s = Schedule(fields)
    h, w = frame
    n = s.num_levels(h, w)
    full = s.dims_chain(h, w)[:n]
    dims: List[Tuple[int, int]] = list(full)
    k = int(s.p["fovea_level"])
    if foveated:
        dims = [full[k - 1]] * (k - 1) + full[k - 1:]
    levels = [bound(*level_work(a * b, s.iters(i), s.passes(i), s.interp))[0]
              for i, (a, b) in enumerate(dims)]
    # the pyramid: blurs of levels 0 .. n - 3 (6 planes), and one
    # resample into each level 1 .. n - 1
    pyramid = 0.0
    for i, (a, b) in enumerate(full):
        if i <= max(0, n - 3) and n > 1:
            pyramid += bound(2 * 6 * F32 * a * b, 6 * 2 * PASS5_OPS * a * b)[0]
        if i >= 1:
            pyramid += bound(2 * 6 * F32 * a * b, 0)[0]
    # each upsample of the state to the next finer level (3 planes)
    upsample = sum(bound(2 * 3 * F32 * a * b, 3 * a * b)[0]
                   for (a, b) in dims[:-1])
    return {"least_s": sum(levels) + pyramid + upsample, "levels": levels,
            "pyramid_s": pyramid, "upsample_s": upsample}
