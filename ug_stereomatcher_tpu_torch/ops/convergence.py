"""Iteration-convergence metric.

Counterpart of ``ug_stereomatcher_tpu/ops/convergence.py``: the
reference's confidence-weighted mean absolute change between successive
disparity estimates (weightedDifference, MatchGPULib.cpp:1336-1437) and
its two-field threshold test (differenceIterations, :1323-1334).  The JAX
package computes these in XLA, not in a Pallas kernel, so they are plain
torch reductions on the tensors' device.  ``torch.sum`` adds in another
order than XLA (and the card in another order than the CPU), so a value
may differ from the JAX package's in its last bits.
"""

from __future__ import annotations

from typing import Tuple

import torch


def weighted_difference(disp_new: torch.Tensor, disp_old: torch.Tensor,
                        conf: torch.Tensor) -> torch.Tensor:
    """sum(|new - old| * conf) / sum(conf), a 0-d tensor on the inputs'
    device; 0 where sum(conf) is 0 (a fully masked frame would give 0/0,
    and NaN < threshold never holds)."""
    num = torch.sum(torch.abs(disp_new - disp_old) * conf)
    den = torch.sum(conf)
    ok = den > 0.0
    return torch.where(ok, num / torch.where(ok, den, 1.0), 0.0)


def has_converged(disp_h_new, disp_h_old, disp_v_new, disp_v_old, conf,
                  threshold: float) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Both-axis convergence test: (converged, diff_h, diff_v), 0-d
    tensors on the inputs' device."""
    dh = weighted_difference(disp_h_new, disp_h_old, conf)
    dv = weighted_difference(disp_v_new, disp_v_old, conf)
    return (dh < threshold) & (dv < threshold), dh, dv
