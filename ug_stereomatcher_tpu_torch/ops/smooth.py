"""Confidence-weighted plus-shaped smoothing (smoothKernel,
MatchLib.cu:1092-1170).

Counterpart of ``ug_stereomatcher_tpu/ops/smooth.py``:

    out(x,y) = sum_n disp(n) * conf(n) / sum_n conf(n)

over the plus stencil (centre, left, right, up, down) with clamp
addressing.  Row 0 and column 0 keep their input values.
"""

from __future__ import annotations

import torch

from ug_stereomatcher_tpu_torch.ops.resample import shift_image


def weighted_smooth(disp: torch.Tensor, conf: torch.Tensor,
                    row0: int = 0) -> torch.Tensor:
    """One smoothing pass over the last two axes of ``disp`` (..., H, W),
    weighted by ``conf`` (H, W).  ``row0`` is the global row of the first
    row (a band of a taller image keeps only the image's row 0)."""
    num = disp * conf
    den = conf
    for (dx, dy) in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        cs = shift_image(conf, dx, dy)
        num = num + shift_image(disp, dx, dy) * cs
        den = den + cs
    out = num / den
    h, w = disp.shape[-2], disp.shape[-1]
    row = torch.arange(row0, row0 + h, device=disp.device)[:, None]
    col = torch.arange(w, device=disp.device)[None, :]
    keep = (row == 0) | (col == 0)
    return torch.where(keep, disp, out)
