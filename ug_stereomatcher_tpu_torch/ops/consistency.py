"""Left-right consistency check.

Counterpart of ``ug_stereomatcher_tpu/ops/consistency.py``.  Not in the
reference: match both directions and flag the pixels whose forward and
backward disparities disagree,

    consistent(x)  <=>  ||d_lr(x) + d_rl(x + d_lr(x))|| <= tau.

The backward field is sampled at the forward match position by the
port's warp kernel (ops/cuda/warp.py): both backward planes as one
(2, H, W) stack, with the matcher's nearest or bilinear texture sampling,
as the JAX ``warp_by_disparity`` samples them.  On a CPU tensor the warp
is its plain version.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ug_stereomatcher_tpu_torch.ops.cuda.warp import warp


def lr_consistency_mask(disp_lr_h: torch.Tensor, disp_lr_v: torch.Tensor,
                        disp_rl_h: torch.Tensor, disp_rl_v: torch.Tensor,
                        tau: float = 1.0, method: str = "nearest"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mask, error) for two-axis fields, each (H, W) on one device.

    disp_lr_*: left -> right fields on the left grid; disp_rl_*: right ->
    left fields on the right grid.  error = ||d_lr(x) + d_rl(x +
    d_lr(x))||_2 and mask = error <= tau (bool)."""
    back = warp(torch.stack([disp_rl_h, disp_rl_v]),
                disp_lr_h.contiguous(), disp_lr_v.contiguous(), method)
    eh = disp_lr_h + back[0]
    ev = disp_lr_v + back[1]
    err = torch.sqrt(eh * eh + ev * ev)
    return err <= tau, err


def apply_consistency(disparity: torch.Tensor, mask: torch.Tensor,
                      fill_value: float = math.nan) -> torch.Tensor:
    """``disparity`` with the inconsistent pixels set to ``fill_value``."""
    return torch.where(mask, disparity, fill_value)
