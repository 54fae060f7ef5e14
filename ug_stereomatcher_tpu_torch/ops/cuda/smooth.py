"""Confidence-weighted smoothing chain: wrapper of ``csrc/smooth.cu``.

Replaces ``fused_smooth_average`` (ug_stereomatcher_tpu/ops/pallas/
smooth.py, ``pallas_call`` at :205).  Bound on the card by device memory:
each pass reads and writes the 3 state planes.  The kernel runs one
launch per pass with ping-pong scratch planes (each pass weighted by the
confidence from before it; row 0 and column 0 kept; clamp addressing),
then the shared-memory separable 3-tap average of blur.cu.  The term
order is that of ops.smooth (centre, left, right, up, down; num / den)
with no fused multiply-add, so it is bit-exact against the plain version.
"""

from __future__ import annotations

import torch

from ug_stereomatcher_tpu_torch.config import average_kernel
from ug_stereomatcher_tpu_torch.ops.conv import blur_average_clamp
from ug_stereomatcher_tpu_torch.ops.cuda._build import check_planes, launch, ptr
from ug_stereomatcher_tpu_torch.ops.smooth import weighted_smooth


def fused_smooth_average_plain(state: torch.Tensor,
                               n_passes: int) -> torch.Tensor:
    """Plain PyTorch version: n weighted_smooth passes + the average."""
    for _ in range(n_passes):
        state = weighted_smooth(state, state[2])
    return blur_average_clamp(state)


def fused_smooth_average(state: torch.Tensor, n_passes: int) -> torch.Tensor:
    """``n_passes`` smoothing passes and the 3-tap average over a (3, H, W)
    float32 [disp_h, disp_v, conf] state.  A CUDA tensor runs the kernel;
    a CPU tensor runs the plain version."""
    if state.ndim != 3 or state.shape[0] != 3:
        raise ValueError(f"expected (3, H, W) state, got {tuple(state.shape)}")
    if n_passes < 0:
        raise ValueError(f"n_passes must be >= 0, got {n_passes}")
    if check_planes("fused_smooth_average", state).type == "cpu":
        return fused_smooth_average_plain(state, n_passes)
    _, H, W = state.shape
    out = torch.empty_like(state)
    scratch = torch.empty((2,) + tuple(state.shape), dtype=state.dtype,
                          device=state.device)
    tap = float(average_kernel()[1])
    launch("ugsm_smooth_average", "smooth", ptr(state), ptr(out),
           ptr(scratch[0]), ptr(scratch[1]), H, W, int(n_passes), tap)
    return out
