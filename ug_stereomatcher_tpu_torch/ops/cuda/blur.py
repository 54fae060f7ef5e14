"""Separable 5-tap Gaussian blur: wrapper of ``csrc/blur.cu``.

Replaces ``fused_blur_gaussian`` (ug_stereomatcher_tpu/ops/pallas/blur.py,
``pallas_call`` at :150).  Bound on the card by device memory (one read and
one write per float, 18 flops per pixel).  Each warp of the kernel walks a
strip of 128 columns of one plane down a run of rows: 16-byte loads of a
row, the +-2 columns by warp shuffles, the row pass in registers and the
column pass from a rolling window of five row-pass rows in registers, so
each float crosses device memory once each way (plus the 2-row halo of
each run).  Bit-exact against the plain version: the same taps, boundary
and term order, with no fused multiply-add.
"""

from __future__ import annotations

import torch

from ug_stereomatcher_tpu_torch.config import gaussian_kernel
from ug_stereomatcher_tpu_torch.ops.conv import conv_separable
from ug_stereomatcher_tpu_torch.ops.cuda._build import check_planes, launch, ptr

_BOUNDARIES = ("zero", "clamp")


def fused_blur_gaussian_plain(x: torch.Tensor,
                              boundary: str = "zero") -> torch.Tensor:
    """Plain PyTorch version: ops.conv's separable Gaussian blur."""
    if boundary not in _BOUNDARIES:
        raise ValueError(f"unknown boundary {boundary!r}")
    return conv_separable(x, gaussian_kernel(), boundary=boundary)


def fused_blur_gaussian(x: torch.Tensor, boundary: str = "zero") -> torch.Tensor:
    """5-tap separable Gaussian blur of a (C, H, W) float32 tensor, zero
    or clamp boundary.  A CUDA tensor runs the kernel; a CPU tensor runs
    the plain version."""
    if boundary not in _BOUNDARIES:
        raise ValueError(f"unknown boundary {boundary!r}")
    if x.ndim != 3:
        raise ValueError(f"expected (C, H, W), got {tuple(x.shape)}")
    if check_planes("fused_blur_gaussian", x).type == "cpu":
        return fused_blur_gaussian_plain(x, boundary)
    C, H, W = x.shape
    out = torch.empty_like(x)
    launch("ugsm_sep5", "blur", ptr(x), ptr(out), C, H, W,
           int(boundary == "clamp"), *(float(t) for t in gaussian_kernel()))
    return out
