"""Backward warp, nearest and bilinear: wrapper of ``csrc/warp.cu``.

Replaces ``warp_windowed_dyn`` (ug_stereomatcher_tpu/ops/pallas/warp.py,
``pallas_call`` at :678) and ``warp_windowed`` (``pallas_call`` at :394)
with both their sweeps (``sweep_nearest`` :87, ``sweep_bilinear`` :191),
and the planner ``plan_dyn_warp`` and the tier logic of
``match.warp_for_level``.  Those exist because Mosaic cannot gather in
2-D; a GPU thread can read any address, so one direct gather per output
pixel is exact for every disparity field and needs no window, planner or
fallback.  Bound on the card by device memory (two field planes and three
gathered reads per pixel, three writes; the bilinear form's four taps
are neighbours and come from cache).  Coordinates and bilinear weights
are rounded in float32 exactly as the JAX gather rounds them (never the
texture unit's 9-bit filter), so both forms are bit-exact against their
plain versions.
"""

from __future__ import annotations

import torch

from ug_stereomatcher_tpu_torch.config import INTERP_METHODS, unsupported_interp
from ug_stereomatcher_tpu_torch.ops.cuda._build import check_planes, launch, ptr
from ug_stereomatcher_tpu_torch.ops.resample import warp_by_disparity

COUNTERS = {"nearest": "warp", "bilinear": "warp_bilinear"}


def warp_plain(img: torch.Tensor, disp_x: torch.Tensor, disp_y: torch.Tensor,
               method: str = "nearest") -> torch.Tensor:
    """Plain PyTorch version: ops.resample.warp_by_disparity."""
    return warp_by_disparity(img, disp_x, disp_y, method)


def warp_nearest_plain(img: torch.Tensor, disp_x: torch.Tensor,
                       disp_y: torch.Tensor) -> torch.Tensor:
    """``warp_plain(img, disp_x, disp_y, "nearest")``."""
    return warp_plain(img, disp_x, disp_y, "nearest")


def warp(img: torch.Tensor, disp_x: torch.Tensor, disp_y: torch.Tensor,
         method: str = "nearest") -> torch.Tensor:
    """dst[c, y, x] = img[c] sampled at (x + 0.5 + disp_x, y + 0.5 +
    disp_y) in texel coordinates with clamp addressing: point sampling
    (``"nearest"``) or four float32-weighted taps (``"bilinear"``).  img
    (C, H, W) float32, disp_x and disp_y (H, W) float32.  A CUDA tensor
    runs the kernel; a CPU tensor runs the plain version."""
    if method not in INTERP_METHODS:
        raise unsupported_interp(method)
    if img.ndim != 3:
        raise ValueError(f"expected (C, H, W), got {tuple(img.shape)}")
    C, H, W = img.shape
    if disp_x.shape != (H, W) or disp_y.shape != (H, W):
        raise ValueError(f"disparity planes must be {(H, W)}, got "
                         f"{tuple(disp_x.shape)} and {tuple(disp_y.shape)}")
    if check_planes("warp", img, disp_x, disp_y).type == "cpu":
        return warp_plain(img, disp_x, disp_y, method)
    out = torch.empty_like(img)
    launch("ugsm_warp", COUNTERS[method], ptr(img), ptr(disp_x), ptr(disp_y),
           ptr(out), C, H, W, int(method == "bilinear"))
    return out


def warp_nearest(img: torch.Tensor, disp_x: torch.Tensor,
                 disp_y: torch.Tensor) -> torch.Tensor:
    """``warp(img, disp_x, disp_y, "nearest")``."""
    return warp(img, disp_x, disp_y, "nearest")
