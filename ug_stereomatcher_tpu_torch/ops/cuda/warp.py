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
are neighbours and come from cache).  Each thread of a 32 x 8 block warps
K pixels of a row, 32 columns apart, with every gather issued before any
store; offsets are 32-bit, so an image of 2^31 floats or more raises.
Coordinates and bilinear weights are rounded in float32 exactly as the
JAX gather rounds them (never the texture unit's 9-bit filter), so both
forms are bit-exact against their plain versions.

The row-sharded form (``row0`` given; ``row_halo=True`` of both TPU
kernels, warp.py:356-385 and :631-664) warps one shard's rows of the
level from the whole right image, which the caller gathers once per
level (the route of the JAX ``_sharded_warp``, spatial.py:173-193): the
same gather with a row offset, exact for every field, so it needs none of
the TPU form's halo windows, tiers or overflow guard.

Early exit's guarded form (``stop`` given, match.match_level on the
card): every block returns before its first load or store while the
level's flag is set (ops/cuda/convergence.py), so ``out`` keeps what it
held.
"""

from __future__ import annotations

from typing import Optional

import torch

from ug_stereomatcher_tpu_torch.config import INTERP_METHODS, unsupported_interp
from ug_stereomatcher_tpu_torch.ops.cuda._build import (
    check_out,
    check_planes,
    guarded_plain,
    launch,
    ptr,
    stop_ptr,
)
from ug_stereomatcher_tpu_torch.ops.resample import warp_by_disparity

COUNTERS = {"nearest": "warp", "bilinear": "warp_bilinear"}
ROW_HALO_COUNTERS = {"nearest": "warp_row_halo",
                     "bilinear": "warp_bilinear_row_halo"}
MAX_KERNEL_ELEMENTS = 2 ** 31  # the kernel's offsets are 32-bit


def warp_plain(img: torch.Tensor, disp_x: torch.Tensor, disp_y: torch.Tensor,
               method: str = "nearest", row0: Optional[int] = None, *,
               stop: Optional[torch.Tensor] = None,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: ops.resample.warp_by_disparity, with the
    guard of ``_build.guarded_plain``."""
    return guarded_plain(
        stop, out, (img.shape[0],) + tuple(disp_x.shape), img,
        lambda: warp_by_disparity(img, disp_x, disp_y, method, row0 or 0))


def warp_nearest_plain(img: torch.Tensor, disp_x: torch.Tensor,
                       disp_y: torch.Tensor) -> torch.Tensor:
    """``warp_plain(img, disp_x, disp_y, "nearest")``."""
    return warp_plain(img, disp_x, disp_y, "nearest")


def warp(img: torch.Tensor, disp_x: torch.Tensor, disp_y: torch.Tensor,
         method: str = "nearest", row0: Optional[int] = None, *,
         stop: Optional[torch.Tensor] = None,
         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dst[c, y, x] = img[c] sampled at (x + 0.5 + disp_x, y + 0.5 +
    disp_y) in texel coordinates with clamp addressing: point sampling
    (``"nearest"``) or four float32-weighted taps (``"bilinear"``).  img
    (C, H, W) float32, disp_x and disp_y (H, W) float32.

    Row-sharded form: with ``row0`` given, disp_x and disp_y are (Hl, W),
    the rows [row0, row0 + Hl) of the (H, W) grid, img is still the whole
    (C, H, W) image, and the result is those (C, Hl, W) rows of the warp.

    ``out``: the (C, Hl, W) result's buffer (default a new one).
    ``stop``: early exit's flag (one int32; the kernel does nothing while
    it is set).  A CUDA tensor runs the kernel; a CPU tensor runs the
    plain version."""
    if method not in INTERP_METHODS:
        raise unsupported_interp(method)
    if img.ndim != 3:
        raise ValueError(f"expected (C, H, W), got {tuple(img.shape)}")
    C, H, W = img.shape
    Hl = disp_x.shape[0] if disp_x.ndim == 2 else -1
    start = 0 if row0 is None else row0
    if (disp_x.shape != (Hl, W) or disp_y.shape != (Hl, W)
            or (row0 is None and Hl != H)
            or not 0 <= start <= H - max(Hl, 1)):
        raise ValueError(f"disparity planes must be (rows, {W}) inside the "
                         f"{H}-row image from row {start}, got "
                         f"{tuple(disp_x.shape)} and {tuple(disp_y.shape)}")
    dev = check_planes("warp", img, disp_x, disp_y)
    if dev.type == "cpu":
        return warp_plain(img, disp_x, disp_y, method, row0, stop=stop,
                          out=out)
    if img.numel() >= MAX_KERNEL_ELEMENTS:
        raise ValueError(f"warp: the kernel takes images of fewer than "
                         f"2^31 floats, got {tuple(img.shape)}")
    out = check_out("warp", out, (C, Hl, W), img)
    counters = COUNTERS if row0 is None else ROW_HALO_COUNTERS
    launch("ugsm_warp", counters[method], ptr(img), ptr(disp_x), ptr(disp_y),
           ptr(out), C, H, W, Hl, start, int(method == "bilinear"),
           stop_ptr("warp", stop, dev))
    return out


def warp_nearest(img: torch.Tensor, disp_x: torch.Tensor,
                 disp_y: torch.Tensor) -> torch.Tensor:
    """``warp(img, disp_x, disp_y, "nearest")``."""
    return warp(img, disp_x, disp_y, "nearest")
