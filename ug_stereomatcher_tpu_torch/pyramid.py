"""Pyramid construction, foveation and disparity resampling.

Counterpart of ``ug_stereomatcher_tpu/pyramid.py``: build_pyramid
(CreatePyramidFromImage, MatchGPULib.cpp:1033-1125), foveate_pyramid
(CreateFoveatedPyramid, :1128-1190), upsample_to_level (subsampleDisp,
:1526-1590), foveated_upsample (foveatedsubsampleDisp, :1595-1655) and
hierarchical_disparity (:2589-2701).  Dimension chains truncate by the exact
SCALE literal; the pyramid is an even/odd factor-2 chain: level 1 comes
from blurred level 0 at scale SCALE, every level i+2 from blurred level i
at scale 2.0 (:1082-1096).  Blurs and resamples run through the kernel
wrappers of ops/cuda, which take the plain versions for CPU tensors.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ug_stereomatcher_tpu_torch.config import MatcherConfig
from ug_stereomatcher_tpu_torch.ops.cuda.blur import fused_blur_gaussian
from ug_stereomatcher_tpu_torch.ops.cuda.resample import resample_tex
from ug_stereomatcher_tpu_torch.ops.resample import ScaleMap


def build_pyramid_pair(left: torch.Tensor, right: torch.Tensor,
                       cfg: MatcherConfig, num_levels: Optional[int] = None
                       ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Both images' pyramids in one stacked (2C, H, W) pass, bit-identical
    per channel to two build_pyramid calls."""
    c = left.shape[-3]
    levels = build_pyramid(torch.cat([left, right], dim=-3), cfg, num_levels)
    return [lv[:c] for lv in levels], [lv[c:] for lv in levels]


def build_pyramid(image: torch.Tensor, cfg: MatcherConfig,
                  num_levels: Optional[int] = None) -> List[torch.Tensor]:
    """Image pyramid of a (C, H, W) float32 image, index 0 = finest (the
    input itself).  Each level is zero-boundary blurred before it is
    resampled; the returned levels are the unblurred resample results.

    Only the blurs that feed a resample run (those of levels 0 .. n-3):
    the two coarsest levels' blurs have no consumer, and XLA drops them
    from the JAX package's jitted program too."""
    h, w = image.shape[-2], image.shape[-1]
    dims = cfg.dims_chain(h, w)
    n = num_levels if num_levels is not None else cfg.num_levels(h, w)
    levels: List[torch.Tensor] = [image] + [None] * (n - 1)  # type: ignore[list-item]
    scale2 = float(int(cfg.scale * cfg.scale + 0.5))  # == 2.0 (:1090)
    for i in range(n):
        first = i == 0 and n > 1
        if not first and i + 2 >= n:
            continue
        blurred = fused_blur_gaussian(levels[i], boundary="zero")
        if first:
            h2, w2 = dims[1]
            levels[1] = resample_tex(blurred, h2, w2,
                                     ScaleMap(cfg.scale), 1.0, cfg.interp)
        if i + 2 < n:
            h2, w2 = dims[i + 2]
            levels[i + 2] = resample_tex(blurred, h2, w2,
                                         ScaleMap(scale2), 1.0, cfg.interp)
    return levels


def foveate_pyramid(levels: Sequence[torch.Tensor], cfg: MatcherConfig,
                    full_dims: Tuple[int, int]) -> List[torch.Tensor]:
    """Foveated pyramid: levels >= fovea_level - 1 are the full levels;
    each finer level is its centred window of the fovea size (the dims of
    level fovea_level - 1).  The windows are contiguous copies, as the
    kernels take them."""
    dims = cfg.dims_chain(*full_dims)
    fov_h, fov_w = dims[cfg.fovea_level - 1]
    out: List[torch.Tensor] = []
    for level, img in enumerate(levels):
        if level >= cfg.fovea_level - 1:
            out.append(img)
            continue
        h, w = dims[level]
        upper, left = h // 2 - fov_h // 2, w // 2 - fov_w // 2
        out.append(img[..., upper:upper + fov_h,
                       left:left + fov_w].contiguous())
    return out


def upsample_to_level(disp: torch.Tensor, out_h: int, out_w: int,
                      cfg: MatcherConfig) -> torch.Tensor:
    """Upsample a (3, h, w) disparity triplet to (3, out_h, out_w) for the
    next finer level, values scaled by SCALE (MatchGPULib.cpp:1279).  The
    reference scales the confidence plane too (cfg.scale_conf_on_upsample)."""
    inv = 1.0 / cfg.scale
    up = resample_tex(disp, out_h, out_w, ScaleMap(inv), cfg.scale,
                      cfg.interp)
    if not cfg.scale_conf_on_upsample:
        conf = resample_tex(disp[2:3], out_h, out_w, ScaleMap(inv), 1.0,
                            cfg.interp)
        up = torch.cat([up[:2], conf], dim=0)
    return up


def foveated_upsample(disp: torch.Tensor, big_h: int, big_w: int,
                      cfg: MatcherConfig) -> torch.Tensor:
    """Fovea-to-fovea level transition: the centred fovea-sized window of
    upsample_to_level(disp, big_h, big_w), computed as one windowed
    resample (the crop commutes with the per-pixel gather), so only the
    window's pixels are evaluated."""
    fov_h, fov_w = disp.shape[-2], disp.shape[-1]
    win = dict(row_off=big_h // 2 - fov_h // 2,
               col_off=big_w // 2 - fov_w // 2)
    inv = 1.0 / cfg.scale
    up = resample_tex(disp, fov_h, fov_w, ScaleMap(inv), cfg.scale,
                      cfg.interp, **win)
    if not cfg.scale_conf_on_upsample:
        conf = resample_tex(disp[2:3], fov_h, fov_w, ScaleMap(inv), 1.0,
                            cfg.interp, **win)
        up = torch.cat([up[:2], conf], dim=0)
    return up


def hierarchical_disparity(stack: Sequence[torch.Tensor], cfg: MatcherConfig,
                           full_dims: Tuple[int, int]) -> torch.Tensor:
    """A full-resolution (3, H, W) map from a fovea stack (index 0 =
    finest): from the coarsest fovea level (fovea_level - 1, whose window
    is its whole level), upsample by SCALE to the next finer level's full
    grid (values x SCALE, confidence included: a reference quirk) and
    paste the next finer stack level into its centred window.  The
    coordinates map by t / SCALE, as the reference's
    partsubsampleDispKernel does (ops.resample.part_upsample_disp)."""
    dims = cfg.dims_chain(*full_dims)
    fov_h, fov_w = dims[cfg.fovea_level - 1]
    current = stack[cfg.fovea_level - 1]
    for level in range(cfg.fovea_level - 1, 0, -1):
        big_h, big_w = dims[level - 1]
        up = resample_tex(current, big_h, big_w,
                          ScaleMap(cfg.scale, divide=True),
                          cfg.scale, cfg.interp)
        upper, left = big_h // 2 - fov_h // 2, big_w // 2 - fov_w // 2
        up[..., upper:upper + fov_h, left:left + fov_w] = stack[level - 1]
        current = up
    return current
