"""Texture-style nearest resampling: subsample, disparity upsample, warp.

Counterpart of ``ug_stereomatcher_tpu/ops/resample.py`` for
``interp="nearest"``, the reference's point sampling: texel-centred
coordinates ((i + 0.5) before any scale or offset), value =
src[floor(y), floor(x)], clamp-to-edge addressing (MatchLib.cu:311-549).
Pyramid resamples depend on the destination axis only, so their index
vectors are computed on the host in float64 with numpy, exactly as the
JAX package computes them.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ug_stereomatcher_tpu_torch.config import unsupported_interp

CoordFn = Callable[[np.ndarray], np.ndarray]


def nearest_indices(n_out: int, n_in: int, coord_of: CoordFn,
                    off: int = 0) -> np.ndarray:
    """int32 source indices clip(floor(coord_of(j + off + 0.5)), 0, n_in-1)
    for destination indices j in [0, n_out), in float64."""
    return np.clip(np.floor(coord_of(np.arange(n_out) + off + 0.5)), 0,
                   n_in - 1).astype(np.int32)


def gather_hw(img: torch.Tensor, iy: torch.Tensor,
              ix: torch.Tensor) -> torch.Tensor:
    """img[..., iy, ix] for in-range integer maps iy, ix of equal shape."""
    h, w = img.shape[-2], img.shape[-1]
    flat = img.reshape(img.shape[:-2] + (h * w,))
    idx = (iy.long() * w + ix.long()).reshape(-1)
    return flat.index_select(-1, idx).reshape(img.shape[:-2] + iy.shape)


def tex_gather(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
               method: str = "nearest") -> torch.Tensor:
    """Sample ``img`` (..., H, W) at float texel coordinates (x, y)."""
    if method != "nearest":
        raise unsupported_interp(method)
    h, w = img.shape[-2], img.shape[-1]
    ix = torch.clamp(torch.floor(x), 0, w - 1).long()
    iy = torch.clamp(torch.floor(y), 0, h - 1).long()
    return gather_hw(img, iy, ix)


def _dest_coords(out_h: int, out_w: int, device, row_off: int = 0,
                 col_off: int = 0):
    """Texel-centre destination coordinates (xs, ys), float32 (1, w) and
    (h, 1): (arange + off) + 0.5, rounded as the JAX package rounds them."""
    f32 = torch.float32
    ys = (torch.arange(out_h, dtype=f32, device=device) + row_off) + 0.5
    xs = (torch.arange(out_w, dtype=f32, device=device) + col_off) + 0.5
    return xs[None, :], ys[:, None]


def resample_static_plain(img: torch.Tensor, iy: torch.Tensor,
                          ix: torch.Tensor,
                          value_scale: float = 1.0) -> torch.Tensor:
    """out[..., r, x] = value_scale * img[..., iy[r], ix[x]] (two takes)."""
    out = img.index_select(-2, iy.long()).index_select(-1, ix.long())
    return out if value_scale == 1.0 else value_scale * out


def _separable_nearest(img: torch.Tensor, out_h: int, out_w: int,
                       coord_of: CoordFn, row_off: int = 0,
                       col_off: int = 0) -> torch.Tensor:
    h, w = img.shape[-2], img.shape[-1]
    iy = torch.from_numpy(nearest_indices(out_h, h, coord_of, row_off))
    ix = torch.from_numpy(nearest_indices(out_w, w, coord_of, col_off))
    return resample_static_plain(img, iy.to(img.device), ix.to(img.device))


def resample_coords(img: torch.Tensor, out_h: int, out_w: int,
                    coord_of: CoordFn, value_scale: float = 1.0,
                    method: str = "nearest", row_off: int = 0,
                    col_off: int = 0) -> torch.Tensor:
    """Generic separable resample from a destination-axis coordinate
    callback, value scaling after the gather; ``row_off``/``col_off``
    evaluate a window of the full destination grid."""
    if method != "nearest":
        raise unsupported_interp(method)
    out = _separable_nearest(img, out_h, out_w, coord_of, row_off, col_off)
    return out if value_scale == 1.0 else value_scale * out


def subsample(img: torch.Tensor, out_h: int, out_w: int, scale: float,
              method: str = "nearest") -> torch.Tensor:
    """dst(x, y) = src(x*scale, y*scale) (subsampleKernel, MatchLib.cu:311)."""
    if method != "nearest":
        raise unsupported_interp(method)
    return _separable_nearest(img, out_h, out_w, lambda t: t * scale)


def upsample_disp(img: torch.Tensor, out_h: int, out_w: int, scale: float,
                  value_scale: float,
                  method: str = "nearest") -> torch.Tensor:
    """dst(x, y) = value_scale * src(x*scale, y*scale)
    (subsampleDispKernel, MatchLib.cu:372-429)."""
    if method != "nearest":
        raise unsupported_interp(method)
    out = _separable_nearest(img, out_h, out_w, lambda t: t * scale)
    return value_scale * out


def warp_by_disparity(img: torch.Tensor, disp_x: torch.Tensor,
                      disp_y: torch.Tensor,
                      method: str = "nearest") -> torch.Tensor:
    """Backward warp dst(x, y) = src(x + disp_x, y + disp_y)
    (warpAbyB, MatchLib.cu:499-549).  img (..., H, W), disp (H, W)."""
    h, w = img.shape[-2], img.shape[-1]
    xs, ys = _dest_coords(h, w, img.device)
    return tex_gather(img, xs + disp_x, ys + disp_y, method)


def shift_image(img: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """Integer shift with clamp addressing: dst(x, y) = src(x+dx, y+dy)."""
    if dx == 0 and dy == 0:
        return img
    h, w = img.shape[-2], img.shape[-1]
    dev = img.device
    out = img
    if dy:
        rows = (torch.arange(h, device=dev) + dy).clamp(0, h - 1)
        out = out.index_select(-2, rows)
    if dx:
        cols = (torch.arange(w, device=dev) + dx).clamp(0, w - 1)
        out = out.index_select(-1, cols)
    return out
