"""Texture-style resampling: subsample, disparity upsample, warp.

Counterpart of ``ug_stereomatcher_tpu/ops/resample.py``.  Coordinates
are texel-centred ((i + 0.5) before any scale or offset) with
clamp-to-edge addressing (MatchLib.cu:311-549).  Nearest is the
reference's point sampling, value = src[floor(y), floor(x)]; nearest
pyramid resamples depend on the destination axis only, so their index
vectors are computed on the host in float64 with numpy, exactly as the
JAX package computes them.
Bilinear is CUDA's linear-filtering convention (weights from coord - 0.5)
with the weights computed in float32 on the device, as the JAX
``tex_gather`` computes them; ``bilinear_taps`` is the host float64 form
of the same taps that the separable resample kernel uses.  Cubic is
cv::INTER_CUBIC's 4 x 4 Keys kernel (a = -0.75) with clamp addressing,
the geometry's range-map resize: the JAX package computes it outside any
Pallas kernel, so it is plain torch here on every device, with the
separable form's taps and weights computed on the host in float64 and
cast once to float32, as there.  The matcher never samples cubic.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ug_stereomatcher_tpu_torch.config import unsupported_interp

CoordFn = Callable[[np.ndarray], np.ndarray]


@dataclasses.dataclass(frozen=True)
class ScaleMap:
    """The coordinate map t -> t * factor (t / factor with ``divide``):
    the pyramid's subsamples and the disparity upsamples.  Equal maps
    compare and hash equal, so the resample kernel's wrapper can keep the
    taps of one call site on the card (ops/cuda/resample.py); a lambda
    of the same arithmetic gives the same taps bit for bit."""
    factor: float
    divide: bool = False

    def __call__(self, t):
        return t / self.factor if self.divide else t * self.factor


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


def bilinear_taps(n_out: int, n_in: int, coord_of: CoordFn,
                  off: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Per-axis bilinear taps (i0 int32, w float32) for destination
    indices j in [0, n_out): f = coord_of(j + off + 0.5) - 0.5 in float64,
    i0 = clip(floor(f)), w = f - floor(f).  Tap i0 gets 1 - w and tap
    min(i0 + 1, n_in - 1) gets w.  Where clamping makes both taps the same
    texel the weight collapses to 0 and i0 points at that texel (the
    collapse rule of the JAX package's ``_bilinear_taps``)."""
    f = coord_of(np.arange(n_out) + off + 0.5) - 0.5
    i0f = np.floor(f)
    w = (f - i0f).astype(np.float32)
    i0 = np.clip(i0f, 0, n_in - 1).astype(np.int32)
    i1 = np.clip(i0f + 1, 0, n_in - 1).astype(np.int32)
    collapse = i1 == i0
    w = np.where(collapse, 0.0, w).astype(np.float32)
    i0 = np.where(collapse & (i0f < 0), 0, i0)
    return np.minimum(i0, n_in - 1).astype(np.int32), w


def tex_gather(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
               method: str = "nearest") -> torch.Tensor:
    """Sample ``img`` (..., H, W) at float texel coordinates (x, y), two
    float32 arrays of one shape."""
    h, w = img.shape[-2], img.shape[-1]
    if method == "nearest":
        ix = torch.clamp(torch.floor(x), 0, w - 1).long()
        iy = torch.clamp(torch.floor(y), 0, h - 1).long()
        return gather_hw(img, iy, ix)
    if method == "cubic":
        return _tex_cubic(img, x, y)
    if method != "bilinear":
        raise unsupported_interp(method)
    # CUDA linear filtering: weights from (coord - 0.5), in float32
    xf = x - 0.5
    yf = y - 0.5
    x0 = torch.floor(xf)
    y0 = torch.floor(yf)
    ax = xf - x0
    ay = yf - y0
    x0i = torch.clamp(x0, 0, w - 1).long()
    x1i = torch.clamp(x0 + 1, 0, w - 1).long()
    y0i = torch.clamp(y0, 0, h - 1).long()
    y1i = torch.clamp(y0 + 1, 0, h - 1).long()
    v00 = gather_hw(img, y0i, x0i)
    v01 = gather_hw(img, y0i, x1i)
    v10 = gather_hw(img, y1i, x0i)
    v11 = gather_hw(img, y1i, x1i)
    top = v00 * (1 - ax) + v01 * ax
    bot = v10 * (1 - ax) + v11 * ax
    return top * (1 - ay) + bot * ay


_CUBIC_A = -0.75  # OpenCV's bicubic sharpness constant (imgproc resize)


def _cubic_weights(t):
    """Keys' weights of the taps at offsets -1, 0, +1, +2 from floor(coord)
    for fractional offsets ``t`` in [0, 1), in the JAX package's term
    order; the last weight is 1 minus the others.  Works on numpy arrays
    and torch tensors alike."""
    a = _CUBIC_A
    w0 = ((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a
    w1 = ((a + 2) * t - (a + 3)) * t * t + 1
    u = 1 - t
    w2 = ((a + 2) * u - (a + 3)) * u * u + 1
    w3 = 1.0 - w0 - w1 - w2
    return w0, w1, w2, w3


def cubic_weights_np(t: np.ndarray) -> np.ndarray:
    """(4, n) float64 Keys weights of fractional offsets ``t``."""
    return np.stack(_cubic_weights(np.asarray(t, dtype=np.float64)), axis=0)


def _tex_cubic(img: torch.Tensor, x: torch.Tensor,
               y: torch.Tensor) -> torch.Tensor:
    """4 x 4 bicubic sample at float32 texel coordinates, weights from
    (coord - 0.5) in float32, rows of taps summed first."""
    h, w = img.shape[-2], img.shape[-1]
    xf = x - 0.5
    yf = y - 0.5
    x0 = torch.floor(xf)
    y0 = torch.floor(yf)
    wxs = _cubic_weights(xf - x0)
    wys = _cubic_weights(yf - y0)
    out = None
    for ky in range(4):
        yi = torch.clamp(y0 + (ky - 1), 0, h - 1).long()
        row = None
        for kx in range(4):
            xi = torch.clamp(x0 + (kx - 1), 0, w - 1).long()
            v = wxs[kx] * gather_hw(img, yi, xi)
            row = v if row is None else row + v
        v = wys[ky] * row
        out = v if out is None else out + v
    return out


def _dest_coords(out_h: int, out_w: int, device, row_off: int = 0,
                 col_off: int = 0):
    """Texel-centre destination coordinates (xs, ys), float32 (1, w) and
    (h, 1): (arange + off) + 0.5, rounded as the JAX package rounds them."""
    f32 = torch.float32
    ys = (torch.arange(out_h, dtype=f32, device=device) + row_off) + 0.5
    xs = (torch.arange(out_w, dtype=f32, device=device) + col_off) + 0.5
    return xs[None, :], ys[:, None]


def resample_static_plain(img: torch.Tensor, iy: torch.Tensor,
                          ix: torch.Tensor, value_scale: float = 1.0,
                          wy: Optional[torch.Tensor] = None,
                          wx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Separable resample from per-axis taps.

    Nearest (``wy``/``wx`` None): out[..., r, x] = value_scale *
    img[..., iy[r], ix[x]] (two takes).  Bilinear: ``iy``/``ix`` are the
    floor taps of ``bilinear_taps`` and ``wy``/``wx`` their float32
    weights; rows interpolate first, then columns, then the value scale:
    a_k = img[iy, k] * (1 - wy) + img[iy + 1, k] * wy at k = ix, ix + 1,
    out = a_ix * (1 - wx) + a_ix+1 * wx, with iy + 1 and ix + 1 clamped to
    the image."""
    if wy is None:
        out = img.index_select(-2, iy.long()).index_select(-1, ix.long())
        return out if value_scale == 1.0 else value_scale * out
    h, w = img.shape[-2], img.shape[-1]
    iy0, ix0 = iy.long(), ix.long()
    iy1 = torch.clamp(iy0 + 1, max=h - 1)
    ix1 = torch.clamp(ix0 + 1, max=w - 1)
    wy = wy[:, None]
    rows = img.index_select(-2, iy0) * (1 - wy) \
        + img.index_select(-2, iy1) * wy
    out = rows.index_select(-1, ix0) * (1 - wx) \
        + rows.index_select(-1, ix1) * wx
    return out if value_scale == 1.0 else value_scale * out


def _separable_nearest(img: torch.Tensor, out_h: int, out_w: int,
                       coord_of: CoordFn, row_off: int = 0,
                       col_off: int = 0) -> torch.Tensor:
    h, w = img.shape[-2], img.shape[-1]
    iy = torch.from_numpy(nearest_indices(out_h, h, coord_of, row_off))
    ix = torch.from_numpy(nearest_indices(out_w, w, coord_of, col_off))
    return resample_static_plain(img, iy.to(img.device), ix.to(img.device))


def _separable_cubic(img: torch.Tensor, out_h: int, out_w: int,
                     coord_of: CoordFn, row_off: int = 0,
                     col_off: int = 0) -> torch.Tensor:
    """Axis-separable bicubic resample: per axis 4 taps, their indices
    clamped to the edge (cv::resize's border replication) and their
    weights computed on the host in float64 and cast once to float32;
    the rows' 4 weighted takes are summed first, then the columns'."""
    h, w = img.shape[-2], img.shape[-1]

    def axis_taps(n_out, n_src, off):
        c = np.asarray(coord_of(np.arange(n_out) + off + 0.5),
                       dtype=np.float64) - 0.5
        i0 = np.floor(c)
        wts = cubic_weights_np(c - i0).astype(np.float32)
        idx = [torch.from_numpy(np.clip(i0 + k, 0, n_src - 1).astype(
            np.int64)).to(img.device) for k in (-1, 0, 1, 2)]
        return idx, torch.from_numpy(wts).to(img.device)

    ry, wy = axis_taps(out_h, h, row_off)
    rx, wx = axis_taps(out_w, w, col_off)
    rows = sum(wy[k][:, None] * img.index_select(-2, ry[k])
               for k in range(4))
    return sum(wx[k][None, :] * rows.index_select(-1, rx[k])
               for k in range(4))


def _tex_resample(img: torch.Tensor, out_h: int, out_w: int,
                  coord_of: Callable[[torch.Tensor], torch.Tensor],
                  method: str, row_off: int = 0,
                  col_off: int = 0) -> torch.Tensor:
    """Non-nearest resample: tex_gather at float32 device coordinates."""
    if method not in ("bilinear", "cubic"):
        raise unsupported_interp(method)
    xs, ys = _dest_coords(out_h, out_w, img.device, row_off, col_off)
    xs, ys = torch.broadcast_tensors(xs, ys)
    return tex_gather(img, coord_of(xs), coord_of(ys), method)


def resample_coords(img: torch.Tensor, out_h: int, out_w: int,
                    coord_of: CoordFn, value_scale: float = 1.0,
                    method: str = "nearest", row_off: int = 0,
                    col_off: int = 0) -> torch.Tensor:
    """Generic separable resample from a destination-axis coordinate
    callback, value scaling after the gather; ``row_off``/``col_off``
    evaluate a window of the full destination grid."""
    if method == "nearest":
        out = _separable_nearest(img, out_h, out_w, coord_of, row_off,
                                 col_off)
    elif method == "cubic":
        out = _separable_cubic(img, out_h, out_w, coord_of, row_off, col_off)
    else:
        out = _tex_resample(img, out_h, out_w, coord_of, method, row_off,
                            col_off)
    return out if value_scale == 1.0 else value_scale * out


def subsample(img: torch.Tensor, out_h: int, out_w: int, scale: float,
              method: str = "nearest") -> torch.Tensor:
    """dst(x, y) = src(x*scale, y*scale) (subsampleKernel, MatchLib.cu:311);
    ``method="cubic"`` is cv::INTER_CUBIC, the resized range maps'
    resize (getPointCloud.cpp:772, :841)."""
    if method == "nearest":
        return _separable_nearest(img, out_h, out_w, lambda t: t * scale)
    if method == "cubic":
        return _separable_cubic(img, out_h, out_w, lambda t: t * scale)
    return _tex_resample(img, out_h, out_w, lambda t: t * scale, method)


def upsample_disp(img: torch.Tensor, out_h: int, out_w: int, scale: float,
                  value_scale: float,
                  method: str = "nearest") -> torch.Tensor:
    """dst(x, y) = value_scale * src(x*scale, y*scale)
    (subsampleDispKernel, MatchLib.cu:372-429)."""
    if method == "nearest":
        out = _separable_nearest(img, out_h, out_w, lambda t: t * scale)
    else:
        out = _tex_resample(img, out_h, out_w, lambda t: t * scale, method)
    return value_scale * out


def part_upsample_disp(img: torch.Tensor, out_h: int, out_w: int,
                       scale: float, method: str = "nearest") -> torch.Tensor:
    """dst(x, y) = scale * src(x / scale, y / scale), the fovea-stack
    upsample of the hierarchical map (partsubsampleDispKernel,
    MatchLib.cu:435-492).  It divides by ``scale``, where upsample_disp
    multiplies by 1 / scale: the two differ in the last bit in float64."""
    if method == "nearest":
        out = _separable_nearest(img, out_h, out_w, lambda t: t / scale)
    else:
        out = _tex_resample(img, out_h, out_w, lambda t: t / scale, method)
    return scale * out


def warp_by_disparity(img: torch.Tensor, disp_x: torch.Tensor,
                      disp_y: torch.Tensor, method: str = "nearest",
                      row0: int = 0) -> torch.Tensor:
    """Backward warp dst(x, y) = src(x + disp_x, y + disp_y)
    (warpAbyB, MatchLib.cu:499-549).  img (..., H, W); disp (Hl, W) are
    the destination rows [row0, row0 + Hl) (the whole image by default),
    and the result holds those rows."""
    h, w = disp_x.shape[-2], disp_x.shape[-1]
    xs, ys = _dest_coords(h, w, img.device, row_off=row0)
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


def band_rows(rows: int, first: int, height: int,
              device) -> Tuple[torch.Tensor, torch.Tensor]:
    """For a band of ``rows`` rows starting at global row ``first`` of a
    ``height``-row image, and reaching into the image: the band index of
    each row clamped into the image (index_select with it re-clamps the
    band's rows outside the image to the image's edge rows), and whether
    each row lies inside the image."""
    g = torch.arange(first, first + rows, device=device)
    return g.clamp(0, height - 1) - first, (g >= 0) & (g < height)
