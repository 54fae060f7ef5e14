"""Separable resample, nearest and bilinear: wrapper of
``csrc/resample.cu``.

Replaces ``resample_static`` (ug_stereomatcher_tpu/ops/pallas/resample.py,
``pallas_call`` at :223), reached through ``resample_tex`` (:286), for
``method="nearest"`` and ``"bilinear"`` (the ``wy``/``wx`` form with
``_bilinear_taps`` :261).  Bound on the card by device memory: a gather.
The TPU kernel selects rows and columns with one-hot (two-hot for
bilinear) matmuls because its vector unit cannot gather; the kernels here
read their source floats directly with coalesced writes: the nearest
kernel gives each thread 4 columns (32 apart) of a 4-row strip across
every plane, its indices held in registers; the bilinear kernel one
output per thread, a block per run of 256 columns of a row.  Bit-exact
against the plain version.

The taps are computed on the host in float64 with numpy, as the JAX
package's ``resample_tex`` computes them: nearest indices, or bilinear
floor taps with float32 weights (``ops.resample.bilinear_taps``).  The
bilinear form uses these host taps on every level.  The JAX package sends
small levels to its float32 ``tex_gather`` instead (pyramid.py:39-54), a
size gate that exists only to skip the TPU kernel's tiling on small
images; the port has no such gate, so its bilinear pyramid differs from
the JAX package's on those levels by the float32 rounding of the
coordinates (about 1e-5 relative; tests/test_torch_kernels.py).
"""

from __future__ import annotations

import torch

from typing import Optional

from ug_stereomatcher_tpu_torch.config import INTERP_METHODS, unsupported_interp
from ug_stereomatcher_tpu_torch.ops.cuda._build import check_planes, launch, ptr
from ug_stereomatcher_tpu_torch.ops.resample import (
    CoordFn,
    bilinear_taps,
    nearest_indices,
    resample_static_plain,
)


def _check_vector(name: str, v: torch.Tensor, dtype: torch.dtype,
                  dev: torch.device) -> None:
    if (v.dtype != dtype or v.ndim != 1 or v.device != dev
            or not v.is_contiguous()):
        raise ValueError(f"resample_static: {name} must be a contiguous "
                         f"1-D {dtype} tensor on {dev}")


def resample_static(img: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
                    value_scale: float = 1.0,
                    wy: Optional[torch.Tensor] = None,
                    wx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Separable resample of a (C, H, W) float32 image from per-axis taps
    on the image's device: int32 indices ``iy``/``ix``, each in range, and
    for bilinear their float32 weights ``wy``/``wx`` (the contract of
    ops.resample.resample_static_plain).  Nearest: out[c, r, x] =
    value_scale * img[c, iy[r], ix[x]].  A CUDA tensor runs the kernel; a
    CPU tensor runs the plain version."""
    if img.ndim != 3:
        raise ValueError(f"expected (C, H, W), got {tuple(img.shape)}")
    if (wy is None) != (wx is None):
        raise ValueError("resample_static: pass both wy and wx, or neither")
    if check_planes("resample_static", img).type == "cpu":
        return resample_static_plain(img, iy, ix, value_scale, wy, wx)
    _check_vector("iy", iy, torch.int32, img.device)
    _check_vector("ix", ix, torch.int32, img.device)
    C, H, W = img.shape
    H2, W2 = iy.numel(), ix.numel()
    out = torch.empty((C, H2, W2), dtype=img.dtype, device=img.device)
    scale = (float(value_scale), int(value_scale != 1.0))
    if wy is None:
        launch("ugsm_resample_nearest", "resample", ptr(img), ptr(out),
               ptr(iy), ptr(ix), C, H, W, H2, W2, *scale)
        return out
    _check_vector("wy", wy, torch.float32, img.device)
    _check_vector("wx", wx, torch.float32, img.device)
    if wy.numel() != H2 or wx.numel() != W2:
        raise ValueError("resample_static: weights and taps differ in length")
    launch("ugsm_resample_bilinear", "resample_bilinear", ptr(img), ptr(out),
           ptr(iy), ptr(ix), ptr(wy), ptr(wx), C, H, W, H2, W2, *scale)
    return out


def resample_tex(img: torch.Tensor, out_h: int, out_w: int, coord_of: CoordFn,
                 value_scale: float = 1.0, method: str = "nearest",
                 row_off: int = 0, col_off: int = 0) -> torch.Tensor:
    """Axis-separable texture resample of a (C, H, W) image: destination
    texel centres map through ``coord_of`` to source coordinates, point
    sampling (``"nearest"``) or linear filtering (``"bilinear"``), clamp
    addressing, then ``value_scale``.  ``row_off``/``col_off`` evaluate
    only the window of rows [row_off, row_off + out_h) and columns
    [col_off, col_off + out_w) of the full destination grid (JAX
    ops/pallas/resample.py:286-297): the window lives in the host taps,
    so the kernel is the same."""
    if method not in INTERP_METHODS:
        raise unsupported_interp(method)
    h, w = img.shape[-2], img.shape[-1]

    def upload(a):
        return torch.from_numpy(a).to(img.device, non_blocking=True)

    if method == "nearest":
        iy = upload(nearest_indices(out_h, h, coord_of, row_off))
        ix = upload(nearest_indices(out_w, w, coord_of, col_off))
        return resample_static(img, iy, ix, value_scale)
    (iy, wy), (ix, wx) = (bilinear_taps(out_h, h, coord_of, row_off),
                          bilinear_taps(out_w, w, coord_of, col_off))
    return resample_static(img, upload(iy), upload(ix), value_scale,
                           upload(wy), upload(wx))
