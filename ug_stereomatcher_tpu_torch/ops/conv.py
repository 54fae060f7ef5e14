"""Separable convolutions with the reference's two boundary semantics.

Counterpart of ``ug_stereomatcher_tpu/ops/conv.py``: zero padding
(pyramid blur, cross-product blur) or clamp addressing (energy blur,
average filter).  The weight applied at offset k is ``kernel[radius - k]``
(MatchLib.cu:133), zero taps are skipped, and the terms are summed in
offset order, one rounding per product and per sum.  The CUDA stencils
keep that order, which is what makes them bit-exact against this code.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ug_stereomatcher_tpu_torch.config import average_kernel, gaussian_kernel

_GAUSS = gaussian_kernel()
_AVG = average_kernel()


def pad_axis(x: torch.Tensor, axis: int, before: int, after: int,
             boundary: str) -> torch.Tensor:
    """Pad one axis with zeros ("zero") or edge copies ("clamp")."""
    axis = axis % x.ndim
    n = x.shape[axis]
    if boundary == "clamp":
        idx = torch.arange(-before, n + after, device=x.device).clamp(0, n - 1)
        return x.index_select(axis, idx)
    if boundary == "zero":
        pads = [0, 0] * (x.ndim - 1 - axis) + [before, after]
        return F.pad(x, pads)
    raise ValueError(f"unknown boundary {boundary!r}")


def conv1d(x: torch.Tensor, kernel, axis: int,
           boundary: str = "zero") -> torch.Tensor:
    """out[i] = sum_k kernel[radius - k] * x[i + k],  k in [-radius, radius]."""
    kernel = np.asarray(kernel)
    radius = len(kernel) // 2
    axis = axis % x.ndim
    xp = pad_axis(x, axis, radius, radius, boundary)
    n = x.shape[axis]
    out = None
    for k in range(-radius, radius + 1):
        w = float(kernel[radius - k])
        if w == 0.0:
            continue
        term = w * xp.narrow(axis, radius + k, n)
        out = term if out is None else out + term
    return out


def conv_separable(x: torch.Tensor, kernel,
                   boundary: str = "zero") -> torch.Tensor:
    """Separable 2-D convolution over the last two axes: the row pass
    (along width) first, then the column pass (MatchGPULib.cpp:866-960)."""
    x = conv1d(x, kernel, axis=-1, boundary=boundary)
    return conv1d(x, kernel, axis=-2, boundary=boundary)


def blur_gaussian_zero(x: torch.Tensor) -> torch.Tensor:
    """5-tap Gaussian blur, zero boundary (MatchLib.cu:159-305)."""
    return conv_separable(x, _GAUSS, boundary="zero")


def blur_gaussian_clamp(x: torch.Tensor) -> torch.Tensor:
    """5-tap Gaussian blur, clamp boundary (MatchLib.cu:1461-1586)."""
    return conv_separable(x, _GAUSS, boundary="clamp")


def blur_average_clamp(x: torch.Tensor) -> torch.Tensor:
    """3-tap average filter (taps exactly 0.3333), clamp boundary
    (MatchLib.cu:1593-1718)."""
    return conv_separable(x, _AVG, boundary="clamp")
