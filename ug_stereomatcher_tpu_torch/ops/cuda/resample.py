"""Separable nearest resample: wrapper of ``csrc/resample.cu``.

Replaces ``resample_static`` (ug_stereomatcher_tpu/ops/pallas/resample.py,
``pallas_call`` at :223), reached through ``resample_tex`` (:286), for
``method="nearest"``.  Bound on the card by device memory: a pure gather.
The TPU kernel selects rows and columns with one-hot matmuls because its
vector unit cannot gather; the kernel here reads one source float per
output float, one block per run of 256 output columns of a row, so the
writes are coalesced.  The index vectors are computed on the host in
float64 with numpy, as the JAX package computes them.  Bit-exact.
"""

from __future__ import annotations

import torch

from ug_stereomatcher_tpu_torch.config import unsupported_interp
from ug_stereomatcher_tpu_torch.ops.cuda._build import check_planes, launch, ptr
from ug_stereomatcher_tpu_torch.ops.resample import (
    CoordFn,
    nearest_indices,
    resample_static_plain,
)


def resample_static(img: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
                    value_scale: float = 1.0) -> torch.Tensor:
    """out[c, r, x] = value_scale * img[c, iy[r], ix[x]] for a (C, H, W)
    float32 image and int32 index vectors on the image's device, each
    index already in range.  A CUDA tensor runs the kernel; a CPU tensor
    runs the plain version."""
    if img.ndim != 3:
        raise ValueError(f"expected (C, H, W), got {tuple(img.shape)}")
    if check_planes("resample_static", img).type == "cpu":
        return resample_static_plain(img, iy, ix, value_scale)
    for name, v in (("iy", iy), ("ix", ix)):
        if (v.dtype != torch.int32 or v.ndim != 1 or v.device != img.device
                or not v.is_contiguous()):
            raise ValueError(f"resample_static: {name} must be a contiguous "
                             f"1-D int32 tensor on {img.device}")
    C, H, W = img.shape
    H2, W2 = iy.numel(), ix.numel()
    out = torch.empty((C, H2, W2), dtype=img.dtype, device=img.device)
    launch("ugsm_resample_nearest", "resample", ptr(img), ptr(out), ptr(iy),
           ptr(ix), C, H, W, H2, W2, float(value_scale),
           int(value_scale != 1.0))
    return out


def resample_tex(img: torch.Tensor, out_h: int, out_w: int, coord_of: CoordFn,
                 value_scale: float = 1.0,
                 method: str = "nearest") -> torch.Tensor:
    """Axis-separable texture resample of a (C, H, W) image: destination
    texel centres map through ``coord_of`` to source coordinates, point
    sampling, clamp addressing, then ``value_scale``."""
    if method != "nearest":
        raise unsupported_interp(method)
    h, w = img.shape[-2], img.shape[-1]

    def upload(a):
        return torch.from_numpy(a).to(img.device, non_blocking=True)

    iy = upload(nearest_indices(out_h, h, coord_of))
    ix = upload(nearest_indices(out_w, w, coord_of))
    return resample_static(img, iy, ix, value_scale)
