"""Fused correlate -> parabola -> update step: wrapper of
``csrc/direction.cu``.

Replaces ``fused_direction_update`` (ug_stereomatcher_tpu/ops/pallas/
direction.py, ``pallas_call`` at :258).  Bound on the card by on-chip
work: 15 separable 5x5 blurs of cross products per pixel against a few
planes of memory traffic.  The kernel keeps every cross product, blur
pass and correlation map in shared memory and registers (a 16 x 32 tile
with halos of 2 and 3 per channel) and writes only the new state; the
clamp-boundary blur of the squared warped image runs first, into a
scratch plane, because the shifted read needs it at clamped neighbours.

The plain version here is the JAX package's unfused scan path
(match.direction_maps + parabola_fit + blend); the kernel follows its
term order with no fused multiply-add, and the channel mean is
``(c0 + c1 + c2) * (1/3)``, which is how jnp.mean rounds it.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ug_stereomatcher_tpu_torch.config import MOVES, gaussian_kernel
from ug_stereomatcher_tpu_torch.ops.conv import (
    blur_gaussian_clamp,
    blur_gaussian_zero,
)
from ug_stereomatcher_tpu_torch.ops.cuda._build import check_planes, launch, ptr
from ug_stereomatcher_tpu_torch.ops.pointwise import (
    blend_confidence,
    correlation_ratio,
    parabola_fit,
)
from ug_stereomatcher_tpu_torch.ops.resample import shift_image

DEFAULT_CONSTS = (0.4, 0.3, 0.7, 0.75, 0.25)


def direction_maps(left: torch.Tensor, warped: torch.Tensor,
                   blurred_l2: torch.Tensor) -> List[torch.Tensor]:
    """Five channel-mean correlation maps [left, right, up, down, centre],
    each (H, W), for (C, H, W) images and the clamp-blurred G(left^2)."""
    blurred_w2 = blur_gaussian_clamp(warped * warped)
    crosses = torch.stack(
        [left * shift_image(warped, dx, dy) for (dx, dy) in MOVES])
    bcross = blur_gaussian_zero(crosses)
    out = []
    for k, (dx, dy) in enumerate(MOVES):
        corr = correlation_ratio(bcross[k], blurred_l2,
                                 shift_image(blurred_w2, dx, dy))
        acc = corr[0]
        for c in range(1, corr.shape[0]):
            acc = acc + corr[c]
        out.append(acc * (1.0 / corr.shape[0]))
    return out


def fused_direction_update_plain(left: torch.Tensor, warped: torch.Tensor,
                                 blurred_l2: torch.Tensor, disp: torch.Tensor,
                                 threshold: float, replace_conf: bool,
                                 consts: Sequence[float] = DEFAULT_CONSTS
                                 ) -> torch.Tensor:
    """Plain PyTorch version of one correlate->parabola->update step."""
    no_peak, aff_scale, aff_bias, w_new, w_old = consts
    dir_l, dir_r, dir_u, dir_d, dir_c = direction_maps(left, warped,
                                                       blurred_l2)
    inc_h, conf_h = parabola_fit(dir_l, dir_c, dir_r, threshold, no_peak,
                                 aff_scale, aff_bias)
    inc_v, conf_v = parabola_fit(dir_u, dir_c, dir_d, threshold, no_peak,
                                 aff_scale, aff_bias)
    conf_new = conf_h * conf_v  # compCorrelation (MatchLib.cu:884)
    if replace_conf:
        conf = conf_new
    else:
        conf = blend_confidence(conf_new, disp[2], w_new, w_old)
    return torch.stack([inc_h + disp[0], inc_v + disp[1], conf])


def fused_direction_update(left: torch.Tensor, warped: torch.Tensor,
                           blurred_l2: torch.Tensor, disp: torch.Tensor,
                           threshold: float, replace_conf: bool,
                           consts: Sequence[float] = DEFAULT_CONSTS
                           ) -> torch.Tensor:
    """One correlate->parabola->update step on (3, H, W) float32 planes.

    ``disp`` is the state [disp_h, disp_v, conf]; ``replace_conf`` takes
    the new confidence instead of blending it (the coarsest level's first
    iteration); ``consts`` is MatcherConfig.conf_consts.  Returns the new
    (3, H, W) state before smoothing.  A CUDA tensor runs the kernel; a
    CPU tensor runs the plain version."""
    shape = disp.shape
    if len(shape) != 3 or shape[0] != 3:
        raise ValueError(f"expected (3, H, W) state, got {tuple(shape)}")
    for name, t in (("left", left), ("warped", warped),
                    ("blurred_l2", blurred_l2)):
        if t.shape != shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
    dev = check_planes("fused_direction_update", left, warped, blurred_l2,
                       disp)
    if dev.type == "cpu":
        return fused_direction_update_plain(left, warped, blurred_l2, disp,
                                            threshold, replace_conf, consts)
    _, H, W = shape
    bw2 = torch.empty_like(warped)
    out = torch.empty_like(disp)
    k = gaussian_kernel()
    launch("ugsm_direction_update", "direction", ptr(left), ptr(warped),
           ptr(blurred_l2), ptr(disp), ptr(bw2), ptr(out), H, W,
           float(threshold), int(bool(replace_conf)), float(k[0]),
           float(k[1]), float(k[2]), *(float(c) for c in consts))
    return out
