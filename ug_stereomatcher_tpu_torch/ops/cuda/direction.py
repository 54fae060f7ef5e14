"""Fused correlate -> parabola -> update step: wrapper of
``csrc/direction.cu``.

Replaces ``fused_direction_update`` (ug_stereomatcher_tpu/ops/pallas/
direction.py, ``pallas_call`` at :258).  Bound on the card by device
memory (15 planes: L, W, G(L^2) and the state read, the state written),
with about 440 float32 operations a pixel close behind.  One launch: a
block stages L, W and (from W, in shared memory) the clamp blur of W^2
for a 16 x 64 tile of all three channels, then each thread computes 4
rows of one column from shared memory and registers, so no intermediate
plane exists and the block meets at no barrier between moves or
channels; only the new state is written.

The plain version here is the JAX package's unfused scan path
(match.direction_maps + parabola_fit + blend); the kernel follows its
term order with no fused multiply-add, and the channel mean is
``(c0 + c1 + c2) * (1/3)``, which is how jnp.mean rounds it.

The row-sharded form (``row0`` given; ``row_halo=True`` of the TPU
kernel, direction.py:221-246) takes one shard's rows of left and warped
with HALO real rows above and below, and resolves every boundary at the
image's global rows 0 and ``global_h - 1``: its output is exactly the
shard's rows of the unsharded step.

Early exit's guarded form (``stop`` given, match.match_level on the
card): every block returns before its first load while the level's flag
is set (ops/cuda/convergence.py), so ``out`` keeps what it held.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ug_stereomatcher_tpu_torch.config import MOVES, gaussian_kernel
from ug_stereomatcher_tpu_torch.ops.conv import (
    blur_gaussian_clamp,
    blur_gaussian_zero,
)
from ug_stereomatcher_tpu_torch.ops.cuda._build import (
    check_out,
    check_planes,
    guarded_plain,
    launch,
    ptr,
    stop_ptr,
)
from ug_stereomatcher_tpu_torch.ops.pointwise import (
    blend_confidence,
    correlation_ratio,
    parabola_fit,
)
from ug_stereomatcher_tpu_torch.ops.resample import band_rows, shift_image

DEFAULT_CONSTS = (0.4, 0.3, 0.7, 0.75, 0.25)
# Rows of halo the row-sharded form reads above and below a shard: the
# blur radius 2 plus the shift of 1.
HALO = 3


def direction_maps(left: torch.Tensor, warped: torch.Tensor,
                   blurred_l2: torch.Tensor, row0: int = 0,
                   global_h: Optional[int] = None) -> List[torch.Tensor]:
    """Five channel-mean correlation maps [left, right, up, down, centre],
    each (H, W), for (C, H, W) images and the clamp-blurred G(left^2).

    Row-sharded form (``global_h`` given): blurred_l2 is the rows [row0,
    row0 + Hl) of a ``global_h``-row image, left and warped the rows
    [row0 - h, row0 + Hl + h) for a halo h >= HALO, and the maps are the
    Hl rows.  The band's rows outside the image are re-clamped to the
    image's edge rows (the clamp boundary) and its cross products there
    set to zero (the zero boundary), so the band's own edges only reach
    halo rows."""
    rows = blurred_l2.shape[-2]
    halo = (left.shape[-2] - rows) // 2
    edge, inside = band_rows(left.shape[-2], row0 - halo,
                             rows if global_h is None else global_h,
                             left.device)
    warped = warped.index_select(-2, edge)
    blurred_w2 = blur_gaussian_clamp(warped * warped).index_select(-2, edge)
    crosses = torch.stack(
        [torch.where(inside[:, None], left * shift_image(warped, dx, dy), 0.0)
         for (dx, dy) in MOVES])
    bcross = blur_gaussian_zero(crosses)[..., halo:halo + rows, :]
    out = []
    for k, (dx, dy) in enumerate(MOVES):
        corr = correlation_ratio(
            bcross[k], blurred_l2,
            shift_image(blurred_w2, dx, dy)[..., halo:halo + rows, :])
        acc = corr[0]
        for c in range(1, corr.shape[0]):
            acc = acc + corr[c]
        out.append(acc * (1.0 / corr.shape[0]))
    return out


def fused_direction_update_plain(left: torch.Tensor, warped: torch.Tensor,
                                 blurred_l2: torch.Tensor, disp: torch.Tensor,
                                 threshold: float, replace_conf: bool,
                                 consts: Sequence[float] = DEFAULT_CONSTS,
                                 row0: Optional[int] = None,
                                 global_h: Optional[int] = None, *,
                                 stop: Optional[torch.Tensor] = None,
                                 out: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Plain PyTorch version of one correlate->parabola->update step, with
    the guard of ``_build.guarded_plain``."""
    return guarded_plain(stop, out, disp.shape, disp, lambda: _update_plain(
        left, warped, blurred_l2, disp, threshold, replace_conf, consts, row0,
        global_h))


def _update_plain(left, warped, blurred_l2, disp, threshold, replace_conf,
                  consts, row0, global_h) -> torch.Tensor:
    no_peak, aff_scale, aff_bias, w_new, w_old = consts
    dir_l, dir_r, dir_u, dir_d, dir_c = direction_maps(
        left, warped, blurred_l2, row0 or 0, global_h)
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
                           consts: Sequence[float] = DEFAULT_CONSTS,
                           row0: Optional[int] = None,
                           global_h: Optional[int] = None, *,
                           stop: Optional[torch.Tensor] = None,
                           out: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """One correlate->parabola->update step on (3, H, W) float32 planes.

    ``disp`` is the state [disp_h, disp_v, conf]; ``replace_conf`` takes
    the new confidence instead of blending it (the coarsest level's first
    iteration); ``consts`` is MatcherConfig.conf_consts.  Returns the new
    (3, H, W) state before smoothing.

    Row-sharded form: with ``row0`` and ``global_h`` given, blurred_l2,
    disp and the result are the (3, Hl, W) rows [row0, row0 + Hl) of a
    ``global_h``-row image, and left and warped are (3, Hl + 2 HALO, W),
    the rows [row0 - HALO, row0 + Hl + HALO) (rows outside the image may
    hold anything).

    ``out``: the result's buffer (default a new one).  ``stop``: early
    exit's flag (one int32; the kernel does nothing while it is set).  A
    CUDA tensor runs the kernel; a CPU tensor runs the plain version."""
    shape = disp.shape
    if len(shape) != 3 or shape[0] != 3:
        raise ValueError(f"expected (3, H, W) state, got {tuple(shape)}")
    _, Hl, W = shape
    halo = 0 if row0 is None else HALO
    if row0 is not None and (global_h is None
                             or not 0 <= row0 <= global_h - Hl):
        raise ValueError(f"rows [{row0}, {row0} + {Hl}) do not lie in an "
                         f"image of global_h={global_h} rows")
    band = (3, Hl + 2 * halo, W)
    for name, t, want in (("left", left, band), ("warped", warped, band),
                          ("blurred_l2", blurred_l2, shape)):
        if t.shape != want:
            raise ValueError(f"{name} is {tuple(t.shape)}, expected "
                             f"{tuple(want)}")
    dev = check_planes("fused_direction_update", left, warped, blurred_l2,
                       disp)
    if dev.type == "cpu":
        return fused_direction_update_plain(left, warped, blurred_l2, disp,
                                            threshold, replace_conf, consts,
                                            row0, global_h, stop=stop,
                                            out=out)
    out = check_out("fused_direction_update", out, shape, disp)
    k = gaussian_kernel()
    launch("ugsm_direction_update",
           "direction" if row0 is None else "direction_row_halo", ptr(left),
           ptr(warped), ptr(blurred_l2), ptr(disp), ptr(out),
           Hl if row0 is None else global_h, W, Hl, row0 or 0, halo,
           float(threshold), int(bool(replace_conf)), float(k[0]),
           float(k[1]), float(k[2]), *(float(c) for c in consts),
           stop_ptr("fused_direction_update", stop, dev))
    return out
