"""Pointwise correlation and subpixel-fit ops.

Counterpart of ``ug_stereomatcher_tpu/ops/pointwise.py``: MoveCorrelation
(MatchLib.cu:666), PolyDisparity (:790) and TrueConfidence (:990), written
as one float32 rounding per operation in the JAX package's order.
"""

from __future__ import annotations

from typing import Tuple

import torch


def correlation_ratio(blurred_cross: torch.Tensor, blurred_l2: torch.Tensor,
                      blurred_w2_shifted: torch.Tensor) -> torch.Tensor:
    """clip(G(L*W_d)^2 / (G(L^2) * G(W^2)(x+d)), 0, 1).

    x/0 gives inf, clamped to 1; 0/0 gives NaN, which passes through."""
    r = (blurred_cross * blurred_cross) / (blurred_l2 * blurred_w2_shifted)
    r = torch.where(r > 1.0, 1.0, r)
    return torch.where(r < 0.0, 0.0, r)


def parabola_fit(corr_minus: torch.Tensor, corr_centre: torch.Tensor,
                 corr_plus: torch.Tensor, threshold: float,
                 conf_no_peak: float = 0.4,
                 conf_affine_scale: float = 0.3,
                 conf_affine_bias: float = 0.7
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """3-point parabola fit over (corr_-, corr_0, corr_+) (PolyDisparity).

    Returns (subpixel offset increment, per-axis confidence).  A NaN input
    makes ``c1 < 0`` false, which gives (0, conf_no_peak)."""
    l, c, r = corr_minus, corr_centre, corr_plus
    b1 = (r - l) * 0.5
    c1 = r - (c + b1)
    has_peak = c1 < 0

    off = (-b1 * 0.5) / c1
    off = torch.clamp(off, -threshold, threshold)
    cstar = (c1 * off + b1) * off + c

    over = cstar > 1.0
    d = cstar - c
    off_over = torch.where(d > 1e-10, off * ((1.0 - c) / d), off)
    conf_in = torch.where(over, 1.0,
                          conf_affine_scale * cstar + conf_affine_bias)
    off_in = torch.where(over, off_over, off)

    offset = torch.where(has_peak, off_in, 0.0)
    conf = torch.where(has_peak, conf_in, conf_no_peak)
    return offset, conf


def blend_confidence(conf_new: torch.Tensor, conf_old: torch.Tensor,
                     w_new: float = 0.75, w_old: float = 0.25) -> torch.Tensor:
    """clip(w_new*new + w_old*old, 0, 1) (TrueConfidence)."""
    c = w_new * conf_new + w_old * conf_old
    c = torch.where(c > 1.0, 1.0, c)
    return torch.where(c < 0.0, 0.0, c)
