"""Disparity / confidence visualisation.

The reference's viz nodes dump raw float TIFFs for external eyeballing
(UG_dispImgTest.cpp); this module renders human-viewable colour maps
directly: signed disparities on a blue-white-red diverging map, confidence
on a black-to-green ramp, plus a side-by-side panel writer.  Planes may be
tensors on any device: each comes to the host through ``device.to_numpy``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ug_stereomatcher_tpu_torch.device import to_numpy


def _normalize(data: np.ndarray, vmin: Optional[float],
               vmax: Optional[float]) -> np.ndarray:
    d = np.asarray(to_numpy(data), dtype=np.float64)
    finite = np.isfinite(d)
    if vmin is None:
        vmin = float(np.percentile(d[finite], 2)) if finite.any() else 0.0
    if vmax is None:
        vmax = float(np.percentile(d[finite], 98)) if finite.any() else 1.0
    if vmax <= vmin:
        vmax = vmin + 1e-6
    out = (d - vmin) / (vmax - vmin)
    out[~finite] = 0.0
    return np.clip(out, 0.0, 1.0)


def colorize_disparity(disp, vmin: Optional[float] = None,
                       vmax: Optional[float] = None) -> np.ndarray:
    """Signed disparity -> (H, W, 3) uint8, blue (negative) / white (zero)
    / red (positive) diverging map.  Default range is symmetric around 0
    at the 98th percentile of |disp|; a single supplied bound mirrors into
    the other.  Non-finite pixels (e.g. consistency-masked NaNs) render as
    neutral mid-gray, not as extreme disparity."""
    d = np.asarray(to_numpy(disp), dtype=np.float64)
    finite = np.isfinite(d)
    if vmin is None and vmax is None:
        m = float(np.percentile(np.abs(d[finite]), 98)) if finite.any() else 1.0
        m = max(m, 1e-6)
        vmin, vmax = -m, m
    elif vmin is None:
        vmin = -abs(vmax)
    elif vmax is None:
        vmax = abs(vmin)
    t = _normalize(d, vmin, vmax) * 2.0 - 1.0   # [-1, 1]
    r = np.clip(1.0 + np.minimum(t, 0.0), 0.0, 1.0)
    b = np.clip(1.0 - np.maximum(t, 0.0), 0.0, 1.0)
    g = np.minimum(r, b)
    rgb = np.stack([np.where(t >= 0, 1.0, r),
                    g,
                    np.where(t <= 0, 1.0, b)], axis=-1)
    rgb[~finite] = 0.5
    return (rgb * 255).astype(np.uint8)


def colorize_confidence(conf) -> np.ndarray:
    """Confidence [0, 1] -> (H, W, 3) uint8 black-to-green ramp."""
    t = _normalize(conf, 0.0, 1.0)
    rgb = np.stack([t * 0.2, t, t * 0.2], axis=-1)
    return (rgb * 255).astype(np.uint8)


def render_panel(result, out_path: str,
                 vrange: Optional[Tuple[float, float]] = None) -> str:
    """Write a horizontal H | V | C colour panel PNG for a MatchResult."""
    from ug_stereomatcher_tpu_torch.io.image import save_image
    vmin, vmax = (vrange or (None, None))
    panel = np.concatenate([
        colorize_disparity(result.disparity_h, vmin, vmax),
        colorize_disparity(result.disparity_v, vmin, vmax),
        colorize_confidence(result.confidence),
    ], axis=1)
    save_image(out_path, panel)
    return out_path
