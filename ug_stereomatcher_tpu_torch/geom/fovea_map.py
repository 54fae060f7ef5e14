"""Fovea-to-full-resolution coordinate mapping.

Counterpart of ``ug_stereomatcher_tpu/geom/fovea_map.py`` (NumPy, on the
port's MatcherConfig): a fovea-stack pixel at stack level ``src_level``
maps into pyramid level ``dest_level`` (default 0, full resolution) by
scaling with sqrt(2)^|src - dest| and adding the centred fovea window's
margins (getPointCloud.cpp:387-484).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ug_stereomatcher_tpu_torch.config import MatcherConfig


def fovea_margins(cfg: MatcherConfig, height: int, width: int,
                  src_level: int, dest_level: int = 0) -> Tuple[int, int]:
    """(left, upper) margins of the scaled fovea window of ``src_level``
    inside pyramid level ``dest_level`` (left_marginOf_in /
    upper_marginOf_in, getPointCloud.cpp:431-484): the scaled fovea level
    is (fovea_level - 1) - src_level in the usual src >= dest case."""
    dims = cfg.dims_chain(height, width)
    if src_level < dest_level:
        scaled = src_level + dest_level  # the reference's branch (:437-438)
    else:
        scaled = (cfg.fovea_level - 1) - src_level
    dest_h, dest_w = dims[dest_level]
    src_h, src_w = dims[scaled]
    return dest_w // 2 - src_w // 2, dest_h // 2 - src_h // 2


def fovea_scale(src_level: int, dest_level: int = 0) -> float:
    """sqrt(2)^|src - dest| (its inverse when src < dest), as a float64
    NumPy scalar: mapXcoord/mapYcoord's factor (getPointCloud.cpp:387-421)."""
    root = 1.0 / np.sqrt(2.0) if src_level < dest_level else np.sqrt(2.0)
    return root ** abs(src_level - dest_level)


def map_fovea_coords(cfg: MatcherConfig, height: int, width: int,
                     src_level: int, src_x, src_y, dest_level: int = 0):
    """Map fovea-stack coordinates (src_x, src_y) of ``src_level`` to
    pyramid level ``dest_level``: margin + src * fovea_scale.  NumPy in,
    NumPy out, with NumPy's promotion (a float32 array times the float64
    factor is float64)."""
    left, upper = fovea_margins(cfg, height, width, src_level, dest_level)
    factor = fovea_scale(src_level, dest_level)
    return left + src_x * factor, upper + src_y * factor
