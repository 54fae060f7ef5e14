"""Closed-form two-view triangulation over whole disparity maps.

Counterpart of ``ug_stereomatcher_tpu/geom/triangulate.py``: the
reference's symbolic least-squares intersection (get3DPoint,
getPointCloud.cpp:886-949), P1 axis-aligned (rows 0 and 1 of its left
3 x 3, no skew), P2 the full 3 x 4 projection of the verged right camera.
It runs in float32 on the coordinates' device, as elementwise torch ops
in the JAX package's term order, with P1 and P2 cast to float32 first
(JAX's ``jnp.asarray`` of a float64 matrix does the same).  The
numerators and the divisor reach about 1e20-1e25 at pixel coordinates in
the thousands and cancel, so two float32 evaluations in different
orders (XLA against torch, the CPU against the card) agree to a relative
quantile, not to the bit.  On the card each operation is its own
elementwise launch (about 150 over the planes).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _matrix(P, like: torch.Tensor) -> torch.Tensor:
    """A projection matrix as float32 on ``like``'s device."""
    if isinstance(P, torch.Tensor):
        return P.to(device=like.device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(P, dtype=np.float32), device=like.device)


def _coeffs(P1, P2, x1, y1, x2, y2):
    """Coefficient fields a..j, x, y of getPointCloud.cpp:917-928."""
    a = P1[0, 0]
    b = P1[0, 2] - x1
    c = P1[1, 1]
    d = P1[1, 2] - y1
    e = P2[0, 0] - x2 * P2[2, 0]
    f = P2[0, 1] - x2 * P2[2, 1]
    g = P2[0, 2] - x2 * P2[2, 2]
    h = P2[1, 0] - y2 * P2[2, 0]
    i = P2[1, 1] - y2 * P2[2, 1]
    j = P2[1, 2] - y2 * P2[2, 2]
    x = x2 * P2[2, 3] - P2[0, 3]
    y = y2 * P2[2, 3] - P2[1, 3]
    return a, b, c, d, e, f, g, h, i, j, x, y


def triangulate_points(P1, P2, x1: torch.Tensor, y1: torch.Tensor,
                       x2: torch.Tensor, y2: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(X, Y, Z) in the left camera's frame of the matched pixel fields
    (x1, y1) <-> (x2, y2), float32 tensors of one shape on one device
    (getPointCloud.cpp:930-947).  P1, P2: (3, 4) matrices, NumPy or
    torch."""
    P1 = _matrix(P1, x1)
    P2 = _matrix(P2, x1)
    a, b, c, d, e, f, g, h, i, j, x, y = _coeffs(P1, P2, x1, y1, x2, y2)

    x_up = ((d * f * h - c * g * h - d * e * i + c * e * j)
            * (-(d * i * x) + c * j * x + d * f * y - c * g * y)
            + b ** 2 * ((f * h - e * i) * (-(i * x) + f * y)
                        + c ** 2 * (e * x + h * y))
            + a * b * ((-(g * i) + f * j) * (i * x - f * y)
                       + c * d * (f * x + i * y)
                       - c ** 2 * (g * x + j * y)))
    y_up = ((b ** 2 * (f * h - e * i)
             + d * (d * f * h - c * g * h - d * e * i + c * e * j))
            * (h * x - e * y)
            + a * b * ((c * d * e + g * h * i - 2.0 * f * h * j + e * i * j) * x
                       + (c * d * h + f * g * h - 2.0 * e * g * i + e * f * j) * y)
            + a ** 2 * ((g * i - f * j) * (-(j * x) + g * y)
                        + d ** 2 * (f * x + i * y)
                        - c * d * (g * x + j * y)))
    z_up = (c * (-(d * f * h) + c * g * h + d * e * i - c * e * j)
            * (h * x - e * y)
            - a * b * ((f * h - e * i) * (-(i * x) + f * y)
                       + c ** 2 * (e * x + h * y))
            + a ** 2 * ((g * i - f * j) * (i * x - f * y)
                        - c * d * (f * x + i * y)
                        + c ** 2 * (g * x + j * y)))
    divisor = (b ** 2 * (c ** 2 * (e ** 2 + h ** 2) + (f * h - e * i) ** 2)
               + (d * f * h - c * g * h - d * e * i + c * e * j) ** 2
               - 2.0 * a * b * (-(c * d * (e * f + h * i))
                                + (f * h - e * i) * (-(g * i) + f * j)
                                + c ** 2 * (e * g + h * j))
               + a ** 2 * (d ** 2 * (f ** 2 + i ** 2) + (g * i - f * j) ** 2
                           - 2.0 * c * d * (f * g + i * j)
                           + c ** 2 * (g ** 2 + j ** 2)))
    return x_up / divisor, y_up / divisor, z_up / divisor


def pixel_grid(h: int, w: int, device, step: int = 1
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 (xx, yy) of the pixels [0, h) x [0, w) every ``step``-th in
    each axis, each (ceil(h / step), ceil(w / step)), on ``device``."""
    xs = torch.arange(0, w, step, dtype=torch.float32, device=device)
    ys = torch.arange(0, h, step, dtype=torch.float32, device=device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return xx, yy


def triangulate_disparity(P1, P2, disp_h: torch.Tensor, disp_v: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Triangulate a full-resolution two-axis disparity map: pixel (xx, yy)
    of the left image matches (xx + disp_h, yy + disp_v) of the right one
    (getPointCloud.cpp:909-914)."""
    xx, yy = pixel_grid(*disp_h.shape, disp_h.device)
    return triangulate_points(P1, P2, xx, yy, xx + disp_h, yy + disp_v)


def range_map(P1, P2, disp_h: torch.Tensor,
              disp_v: torch.Tensor) -> torch.Tensor:
    """Z only (getRangePoint, getPointCloud.cpp:951-982)."""
    return triangulate_disparity(P1, P2, disp_h, disp_v)[2]
