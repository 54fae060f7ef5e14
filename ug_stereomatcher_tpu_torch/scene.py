"""Synthetic stereo scene with a known shift, made from a seed with numpy.

The multi-octave (1/f-style) texture has structure at every pyramid
scale, as a natural photograph does; white noise would be unmatchable at
the coarse levels.  ``make_pair`` cuts a left/right pair from it with a
constant horizontal disparity of 3 px: right[:, x + 3] == left[:, x].
The same scene the JAX package's bench and on-chip value check use.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

SHIFT_PX = 3


def octave_texture(h: int, w: int, seed: int = 0) -> np.ndarray:
    """(h, w, 3) uint8 texture: sum of nearest-upscaled random octaves
    of size 4, 8, ... with amplitude 0.85 per octave."""
    rng = np.random.RandomState(seed)
    out = np.zeros((h, w, 3), np.float32)
    scale = 1.0
    size = 4
    while size <= max(h, w):
        base = rng.rand(min(size, h), min(size, w), 3).astype(np.float32)
        yi = np.arange(h) * base.shape[0] // h
        xi = np.arange(w) * base.shape[1] // w
        out += scale * base[yi][:, xi]
        size *= 2
        scale *= 0.85
    out -= out.min()
    out *= 255.0 / out.max()
    return out.astype(np.uint8)


def make_pair(h: int, w: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(left, right), each (h, w, 3) uint8, with disparity +SHIFT_PX."""
    tex = octave_texture(h, w + 8, seed)
    return tex[:, 4:w + 4], tex[:, 4 - SHIFT_PX:w + 4 - SHIFT_PX]
