"""Typed configuration for the PyTorch stereo matcher.

The port's own copy of the algorithm contract of
``ug_stereomatcher_tpu/config.py``: the same constants, tap tables,
dimension chains and schedules, with the fields that only steer the TPU
kernels' tiling and dispatch left out.  It imports numpy only, so the
port never loads the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional, Tuple

import numpy as np

# The reference's SCALE constant (MatchLib_common.h:15): the truncated
# literal 1.41421356, not math.sqrt(2).  Dimension chains divide by it.
REFERENCE_SCALE = 1.41421356

# Hard-coded 5-tap Gaussian, renormalised by its own sum
# (MatchGPULib.cpp:761-774).
_RAW_GAUSSIAN = np.array(
    [0.0816475, 0.218507, 0.303281, 0.218507, 0.0816475], dtype=np.float64
)

# 3-tap average in 5-tap storage with the literal 0.3333 taps
# (MatchGPULib.cpp:344-350); each pass attenuates by 0.9999.
_AVERAGE = np.array([0.0, 0.3333, 0.3333, 0.3333, 0.0], dtype=np.float64)

# Correlation search moves (dx, dy): left, right, up, down, centre
# (MatchGPULib.cpp:1677).  The horizontal parabola reads (left, centre,
# right), the vertical one (up, centre, down).
MOVES: Tuple[Tuple[int, int], ...] = ((-1, 0), (1, 0), (0, -1), (0, 1),
                                      (0, 0))

# MatcherConfig fields of the JAX package that only tune its TPU kernels
# (warp windows and tiers, the stencil size gate, the level-resident
# program).  The port has no such knobs: its warp is one exact gather, and
# its level-resident gate is one module constant (match.py).
TPU_ONLY_FIELDS = frozenset({
    "warp_backend", "warp_max_dy", "warp_max_dx", "warp_overflow_guard",
    "warp_dynamic", "stencil_min_pixels", "level_backend",
})


INTERP_METHODS = ("nearest", "bilinear")


def unsupported_interp(method: str) -> Exception:
    """The error for an interpolation mode the port's matcher and kernels
    do not run."""
    if method == "cubic":
        return NotImplementedError(
            "interp='cubic' is not run by the matcher or the resample "
            "kernel: the JAX package's Pallas warp, level and resample "
            "kernels refuse it, so the port's do too (a non-goal recorded "
            "in ROADMAP.md); the cubic range-map resize of the geometry "
            "runs as plain torch (ops.resample.subsample(method='cubic')); "
            "use 'nearest' or 'bilinear'")
    return ValueError(f"unknown interp {method!r}")


def check_supported(cfg: "MatcherConfig") -> None:
    """Raise for configuration the port does not run."""
    if cfg.interp not in INTERP_METHODS:
        raise unsupported_interp(cfg.interp)
    if cfg.dtype != "float32":
        raise NotImplementedError(
            f"dtype={cfg.dtype!r}: the port's kernels are float32-only")


def gaussian_kernel() -> np.ndarray:
    """The effective 5-tap Gaussian blur kernel (float32, sums to 1)."""
    k = _RAW_GAUSSIAN / _RAW_GAUSSIAN.sum()
    return k.astype(np.float32)


def average_kernel() -> np.ndarray:
    """The 5-tap 'average' kernel of the per-iteration smoothing."""
    return _AVERAGE.astype(np.float32)


def analytic_gaussian_kernel(sigma: float = 1.1, radius: int = 2,
                             precision: int = 5) -> np.ndarray:
    """The 5-sample-averaged discrete Gaussian the reference computes
    (MatchGPULib.cpp:735-760) before overwriting it with the hard-coded
    taps; normalised to sum 1, float32.  Not used on the default path."""
    length = 2 * radius + 1
    mid = length // 2 + 1
    k = np.zeros(length, dtype=np.float64)
    for i in range(length):
        acc = 0.0
        for n in range(precision):
            t = i + 0.5 - mid + (n / (precision - 1.0))
            acc += math.exp(-(t * t) / (2 * sigma * sigma)) / (
                math.sqrt(2 * math.pi) * sigma)
        k[i] = acc / precision
    k /= k.sum()
    return k.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """Algorithm configuration; defaults reproduce the reference contract.

    Field provenance is documented on the JAX package's MatcherConfig."""

    # Pyramid
    max_level: int = 14
    scale: float = REFERENCE_SCALE
    min_dim: int = 8

    # Foveation
    fovea_level: int = 7

    # Iteration schedule
    level_cutoff: int = 22
    coarse_min_index: int = 6
    early_exit_delta: Optional[float] = None
    smooth_passes: int = 5
    smooth_passes_fine: int = 10
    fine_smooth_levels: int = 2

    # Confidence
    conf_blend_new: float = 0.75
    conf_blend_old: float = 0.25
    conf_no_peak: float = 0.4
    conf_affine_scale: float = 0.3
    conf_affine_bias: float = 0.7

    # Threshold (clamp) decay schedule
    threshold_init: float = 1.0
    threshold_floor: float = 0.1
    threshold_decay_window: int = 7

    # Sampling: the reference's textures use point sampling with clamp
    # addressing, which "nearest" reproduces; "bilinear" is the quality
    # mode (four taps, weights from coord - 0.5 computed in float32).
    interp: str = "nearest"

    # Upsampling scales all three planes, confidence included (a kept
    # reference quirk, MatchGPULib.cpp:1279).
    scale_conf_on_upsample: bool = True

    dtype: str = "float32"

    # ------------------------------------------------------------------
    @classmethod
    def from_reference(cls, mapping: Mapping[str, Any]) -> "MatcherConfig":
        """Build from ``dataclasses.asdict`` of a JAX-package MatcherConfig.

        Drops the TPU-only fields and raises on any other field this class
        does not know, so the two packages are held to the same values."""
        valid = {f.name for f in dataclasses.fields(cls)}
        kept = {k: v for k, v in mapping.items() if k not in TPU_ONLY_FIELDS}
        unknown = set(kept) - valid
        if unknown:
            raise ValueError(f"unknown MatcherConfig fields {sorted(unknown)}")
        return cls(**kept)

    @classmethod
    def from_file(cls, path: str) -> "MatcherConfig":
        """Load a config from a YAML or JSON file, the launch-file /
        parameter-server analog (ug_stereomatcher_tpu/config.py:304-325).
        The TPU-only fields are dropped, as in ``from_reference``, so a
        file written for the JAX package loads; any other unknown key
        raises, so a typo does not fall back to a default.  YAML needs
        PyYAML, imported at first use."""
        import json

        with open(path) as fh:
            if path.endswith((".yaml", ".yml")):
                import yaml
                data = yaml.safe_load(fh) or {}
            else:
                data = json.load(fh)
        if not isinstance(data, dict):
            raise ValueError(f"{path}: expected a mapping of config fields")
        valid = {f.name for f in dataclasses.fields(cls)}
        kept = {k: v for k, v in data.items() if k not in TPU_ONLY_FIELDS}
        unknown = set(kept) - valid
        if unknown:
            raise ValueError(
                f"{path}: unknown config fields {sorted(unknown)}; valid "
                f"fields: {sorted(valid)}")
        return cls(**kept)

    def num_levels(self, height: int, width: int) -> int:
        """Usable pyramid levels: no level dimension below min_dim."""
        n = 0
        for (h, w) in self.dims_chain(height, width):
            if h < self.min_dim or w < self.min_dim:
                break
            n += 1
        return max(1, n)

    def dims_chain(self, height: int, width: int) -> Tuple[Tuple[int, int], ...]:
        """dims[i+1] = int(dims[i] / SCALE), truncated as C++ int division
        by the double SCALE (MatchGPULib.cpp:1224-1228)."""
        out = [(height, width)]
        h, w = height, width
        for _ in range(self.max_level - 1):
            h = int(h / self.scale)
            w = int(w / self.scale)
            out.append((h, w))
        return tuple(out)

    def fovea_dims(self, height: int, width: int) -> Tuple[int, int]:
        """Fovea (h, w): the dims of level fovea_level - 1
        (MatchGPULib.cpp:406-426)."""
        return self.dims_chain(height, width)[self.fovea_level - 1]

    def iters_for_level(self, level_index: int) -> int:
        """mi = level_cutoff if i >= coarse_min_index else (i+1)*2
        (MatchGPULib.cpp:1741)."""
        if level_index >= self.coarse_min_index:
            return self.level_cutoff
        return (level_index + 1) * 2

    def smooth_passes_for_level(self, level_index: int) -> int:
        """Smoothing repetitions per iteration (MatchGPULib.cpp:2257-2261)."""
        if level_index < self.fine_smooth_levels:
            return self.smooth_passes_fine
        return self.smooth_passes

    def threshold_schedule(self, mi: int) -> Tuple[float, ...]:
        """Clamp threshold for each iteration m=1..mi, updated after every
        even iteration (MatchGPULib.cpp:2299-2306, integer division)."""
        th = self.threshold_init
        sched = []
        half = mi // 2
        for m in range(1, mi + 1):
            sched.append(th)
            if m % 2 == 0 and m < mi:
                rem = half - m // 2
                if rem < self.threshold_decay_window:
                    span = 1.0 - self.threshold_floor
                    th = (rem - 1) * (span / (half - 1.0)) + self.threshold_floor
                else:
                    th = self.threshold_init
        return tuple(sched)

    @property
    def moves(self) -> Tuple[Tuple[float, float], ...]:
        """The five correlation search moves (dx, dy) at the initial
        threshold: left, right, up, down, centre (MatchGPULib.cpp:1677)."""
        t = self.threshold_init
        return ((-t, 0.0), (t, 0.0), (0.0, -t), (0.0, t), (0.0, 0.0))

    @property
    def conf_consts(self) -> Tuple[float, float, float, float, float]:
        """(no_peak, affine_scale, affine_bias, blend_new, blend_old), the
        constants the direction update reads."""
        return (self.conf_no_peak, self.conf_affine_scale,
                self.conf_affine_bias, self.conf_blend_new,
                self.conf_blend_old)
