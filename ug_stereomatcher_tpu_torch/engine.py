"""StereoEngine: the in-process matching API of the port (mode 1).

Counterpart of ``ug_stereomatcher_tpu/engine.py``.  ``match(left, right)``
is mode 1: pyramid build, coarse-to-fine matching, the finest level's
two-axis disparity and confidence (UG_GPU_matcher.cpp:421-491).  The
engine runs on the device it is given: ``device="cuda"`` runs every
stencil and gather as a hand-written CUDA kernel, ``device="cpu"`` runs
their plain PyTorch versions.  There is no fallback from one to the other.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from ug_stereomatcher_tpu_torch import match as match_mod
from ug_stereomatcher_tpu_torch import pyramid as pyr
from ug_stereomatcher_tpu_torch.config import MatcherConfig, check_supported
from ug_stereomatcher_tpu_torch.device import DTYPE, resolve_device
from ug_stereomatcher_tpu_torch.profiling import Timings


@dataclasses.dataclass
class MatchResult:
    """Full-resolution two-axis disparity and confidence (mode 1)."""
    disparity_h: torch.Tensor   # (H, W)
    disparity_v: torch.Tensor   # (H, W)
    confidence: torch.Tensor    # (H, W)

    @property
    def triplet(self) -> torch.Tensor:
        return torch.stack([self.disparity_h, self.disparity_v,
                            self.confidence])


def _to_chw(image, device: torch.device) -> torch.Tensor:
    """Accept (H, W, 3) or (3, H, W), uint8 or float, numpy or torch;
    return a contiguous (3, H, W) float32 tensor on ``device``.  The copy
    to the device happens before the cast, so uint8 crosses the bus."""
    arr = image if isinstance(image, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(image))
    if arr.ndim != 3:
        raise ValueError(f"expected 3-D RGB image, got shape {tuple(arr.shape)}")
    arr = arr.to(device)
    if arr.shape[0] != 3 and arr.shape[-1] == 3:
        arr = arr.movedim(-1, 0)
    return arr.to(DTYPE).contiguous()


def _check_pair(left: torch.Tensor, right: torch.Tensor) -> None:
    if left.shape != right.shape:
        raise ValueError(
            f"stereo pair shapes differ: left {tuple(left.shape)} vs right "
            f"{tuple(right.shape)}; both images must have identical "
            f"dimensions")


class StereoEngine:
    """Long-lived stereo matching engine on one device.

    * ``timings``: cumulative per-entry-point wall-clock buckets.
    * ``metrics``: last-call snapshot, ``{entry}_s`` per entry point.

    An entry point returns once the device has finished its work, so the
    recorded time is completion latency, not enqueue time.
    ``resident_max_pixels`` is a measurement-only override of the
    level-resident gate of match.match_level, for timing both routes of
    one match (None, the default for every workload: the size-derived
    LEVEL_RESIDENT_MAX_PIXELS; 0: every level runs per iteration).
    """

    def __init__(self, config: Optional[MatcherConfig] = None,
                 device: str | torch.device = "cuda",
                 resident_max_pixels: Optional[int] = None):
        self.config = config or MatcherConfig()
        check_supported(self.config)
        self.device = resolve_device(device)
        self.resident_max_pixels = resident_max_pixels
        self.timings = Timings()
        self.metrics: Dict[str, object] = {}

    def _record(self, name: str, t0: float) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        self.timings.record(name, dt)
        self.metrics[f"{name}_s"] = round(dt, 6)

    def match(self, left, right) -> MatchResult:
        """Full-resolution two-axis disparity for an RGB pair
        (MatchGPULib.cpp:303 ``match`` with fov=0)."""
        t0 = time.perf_counter()
        left = _to_chw(left, self.device)
        right = _to_chw(right, self.device)
        _check_pair(left, right)
        h, w = left.shape[-2:]
        trip = self._match_impl(left, right, height=h, width=w)
        self._record("match", t0)
        return MatchResult(trip[0], trip[1], trip[2])

    def _match_impl(self, left: torch.Tensor, right: torch.Tensor, *,
                    height: int, width: int) -> torch.Tensor:
        cfg = self.config
        n = cfg.num_levels(height, width)
        lp, rp = pyr.build_pyramid_pair(left, right, cfg, n)
        res = match_mod.match_pyramid(
            lp, rp, cfg, (height, width), foveated=False,
            resident_max_pixels=self.resident_max_pixels)
        return res.levels[0]
