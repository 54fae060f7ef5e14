"""StereoEngine: the in-process matching API of the port (mode 1).

Counterpart of ``ug_stereomatcher_tpu/engine.py``.  ``match(left, right)``
is mode 1: pyramid build, coarse-to-fine matching, the finest level's
two-axis disparity and confidence (UG_GPU_matcher.cpp:421-491);
``match_batch`` runs a batch of pairs, on one device or over a mesh.  The
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


def _to_bchw(batch, device: torch.device) -> torch.Tensor:
    """_to_chw for a batch: (B, H, W, 3) or (B, 3, H, W) -> a contiguous
    (B, 3, H, W) float32 tensor on ``device``."""
    arr = batch if isinstance(batch, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(batch))
    if arr.ndim != 4:
        raise ValueError(f"expected a 4-D batch, got shape {tuple(arr.shape)}")
    return torch.stack([_to_chw(a, device) for a in arr])


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
    LEVEL_RESIDENT_MAX_PIXELS; 0: every level runs per iteration).  It
    applies to ``match`` only; ``match_batch`` keeps the default gate.
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

    def _record(self, name: str, t0: float, devices=None) -> None:
        for dev in devices or [self.device]:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
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

    def match_batch(self, left_batch, right_batch, mesh=None,
                    foveated: bool = False) -> MatchResult:
        """Match a batch of pairs (B, H, W, 3) or (B, 3, H, W), uint8 or
        float, numpy or torch.  Returns a MatchResult whose planes carry a
        leading batch axis.

        Without a mesh the pairs run in turn on the engine's device.  On a
        mesh (parallel.make_mesh) the pairs go over its pairs axis and, with
        more than one row, each pair is row-sharded over its group's rows
        (parallel/batch.py); the result lies on the mesh's first device and
        equals ``match`` per pair bit for bit.  ``foveated=True`` (mode 2)
        is not ported yet."""
        from ug_stereomatcher_tpu_torch.parallel.batch import (
            make_batch_matcher)

        t0 = time.perf_counter()
        fn = make_batch_matcher(self.config, mesh, self.device, foveated)
        dev = self.device if mesh is None else mesh.devices[0][0]
        lb = _to_bchw(left_batch, dev)
        rb = _to_bchw(right_batch, dev)
        if lb.shape != rb.shape:
            raise ValueError(f"batch shapes differ: {tuple(lb.shape)} vs "
                             f"{tuple(rb.shape)}")
        out = fn(lb, rb)
        self._record("match_batch", t0,
                     None if mesh is None else mesh.distinct_devices())
        return MatchResult(out[:, 0], out[:, 1], out[:, 2])

    def _match_impl(self, left: torch.Tensor, right: torch.Tensor, *,
                    height: int, width: int) -> torch.Tensor:
        cfg = self.config
        n = cfg.num_levels(height, width)
        lp, rp = pyr.build_pyramid_pair(left, right, cfg, n)
        res = match_mod.match_pyramid(
            lp, rp, cfg, (height, width), foveated=False,
            resident_max_pixels=self.resident_max_pixels)
        return res.levels[0]
