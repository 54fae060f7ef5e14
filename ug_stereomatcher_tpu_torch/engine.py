"""StereoEngine: the in-process matching API of the port.

Counterpart of ``ug_stereomatcher_tpu/engine.py``.  ``match(left, right)``
is mode 1: pyramid build, coarse-to-fine matching, the finest level's
two-axis disparity and confidence (UG_GPU_matcher.cpp:421-491).
``match_foveated`` is mode 2: the per-level foveated disparity stack
(matchStackPyramid, MatchGPULib.cpp:534), and ``match_hierarchical``
the full-resolution map rebuilt from it (:355-360, :2589).
``match_batch`` runs a batch of pairs in either mode, on one device or
over a mesh.  The
engine runs on the device it is given: ``device="cuda"`` runs every
stencil and gather as a hand-written CUDA kernel, ``device="cpu"`` runs
their plain PyTorch versions.  There is no fallback from one to the other.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

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


@dataclasses.dataclass
class FoveatedStackResult:
    """Foveated disparity stack (mode 2), the analog of the reference's
    foveatedstack messages (msg/foveatedstack.msg:7-21).  The stacks are
    level-major: level i's rows are [i * roi_height, (i + 1) *
    roi_height).  Batched results (match_batch) carry a leading batch axis
    and no image stacks."""
    stack_h: torch.Tensor       # (num_levels * roi_height, roi_width)
    stack_v: torch.Tensor
    stack_c: torch.Tensor
    stack_left: Optional[torch.Tensor]   # (num_levels * 3 * roi_height,
    stack_right: Optional[torch.Tensor]  #  roi_width); None when batched
    im_width: int
    im_height: int
    roi_width: int
    roi_height: int
    num_levels: int

    def level_disparity(self, level: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One level's (disp_h, disp_v, confidence); a batch keeps its
        leading axis."""
        sl = slice(level * self.roi_height, (level + 1) * self.roi_height)
        return (self.stack_h[..., sl, :], self.stack_v[..., sl, :],
                self.stack_c[..., sl, :])

    def level_image(self, level: int, side: str = "left") -> torch.Tensor:
        """One level's (3, roi_height, roi_width) image: the rows of each
        level are channel-major (UG_GPU_matcher.cpp:203-213)."""
        stack = self.stack_left if side == "left" else self.stack_right
        if stack is None:
            raise ValueError("image stacks are not produced by batched "
                             "(match_batch) foveated runs")
        h = self.roi_height
        base = level * 3 * h
        return stack[..., base:base + 3 * h, :].unflatten(-2, (3, h))


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


def _check_fovea(cfg: MatcherConfig, height: int, width: int) -> None:
    n = cfg.num_levels(height, width)
    if n < cfg.fovea_level:
        fh, fw = cfg.fovea_dims(height, width)
        raise ValueError(
            f"image {height}x{width} supports only {n} pyramid levels but "
            f"fovea_level={cfg.fovea_level} (fovea would be {fh}x{fw}); use "
            f"a larger image or MatcherConfig(fovea_level<={n})")


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
    applies to ``match``, ``match_foveated`` and ``match_hierarchical``;
    ``match_batch`` keeps the default gate.
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
        left, right, (h, w) = self._pair(left, right)
        trip = self._match_impl(left, right, height=h, width=w)
        self._record("match", t0)
        return MatchResult(trip[0], trip[1], trip[2])

    def match_foveated(self, left, right) -> FoveatedStackResult:
        """Foveated per-level disparity stack of an RGB pair (mode 2:
        matchStackPyramid, MatchGPULib.cpp:534, with the node's stack
        layout, UG_GPU_matcher.cpp:163-369)."""
        t0 = time.perf_counter()
        left, right, (h, w) = self._pair(left, right)
        _check_fovea(self.config, h, w)
        levels, lf, rf = match_mod.match_foveated_pair(
            left, right, self.config, self.resident_max_pixels)
        k = self.config.fovea_level
        fov_h, fov_w = self.config.fovea_dims(h, w)
        stacks = torch.cat(levels[:k], dim=-2)
        # image stacks: level-major, channel-major rows inside each level
        stack_l, stack_r = (torch.cat([x.flatten(0, 1) for x in f[:k]])
                            for f in (lf, rf))
        self._record("match_foveated", t0)
        return FoveatedStackResult(
            stack_h=stacks[0], stack_v=stacks[1], stack_c=stacks[2],
            stack_left=stack_l, stack_right=stack_r, im_width=w,
            im_height=h, roi_width=fov_w, roi_height=fov_h, num_levels=k)

    def match_hierarchical(self, left, right) -> MatchResult:
        """The foveated match rebuilt into a full-resolution map: a sharp
        fovea and a coarser periphery (match(fov=1),
        MatchGPULib.cpp:355-360 -> hierarchicalDisparity, :2589)."""
        t0 = time.perf_counter()
        left, right, (h, w) = self._pair(left, right)
        _check_fovea(self.config, h, w)
        levels, _, _ = match_mod.match_foveated_pair(
            left, right, self.config, self.resident_max_pixels)
        trip = pyr.hierarchical_disparity(levels, self.config, (h, w))
        self._record("match_hierarchical", t0)
        return MatchResult(trip[0], trip[1], trip[2])

    def match_batch(self, left_batch, right_batch, mesh=None,
                    foveated: bool = False):
        """Match a batch of pairs (B, H, W, 3) or (B, 3, H, W), uint8 or
        float, numpy or torch.  Returns a MatchResult whose planes carry a
        leading batch axis or, with ``foveated=True`` (mode 2, the
        reference's throughput configuration), a FoveatedStackResult whose
        disparity stacks carry one and which holds no image stacks.

        Without a mesh the pairs run in turn on the engine's device.  On a
        mesh (parallel.make_mesh) the pairs go over its pairs axis and, with
        more than one row, each pair is row-sharded over its group's rows
        (parallel/batch.py); the result lies on the mesh's first device and
        equals ``match`` (``match_foveated``) per pair bit for bit."""
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
        h, w = lb.shape[-2:]
        if foveated:
            _check_fovea(self.config, h, w)
        out = fn(lb, rb)
        self._record("match_batch", t0,
                     None if mesh is None else mesh.distinct_devices())
        if foveated:
            fov_h, fov_w = self.config.fovea_dims(h, w)
            return FoveatedStackResult(
                stack_h=out[:, 0], stack_v=out[:, 1], stack_c=out[:, 2],
                stack_left=None, stack_right=None, im_width=w, im_height=h,
                roi_width=fov_w, roi_height=fov_h,
                num_levels=self.config.fovea_level)
        return MatchResult(out[:, 0], out[:, 1], out[:, 2])

    def _pair(self, left, right):
        """Both images as (3, H, W) float32 on the engine's device, and
        (H, W)."""
        left = _to_chw(left, self.device)
        right = _to_chw(right, self.device)
        _check_pair(left, right)
        return left, right, tuple(left.shape[-2:])

    def _match_impl(self, left: torch.Tensor, right: torch.Tensor, *,
                    height: int, width: int) -> torch.Tensor:
        cfg = self.config
        n = cfg.num_levels(height, width)
        lp, rp = pyr.build_pyramid_pair(left, right, cfg, n)
        res = match_mod.match_pyramid(
            lp, rp, cfg, (height, width), foveated=False,
            resident_max_pixels=self.resident_max_pixels)
        return res.levels[0]
