"""StereoEngine: the in-process matching API of the port.

Counterpart of ``ug_stereomatcher_tpu/engine.py``.  ``match(left, right)``
is mode 1: pyramid build, coarse-to-fine matching, the finest level's
two-axis disparity and confidence (UG_GPU_matcher.cpp:421-491).
``match_foveated`` is mode 2: the per-level foveated disparity stack
(matchStackPyramid, MatchGPULib.cpp:534), and ``match_hierarchical``
the full-resolution map rebuilt from it (:355-360, :2589).
``match_batch`` runs a batch of pairs in either mode, on one device or
over a mesh.  The extras: ``profile_match`` (mode 1 with a per-stage
timing breakdown), ``match_with_consistency`` (both directions and the
left-right check), ``get_disparities`` (the service entry point) and
``warmup``.  The engine runs on the device it is given: ``device="cuda"``
runs every stencil and gather as a hand-written CUDA kernel,
``device="cpu"`` runs their plain PyTorch versions.  There is no fallback
from one to the other.

On the card every entry point runs compiled once, as the JAX engine's
``_jitted`` cache runs them: ``match``, ``match_foveated`` and
``match_hierarchical`` (and so ``warmup``, ``match_with_consistency``
and ``get_disparities``) capture the eager call as a CUDA graph at the
first call of a key (``graphs.graph_key``: entry point, shape, config and
``resident_max_pixels``), which every later call at that key replays
(graphs.py); ``match_batch`` keeps one batch matcher per mesh and
``foveated`` (``matchers``), which replays one graph per batch shape and
card (parallel/batch.py; only a rows-group across several cards runs
eagerly); ``profile_match`` replays one graph per stage.  The graphs
live on the engine and go with it.  A capture that fails raises.  The
CPU engine captures nothing; the module functions
(``match.match_pyramid``, ``match.match_foveated_pair``,
``parallel.batch.make_batch_matcher(..., capture=False)``) are the eager
path on any device.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ug_stereomatcher_tpu_torch import match as match_mod
from ug_stereomatcher_tpu_torch import pyramid as pyr
from ug_stereomatcher_tpu_torch.config import MatcherConfig, check_supported
from ug_stereomatcher_tpu_torch.device import DTYPE, resolve_device
from ug_stereomatcher_tpu_torch.graphs import CapturedCall, graph_key
from ug_stereomatcher_tpu_torch.profiling import REQUEST, Timings, span


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


def _on_device(image, device: torch.device, ndim: int) -> torch.Tensor:
    """An ``ndim``-D image or batch, channels last or first, as a
    channels-first view on ``device`` in its own dtype: the copy to the
    device happens before any cast, so uint8 crosses the bus."""
    arr = image if isinstance(image, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(image))
    if arr.ndim != ndim:
        what = "3-D RGB image" if ndim == 3 else "a 4-D batch"
        raise ValueError(f"expected {what}, got shape {tuple(arr.shape)}")
    arr = arr.to(device)
    c = ndim - 3
    if arr.shape[c] != 3 and arr.shape[-1] == 3:
        arr = arr.movedim(-1, c)
    return arr


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

    * ``timings``: cumulative per-entry-point wall-clock totals.
    * ``metrics``: last-call snapshot, ``{entry}_s`` per entry point.

    An entry point returns once the device has finished its work, so the
    recorded time is completion latency, not enqueue time.  While
    tracing is on (a ``torch.profiler`` records, or
    ``profiling.collecting()``), ``match``, ``match_foveated``,
    ``match_hierarchical`` and ``match_batch`` each open an
    ``entry.request`` span (its ``pairs`` the pairs served) on the same
    two clock reads as ``timings``, with ``entry.upload`` (the images'
    copy to the device, device-timed), the graph's ``graph.load``,
    ``graph.replay`` and ``graph.clone`` (graphs.py) or the mesh's spans
    (parallel/batch.py) and ``entry.sync`` (the final synchronise)
    inside it (profiling.py).
    ``resident_max_pixels`` is a measurement-only override of the
    level-resident gate of match.match_level, for timing both routes of
    one match (None, the default for every workload: the size-derived
    LEVEL_RESIDENT_MAX_PIXELS; 0: every level runs per iteration).  It
    applies to ``match``, ``match_foveated`` and ``match_hierarchical``;
    ``match_batch`` keeps the default gate.
    * ``graphs``: on the card, the captured calls by key
      (graphs.graph_key -> graphs.CapturedCall, and profile_match's
      stage keys), the counterpart of the JAX engine's ``_cache``; empty
      on the CPU.
    * ``matchers``: match_batch's batch matchers by (mesh key,
      ``foveated``) (parallel.batch.BatchMatcher, each with its graphs,
      a card's or a rows-group's across cards);
      ``metrics["match_batch_route"]`` names the route of the last batch
      (``"graph"`` on cards, ``"eager"`` on the CPU).
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
        self.graphs: Dict[tuple, CapturedCall] = {}
        self.matchers: Dict[tuple, object] = {}
        self._graphs_lock = threading.Lock()
        self._profile_lock = threading.Lock()

    def _graph(self, key: tuple, impl: Callable[..., object],
               inputs: Sequence) -> CapturedCall:
        """The engine's captured call of ``key``, made at its first use
        (``inputs``: CapturedCall's shapes or static tensors)."""
        with self._graphs_lock:
            call = self.graphs.get(key)
            if call is None:
                call = self.graphs[key] = CapturedCall(impl, inputs,
                                                       self.device)
        return call

    def _run(self, entry: str, impl: Callable[..., object],
             sources: Sequence[torch.Tensor]):
        """``impl`` on float32 copies of ``sources`` (channels-first views
        on the engine's device): eagerly on the CPU; on the card through
        the CUDA graph of its key, captured at the key's first call."""
        if self.device.type != "cuda":
            return impl(*(x.to(DTYPE).contiguous() for x in sources))
        key = graph_key(entry, sources[0].shape, self.config,
                        self.resident_max_pixels)
        return self._graph(key, impl, [x.shape for x in sources])(*sources)

    def _record(self, name: str, t0: float, request, devices=None) -> None:
        """Wait for the devices (``entry.sync``), then record the call's
        seconds since ``t0`` and end its ``request`` span there."""
        with span("entry.sync"):
            for dev in devices or [self.device]:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        request.stop(t1)
        dt = t1 - t0
        self.timings.record(name, dt)
        self.metrics[f"{name}_s"] = round(dt, 6)

    def match(self, left, right) -> MatchResult:
        """Full-resolution two-axis disparity for an RGB pair
        (MatchGPULib.cpp:303 ``match`` with fov=0)."""
        t0 = time.perf_counter()
        with span(REQUEST, pairs=1, start=t0) as request:
            left, right, (h, w) = self._pair(left, right)
            trip = self._run("match", lambda lft, rgt: self._match_impl(
                lft, rgt, height=h, width=w), (left, right))
            self._record("match", t0, request)
        return MatchResult(trip[0], trip[1], trip[2])

    def match_foveated(self, left, right) -> FoveatedStackResult:
        """Foveated per-level disparity stack of an RGB pair (mode 2:
        matchStackPyramid, MatchGPULib.cpp:534, with the node's stack
        layout, UG_GPU_matcher.cpp:163-369)."""
        t0 = time.perf_counter()
        with span(REQUEST, pairs=1, start=t0) as request:
            left, right, (h, w) = self._pair(left, right)
            _check_fovea(self.config, h, w)
            stacks, stack_l, stack_r = self._run(
                "match_foveated", self._foveated_impl, (left, right))
            self._record("match_foveated", t0, request)
        fov_h, fov_w = self.config.fovea_dims(h, w)
        return FoveatedStackResult(
            stack_h=stacks[0], stack_v=stacks[1], stack_c=stacks[2],
            stack_left=stack_l, stack_right=stack_r, im_width=w,
            im_height=h, roi_width=fov_w, roi_height=fov_h,
            num_levels=self.config.fovea_level)

    def _foveated_impl(self, left: torch.Tensor, right: torch.Tensor):
        """Mode 2 of one pair: the (3, k * fh, fw) disparity stack and the
        two image stacks, k = fovea_level."""
        levels, lf, rf = match_mod.match_foveated_pair(
            left, right, self.config, self.resident_max_pixels)
        k = self.config.fovea_level
        # image stacks: level-major, channel-major rows inside each level
        stack_l, stack_r = (torch.cat([x.flatten(0, 1) for x in f[:k]])
                            for f in (lf, rf))
        return torch.cat(levels[:k], dim=-2), stack_l, stack_r

    def match_hierarchical(self, left, right) -> MatchResult:
        """The foveated match rebuilt into a full-resolution map: a sharp
        fovea and a coarser periphery (match(fov=1),
        MatchGPULib.cpp:355-360 -> hierarchicalDisparity, :2589)."""
        t0 = time.perf_counter()
        with span(REQUEST, pairs=1, start=t0) as request:
            left, right, (h, w) = self._pair(left, right)
            _check_fovea(self.config, h, w)

            def impl(lft, rgt):
                levels, _, _ = match_mod.match_foveated_pair(
                    lft, rgt, self.config, self.resident_max_pixels)
                return pyr.hierarchical_disparity(levels, self.config,
                                                  (h, w))
            trip = self._run("match_hierarchical", impl, (left, right))
            self._record("match_hierarchical", t0, request)
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
        equals ``match`` (``match_foveated``) per pair bit for bit.  On a
        mesh that spans processes (parallel.pod_mesh) every rank passes the
        same batch, matches its own groups' pairs and gets the whole
        result on its first local device.  The engine keeps one batch
        matcher per mesh key and ``foveated`` (parallel.mesh.mesh_key), as
        the JAX engine caches its jitted matcher per shape and mesh
        (engine.py:383-390): on the card it replays one CUDA graph per
        batch shape and card, or per batch shape and rows-group where a
        group's rows lie on several cards (one graph across them, its
        halo copies between the cards inside it); CPU devices run
        eagerly; ``metrics["match_batch_route"]`` says which ran."""
        from ug_stereomatcher_tpu_torch.parallel.batch import (
            make_batch_matcher)
        from ug_stereomatcher_tpu_torch.parallel.mesh import mesh_key

        t0 = time.perf_counter()
        with span(REQUEST, pairs=len(left_batch), start=t0) as request:
            key = (mesh_key(mesh), bool(foveated))
            with self._graphs_lock:
                fn = self.matchers.get(key)
                if fn is None:
                    fn = self.matchers[key] = make_batch_matcher(
                        self.config, mesh, self.device, foveated)
            dev = self.device if mesh is None else mesh.local_devices()[0]
            with span("entry.upload", device=dev):
                lb = _on_device(left_batch, dev, 4)
                rb = _on_device(right_batch, dev, 4)
            if lb.shape != rb.shape:
                raise ValueError(f"batch shapes differ: {tuple(lb.shape)} "
                                 f"vs {tuple(rb.shape)}")
            h, w = lb.shape[-2:]
            if foveated:
                _check_fovea(self.config, h, w)
            out = fn(lb, rb)
            self.metrics["match_batch_route"] = fn.route
            self._record("match_batch", t0, request,
                         None if mesh is None else mesh.local_devices())
        if foveated:
            fov_h, fov_w = self.config.fovea_dims(h, w)
            return FoveatedStackResult(
                stack_h=out[:, 0], stack_v=out[:, 1], stack_c=out[:, 2],
                stack_left=None, stack_right=None, im_width=w, im_height=h,
                roi_width=fov_w, roi_height=fov_h,
                num_levels=self.config.fovea_level)
        return MatchResult(out[:, 0], out[:, 1], out[:, 2])

    def profile_match(self, left, right) -> Tuple[MatchResult, Dict]:
        """Mode-1 match with a per-stage timing breakdown: the pyramid
        build, each level's match_level and each upsample, with the device
        synchronised after every stage, so each bucket is the stage's
        completion time (the reference's per-level logs,
        MatchGPULib.cpp:1265-1269, and excutionTime buckets, :1108-1117).
        The syncs serialise the host and the device: use it for analysis,
        not serving.  Its result equals :meth:`match`'s bit for bit (the
        gate ``resident_max_pixels`` included).

        On the card each stage replays its own CUDA graph, as the JAX
        engine jits each stage (engine.py:434, :449, :461), keyed as
        there (``("prof_build", h, w, cfg)``, ``("prof_level", i, dims,
        cfg)`` with whether the level is the coarsest, ``("prof_up",
        dims, out dims, cfg)``) plus ``resident_max_pixels``; a stage's
        first call captures it, inside its bucket.  The stages chain: a
        level or upsample graph reads the previous stage's static outputs
        in place, so no stage copies or clones a pyramid; the result is
        cloned after the last stage.  The CPU runs the stages eagerly.

        Returns ``(MatchResult, breakdown)``, the breakdown with the JAX
        package's keys (``pyramid_build_s``, ``levels.level_XX.{match_s,
        height, width, iterations, upsample_s}``, ``match_total_s``,
        ``total_s``; ``iterations`` is the level's schedule), and stores
        it at ``self.metrics["profile"]``."""
        cfg = self.config
        gate = self.resident_max_pixels
        on_card = self.device.type == "cuda"

        def stage(key, fn, spec, *sources):
            """One stage to its completion, ``(outputs, seconds)``: eager
            on the CPU; on the card the replay of its graph, whose static
            inputs are ``spec`` (shapes, or another stage's outputs)."""
            if not on_card:
                t0 = time.perf_counter()
                out = fn(*sources)
                return ((out,) if isinstance(out, torch.Tensor) else out,
                        time.perf_counter() - t0)
            call = self._graph(key + (gate,), fn, spec)
            call.load(*sources)
            t0 = time.perf_counter()
            out = call.replay()
            torch.cuda.synchronize(self.device)
            return out, time.perf_counter() - t0

        t_all = time.perf_counter()
        left, right, (h, w) = self._pair(left, right)
        left, right = (x.to(DTYPE).contiguous() for x in (left, right))
        n = cfg.num_levels(h, w)
        dims = match_mod.level_dims_for_matching(cfg, h, w, n, False)

        def build(lft, rgt):
            lp, rp = pyr.build_pyramid_pair(lft, rgt, cfg, n)
            return tuple(lp) + tuple(rp)

        def level(i):
            def run(lft, rgt, disp=None):
                if disp is None:   # the coarsest level starts from zeros
                    disp = torch.zeros((3,) + tuple(dims[i]),
                                       dtype=lft.dtype, device=lft.device)
                return match_mod.match_level(
                    lft, rgt, disp, i, cfg, is_coarsest=(i == n - 1),
                    resident_max_pixels=gate)
            return run

        levels: Dict[str, Dict[str, float]] = {}
        with self._profile_lock:   # the stages' static buffers
            pyramid, build_s = stage(("prof_build", h, w, cfg), build,
                                     [left.shape, right.shape], left, right)
            disp = ()
            for i in range(n - 1, -1, -1):
                ins = (pyramid[i], pyramid[n + i]) + tuple(disp)
                disp, match_s = stage(
                    ("prof_level", i, dims[i], cfg, i == n - 1), level(i),
                    ins, *ins)
                lvl = {"match_s": round(match_s, 6),
                       "height": dims[i][0], "width": dims[i][1],
                       "iterations": cfg.iters_for_level(i)}
                if i > 0:
                    h2, w2 = dims[i - 1]
                    disp, up_s = stage(
                        ("prof_up", dims[i], (h2, w2), cfg),
                        functools.partial(pyr.upsample_to_level, out_h=h2,
                                          out_w=w2, cfg=cfg), disp, *disp)
                    lvl["upsample_s"] = round(up_s, 6)
                levels[f"level_{i:02d}"] = lvl
            (trip,) = disp
            if on_card:   # the graph's buffer is overwritten by a replay
                trip = trip.clone()
        breakdown = {
            "pyramid_build_s": round(build_s, 6),
            "levels": levels,
            "match_total_s": round(sum(
                v["match_s"] + v.get("upsample_s", 0.0)
                for v in levels.values()), 6),
            "total_s": round(time.perf_counter() - t_all, 6),
        }
        self.metrics["profile"] = breakdown
        return MatchResult(trip[0], trip[1], trip[2]), breakdown

    def warmup(self, height: int, width: int, foveated: bool = False) -> None:
        """Run one match of a zero pair of this size (``foveated``: mode
        2), so that the first served pair pays no set-up: on the card it
        builds and loads the kernel library and captures the entry
        point's CUDA graph for this size, as the JAX ``warmup``
        compiles."""
        z = torch.zeros((3, height, width), dtype=DTYPE, device=self.device)
        if foveated:
            self.match_foveated(z, z)
        else:
            self.match(z, z)

    def match_with_consistency(self, left, right, tau: float = 1.0):
        """Both directions and the left-right check: the forward match,
        the backward one (the images swapped), and
        ops.consistency.lr_consistency_mask of the two in the config's
        interpolation (one warp launch on the card).  Returns
        ``(MatchResult left -> right, mask (H, W) bool, error (H, W))``.
        Not in the reference: a validity layer over its algorithm."""
        from ug_stereomatcher_tpu_torch.ops.consistency import (
            lr_consistency_mask)
        fwd = self.match(left, right)
        bwd = self.match(right, left)
        mask, err = lr_consistency_mask(
            fwd.disparity_h, fwd.disparity_v, bwd.disparity_h,
            bwd.disparity_v, tau=tau, method=self.config.interp)
        return fwd, mask, err

    def get_disparities(self, left, right, foveated: bool = False):
        """The service entry point (GetDisparitiesGPU,
        srv/GetDisparitiesGPU.srv; UG_GPU_matcher.cpp:497): a MatchResult,
        or with ``foveated`` a FoveatedStackResult."""
        if foveated:
            return self.match_foveated(left, right)
        return self.match(left, right)

    def _pair(self, left, right):
        """Both images as (3, H, W) views on the engine's device in their
        own dtype (``_run`` casts them), and (H, W)."""
        with span("entry.upload", device=self.device):
            left = _on_device(left, self.device, 3)
            right = _on_device(right, self.device, 3)
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
