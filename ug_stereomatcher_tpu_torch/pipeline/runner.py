"""Batch runner: drive the engine over a manifest of stereo pairs.

The in-process replacement for the launch-file graph (publish_images ->
matcher -> point cloud -> viz savers, stereo_nodes.launch:1-39): one call
runs capture, matching, optional point-cloud reconstruction and optional
dumps for every pair, with a background-thread prefetcher overlapping host
image decode with device compute (the reference instead paid a full process
round-trip per frame).  Counterpart of
``ug_stereomatcher_tpu/pipeline/runner.py``; clouds are written by the
native PCD writer (the bytes of ``geom.save_pcd``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import threading
import time
from typing import Iterable, List, Optional, Set

import torch

from ug_stereomatcher_tpu_torch import native
from ug_stereomatcher_tpu_torch.engine import StereoEngine
from ug_stereomatcher_tpu_torch.geom.calibration import StereoCalibration
from ug_stereomatcher_tpu_torch.geom.pointcloud import disparity_to_pointcloud
from ug_stereomatcher_tpu_torch.io.dumps import (
    save_disparity_maps,
    save_foveated_stack,
)
from ug_stereomatcher_tpu_torch.pipeline.capture import ImageListCapture


@dataclasses.dataclass
class PipelineResult:
    """Per-pair outputs + timing: ``match_seconds`` is the match's
    completion latency; ``cloud_seconds`` the reconstruction and its PCD
    write, ``dump_seconds`` the H/V/C dumps (0 where not run)."""
    index: int
    match_seconds: float
    result: object                      # MatchResult or FoveatedStackResult
    cloud: Optional[object] = None      # PointCloud
    dump_paths: Optional[dict] = None
    cloud_seconds: float = 0.0
    dump_seconds: float = 0.0


class _Prefetcher:
    """Background-thread image decode pipeline (depth-2 queue)."""

    def __init__(self, capture: ImageListCapture, n: int):
        self.q: "queue.Queue" = queue.Queue(maxsize=2)
        self.n = n
        self._thread = threading.Thread(
            target=self._run, args=(capture,), daemon=True)
        self._thread.start()

    def _run(self, capture):
        for _ in range(self.n):
            try:
                self.q.put(capture.capture())
            except Exception as exc:  # propagate through the queue
                self.q.put(exc)
                return
        self.q.put(None)

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item


class BatchRunner:
    """Run the matcher over every pair in a manifest.  ``dump_ext`` is the
    dumps' file type: ``.tif`` (PIL) or ``.npy``."""

    def __init__(self, engine: Optional[StereoEngine] = None,
                 foveated: bool = False,
                 calibration: Optional[StereoCalibration] = None,
                 out_dir: Optional[str] = None,
                 save_clouds: bool = False,
                 prefetch: bool = True,
                 checkpoint_path: Optional[str] = None,
                 dump_ext: str = ".tif"):
        self.engine = engine or StereoEngine()
        self.foveated = foveated
        self.calibration = calibration
        self.out_dir = out_dir
        self.save_clouds = save_clouds
        self.prefetch = prefetch
        self.dump_ext = dump_ext
        # Checkpoint/resume over large databases (the reference pipeline is
        # stateless per frame and restarts from scratch — SURVEY.md §5):
        # one JSON line per completed pair; on rerun, completed pairs whose
        # dump files still exist are skipped.
        self.checkpoint_path = checkpoint_path

    def _completed(self) -> Set[int]:
        done: Set[int] = set()
        if not self.checkpoint_path or not os.path.exists(self.checkpoint_path):
            return done
        with open(self.checkpoint_path) as fh:
            for line in fh:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                paths = rec.get("dump_paths") or {}
                # without persisted dumps there is nothing to resume from —
                # the pair must be recomputed so the caller gets results
                if paths and all(os.path.exists(p) for p in paths.values()):
                    done.add(int(rec["index"]))
        return done

    def _record(self, out: "PipelineResult") -> None:
        if not self.checkpoint_path:
            return
        rec = {"index": out.index, "match_seconds": out.match_seconds,
               "dump_paths": out.dump_paths, "ts": time.time()}
        with open(self.checkpoint_path, "a") as fh:
            fh.write(json.dumps(rec) + "\n")

    def run(self, capture: ImageListCapture,
            max_pairs: Optional[int] = None) -> List[PipelineResult]:
        n_pairs = len(capture.images.pairs())
        if max_pairs is not None:
            n_pairs = min(n_pairs, max_pairs)
        done = self._completed()
        # resume without decoding completed pairs: skip a completed PREFIX
        # cheaply by advancing the capture cursor (paths are known without
        # touching pixels); holes mid-run still decode-and-skip below
        skip = 0
        while skip < n_pairs and skip in done:
            skip += 1
        for _ in range(skip):
            capture.images.skip_pair()
        remaining = n_pairs - skip
        frames: Iterable = (_Prefetcher(capture, remaining) if self.prefetch
                            else (capture.capture()
                                  for _ in range(remaining)))
        results = []
        for off, frame in enumerate(frames):
            idx = skip + off
            if idx in done:
                continue
            t0 = time.perf_counter()
            if self.foveated:
                res = self.engine.match_foveated(frame.left, frame.right)
            else:
                res = self.engine.match(frame.left, frame.right)
            _block(res)
            dt = time.perf_counter() - t0

            out = PipelineResult(index=idx, match_seconds=dt, result=res)
            if self.calibration is not None and not self.foveated:
                t0 = time.perf_counter()
                out.cloud = disparity_to_pointcloud(
                    self.calibration, res.disparity_h, res.disparity_v,
                    frame.left)
                if self.save_clouds and self.out_dir:
                    os.makedirs(self.out_dir, exist_ok=True)
                    native.write_pcd(
                        os.path.join(self.out_dir, f"cloud_{idx}.pcd"),
                        out.cloud.xyz, out.cloud.rgb)
                out.cloud_seconds = time.perf_counter() - t0
            if self.out_dir:
                t0 = time.perf_counter()
                save = (save_foveated_stack if self.foveated
                        else save_disparity_maps)
                out.dump_paths = save(res, self.out_dir, prefix=f"pair{idx}",
                                      ext=self.dump_ext)
                out.dump_seconds = time.perf_counter() - t0
            self._record(out)
            results.append(out)
        return results


def _block(res) -> None:
    """Wait for the device that holds the result, so that match_seconds is
    completion latency, not enqueue time (the engine's entry points
    already synchronise; this keeps the runner's contract explicit)."""
    for field in dataclasses.fields(res):
        v = getattr(res, field.name)
        if isinstance(v, torch.Tensor):
            if v.is_cuda:
                torch.cuda.synchronize(v.device)
            return
