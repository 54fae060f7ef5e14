"""Timing buckets and device traces, the counterpart of
``ug_stereomatcher_tpu/profiling.py``.

``Timings`` keeps named wall-clock buckets with call counts.  Times taken
on the host clock measure device work only where the device has finished
before the clock stops: ``StereoEngine``'s entry points synchronise their
devices before they record.  ``device_trace`` writes a ``torch.profiler``
trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


class Timings:
    """Named wall-clock buckets with call counts."""

    def __init__(self) -> None:
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def bucket(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    def record(self, name: str, seconds: float) -> None:
        self.total[name] += seconds
        self.count[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": round(self.total[k], 6),
                "count": self.count[k],
                "mean_s": round(self.total[k] / max(1, self.count[k]), 6)}
            for k in sorted(self.total)
        }

    def report(self) -> str:
        return json.dumps(self.summary(), indent=2)

    def reset(self) -> None:
        self.total.clear()
        self.count.clear()


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Trace the block with ``torch.profiler``: CPU activity, and CUDA
    activity where a card is present (the block's kernels and copies).
    On exit the card is synchronised and a Chrome trace
    (``trace_<pid>.json``, viewable in Perfetto or chrome://tracing) is
    written into ``log_dir``.  A profiler failure raises."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}.json"))
