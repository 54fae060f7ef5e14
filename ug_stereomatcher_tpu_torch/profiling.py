"""Timing buckets, the counterpart of ``ug_stereomatcher_tpu/profiling.py``.

``Timings`` keeps named wall-clock buckets with call counts.  Times taken
on the host clock measure device work only when the caller synchronises
first (``StereoEngine(sync_timing=True)``).
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict, Iterator


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
