"""Engine supervisor — the failure-containment analog of matcher.py.

The reference ships a Python supervisor that SIGINTs and respawns the
matcher process after *every* frame to contain a GPU memory leak
(src/gpu_matcher/matcher.py:3-9, 26-52).  This engine is a long-lived jitted
object and doesn't leak, so the supervisor here is a proper watchdog
instead: it retries failed matches, rebuilds the engine (dropping its
device buffers: on a card, PyTorch's cached blocks are released)
after a failure, and keeps health/latency statistics.
``restart_every_frame=True`` reproduces the reference's paranoid
behaviour for A/B debugging.  Counterpart of
``ug_stereomatcher_tpu/pipeline/supervisor.py``, with its retry classes.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from ug_stereomatcher_tpu_torch.config import MatcherConfig
from ug_stereomatcher_tpu_torch.engine import StereoEngine


@dataclasses.dataclass
class SupervisorStats:
    frames: int = 0
    failures: int = 0
    restarts: int = 0
    total_seconds: float = 0.0

    @property
    def mean_seconds(self) -> float:
        return self.total_seconds / max(1, self.frames)


class EngineSupervisor:
    """Retry + engine-rebuild watchdog around StereoEngine."""

    def __init__(self,
                 engine_factory: Optional[Callable[[], StereoEngine]] = None,
                 max_retries: int = 2,
                 restart_every_frame: bool = False):
        # the default engine runs on the card ("cuda"), as StereoEngine()
        self._factory = engine_factory or (lambda: StereoEngine(MatcherConfig()))
        self.engine = self._factory()
        self.max_retries = max_retries
        self.restart_every_frame = restart_every_frame
        self.stats = SupervisorStats()

    def restart(self) -> None:
        """Rebuild the engine and drop the old one's device state (on a
        card, PyTorch's cached blocks) — the in-process analog of the
        reference's process respawn."""
        old = getattr(self.engine, "device", None)
        self.engine = None
        if isinstance(old, torch.device) and old.type == "cuda":
            torch.cuda.empty_cache()
        self.engine = self._factory()
        self.stats.restarts += 1

    def match(self, left, right, mode: str = "full"):
        """Run one frame with retry-on-failure.  mode: 'full' | 'foveated'
        | 'hierarchical'."""
        modes = {
            "full": lambda: self.engine.match(left, right),
            "foveated": lambda: self.engine.match_foveated(left, right),
            "hierarchical": lambda: self.engine.match_hierarchical(left, right),
        }
        if mode not in modes:
            raise ValueError(
                f"unknown mode {mode!r}; expected one of {sorted(modes)}")
        fn = modes[mode]
        last_exc: Optional[BaseException] = None
        for attempt in range(self.max_retries + 1):
            t0 = time.perf_counter()
            try:
                result = fn()
                self.stats.frames += 1
                self.stats.total_seconds += time.perf_counter() - t0
                if self.restart_every_frame:
                    self.restart()
                return result
            except (ValueError, TypeError):
                # programming/input errors are not transient — don't retry
                raise
            except Exception as exc:  # device/runtime failure: rebuild
                last_exc = exc
                self.stats.failures += 1
                # rebuild even on the FINAL failure: a caller that catches
                # this error and continues must face a fresh engine on the
                # next frame, not the poisoned one (with max_retries=0 the
                # watchdog would otherwise never restart at all)
                self.restart()
        raise RuntimeError(
            f"matcher failed after {self.max_retries + 1} attempts "
            f"({self.stats.failures} total failures)") from last_exc
