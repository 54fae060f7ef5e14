"""Compile once, replay: one CUDA graph per entry point, shape and config.

Counterpart of the JAX engine's ``_jitted`` cache
(ug_stereomatcher_tpu/engine.py:222-227): there each entry point is
traced once per (entry point, shape, config), compiled into one program
and replayed on every later call.  On the card the port does the same
with a CUDA graph.  The first call of a key runs the eager path once on
a side stream (the warm-up: the nvcc build, the resample taps' upload,
the level kernel's host queries and the allocator's first blocks all
happen there, outside any capture), captures the same call into a
``torch.cuda.CUDAGraph`` and replays it; every later call copies the
caller's inputs into the graph's static inputs, replays, and returns
clones of its static outputs, so a result is never overwritten by a
later call, as a JAX array never is.  The kernels, their arguments and
their order are the eager call's, so the results are bit-equal to it.

A replay launches no wrapper, so it counts what its capture counted:
``_build.record_replay`` adds the capture's launches to the counters
(and counts the replay) and ``match.add_iterations`` adds early exit's
iterations, whose per-level counts the graph computes anew on each
replay.  ``launch_counts()``, ``iterations_run()`` and ``host_syncs()``
after a replay are therefore the eager call's.

The capture runs in ``thread_local`` mode: another thread (BatchRunner's
prefetcher) may touch CUDA while this one captures.  A call that the
capture refuses (a host read, a pageable copy, a synchronise) raises
with the reason; nothing falls back to the eager path.  Each graph keeps
its own memory pool alive for as long as it lives (about an eager call's
peak), and a graph replays on the device it was captured on.

Who captures: the engine's single-device entry points (engine.py), the
batch matcher (parallel/batch.py: one graph per batch shape and card, so
a mesh replays one graph on each card it covers; a rows-group that
spans several cards is the one route that stays eager) and
``profile_match``'s stages, which chain: a stage's static inputs are the
previous stage's static outputs, read in place (``load`` copies nothing
for them) and never cloned.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from ug_stereomatcher_tpu_torch import match as match_mod
from ug_stereomatcher_tpu_torch.ops.cuda import _build


def graph_key(entry: str, shape: Sequence[int], config,
              resident_max_pixels: Optional[int] = None,
              foveated: bool = False) -> tuple:
    """The cache key of one captured call, the JAX engine's key (entry
    point, input shape, MatcherConfig; ``foveated`` for match_batch) plus
    the engine's level-resident gate, which changes the kernels a call
    runs.  Equal configs give equal keys (MatcherConfig is a frozen
    dataclass)."""
    return (entry, tuple(int(s) for s in shape), config, resident_max_pixels,
            bool(foveated))


class CapturedCall:
    """One entry point's call at one key, as a CUDA graph.

    ``fn(*inputs)`` takes float32 tensors on ``device`` and returns a
    tensor or a tuple of tensors; it may allocate and launch kernels, but
    not read anything back to the host.  ``inputs`` gives each static
    input as a shape (a buffer of its own, filled by ``load``) or as a
    tensor on ``device`` that is the static input itself (another graph's
    static output, which a chain of stages reads in place).  The first
    replay captures (``capture_s`` its seconds: warm-up, capture and
    instantiation); a call returns fresh tensors."""

    def __init__(self, fn: Callable[..., object],
                 inputs: Sequence[Union[Sequence[int], torch.Tensor]],
                 device: torch.device):
        self.fn = fn
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got "
                             f"{self.device}")
        self.inputs = tuple(
            x if isinstance(x, torch.Tensor) else
            torch.empty(tuple(x), dtype=torch.float32, device=self.device)
            for x in inputs)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Tuple[torch.Tensor, ...] = ()
        self.single = False
        self.launches: collections.Counter = collections.Counter()
        self.iterations = match_mod.IterationCounts()
        self.capture_s: Optional[float] = None
        self._lock = threading.Lock()

    def _capture(self) -> None:
        t0 = time.perf_counter()
        here = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(here)
        with torch.cuda.stream(side), \
                _build.counting_into(collections.Counter()), \
                match_mod.counting_iterations_into(
                    match_mod.IterationCounts()):
            self.fn(*self.inputs)
        here.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        launches = collections.Counter()
        iterations = match_mod.IterationCounts()
        try:
            # a capture stream on this device: torch.cuda.graph's default
            # is one stream for the process, on the first device it met
            with _build.counting_into(launches), \
                    match_mod.counting_iterations_into(iterations), \
                    torch.cuda.graph(graph, stream=side,
                                     capture_error_mode="thread_local"):
                out = self.fn(*self.inputs)
        except Exception as exc:
            raise RuntimeError(f"CUDA graph capture failed: {exc}") from exc
        self.single = isinstance(out, torch.Tensor)
        self.outputs = (out,) if self.single else tuple(out)
        self.graph, self.launches, self.iterations = graph, launches, iterations
        self.capture_s = time.perf_counter() - t0
        # fn may hold the engine that holds this call: drop it, so that
        # the graph and its pool go with the engine without a GC pass
        self.fn = None

    def load(self, *sources: torch.Tensor) -> None:
        """Copy ``sources`` (tensors on any CUDA device, each broadcastable
        to its static input; the copy casts) into the static inputs, on
        the current streams; a source that is its static input is not
        copied."""
        if len(sources) != len(self.inputs):
            raise ValueError(f"expected {len(self.inputs)} inputs, got "
                             f"{len(sources)}")
        with torch.cuda.device(self.device):
            for static, src in zip(self.inputs, sources):
                if src is not static:
                    static.copy_(src)

    def replay(self) -> Tuple[torch.Tensor, ...]:
        """Replay on the device's current stream (capturing at the first
        call) and add the capture's counts; returns the static outputs,
        which the next replay overwrites.  The host does not wait."""
        with torch.cuda.device(self.device):
            if self.graph is None:
                self._capture()
            self.graph.replay()
        _build.record_replay(self.launches)
        match_mod.add_iterations(self.iterations)
        return self.outputs

    def __call__(self, *sources: torch.Tensor):
        """``load(*sources)``, replay, and clones of the outputs."""
        with self._lock:
            self.load(*sources)
            with torch.cuda.device(self.device):
                out = tuple(t.clone() for t in self.replay())
        return out[0] if self.single else out
