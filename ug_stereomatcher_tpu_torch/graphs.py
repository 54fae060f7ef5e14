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
with the reason and the cards; nothing falls back to the eager path.
Each graph keeps its own memory pool alive for as long as it lives
(about an eager call's peak), and a graph replays on the device it was
captured on.

One graph may span several cards (``peers``), as one jitted program of
the JAX package spans a rows-group's devices: each card's work runs on a
side stream of that card, which joins the capture through an event
(``wait_stream``) and is joined back before it ends; each card's
allocations go to a pool of that card (``torch.cuda.MemPool``, which
lives as long as the graph), and the copies between cards become graph
nodes whose order the graph's edges keep.  The replay is one launch on
the first card's stream; the other cards' nodes wait only on the graph's
own edges.

Who captures: the engine's single-device entry points (engine.py), the
batch matcher (parallel/batch.py: one graph per batch shape and card,
or per batch shape and rows-group where the group's rows lie on several
cards, so a mesh replays one graph on each card or group it covers) and
``profile_match``'s stages, which chain: a stage's static inputs are the
previous stage's static outputs, read in place (``load`` copies nothing
for them) and never cloned.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

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
                 device: torch.device, peers: Sequence[torch.device] = ()):
        self.fn = fn
        self.device = torch.device(device)
        self.peers = tuple(d for d in dict.fromkeys(
            torch.device(p) for p in peers) if d != self.device)
        for d in (self.device,) + self.peers:
            if d.type != "cuda":
                raise ValueError(f"a CUDA graph needs CUDA devices, got {d}")
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
        self.pools: Dict[torch.device, object] = {}
        self._lock = threading.Lock()

    def _capture(self) -> None:
        t0 = time.perf_counter()
        cards = (self.device,) + self.peers
        _peer_access(cards)
        here = [torch.cuda.current_stream(d) for d in cards]
        side = [torch.cuda.Stream(d) for d in cards]
        for s, h in zip(side, here):
            s.wait_stream(h)
        with _current_streams(side), \
                _build.counting_into(collections.Counter()), \
                match_mod.counting_iterations_into(
                    match_mod.IterationCounts()):
            self.fn(*self.inputs)
        for s, h in zip(side, here):
            h.wait_stream(s)
        for s in side[1:]:
            s.synchronize()   # the peers' warm-up, before their capture
        graph = torch.cuda.CUDAGraph()
        launches = collections.Counter()
        iterations = match_mod.IterationCounts()
        try:
            # a capture stream on this device: torch.cuda.graph's default
            # is one stream for the process, on the first device it met
            with _build.counting_into(launches), \
                    match_mod.counting_iterations_into(iterations), \
                    torch.cuda.graph(graph, stream=side[0],
                                     capture_error_mode="thread_local"), \
                    self._joined(side):
                out = self.fn(*self.inputs)
        except Exception as exc:
            names = ", ".join(str(d) for d in cards)
            raise RuntimeError(f"CUDA graph capture failed on {names}: "
                               f"{exc}") from exc
        self.single = isinstance(out, torch.Tensor)
        self.outputs = (out,) if self.single else tuple(out)
        self.graph, self.launches, self.iterations = graph, launches, iterations
        self.capture_s = time.perf_counter() - t0
        # fn may hold the engine that holds this call: drop it, so that
        # the graph and its pool go with the engine without a GC pass
        self.fn = None

    @contextlib.contextmanager
    def _joined(self, side: Sequence[torch.cuda.Stream]):
        """Inside ``torch.cuda.graph`` on ``side[0]``: each peer's side
        stream joins the capture and is its card's current stream, and
        this thread's allocations on the peer go to the peer's pool, until
        the block ends and the capture stream joins the peers back."""
        cap = side[0]
        with contextlib.ExitStack() as stack:
            for s in side[1:]:
                s.wait_stream(cap)
                if s.device not in self.pools:
                    with torch.cuda.device(s.device):
                        self.pools[s.device] = torch.cuda.MemPool()
                stack.enter_context(torch.cuda.use_mem_pool(
                    self.pools[s.device], s.device))
            stack.enter_context(_current_streams(side[1:]))
            yield
        for s in side[1:]:
            cap.wait_stream(s)

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


@contextlib.contextmanager
def _current_streams(streams: Sequence[torch.cuda.Stream]):
    """Make each stream its card's current stream while the block runs
    (the current device stays as it was)."""
    here = torch.cuda.current_device()
    prev = [torch.cuda.current_stream(s.device) for s in streams]
    for s in streams:
        torch.cuda.set_stream(s)
    torch.cuda.set_device(here)
    try:
        yield
    finally:
        for s in prev:
            torch.cuda.set_stream(s)
        torch.cuda.set_device(here)


def _peer_access(cards: Sequence[torch.device]) -> None:
    """Enable peer access between every two of ``cards`` that allow it
    (torch enables it at a pair's first copy: one element copied each way
    does it before the warm-up and the capture), so that the copies
    between them are direct."""
    for a in cards:
        for b in cards:
            if a != b and torch.cuda.can_device_access_peer(a, b):
                torch.empty(1, device=b).copy_(torch.empty(1, device=a))
