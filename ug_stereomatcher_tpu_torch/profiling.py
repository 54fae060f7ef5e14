"""Spans, timing records and device traces, the counterpart of
``ug_stereomatcher_tpu/profiling.py``.

Spans.  ``span(name, ...)`` marks one step of the port: an entry point's
request (``entry.request``), its upload (``entry.upload``) and its final
synchronise (``entry.sync``), a CUDA graph's copy-in, replay, output
clones and capture (``graph.load``, ``graph.replay``, ``graph.clone``,
``graph.capture``), and a mesh's copies onto the groups' cards, its
replays, its copies back and its all-gather (``mesh.scatter``,
``mesh.replay``, ``mesh.gather``, ``mesh.all_gather``).  Spans are on
only while tracing is on: while a ``torch.profiler`` records, or inside
``collecting()``.  Off, a span costs one flag check and returns a shared
do-nothing object: no ``record_function``, no event, no allocation.  On,
a span

* opens a ``record_function`` range of its name, so that it sits in the
  profiler's trace on the clock of the device's kernels and copies, its
  parent span around it; its args carry the request id (and, for a
  request, its pairs) where the profiler records inputs
  (``record_shapes=True``);
* adds its host seconds, its self seconds (less the part its child
  spans cover), its device seconds and one count to the process's
  totals, ``span_totals()``, which ``reset_spans()`` clears.

A span opened with ``pairs`` is a request: it takes a new request id,
which every span opened inside it shares.  A span given ``device`` (a
device, a tensor, or a sequence of either; CPU ones are passed over)
records a timing ``torch.cuda.Event`` on the current stream of each of
those cards when it opens and when it closes: the caller names the cards
whose streams carry the span's work (torch runs a copy between two cards
on the source card's stream), and the device seconds are the sum over
them of the time between the two events, waits on those streams
included.  The events are read when a span that no other span encloses
closes, if they have completed, which they have after the synchronise
every entry point ends with; ``span_totals()`` reads the rest.  So no
read adds a synchronise on the request's path.  No span records an
event on a stream that is capturing: spans sit around captured work,
never inside what a graph captures.

``Timings`` keeps named wall-clock totals with call counts
(``StereoEngine.timings``).  Times taken on the host clock measure
device work only where the device has finished before the clock stops:
``StereoEngine``'s entry points synchronise their devices before they
record.  ``device_trace`` writes a ``torch.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

REQUEST = "entry.request"
FIELDS = ("count", "host_s", "self_s", "device_s", "pairs")


class Timings:
    """Named wall-clock totals with call counts."""

    def __init__(self) -> None:
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

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


class _Registry:
    """The process's span totals by name, the device events of closed
    spans not read yet, and events read, kept to be recorded again (a
    card's own: an event records only on the card it was made on)."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.totals: Dict[str, Dict[str, float]] = {}
        self.pending: List[tuple] = []   # (name, card, start, end event)
        self.free: Dict[torch.device, List[torch.cuda.Event]] = {}
        self.collecting = 0              # depth of collecting() blocks
        self.requests = itertools.count(1)
        self.local = threading.local()   # .open: this thread's open spans

    def add(self, name: str, host_s: float, self_s: float, pairs,
            events) -> None:
        with self.lock:
            t = self.totals.get(name)
            if t is None:
                t = self.totals[name] = dict.fromkeys(FIELDS, 0)
            t["count"] += 1
            t["host_s"] += host_s
            t["self_s"] += self_s
            t["pairs"] += pairs or 0
            self.pending.extend((name,) + e for e in events)

    def event(self, card: torch.device) -> torch.cuda.Event:
        """A timing event recorded on ``card``'s current stream."""
        with self.lock:
            free = self.free.get(card)
            ev = free.pop() if free else None
        if ev is None:
            ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(card))
        return ev

    def read_events(self, wait: bool) -> None:
        """Add the device seconds of the pending events that have
        completed (all of them, waiting for each, with ``wait``)."""
        with self.lock:
            left = []
            for name, card, start, end in self.pending:
                if wait:
                    end.synchronize()
                elif not end.query():
                    left.append((name, card, start, end))
                    continue
                self.totals[name]["device_s"] += start.elapsed_time(end) / 1e3
                self.free.setdefault(card, []).extend((start, end))
            self.pending = left


_REG = _Registry()


class _Off:
    """The span of tracing off: does nothing."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def stop(self, t: float) -> None:
        return None


_OFF = _Off()


def tracing() -> bool:
    """Whether spans record: a ``torch.profiler`` is recording, or a
    ``collecting()`` block is open."""
    return bool(_REG.collecting) or _autograd_profiler._is_profiler_enabled


def span(name: str, pairs: Optional[int] = None, device=None,
         start: Optional[float] = None):
    """A context manager that marks one step of the port (the module
    docstring).  ``pairs``: the span is a request serving that many
    pairs; ``device``: the cards whose streams carry the work, timed with
    events; ``start``: a ``time.perf_counter()`` reading taken before
    the span to use as its start (and ``.stop(t)`` inside the block sets
    its end), so that a caller's own timing and the span share their
    clock reads."""
    if not tracing():
        return _OFF
    return _Span(name, pairs, device, start)


def _cards(device) -> tuple:
    """The CUDA devices of ``device``: a device, a tensor, or a sequence
    of either, each card once, with its index ("cuda" is the current
    card)."""
    if device is None:
        return ()
    if isinstance(device, (torch.Tensor, torch.device, str)):
        device = (device,)
    devs = (d.device if isinstance(d, torch.Tensor) else torch.device(d)
            for d in device)
    return tuple(dict.fromkeys(
        d if d.index is not None
        else torch.device("cuda", torch.cuda.current_device())
        for d in devs if d.type == "cuda"))


# the range that records args (a private class: record_function where a
# torch lacks it)
_FAST_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None)


def _annotation(name: str, args: Dict[str, int]):
    """A ``record_function`` range of ``name`` whose args (recorded where
    the profiler records inputs) are ``args``."""
    if _FAST_RANGE is not None:
        return _FAST_RANGE(name, (), args)
    return torch.profiler.record_function(name)


class _Span:
    """The span of tracing on."""

    __slots__ = ("name", "pairs", "cards", "t0", "t1", "parent",
                 "request", "child_s", "events", "range")

    def __init__(self, name: str, pairs: Optional[int], device,
                 start: Optional[float]):
        self.name, self.pairs = name, pairs
        self.cards = _cards(device)
        self.t0, self.t1 = start, None
        self.child_s = 0.0
        self.events: List[torch.cuda.Event] = []

    def __enter__(self) -> "_Span":
        stack = getattr(_REG.local, "open", None)
        if stack is None:
            stack = _REG.local.open = []
        self.parent = stack[-1] if stack else None
        if self.pairs is not None:
            self.request = next(_REG.requests)
        else:
            self.request = self.parent.request if self.parent else 0
        args = {"request": self.request}
        if self.pairs is not None:
            args["pairs"] = int(self.pairs)
        self.range = _annotation(self.name, args)
        self.range.__enter__()
        if self.t0 is None:
            self.t0 = time.perf_counter()
        if self.cards and not torch.cuda.is_current_stream_capturing():
            self.events = [_REG.event(card) for card in self.cards]
        stack.append(self)
        return self

    def stop(self, t: float) -> None:
        """End the span's host time at ``t`` (a perf_counter reading)."""
        self.t1 = t

    def __exit__(self, *exc) -> None:
        timed = [(card, start, _REG.event(card))
                 for card, start in zip(self.cards, self.events)]
        t1 = time.perf_counter() if self.t1 is None else self.t1
        _REG.local.open.pop()
        host_s = t1 - self.t0
        if self.parent is not None:
            self.parent.child_s += host_s
        _REG.add(self.name, host_s, host_s - self.child_s, self.pairs, timed)
        if self.parent is None and _REG.pending:
            _REG.read_events(wait=False)
        # last, so that the trace's range holds the span's own work
        self.range.__exit__(None, None, None)


@contextlib.contextmanager
def collecting() -> Iterator[None]:
    """Record spans inside the block without a profiler (their totals go
    to ``span_totals()``)."""
    with _REG.lock:
        _REG.collecting += 1
    try:
        yield
    finally:
        with _REG.lock:
            _REG.collecting -= 1


def span_totals() -> Dict[str, Dict[str, float]]:
    """The totals of every span closed since ``reset_spans()``, by name:
    ``count``, ``host_s``, ``self_s``, ``device_s`` (summed over the
    cards each span named) and ``pairs`` (requests only).  Device events
    not read yet are waited for."""
    _REG.read_events(wait=True)
    with _REG.lock:
        return {k: dict(v) for k, v in _REG.totals.items()}


def reset_spans() -> None:
    """Forget every closed span's totals and unread events."""
    with _REG.lock:
        _REG.totals.clear()
        _REG.pending = []
        _REG.free.clear()


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Trace the block with ``torch.profiler``: CPU activity, and CUDA
    activity where a card is present (the block's kernels and copies),
    with the port's spans among the host events.  On exit the card is
    synchronised and a Chrome trace (``trace_<pid>.json``, viewable in
    Perfetto or chrome://tracing) is written into ``log_dir``.  A
    profiler failure raises."""
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
