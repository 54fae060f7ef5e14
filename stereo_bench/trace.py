"""The traced window: torch.profiler over the window, and the reduction of
its trace to device busy time, kernel time, copies and idle gaps.

The trace is exported as a Chrome trace under ``TMPDIR`` and read back
with ``json``, then deleted.  Device work is every ``kernel``,
``gpu_memcpy`` and ``gpu_memset`` event, by the card it ran on.  The
window is the harness's ``stereo_bench.window`` annotation less its
``stereo_bench.pause`` annotations (the copies of the sampled answers to
the host, which are the check's and not the system's).  An idle gap on a
card is put down to the innermost host event (an op, a runtime call or
the harness's annotation) that covered its midpoint.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import tempfile
from typing import Dict, Iterator, List, Sequence, Tuple

WINDOW = "stereo_bench.window"
PAUSE = "stereo_bench.pause"
REQUEST = "stereo_bench.request"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")

Span = Tuple[float, float]


def merge(spans: Sequence[Span]) -> List[Span]:
    """The union of ``spans`` as sorted, disjoint spans."""
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def intersect(spans: Sequence[Span], cuts: Sequence[Span]) -> List[Span]:
    """The parts of the disjoint sorted ``spans`` inside the disjoint
    sorted ``cuts``."""
    out, j = [], 0
    for a, b in spans:
        while j < len(cuts) and cuts[j][1] <= a:
            j += 1
        k = j
        while k < len(cuts) and cuts[k][0] < b:
            lo, hi = max(a, cuts[k][0]), min(b, cuts[k][1])
            if hi > lo:
                out.append((lo, hi))
            k += 1
    return out


def length(spans: Sequence[Span]) -> float:
    return sum(b - a for a, b in spans)


def _card(ev: dict) -> int:
    args = ev.get("args") or {}
    return int(args.get("device", ev.get("pid", 0)))


class Trace:
    """The reduced trace of one window (times in seconds).

    ``window_s``: the traced window's length; ``cards``: per card,
    ``busy_s`` (the union of its device work in the window), ``kernel_s``
    (the sum of its kernels' times) and ``h2d_s`` (its host-to-device
    copies' time); ``device_ops`` and ``idle_gaps``: the ten largest
    [name, seconds] of device work by name and of idle time by what the
    host was doing; ``requests``: the requests annotated in it."""

    def __init__(self, events: Sequence[dict], cards: Sequence[int]):
        host = [e for e in events if e.get("cat") == "user_annotation"]
        win = [e for e in host if e.get("name") == WINDOW]
        if not win:
            raise ValueError(f"the trace has no {WINDOW} annotation")
        w0 = win[0]["ts"]
        w1 = w0 + win[0]["dur"]
        pauses = merge([(e["ts"], e["ts"] + e["dur"]) for e in host
                        if e.get("name") == PAUSE])
        inside = _subtract([(w0, w1)], pauses)
        self.window_s = length(inside) * 1e-6
        self.requests = sum(1 for e in host if e.get("name") == REQUEST
                            and w0 <= e["ts"] <= w1)
        per_card: Dict[int, List[Span]] = collections.defaultdict(list)
        kernel = collections.Counter()
        h2d = collections.Counter()
        by_name = collections.Counter()
        for e in events:
            if e.get("cat") not in DEVICE_CATS or "dur" not in e:
                continue
            span = intersect([(e["ts"], e["ts"] + e["dur"])], inside)
            if not span:
                continue
            card, dur = _card(e), length(span) * 1e-6
            per_card[card].append((e["ts"], e["ts"] + e["dur"]))
            by_name[e["name"]] += dur
            if e["cat"] == "kernel":
                kernel[card] += dur
            elif "HtoD" in e["name"]:
                h2d[card] += dur
        self.cards: Dict[int, Dict[str, float]] = {}
        gaps: collections.Counter = collections.Counter()
        index = _HostIndex(events)
        for c in cards:
            busy = intersect(merge(per_card.get(c, [])), inside)
            self.cards[c] = {"busy_s": length(busy) * 1e-6,
                             "kernel_s": kernel[c],
                             "h2d_s": h2d[c]}
            for a, b in _subtract(inside, busy):
                gaps[index.doing((a + b) / 2)] += (b - a) * 1e-6
        self.device_ops = [[n, s] for n, s in by_name.most_common(10)]
        self.idle_gaps = [[n, s] for n, s in gaps.most_common(10)]

    def idle_pct(self, card: int) -> float:
        return 100.0 * (1.0 - self.cards[card]["busy_s"] / self.window_s)


def _subtract(spans: Sequence[Span], cuts: Sequence[Span]) -> List[Span]:
    """The parts of the disjoint sorted ``spans`` outside ``cuts``."""
    out = []
    for a, b in spans:
        cur = a
        for c, d in cuts:
            if d <= cur or c >= b:
                continue
            if c > cur:
                out.append((cur, c))
            cur = max(cur, d)
        if cur < b:
            out.append((cur, b))
    return out


class _HostIndex:
    """The host's events by start, to name what the host was doing."""

    def __init__(self, events: Sequence[dict]):
        # by start, the longer of two that start together first, so that
        # a look back from a time meets the innermost event first
        host = sorted(((e["ts"], e["ts"] + e.get("dur", 0), e["name"])
                       for e in events
                       if e.get("cat") in HOST_CATS
                       and e.get("name") != WINDOW),
                      key=lambda h: (h[0], -h[1]))
        self.starts = [h[0] for h in host]
        self.host = host

    def doing(self, t: float, look_back: int = 4000) -> str:
        i = bisect.bisect_right(self.starts, t)
        for j in range(i - 1, max(-1, i - 1 - look_back), -1):
            if self.host[j][1] >= t:
                return self.host[j][2]
        return "host (no event)"


@contextlib.contextmanager
def profiled(enabled: bool) -> Iterator[dict]:
    """Run the block under torch.profiler (CPU and CUDA activities) when
    ``enabled``; on exit, the yielded dict gets ``events``, the trace's
    events (the exported file is deleted)."""
    out: dict = {}
    if not enabled:
        yield out
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield out
    fd, path = tempfile.mkstemp(prefix="stereo_bench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            out["events"] = json.load(fh).get("traceEvents", [])
    finally:
        os.unlink(path)


def annotate(name: str):
    """A host annotation that the trace records (a no-op cost when no
    profiler runs)."""
    from torch.profiler import record_function
    return record_function(name)
