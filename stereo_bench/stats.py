"""The statistics of a run's window, over all of its requests."""

from __future__ import annotations

from typing import Dict, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) of every value, linear between the
    two nearest ranks (numpy's default)."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def window_metrics(latencies_s: Sequence[float], pairs_per_request: int,
                   window_s: float) -> Dict[str, float]:
    """``pairs_per_s`` (all pairs completed over the window's length) and
    the median and 95th percentile latency of all requests, in ms."""
    if window_s <= 0:
        raise ValueError("the window has no length")
    ms = [1e3 * t for t in latencies_s]
    return {"pairs_per_s": len(ms) * pairs_per_request / window_s,
            "latency_ms_p50": percentile(ms, 50),
            "latency_ms_p95": percentile(ms, 95)}

