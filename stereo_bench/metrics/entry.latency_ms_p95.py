"""entry.latency_ms_p95: the 95th percentile latency of every request of
the window, in ms, as the end-to-end ``latency_ms_p95`` takes it, here
from the traced window (the profiler's cost included).  It stands per
layer in the cells whose tail the host's load swings by more than an
end-to-end bound can hold.  Nothing where the window served no
request."""

from stereo_bench import stats


def read(run):
    latencies = getattr(run, "latencies_s", None)
    if not latencies:
        return None
    return stats.percentile([1e3 * t for t in latencies], 95)
