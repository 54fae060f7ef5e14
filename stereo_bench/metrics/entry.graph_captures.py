"""entry.graph_captures: the CUDA graphs the program captured in the
window (``ops.cuda._build.graph_captures()``, reset just before it): a
capture there means a graph was built again, so it should read 0.
Nothing where the window recorded no request span, or the program has
no such counter."""

from stereo_bench import spans


def read(run):
    if not spans.pairs(spans.totals()):
        return None
    from ug_stereomatcher_tpu_torch.ops.cuda import _build
    count = getattr(_build, "graph_captures", None)
    return None if count is None else float(count())
