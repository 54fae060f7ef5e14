"""entry.staged_share: the share of the host bytes that the program
uploaded to its cards in the window which went through its pinned
staging ring (``ops.cuda._build.upload_bytes()``, reset just before the
window: ``staged`` over ``staged`` plus ``pinned``).  Nothing where the
window recorded no request span or uploaded no host bytes, or the
program has no such counter."""

from stereo_bench import spans


def read(run):
    if not spans.pairs(spans.totals()):
        return None
    from ug_stereomatcher_tpu_torch.ops.cuda import _build
    count = getattr(_build, "upload_bytes", None)
    if count is None:
        return None
    moved = count()
    total = sum(moved.values())
    return moved["staged"] / total if total else None
