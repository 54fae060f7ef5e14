"""What the program's own spans and counters recorded in the traced
window: ``ug_stereomatcher_tpu_torch.profiling.span_totals()``, which
holds the window's requests alone (the program records spans only while
a profiler runs, and the harness's runs over the window, after the
warm-up).  A program without the spans, or a window with no request
span (a CPU run), gives nothing to read."""

from __future__ import annotations

from typing import Dict, Optional

REQUEST = "entry.request"


def totals() -> Dict[str, Dict[str, float]]:
    """The program's span totals by name, or {} where it has none."""
    try:
        from ug_stereomatcher_tpu_torch import profiling
    except ImportError:
        return {}
    read = getattr(profiling, "span_totals", None)
    return read() if read is not None else {}


def pairs(spans: Dict[str, Dict[str, float]]) -> int:
    """The pairs that the program's request spans served."""
    return int(spans.get(REQUEST, {}).get("pairs", 0))


def ms_per_pair(field: str, *names: str) -> Optional[float]:
    """The ``field`` seconds (``host_s``, ``self_s`` or ``device_s``) of
    the spans ``names``, summed, in ms over the requests' pairs; None
    where no request span was recorded or the spans read no time."""
    spans = totals()
    n = pairs(spans)
    seconds = sum(spans[k][field] for k in names if k in spans)
    if not n or seconds <= 0:
        return None
    return 1e3 * seconds / n
