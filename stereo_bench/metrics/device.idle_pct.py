"""device.idle_pct: 100 - the union of kernel, copy and memset time on
each card over the traced window, in %, the mean over the cell's
cards."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return sum(tr.idle_pct(c) for c in run.cards) / len(run.cards)
