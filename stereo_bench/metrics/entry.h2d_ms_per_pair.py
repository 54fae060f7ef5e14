"""entry.h2d_ms_per_pair: the device time of the traced window's
host-to-device copies (the upload of the pairs' host arrays), summed
over the cell's cards, over the pairs the window served."""


def read(run):
    tr = run.trace
    if tr is None or not run.pairs_traced:
        return None
    h2d = sum(tr.cards[c]["h2d_s"] for c in run.cards)
    if h2d <= 0:
        return None
    return 1e3 * h2d / run.pairs_traced
