"""kernels.roofline_pct: the least time of the window's matches
(stereo_bench/work.py, per pyramid level, against the H100's published
peaks; with early exit from the reference's iterations) over the
device time of every kernel in the traced window, summed over the
cell's cards, in %."""


def read(run):
    tr = run.trace
    if tr is None or not run.pairs_traced or run.least_s is None:
        return None
    kernel_s = sum(tr.cards[c]["kernel_s"] for c in run.cards)
    if kernel_s <= 0:
        return None
    return 100.0 * run.least_s * run.pairs_traced / kernel_s
