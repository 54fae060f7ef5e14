"""mesh.card_idle_max_pct: device.idle_pct of the idlest of the cell's
cards; nothing to read on one card."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or len(run.cards) < 2:
        return None
    return max(tr.idle_pct(c) for c in run.cards)
