"""Device: the share of the window in which no kernel, copy or set ran on
the card (the union of their intervals), in percent; nothing to read
where the trace holds no device operation."""


def read(run):
    t = run.trace
    if not len(t.device):
        return None
    lo, hi = t.window()
    busy = sum(e - s for s, e in t.busy())
    return 100.0 * (hi - lo - busy) / (hi - lo) if hi > lo else None
