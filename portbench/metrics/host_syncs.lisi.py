"""LISI: the host's waits for the card per call, the count of sync::
ranges (one per blocking read: the index's sizes, the probe's
certificate count, the fallback's rows, each label's result). Nothing to
read where the program has no such ranges."""


def read(run):
    t = run.trace
    n = len(t.range("portbench::call"))
    syncs = t.prefixed("sync::")
    return len(syncs) / n if n and len(syncs) else None
