"""LISI: the exact kNN, the lisi::build_index, lisi::scan,
lisi::fallback and lisi::brute ranges (the pruned search, its index, its
brute-force fallback, the tiled brute force) as a union, per call."""

from harness.tracefile import length


def read(run):
    n = len(run.trace.range("portbench::call"))
    iv = run.trace.range("lisi::build_index", "lisi::scan", "lisi::fallback",
                         "lisi::brute")
    return length(iv) / n if n and len(iv) else None
