"""Init: the harmony::init range (k-means seeding and Lloyd, the init
pass), per call."""

from harness.tracefile import length


def read(run):
    n = len(run.trace.range("portbench::call"))
    iv = run.trace.range("harmony::init")
    return length(iv) / n if n and len(iv) else None
