"""k-means loop: the harmony::cluster ranges (every k-means round of
every harmony iteration), nested ranges taken as a union, per call."""

from harness.tracefile import length


def read(run):
    n = len(run.trace.range("portbench::call"))
    iv = run.trace.range("harmony::cluster")
    return length(iv) / n if n and len(iv) else None
