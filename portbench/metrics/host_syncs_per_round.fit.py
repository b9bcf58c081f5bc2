"""k-means loop: the host's waits for the card per k-means round, the
sync:: ranges (one per blocking read) that start inside a harmony::cluster
range, over the rounds the window's calls ran (sum(kmeans_rounds)).
Nothing to read where the program has no harmony::k1 range, that is no
ranges at its blocking reads either."""

from harness.tracefile import contains


def read(run):
    t = run.trace
    rounds = sum(c["counters"].get("kmeans_rounds", 0) for c in run.calls
                 if c["ok"])
    if not rounds or not len(t.range("harmony::k1")):
        return None
    starts = t.prefixed("sync::")[:, 0]
    return float(contains(t.range("harmony::cluster"), starts).sum()) / rounds
