"""API / host prep: each call's wall time outside every harmony:: range
(one-hot and broadcasting, padding, upload, readback), per call. Nested
ranges are taken as a union."""

from harness.tracefile import intersect, length


def read(run):
    t = run.trace
    calls = t.range("portbench::call")
    if not len(calls):
        return None
    inside = length(intersect(t.prefixed("harmony::"), calls))
    return (length(calls) - inside) / len(calls)
