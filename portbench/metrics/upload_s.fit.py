"""API / host prep: the api::upload ranges (the per-shard padding and the
host-to-device copies of the embedding, the design and the parameters),
as a union, per call."""

from harness.tracefile import length


def read(run):
    n = len(run.trace.range("portbench::call"))
    iv = run.trace.range("api::upload")
    return length(iv) / n if n and len(iv) else None
