"""API / host prep: the api::design ranges (the layout of the embedding,
the one-hot design, the hyper-parameters' broadcasting, the configuration,
the capacity preflight and the generator: everything before the upload),
as a union, per call."""

from harness.tracefile import length


def read(run):
    n = len(run.trace.range("portbench::call"))
    iv = run.trace.range("api::design")
    return length(iv) / n if n and len(iv) else None
