"""API / host prep: the api::readback ranges (Z_corr gathered to the
host, unpadded and transposed, as the caller reads it), as a union, per
call."""

from harness.tracefile import length


def read(run):
    n = len(run.trace.range("portbench::call"))
    iv = run.trace.range("api::readback")
    return length(iv) / n if n and len(iv) else None
