"""Ridge / replay: the harmony::ridge and harmony::ridge_replay ranges
(normal equations, solve, apply), as a union, per call."""

from harness.tracefile import length


def read(run):
    n = len(run.trace.range("portbench::call"))
    iv = run.trace.range("harmony::ridge", "harmony::ridge_replay")
    return length(iv) / n if n and len(iv) else None
