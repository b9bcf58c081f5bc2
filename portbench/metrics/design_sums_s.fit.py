"""Ridge / replay: the device time (union) of the operations launched
inside the harmony::design_sums ranges, per call: the one-hot design's
normal equations and correction (ops/replay.py window_design_sums,
window_apply_onehot). Nothing to read without such ranges."""

from harness.tracefile import length


def read(run):
    n = len(run.trace.range("portbench::call"))
    if not n or not len(run.trace.range("harmony::design_sums")):
        return None
    return length(run.trace.launched_in("harmony::design_sums")) / n
