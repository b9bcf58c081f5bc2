"""Host waits: the sync:: ranges (one around each statement at which the
host blocks until the card has caught up), as a union, per call: the time
the host sat blocked on the card. Nothing to read where the program has
no api::design range, that is no ranges at its blocking reads either."""

from harness.tracefile import length


def read(run):
    t = run.trace
    n = len(t.range("portbench::call"))
    if not n or not len(t.range("api::design")):
        return None
    return length(t.prefixed("sync::")) / n
