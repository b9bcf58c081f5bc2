"""API / host prep: the share of calls (%) whose api::upload range holds
an api::layout range, the padded embedding, one-hot design and mask built
on the device. Nothing to read where the program has no api::upload
range; 0 where it uploads but lays the cells out on the host."""

import numpy as np


def read(run):
    t = run.trace
    calls, ups = t.range("portbench::call"), t.range("api::upload")
    if not len(calls) or not len(ups):
        return None
    lays = t.range("api::layout")
    held = [(s, e) for s, e in ups
            if np.any((lays[:, 0] >= s) & (lays[:, 1] <= e))]
    hit = sum(any(c0 <= s and e <= c1 for s, e in held) for c0, c1 in calls)
    return 100.0 * hit / len(calls)
