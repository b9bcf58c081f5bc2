"""Kernels: the share (%) of the window's harmony::k1 ranges (a k-means
round's launch) that hold a harmony::k1_wide range: the round's kernel in
its wide plan, O, E, the diversity weights and the S accumulator out of
shared memory (csrc/fused_estep.cuh layout_wide). Nothing to read without
harmony::k1 ranges."""

import numpy as np


def read(run):
    k1 = run.trace.range("harmony::k1")
    if not len(k1):
        return None
    wide = run.trace.range("harmony::k1_wide")
    held = sum(bool(np.any((wide[:, 0] >= s) & (wide[:, 1] <= e)))
               for s, e in k1)
    return 100.0 * held / len(k1)
