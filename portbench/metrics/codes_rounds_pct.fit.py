"""Kernels: the share (%) of the window's harmony::k1 ranges (a k-means
round's launch) that hold a harmony::k1_codes range: the round's kernel in
its wide plan's codes plan, which reads each cell's batch level instead of
its B design rows (csrc/fused_estep.cuh layout_codes). Nothing to read
without harmony::k1 ranges, nor from a program without a codes plan (no
ops/cuda/fused_estep.launches_codes)."""

import numpy as np


def read(run):
    from harmonypy_tpu_torch.ops.cuda import fused_estep
    if not hasattr(fused_estep, "launches_codes"):
        return None
    k1 = run.trace.range("harmony::k1")
    if not len(k1):
        return None
    codes = run.trace.range("harmony::k1_codes")
    held = sum(bool(np.any((codes[:, 0] >= s) & (codes[:, 1] <= e)))
               for s, e in k1)
    return 100.0 * held / len(k1)
