"""Mesh, processes: the mean wall time (ms) of a harmony::mesh_pass range,
one E-step pass of the round on a mesh (ops/cuda/fused_estep.py
fused_estep_mesh: every block's per-block launches on every shard and the
last re-add, as the host issues them). Nothing to read without such
ranges."""

import numpy as np


def read(run):
    iv = run.trace.range("harmony::mesh_pass")
    if not len(iv):
        return None
    return 1e3 * float(np.mean(iv[:, 1] - iv[:, 0]))
