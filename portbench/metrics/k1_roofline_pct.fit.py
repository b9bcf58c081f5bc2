"""Kernels: the least time the window's k-means rounds could take on an
H100 (harness/roofline.py, counted from N, d, K, B and the rounds run),
as a share of the device time of the operations launched inside the
harmony::k1 ranges (their union): the round's kernel alone, without the
slot tables, frame sums and objective the harmony::cluster ranges also
launch. Nothing to read without device operations there."""

from harness.roofline import round_least_s
from harness.tracefile import length
from reference.harmony_ref import chunk_size


def read(run):
    dev = length(run.trace.launched_in("harmony::k1"))
    rounds = sum(c["counters"].get("kmeans_rounds", 0) for c in run.calls
                 if c["ok"])
    if dev <= 0 or not rounds:
        return None
    data, h = run.config["data"], run.config["harmony"]
    N = data["n_cells"]
    least = rounds * round_least_s(N, data["n_pcs"], h["nclust"],
                                   data["n_batches"],
                                   h.get("chunk_size")
                                   or chunk_size(N, h["block_size"]))
    return 100.0 * least / dev
