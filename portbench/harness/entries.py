"""The program's entries a traffic mix drives, and how each is judged.

An entry makes the cell's input sets from the seed, calls the program on
one of them, and, once the window has closed, compares what the calls
returned with the plain reference (portbench/reference). A check yields
(name, value, limit): the run is correct where every value is at most
its limit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import inputs

LABELS = ("batch", "group")


def _value(v):
    """JSON has no infinities: the strings "inf" and "-inf" stand for them."""
    return float(v) if isinstance(v, str) and v in ("inf", "-inf") else v


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.kwargs = {k: _value(v) for k, v in traffic["kwargs"].items()}
        self.warm_kwargs = {k: _value(v) for k, v in
                            traffic.get("warm_kwargs", {}).items()}
        self.n_sets = int(traffic["input_sets"])
        self.kept = {}        # input set -> [first output, last output]

    def make_inputs(self) -> list:
        return [inputs.make(self.config["data"], self.seed, i, self.device,
                            self.traffic.get("batch_shift_scale"))
                for i in range(self.n_sets)]

    def keep(self, index: int, out) -> None:
        k = self.kept.setdefault(index, [out, out])
        k[1] = out

    def sampled_set(self) -> int:
        """The input set whose answers the reference checks, drawn from
        the seed among those the window answered."""
        done = sorted(self.kept)
        return done[inputs.derive(self.seed, 7) % len(done)]

    def repeat_mismatches(self) -> int:
        """Input sets whose first and last answers differ: the same inputs
        and seed must give the same bits."""
        return sum(not np.array_equal(a, b, equal_nan=True)
                   for a, b in self.kept.values())


class Fit(Entry):
    """run_harmony from host NumPy and pandas to Z_corr on the host."""

    def fit_kwargs(self, warm: bool = False) -> dict:
        h = self.config["harmony"]
        kw = dict(nclust=h["nclust"], theta=h["theta"], sigma=h["sigma"],
                  lamb=h["lamb"], block_size=h["block_size"],
                  max_iter_harmony=h["max_iter_harmony"],
                  max_iter_kmeans=h["max_iter_kmeans"],
                  matmul_precision=h["matmul_precision"],
                  low_memory=h["low_memory"],
                  chunk_size=h.get("chunk_size"), verbose=False,
                  device=str(self.device))
        kw.update(self.kwargs)
        if warm:
            kw.update(self.warm_kwargs)
        return kw

    def expected_rounds(self) -> int:
        h = self.config["harmony"]
        return int(h["max_iter_harmony"]) * int(h["max_iter_kmeans"])

    def call(self, inp, warm: bool = False):
        from harmonypy_tpu_torch import run_harmony
        ho = run_harmony(inp.X, inp.meta, ["batch"],
                         random_state=inp.random_state,
                         **self.fit_kwargs(warm))
        out = ho.Z_corr
        return out, {"kmeans_rounds": int(sum(ho.kmeans_rounds))}

    def precision(self) -> str:
        """The products' precision the configuration states on this
        device: one bf16 pass under "default" on a card, fp32 on the CPU
        (where run_harmony computes every product in fp32) or under
        "float32"."""
        one = (self.config["harmony"]["matmul_precision"] == "default"
               and self.device.type == "cuda")
        return "bf16" if one else "fp32"

    def check(self, sets, calls, limits, reference_precision=None):
        rounds = [c["counters"]["kmeans_rounds"] for c in calls if c["ok"]]
        yield ("rounds_off", float(max(
            (abs(r - self.expected_rounds()) for r in rounds), default=1)),
            limits["rounds_off"])
        yield ("repeat_mismatch", float(self.repeat_mismatches()),
               limits["repeat_mismatch"])
        i = self.sampled_set()
        out = self.kept.pop(i)[1]
        self.kept.clear()
        yield from self.compare(sets[i], out, limits, reference_precision)

    def reference(self, inp, precision):
        """The plain reference's (Z_corr (N, d), R (K, N)) of input set
        inp, on the device, its products in `precision`."""
        from reference.harmony_ref import harmony
        h = self.config["harmony"]
        return harmony(torch.as_tensor(inp.X, device=self.device),
                       inp.codes["batch"], self.config["data"]["n_batches"],
                       h["nclust"], inp.random_state, precision,
                       h["theta"], h["sigma"], h["lamb"], h["block_size"],
                       h["max_iter_harmony"], h["max_iter_kmeans"],
                       h.get("chunk_size"))

    def compare(self, inp, out, limits, precision=None):
        """zcorr_err, zcorr_gap and zcorr_raw of an answer `out` (N, d)
        for input set inp against the reference in `precision` (default:
        as stated)."""
        ref, R = self.reference(inp, precision or self.precision())
        err, gap, raw = correction_error(
            torch.as_tensor(inp.X, device=self.device),
            torch.as_tensor(out, device=self.device), ref, R)
        yield "zcorr_err", err, limits["zcorr_err"]
        yield "zcorr_gap", gap, limits["zcorr_gap"]
        yield "zcorr_raw", raw, limits["zcorr_raw"]


def correction_error(Z, got, ref, R) -> tuple:
    """How far an answer `got` (N, d) lies from the reference's `ref`,
    leaving out what rounding alone decides.

    Harmony's ridge leaves the intercept unpenalised, so each cluster's
    system is near-singular along one direction: the same shift t_k of
    every batch's coefficient, held only by lamb against about N / K
    cells (condition ~ N / K). Rounding sets t_k, and Z_corr moves by
    sum_k R_kn t_k, a shift common to all batches of a cluster that
    carries no batch correction. That family (K x d numbers) is taken out
    of the difference by least squares over the reference's R (K, N);
    the rest is compared: (its norm over ||Z - ref||, its widest value).
    The third number is the whole difference's norm over ||Z - ref||,
    the family left in: a fault that is itself such a shift (an
    intercept applied, a wrong batch-uniform apply) shows there only."""
    D = got.double() - ref.double()
    scale = torch.linalg.vector_norm(Z.double() - ref.double())
    raw = (torch.linalg.vector_norm(D) / scale).item()
    Rd = R.double()
    T = torch.linalg.pinv(Rd @ Rd.T, hermitian=True, rtol=1e-12) @ (Rd @ D)
    D = D - Rd.T @ T
    err = (torch.linalg.vector_norm(D) / scale).item()
    gap = torch.max(torch.abs(D)).item()
    return tuple(v if math.isfinite(v) else math.inf
                 for v in (err, gap, raw))


class Lisi(Entry):
    """compute_lisi over every cell, both labels, from host NumPy."""

    def call(self, inp, warm: bool = False):
        from harmonypy_tpu_torch import compute_lisi
        out = compute_lisi(inp.X, inp.meta, list(LABELS),
                           device=str(self.device),
                           **{**self.kwargs,
                              **(self.warm_kwargs if warm else {})})
        return np.asarray(out), {}

    def check(self, sets, calls, limits, reference_precision="float64"):
        yield ("repeat_mismatch", float(self.repeat_mismatches()),
               limits["repeat_mismatch"])
        i = self.sampled_set()
        out = self.kept[i][1]
        self.kept.clear()
        cats = np.asarray([sets[i].n_cats[k] for k in LABELS], np.float64)
        bad = ~np.isfinite(out) | (out < 1 - 1e-9) | (out > cats + 1e-9)
        yield "lisi_out_of_range", float(np.sum(bad)), \
            limits["lisi_out_of_range"]
        yield from self.compare(sets[i], out, limits, reference_precision)

    def queries(self, n: int) -> np.ndarray:
        """The rows the reference checks, drawn from the seed."""
        rng = np.random.default_rng(inputs.derive(self.seed, 8))
        return np.sort(rng.choice(n, size=min(int(
            self.traffic["check_queries"]), n), replace=False))

    def reference(self, inp, q, precision):
        from reference.lisi_ref import lisi
        dev = self.device
        return lisi(torch.as_tensor(inp.X, device=dev),
                    [torch.as_tensor(inp.codes[k], device=dev)
                     for k in LABELS], [inp.n_cats[k] for k in LABELS],
                    torch.as_tensor(q, device=dev),
                    self.kwargs.get("perplexity", 30),
                    getattr(torch, precision)).double().cpu().numpy()

    def compare(self, inp, out, limits, precision="float64"):
        """lisi_gap: the widest gap between `out` (N, labels) and the
        reference on the sampled rows."""
        q = self.queries(out.shape[0])
        gap = np.max(np.abs(out[q] - self.reference(inp, q, precision)))
        yield ("lisi_gap", float(gap) if np.isfinite(gap) else math.inf,
               limits["lisi_gap"])


ENTRIES = {"run_harmony": Fit, "compute_lisi": Lisi}
