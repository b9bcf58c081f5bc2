"""The plain references hold the published fixtures (read as data from
harmonypy_tpu/data): Harmony's pbmc_3500 against the R package's
harmonized output at the gate of per-PC Pearson r >= 0.99, and LISI
against the R package's values."""

import os

import numpy as np
import pandas as pd
import torch

from conftest import ROOT
from reference.harmony_ref import harmony
from reference.lisi_ref import lisi

DATA = os.path.join(ROOT, "harmonypy_tpu", "data")


def _tsv(name):
    return pd.read_csv(os.path.join(DATA, name), sep="\t")


def test_harmony_reference_holds_pbmc_golden_gate():
    torch.set_num_threads(2)
    meta, pcs = _tsv("pbmc_3500_meta.tsv.gz"), _tsv("pbmc_3500_pcs.tsv.gz")
    harm = _tsv("pbmc_3500_pcs_harmonized.tsv.gz")
    if harm.iloc[:, 0].dtype == object:
        harm = harm.iloc[:, 1:]
    codes = pd.Categorical(meta["donor"]).codes.astype(np.int64)
    Z = torch.as_tensor(pcs.to_numpy(np.float32))
    K = int(min(round(Z.shape[0] / 30.0), 100))
    for precision in ("fp32", "bf16"):
        zc, R = harmony(Z, codes, int(codes.max()) + 1, K, 0, precision,
                        chunk=128)
        zc = zc.numpy()
        r = [np.corrcoef(zc[:, i], harm.iloc[:, i].to_numpy())[0, 1]
             for i in range(zc.shape[1])]
        assert min(r) >= 0.99, (precision, r)
        # bf16 keeps 8 significant bits: each value within 2^-8 of itself.
        tol = 1e-5 if precision == "fp32" else 2.0 ** -8
        assert torch.allclose(R.sum(0), torch.ones(R.shape[1]), atol=tol)


def test_lisi_reference_matches_r_fixture():
    X = _tsv("lisi_x.tsv.gz").to_numpy(np.float64)
    meta = _tsv("lisi_metadata.tsv.gz")
    want = _tsv("lisi_lisi.tsv.gz").iloc[:, -2:].to_numpy()
    cats = [pd.Categorical(meta[c]) for c in meta.columns]
    got = lisi(torch.as_tensor(X),
               [torch.as_tensor(c.codes.astype(np.int64)) for c in cats],
               [len(c.categories) for c in cats],
               torch.arange(X.shape[0]), 30).numpy()
    assert np.allclose(got, want), np.abs(got - want).max()
