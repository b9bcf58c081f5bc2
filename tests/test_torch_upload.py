"""The fit's cell inputs built on the device (parallel/sharding.py
shard_inputs): the embedding uploaded in the caller's layout and padded
there, the one-hot design scattered from category codes, the mask from an
index comparison. Each is held bitwise against the host helpers
(pad_cells, shard_mask) of the dense arrays, the host quantities that the
codes now give against pd.get_dummies', and a run_harmony fit against
Harmony fed the dense design."""

import numpy as np
import pandas as pd
import pytest
import torch

import harmonypy_tpu_torch as ht
from harmonypy_tpu_torch.api import Harmony
from harmonypy_tpu_torch.config import EngineConfig
from harmonypy_tpu_torch.parallel.mesh import Mesh, make_mesh
from harmonypy_tpu_torch.parallel.sharding import (
    OneHotCodes, cell_range, parts, shard_inputs)
from harmonypy_tpu_torch.layout import pad_cells, shard_mask

N, D = 1000, 6          # N is no multiple of the chunk size, 32


def _meta(design, rng, n=N):
    """Metadata of one covariate, or of two: the second with a declared,
    unused category and missing values."""
    meta = pd.DataFrame({"batch": pd.Categorical(
        rng.choice(["b0", "b1", "b2"], size=n))})
    if design == "two":
        donor = rng.choice(["d0", "d1", "d2", None], size=n)
        meta["donor"] = pd.Categorical(donor,
                                       categories=["d0", "d1", "d2", "dx"])
    return meta


def _vars(design):
    return ["batch", "donor"] if design == "two" else ["batch"]


def _dense(meta, vars_use):
    return pd.get_dummies(meta[vars_use].astype("category")).to_numpy() \
        .T.astype(np.float32)


def _codes(meta, vars_use):
    cats = meta[vars_use].astype("category")
    return OneHotCodes(
        np.stack([cats[c].cat.codes.to_numpy() for c in cats.columns]),
        tuple(len(cats[c].cat.categories) for c in cats.columns))


MESHES = {"one": lambda: make_mesh(["cpu"]),
          "two": lambda: make_mesh(["cpu"] * 2),
          "three": lambda: make_mesh(["cpu"] * 3),
          "second_process": lambda: Mesh(("cpu", "cpu"), 2, 1)}


@pytest.mark.parametrize("design", ["one", "two", "dense"])
@pytest.mark.parametrize("layout", ["cells_first", "c_contiguous"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_device_layout_is_the_host_pad(mesh_name, layout, design):
    rng = np.random.default_rng(7)
    mesh = MESHES[mesh_name]()
    X = rng.normal(size=(N, D)).astype(np.float32)
    Z = X.T if layout == "cells_first" else np.ascontiguousarray(X.T)
    meta = _meta("one" if design == "dense" else design, rng)
    vars_use = _vars(design)
    dense = _dense(meta, vars_use)
    phi = dense if design == "dense" else _codes(meta, vars_use)
    cfg = EngineConfig(N=N, d=D, K=4, B=dense.shape[0], n_devices=mesh.size,
                       use_fused_xla=True, chunk_size=32)
    assert cfg.N_shard_real < cfg.N_local and N % cfg.chunk_size
    data = shard_inputs(Z, phi, cfg, mesh)
    ids, Nl = mesh.shard_ids, cfg.N_local
    lo, hi = cell_range(cfg, mesh)
    want = {"Z_orig": pad_cells(X.T[:, lo:hi], cfg, ids),
            "Phi": pad_cells(dense[:, lo:hi], cfg, ids),
            "mask": shard_mask(cfg)[ids[0] * Nl: (ids[-1] + 1) * Nl]}
    for f, w in want.items():
        got = parts(getattr(data, f))
        assert len(got) == len(ids), f
        for i, g in enumerate(got):
            assert g.dtype == torch.float32 and g.is_contiguous(), f
            assert torch.equal(g, torch.as_tensor(
                w[..., i * Nl: (i + 1) * Nl])), (f, i)


@pytest.mark.parametrize("design", ["one", "two", "one_missing"])
def test_codes_give_get_dummies_host_quantities(design):
    """Pr_b, theta under tau > 0 and n_covariates from the codes, bit for
    bit the computation over pd.get_dummies' dense design."""
    rng = np.random.default_rng(3)
    n = 20480 + 77
    meta = _meta("two" if design == "two" else "one", rng, n)
    if design == "one_missing":
        meta.loc[5, "batch"] = None
    vars_use = _vars(design)
    phi = _dense(meta, vars_use)
    N_b = phi.sum(axis=1)
    np.testing.assert_array_equal(_codes(meta, vars_use).counts(), N_b)
    K, tau = 16, 3.0
    phi_n = [len(meta[v].cat.categories) for v in vars_use]
    theta = np.repeat([2] * len(phi_n), phi_n).astype(np.float32)
    theta = (theta * (1 - np.exp(-(N_b / (K * tau)) ** 2))).astype(
        np.float32)
    ho = ht.run_harmony(rng.normal(size=(n, 4)).astype(np.float32), meta,
                        vars_use, nclust=K, tau=tau, max_iter_harmony=0,
                        device="cpu", verbose=False)
    assert ho.Pr_b.tobytes() == (N_b / n).astype(np.float32).tobytes()
    assert ho.theta.tobytes() == theta.tobytes()
    single = bool(np.all(phi.sum(axis=0) == 1.0)
                  and np.all((phi != 0).sum(axis=0) == 1))
    assert ho.n_covariates == (1 if single else 2)
    assert ho.n_covariates == (1 if design == "one" else 2)
    np.testing.assert_array_equal(ho.Phi, phi.T)


@pytest.mark.parametrize("design,n_dev", [("one", 1), ("two", 2)])
def test_run_harmony_is_harmony_fed_the_dense_design(design, n_dev):
    rng = np.random.default_rng(11)
    n = 3000
    centers = rng.normal(size=(5, D)) * 4
    X = (centers[rng.integers(0, 5, n)]
         + rng.normal(size=(n, D))).astype(np.float32)
    meta = _meta(design, rng, n)
    vars_use = _vars(design)
    kw = dict(nclust=8, max_iter_harmony=2, max_iter_kmeans=5,
              chunk_size=128, verbose=False, random_state=5,
              mesh=make_mesh(["cpu"] * n_dev))
    ho = ht.run_harmony(X, meta, vars_use, **kw)
    assert ho.cfg.defer_r and ho.cfg.fused_estep
    ref = Harmony(X.T, _dense(meta, vars_use), ho.Pr_b, ho.sigma, ho.theta,
                  ho.lamb, 0.2, False, 2, 5, 1e-5, 1e-4, 8, 0.05, False, 5,
                  mesh=kw["mesh"], chunk_size=128)
    assert ref.n_covariates == ho.n_covariates
    assert ho.Z_corr.tobytes() == ref.Z_corr.tobytes()
