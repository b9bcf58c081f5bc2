"""The JAX package's end-to-end gates that hold the engine across covariates,
loop bounds and shapes, run against the port with the JAX tests' own data,
bounds and shard counts, on CPU meshes of as many shards:

- tests/test_harmony_golden.py:101-118 (`test_multi_covariate`): donor and a
  random chemistry, 2 harmony iterations, 8 shards, every PC r >= 0.8;
- tests/test_harmony_golden.py:121-128 (`test_lambda_estimation`): lamb=-1,
  8 shards, every PC r >= 0.9;
- tests/test_shapes_fuzz.py:14-60: eight odd shapes (prime N, N not a
  multiple of the shards, d = 1, B > K, tiny chunks, deferred and stored),
  finiteness, R sums, O = R^T Phi and history lengths; each fused case on
  several shards also bitwise equal to its one-shard fit (the port's 1 == N
  contract);
- tests/test_robustness.py:109-123 (`test_tiny_max_iter_kmeans`):
  max_iter_kmeans 1 and 2 on 2 shards, the history lengths."""

import numpy as np
import pandas as pd
import pytest
import torch
from scipy.stats import pearsonr

# Test workers share the CPU cores with each other and with JAX's own
# thread pool: one intra-op thread each keeps torch from oversubscribing.
torch.set_num_threads(1)

import harmonypy_tpu_torch as ht
from harmonypy_tpu_torch.config import fused_geometry_ok
from harmonypy_tpu_torch.parallel.mesh import make_mesh
from conftest import synthetic_batched


def cpu_mesh(n):
    return make_mesh(["cpu"] * n)


def _correlations(Z_corr, harmonized):
    """Per-PC Pearson r against the R package's output
    (tests/test_harmony_golden.py:13-20)."""
    harm = harmonized
    if harm.iloc[:, 0].dtype == "object":
        harm = harm.iloc[:, 1:]
    return np.array([pearsonr(Z_corr[:, i], harm.iloc[:, i].values)[0]
                     for i in range(Z_corr.shape[1])])


def test_multi_covariate(pbmc):
    """Phi from two covariates (tests/test_harmony_golden.py:101-118): its
    columns, theta and O per level; a random chemistry has no batch
    effect, so the donor correction still lands every PC at r >= 0.8."""
    meta, pcs, harmonized = pbmc
    rng = np.random.default_rng(0)
    meta = meta.copy()
    meta["chemistry"] = rng.choice(["v2", "v3"], size=len(meta))
    ho = ht.run_harmony(pcs, meta, ["donor", "chemistry"], mesh=cpu_mesh(8),
                        verbose=False, max_iter_harmony=2)
    B = meta["donor"].nunique() + meta["chemistry"].nunique()
    assert ho.Phi.shape[1] == B
    assert ho.theta.shape == (B,)
    assert ho.O.shape == (ho.K, B)
    cors = _correlations(ho.Z_corr, harmonized)
    assert np.all(cors >= 0.8), cors


def test_lambda_estimation(pbmc):
    """lamb=-1 estimates the ridge penalty from the data
    (tests/test_harmony_golden.py:121-128), 8 shards: every PC r >= 0.9."""
    meta, pcs, harmonized = pbmc
    ho = ht.run_harmony(pcs, meta, ["donor"], lamb=-1, mesh=cpu_mesh(8),
                        verbose=False)
    assert ho.lambda_estimation
    cors = _correlations(ho.Z_corr, harmonized)
    assert np.all(cors >= 0.9), cors


CASES = [
    # (N, d, B, nclust, n_devices, chunk_size or None for per-cell path,
    #  defer: None = library default (deferred on fused geometry)), as
    # tests/test_shapes_fuzz.py:14-25 lists them
    (173, 2, 2, 3, 1, None, None),      # tiny, prime N
    (515, 7, 4, 12, 8, None, None),     # N % n_devices != 0
    (1301, 3, 2, 5, 4, 8, None),        # fused deferred, tiny chunks, odd N
    (4000, 16, 5, 40, 2, 64, None),     # fused deferred, many clusters
    (1301, 3, 2, 5, 4, 8, False),       # stored-R fused, odd N
    (4000, 16, 5, 40, 2, 64, False),    # stored-R fused, many clusters
    (999, 1, 2, 4, 4, None, None),      # single PC
    (300, 6, 6, 2, 8, None, None),      # B > K
]


@pytest.mark.parametrize("N,d,B,nclust,ndev,chunk,defer", CASES)
def test_engine_shape_fuzz(N, d, B, nclust, ndev, chunk, defer):
    """One truncated fit of each shape (tests/test_shapes_fuzz.py:28-60):
    the path it asks for, finite Z_corr of its shape, R's rows summing to
    1, O summing to N and equal to R^T Phi, two or more finite harmony
    objectives; a fused fit on several shards bitwise its one-shard fit."""
    rng = np.random.default_rng(N + d)
    X = rng.normal(size=(N, d)).astype(np.float32)
    meta = pd.DataFrame({"b": rng.integers(0, B, N)})
    kwargs = dict(verbose=False, nclust=nclust, max_iter_harmony=2,
                  max_iter_kmeans=4)
    if chunk is not None:
        assert fused_geometry_ok(N, ndev, 0.05, chunk), (N, ndev, chunk)
        kwargs.update(chunk_size=chunk, defer_r=defer)
    else:
        kwargs.update(use_pallas=False)

    ho = ht.run_harmony(X, meta, ["b"], mesh=cpu_mesh(ndev), **kwargs)
    if chunk is not None:
        assert ho.cfg.fused_estep
        assert ho.cfg.defer_r == (defer is None or defer)
    Z = ho.Z_corr
    assert Z.shape == (N, d)
    assert np.all(np.isfinite(Z))
    R = ho.R
    assert R.shape == (N, nclust)
    np.testing.assert_allclose(R.sum(axis=1), 1.0, rtol=1e-3)
    np.testing.assert_allclose(ho.O.sum(), N, rtol=1e-3)
    np.testing.assert_allclose(ho.O, R.T @ ho.Phi, rtol=5e-3, atol=5e-2)
    assert len(ho.objective_harmony) >= 2
    assert np.all(np.isfinite(ho.objective_harmony))
    if chunk is not None and ndev > 1:
        one = ht.run_harmony(X, meta, ["b"], mesh=cpu_mesh(1), **kwargs)
        for a in ("Z_corr", "R", "objective_harmony", "objective_kmeans",
                  "kmeans_rounds"):
            assert np.array_equal(np.asarray(getattr(ho, a)),
                                  np.asarray(getattr(one, a))), a


@pytest.mark.parametrize("mik", [1, 2])
def test_tiny_max_iter_kmeans(mik):
    """max_iter_kmeans below the convergence window runs, stops on the
    harmony criterion and keeps the history lengths consistent
    (tests/test_robustness.py:109-123), 2 shards."""
    X, batches, _ = synthetic_batched(n_cells=500, d=8)
    meta = pd.DataFrame({"donor": [f"d{b}" for b in batches]})
    ho = ht.run_harmony(X, meta, ["donor"], mesh=cpu_mesh(2), verbose=False,
                        max_iter_harmony=3, max_iter_kmeans=mik)
    rounds = ho.kmeans_rounds
    assert all(1 <= r <= mik for r in rounds)
    assert len(ho.objective_kmeans) == 1 + sum(rounds)
    assert len(ho.objective_harmony) == 1 + len(rounds)
    assert np.all(np.isfinite(ho.Z_corr))
