"""The properties of tests/test_invariants.py, run on the port on the CPU:
O/E track R, theta=0, one batch level, auto-transpose, unused categorical
levels, the lamb / sigma errors, tau, numeric batch columns and
low_memory."""

import numpy as np
import pandas as pd
import pytest
import torch

# Test workers share the CPU cores with each other and with JAX's own
# thread pool: one intra-op thread each keeps torch from oversubscribing.
torch.set_num_threads(1)

import harmonypy_tpu_torch as ht
from harmonypy_tpu_torch.config import EngineConfig
from harmonypy_tpu_torch.ops.partition import (cell_partition_len,
                                               cell_slot_table, iid_blocks)
from harmonypy_tpu_torch.ops.update_r import update_r
from harmonypy_tpu_torch.state import HarmonyParams

from conftest import synthetic_batched


def _run(X, meta, **kw):
    return ht.run_harmony(X, meta, ["donor"], device="cpu", verbose=False,
                          **kw)


@pytest.fixture(scope="module")
def problem():
    X, batches, _ = synthetic_batched(n_cells=700, d=9)
    meta = pd.DataFrame({"donor": [f"d{b}" for b in batches]})
    return X, meta


@pytest.mark.parametrize("kw", [dict(), dict(chunk_size=32, defer_r=False),
                                dict(chunk_size=32)])
def test_state_invariants(problem, kw):
    """O/E track R; R rows are distributions; E and O have the same cluster
    masses. The per-cell, stored fused and deferred fits."""
    X, meta = problem
    ho = _run(X, meta, max_iter_harmony=3, **kw)
    R, Phi = ho.R.T, ho.Phi.T
    np.testing.assert_allclose(ho.O, R @ Phi.T, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(
        ho.E, np.outer(R.sum(axis=1), ho.Pr_b), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(R.sum(axis=0), 1.0, rtol=1e-4)
    np.testing.assert_allclose(ho.O.sum(axis=1), ho.E.sum(axis=1),
                               rtol=1e-3, atol=1e-3)


def test_theta_zero_disables_diversity():
    """theta=0 makes the E-step plain soft k-means: the updated R equals
    softmax(-dist/sigma) whatever O/E and the block order (reference
    update_R with (E/(O+E))^0 == 1, harmony.py:495-499)."""
    rng = np.random.default_rng(0)
    N, d, K, B = 512, 6, 9, 3
    cfg = EngineConfig(N=N, d=d, K=K, B=B, n_devices=1, block_size=0.2)
    Z = rng.normal(size=(d, N)).astype(np.float32)
    Z /= np.linalg.norm(Z, axis=0)
    Y = rng.normal(size=(d, K)).astype(np.float32)
    Y /= np.linalg.norm(Y, axis=0)
    dist = 2.0 * (1.0 - Y.T @ Z)
    batch = rng.integers(0, B, N)
    Phi = (batch[None, :] == np.arange(B)[:, None]).astype(np.float32)
    s = np.exp(-dist / 0.1)
    R0 = (s / s.sum(0)).astype(np.float32)
    E = np.outer(R0.sum(1), Phi.sum(1) / N).astype(np.float32)
    O = (R0 @ Phi.T).astype(np.float32)
    params = HarmonyParams(
        theta=torch.zeros(B), sigma=torch.full((K,), 0.1),
        lamb=torch.zeros(B + 1), Pr_b=torch.tensor(Phi.sum(1) / N))
    gen = torch.Generator()
    gen.manual_seed(0)
    slots = cell_slot_table(iid_blocks(gen, N, cell_partition_len(cfg),
                                       cfg.n_blocks), cfg)
    R_in = torch.full((K, N), 1.0 / K)                # far from the fixed point
    R2, _, _ = update_r(slots, R_in, torch.tensor(dist), torch.tensor(Phi),
                        torch.tensor(E), torch.tensor(O), params, cfg,
                        torch.ones(N))
    np.testing.assert_allclose(R2.numpy(), s / s.sum(0), atol=2e-5)


def test_single_batch_noop_mixing(problem):
    """With one batch level O == E: nothing to diversify."""
    X, _ = problem
    meta = pd.DataFrame({"donor": ["a"] * X.shape[0]})
    ho = _run(X, meta, max_iter_harmony=2)
    np.testing.assert_allclose(ho.O, ho.E, rtol=1e-3, atol=1e-3)


def test_orientation_autotranspose(problem):
    """(N, d) and (d, N) inputs give identical results (reference
    harmony.py:117-121)."""
    X, meta = problem
    a = _run(X, meta, max_iter_harmony=2).Z_corr
    b = _run(X.T, meta, max_iter_harmony=2).Z_corr
    np.testing.assert_array_equal(a, b)


def test_shape_mismatch_raises(problem):
    X, meta = problem
    with pytest.raises(AssertionError, match="same number of cells"):
        ht.run_harmony(X[:-5], meta, ["donor"], device="cpu")


@pytest.mark.parametrize("lamb", [None, -1])
def test_unused_categorical_levels(problem, lamb):
    """A pd.Categorical with an unused level keeps theta / Phi shapes
    consistent, with a fixed or a dynamic ridge (whose floor keeps the
    systems regular for the empty level)."""
    X, meta = problem
    meta = meta.copy()
    meta["donor"] = pd.Categorical(
        meta["donor"], categories=sorted(meta["donor"].unique()) + ["ghost"])
    ho = _run(X, meta, max_iter_harmony=2, lamb=lamb)
    B = len(meta["donor"].cat.categories)
    assert ho.Phi.shape[1] == B
    assert ho.theta.shape == (B,)
    assert np.all(np.isfinite(ho.Z_corr))
    assert np.all(np.isfinite(ho.objective_harmony))


@pytest.mark.parametrize("kw,match", [
    (dict(lamb=[1.0, 1.0]), "lamb"),        # 3 levels, 2 entries
    (dict(lamb=0), "positive"),             # singular ridge
    (dict(sigma=[0.1, 0.2]), "sigma"),      # neither scalar nor K
])
def test_malformed_arguments_raise(problem, kw, match):
    X, meta = problem
    with pytest.raises(ValueError, match=match):
        _run(X, meta, **kw)


def test_tau_discounts_theta(problem):
    """tau > 0 applies 1 - exp(-(N_b/(K*tau))^2) to theta (reference
    harmony.py:172-173)."""
    X, meta = problem
    ho0 = _run(X, meta, max_iter_harmony=1)
    ho_tau = _run(X, meta, max_iter_harmony=1, tau=50)
    N_b = ho_tau.Phi.sum(axis=0)
    expected = ho0.theta * (1 - np.exp(-(N_b / (ho_tau.K * 50)) ** 2))
    np.testing.assert_allclose(ho_tau.theta, expected, rtol=1e-5)
    assert np.all(ho_tau.theta < ho0.theta)


def test_numeric_batch_column(problem):
    """Integer batch columns give the results of the equivalent labels."""
    X, meta = problem
    codes = pd.Categorical(meta["donor"]).codes
    meta_num = pd.DataFrame({"donor": codes.astype(np.int64)})
    a = _run(X, meta, max_iter_harmony=2).Z_corr
    b = _run(X, meta_num, max_iter_harmony=2).Z_corr
    np.testing.assert_array_equal(a, b)


def test_low_memory_mode(problem):
    """bfloat16 R: the same correction quality and mixing, a float32 .R."""
    X, meta = problem
    a = _run(X, meta, max_iter_harmony=3)
    b = _run(X, meta, max_iter_harmony=3, low_memory=True)
    assert b.cfg.r_dtype == "bfloat16"
    assert np.all(np.isfinite(b.Z_corr))
    assert b.R.dtype == np.float32
    np.testing.assert_allclose(b.R.sum(axis=1), 1.0, atol=5e-3)
    corr = np.corrcoef(a.Z_corr.ravel(), b.Z_corr.ravel())[0, 1]
    assert corr > 0.995, corr
    l_a = ht.compute_lisi(a.Z_corr, meta, ["donor"], device="cpu").mean()
    l_b = ht.compute_lisi(b.Z_corr, meta, ["donor"], device="cpu").mean()
    assert abs(l_a - l_b) < 0.1, (l_a, l_b)
