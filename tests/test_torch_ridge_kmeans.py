"""The port's ridge solve against the JAX package's solve_w and the numpy
oracle, and its k-means seeding quality against the JAX package's seeding
and sklearn, at the ratios of tests/test_kernels.py:178-300."""

import numpy as np
import pytest
import torch

# Test workers share the CPU cores with each other and with JAX's own
# thread pool: one intra-op thread each keeps torch from oversubscribing.
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from harmonypy_tpu.config import EngineConfig as JConfig
from harmonypy_tpu.ops import kmeans as jk
from harmonypy_tpu.ops.ridge import solve_w as j_solve_w
from harmonypy_tpu.state import HarmonyParams as JParams
from harmonypy_tpu_torch.config import EngineConfig as TConfig
from harmonypy_tpu_torch.ops import kmeans as tk
from harmonypy_tpu_torch.ops.ridge import solve_w
from harmonypy_tpu_torch.state import HarmonyParams

import oracle


def _ridge_problem(N=400, d=6, K=7, B=3, seed=1):
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(d, N)).astype(np.float32)
    batch = rng.integers(0, B, size=N)
    Phi = (batch[None, :] == np.arange(B)[:, None]).astype(np.float32)
    R = rng.random(size=(K, N)).astype(np.float32)
    R /= R.sum(axis=0, keepdims=True)
    E = np.outer(R.sum(axis=1), Phi.sum(1) / N).astype(np.float32)
    A = np.vstack([np.ones((1, N), np.float32), Phi])           # Phi_moe
    B1 = B + 1
    cov = np.einsum("bn,cn,kn->bck", A, A, R).reshape(B1 * B1, K)
    rhs = np.einsum("bn,xn,kn->bxk", A, Z, R).reshape(B1 * d, K)
    S = np.concatenate([cov, rhs]).astype(np.float32)
    lamb = np.concatenate([[0.0], np.ones(B)]).astype(np.float32)
    return dict(Z=Z, Phi=Phi, R=R, E=E, A=A, S=S, lamb=lamb, N=N, d=d, K=K,
                B=B)


@pytest.mark.parametrize("lambda_estimation", [False, True])
def test_solve_w_matches_jax_and_oracle(lambda_estimation):
    p = _ridge_problem()
    kw = dict(N=p["N"], d=p["d"], K=p["K"], B=p["B"], n_devices=1,
              lambda_estimation=lambda_estimation)
    theta, sigma = np.full(p["B"], 2.0, np.float32), np.full(p["K"], 0.1,
                                                             np.float32)
    Pr_b = (p["Phi"].sum(1) / p["N"]).astype(np.float32)
    jparams = JParams(*(jnp.asarray(x) for x in (theta, sigma, p["lamb"],
                                                 Pr_b)))
    tparams = HarmonyParams(*(torch.as_tensor(x) for x in (theta, sigma,
                                                           p["lamb"], Pr_b)))
    W_j = np.asarray(j_solve_w(jnp.asarray(p["S"]), jnp.asarray(p["E"]),
                               jparams, JConfig(**kw)))
    W_t = solve_w(torch.as_tensor(p["S"]), torch.as_tensor(p["E"]), tparams,
                  TConfig(**kw)).numpy()
    np.testing.assert_allclose(W_t, W_j, rtol=1e-5, atol=1e-6)
    assert np.all(W_t[:, 0, :] == 0.0)

    Z_corr = p["Z"] - np.einsum("kbx,bn,kn->xn", W_t, p["A"], p["R"])
    ref = oracle.ridge_correct(p["Z"], p["Phi"], p["R"], p["E"], p["lamb"],
                               0.2, lambda_estimation)
    np.testing.assert_allclose(Z_corr, ref, rtol=2e-4, atol=2e-4)


def _blobs(S=4096, d=8, K=16, seed=0):
    rng = np.random.default_rng(seed)
    centers = (rng.standard_normal((d, K)) * 2.0).astype(np.float32)
    return (centers[:, rng.integers(0, K, S)]
            + rng.standard_normal((d, S)).astype(np.float32))


def _potential(C, X):
    d2 = ((X[:, :, None] - C[:, None, :]) ** 2).sum(0)
    return float(d2.min(axis=1).mean())


def test_kmeanspp_quality_vs_jax_and_sklearn():
    """test_kernels.py:178-204: within 1.15x of sklearn's inertia, and of
    the JAX package's greedy k-means++ + Lloyd on the same data."""
    from sklearn.cluster import KMeans
    rng = np.random.default_rng(0)
    X = rng.normal(size=(400, 5)).astype(np.float32)
    X[:100] += 4.0
    X[100:200] -= 4.0
    Xn = (X / np.linalg.norm(X, axis=1, keepdims=True)).T.astype(np.float32)
    K = 8
    tc = TConfig(N=400, d=5, K=K, B=2, n_devices=1)
    jc = JConfig(N=400, d=5, K=K, B=2, n_devices=1)
    C_t = tk.lloyd(tk.kmeanspp_seed(torch.Generator().manual_seed(0),
                                    torch.as_tensor(Xn), tc),
                   torch.as_tensor(Xn), tc).numpy()
    C_j = np.asarray(jk._lloyd(jk._kmeanspp_seed(jax.random.PRNGKey(0),
                                                 jnp.asarray(Xn), jc),
                               jnp.asarray(Xn), jc))
    sk = KMeans(n_clusters=K, init="k-means++", n_init=1, max_iter=25,
                random_state=0).fit(Xn.T)
    ours = _potential(C_t, Xn) * Xn.shape[1]
    assert ours <= sk.inertia_ * 1.15, (ours, sk.inertia_)
    assert ours <= _potential(C_j, Xn) * Xn.shape[1] * 1.15


def test_kmeansbb_quality_vs_jax_exact_topk():
    """k-means|| (exact top-k) + Lloyd against the JAX package's
    exact_topk=True variant (test_kernels.py:300-326) and the port's own
    greedy k-means++ on the same sample."""
    X = _blobs()
    S, d = X.shape[1], X.shape[0]
    tc = TConfig(N=S, d=d, K=16, B=3, n_devices=1)
    jc = JConfig(N=S, d=d, K=16, B=3, n_devices=1)
    Xt = torch.as_tensor(X)
    p_bb = _potential(tk.lloyd(tk.kmeansbb_seed(
        torch.Generator().manual_seed(0), Xt, tc), Xt, tc).numpy(), X)
    p_pp = _potential(tk.lloyd(tk.kmeanspp_seed(
        torch.Generator().manual_seed(0), Xt, tc), Xt, tc).numpy(), X)
    p_j = _potential(np.asarray(jk._lloyd(jk._kmeansbb_seed(
        jax.random.PRNGKey(0), jnp.asarray(X), jc, exact_topk=True),
        jnp.asarray(X), jc)), X)
    assert p_bb <= p_j * 1.15, (p_bb, p_j)
    assert p_bb <= p_pp * 1.15, (p_bb, p_pp)


def test_kmeans_init_uses_sample_above_cap():
    """Above kmeanspp_sample cells the port seeds with k-means|| on a sample
    drawn with replacement; the same generator state gives the same
    centroids."""
    X = _blobs(S=3000)
    tc = TConfig(N=3000, d=8, K=16, B=3, n_devices=1, kmeanspp_sample=1024)
    Xt = torch.as_tensor(X / np.linalg.norm(X, axis=0))

    def run(seed):
        return tk.kmeans_init(torch.Generator().manual_seed(seed), Xt, tc)

    a, b, c = run(1), run(1), run(2)
    assert a.shape == (8, 16) and torch.isfinite(a).all()
    assert torch.equal(a, b) and not torch.equal(a, c)
