"""The port's cluster-pruned exact kNN on the CPU: its scan on the JAX
package's own index against the JAX pruned_knn, pruned against brute in
float32 and float64, and the behaviour tests of tests/test_lisi.py
(140-333): uncentered data, the fallback, the probe bail, auto-dispatch,
the balance split; plus determinism of the build and batch-independence
of the scan."""

import numpy as np
import pandas as pd
import pytest
import torch

# Test workers share the CPU cores with each other and with JAX's own
# thread pool: one intra-op thread each keeps torch from oversubscribing.
torch.set_num_threads(1)

import jax.numpy as jnp

import harmonypy_tpu.ops.knn_pruned as jkp
import harmonypy_tpu_torch as ht
import harmonypy_tpu_torch.lisi as tlisi
import harmonypy_tpu_torch.ops.knn_pruned as tkp
from test_torch_lisi import _blobby


def _assert_same_distances(pd_, bd_, X):
    """tests/test_lisi.py:126-137: squared distances agree within 1e-4 of
    the squared data radius."""
    R2 = float(np.max(np.sum((X - X.mean(0)) ** 2, axis=1)))
    np.testing.assert_allclose(np.asarray(pd_) ** 2, np.asarray(bd_) ** 2,
                               rtol=0, atol=1e-4 * R2)


def _ids(n):
    return torch.arange(n)


@pytest.mark.parametrize("n", [1, 7, 100, 999, 4000, 65_536, 858_000])
def test_default_n_clusters_equals_jax(n):
    for k in (1, 15, 30, 90, 150):
        assert tkp.default_n_clusters(n, k) == jkp.default_n_clusters(n, k)


@pytest.mark.parametrize("visit", [32, 3])
def test_scan_on_jax_index_matches_jax(visit):
    """The port's pruned_knn on the JAX package's own float64 index
    (index_from_numpy): distances within 1e-12 of the JAX pruned_knn and
    the same certificates; visit=3 leaves rows uncertified."""
    rng = np.random.default_rng(6)
    X = _blobby(rng, 3000, 3).astype(np.float64)
    jidx = jkp.build_index(jnp.asarray(X), jkp.default_n_clusters(3000, 30))
    jd, ji, jc = jkp.pruned_knn(jnp.asarray(X), 29, visit=visit,
                                index=jidx, probe_min_cert=None)
    index = tkp.index_from_numpy(*(np.asarray(f) for f in jidx))
    assert index.p_max == jidx.p_max
    td, ti, tc = tkp.pruned_knn(torch.tensor(X), 29, visit=visit,
                                index=index, probe_min_cert=None)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert np.mean(ti.numpy() == np.asarray(ji)) > 0.999
    if visit == 3:
        assert 0 < tc.float().mean() < 1


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pruned_knn_exact_vs_brute(dtype):
    """Pruned (certified rows plus the brute fallback) against brute:
    squared distances at the tolerance, ids equal except at near-ties, a
    healthy certification rate, and equal LISI."""
    rng = np.random.default_rng(6)
    X = _blobby(rng, 4000, 2).astype(dtype)
    Xt = torch.tensor(X)
    index = tkp.build_index(Xt, tkp.default_n_clusters(4000, 90))
    _, _, cert = tkp.pruned_knn(Xt, 89, index=index, probe_min_cert=None)
    assert float(cert.float().mean()) > 0.8
    pd_, pi_ = tlisi._knn_pruned(Xt, 89, _ids(4000))
    bd_, bi_ = tlisi._knn_batched(Xt, Xt, 89, qid=_ids(4000))
    _assert_same_distances(pd_.numpy(), bd_.numpy(), X)
    assert np.mean(pi_.numpy() == bi_.numpy()) > 0.999
    meta = pd.DataFrame({"b": rng.choice(["x", "y"], size=4000)})
    lb = ht.compute_lisi(X, meta, ["b"], knn="brute", device="cpu")
    lp = ht.compute_lisi(X, meta, ["b"], knn="pruned", device="cpu")
    np.testing.assert_allclose(lp, lb, rtol=1e-4, atol=1e-4)


def test_knn_uncentered_data_stays_exact():
    """Both kNN paths center internally: an embedding far from the origin
    still returns float64-true neighbor sets in float32."""
    rng = np.random.default_rng(12)
    X = _blobby(rng, 2000, 8) + 1024.0
    Xt = torch.tensor(X)
    pd_, pi_ = tlisi._knn_pruned(Xt, 29, _ids(2000))
    bd_, bi_ = tlisi._knn_batched(Xt, Xt, 29, qid=_ids(2000))
    m = 200
    X64 = X.astype(np.float64)
    d2 = ((X64[:m, None, :] - X64[None, :, :]) ** 2).sum(-1)
    d2[np.arange(m), np.arange(m)] = np.inf
    order = np.argsort(d2, axis=1)[:, :29]
    for name, ids in (("pruned", pi_), ("brute", bi_)):
        match = np.mean(ids.numpy()[:m] == order)
        assert match > 0.995, (name, match)


def test_pruned_knn_fallback_covers_uncertified():
    """visit=2 starves the candidates: some rows go uncertified, and the
    fallback brings every row to the brute values."""
    rng = np.random.default_rng(7)
    X = _blobby(rng, 3000, 6, n_clumps=8, spread=3.0)
    Xt = torch.tensor(X)
    index = tkp.build_index(Xt, tkp.default_n_clusters(3000, 46))
    _, _, cert = tkp.pruned_knn(Xt, 45, visit=2, index=index,
                                probe_min_cert=None)
    assert float(cert.float().mean()) < 1.0
    stats = {}
    pd_, _ = tlisi._knn_pruned(Xt, 45, _ids(3000), visit=2, stats=stats)
    assert stats["n_fallback"] > 0
    bd_, _ = tlisi._knn_batched(Xt, Xt, 45, qid=_ids(3000))
    _assert_same_distances(pd_.numpy(), bd_.numpy(), X)


def test_pruned_probe_bails_on_high_dim(monkeypatch):
    """On 32-d uniform data the probe certifies almost nothing and the
    pruned path bows out; compute_lisi then answers by brute force."""
    rng = np.random.default_rng(8)
    X = rng.uniform(size=(4000, 32)).astype(np.float32)
    monkeypatch.setattr(tkp, "_CLUSTER_BATCH", 8)  # C > batch: probe runs
    assert tlisi._knn_pruned(torch.tensor(X), 14, _ids(4000)) is None
    meta = pd.DataFrame({"b": rng.choice(["x", "y"], size=4000)})
    lb = ht.compute_lisi(X, meta, ["b"], perplexity=5, knn="brute",
                         device="cpu")
    lp = ht.compute_lisi(X, meta, ["b"], perplexity=5, knn="pruned",
                         device="cpu")
    np.testing.assert_allclose(lp, lb, rtol=1e-5, atol=1e-5)


def test_pruned_auto_dispatch_and_sample(monkeypatch):
    """knn='exact' takes the pruned search above _PRUNED_MIN_N (brute's
    values), and forced pruned composes with sample=."""
    rng = np.random.default_rng(9)
    X = _blobby(rng, 2500, 2)
    meta = pd.DataFrame({"b": rng.choice(["x", "y", "z"], size=2500)})
    brute = ht.compute_lisi(X, meta, ["b"], knn="brute", device="cpu")
    calls = []
    real = tlisi._knn_pruned
    monkeypatch.setattr(tlisi, "_knn_pruned",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(tlisi, "_PRUNED_MIN_N", 1000)
    auto = ht.compute_lisi(X, meta, ["b"], device="cpu")
    assert calls, "knn='exact' did not take the pruned search"
    np.testing.assert_allclose(auto, brute, rtol=1e-4, atol=1e-4)
    sampled, idx = ht.compute_lisi(X, meta, ["b"], knn="pruned", sample=300,
                                   random_state=3, device="cpu")
    np.testing.assert_allclose(sampled, brute[idx], rtol=1e-4, atol=1e-4)


def test_pruned_index_balance_split():
    """One dominant clump leaves an oversized Lloyd cluster; the balanced
    index caps p_max, stays a partition, and stays exact against brute."""
    rng = np.random.default_rng(9)
    n = 6000
    clump = rng.standard_normal((int(n * 0.7), 4)) * 0.3
    rest = _blobby(rng, n - clump.shape[0], 4, n_clumps=6)
    X = np.concatenate([clump, rest]).astype(np.float32)
    Xt = torch.tensor(X)
    C = tkp.default_n_clusters(n, 31)
    raw = tkp.build_index(Xt, C, balance=False)
    cap = max(tkp._BALANCE_MIN_CAP, int(np.ceil(tkp._BALANCE_FACTOR * n / C)))
    assert raw.p_max > cap, "geometry did not produce an oversized cluster"
    bal = tkp.build_index(Xt, C)
    assert bal.p_max <= cap
    assert int(bal.counts.sum()) == n
    assert np.array_equal(np.sort(bal.ids[:n].numpy()), np.arange(n))
    pd_, _ = tlisi._knn_pruned(Xt, 30, _ids(n))
    bd_, _ = tlisi._knn_batched(Xt, Xt, 30, qid=_ids(n))
    _assert_same_distances(pd_.numpy(), bd_.numpy(), X)


def test_scan_is_independent_of_the_batch_size(monkeypatch):
    """One cluster per scan batch and all clusters in one batch give the
    same (dist, idx, cert) bitwise: each cluster writes only its rows."""
    rng = np.random.default_rng(10)
    Xt = torch.tensor(_blobby(rng, 3000, 3))
    index = tkp.build_index(Xt, tkp.default_n_clusters(3000, 30))
    runs = []
    for slab in (1, 1 << 40):
        monkeypatch.setattr(tkp, "_SLAB_BYTES", slab)
        runs.append(tkp.pruned_knn(Xt, 29, visit=4, index=index))
    assert tkp.scan_batch_size(index, 4) > 1
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_build_index_is_deterministic():
    """One seed, one index, bitwise (no float atomics in the build)."""
    rng = np.random.default_rng(11)
    Xt = torch.tensor(_blobby(rng, 3000, 5).astype(np.float64))
    a = tkp.build_index(Xt, 64, seed=3)
    b = tkp.build_index(Xt, 64, seed=3)
    for f in ("Xs", "sqs", "ids", "starts", "counts", "centroids", "radii",
              "scale"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.p_max == b.p_max
    c = tkp.build_index(Xt, 64, seed=4)
    assert not torch.equal(a.ids, c.ids)
