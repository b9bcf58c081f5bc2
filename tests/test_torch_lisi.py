"""The port's LISI on the CPU: the R fixture, the JAX package's
compute_lisi / compute_simpson / _drop_self_by_id on the same inputs, the
brute kNN against the JAX one in float32 and float64, and the behaviour
tests of tests/test_lisi.py on the port."""

import numpy as np
import pandas as pd
import pytest
import torch

# Test workers share the CPU cores with each other and with JAX's own
# thread pool: one intra-op thread each keeps torch from oversubscribing.
torch.set_num_threads(1)

import jax.numpy as jnp

import harmonypy_tpu as hm
import harmonypy_tpu.lisi as jlisi
import harmonypy_tpu_torch as ht
import harmonypy_tpu_torch.lisi as tlisi


def _lisi(X, meta, labels, **kw):
    return ht.compute_lisi(X, meta, labels, device="cpu", **kw)


def _blobby(rng, n, d, n_clumps=10, spread=6.0):
    centers = rng.normal(size=(n_clumps, d)) * spread
    return (centers[rng.integers(0, n_clumps, n)]
            + rng.normal(size=(n, d))).astype(np.float32)


def test_lisi_golden(ref_data_dir):
    """tests/test_lisi.py:10 on the port: the R LISI package's output on
    the bundled 400-cell fixture, at np.allclose's default tolerances."""
    X = pd.read_csv(f"{ref_data_dir}/lisi_x.tsv.gz", sep="\t")
    metadata = pd.read_csv(f"{ref_data_dir}/lisi_metadata.tsv.gz", sep="\t")
    lisi = _lisi(X, metadata, metadata.columns, perplexity=30)
    lisi_ref = pd.read_csv(f"{ref_data_dir}/lisi_lisi.tsv.gz", sep="\t")
    lisi_ref = lisi_ref.iloc[:, -2:].to_numpy()
    assert np.allclose(lisi, lisi_ref), np.abs(lisi - lisi_ref).max()


@pytest.mark.parametrize("knn", ["brute", "exact", "pruned"])
def test_lisi_matches_jax(knn):
    """The port against harmonypy_tpu.compute_lisi on the same data, two
    label columns, np.allclose at default tolerances."""
    rng = np.random.default_rng(11)
    X = _blobby(rng, 1500, 4)
    meta = pd.DataFrame({"b": rng.choice(["x", "y", "z"], size=1500),
                         "c": rng.choice(["u", "v"], size=1500)})
    port = _lisi(X, meta, ["b", "c"], knn=knn)
    ref = hm.compute_lisi(X, meta, ["b", "c"], knn=knn)
    assert port.shape == ref.shape == (1500, 2)
    assert np.allclose(port, ref), np.abs(port - ref).max()


def test_compute_simpson_matches_jax():
    """The reference-compatible entry on identical (k, N) distances and
    indices, rtol 1e-9; includes a cell whose distances are all huge
    (H == 0 -> simpson - 1)."""
    rng = np.random.default_rng(3)
    k, N, C = 20, 300, 4
    dist = rng.uniform(0.1, 3.0, size=(k, N))
    dist[:, 7] = 1e4
    idx = rng.integers(0, N, size=(k, N))
    labels = pd.Categorical(rng.choice(list("abcd"), size=N))
    port = tlisi.compute_simpson(dist, idx, labels, C, 10.0, device="cpu")
    ref = jlisi.compute_simpson(dist, idx, labels, C, 10.0)
    np.testing.assert_allclose(port, ref, rtol=1e-9)


def test_drop_self_by_id_matches_jax():
    """Bitwise against the JAX rule, self present at varied positions and
    absent (then the worst candidate goes)."""
    rng = np.random.default_rng(4)
    M, k = 64, 9
    idx = np.stack([rng.permutation(200)[:k] for _ in range(M)])
    qid = np.where(rng.random(M) < 0.7,
                   idx[np.arange(M), rng.integers(0, k, M)], 500 + np.arange(M))
    dist = np.sort(rng.random((M, k)), axis=1)
    pd_, pi_ = tlisi._drop_self_by_id(torch.tensor(dist), torch.tensor(idx),
                                      torch.tensor(qid))
    jd, ji = jlisi._drop_self_by_id(jnp.asarray(dist), jnp.asarray(idx),
                                    jnp.asarray(qid))
    np.testing.assert_array_equal(pd_.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(pi_.numpy(), np.asarray(ji))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_brute_knn_matches_jax(dtype):
    """_knn_batched against the JAX one in the input's dtype: distances at
    the dtype's rounding of the squared data radius, ids equal except at
    near-ties."""
    rng = np.random.default_rng(5)
    X = _blobby(rng, 700, 5).astype(dtype)
    qid = np.arange(700)
    pd_, pi_ = tlisi._knn_batched(torch.tensor(X), torch.tensor(X), 29,
                                  qid=torch.tensor(qid))
    jd, ji = jlisi._knn_batched(jnp.asarray(X), jnp.asarray(X), 29, None,
                                qid=jnp.asarray(qid, jnp.int32))
    assert pd_.dtype == torch.from_numpy(X).dtype
    R2 = float(np.max(np.sum((X - X.mean(0)) ** 2, axis=1)))
    tol = (1e-4 if dtype == np.float32 else 1e-12) * R2
    np.testing.assert_allclose(pd_.numpy() ** 2, np.asarray(jd) ** 2,
                               rtol=0, atol=tol)
    assert np.mean(pi_.numpy() == np.asarray(ji)) > 0.999


def test_knn_keeps_the_callers_tf32_setting():
    """A float32 kNN runs its products in full float32 and restores the
    caller's matmul precision on exit."""
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        X = torch.randn(300, 3)
        tlisi._knn_impl(X, X, 10)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(saved)


def test_lisi_bounds():
    """LISI is within [1, n_categories] for well-defined inputs."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(300, 4))
    meta = pd.DataFrame({"b": rng.choice(["x", "y", "z"], size=300)})
    lisi = _lisi(X, meta, ["b"], perplexity=20)
    assert lisi.shape == (300, 1)
    assert np.all(lisi >= 1.0 - 1e-6)
    assert np.all(lisi <= 3.0 + 1e-6)


def test_lisi_separated_batches():
    """Perfectly separated batches -> LISI ~= 1; mixed -> ~= 2."""
    rng = np.random.default_rng(1)
    n = 200
    X_sep = np.concatenate([rng.normal(size=(n, 2)),
                            rng.normal(size=(n, 2)) + 100.0])
    X_mix = rng.normal(size=(2 * n, 2))
    meta = pd.DataFrame({"b": ["a"] * n + ["b"] * n})
    assert np.all(_lisi(X_sep, meta, ["b"]) < 1.1)
    rng.shuffle(X_mix)
    assert _lisi(X_mix, meta, ["b"]).mean() > 1.8


def test_lisi_sampled_matches_full():
    """Sampled-query LISI values equal the matching rows of the full
    computation, and sample >= N still returns (values, indices)."""
    rng = np.random.default_rng(2)
    X = rng.normal(size=(500, 5))
    meta = pd.DataFrame({"b": rng.choice(["x", "y"], size=500)})
    full = _lisi(X, meta, ["b"], perplexity=15)
    sampled, idx = _lisi(X, meta, ["b"], perplexity=15, sample=120,
                         random_state=7)
    assert sampled.shape == (120, 1) and idx.shape == (120,)
    np.testing.assert_allclose(sampled, full[idx], rtol=1e-6, atol=1e-8)
    # The JAX package draws the same query rows from the same seed.
    _, jidx = hm.compute_lisi(X, meta, ["b"], perplexity=15, sample=120,
                              random_state=7)
    np.testing.assert_array_equal(idx, jidx)
    out, idx_all = _lisi(X, meta, ["b"], perplexity=15, sample=500)
    np.testing.assert_allclose(out, full)
    np.testing.assert_array_equal(idx_all, np.arange(500))


def test_lisi_tiled_knn_matches_single_tile(monkeypatch):
    """The two-stage tiled kNN (per-tile top-k, then a merge top-k) gives
    the one-slab values, with a partial final tile."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(530, 5)).astype(np.float32)
    meta = pd.DataFrame({"b": rng.choice(["x", "y", "z"], size=530)})
    full = _lisi(X, meta, ["b"])
    monkeypatch.setattr(tlisi, "_KNN_TILE", 128)  # 5 tiles, the last partial
    tiled = _lisi(X, meta, ["b"])
    np.testing.assert_allclose(tiled, full, rtol=1e-5, atol=1e-6)


def test_lisi_query_batching_matches_one_shot(monkeypatch):
    """Host query batches (the last one short) give the one-shot values
    bitwise."""
    rng = np.random.default_rng(4)
    X = rng.normal(size=(333, 4)).astype(np.float32)
    meta = pd.DataFrame({"b": rng.choice(["x", "y"], size=333)})
    full = _lisi(X, meta, ["b"])
    monkeypatch.setattr(tlisi, "_KNN_BATCH", 100)
    np.testing.assert_array_equal(_lisi(X, meta, ["b"]), full)


def test_lisi_approx_is_exact():
    """knn='approx' is answered by the exact top-k: the exact values, at
    any valid recall target."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(500, 6)).astype(np.float32)
    meta = pd.DataFrame({"b": rng.choice(["x", "y", "z"], size=500)})
    exact = _lisi(X, meta, ["b"])
    for rt in (0.5, 0.95, 1.0):
        np.testing.assert_array_equal(
            _lisi(X, meta, ["b"], knn="approx", knn_recall_target=rt), exact)


@pytest.mark.parametrize("kw,match", [
    (dict(knn="fancy"), "approx"),
    (dict(knn="approx", knn_recall_target=0.0), "knn_recall_target"),
    (dict(knn="approx", knn_recall_target=1.5), "knn_recall_target"),
])
def test_lisi_argument_errors(kw, match):
    X = np.random.default_rng(0).normal(size=(100, 3))
    meta = pd.DataFrame({"b": ["x", "y"] * 50})
    with pytest.raises(ValueError, match=match):
        _lisi(X, meta, ["b"], **kw)


def test_lisi_device_and_mesh():
    """device=None means every CUDA card and raises without one; mesh=
    takes a parallel.mesh.Mesh and refuses anything else naming it; a torch
    tensor stays on its own device."""
    X = np.random.default_rng(0).normal(size=(120, 3))
    meta = pd.DataFrame({"b": ["x", "y"] * 60})
    with pytest.raises(TypeError, match="Mesh"):
        _lisi(X, meta, ["b"], mesh=object())
    np.testing.assert_array_equal(
        ht.compute_lisi(torch.tensor(X), meta, ["b"]), _lisi(X, meta, ["b"]))
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ht.compute_lisi(X, meta, ["b"])
