"""The port's LISI on a device mesh, on the CPU: brute force with the
queries split over the shards, the pruned scan with the cluster batches
dealt out to them; both bitwise equal to one device (tests/test_lisi.py:
65-90, 278-294), and close to the JAX package's mesh LISI."""

import numpy as np
import pandas as pd
import pytest
import torch

# Test workers share the CPU cores with each other and with JAX's own
# thread pool: one intra-op thread each keeps torch from oversubscribing.
torch.set_num_threads(1)

import jax.numpy as jnp

import harmonypy_tpu as hm
from harmonypy_tpu.parallel.mesh import make_mesh as jax_mesh
import harmonypy_tpu_torch as ht
import harmonypy_tpu_torch.lisi as tlisi
import harmonypy_tpu_torch.ops.knn_pruned as tkp
from harmonypy_tpu_torch.parallel.mesh import make_mesh


def _blobby(rng, n, d, n_clumps=10, spread=6.0):
    centers = rng.normal(size=(n_clumps, d)) * spread
    return (centers[rng.integers(0, n_clumps, n)]
            + rng.normal(size=(n, d))).astype(np.float32)


def _meta(rng, n):
    return pd.DataFrame({"b": rng.choice(["x", "y", "z"], size=n),
                         "c": rng.choice(["u", "v"], size=n)})


@pytest.mark.parametrize("n_dev", [2, 3, 8])
def test_lisi_brute_on_a_mesh_is_one_device_bitwise(n_dev):
    """Queries split over the shards at an N no shard count divides:
    every query, the sampled ones and knn="approx" as on one device."""
    rng = np.random.default_rng(2)
    X = rng.normal(size=(403, 6)).astype(np.float32)
    meta = _meta(rng, 403)
    mesh = make_mesh(["cpu"] * n_dev)
    one = ht.compute_lisi(X, meta, ["b", "c"], device="cpu")
    np.testing.assert_array_equal(
        ht.compute_lisi(X, meta, ["b", "c"], mesh=mesh), one)
    v1, i1 = ht.compute_lisi(X, meta, ["b"], sample=101, device="cpu")
    vm, im = ht.compute_lisi(X, meta, ["b"], sample=101, mesh=mesh)
    np.testing.assert_array_equal(i1, im)
    np.testing.assert_array_equal(v1, vm)
    np.testing.assert_array_equal(
        ht.compute_lisi(X, meta, ["b"], knn="approx", mesh=mesh),
        ht.compute_lisi(X, meta, ["b"], knn="approx", device="cpu"))


def test_lisi_mesh_matches_jax_mesh():
    """The port on 4 shards against the JAX package on 4 devices."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(500, 5)).astype(np.float32)
    meta = _meta(rng, 500)
    port = ht.compute_lisi(X, meta, ["b", "c"], mesh=make_mesh(["cpu"] * 4))
    ref = hm.compute_lisi(X, meta, ["b", "c"], mesh=jax_mesh(n_devices=4))
    assert np.allclose(port, ref), np.abs(port - ref).max()


@pytest.mark.parametrize("n_dev", [2, 4])
def test_pruned_knn_on_a_mesh_is_one_device_bitwise(n_dev):
    """The cluster scan dealt out to the shards returns the one-device
    (dist, idx, cert) bit for bit: each cluster writes only its rows."""
    rng = np.random.default_rng(7)
    X = torch.as_tensor(_blobby(rng, 4000, 2))
    index = tkp.build_index(X, tkp.default_n_clusters(4000, 30))
    one = tkp.pruned_knn(X, 29, index=index, probe_min_cert=None)
    mesh = tkp.pruned_knn(X, 29, index=index, probe_min_cert=None,
                          mesh=make_mesh(["cpu"] * n_dev))
    for a, b in zip(one, mesh):
        assert torch.equal(a, b)


def test_pruned_lisi_on_a_mesh_is_one_device_bitwise(monkeypatch):
    """compute_lisi's exact path takes the pruned search (threshold lowered)
    with its probe and fallback; on 4 shards it is the one-device LISI bit
    for bit, and close to the brute force."""
    monkeypatch.setattr(tlisi, "_PRUNED_MIN_N", 1000)
    rng = np.random.default_rng(5)
    X = _blobby(rng, 3000, 4)
    meta = _meta(rng, 3000)
    one = ht.compute_lisi(X, meta, ["b", "c"], device="cpu")
    four = ht.compute_lisi(X, meta, ["b", "c"], mesh=make_mesh(["cpu"] * 4))
    np.testing.assert_array_equal(one, four)
    brute = ht.compute_lisi(X, meta, ["b", "c"], device="cpu", knn="brute")
    np.testing.assert_allclose(four, brute, rtol=1e-4, atol=1e-4)


def test_knn_batched_on_a_mesh_is_one_device_bitwise():
    """The brute kNN's query split keeps every row's values and ids."""
    rng = np.random.default_rng(9)
    X = torch.as_tensor(rng.normal(size=(700, 5)))
    q = torch.as_tensor(np.sort(rng.choice(700, 300, replace=False)))
    d1, i1 = tlisi._knn_batched(X[q], X, 20, qid=q)
    d4, i4 = tlisi._knn_batched(X[q], X, 20, qid=q,
                                mesh=make_mesh(["cpu"] * 4))
    assert torch.equal(d1, d4) and torch.equal(i1, i4)
    jd, _ = hm.lisi._knn_batched(jnp.asarray(X.numpy()[q.numpy()]),
                                 jnp.asarray(X.numpy()), 20, None,
                                 qid=jnp.asarray(q.numpy()))
    np.testing.assert_allclose(d4.numpy(), np.asarray(jd), rtol=1e-10)
