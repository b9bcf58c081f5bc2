"""The port's deferred-R fit end to end on the CPU: an exact trajectory
against the JAX package with its init and partitions injected, the golden
pbmc gate, seeds, a JAX fit's state carried across, device selection, the
configurations of the stored-R slice as the JAX package resolves them, the
unported configurations, and the import boundary."""

import os
import re
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

# Test workers share the CPU cores with each other and with JAX's own
# thread pool: one intra-op thread each keeps torch from oversubscribing.
torch.set_num_threads(1)

import jax

import harmonypy_tpu as hm
from harmonypy_tpu.ops.partition import partition_geometry, stripe_blocks
from harmonypy_tpu.parallel.mesh import make_mesh
import harmonypy_tpu_torch as ht
from harmonypy_tpu_torch.api import materialize_r
from harmonypy_tpu_torch.layout import pad_cells, shard_mask
from harmonypy_tpu_torch.state import (HarmonyData, HarmonyParams,
                                       state_from_numpy)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0


def _problem(N=5000, d=10, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(6, d)) * 4
    g = rng.integers(0, 6, N)
    b = rng.integers(0, 3, N)
    shifts = rng.normal(size=(3, d)) * 2
    X = (centers[g] + shifts[b] + rng.normal(size=(N, d))).astype(np.float32)
    return X, pd.DataFrame({"batch": [f"b{i}" for i in b]})


@pytest.fixture(scope="module")
def jax_fit():
    """One deferred-R JAX fit (1 device, chunk_size=128, one harmony
    iteration), its init centroids and its per-round block assignments,
    derived from the JAX key splits (api.py:394, engine.py:209, 548)."""
    X, meta = _problem()
    ho = hm.run_harmony(X, meta, ["batch"], mesh=make_mesh(n_devices=1),
                        verbose=False, chunk_size=128, max_iter_harmony=1,
                        random_state=SEED)
    assert ho.cfg.defer_r and not ho.cfg.use_pallas
    st0 = ho._engine.init_fn(ho._data, ho._params, jax.random.PRNGKey(SEED))
    geom = partition_geometry(ho.cfg)
    key, _ = jax.random.split(jax.random.PRNGKey(SEED))
    blocks = []
    for _ in range(ho.cfg.max_iter_kmeans * ho.cfg.max_iter_harmony):
        key, k_r = jax.random.split(key)
        blocks.append(np.array(stripe_blocks(k_r, geom.NC_fixed, geom.L,
                                             geom.nb)))
    return X, meta, ho, np.array(st0.Y), blocks


def test_exact_trajectory_with_injected_init_and_partitions(jax_fit):
    X, meta, ho_j, Y0, blocks = jax_fit
    ho_t = ht.run_harmony(X, meta, ["batch"], device="cpu", verbose=False,
                          chunk_size=128, max_iter_harmony=1,
                          _init_Y=Y0, _blocks_fn=lambda i: blocks[i])
    assert ho_t.kmeans_rounds == ho_j.kmeans_rounds
    np.testing.assert_allclose(ho_t.objective_kmeans, ho_j.objective_kmeans,
                               rtol=1e-4)
    np.testing.assert_allclose(ho_t.objective_harmony,
                               ho_j.objective_harmony, rtol=1e-4)
    np.testing.assert_allclose(ho_t.Z_corr, ho_j.Z_corr, atol=1e-4)


def test_state_carried_across_gives_jax_R(jax_fit):
    """A JAX fit's state, as numpy arrays, through state_from_numpy: the
    port's replayed .R equals the JAX package's."""
    _, _, ho_j, _, _ = jax_fit
    arrays = {k: np.asarray(v) for k, v in ho_j.state._asdict().items()}
    geom = partition_geometry(ho_j.cfg)
    rep_blocks = np.array(stripe_blocks(ho_j.state.rep_key, geom.NC_fixed,
                                        geom.L, geom.nb))
    cfg = ht.api.EngineConfig(
        N=ho_j.N, d=ho_j.d, K=ho_j.K, B=ho_j.B, n_devices=1,
        use_fused_xla=True, defer_r=True, chunk_size=ho_j.cfg.chunk_size,
        max_iter_harmony=1)
    st = state_from_numpy(arrays, cfg, rep_blocks, device="cpu")

    def t(x):
        return torch.tensor(np.asarray(x, np.float32))

    data = HarmonyData(Z_orig=t(pad_cells(ho_j.Z_orig.T, cfg)),
                       Phi=t(pad_cells(ho_j.Phi.T, cfg)),
                       mask=t(shard_mask(cfg)))
    params = HarmonyParams(theta=t(ho_j.theta), sigma=t(ho_j.sigma),
                           lamb=t(np.asarray(ho_j._params.lamb)),
                           Pr_b=t(ho_j.Pr_b))
    R_t = materialize_r(cfg, st, data, params)
    np.testing.assert_allclose(R_t, ho_j.R, atol=1e-5)
    assert st.kmeans_rounds == ho_j.kmeans_rounds


def _correlations(Z_corr, harmonized):
    harm = harmonized
    if harm.iloc[:, 0].dtype == "object":
        harm = harm.iloc[:, 1:]
    return np.array([np.corrcoef(Z_corr[:, i], harm.iloc[:, i].values)[0, 1]
                     for i in range(Z_corr.shape[1])])


@pytest.fixture(scope="module")
def pbmc_fit(pbmc):
    meta, pcs, _ = pbmc
    return ht.run_harmony(pcs, meta, ["donor"], device="cpu", verbose=False,
                          chunk_size=128)


def test_golden_pbmc_chunk128(pbmc, pbmc_fit):
    """tests/test_harmony_golden.py:49-61 on the port."""
    _, _, harmonized = pbmc
    assert pbmc_fit.cfg.defer_r and pbmc_fit.cfg.chunk_size == 128
    cors = _correlations(pbmc_fit.Z_corr, harmonized)
    assert np.all(cors >= 0.99), cors
    obj = pbmc_fit.objective_harmony
    assert obj[-1] < obj[0]
    assert len(pbmc_fit.kmeans_rounds) == len(obj) - 1
    assert len(pbmc_fit.objective_kmeans) == 1 + sum(pbmc_fit.kmeans_rounds)


def test_result_shapes_and_properties(pbmc, pbmc_fit):
    """tests/test_harmony_golden.py:75-98 on the port's 13 properties."""
    meta, pcs, _ = pbmc
    ho = pbmc_fit
    N, d = pcs.shape
    B = meta["donor"].nunique()
    assert ho.Z_corr.shape == ho.Z_orig.shape == ho.Z_cos.shape == (N, d)
    assert ho.R.shape == (N, ho.K)
    assert ho.Y.shape == (d, ho.K)
    assert ho.O.shape == ho.E.shape == (ho.K, B)
    assert ho.Phi.shape == (N, B) and ho.Phi_moe.shape == (N, B + 1)
    assert ho.Pr_b.shape == (B,) and ho.theta.shape == (B,)
    assert ho.sigma.shape == (ho.K,) and ho.lamb.shape == (B + 1,)
    np.testing.assert_allclose(ho.Pr_b.sum(), 1.0, rtol=1e-5)
    np.testing.assert_array_equal(ho.result(), ho.Z_corr)
    np.testing.assert_allclose(ho.R.sum(axis=1), 1.0, rtol=1e-4)
    np.testing.assert_allclose(ho.R.T @ ho.Phi, ho.O, rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(np.linalg.norm(ho.Z_cos, axis=1), 1.0,
                               rtol=1e-5)
    for h in (ho.objective_kmeans_dist, ho.objective_kmeans_entropy,
              ho.objective_kmeans_cross):
        assert len(h) == len(ho.objective_kmeans)


def test_seeds():
    X, meta = _problem(N=3000, d=6, seed=1)

    def run(seed):
        return ht.run_harmony(X, meta, ["batch"], device="cpu",
                              verbose=False, chunk_size=128,
                              max_iter_harmony=2, random_state=seed).Z_corr

    np.testing.assert_array_equal(run(7), run(7))
    assert np.abs(run(7) - run(8)).sum() > 1.0


def test_device_none_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, meta = _problem(N=3000, d=6)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ht.run_harmony(X, meta, ["batch"], verbose=False, chunk_size=128)
    with pytest.raises(RuntimeError):
        ht.run_harmony(X, meta, ["batch"], verbose=False, chunk_size=128,
                       device="cuda")


def _jax_cfg(monkeypatch, X, meta, **kw):
    """The EngineConfig the JAX package resolves for these arguments, taken
    where its Harmony builds the engine, before any fit runs."""
    import harmonypy_tpu.api as japi

    class _Resolved(Exception):
        pass

    def stop(cfg, mesh):
        raise _Resolved(cfg)

    monkeypatch.setattr(japi, "get_engine", stop)
    with pytest.raises(_Resolved) as exc:
        hm.run_harmony(X, meta, ["batch"], mesh=make_mesh(n_devices=1), **kw)
    return exc.value.args[0]


@pytest.mark.parametrize("kw", [
    dict(use_pallas=True),
    dict(defer_r=False),
    dict(low_memory=True),
    dict(chunk_size=None),                               # per-cell path
    dict(max_iter_harmony=0),
])
def test_item8_configurations_run(monkeypatch, kw):
    """The stored-R, low_memory, per-cell and zero-iteration configurations
    run, and resolve the flags as the JAX package does."""
    X, meta = _problem(N=3000, d=6)
    args = dict(verbose=False, chunk_size=128, max_iter_harmony=2)
    args.update(kw)
    ho = ht.run_harmony(X, meta, ["batch"], device="cpu", **args)
    jc = _jax_cfg(monkeypatch, X, meta, **args)
    for f in ("use_pallas", "use_fused_xla", "defer_r", "r_dtype",
              "chunk_size", "max_iter_harmony", "N_pad"):
        assert getattr(ho.cfg, f) == getattr(jc, f), f
    Z = ho.Z_corr
    assert Z.shape == X.shape and np.all(np.isfinite(Z))


@pytest.mark.parametrize("kw,item", [
    (dict(checkpoint_dir="ckpt"), "item 10"),
    (dict(resume_from="ckpt.npz"), "item 10"),
    (dict(mesh=object()), "item 11"),
])
def test_unported_configurations_raise(kw, item, tmp_path, monkeypatch):
    """The arguments of once-unported items are ported: the checkpoint
    arguments (item 10) run, and mesh= (item 11) takes a
    parallel.mesh.Mesh, refusing anything else with an error naming it."""
    monkeypatch.chdir(tmp_path)
    X, meta = _problem(N=3000, d=6)
    args = dict(device="cpu", verbose=False, chunk_size=128,
                max_iter_harmony=1)
    args.update(kw)
    if item == "item 11":
        with pytest.raises((TypeError, ValueError), match="Mesh"):
            ht.run_harmony(X, meta, ["batch"], **args)
    elif "resume_from" in kw:
        with pytest.raises(FileNotFoundError):
            ht.run_harmony(X, meta, ["batch"], **args)
    else:
        ht.run_harmony(X, meta, ["batch"], **args)
        assert (tmp_path / "ckpt" / "harmony_iter_1.npz").exists()


def test_jax_validation_errors_kept():
    X, meta = _problem(N=3000, d=6)
    with pytest.raises(ValueError, match="smaller chunk_size"):
        ht.run_harmony(X, meta, ["batch"], device="cpu", verbose=False,
                       defer_r=True)
    with pytest.raises(ValueError, match="max_iter_harmony >= 1"):
        ht.run_harmony(X, meta, ["batch"], device="cpu", verbose=False,
                       chunk_size=128, defer_r=True, max_iter_kmeans=0)
    with pytest.raises(ValueError, match="positive"):
        ht.run_harmony(X, meta, ["batch"], device="cpu", verbose=False,
                       chunk_size=128, lamb=0.0)
    with pytest.raises(AssertionError, match="same number of cells"):
        ht.run_harmony(X[:100], meta, ["batch"], device="cpu")


def test_port_imports_neither_jax_nor_the_jax_package():
    code = ("import sys, runpy\n"
            "import harmonypy_tpu_torch, harmonypy_tpu_torch.engine\n"
            "import harmonypy_tpu_torch.ops.cuda.build\n"
            "runpy.run_path('chip_smoke.py', run_name='not_main')\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'harmonypy_tpu' or "
            "m.startswith('harmonypy_tpu.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
    pat = re.compile(r"^\s*(import|from)\s+(jax\b|harmonypy_tpu(?!_torch))",
                     re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "harmonypy_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for f in files:
        with open(f) as fh:
            assert not pat.search(fh.read()), f
