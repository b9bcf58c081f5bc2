"""The port's per-cell path and stored-R ops on the CPU, against the JAX
package: the iid cell partition with its capacity rule, the per-cell
E-step, the stored-R ridge in both layouts, the objective terms, a per-cell
fit with the JAX init and partitions injected, the golden pbmc gate at
default settings, and the zero-iteration fit."""

import numpy as np
import pytest
import torch

# Test workers share the CPU cores with each other and with JAX's own
# thread pool: one intra-op thread each keeps torch from oversubscribing.
torch.set_num_threads(1)

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import harmonypy_tpu as hm
from harmonypy_tpu.config import EngineConfig as JConfig, cell_tile_geom
from harmonypy_tpu.ops import partition as jp
from harmonypy_tpu.ops.objective import (compute_objective_terms as
                                         j_objective_terms)
from harmonypy_tpu.ops.ridge import moe_correct_ridge as j_ridge
from harmonypy_tpu.ops.update_r import (cell_partition_len as j_cell_len,
                                        update_r as j_update_r)
from harmonypy_tpu.parallel.mesh import AXIS, make_mesh
import harmonypy_tpu_torch as ht
from harmonypy_tpu_torch.config import EngineConfig as TConfig
from harmonypy_tpu_torch.layout import pad_cells, shard_mask, unpad_cells
from harmonypy_tpu_torch.ops import partition as tp
from harmonypy_tpu_torch.ops.objective import compute_objective_terms
from harmonypy_tpu_torch.ops.ridge import moe_correct_ridge
from harmonypy_tpu_torch.ops.update_r import update_r
from harmonypy_tpu_torch.state import HarmonyParams
from test_kernels import _cfg, _params, _problem, _run_sharded
from test_torch_fit import SEED, _correlations
from test_torch_fit import _problem as _fit_problem

_S2 = P(None, AXIS)


def _tparams(p):
    return HarmonyParams(*(torch.as_tensor(np.asarray(p[k], np.float32))
                           for k in ("theta", "sigma", "lamb", "Pr_b")))


def _jax_raw(key, n_real, nb):
    """The raw draw JAX's iid_blocks makes (ops/partition.py:107-108)."""
    G, _ = cell_tile_geom(nb)
    n_tiles = -(-max(n_real, 1) // G)
    return jax.random.randint(key, (n_tiles * G,), 0, nb, jnp.int32)


@pytest.mark.parametrize("n_real,L,nb", [
    (173, 180, 20), (3500, 3500, 20), (20_000, 20_480, 20), (1000, 1002, 3),
    (5000, 5000, 1)])
def test_iid_blocks_from_draw_equals_jax(n_real, L, nb):
    key = jax.random.PRNGKey(n_real % 89)
    raw = np.array(_jax_raw(key, n_real, nb))
    ref = np.asarray(jp.iid_blocks(key, n_real, L, nb))
    out = tp.iid_blocks_from_draw(torch.as_tensor(raw), n_real, L, nb)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert np.all(ref[n_real:] == nb)


def test_iid_capacity_rule_skips_equal_jax(monkeypatch):
    """A draw that overflows the per-tile capacity (one tile all in block 0,
    one with a block drawn 1.5x its cap): the same cells are skipped."""
    nb, n_real = 4, 1200
    G, cap = cell_tile_geom(nb)
    raw = np.asarray(_jax_raw(jax.random.PRNGKey(1), n_real, nb)).copy()
    raw[:G] = 0
    raw[G: G + cap * 3 // 2] = 2
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.asarray(raw))
    ref = np.asarray(jp.iid_blocks(jax.random.PRNGKey(1), n_real, n_real, nb))
    out = tp.iid_blocks_from_draw(torch.as_tensor(raw), n_real, n_real, nb)
    np.testing.assert_array_equal(out.numpy(), ref)
    skipped = (ref == nb).sum()
    assert skipped >= (G - cap) + cap // 2, skipped


def test_torch_iid_draw_structure():
    """The port's own draw: every block drawn, the capacity rule applied,
    sentinels past n_real; the slot table groups cells ascending."""
    cfg = TConfig(N=3500, d=4, K=5, B=2, n_devices=1)
    L = tp.cell_partition_len(cfg)
    gen = torch.Generator().manual_seed(0)
    blocks = tp.iid_blocks(gen, cfg.N, L, cfg.n_blocks)
    assert blocks.shape == (L,) and torch.all(blocks[cfg.N:] == cfg.n_blocks)
    assert set(blocks[: cfg.N].tolist()) <= set(range(cfg.n_blocks + 1))
    tbl = tp.cell_slot_table(blocks, cfg).numpy()
    assert tbl.shape == (cfg.n_blocks, cfg.cell_block_width)
    for b in range(cfg.n_blocks):
        ids = tbl[b][tbl[b] < cfg.N_local]
        np.testing.assert_array_equal(ids, np.where(blocks.numpy() == b)[0])


@pytest.mark.parametrize("block_size,r_dtype", [
    (0.05, "float32"), (0.3, "float32"), (0.45, "float32"),
    (0.05, "bfloat16")])
def test_update_r_matches_jax(block_size, r_dtype):
    """tests/test_kernels.py:96-128's E-step, on the port, given the JAX
    package's iid partition for the same key."""
    p = _problem(N=173)
    cfg = _cfg(p, block_size=block_size, r_dtype=r_dtype)
    key = jax.random.PRNGKey(7)
    mask = jnp.ones((p["N"],), jnp.float32)
    jdt = jnp.bfloat16 if r_dtype == "bfloat16" else jnp.float32

    def f(key, R, dist, Phi, E, O, params, mask):
        return j_update_r(key, R, dist, Phi, E, O, params, cfg, mask, AXIS)

    R_j, E_j, O_j = _run_sharded(
        f, make_mesh(n_devices=1),
        (P(), _S2, _S2, _S2, P(), P(), P(), P(AXIS)), (_S2, P(), P()),
        key, jnp.asarray(p["R"]).astype(jdt), jnp.asarray(p["dist"]),
        jnp.asarray(p["Phi"]), jnp.asarray(p["E"]), jnp.asarray(p["O"]),
        _params(p), mask)
    tc = TConfig(N=p["N"], d=p["d"], K=p["K"], B=p["B"], n_devices=1,
                 block_size=block_size, r_dtype=r_dtype)
    blocks = np.asarray(jp.iid_blocks(key, p["N"], j_cell_len(cfg),
                                      cfg.n_blocks))
    assert tp.cell_partition_len(tc) == j_cell_len(cfg)
    tbl = tp.cell_slot_table(torch.as_tensor(blocks), tc)
    R0 = torch.as_tensor(p["R"]).to(tc.r_torch_dtype)
    R_t, E_t, O_t = update_r(
        tbl, R0, torch.as_tensor(p["dist"]), torch.as_tensor(p["Phi"]),
        torch.as_tensor(p["E"]), torch.as_tensor(p["O"]), _tparams(p), tc,
        torch.ones(p["N"]))
    assert R_t.dtype == tc.r_torch_dtype
    R_t = R_t.float().numpy()
    R_j = np.asarray(R_j, np.float32)
    if r_dtype == "float32":
        np.testing.assert_allclose(R_t, R_j, rtol=1e-5, atol=1e-6)
    else:   # one bf16 ulp (at most 2^-8 relative) where rounding differs
        np.testing.assert_allclose(R_t, R_j, rtol=2 ** -8, atol=1e-30)
    np.testing.assert_allclose(E_t.numpy(), np.asarray(E_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(O_t.numpy(), np.asarray(O_j), rtol=1e-5,
                               atol=1e-5)


def _fused_ridge_problem(N=600, CH=128, d=6, K=7, B=3, seed=2):
    """A stored-R problem on the fused (chunk-padded) layout."""
    kw = dict(N=N, d=d, K=K, B=B, n_devices=1, use_fused_xla=True,
              chunk_size=CH, block_size=0.25)
    tc = TConfig(**kw)
    Np = tc.N_pad
    rng = np.random.default_rng(seed)
    mask = shard_mask(tc)
    Z = rng.normal(size=(d, Np)).astype(np.float32) * mask
    batch = rng.integers(0, B, size=Np)
    Phi = ((batch[None, :] == np.arange(B)[:, None]) * mask).astype(
        np.float32)
    R = rng.random(size=(K, Np)).astype(np.float32)
    R = (R / R.sum(axis=0, keepdims=True) * mask).astype(np.float32)
    Pr_b = (Phi.sum(1) / N).astype(np.float32)
    E = np.outer(R.sum(axis=1), Pr_b).astype(np.float32)
    p = dict(Z=Z, Phi=Phi, R=R, E=E, Pr_b=Pr_b, mask=mask,
             theta=np.full(B, 2.0, np.float32),
             sigma=np.full(K, 0.1, np.float32),
             lamb=np.concatenate([[0.0], np.ones(B)]).astype(np.float32))
    return kw, tc, p


@pytest.mark.parametrize("layout", ["per_cell", "fused"])
@pytest.mark.parametrize("lambda_estimation", [False, True])
def test_moe_correct_ridge_matches_jax(layout, lambda_estimation):
    if layout == "fused":
        kw, _, p = _fused_ridge_problem()
        kw["lambda_estimation"] = lambda_estimation
        cfg = JConfig(**kw)
        tc = TConfig(**kw)
    else:
        p = _problem()
        p["mask"] = np.ones(p["N"], np.float32)
        cfg = _cfg(p, lambda_estimation=lambda_estimation)
        tc = TConfig(N=p["N"], d=p["d"], K=p["K"], B=p["B"], n_devices=1,
                     lambda_estimation=lambda_estimation)

    def f(Z, Phi, R, E, params, mask):
        return j_ridge(Z, Phi, R, E, params, cfg, mask, AXIS)

    Z_j = np.asarray(_run_sharded(
        f, make_mesh(n_devices=1), (_S2, _S2, _S2, P(), P(), P(AXIS)), _S2,
        jnp.asarray(p["Z"]), jnp.asarray(p["Phi"]), jnp.asarray(p["R"]),
        jnp.asarray(p["E"]), _params(p), jnp.asarray(p["mask"])))
    R = torch.as_tensor(p["R"])
    if layout == "fused":
        R = R.reshape(tc.K, -1, tc.chunk_size).permute(1, 0, 2).contiguous()
    Z_t = moe_correct_ridge(
        torch.as_tensor(p["Z"]), torch.as_tensor(p["Phi"]), R,
        torch.as_tensor(p["E"]), _tparams(p), tc,
        torch.as_tensor(p["mask"])).numpy()
    np.testing.assert_allclose(Z_t, Z_j, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("r_dtype", ["float32", "bfloat16"])
def test_objective_terms_match_jax(r_dtype):
    p = _problem()
    cfg = _cfg(p)
    jdt = jnp.bfloat16 if r_dtype == "bfloat16" else jnp.float32

    def f(R, dist, O, E, Phi, params):
        return j_objective_terms(R, dist, O, E, Phi, params, cfg, AXIS)

    ref = _run_sharded(
        f, make_mesh(n_devices=1), (_S2, _S2, P(), P(), _S2, P()),
        (P(), P(), P()), jnp.asarray(p["R"]).astype(jdt),
        jnp.asarray(p["dist"]), jnp.asarray(p["O"]), jnp.asarray(p["E"]),
        jnp.asarray(p["Phi"]), _params(p))
    R = torch.as_tensor(p["R"]).to(getattr(torch, r_dtype))
    out = compute_objective_terms(
        R, torch.as_tensor(p["dist"]), torch.as_tensor(p["O"]),
        torch.as_tensor(p["E"]), torch.as_tensor(p["Phi"]), _tparams(p),
        TConfig(N=p["N"], d=p["d"], K=p["K"], B=p["B"], n_devices=1))
    np.testing.assert_allclose([float(x) for x in out],
                               [float(x) for x in ref], rtol=2e-5)


@pytest.fixture(scope="module")
def jax_percell_fit():
    """A default-settings JAX fit of 3,000 cells (the per-cell path, two
    harmony iterations), its init centroids and per-round cell
    assignments, from its key splits (api.py:394, engine.py:209, 361)."""
    X, meta = _fit_problem(N=3000, d=8)
    ho = hm.run_harmony(X, meta, ["batch"], mesh=make_mesh(n_devices=1),
                        verbose=False, max_iter_harmony=2, random_state=SEED)
    assert not ho.cfg.fused_estep
    st0 = ho._engine.init_fn(ho._data, ho._params, jax.random.PRNGKey(SEED))
    cfg = ho.cfg
    key, _ = jax.random.split(jax.random.PRNGKey(SEED))
    blocks = []
    for _ in range(cfg.max_iter_kmeans * cfg.max_iter_harmony):
        key, k_r = jax.random.split(key)
        blocks.append(np.array(jp.iid_blocks(k_r, cfg.N, j_cell_len(cfg),
                                             cfg.n_blocks)))
    return X, meta, ho, np.array(st0.Y), blocks


def test_percell_fit_matches_jax_with_injected_init_and_partitions(
        jax_percell_fit):
    X, meta, ho_j, Y0, blocks = jax_percell_fit
    ho_t = ht.run_harmony(X, meta, ["batch"], device="cpu", verbose=False,
                          max_iter_harmony=2, _init_Y=Y0,
                          _blocks_fn=lambda i: blocks[i])
    assert not ho_t.cfg.fused_estep and ho_t.cfg.N_pad == ho_t.N
    assert ho_t.kmeans_rounds == ho_j.kmeans_rounds
    np.testing.assert_allclose(ho_t.objective_kmeans, ho_j.objective_kmeans,
                               rtol=1e-4)
    np.testing.assert_allclose(ho_t.objective_harmony,
                               ho_j.objective_harmony, rtol=1e-4)
    np.testing.assert_allclose(ho_t.Z_corr, ho_j.Z_corr, atol=1e-4)
    np.testing.assert_allclose(ho_t.R, ho_j.R, atol=1e-5)


@pytest.mark.parametrize("chunk_size", [None, 128], ids=["per_cell", "fused"])
def test_zero_iteration_fit_matches_jax(chunk_size):
    """max_iter_harmony=0: Z_corr is Z_orig and .R the initial soft
    assignments of the injected init."""
    X, meta = _fit_problem(N=3000, d=6)
    ho_j = hm.run_harmony(X, meta, ["batch"], mesh=make_mesh(n_devices=1),
                          verbose=False, max_iter_harmony=0,
                          chunk_size=chunk_size, random_state=SEED)
    ho_t = ht.run_harmony(X, meta, ["batch"], device="cpu", verbose=False,
                          max_iter_harmony=0, chunk_size=chunk_size,
                          _init_Y=np.asarray(ho_j.Y))
    assert ho_t.cfg.fused_estep == ho_j.cfg.fused_estep
    assert not ho_t.cfg.defer_r and ho_t.kmeans_rounds == []
    np.testing.assert_array_equal(ho_t.Z_corr, ho_j.Z_corr)
    np.testing.assert_allclose(ho_t.R, ho_j.R, atol=1e-5)
    np.testing.assert_allclose(ho_t.objective_harmony,
                               ho_j.objective_harmony, rtol=1e-5)


def test_layout_without_padding():
    """The per-cell layout pads nothing: N_pad == N, every cell real."""
    cfg = TConfig(N=3500, d=4, K=5, B=2, n_devices=1)
    assert cfg.N_pad == cfg.N_local == cfg.N_shard_real == 3500
    X = np.arange(2 * 3500, dtype=np.float32).reshape(2, 3500)
    np.testing.assert_array_equal(pad_cells(X, cfg), X)
    np.testing.assert_array_equal(unpad_cells(X, cfg), X)
    assert shard_mask(cfg).shape == (3500,) and shard_mask(cfg).all()


def test_golden_pbmc_default_settings(pbmc):
    """tests/test_harmony_golden.py:33 on the port: pbmc_3500 at default
    settings, which is the per-cell path."""
    meta, pcs, harmonized = pbmc
    ho = ht.run_harmony(pcs, meta, ["donor"], device="cpu", verbose=False)
    assert not ho.cfg.fused_estep and not ho.cfg.defer_r
    cors = _correlations(ho.Z_corr, harmonized)
    assert np.all(cors >= 0.99), cors
    obj = ho.objective_harmony
    assert obj[-1] < obj[0]
    assert len(ho.objective_kmeans) == 1 + sum(ho.kmeans_rounds)
    np.testing.assert_allclose(ho.R.sum(axis=1), 1.0, rtol=1e-4)
