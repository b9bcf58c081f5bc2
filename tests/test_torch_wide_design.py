"""Designs wider than the kernel's shared-memory plan, and the ridge's
one-hot forms, on the CPU.

  - the port's default fit at B = 120 batch levels (one unused), more than
    K1's O, E and S fit in a CTA's shared memory at d = 50, K = 100 (the
    card takes the wide plan there; the CPU runs the plain round), against
    the plain reference of the benchmark (portbench/reference/
    harmony_ref.py), which follows the same trajectory from the seed, at
    the harness's correctness numbers;
  - the same fit on 2 and 4 CPU shards, bitwise the one-device fit;
  - the one-hot normal equations, their dense layout, solve and apply
    (ops/replay.py window_design_sums, dense_normal_eq,
    window_apply_onehot) equal the dense forms (window_normal_eq,
    window_apply) to fp32 rounding, both ridge penalties, fp32 and one
    pass;
  - a design read by io/loader.load_sharded_data takes the one-hot forms
    only where it is one-hot: two covariates, or a cell with no level,
    take the dense forms, and the fit of its data is run_harmony's;
  - the harmony::design_sums and harmony::mesh_pass ranges."""

import dataclasses
import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

# Test workers share the CPU cores: one intra-op thread each.
torch.set_num_threads(1)

import harmonypy_tpu_torch as ht
from harmonypy_tpu_torch import engine
from harmonypy_tpu_torch.config import EngineConfig
from harmonypy_tpu_torch.io import load_sharded_data
from harmonypy_tpu_torch.ops import replay
from harmonypy_tpu_torch.ops.ridge import solve_w
from harmonypy_tpu_torch.parallel.mesh import make_mesh
from harmonypy_tpu_torch.parallel.sharding import gather_cells
from harmonypy_tpu_torch.layout import unpad_cells
from harmonypy_tpu_torch.state import HarmonyParams

PB = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "portbench")
sys.path.insert(0, PB)
from harness.entries import correction_error  # noqa: E402
from reference.harmony_ref import harmony  # noqa: E402

N, D, K, B, UNUSED = 41_000, 16, 20, 120, 57
ITERS, ROUNDS = 2, 4
SEED = 2 ** 31 + 7


@pytest.fixture(scope="module")
def wide():
    """(X, codes, meta) of a clustered embedding over B levels, level
    UNUSED holding no cell."""
    rng = np.random.default_rng(5)
    codes = rng.integers(0, B - 1, N)
    codes[codes >= UNUSED] += 1
    groups = rng.integers(0, 12, N)
    X = (rng.normal(size=(12, D))[groups] * 5.0
         + rng.normal(size=(B, D))[codes] * 1.5
         + rng.normal(size=(N, D))).astype(np.float32)
    meta = pd.DataFrame({"batch": pd.Categorical.from_codes(
        codes, categories=[f"b{i}" for i in range(B)])})
    return X, codes, meta


def _fit(X, meta, **kw):
    return ht.run_harmony(X, meta, ["batch"], nclust=K, random_state=SEED,
                          max_iter_harmony=ITERS, max_iter_kmeans=ROUNDS,
                          epsilon_cluster=0.0, epsilon_harmony=-np.inf,
                          device="cpu", verbose=False, **kw)


@pytest.fixture(scope="module")
def one_device(wide):
    X, _, meta = wide
    return _fit(X, meta)


def test_wide_fit_against_the_plain_reference(wide, one_device):
    """The fused default fit at B = 120 with an unused level follows the
    reference's trajectory: the harness's numbers (portbench's tiny CPU
    cell's limits) between its Z_corr and the reference's, both fp32."""
    X, codes, _ = wide
    ho = one_device
    assert ho.cfg.fused_estep and ho.cfg.defer_r and ho.cfg.B == B
    assert ho.kmeans_rounds == [ROUNDS] * ITERS
    Z = torch.as_tensor(X)
    ref, R = harmony(Z, codes, B, K, SEED, "fp32",
                     max_iter_harmony=ITERS, max_iter_kmeans=ROUNDS)
    err, gap, raw = correction_error(Z, torch.as_tensor(ho.Z_corr), ref, R)
    assert err <= 1e-3 and gap <= 1e-2 and raw <= 0.1, (err, gap, raw)


@pytest.mark.parametrize("shards", [2, 4])
def test_wide_fit_on_a_cpu_mesh_is_the_one_device_fit(wide, one_device,
                                                      shards):
    X, _, meta = wide
    ho = _fit(X, meta, mesh=make_mesh(["cpu"] * shards))
    assert ho.cfg.n_devices == shards
    assert np.array_equal(ho.Z_corr, one_device.Z_corr)


def _window(B1, d, Kc, w=3, CH=64, seed=0):
    """A window of one-hot design rows a (mask; Phi) with padding cells in
    its last chunk and an unused level, Z_orig and r zero on padding."""
    rng = np.random.default_rng(seed)
    lev = rng.integers(1, B1 - 1, (w, CH))          # level B1 - 1 unused
    mask = np.ones((w, CH), np.float32)
    mask[-1, CH // 2:] = 0
    a = np.zeros((w, B1, CH), np.float32)
    a[:, 0] = mask
    np.put_along_axis(a, lev[:, None], mask[:, None], axis=1)
    zo = rng.normal(size=(w, d, CH)).astype(np.float32) * mask[:, None]
    r = rng.uniform(size=(w, Kc, CH)).astype(np.float32) * mask[:, None]
    return (torch.as_tensor(a), torch.as_tensor(zo),
            torch.as_tensor(r / np.maximum(r.sum(1, keepdims=True), 1e-8)))


@pytest.mark.parametrize("one", [False, True], ids=["fp32", "one_pass"])
@pytest.mark.parametrize("lambda_estimation", [False, True])
@pytest.mark.parametrize("Bc", [3, 49])
def test_onehot_ridge_equals_the_dense_forms(Bc, lambda_estimation, one):
    """Summed over the window's chunks, window_design_sums laid out by
    dense_normal_eq equals window_normal_eq's sums (the B1^2 products
    included), both solve alike, and window_apply_onehot equals
    window_apply (by rows at B1 <= K, by gathered W above), within fp32
    rounding, in fp32 and with the CPU's plain one-pass operands; W's
    intercept row applied too."""
    B1, d, Kc = Bc + 1, 6, 7
    a, zo, r = _window(B1, d, Kc, seed=Bc)
    cfg = EngineConfig(N=1000, d=d, K=Kc, B=Bc, n_devices=1,
                       lambda_estimation=lambda_estimation)
    dense = replay.window_normal_eq(a, zo, r, one).sum(0)
    sums = replay.window_design_sums(a, zo, r, one)
    assert sums.shape == (a.shape[0], replay.normal_eq_rows(cfg), Kc)
    onehot = replay.dense_normal_eq(sums.sum(0), cfg)
    assert onehot.shape == dense.shape
    np.testing.assert_allclose(onehot.numpy(), dense.numpy(), rtol=1e-5,
                               atol=1e-5)
    E = torch.sum(r, dim=(0, 2))[:, None] * a[:, 1:].sum((0, 2))[None] / \
        a[:, 0].sum()
    params = HarmonyParams(torch.full((Bc,), 2.0), torch.full((Kc,), 0.1),
                           torch.cat([torch.zeros(1), torch.ones(Bc)]),
                           a[:, 1:].sum((0, 2)) / a[:, 0].sum())
    W = solve_w(onehot, E, params, cfg)
    np.testing.assert_allclose(W.numpy(),
                               solve_w(dense, E, params, cfg).numpy(),
                               rtol=1e-4, atol=1e-5)
    assert torch.all(W[:, Bc] == 0)                 # the unused level
    # One pass: the intercept row is rounded with each level's row (the
    # fault's path only), so it is held at the rounding of W's operand.
    for intercept, tol in ((0.0, 1e-5), (0.5, 2e-2 if one else 1e-5)):
        W[:, 0] = intercept
        np.testing.assert_allclose(
            replay.window_apply_onehot(a, zo, r, W, one).numpy(),
            replay.window_apply(a, zo, r, W, one).numpy(),
            rtol=1e-5, atol=tol)


def _loaded_fit(path, meta, vars_use, cfg, params, n_covariates=None):
    """Z_corr (N, d) of engine.fit on load_sharded_data's data of one CPU
    device, under cfg with the loader's n_covariates (or the one given)."""
    data, lcfg, _, _ = load_sharded_data(path, meta, vars_use,
                                         make_mesh(["cpu"]), cfg=cfg)
    cfg = dataclasses.replace(
        cfg, n_covariates=n_covariates or lcfg.n_covariates)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(SEED)
    st = engine.fit(data, params, cfg, gen)
    return unpad_cells(gather_cells(st.Z_corr, cfg).numpy(), cfg).T


@pytest.mark.parametrize("design", ["one", "two", "missing"])
def test_loaded_design_takes_the_ridge_its_phi_allows(tmp_path, design):
    """load_sharded_data sets n_covariates from its Phi, with no cfg given
    and over a given one: 1 for one covariate with a level in every cell,
    else 2, so that two covariates and a cell with no level take the dense
    ridge. engine.fit of the loaded data is then run_harmony's fit of the
    same design bit for bit; under the one-hot forms (n_covariates 1, the
    fault) the two-hot design fails to solve or comes out otherwise."""
    rng = np.random.default_rng(11)
    n = 22_000
    # Cell groups the clusters follow, each mixing the levels of a, which
    # shift the first two PCs.
    a = rng.choice(["a0", "a1", "a2"], size=n).astype(object)
    X = (rng.normal(size=(4, 8))[rng.integers(0, 4, n)] * 5.0
         + rng.normal(size=(n, 8))).astype(np.float32)
    X[:, :2] += np.select([a == "a0", a == "a1"], [1.5, -1.5])[:, None]
    meta = pd.DataFrame({"a": a, "b": rng.choice(["b0", "b1"], size=n)})
    if design == "missing":
        meta.loc[::97, "a"] = np.nan
    vars_use = ["a", "b"] if design == "two" else ["a"]
    path = str(tmp_path / "pcs.npy")
    np.save(path, X)
    ho = ht.run_harmony(X, meta, vars_use, nclust=6, random_state=SEED,
                        max_iter_harmony=2, max_iter_kmeans=3,
                        epsilon_cluster=0.0, epsilon_harmony=-np.inf,
                        device="cpu", verbose=False)
    want = 1 if design == "one" else 2
    assert ho.cfg.fused_estep and ho.cfg.n_covariates == want
    _, cfg, _, _ = load_sharded_data(path, meta, vars_use,
                                     make_mesh(["cpu"]))
    assert cfg.n_covariates == want
    # A given cfg that claims one covariate is set from Phi, too.
    Z = _loaded_fit(path, meta, vars_use,
                    dataclasses.replace(ho.cfg, n_covariates=1), ho._params)
    assert np.array_equal(Z, ho.Z_corr)
    if design == "two":
        # The fault: its normal equations miss the two-hot cells' cross
        # terms, so they are singular or solve to another W.
        try:
            Z1 = _loaded_fit(path, meta, vars_use, ho.cfg, ho._params,
                             n_covariates=1)
        except torch.linalg.LinAlgError:
            return
        assert np.abs(Z1 - ho.Z_corr).max() > 1e-2


def _names(prof):
    return [e.name for e in prof.events()]


def test_design_sums_and_mesh_pass_ranges(wide):
    """A one-hot design's replays run their products inside
    harmony::design_sums (two windows a replay pair here: normal equations
    and apply, per iteration); a mesh fit's passes each run inside one
    harmony::mesh_pass."""
    X, _, meta = wide
    X, meta = X[:22_000], meta.iloc[:22_000]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ho = _fit(X, meta)
    names = _names(prof)
    windows = len(replay.windows(ho.cfg))
    assert names.count("harmony::design_sums") == 2 * windows * ITERS
    assert "harmony::mesh_pass" not in names
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ho = _fit(X, meta, mesh=make_mesh(["cpu"] * 2))
    assert _names(prof).count("harmony::mesh_pass") == ho.state.n_passes
