"""The port's device mesh on the CPU: fused fits bitwise equal on 1, 2 and
4 shards (deferred, stored, low_memory), the per-cell fit to reduction-order
tolerance, the 4-shard fit against the JAX package's 4-device fit with its
init and partitions injected, the resolved configuration and a JAX
4-device state carried across, the kernel's work split, the per-block
plain round against the one-call plain rounds, checkpoints on a mesh, the
capacity preflight of logical shards, sharded ingest and the scanpy
helper."""

import dataclasses
import types

import numpy as np
import pandas as pd
import pytest
import torch

# Test workers share the CPU cores with each other and with JAX's own
# thread pool: one intra-op thread each keeps torch from oversubscribing.
torch.set_num_threads(1)

import jax

import harmonypy_tpu as hm
from harmonypy_tpu.io.loader import load_sharded_data as j_load_sharded
from harmonypy_tpu.ops.partition import partition_geometry, stripe_blocks
from harmonypy_tpu.parallel.mesh import make_mesh as jax_mesh
import harmonypy_tpu_torch as ht
from harmonypy_tpu_torch.api import materialize_r, stored_r
from harmonypy_tpu_torch.config import EngineConfig
from harmonypy_tpu_torch.integrate import harmony_integrate
from harmonypy_tpu_torch.io import load_matrix_tsv, load_sharded_data
from harmonypy_tpu_torch.ops import partition as tp
from harmonypy_tpu_torch.ops.cuda import fused_estep as fe
from harmonypy_tpu_torch.ops.cuda.fused_estep import kernel_geometry
from harmonypy_tpu_torch.ops.update_r_fused import (fused_update_nor,
                                                    fused_update_r,
                                                    mesh_round)
from harmonypy_tpu_torch.parallel import sharding
from harmonypy_tpu_torch.parallel.mesh import (Mesh, default_mesh,
                                               initialize_distributed,
                                               make_mesh, resolve_mesh)
from harmonypy_tpu_torch.state import HarmonyParams, state_from_numpy
from harmonypy_tpu_torch.utils.memory import (CapacityError, _check_card,
                                              check_capacity,
                                              memory_envelope)
from test_torch_fit import _problem as fit_problem

SEED = 0
HIST = ("objective_harmony", "objective_kmeans", "objective_kmeans_dist",
        "objective_kmeans_entropy", "objective_kmeans_cross",
        "kmeans_rounds")
FIT = dict(verbose=False, chunk_size=128, nclust=12, max_iter_harmony=2)


def _problem(N=6000, d=8, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(6, d)) * 4
    g = rng.integers(0, 6, N)
    b = rng.integers(0, 3, N)
    shifts = rng.normal(size=(3, d)) * 2
    X = (centers[g] + shifts[b] + rng.normal(size=(N, d))).astype(np.float32)
    return X, pd.DataFrame({"batch": [f"b{i}" for i in b]})


def cpu_mesh(n):
    return make_mesh(["cpu"] * n)


def _fit(X, meta, n, **kw):
    return ht.run_harmony(X, meta, ["batch"], mesh=cpu_mesh(n),
                          **{**FIT, **kw})


@pytest.fixture(scope="module")
def data():
    return _problem()


@pytest.mark.parametrize("kind,kw", [
    ("deferred", {}),
    ("stored", dict(defer_r=False)),
    ("low_memory", dict(defer_r=False, low_memory=True)),
])
def test_fused_fits_bitwise_on_1_2_4_shards(data, kind, kw):
    """tests/test_fused_xla.py:108-132 and tests/test_defer.py:51-60 on the
    port: Z_corr, R, the five histories and kmeans_rounds bit for bit."""
    X, meta = data
    fits = {n: _fit(X, meta, n, **kw) for n in (1, 2, 4)}
    assert fits[4].cfg.n_devices == 4 and fits[4].cfg.fused_estep
    assert fits[4].cfg.defer_r == (kind == "deferred")
    for n in (2, 4):
        np.testing.assert_array_equal(fits[n].Z_corr, fits[1].Z_corr)
        np.testing.assert_array_equal(fits[n].R, fits[1].R)
        for h in HIST:
            assert getattr(fits[n], h) == getattr(fits[1], h), (n, h)


def test_per_cell_fit_on_a_mesh_within_tolerance(data):
    """tests/test_fused_xla.py:135-150 on the port: shard partials in shard
    order, atol 5e-4 max|Z|."""
    X, meta = data
    one = ht.run_harmony(X, meta, ["batch"], mesh=cpu_mesh(1),
                         verbose=False, nclust=12, max_iter_harmony=2)
    four = ht.run_harmony(X, meta, ["batch"], mesh=cpu_mesh(4),
                          verbose=False, nclust=12, max_iter_harmony=2)
    assert not four.cfg.fused_estep and four.cfg.n_devices == 4
    scale = float(np.max(np.abs(one.Z_corr)))
    np.testing.assert_allclose(four.Z_corr, one.Z_corr, atol=5e-4 * scale)


@pytest.fixture(scope="module")
def jax_mesh_fit():
    """One deferred-R JAX fit on 4 virtual CPU devices on
    tests/test_torch_fit.py's problem (chunk_size=128, one harmony
    iteration), its init centroids and per-round blocks from its key splits
    (api.py:394, engine.py:209, 548)."""
    X, meta = fit_problem()
    ho = hm.run_harmony(X, meta, ["batch"], mesh=jax_mesh(n_devices=4),
                        verbose=False, chunk_size=128, max_iter_harmony=1,
                        random_state=SEED)
    assert ho.cfg.defer_r and ho.cfg.n_devices == 4
    st0 = ho._engine.init_fn(ho._data, ho._params, jax.random.PRNGKey(SEED))
    geom = partition_geometry(ho.cfg)
    key, _ = jax.random.split(jax.random.PRNGKey(SEED))
    blocks = []
    for _ in range(ho.cfg.max_iter_kmeans):
        key, k_r = jax.random.split(key)
        blocks.append(np.array(stripe_blocks(k_r, geom.NC_fixed, geom.L,
                                             geom.nb)))
    return X, meta, ho, np.array(st0.Y), blocks


def test_four_shards_against_jax_four_devices(jax_mesh_fit):
    """The port on 4 CPU shards against the JAX package on 4 devices, the
    JAX init and partitions injected: tests/test_torch_fit.py:67-77's
    problem and tolerances."""
    X, meta, ho_j, Y0, blocks = jax_mesh_fit
    ho_t = ht.run_harmony(X, meta, ["batch"], mesh=cpu_mesh(4),
                          verbose=False, chunk_size=128, max_iter_harmony=1,
                          _init_Y=Y0, _blocks_fn=lambda i: blocks[i])
    assert ho_t.cfg.N_pad == ho_j.cfg.N_pad
    assert ho_t.kmeans_rounds == ho_j.kmeans_rounds
    np.testing.assert_allclose(ho_t.objective_kmeans, ho_j.objective_kmeans,
                               rtol=1e-4)
    np.testing.assert_allclose(ho_t.objective_harmony,
                               ho_j.objective_harmony, rtol=1e-4)
    np.testing.assert_allclose(ho_t.Z_corr, ho_j.Z_corr, atol=1e-4)


def test_jax_four_device_state_gives_jax_R(jax_mesh_fit):
    """A JAX 4-device deferred state, as numpy arrays, through
    state_from_numpy onto 4 CPU shards: the port's replayed .R equals the
    JAX package's."""
    _, _, ho_j, _, _ = jax_mesh_fit
    arrays = {k: np.asarray(v) for k, v in ho_j.state._asdict().items()}
    geom = partition_geometry(ho_j.cfg)
    rep_blocks = np.array(stripe_blocks(ho_j.state.rep_key, geom.NC_fixed,
                                        geom.L, geom.nb))
    cfg = EngineConfig(N=ho_j.N, d=ho_j.d, K=ho_j.K, B=ho_j.B, n_devices=4,
                       use_fused_xla=True, defer_r=True, chunk_size=128,
                       max_iter_harmony=1)
    mesh = cpu_mesh(4)
    st = state_from_numpy(arrays, cfg, rep_blocks, mesh=mesh)
    assert isinstance(st.Z_corr, list) and len(st.cache) == 4
    dat = sharding.shard_inputs(ho_j.Z_orig.T, ho_j.Phi.T, cfg, mesh)
    params = HarmonyParams(*(torch.tensor(np.asarray(v, np.float32)) for v
                             in (ho_j.theta, ho_j.sigma,
                                 np.asarray(ho_j._params.lamb), ho_j.Pr_b)))
    np.testing.assert_allclose(materialize_r(cfg, st, dat, params), ho_j.R,
                               atol=1e-5)
    assert st.kmeans_rounds == ho_j.kmeans_rounds


@pytest.fixture(scope="module")
def jax_stored_mesh_fit(data):
    X, meta = data
    return hm.run_harmony(X, meta, ["batch"], mesh=jax_mesh(n_devices=4),
                          verbose=False, chunk_size=128, nclust=12,
                          max_iter_harmony=1, defer_r=False)


def test_jax_four_device_stored_state_gives_jax_R(jax_stored_mesh_fit):
    ho_j = jax_stored_mesh_fit
    assert not ho_j.cfg.defer_r and ho_j.cfg.use_fused_xla
    arrays = {k: np.asarray(v) for k, v in ho_j.state._asdict().items()}
    cfg = EngineConfig(N=ho_j.N, d=ho_j.d, K=ho_j.K, B=ho_j.B, n_devices=4,
                       use_fused_xla=True, chunk_size=128,
                       max_iter_harmony=1)
    st = state_from_numpy(arrays, cfg, mesh=cpu_mesh(4))
    assert [tuple(R.shape) for R in st.R] == [
        (cfg.N_local // 128, cfg.K, 128)] * 4
    np.testing.assert_array_equal(stored_r(cfg, st), ho_j.R)


def _jax_cfg(monkeypatch, X, meta, **kw):
    import harmonypy_tpu.api as japi

    class _Resolved(Exception):
        pass

    def stop(cfg, mesh):
        raise _Resolved(cfg)

    monkeypatch.setattr(japi, "get_engine", stop)
    with pytest.raises(_Resolved) as exc:
        hm.run_harmony(X, meta, ["batch"], mesh=jax_mesh(n_devices=4), **kw)
    return exc.value.args[0]


def _port_cfg(monkeypatch, X, meta, **kw):
    import harmonypy_tpu_torch.engine as eng

    class _Resolved(Exception):
        pass

    def stop(data, params, cfg, *a, **k):
        raise _Resolved(cfg)

    monkeypatch.setattr(eng, "fit", stop)
    with pytest.raises(_Resolved) as exc:
        ht.run_harmony(X, meta, ["batch"], mesh=cpu_mesh(4), **kw)
    return exc.value.args[0]


@pytest.mark.parametrize("kw", [
    dict(chunk_size=128),
    dict(chunk_size=128, defer_r=False),
    dict(chunk_size=128, use_pallas=True),
    dict(chunk_size=128, low_memory=True, defer_r=False),
    dict(),                                              # per-cell path
])
def test_resolved_config_matches_jax_on_four_devices(monkeypatch, data, kw):
    """config.py:180-202 and api.py:265-330 of the JAX package: every
    resolved field on a 4-device mesh, use_pallas=True included (the JAX
    kernel is single-device: pallas_supported is false on 4)."""
    X, meta = data
    args = dict(verbose=False, max_iter_harmony=2, **kw)
    jc = _jax_cfg(monkeypatch, X, meta, **args)
    pc = _port_cfg(monkeypatch, X, meta, **args)
    for f in ("n_devices", "use_pallas", "use_fused_xla", "defer_r",
              "r_dtype", "chunk_size", "N_pad", "N_local", "N_shard_real",
              "K", "n_blocks", "cell_block_width", "kmeans_hist_len"):
        assert getattr(pc, f) == getattr(jc, f), f
    assert not ht.config.pallas_supported(len(X), 4, chunk_size=128)


# The one-device work split the kernel has used since its redesign (units
# per slot, n_sm = 132) for the 858k shape and the shapes of chip_smoke.py's
# phase shapes: (N, CH, J, ng).
_ONE_DEVICE_SPLITS = [(858_000, 2048, 22, 12), (6_000, 128, 4, 2),
               (45_000, 2048, 3, 32)]


@pytest.mark.parametrize("N,CH,J,ng", _ONE_DEVICE_SPLITS)
def test_kernel_geometry_split_unchanged_and_shard_invariant(N, CH, J, ng):
    """The units per slot of the one-device round are unchanged, and a mesh
    shard (fewer slots per block) splits each chunk the same way when it
    passes the one-device J_fix + 1: on 4 shards of 858k, J_shard = 7,
    where J alone would give 32 units per slot."""
    cfg = EngineConfig(N=N, d=29, K=100, B=3, n_devices=1, chunk_size=CH,
                       use_fused_xla=True)
    geom = tp.partition_geometry(cfg)
    assert geom.J_shard == geom.J_fix + 1 == J
    assert kernel_geometry(100, 3, 29, CH, J, 132).ng == ng
    g4 = tp.partition_geometry(dataclasses.replace(cfg, n_devices=4))
    split = kernel_geometry(100, 3, 29, CH, g4.J_shard, 132, g4.J_fix + 1)
    assert split.ng == ng and split.n_units == g4.J_shard * ng
    if N == 858_000:
        assert (g4.nc_cap, g4.J_shard) == (105, 7)
        assert kernel_geometry(100, 3, 29, CH, 7, 132).ng == 32


def _round_inputs(n_dev, X, meta):
    """One round's inputs on n_dev CPU shards from a 1-device init."""
    ho = ht.run_harmony(X, meta, ["batch"], device="cpu", verbose=False,
                        chunk_size=128, nclust=12, max_iter_harmony=0,
                        defer_r=False)
    cfg1 = ho.cfg
    cfg = dataclasses.replace(cfg1, n_devices=n_dev)
    g1, g = tp.partition_geometry(cfg1), tp.partition_geometry(cfg)
    from harmonypy_tpu_torch.ops.update_r_fused import chunk_stats, make_zp3
    ZP3 = make_zp3(ho.state.Z_cos, ho._data.Phi, ho._data.mask, cfg1)
    cache = chunk_stats(ho.state.R, ZP3[:, 1:1 + cfg.B, :])
    gen = torch.Generator()
    gen.manual_seed(5)
    blocks = tp.stripe_blocks(gen, g.NC_fixed, g.L, g.nb)
    slots1, removal = tp.round_tables(blocks[: g1.L], cache, g1)
    mesh = cpu_mesh(n_dev)
    ZP3s = [sharding.extract_chunks(ZP3, s, g) for s in range(n_dev)]
    tabs = tp.mesh_round_tables(
        blocks, [sharding.extract_chunks(cache, s, g) for s in range(n_dev)],
        g, mesh.devices)
    p = ho._params
    Y = torch.nn.functional.normalize(torch.randn(cfg.d, cfg.K,
                                                  generator=gen), dim=0)
    common = (Y, p.sigma, p.theta, p.Pr_b, ho.state.O, ho.state.E)
    return g1, g, (slots1, removal, ZP3), tabs, ZP3s, common


@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("kind", ["round", "r_window", "float32",
                                  "bfloat16"])
def test_per_block_plain_round_equals_one_call_round(data, n_dev, kind):
    """The plain per-block entry on every shard with the frame re-add
    (mesh_round) equals fused_update_nor / fused_update_r bit for bit:
    O, E, the per-chunk rows, the r window and the stored R."""
    X, meta = data
    g1, g, (slots1, removal, ZP3), tabs, ZP3s, common = _round_inputs(
        n_dev, X, meta)
    assert torch.equal(tabs.removal, removal)
    fast = kind == "r_window"
    lo, width = 5, 9
    if kind in ("round", "r_window"):
        ref = fused_update_nor(slots1, removal, ZP3, *common, fast,
                               lo=lo if fast else 0,
                               width=width if fast else 0)
        wins = ([(lo - s * g.nc_cap, width)
                 if sharding.window_rows(g, s, lo, width)[2] else None
                 for s in range(n_dev)] if fast else None)
        out = mesh_round(tabs, ZP3s, *common, fast, g.J_fix, windows=wins)
    else:
        dt = getattr(torch, kind)
        R3 = torch.zeros((g1.nc_cap + 1, 12, g.CH), dtype=dt)
        r = fused_update_r(slots1, removal, ZP3, R3, *common, fast)
        ref = (*r[1:], r[0])
        R3s = [torch.zeros((g.nc_cap + 1, 12, g.CH), dtype=dt)
               for _ in range(n_dev)]
        out = (*mesh_round(tabs, ZP3s, *common, fast, g.J_fix,
                           R3s=R3s)[:5], R3s)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    for got, want in zip(out[2:5], ref[2:5]):
        assert torch.equal(tp.frame_rows(got, g), want[: g1.nc_cap])
    if kind == "r_window":
        for s, Rw in enumerate(out[5]):
            if Rw is not None:
                l0, p0, n = sharding.window_rows(g, s, lo, width)
                assert torch.equal(Rw[p0: p0 + n], ref[5][p0: p0 + n])
    elif kind != "round":
        assert torch.equal(tp.frame_rows(out[5], g), ref[5][: g1.nc_cap])


def test_mesh_checkpoint_resume_and_mesh_size_mismatch(data, tmp_path):
    """tests/test_checkpoint.py:21-80 and tests/test_robustness.py:88-103 on
    a 4-shard mesh: a fit resumed from iteration 1 equals the uninterrupted
    one bitwise; the file holds the global layout; a resume on 2 shards
    raises ValueError naming the mesh sizes."""
    X, meta = data
    kw = dict(max_iter_harmony=3, defer_r=False)
    full = _fit(X, meta, 4, checkpoint_dir=str(tmp_path), **kw)
    path = str(tmp_path / "harmony_iter_1.npz")
    with np.load(path) as z:
        assert int(z["n_devices"]) == 4
        assert z["Z_corr"].shape == (X.shape[1], full.cfg.N_pad)
        assert z["cache"].shape[0] == full.cfg.N_pad // 128
    resumed = _fit(X, meta, 4, resume_from=path, **kw)
    np.testing.assert_array_equal(resumed.Z_corr, full.Z_corr)
    np.testing.assert_array_equal(resumed.R, full.R)
    for h in HIST:
        assert getattr(resumed, h) == getattr(full, h), h
    with pytest.raises(ValueError, match="mesh: written on 4 device"):
        _fit(X, meta, 2, resume_from=path, **kw)


def test_preflight_sums_logical_shards_of_one_device(monkeypatch):
    """Shards that share a card are summed against it (utils/memory.py): a
    cap between one shard's and four shards' model passes one shard per
    card and refuses four logical shards on one device, with the mesh
    remedy."""
    cfg = EngineConfig(N=20_000_000, d=29, K=100, B=3, n_devices=4,
                       use_fused_xla=True)
    one = memory_envelope(cfg, 1)["total"]
    four = memory_envelope(cfg, 4)["total"]
    assert one < four
    cap = int((one + four) / 2 / 0.92)
    monkeypatch.setenv("HARMONYPY_DEVICE_MEM_BYTES", str(cap))
    with pytest.raises(CapacityError,
                       match="4 shards of a 4-device mesh") as exc:
        check_capacity(cfg, cpu_mesh(4))
    assert "-device mesh (one shard per card" in str(exc.value)
    _check_card(cfg, 1, cap, "cpu")          # one shard per card fits


def test_load_sharded_data_matches_shard_inputs(tmp_path):
    """tests/test_io.py:83-92 on the port: one parse, each shard uploaded;
    equal to shard_inputs and to the JAX package's sharded ingest."""
    rng = np.random.default_rng(0)
    N = 1000
    X = rng.normal(size=(N, 7)).astype(np.float32)
    path = str(tmp_path / "pcs.tsv")
    np.savetxt(path, X, delimiter="\t")
    meta = pd.DataFrame({"donor": rng.choice(["a", "b", "c"], size=N)})
    mesh = cpu_mesh(4)
    dat, cfg, n, (Pr_b, phi_n) = load_sharded_data(path, meta, "donor", mesh)
    assert n == N and cfg.N == N and cfg.d == 7 and cfg.n_devices == 4
    phi = pd.get_dummies(meta[["donor"]].astype("category")).to_numpy().T
    ref = sharding.shard_inputs(load_matrix_tsv(path).T,
                                phi.astype(np.float32), cfg, mesh)
    for f in ("Z_orig", "Phi", "mask"):
        assert len(getattr(dat, f)) == 4
        for a, b in zip(getattr(dat, f), getattr(ref, f)):
            assert torch.equal(a, b), f
    jd, jcfg, _, (jPr, jphi_n) = j_load_sharded(path, meta, "donor",
                                                jax_mesh(n_devices=4))
    assert jcfg.N_pad == cfg.N_pad and jcfg.use_fused_xla == \
        cfg.use_fused_xla
    np.testing.assert_array_equal(
        sharding.cat_cells(dat.Z_orig).numpy(), np.asarray(jd.Z_orig))
    np.testing.assert_array_equal(sharding.cat_cells(dat.mask).numpy(),
                                  np.asarray(jd.mask))
    np.testing.assert_array_equal(Pr_b, jPr)
    np.testing.assert_array_equal(phi_n, jphi_n)


def test_harmony_integrate_on_a_mesh(data):
    """tests/test_cli.py:65-71: the scanpy helper passes mesh= through, and
    the 3-shard result is the 1-device result bitwise."""
    X, meta = data
    adata = types.SimpleNamespace(obsm={"X_pca": X}, obs=meta)
    ho = harmony_integrate(adata, "batch", mesh=cpu_mesh(3), **FIT)
    assert ho.cfg.n_devices == 3
    np.testing.assert_array_equal(adata.obsm["X_pca_harmony"],
                                  _fit(X, meta, 1).Z_corr)


def test_mesh_construction_and_errors(monkeypatch):
    m = make_mesh(["cpu"] * 3, n_devices=2)
    assert m.size == 2 and m.lead == torch.device("cpu")
    assert default_mesh("cpu").devices == (torch.device("cpu"),)
    assert resolve_mesh(m) is m
    with pytest.raises(ValueError, match="all CPU or all CUDA"):
        Mesh((torch.device("cpu"), torch.device("cuda", 0)))
    with pytest.raises(TypeError, match="Mesh"):
        resolve_mesh(object())
    with pytest.raises(ValueError, match="n_devices"):
        make_mesh(["cpu"], n_devices=2)
    with pytest.raises(NotImplementedError, match="item 11b"):
        initialize_distributed("localhost:1234", 2, 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices=\\['cpu'\\]"):
        make_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_mesh()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_mesh_fit_bitwise_on_logical_shards_of_the_card(cuda_device, data):
    """On the card: 4 logical shards of cuda:0 run the per-block entry
    (blocks x shards launches per pass) and give the one-device fit bit
    for bit."""
    X, meta = data
    one = ht.run_harmony(X, meta, ["batch"], device="cuda:0", **FIT)
    n0 = fe.launches_block
    four = ht.run_harmony(X, meta, ["batch"], mesh=make_mesh(["cuda:0"] * 4),
                          **FIT)
    assert fe.launches_block - n0 == (four.cfg.n_blocks * 4
                                      * four.state.n_passes)
    np.testing.assert_array_equal(four.Z_corr, one.Z_corr)
    for h in HIST:
        assert getattr(four, h) == getattr(one, h), h
