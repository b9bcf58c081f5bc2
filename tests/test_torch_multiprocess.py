"""Multi-process runs of the port on the CPU: torch.distributed with the gloo
backend, worker processes of this file joined through a file:// init
method, each with a timeout.

Two topologies of one 4-shard mesh (2 processes x 2 CPU shards, 4 x 1)
against the one-process 4-shard CPU mesh, bitwise (the JAX package's
tools/multihost_smoke.py:285-338 on the port): the deferred fit, its .R
(materialize_r), the stored fit, a checkpoint then resume; per-process
ingest (load_sharded_data); the cross-process frame_rows, gather_cols and
plain mesh round (frame_readd of the gathered rows) against their
one-process forms; the pbmc golden gate across 2 processes; the per-cell
fit and compute_lisi across processes raising NotImplementedError; the
CLI's `correct --coordinator` with rank 0 the only writer. The one-process
mesh is held against the JAX package by tests/test_torch_mesh*.py.

    python tests/test_torch_multiprocess.py <task> <rank> <world> <dir> <shards>

runs one worker by hand."""

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

# Test workers share the CPU cores with each other: one intra-op thread
# each keeps torch from oversubscribing.
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)

import harmonypy_tpu_torch as ht                                # noqa: E402
from harmonypy_tpu_torch.api import materialize_r               # noqa: E402
from harmonypy_tpu_torch.config import EngineConfig              # noqa: E402
from harmonypy_tpu_torch.io import load_sharded_data             # noqa: E402
from harmonypy_tpu_torch.ops import partition as tp              # noqa: E402
from harmonypy_tpu_torch.ops.update_r_fused import mesh_round    # noqa: E402
from harmonypy_tpu_torch.parallel import mesh as pm              # noqa: E402
from harmonypy_tpu_torch.parallel import sharding                # noqa: E402

N, D, B, SHARDS = 4000, 8, 3, 4
FIT = dict(verbose=False, chunk_size=128, nclust=20, max_iter_harmony=3)
HIST = ("objective_harmony", "objective_kmeans", "objective_kmeans_dist",
        "objective_kmeans_entropy", "objective_kmeans_cross",
        "kmeans_rounds")
# Seconds a collective may wait, and a worker may run.
COLLECTIVE_S, WORKER_S = 60, 240


def _problem(n=N, d=D, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(5, d)) * 4
    g = rng.integers(0, 5, n)
    b = rng.integers(0, B, n)
    shifts = rng.normal(size=(B, d)) * 2
    X = (centers[g] + shifts[b] + rng.normal(size=(n, d))).astype(np.float32)
    return X, pd.DataFrame({"batch": [f"b{i}" for i in b]})


def _unit_cfg():
    return EngineConfig(N=N, d=D, K=12, B=B, n_devices=SHARDS,
                        use_fused_xla=True, chunk_size=128)


def _unit_inputs(cfg):
    """Every shard's inputs of the unit checks, from one numpy seed: per
    shard a per-chunk buffer, the (rows, N_pad) array gather_cols reads,
    its sampled ids, and a round's tables and slabs."""
    geom = tp.partition_geometry(cfg)
    rng = np.random.default_rng(1)
    nc1 = geom.nc_cap + 1
    bufs = [torch.as_tensor(rng.normal(size=(nc1, cfg.K, B + 1))
                            .astype(np.float32)) for _ in range(SHARDS)]
    X = torch.as_tensor(sharding.pad_cells(rng.normal(size=(5, N)), cfg))
    ids = torch.as_tensor(rng.integers(0, N, 300))
    blocks = tp.stripe_blocks(torch.Generator().manual_seed(2),
                              geom.NC_fixed, geom.L, geom.nb)
    Z = rng.normal(size=(D, N)).astype(np.float32)
    Z /= np.linalg.norm(Z, axis=0)
    phi = np.eye(B, dtype=np.float32)[rng.integers(0, B, N)].T
    zp = [torch.cat([m[None], p, z]).reshape(1 + B + D, nc1, geom.CH)
          .permute(1, 0, 2).contiguous() for z, p, m in zip(
              *(sharding.split_cells(torch.as_tensor(a), cfg,
                                     pm.Mesh((torch.device("cpu"),) * SHARDS))
                for a in (sharding.pad_cells(Z, cfg),
                          sharding.pad_cells(phi, cfg),
                          sharding.shard_mask(cfg))))]
    Y = torch.as_tensor(rng.normal(size=(D, cfg.K)).astype(np.float32))
    Y = Y / torch.linalg.norm(Y, dim=0)
    consts = (Y, torch.full((cfg.K,), 0.1), torch.full((B,), 2.0),
              torch.full((B,), 1.0 / B),
              torch.as_tensor(rng.random((cfg.K, B)).astype(np.float32)),
              torch.as_tensor(rng.random((cfg.K, B)).astype(np.float32)))
    return geom, bufs, X, ids, blocks, zp, consts


def _units(shard_ids):
    """frame_rows, gather_cols and the plain mesh round (its per-block
    re-add through frame_readd) on the shards `shard_ids` of the unit
    inputs: the results every rank holds."""
    cfg = _unit_cfg()
    geom, bufs, X, ids, blocks, zp, (Y, sig, th, prb, O, E) = \
        _unit_inputs(cfg)
    mine = list(shard_ids)
    xs = list(X.reshape(5, SHARDS, -1).unbind(1))
    tabs = tp.mesh_round_tables(blocks, [bufs[s] for s in mine], geom,
                                [torch.device("cpu")] * len(mine))
    out = mesh_round(tabs, [zp[s] for s in mine], Y, sig, th, prb, O, E,
                     False, geom.J_fix)
    return dict(frame=tp.frame_rows([bufs[s] for s in mine], geom).numpy(),
                cols=sharding.gather_cols([xs[s] for s in mine], ids,
                                          cfg).numpy(),
                removal=tabs.removal.numpy(), O=out[0].numpy(),
                E=out[1].numpy(),
                cache=tp.frame_rows(out[2], geom).numpy())


def _fit_arrays(ho, prefix):
    out = {f"{prefix}_Z": ho.Z_corr, f"{prefix}_R": ho.R}
    for a in HIST:
        out[f"{prefix}_{a}"] = np.asarray(getattr(ho, a))
    return out


def _fits(mesh, X, meta, tmp):
    """The deferred fit (checkpointed), .R, the stored fit and the resumed
    fit on `mesh`."""
    ck = os.path.join(tmp, f"ck{pm.process_count()}")
    out = _fit_arrays(ht.run_harmony(X, meta, ["batch"], mesh=mesh,
                                     checkpoint_dir=ck, **FIT), "deferred")
    out.update(_fit_arrays(ht.run_harmony(
        X, meta, ["batch"], mesh=mesh, defer_r=False, **FIT), "stored"))
    out.update(_fit_arrays(ht.run_harmony(
        X, meta, ["batch"], mesh=mesh,
        resume_from=os.path.join(ck, "harmony_iter_1.npz"), **FIT),
        "resumed"))
    return out


def _worker(rank, world, tmp, shards):
    """One rank of a `world`-process run of `shards` CPU shards each."""
    pm.initialize_distributed(f"file://{tmp}/pg", world, rank, device="cpu",
                              timeout_s=COLLECTIVE_S)
    try:
        X, meta = _problem()
        mesh = pm.make_mesh(["cpu"] * shards)
        assert mesh.size == SHARDS and mesh.n_processes == world
        assert list(mesh.shard_ids) == list(range(rank * shards,
                                                  (rank + 1) * shards))
        out = _fits(mesh, X, meta, tmp)
        out.update({f"unit_{k}": v
                    for k, v in _units(mesh.shard_ids).items()})
        # Per-process ingest from a seekable .npy and a TSV file.
        for ext in ("npy", "tsv"):
            data, cfg, n, _ = load_sharded_data(
                os.path.join(tmp, f"pcs.{ext}"), meta, "batch", mesh,
                cfg=_unit_cfg())
            out[f"ingest_{ext}"] = sharding.gather_cells(data.Z_orig,
                                                         cfg).numpy()
            out[f"ingest_{ext}_mask"] = sharding.gather_cells(data.mask,
                                                              cfg).numpy()
        # Not ported across processes: each raises on every rank.
        for name, call in (
                ("percell", lambda: ht.run_harmony(
                    X, meta, ["batch"], mesh=mesh, verbose=False)),
                ("lisi", lambda: ht.compute_lisi(X, meta, ["batch"],
                                                 mesh=mesh))):
            try:
                call()
                out[f"raises_{name}"] = np.asarray("")
            except NotImplementedError as e:
                out[f"raises_{name}"] = np.asarray(str(e))
        if world == 2:
            d = os.path.join(REPO, "harmonypy_tpu", "data")
            pmeta = pd.read_csv(os.path.join(d, "pbmc_3500_meta.tsv.gz"),
                                sep="\t")
            pcs = pd.read_csv(os.path.join(d, "pbmc_3500_pcs.tsv.gz"),
                              sep="\t")
            gold = pd.read_csv(os.path.join(
                d, "pbmc_3500_pcs_harmonized.tsv.gz"), sep="\t")
            ho = ht.run_harmony(pcs, pmeta, ["donor"], verbose=False,
                                chunk_size=128,
                                mesh=pm.make_mesh(["cpu"]))
            gold = gold.iloc[:, 1:] if gold.iloc[:, 0].dtype == "object" \
                else gold
            out["pbmc_r"] = np.array([
                np.corrcoef(ho.Z_corr[:, i], gold.iloc[:, i].values)[0, 1]
                for i in range(ho.Z_corr.shape[1])])
            out["pbmc_shards"] = np.asarray(ho.cfg.n_devices)
        np.savez(os.path.join(tmp, f"out_{rank}.npz"), **out)
    finally:
        pm.shutdown_distributed()


def _spawn(args_list, env_extra=None):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, HERE, os.environ.get("PYTHONPATH", "")]))
    env.update(env_extra or {})
    return [subprocess.Popen(a, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for a in args_list]


def _wait(procs):
    """Wait for every worker (at most WORKER_S); kill all if one fails or
    hangs. Returns their outputs."""
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WORKER_S)
            outs.append(out)
            assert p.returncode == 0, out[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both topologies started at once; the one-process references computed
    meanwhile. Returns ({world: [per-rank arrays]}, reference arrays)."""
    X, meta = _problem()
    dirs, procs = {}, []
    for world, shards in ((2, 2), (4, 1)):
        tmp = str(tmp_path_factory.mktemp(f"mp{world}"))
        np.save(os.path.join(tmp, "pcs.npy"), X)
        np.savetxt(os.path.join(tmp, "pcs.tsv"), X, delimiter="\t")
        dirs[world] = tmp
        procs.append(_spawn([[sys.executable, __file__, str(r), str(world),
                              tmp, str(shards)] for r in range(world)]))
    ref_dir = str(tmp_path_factory.mktemp("ref"))
    try:
        mesh = pm.make_mesh(["cpu"] * SHARDS)
        ref = _fits(mesh, X, meta, ref_dir)
        ref.update({f"unit_{k}": v for k, v in _units(range(SHARDS)).items()})
        cfg = _unit_cfg()
        ref["ingest"] = sharding.cat_cells(sharding.shard_inputs(
            X.T, np.zeros((B, N), np.float32), cfg, mesh).Z_orig).numpy()
        ref["ingest_mask"] = sharding.shard_mask(cfg)
    finally:
        for ps in procs:
            _wait(ps)
    got = {w: [dict(np.load(os.path.join(dirs[w], f"out_{r}.npz")))
               for r in range(w)] for w in dirs}
    return got, ref


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("fit", ["deferred", "stored", "resumed"])
def test_fits_bitwise_equal_one_process_mesh(runs, world, fit):
    """Z_corr, .R, the five histories and kmeans_rounds of every rank equal
    the one-process 4-shard mesh's bit for bit (resumed: the checkpointing
    deferred fit's)."""
    got, ref = runs
    want = "deferred" if fit == "resumed" else fit
    for rank, out in enumerate(got[world]):
        for a in ("Z", "R") + HIST:
            np.testing.assert_array_equal(
                out[f"{fit}_{a}"], ref[f"{want}_{a}"],
                err_msg=f"{world} processes, rank {rank}: {fit} {a}")
    assert np.all(np.isfinite(got[world][0][f"{fit}_Z"]))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("what", ["frame", "cols", "removal", "O", "E",
                                  "cache"])
def test_collectives_equal_one_process(runs, world, what):
    """frame_rows (the frame all-gathered), gather_cols (owned columns
    all-gathered, taken by owner), the round tables' removal stats and the
    plain mesh round (each block's rows all-gathered, re-added by every
    rank through frame_readd) equal their one-process forms bitwise."""
    got, ref = runs
    for out in got[world]:
        np.testing.assert_array_equal(out[f"unit_{what}"],
                                      ref[f"unit_{what}"])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("ext", ["npy", "tsv"])
def test_load_sharded_data_per_process(runs, world, ext):
    """Each process reads its cell range and uploads its shards; gathered,
    the padded layout equals shard_inputs of the whole file."""
    got, ref = runs
    for out in got[world]:
        np.testing.assert_array_equal(out[f"ingest_{ext}"], ref["ingest"])
        np.testing.assert_array_equal(out[f"ingest_{ext}_mask"],
                                      ref["ingest_mask"])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("what", ["percell", "lisi"])
def test_unported_across_processes_raise(runs, world, what):
    """The per-cell fit and LISI across processes raise NotImplementedError
    naming their ROADMAP.md item, on every rank."""
    got, _ = runs
    for out in got[world]:
        assert "ROADMAP.md §1 item 5" in str(out[f"raises_{what}"])


def test_golden_pbmc_across_two_processes(runs):
    """tests/test_harmony_golden.py:33,49-61 across 2 processes (one shard
    each, chunk_size=128): min per-PC Pearson r >= 0.99 against R."""
    got, _ = runs
    for out in got[2]:
        assert int(out["pbmc_shards"]) == 2
        assert np.min(out["pbmc_r"]) >= 0.99, out["pbmc_r"]


def test_cli_correct_with_coordinator(tmp_path):
    """`correct --coordinator` in 2 processes (gloo on the CPU): rank 0
    alone writes --out, equal bitwise to the one-process 2-shard fit.
    20,480 cells: the fused fit at the default chunk size."""
    X, meta = _problem(n=20_480)
    pcs, mpath = str(tmp_path / "pcs.npy"), str(tmp_path / "meta.tsv")
    np.save(pcs, X)
    meta.to_csv(mpath, sep="\t", index=False)
    out = str(tmp_path / "z.npy")
    args = ["correct", "--pcs", pcs, "--meta", mpath, "--vars", "batch",
            "--out", out, "--device", "cpu", "--nclust", "20",
            "--max-iter-harmony", "2", "--quiet",
            "--coordinator", f"file://{tmp_path}/pg", "--num-processes",
            "2"]
    # One intra-op thread, as this process runs: torch's CPU reductions
    # split their work by the thread count, and so round by it.
    outs = _wait(_spawn([[sys.executable, "-m", "harmonypy_tpu_torch",
                          *args, "--process-id", str(r)]
                         for r in range(2)], dict(OMP_NUM_THREADS="1")))
    assert "wrote" in outs[0] and "wrote" not in outs[1], outs
    ref = ht.run_harmony(X, meta, ["batch"], verbose=False, nclust=20,
                         max_iter_harmony=2, mesh=pm.make_mesh(["cpu"] * 2))
    assert ref.cfg.defer_r
    np.testing.assert_array_equal(np.load(out), ref.Z_corr)


def test_initialize_distributed_arguments(monkeypatch):
    """Malformed coordinators and ranks raise ValueError before any
    connection; no device means a card, and none here raises (no fallback
    to the CPU); init methods pass through."""
    with pytest.raises(ValueError, match="not host:port"):
        pm.initialize_distributed("localhost:port", 2, 0, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        pm.initialize_distributed("localhost:1234", 2, 2, device="cpu")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="num_processes"):
        pm.initialize_distributed("localhost:1234", None, 0, device="cpu")
    assert pm._init_method("file:///tmp/x") == "file:///tmp/x"
    assert pm._init_method("h:29500") == "tcp://h:29500"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pm.initialize_distributed("localhost:1234", 2, 0)
    assert not pm.spans_processes() and pm.process_count() == 1


@pytest.mark.cuda
def test_card_ranks_bitwise_equal_one_process_mesh(tmp_path):
    """On a card: 2 ranks on cuda:0 under gloo, 2 shards each, give the
    one-process 4-shard mesh's deferred fit bitwise (NCCL refuses two ranks
    on one card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    X, meta = _problem()
    procs = _spawn([[sys.executable, __file__, "card", str(r), "2",
                     str(tmp_path), "2"] for r in range(2)])
    _wait(procs)
    ref = ht.run_harmony(X, meta, ["batch"],
                         mesh=pm.make_mesh(["cuda:0"] * SHARDS), **FIT)
    for r in range(2):
        out = np.load(os.path.join(tmp_path, f"card_{r}.npz"))
        np.testing.assert_array_equal(out["Z"], ref.Z_corr)
        np.testing.assert_array_equal(out["R"], ref.R)


def _card_worker(rank, world, tmp, shards):
    pm.initialize_distributed(f"file://{tmp}/pg", world, rank,
                              device="cuda:0", backend="gloo",
                              timeout_s=COLLECTIVE_S)
    try:
        X, meta = _problem()
        ho = ht.run_harmony(X, meta, ["batch"],
                            mesh=pm.make_mesh(["cuda:0"] * shards), **FIT)
        np.savez(os.path.join(tmp, f"card_{rank}.npz"), Z=ho.Z_corr, R=ho.R)
    finally:
        pm.shutdown_distributed()


if __name__ == "__main__":
    if sys.argv[1] == "card":
        _card_worker(*map(int, sys.argv[2:4]), sys.argv[4], int(sys.argv[5]))
    else:
        _worker(*map(int, sys.argv[1:3]), sys.argv[3], int(sys.argv[4]))
