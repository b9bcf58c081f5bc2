"""Multi-process runs of the port on the CPU: torch.distributed with the gloo
backend, worker processes of this file joined through a file:// init
method, each with a timeout.

Two topologies of one 4-shard mesh (2 processes x 2 CPU shards, 4 x 1)
against the one-process 4-shard CPU mesh, bitwise (the JAX package's
tools/multihost_smoke.py:200-214, 285-338 on the port): the deferred fit,
its .R (materialize_r), the stored fit, a checkpoint then resume; the
per-cell fit, its checkpoints (rank 0 the only writer) and resume, and the
slot tables its rounds cut at each shard's global index; compute_lisi by
brute force and by the pruned search (probe, fallback; the index from rank
0); per-process ingest (load_sharded_data); the cross-process frame_rows,
gather_cols, shard_sum and plain mesh round (frame_readd of the gathered
rows) against their one-process forms; the pbmc golden gate across 2
processes, fused and per-cell; the 2-process per-cell fit against the JAX
package's per-cell mesh fit with its init and partitions injected; the
CLI's `correct --coordinator` with rank 0 the only writer. The one-process
mesh is held against the JAX package by tests/test_torch_mesh*.py.

    python tests/test_torch_multiprocess.py <task> <rank> <world> <dir> <shards>

runs one worker by hand."""

import contextlib
import os
import subprocess
import sys
import time

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
import harmonypy_tpu_torch.lisi as tlisi                        # noqa: E402
from harmonypy_tpu_torch import engine                          # noqa: E402
from harmonypy_tpu_torch.api import materialize_r               # noqa: E402
from harmonypy_tpu_torch.config import EngineConfig              # noqa: E402
from harmonypy_tpu_torch.io import load_sharded_data             # noqa: E402
from harmonypy_tpu_torch.ops import knn_pruned as tkp           # noqa: E402
from harmonypy_tpu_torch.ops import partition as tp              # noqa: E402
from harmonypy_tpu_torch.ops.objective import shard_sum          # noqa: E402
from harmonypy_tpu_torch.ops.update_r_fused import mesh_round    # noqa: E402
from harmonypy_tpu_torch.parallel import mesh as pm              # noqa: E402
from harmonypy_tpu_torch.parallel import sharding                # noqa: E402

N, D, B, SHARDS = 4000, 8, 3, 4
FIT = dict(verbose=False, chunk_size=128, nclust=20, max_iter_harmony=3)
# The per-cell fit: the default chunk size below 20,480 cells.
FIT_PC = dict(verbose=False, nclust=20, max_iter_harmony=3)
# LISI's pruned case visits 4 of the index's 10 clusters, so its
# certificate fails for ~30% of the queries and the fallback answers them.
LISI_VISIT = 4
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
                shard_sum=shard_sum([bufs[s] for s in mine],
                                    torch.device("cpu"), SHARDS).numpy(),
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


def _percell(mesh, X, meta, tmp):
    """The per-cell fit (checkpointed) and its resume on `mesh`; the slot
    tables the fit's first round passed to update_r, and how many
    checkpoints this process wrote."""
    ck = os.path.join(tmp, f"pc{pm.process_count()}")
    tables, writes = [], []
    update_r, savez = engine.update_r, np.savez

    def spy(slot_table, *a, **kw):
        if not tables:
            tables.extend(t.numpy() for t in sharding.parts(slot_table))
        return update_r(slot_table, *a, **kw)

    def count(*a, **kw):
        writes.append(a[0])
        return savez(*a, **kw)
    engine.update_r, np.savez = spy, count
    try:
        ho = ht.run_harmony(X, meta, ["batch"], mesh=mesh, checkpoint_dir=ck,
                            **FIT_PC)
    finally:
        engine.update_r, np.savez = update_r, savez
    assert not ho.cfg.fused_estep and ho.cfg.n_devices == SHARDS
    out = _fit_arrays(ho, "percell")
    out.update(_fit_arrays(ht.run_harmony(
        X, meta, ["batch"], mesh=mesh,
        resume_from=os.path.join(ck, "harmony_iter_1.npz"), **FIT_PC),
        "percell_resumed"))
    out["percell_tables"] = np.stack(tables)
    out["percell_writes"] = np.asarray(len(writes))
    return out


@contextlib.contextmanager
def _patched(module, name, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def _lisi(mesh, X, meta, stats=None):
    """compute_lisi by brute force and by the pruned search (LISI_VISIT
    clusters visited: the fallback answers the uncertified rows), and the
    pruned scan alone (k = 6, 4 clusters visited) of a 256-cluster index of
    X's first two columns from mesh_index, in batches of 12 clusters,
    so the probe batches and the rest are dealt over every shard; `stats`
    gets the scan's."""
    out = {"lisi_brute": ht.compute_lisi(X, meta, ["batch"], mesh=mesh,
                                         knn="brute")}
    with _patched(tlisi, "_DEFAULT_VISIT", LISI_VISIT):
        out["lisi_pruned"] = ht.compute_lisi(X, meta, ["batch"], mesh=mesh,
                                             knn="pruned")
    Xt = torch.as_tensor(X[:, :2]).contiguous()
    index = tkp.mesh_index(Xt, 256, mesh)
    with _patched(tkp, "_SLAB_BYTES", 1 << 20):
        d, i, c = tkp.pruned_knn(Xt, 5, visit=4, index=index, mesh=mesh,
                                 stats=stats)
    out.update(lisi_scan_dist=d.numpy(), lisi_scan_idx=i.numpy(),
               lisi_scan_cert=c.numpy())
    return out


def _jax_inputs(tmp):
    """The JAX package's init centroids and per-round cell assignments,
    written by the test process: waited for."""
    path = os.path.join(tmp, "jax_in.npz")
    for _ in range(WORKER_S * 10):
        if os.path.exists(path):
            with np.load(path) as z:
                return z["Y0"], z["blocks"]
        time.sleep(0.1)
    raise TimeoutError(path)


def _pbmc():
    d = os.path.join(REPO, "harmonypy_tpu", "data")
    pmeta = pd.read_csv(os.path.join(d, "pbmc_3500_meta.tsv.gz"), sep="\t")
    pcs = pd.read_csv(os.path.join(d, "pbmc_3500_pcs.tsv.gz"), sep="\t")
    gold = pd.read_csv(os.path.join(
        d, "pbmc_3500_pcs_harmonized.tsv.gz"), sep="\t")
    gold = gold.iloc[:, 1:] if gold.iloc[:, 0].dtype == "object" else gold
    return pcs, pmeta, gold


def _pbmc_r(ho, gold):
    return np.array([np.corrcoef(ho.Z_corr[:, i], gold.iloc[:, i].values)
                     [0, 1] for i in range(ho.Z_corr.shape[1])])


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
        out.update(_percell(mesh, X, meta, tmp))
        out.update(_lisi(mesh, X, meta))
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
        if world == 2:
            pcs, pmeta, gold = _pbmc()
            one = pm.make_mesh(["cpu"])
            ho = ht.run_harmony(pcs, pmeta, ["donor"], verbose=False,
                                chunk_size=128, mesh=one)
            out["pbmc_r"] = _pbmc_r(ho, gold)
            out["pbmc_shards"] = np.asarray(ho.cfg.n_devices)
            ho = ht.run_harmony(pcs, pmeta, ["donor"], verbose=False,
                                mesh=one)
            out["pbmc_pc_r"] = _pbmc_r(ho, gold)
            out["pbmc_pc_fused"] = np.asarray(ho.cfg.fused_estep)
            Y0, blocks = _jax_inputs(tmp)
            ho = ht.run_harmony(X, meta, ["batch"], mesh=mesh, _init_Y=Y0,
                                _blocks_fn=lambda i: blocks[i], **FIT_PC)
            out.update(jax_Z=ho.Z_corr, jax_rounds=np.asarray(
                ho.kmeans_rounds), jax_cell_len=np.asarray(
                tp.cell_partition_len(ho.cfg)))
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


def _jax_percell(X, meta, tmp):
    """The JAX package's per-cell fit on a 4-device mesh (FIT_PC), its init
    centroids and per-round cell assignments from its key splits (api.py:
    394, engine.py:209, 361), the latter two written to tmp/jax_in.npz for
    the 2-process workers. Returns (Z_corr, its cell_partition_len)."""
    import jax

    import harmonypy_tpu as hm
    from harmonypy_tpu.ops import partition as jp
    from harmonypy_tpu.ops.update_r import cell_partition_len
    from harmonypy_tpu.parallel.mesh import make_mesh as jax_mesh
    ho = hm.run_harmony(X, meta, ["batch"], mesh=jax_mesh(n_devices=SHARDS),
                        random_state=0, **FIT_PC)
    cfg = ho.cfg
    assert not cfg.fused_estep and cfg.n_devices == SHARDS
    st0 = ho._engine.init_fn(ho._data, ho._params, jax.random.PRNGKey(0))
    key, _ = jax.random.split(jax.random.PRNGKey(0))
    blocks = []
    for _ in range(cfg.max_iter_kmeans * cfg.max_iter_harmony):
        key, k_r = jax.random.split(key)
        blocks.append(np.array(jp.iid_blocks(
            k_r, cfg.N, cell_partition_len(cfg), cfg.n_blocks)))
    part = os.path.join(tmp, "jax_in.part")
    with open(part, "wb") as fh:
        np.savez(fh, Y0=np.array(st0.Y), blocks=np.stack(blocks))
    os.replace(part, os.path.join(tmp, "jax_in.npz"))
    return ho.Z_corr, cell_partition_len(cfg)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both topologies started at once; the JAX package's per-cell mesh fit
    (whose init the 2-process workers wait for) and the one-process
    references computed meanwhile. Returns ({world: [per-rank arrays]},
    reference arrays)."""
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
        jax_ref = _jax_percell(X, meta, dirs[2])
        mesh = pm.make_mesh(["cpu"] * SHARDS)
        ref = _fits(mesh, X, meta, ref_dir)
        ref.update(_percell(mesh, X, meta, ref_dir))
        scan = {}
        ref.update(_lisi(mesh, X, meta, scan))
        pruned = {}
        tlisi._knn_pruned(torch.as_tensor(X, dtype=torch.float64), 89,
                          torch.arange(N), visit=LISI_VISIT, stats=pruned)
        ref.update(jax=jax_ref, lisi_stats=pruned, scan_stats=scan)
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
@pytest.mark.parametrize("fit", ["fit", "resumed"])
def test_percell_fit_bitwise_equal_one_process_mesh(runs, world, fit):
    """The per-cell fit across processes (every shard sum an all-gather
    of the partials, then the one-process adds): Z_corr, .R, the five
    histories and kmeans_rounds of every rank equal the one-process 4-shard
    mesh's bit for bit; rank 0 alone writes the checkpoints, and a resume
    from the first is the uninterrupted fit's bits."""
    got, ref = runs
    key = "percell" if fit == "fit" else "percell_resumed"
    for rank, out in enumerate(got[world]):
        for a in ("Z", "R") + HIST:
            np.testing.assert_array_equal(
                out[f"{key}_{a}"], ref[f"percell_{a}"],
                err_msg=f"{world} processes, rank {rank}: {fit} {a}")
        if fit == "fit":
            iters = len(out["percell_kmeans_rounds"])
            assert int(out["percell_writes"]) == (iters if rank == 0
                                                  else 0), rank
    assert np.all(np.isfinite(got[world][0][f"{key}_Z"]))


@pytest.mark.parametrize("world", [2, 4])
def test_percell_slot_tables_cut_at_global_shard(runs, world):
    """The slot tables cluster_percell hands to update_r on rank r are the
    one-process mesh's tables of the rank's GLOBAL shards: rank 1 of 2
    holds shards 2 and 3, whose cells are not shards 0 and 1's."""
    got, ref = runs
    per = SHARDS // world
    for rank, out in enumerate(got[world]):
        np.testing.assert_array_equal(
            out["percell_tables"],
            ref["percell_tables"][rank * per: (rank + 1) * per])
    assert not np.array_equal(ref["percell_tables"][0],
                              ref["percell_tables"][2])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("knn", ["brute", "pruned"])
def test_lisi_across_processes_bitwise(runs, world, knn):
    """compute_lisi with the whole X on every rank returns the one-process
    4-shard mesh's values bitwise on every rank: brute force (each rank's
    shards' queries, rows all-gathered per host batch); pruned (the index
    from rank 0, each rank's cluster batches, rows merged by owner, the
    fallback re-answering the same uncertified rows everywhere), and the
    pruned scan of a 256-cluster index with its probe batch."""
    got, ref = runs
    keys = [f"lisi_{knn}"]
    if knn == "pruned":
        keys += ["lisi_scan_dist", "lisi_scan_idx", "lisi_scan_cert"]
        assert ref["lisi_stats"]["n_fallback"] > 0, ref["lisi_stats"]
        sc = ref["scan_stats"]
        assert sc["probe_ok"] and sc["visit"] == 4 and sc["scan_batch"] == 12
        assert not ref["lisi_scan_cert"].all()
        np.testing.assert_allclose(ref["lisi_pruned"], ref["lisi_brute"],
                                   rtol=1e-4, atol=1e-4)
    for rank, out in enumerate(got[world]):
        for k in keys:
            np.testing.assert_array_equal(out[k], ref[k],
                                          err_msg=f"rank {rank}: {k}")


def test_percell_golden_pbmc_across_two_processes(runs):
    """tests/test_harmony_golden.py:33 across 2 processes at default
    settings, which is the per-cell fit: min per-PC Pearson r >= 0.99."""
    got, _ = runs
    for out in got[2]:
        assert not bool(out["pbmc_pc_fused"])
        assert np.min(out["pbmc_pc_r"]) >= 0.99, out["pbmc_pc_r"]


def test_percell_two_processes_against_jax_mesh(runs):
    """The 2-process per-cell fit (2 shards each) against the JAX
    package's 4-device per-cell fit, its init centroids and partitions
    injected (tests/test_torch_percell.py): atol 5e-4 max|Z|, the JAX
    package's per-cell mesh contract (tools/multihost_smoke.py:319-327)."""
    got, ref = runs
    Zj, cell_len = ref["jax"]
    scale = float(np.max(np.abs(Zj)))
    for out in got[2]:
        assert int(out["jax_cell_len"]) == cell_len
        np.testing.assert_allclose(out["jax_Z"], Zj, rtol=0,
                                   atol=5e-4 * scale)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("what", ["frame", "cols", "shard_sum", "removal",
                                  "O", "E", "cache"])
def test_collectives_equal_one_process(runs, world, what):
    """frame_rows (the frame all-gathered), gather_cols (owned columns
    all-gathered, taken by owner), shard_sum (the partials all-gathered,
    added in shard order), the round tables' removal stats and the plain
    mesh round (each block's rows all-gathered, re-added by every rank
    through frame_readd) equal their one-process forms bitwise."""
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
