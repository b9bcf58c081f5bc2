"""The Harmony engine on one device or a mesh of shards (JAX package
engine.py:51-719): the deferred-R fused path, the stored-R fused path and
the per-cell path.

  reference harmonize()        -> fit(): init + up to max_iter_harmony
                                  calls of iterate()
  reference cluster()          -> cluster() (deferred), cluster_fused()
                                  (stored, fused), cluster_percell():
                                  up to max_iter_kmeans rounds, windowed
                                  convergence
  reference update_R()         -> ops.cuda.fused_estep (K1, deferred) and
                                  fused_estep_r (K2, stored): the
                                  hand-written kernels on CUDA, their plain
                                  versions on CPU; ops.update_r (per-cell,
                                  plain torch everywhere)
  reference moe_correct_ridge()-> deferred: replay of the final round
                                  (normal equations, solve_w, apply);
                                  stored: ops.ridge.moe_correct_ridge
  reference init_cluster()     -> ops.kmeans.kmeans_init + init_defer() or
                                  init_stored()

On the deferred path nothing K x N is ever held: the soft assignments exist
only inside the kernel (rounds) or one window at a time (replays). The
stored paths keep R in cfg.r_dtype (fp32, or bf16 under low_memory).

On a mesh (parallel/), the N-scale data and state are lists of the shards'
tensors and the rest lives on the lead device. A fused round runs the
per-block entry of the kernel on every shard and re-adds each block
through the global rank frame on the lead device (ops/cuda/fused_estep.
fused_estep_mesh); every other reduction over chunks gathers the shards'
per-chunk rows into the global frame (ops/partition.frame_sum); the N-axis
work outside the kernel runs on each shard over the one-device windows of
chunks that hold its cells (parallel/sharding.py), and k-means init copies
its sample's columns from the shards that own them. The fused fits are
therefore the one-device fits bit for bit on any mesh, and no shard holds
an array of the one-device width. The per-cell fit sums shard partials in
shard order (ops/objective.shard_sum): equal to one device to
reduction-order tolerance.

Across processes (parallel.mesh.initialize_distributed) each process runs
its own shards; the frames, each block's rows and the per-cell fit's shard
partials are all-gathered, so every rank holds the same replicated state
bit for bit (the one-process mesh's) and takes every host branch (the
convergence checks, Lloyd's stop) on the same values, issuing the same
collectives in the same order.

Under matmul_precision "default" on a card (ops/products.runs_one_pass)
every product of the fit runs as one bf16 pass with fp32 accumulation, as
the JAX package's precision scopes run them (its engine.py:175, 205, 611,
685): the kernels' one-pass variant, and the torch products here, in the
k-means init and in the ridge through ops/products.py. `one_pass` of
fit / HarmonyStep / init_defer / init_stored makes that choice (None:
runs_one_pass of cfg and the data's device); the functions below them take
it as `one`. True on the CPU runs the torch products' plain version.

Profiler ranges (utils/profiling.span: a record_function while a
profiler records, one flag check otherwise): harmony::init,
harmony::kmeans_init, harmony::cluster, harmony::estep (the per-cell
E-step's block loop), harmony::ridge_replay (deferred), harmony::ridge
(stored); inside them harmony::tables (each round's and each replay's slot
tables and removal stats), harmony::k1 (each fused round's kernel launch:
K1, or K2 on the stored path; on a mesh its per-block entries and re-add)
and, in the replay, harmony::normal_eq, harmony::solve and
harmony::apply. Each statement at which the host waits for the card
has a sync::<site> range of its own: sync::conv_kmeans and
sync::conv_harmony here, sync::tables (ops/partition.py), sync::kmeans_seed
and sync::lloyd (ops/kmeans.py), sync::cholesky (ops/ridge.py). api.py
adds api::design, api::upload and api::readback around the engine.

Test hooks: `init_Y` replaces the k-means centroids, and `blocks_fn(i)`
returns the assignment of the i-th round of the fit (counted from 0 across
harmony iterations) in place of a draw from the generator: the (L,) chunk
assignment on the fused paths, the (L_cell,) cell assignment on the
per-cell path.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import torch

from .config import EngineConfig
from .ops.cuda.fused_estep import (codes_plan, fused_estep,
                                   fused_estep_mesh, fused_estep_r,
                                   mesh_plans)
from .ops.kmeans import kmeans_init
from .ops.normalize import l2_normalize_cells, l2_normalize_cols
from .ops.objective import (chunk_objective_partials,
                            compute_objective_terms, cross_entropy_from_stats,
                            shard_sum)
from .ops.partition import (cell_partition_len, cell_slot_table, frame_sum,
                            iid_blocks, mesh_round_tables, partition_geometry,
                            stripe_blocks)
from .ops.products import einsum, matmul, runs_one_pass
from .ops.replay import (INIT_ELEMS, replay_apply, replay_normal_eq,
                         round_codes, windows)
from .ops.ridge import moe_correct_ridge, solve_w
from .ops.update_r import compute_scale_dist, update_r
from .ops.update_r_fused import chunk_stats, make_zp3
from .parallel.mesh import local_shards
from .parallel.sharding import (cells_window, holds_window, one_device,
                                pack, parts, put_window, window_of)
from .state import (HarmonyData, HarmonyParams, HarmonyState, append,
                    defer_placeholders, empty_histories)
from .utils.checkpoint import RngState, save_state
from .utils.logging import logger
from .utils.profiling import span


def check_conv_kmeans(obj_buf, n: int, cfg: EngineConfig) -> bool:
    """Windowed k-means convergence (reference type 0, harmony.py:516-523);
    `n` is the count after the latest append."""
    w = cfg.window_size
    if n < w + 2:
        return False
    obj_old = torch.sum(obj_buf[n - w - 1: n - 1])
    obj_new = torch.sum(obj_buf[n - w: n])
    with span("sync::conv_kmeans"):
        return bool(torch.abs(obj_old - obj_new) / torch.abs(obj_old)
                    < cfg.epsilon_kmeans)


def check_conv_harmony(obj_h, n: int, cfg: EngineConfig) -> bool:
    """Signed harmony convergence (reference type 1, harmony.py:525-531):
    an objective increase also counts as converged."""
    if n < 2:
        return False
    obj_old, obj_new = obj_h[n - 2], obj_h[n - 1]
    with span("sync::conv_harmony"):
        return bool((obj_old - obj_new) / torch.abs(obj_old)
                    < cfg.epsilon_harmony)


def fast_ent(cfg: EngineConfig) -> bool:
    return cfg.fast_objective and cfg.n_covariates == 1


def _append_terms(st: HarmonyState, terms) -> None:
    ke, ent, cross = terms
    n = st.n_kmeans
    append(st.obj_kmeans, n, ke + ent + cross)
    append(st.obj_dist, n, ke)
    append(st.obj_entropy, n, ent)
    st.n_kmeans = append(st.obj_cross, n, cross)


def _devices(data: HarmonyData) -> list:
    return [z.device for z in parts(data.Z_orig)]


def normalize_cells(X):
    """Column L2 normalisation of a sharded (rows, N_local) array, each
    shard's columns on their own (harmony.py:238, 569): the one-device bits
    on any mesh (l2_normalize_cells)."""
    return pack(l2_normalize_cells(x) for x in parts(X))


def _init_pass(Z_cos, Phi, mask, Y, sigma, cfg: EngineConfig, s: int,
               wins, one: bool, put_r=None):
    """Per-chunk cache, centroid numerator and objective partials of the
    initial soft assignments (softmax of -dist/sigma, harmony.py:380-389)
    of shard s's (rows, N_local) cells (one device: s = 0), over the
    one-device windows of chunks `wins`, each window's cells copied into
    new chunk-major arrays of the one-device window shape
    (parallel/sharding.py `cells_window`); put_r(lo, w, r), when given,
    stores each window's assignments. one: the products as one bf16
    pass."""
    geom = partition_geometry(cfg)
    nc1, K, d = geom.nc_cap + 1, cfg.K, cfg.d
    dev = Z_cos.device
    cache = torch.zeros((nc1, K, cfg.B1), dtype=torch.float32, device=dev)
    ybuf = torch.zeros((nc1, d, K), dtype=torch.float32, device=dev)
    kbuf = torch.zeros((nc1, 2), dtype=torch.float32, device=dev)
    for lo, w in wins:
        z3 = cells_window(Z_cos, s, geom, lo, w)                    # (w,d,CH)
        dist = 2.0 * (1.0 - einsum("dk,jdc->jkc", Y, z3, one))
        e = torch.exp(-dist / sigma[None, :, None])
        # In place: the bits of e / sum * mask, one window less held.
        r = e.div_(torch.sum(e, dim=1, keepdim=True)).mul_(
            cells_window(mask[None], s, geom, lo, w))               # (w,K,CH)
        if put_r is not None:
            put_r(lo, w, r)
        put_window(cache, chunk_stats(r, cells_window(Phi, s, geom, lo, w)),
                   s, geom, lo, w)
        put_window(ybuf, einsum("jdc,jkc->jdk", z3, r, one), s, geom, lo, w)
        put_window(kbuf, torch.stack(chunk_objective_partials(
            r, dist, sigma, k_axis=1, chunk_axis=0), dim=1), s, geom, lo, w)
    return cache, ybuf, kbuf


def _init_fused(Z_cos, data: HarmonyData, Y, params: HarmonyParams,
                cfg: EngineConfig, one: bool, R3s=None):
    """The init pass on every shard, each over the one-device windows that
    hold its chunks, reduced through the frame: (O, E, objective terms,
    the shards' caches, the centroid numerator). With R3s (each shard's
    chunk-major R) the assignments are also stored there in its dtype."""
    geom, cfg1 = partition_geometry(cfg), one_device(cfg)
    caches, ybufs, kbufs = [], [], []
    for i, (s, z, p, m) in enumerate(zip(
            local_shards(cfg.n_devices), parts(Z_cos), parts(data.Phi),
            parts(data.mask))):
        put_r = None
        if R3s is not None:
            def put_r(lo, w, r, R3=R3s[i], s=s):
                put_window(R3, r.to(R3.dtype), s, geom, lo, w)
        wins = [(lo, w) for lo, w in windows(cfg1, INIT_ELEMS)
                if holds_window(geom, s, lo, w)]
        out = _init_pass(z, p, m, Y.to(z.device), params.sigma.to(z.device),
                         cfg, s, wins, one, put_r)
        for buf, o in zip((caches, ybufs, kbufs), out):
            buf.append(o)
    tot = frame_sum(caches, geom)                                # (K, B+1)
    E = tot[:, 0:1] * params.Pr_b[None, :]
    # Contiguous, as every round's O: a mesh pass takes its O as it is.
    O = tot[:, 1:].contiguous()
    ko = frame_sum(kbufs, geom) * (2000.0 / cfg.N)
    terms = (ko[0], ko[1], cross_entropy_from_stats(O, E, params, cfg))
    return O, E, terms, pack(caches), frame_sum(ybufs, geom)


def _one(one_pass: Optional[bool], cfg: EngineConfig,
         data: HarmonyData) -> bool:
    """one_pass, or None: whether cfg's fit runs the one-pass products on
    the data's device (ops/products.runs_one_pass)."""
    if one_pass is None:
        return runs_one_pass(cfg, _devices(data)[0])
    return bool(one_pass)


@span("harmony::init")
def init_defer(data: HarmonyData, params: HarmonyParams, cfg: EngineConfig,
               gen: torch.Generator, init_Y=None,
               one_pass: Optional[bool] = None) -> HarmonyState:
    """Normalize, seed the centroids, and make one pass over the chunks for
    the cache, O/E, the first objective and the first centroid numerator:
    the initial soft assignments are reduced away one window of chunks at a
    time (each shard: the windows that hold its chunks)."""
    geom = partition_geometry(cfg)
    one = _one(one_pass, cfg, data)
    Z_cos = normalize_cells(data.Z_orig)                         # harmony.py:238
    with span("harmony::kmeans_init"):
        Y = kmeans_init(gen, Z_cos, cfg, one) if init_Y is None else init_Y
    Y = l2_normalize_cols(Y)                                     # harmony.py:377
    dev = Y.device
    O, E, terms, cache, Ysum0 = _init_fused(Z_cos, data, Y, params, cfg, one)
    hist = empty_histories(cfg, dev)
    st = HarmonyState(
        Z_corr=data.Z_orig, Z_cos=Z_cos,
        R=torch.zeros((1, 1), dtype=cfg.r_torch_dtype, device=dev),
        Y=Y, O=O, E=E, cache=cache,
        **hist, Ysum0=Ysum0, rep_Y=Y, rep_O=O, rep_E=E,
        rep_blocks=torch.zeros((geom.L,), dtype=torch.int64, device=dev),
        rep_cache=cache, rep_Zcos=Z_cos, n_devices=cfg.n_devices)
    _append_terms(st, terms)
    st.n_harmony = append(st.obj_harmony, 0, st.obj_kmeans[0])  # harmony.py:392
    return st


@span("harmony::init")
def init_stored(data: HarmonyData, params: HarmonyParams, cfg: EngineConfig,
                gen: torch.Generator, init_Y=None,
                one_pass: Optional[bool] = None) -> HarmonyState:
    """Normalize, seed the centroids, and store the initial soft
    assignments R = softmax_k(-dist/sigma) (harmony.py:377-392) with O/E and
    the first objective (JAX package engine.py:221-284). Fused layout: the
    deferred fit's init pass, storing each window's R; cache and partials
    come from the fp32 R. Per-cell layout: O/E and the objective from the
    storage-rounded R, since its E-step re-reads the stored values; shard
    partials summed in shard order (O and E packed into one)."""
    one = _one(one_pass, cfg, data)
    Z_cos = normalize_cells(data.Z_orig)                         # harmony.py:238
    with span("harmony::kmeans_init"):
        Y = kmeans_init(gen, Z_cos, cfg, one) if init_Y is None else init_Y
    Y = l2_normalize_cols(Y)                                     # harmony.py:377
    dev, K = Y.device, cfg.K
    Rs, dists = [], []
    if cfg.fused_estep:
        geom = partition_geometry(cfg)
        Rs = [torch.zeros((geom.nc_cap + 1, K, geom.CH),
                          dtype=cfg.r_torch_dtype, device=z.device)
              for z in parts(Z_cos)]
        O, E, terms, cache, _ = _init_fused(Z_cos, data, Y, params, cfg, one,
                                            Rs)
    else:
        for z, m in zip(parts(Z_cos), parts(data.mask)):
            dist_mat = 2.0 * (1.0 - matmul(Y.to(z.device).T, z,
                                           one))                 # :380
            R = (compute_scale_dist(dist_mat, params.sigma.to(z.device))
                 * m[None, :])
            Rs.append(R.to(cfg.r_torch_dtype).to(torch.float32))
            dists.append(dist_mat)
        tot = shard_sum([torch.cat([torch.sum(R, dim=1)[:, None],
                                    matmul(R, p.T, one)], dim=1)
                         for R, p in zip(Rs, parts(data.Phi))], dev,
                        cfg.n_devices)
        E = torch.outer(tot[:, 0], params.Pr_b)                  # :388
        O = tot[:, 1:]                                           # :389
        cache = torch.zeros((1, 1, 1), dtype=torch.float32, device=dev)
        terms = compute_objective_terms(pack(Rs), pack(dists), O, E,
                                        data.Phi, params, cfg, one)
    st = HarmonyState(
        Z_corr=data.Z_orig, Z_cos=Z_cos,
        R=pack(R.to(cfg.r_torch_dtype).contiguous() for R in Rs), Y=Y, O=O,
        E=E, cache=cache, **empty_histories(cfg, dev),
        **defer_placeholders(cfg, dev), n_devices=cfg.n_devices)
    _append_terms(st, terms)
    st.n_harmony = append(st.obj_harmony, 0, st.obj_kmeans[0])  # harmony.py:392
    return st


def fit_codes(data: HarmonyData, cfg: EngineConfig):
    """The codes a fit's rounds and replays pass to the one-launch kernel
    (ops/replay.round_codes, once per fit), where they take its codes
    plan: one card, the fused path, a shape in the kernel's codes plan and
    one covariate (codes_plan); else None (the CPU runs the plain round,
    which reads the design rows)."""
    dev = _devices(data)[0]
    if (dev.type != "cuda" or cfg.n_devices != 1 or not cfg.fused_estep
            or not codes_plan(cfg.K, cfg.B, cfg.d, cfg.matmul_precision,
                              cfg.n_covariates)):
        return None
    return round_codes(data.Phi, data.mask, cfg)


def _k1_round(tables, ZP3s, Y, params: HarmonyParams, O, E, fast: bool,
              geom, precision: str, codes=None):
    """One deferred-R round: the one-launch K1 on one device, the mesh
    round (K1's per-block entry) on a mesh, in the kernels' variant of
    `precision`; codes: fit_codes'. Returns (O, E, caches, ybufs, kbufs)
    with the per-chunk buffers per shard."""
    with span("harmony::k1"):
        if geom.n_devices == 1:
            O, E, cache, ybuf, kbuf, _ = fused_estep(
                tables.slots[0], tables.removal, ZP3s[0], Y, params.sigma,
                params.theta, params.Pr_b, O, E, fast, precision=precision,
                codes=codes)
            return O, E, [cache], [ybuf], [kbuf]
        return fused_estep_mesh(tables, ZP3s, Y, params.sigma, params.theta,
                                params.Pr_b, O, E, fast, geom.J_fix,
                                precision=precision)[:5]


@span("harmony::cluster")
def cluster(st: HarmonyState, ZP3s, params: HarmonyParams, cfg: EngineConfig,
            draw_blocks: Callable[[], torch.Tensor], codes=None) -> int:
    """Deferred-R k-means loop (harmony.py:437-462): every round runs the
    fused E-step and keeps its start-of-round inputs for the replays.
    Updates `st` in place; returns the number of rounds run. codes:
    fit_codes'."""
    geom = partition_geometry(cfg)
    fast = fast_ent(cfg)
    nc = 2000.0 / cfg.N
    devs = [z.device for z in ZP3s]
    Ysum = st.Ysum0
    for i in range(cfg.max_iter_kmeans):
        Y = l2_normalize_cols(Ysum).contiguous()                # harmony.py:443
        blocks = draw_blocks()
        with span("harmony::tables"):
            tables = mesh_round_tables(blocks, parts(st.cache), geom, devs)
        st.rep_Y, st.rep_O, st.rep_E = Y, st.O, st.E
        st.rep_cache, st.rep_blocks = st.cache, blocks
        O, E, caches, ybufs, kbufs = _k1_round(tables, ZP3s, Y, params,
                                               st.O, st.E, fast, geom,
                                               cfg.matmul_precision, codes)
        st.n_passes += 1
        st.Y, st.O, st.E, st.cache = Y, O, E, pack(caches)
        Ysum = frame_sum(ybufs, geom).T
        ko = frame_sum(kbufs, geom)
        if _round_end(st, i, (ko[0] * nc, ko[1] * nc,
                              cross_entropy_from_stats(O, E, params, cfg)),
                      cfg):
            return i + 1
    return cfg.max_iter_kmeans


def _zp3s(st: HarmonyState, data: HarmonyData, cfg: EngineConfig) -> list:
    return [make_zp3(z, p, m, cfg) for z, p, m in
            zip(parts(st.Z_cos), parts(data.Phi), parts(data.mask))]


def iterate(st: HarmonyState, data: HarmonyData, params: HarmonyParams,
            cfg: EngineConfig, draw_blocks, ZO3s, one: bool,
            codes=None) -> None:
    """One harmony iteration (harmony.py:421-428): cluster, then the ridge
    correction by replaying the final round twice (normal equations;
    apply), then the type-1 convergence check. Updates `st` in place; one:
    the ridge's products as one bf16 pass; codes: fit_codes', for the
    rounds and their replays."""
    geom = partition_geometry(cfg)
    fast = fast_ent(cfg)
    ZP3s = _zp3s(st, data, cfg)
    rounds = cluster(st, ZP3s, params, cfg, draw_blocks, codes)
    st.kmeans_rounds.append(rounds)
    st.n_rounds += 1
    st.n_harmony = append(st.obj_harmony, st.n_harmony,
                          st.obj_kmeans[st.n_kmeans - 1])

    with span("harmony::ridge_replay"):
        with span("harmony::tables"):
            tables = mesh_round_tables(st.rep_blocks, parts(st.rep_cache),
                                       geom, [z.device for z in ZP3s])
        rep = (st.rep_Y, params.sigma, params.theta, params.Pr_b, st.rep_O,
               st.rep_E)
        with span("harmony::normal_eq"):
            S = replay_normal_eq(tables, ZP3s, ZO3s, rep, cfg, fast, one=one,
                                 codes=codes)
        with span("harmony::solve"):
            W = solve_w(S, st.E, params, cfg)
        with span("harmony::apply"):
            Zc3s, Zs3s, st.Ysum0 = replay_apply(tables, ZP3s, ZO3s, W, rep,
                                                cfg, fast, one=one,
                                                codes=codes)
        st.n_passes += 2 * len(windows(one_device(cfg)))
    st.rep_Zcos = st.Z_cos
    st.Z_corr = pack(z.permute(1, 0, 2).reshape(cfg.d, -1) for z in Zc3s)
    st.Z_cos = pack(z.permute(1, 0, 2).reshape(cfg.d, -1) for z in Zs3s)
    st.converged = check_conv_harmony(st.obj_harmony, st.n_harmony, cfg)


def _round_end(st: HarmonyState, i: int, terms, cfg: EngineConfig) -> bool:
    """Append a round's objective terms; whether the loop has converged."""
    _append_terms(st, terms)
    return i > cfg.window_size and check_conv_kmeans(st.obj_kmeans,
                                                     st.n_kmeans, cfg)


@span("harmony::cluster")
def cluster_fused(st: HarmonyState, ZP3s, params: HarmonyParams,
                  cfg: EngineConfig, draw_blocks, one: bool,
                  codes=None) -> int:
    """Stored-R fused k-means loop (JAX package engine.py:391-511): every
    round runs K2, which rewrites the chunk-major R3 in place in its
    storage dtype. The first centroid numerator comes from the stored R by
    a per-chunk product, window by window, and frame_sum (one: as one bf16
    pass). codes: fit_codes'. Returns the rounds run."""
    geom = partition_geometry(cfg)
    fast = fast_ent(cfg)
    nc = 2000.0 / cfg.N
    devs = [z.device for z in ZP3s]
    y_cs = []
    for s, Z, R in zip(local_shards(cfg.n_devices), ZP3s, parts(st.R)):
        y_cs.append(torch.zeros((Z.shape[0], cfg.d, cfg.K),
                                dtype=torch.float32, device=Z.device))
        for lo, w in windows(one_device(cfg)):
            if holds_window(geom, s, lo, w):
                put_window(y_cs[-1], einsum(
                    "jdc,jkc->jdk", window_of(Z, s, geom, lo, w)[:, cfg.B1:],
                    window_of(R, s, geom, lo, w).to(torch.float32), one),
                    s, geom, lo, w)
    Ysum = frame_sum(y_cs, geom)
    for i in range(cfg.max_iter_kmeans):
        Y = l2_normalize_cols(Ysum).contiguous()                # harmony.py:443
        blocks = draw_blocks()
        with span("harmony::tables"):
            tables = mesh_round_tables(blocks, parts(st.cache), geom, devs)
        with span("harmony::k1"):
            if geom.n_devices == 1:
                _, O, E, cache, ybuf, kbuf = fused_estep_r(
                    tables.slots[0], tables.removal, ZP3s[0], st.R, Y,
                    params.sigma, params.theta, params.Pr_b, st.O, st.E,
                    fast, precision=cfg.matmul_precision,
                    codes=codes)
                caches, ybufs, kbufs = [cache], [ybuf], [kbuf]
            else:
                O, E, caches, ybufs, kbufs, _ = fused_estep_mesh(
                    tables, ZP3s, Y, params.sigma, params.theta, params.Pr_b,
                    st.O, st.E, fast, geom.J_fix, R3s=parts(st.R),
                    precision=cfg.matmul_precision)
        st.n_passes += 1
        st.Y, st.O, st.E, st.cache = Y, O, E, pack(caches)
        Ysum = frame_sum(ybufs, geom).T
        ko = frame_sum(kbufs, geom)
        if _round_end(st, i, (ko[0] * nc, ko[1] * nc,
                              cross_entropy_from_stats(O, E, params, cfg)),
                      cfg):
            return i + 1
    return cfg.max_iter_kmeans


def percell_slot_tables(blocks, cfg: EngineConfig, devices) -> list:
    """The per-cell slot table of each of this process's shards (devices:
    theirs), cut from the global (L,) cell assignment at the shard's
    GLOBAL index (local_shards): in a process group, rank r's first shard
    is not shard 0."""
    return [cell_slot_table(blocks, cfg, s).to(dev)
            for s, dev in zip(local_shards(cfg.n_devices), devices)]


@span("harmony::cluster")
def cluster_percell(st: HarmonyState, data: HarmonyData,
                    params: HarmonyParams, cfg: EngineConfig,
                    draw_blocks, one: bool) -> int:
    """Per-cell k-means loop (JAX package engine.py:351-389): centroids
    from Z_cos R^T, the distances, one per-cell E-step over iid blocks, the
    objective from R. Returns the rounds run. On a mesh the centroid
    numerator, every block's O/E change and the objective are shard
    partials summed in shard order: 2 n_blocks + 2 shard sums a round
    (across processes, as many all-gathers). one: the products as one
    bf16 pass."""
    lead = st.Y.device
    devs = [z.device for z in parts(st.Z_cos)]
    for i in range(cfg.max_iter_kmeans):
        Y = l2_normalize_cols(shard_sum(                          # :443-444
            [matmul(z, R.to(torch.float32).T, one)
             for z, R in zip(parts(st.Z_cos), parts(st.R))], lead,
            cfg.n_devices))
        tables = percell_slot_tables(draw_blocks(), cfg, devs)
        dists = [2.0 * (1.0 - matmul(Y.to(z.device).T, z, one))  # :447
                 for z in parts(st.Z_cos)]
        with span("harmony::estep"):
            st.R, st.E, st.O = update_r(pack(tables), st.R, pack(dists),
                                        data.Phi, st.E, st.O, params, cfg,
                                        data.mask, one)
        st.Y = Y
        if _round_end(st, i, compute_objective_terms(
                st.R, pack(dists), st.O, st.E, data.Phi, params, cfg, one),
                cfg):
            return i + 1
    return cfg.max_iter_kmeans


def iterate_stored(st: HarmonyState, data: HarmonyData,
                   params: HarmonyParams, cfg: EngineConfig,
                   draw_blocks, one: bool, codes=None) -> None:
    """One stored-R harmony iteration (JAX package engine.py:685-719):
    cluster, moe_correct_ridge on the stored R, normalize, the type-1
    convergence check. Updates `st` in place; one: the products outside
    the kernels as one bf16 pass; codes: fit_codes'."""
    if cfg.fused_estep:
        rounds = cluster_fused(st, _zp3s(st, data, cfg), params, cfg,
                               draw_blocks, one, codes)
    else:
        rounds = cluster_percell(st, data, params, cfg, draw_blocks, one)
    st.kmeans_rounds.append(rounds)
    st.n_rounds += 1
    st.n_harmony = append(st.obj_harmony, st.n_harmony,
                          st.obj_kmeans[st.n_kmeans - 1])
    with span("harmony::ridge"):
        st.Z_corr = moe_correct_ridge(data.Z_orig, data.Phi, st.R, st.E,
                                      params, cfg, data.mask, one)
    st.Z_cos = normalize_cells(st.Z_corr)                        # :569
    st.converged = check_conv_harmony(st.obj_harmony, st.n_harmony, cfg)


class HarmonyStep:
    """One harmony iteration of a fit's state on the path cfg selects
    (deferred-R `iterate`, else `iterate_stored`), each round's partition
    drawn from `gen` (the stripes of the fused paths, the iid cells of the
    per-cell path) or, as a test hook, given by `blocks_fn(i)`. n_drawn
    counts the draws, from the count a resumed fit had reached. one_pass:
    the products outside the kernels as one bf16 pass (None: as
    runs_one_pass decides for the data's device). `fit` and
    utils/profiling.profile_fit both step a state through it."""

    def __init__(self, data: HarmonyData, params: HarmonyParams,
                 cfg: EngineConfig, gen: torch.Generator,
                 blocks_fn: Optional[Callable[[int], torch.Tensor]] = None,
                 n_drawn: int = 0, one_pass: Optional[bool] = None):
        self.data, self.params, self.cfg = data, params, cfg
        self.gen, self.blocks_fn, self.n_drawn = gen, blocks_fn, n_drawn
        self.one = _one(one_pass, cfg, data)
        self.dev = _devices(data)[0]
        self.ZO3s = None        # the deferred ridge's chunk-major Z_orig
        self.codes = fit_codes(data, cfg)   # the kernel's codes plan

    def draw_blocks(self) -> torch.Tensor:
        cfg = self.cfg
        if self.blocks_fn is not None:
            blocks = torch.as_tensor(self.blocks_fn(self.n_drawn),
                                     dtype=torch.int64, device=self.dev)
        elif cfg.fused_estep:
            geom = partition_geometry(cfg)
            blocks = stripe_blocks(self.gen, geom.NC_fixed, geom.L, geom.nb)
        else:
            blocks = iid_blocks(self.gen, cfg.N, cell_partition_len(cfg),
                                cfg.n_blocks)
        self.n_drawn += 1
        return blocks

    def __call__(self, st: HarmonyState) -> None:
        cfg = self.cfg
        # The mesh passes' plans live through the iteration, or through
        # the fit that holds a mesh_plans block around its steps.
        with mesh_plans():
            if cfg.defer_r:
                if self.ZO3s is None:
                    geom = partition_geometry(cfg)
                    self.ZO3s = [z.reshape(cfg.d, geom.nc_cap + 1, geom.CH)
                                 .permute(1, 0, 2).contiguous()
                                 for z in parts(self.data.Z_orig)]
                iterate(st, self.data, self.params, cfg, self.draw_blocks,
                        self.ZO3s, self.one, self.codes)
            else:
                iterate_stored(st, self.data, self.params, cfg,
                               self.draw_blocks, self.one, self.codes)


def fit(data: HarmonyData, params: HarmonyParams, cfg: EngineConfig,
        gen: torch.Generator, verbose: bool = False, init_Y=None,
        blocks_fn: Optional[Callable[[int], torch.Tensor]] = None,
        checkpoint_dir: Optional[str] = None, resume=None,
        one_pass: Optional[bool] = None) -> HarmonyState:
    """init_cluster + harmonize (harmony.py:280-282, 419-435): the
    deferred-R, stored-R fused or per-cell fit as cfg selects.

    checkpoint_dir: write harmony_iter_{i}.npz after every harmony
    iteration i (utils/checkpoint.py). resume: (state, RngState) of a
    validated checkpoint on the fit's device, whose generator state `gen`
    already holds; the fit continues from its iteration n_rounds + 1 (JAX
    package api.py:395-436). one_pass: the products outside the kernels
    as one bf16 pass (None: runs_one_pass of cfg and the data's device)."""
    cfg.validate()
    step = HarmonyStep(data, params, cfg, gen, blocks_fn,
                       0 if resume is None else resume[1].n_drawn, one_pass)
    if resume is not None:
        st = resume[0]
    elif cfg.defer_r:
        st = init_defer(data, params, cfg, gen, init_Y, step.one)
    else:
        st = init_stored(data, params, cfg, gen, init_Y, step.one)

    resumed = " (resumed)" if resume is not None else ""
    # One plan per mesh pass geometry for the whole fit (made on its first
    # pass of that geometry, reused by every later one), none after it.
    with mesh_plans():
        for i in range(st.n_rounds + 1, cfg.max_iter_harmony + 1):
            if st.converged:
                break
            if verbose:
                logger.info(f"Iteration {i} of {cfg.max_iter_harmony}"
                            f"{resumed}")
            step(st)
            if checkpoint_dir is not None:
                save_state(os.path.join(checkpoint_dir,
                                        f"harmony_iter_{i}.npz"),
                           st, RngState(gen.get_state(), gen.device.type,
                                        step.n_drawn), cfg)
            if st.converged:
                if verbose:
                    logger.info(f"Converged after {i} iteration"
                                f"{'s' if i > 1 else ''}")
                break
        else:
            if verbose:
                logger.info("Stopped before convergence")
    return st
