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
through the global rank frame (ops/update_r_fused.mesh_round); every other
reduction over chunks gathers the shards' per-chunk rows into the global
frame (ops/partition.frame_sum); the N-axis work outside the kernel runs on
each shard in the one-device layout (parallel/sharding.py). The fused fits
are therefore the one-device fits bit for bit on any mesh. The per-cell fit
sums shard partials in shard order: equal to reduction-order tolerance.

Profiler ranges (torch.profiler.record_function, no cost without a
profiler beyond a few microseconds per call): harmony::init,
harmony::kmeans_init, harmony::cluster, harmony::ridge_replay (deferred),
harmony::ridge (stored).

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
from torch.profiler import record_function

from .config import EngineConfig
from .ops.cuda.fused_estep import fused_estep, fused_estep_r
from .ops.kmeans import kmeans_init
from .ops.normalize import l2_normalize_cols
from .ops.objective import (chunk_objective_partials,
                            compute_objective_terms, cross_entropy_from_stats,
                            shard_sum)
from .ops.partition import (cell_partition_len, cell_slot_table, frame_sum,
                            iid_blocks, mesh_round_tables, partition_geometry,
                            stripe_blocks)
from .ops.replay import INIT_ELEMS, replay_apply, replay_normal_eq, windows
from .ops.ridge import moe_correct_ridge, solve_w
from .ops.update_r import compute_scale_dist, update_r
from .ops.update_r_fused import chunk_stats, make_zp3, mesh_round
from .parallel.sharding import (embed_cols, extract_chunks, extract_cols,
                                holds_window, one_device, pack, parts,
                                put_window, real_cols, window_of)
from .state import (HarmonyData, HarmonyParams, HarmonyState, append,
                    defer_placeholders, empty_histories)
from .utils.checkpoint import RngState, save_state
from .utils.logging import logger


def check_conv_kmeans(obj_buf, n: int, cfg: EngineConfig) -> bool:
    """Windowed k-means convergence (reference type 0, harmony.py:516-523);
    `n` is the count after the latest append."""
    w = cfg.window_size
    if n < w + 2:
        return False
    obj_old = torch.sum(obj_buf[n - w - 1: n - 1])
    obj_new = torch.sum(obj_buf[n - w: n])
    return bool(torch.abs(obj_old - obj_new) / torch.abs(obj_old)
                < cfg.epsilon_kmeans)


def check_conv_harmony(obj_h, n: int, cfg: EngineConfig) -> bool:
    """Signed harmony convergence (reference type 1, harmony.py:525-531):
    an objective increase also counts as converged."""
    if n < 2:
        return False
    obj_old, obj_new = obj_h[n - 2], obj_h[n - 1]
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


def normalize_cells(X, cfg: EngineConfig):
    """l2_normalize_cols of a sharded (rows, N_local) array, each shard in
    the one-device layout (harmony.py:238, 569)."""
    return pack(extract_cols(l2_normalize_cols(embed_cols(x, s, cfg)), s, cfg)
                for s, x in enumerate(parts(X)))


def _init_pass(Z_cos, Phi, mask, Y, sigma, cfg: EngineConfig, wins,
               put_r=None):
    """Per-chunk cache, centroid numerator and objective partials of the
    initial soft assignments (softmax of -dist/sigma, harmony.py:380-389),
    one window of chunks at a time, in the one-device layout of cfg;
    put_r(lo, w, r), when given, stores each window's assignments."""
    geom = partition_geometry(cfg)
    nc1, CH, K, d = geom.nc_cap + 1, geom.CH, cfg.K, cfg.d
    dev = Z_cos.device
    cache = torch.zeros((nc1, K, cfg.B1), dtype=torch.float32, device=dev)
    ybuf = torch.zeros((nc1, d, K), dtype=torch.float32, device=dev)
    kbuf = torch.zeros((nc1, 2), dtype=torch.float32, device=dev)
    z3 = Z_cos.reshape(d, nc1, CH).permute(1, 0, 2)
    p3 = Phi.reshape(cfg.B, nc1, CH).permute(1, 0, 2)
    m3 = mask.reshape(nc1, 1, CH)
    for lo, w in wins:
        sl = slice(lo, lo + w)
        dist = 2.0 * (1.0 - torch.einsum("dk,jdc->jkc", Y, z3[sl]))
        s = torch.exp(-dist / sigma[None, :, None])
        # In place: the bits of s / sum * m3, one window less held.
        r = s.div_(torch.sum(s, dim=1, keepdim=True)).mul_(m3[sl])  # (w,K,CH)
        if put_r is not None:
            put_r(lo, w, r)
        cache[sl] = chunk_stats(r, p3[sl])
        ybuf[sl] = torch.einsum("jdc,jkc->jdk", z3[sl], r)
        kbuf[sl] = torch.stack(chunk_objective_partials(
            r, dist, sigma, k_axis=1, chunk_axis=0), dim=1)
    return cache, ybuf, kbuf


def _init_fused(Z_cos, data: HarmonyData, Y, params: HarmonyParams,
                cfg: EngineConfig, R3s=None):
    """The init pass on every shard, each over the one-device windows that
    hold its chunks, reduced through the frame: (O, E, objective terms,
    the shards' caches, the centroid numerator). With R3s (each shard's
    chunk-major R) the assignments are also stored there in its dtype."""
    geom, cfg1 = partition_geometry(cfg), one_device(cfg)
    caches, ybufs, kbufs = [], [], []
    for s, (z, p, m) in enumerate(zip(parts(Z_cos), parts(data.Phi),
                                      parts(data.mask))):
        put_r = None
        if R3s is not None:
            def put_r(lo, w, r, R3=R3s[s], s=s):
                put_window(R3, r.to(R3.dtype), s, geom, lo, w)
        wins = [(lo, w) for lo, w in windows(cfg1, INIT_ELEMS)
                if holds_window(geom, s, lo, w)]
        out = _init_pass(embed_cols(z, s, cfg), embed_cols(p, s, cfg),
                         embed_cols(m[None], s, cfg)[0], Y.to(z.device),
                         params.sigma.to(z.device), cfg1, wins, put_r)
        for buf, o in zip((caches, ybufs, kbufs), out):
            buf.append(extract_chunks(o, s, geom))
    tot = frame_sum(caches, geom)                                # (K, B+1)
    E = tot[:, 0:1] * params.Pr_b[None, :]
    O = tot[:, 1:]
    ko = frame_sum(kbufs, geom) * (2000.0 / cfg.N)
    terms = (ko[0], ko[1], cross_entropy_from_stats(O, E, params, cfg))
    return O, E, terms, pack(caches), frame_sum(ybufs, geom)


@record_function("harmony::init")
def init_defer(data: HarmonyData, params: HarmonyParams, cfg: EngineConfig,
               gen: torch.Generator, init_Y=None) -> HarmonyState:
    """Normalize, seed the centroids, and make one pass over the chunks for
    the cache, O/E, the first objective and the first centroid numerator:
    the initial soft assignments are reduced away one window of chunks at a
    time (each shard: the windows that hold its chunks)."""
    geom = partition_geometry(cfg)
    Z_cos = normalize_cells(data.Z_orig, cfg)                    # harmony.py:238
    with record_function("harmony::kmeans_init"):
        Y = (kmeans_init(gen, real_cols(Z_cos, cfg), cfg) if init_Y is None
             else init_Y)
    Y = l2_normalize_cols(Y)                                     # harmony.py:377
    dev = Y.device
    O, E, terms, cache, Ysum0 = _init_fused(Z_cos, data, Y, params, cfg)
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


@record_function("harmony::init")
def init_stored(data: HarmonyData, params: HarmonyParams, cfg: EngineConfig,
                gen: torch.Generator, init_Y=None) -> HarmonyState:
    """Normalize, seed the centroids, and store the initial soft
    assignments R = softmax_k(-dist/sigma) (harmony.py:377-392) with O/E and
    the first objective (JAX package engine.py:221-284). Fused layout: the
    deferred fit's init pass, storing each window's R; cache and partials
    come from the fp32 R. Per-cell layout: O/E and the objective from the
    storage-rounded R, since its E-step re-reads the stored values; shard
    partials summed in shard order."""
    Z_cos = normalize_cells(data.Z_orig, cfg)                    # harmony.py:238
    with record_function("harmony::kmeans_init"):
        Y = (kmeans_init(gen, real_cols(Z_cos, cfg), cfg) if init_Y is None
             else init_Y)
    Y = l2_normalize_cols(Y)                                     # harmony.py:377
    dev, K = Y.device, cfg.K
    Rs, dists = [], []
    if cfg.fused_estep:
        geom = partition_geometry(cfg)
        Rs = [torch.zeros((geom.nc_cap + 1, K, geom.CH),
                          dtype=cfg.r_torch_dtype, device=z.device)
              for z in parts(Z_cos)]
        O, E, terms, cache, _ = _init_fused(Z_cos, data, Y, params, cfg, Rs)
    else:
        for z, m in zip(parts(Z_cos), parts(data.mask)):
            dist_mat = 2.0 * (1.0 - Y.to(z.device).T @ z)        # :380
            R = (compute_scale_dist(dist_mat, params.sigma.to(z.device))
                 * m[None, :])
            Rs.append(R.to(cfg.r_torch_dtype).to(torch.float32))
            dists.append(dist_mat)
        E = torch.outer(shard_sum([torch.sum(R, dim=1) for R in Rs], dev),
                        params.Pr_b)                             # :388
        O = shard_sum([R @ p.T for R, p in zip(Rs, parts(data.Phi))],
                      dev)                                       # :389
        cache = torch.zeros((1, 1, 1), dtype=torch.float32, device=dev)
        terms = compute_objective_terms(pack(Rs), pack(dists), O, E,
                                        data.Phi, params, cfg)
    st = HarmonyState(
        Z_corr=data.Z_orig, Z_cos=Z_cos,
        R=pack(R.to(cfg.r_torch_dtype).contiguous() for R in Rs), Y=Y, O=O,
        E=E, cache=cache, **empty_histories(cfg, dev),
        **defer_placeholders(cfg, dev), n_devices=cfg.n_devices)
    _append_terms(st, terms)
    st.n_harmony = append(st.obj_harmony, 0, st.obj_kmeans[0])  # harmony.py:392
    return st


def _k1_round(tables, ZP3s, Y, params: HarmonyParams, O, E, fast: bool,
              geom):
    """One deferred-R round: the one-launch K1 on one device, the mesh
    round (K1's per-block entry) on a mesh. Returns (O, E, caches, ybufs,
    kbufs) with the per-chunk buffers per shard."""
    if len(ZP3s) == 1:
        O, E, cache, ybuf, kbuf, _ = fused_estep(
            tables.slots[0], tables.removal, ZP3s[0], Y, params.sigma,
            params.theta, params.Pr_b, O, E, fast)
        return O, E, [cache], [ybuf], [kbuf]
    return mesh_round(tables, ZP3s, Y, params.sigma, params.theta,
                      params.Pr_b, O, E, fast, geom.J_fix)[:5]


@record_function("harmony::cluster")
def cluster(st: HarmonyState, ZP3s, params: HarmonyParams, cfg: EngineConfig,
            draw_blocks: Callable[[], torch.Tensor]) -> int:
    """Deferred-R k-means loop (harmony.py:437-462): every round runs the
    fused E-step and keeps its start-of-round inputs for the replays.
    Updates `st` in place; returns the number of rounds run."""
    geom = partition_geometry(cfg)
    fast = fast_ent(cfg)
    nc = 2000.0 / cfg.N
    devs = [z.device for z in ZP3s]
    Ysum = st.Ysum0
    for i in range(cfg.max_iter_kmeans):
        Y = l2_normalize_cols(Ysum).contiguous()                # harmony.py:443
        blocks = draw_blocks()
        tables = mesh_round_tables(blocks, parts(st.cache), geom, devs)
        st.rep_Y, st.rep_O, st.rep_E = Y, st.O, st.E
        st.rep_cache, st.rep_blocks = st.cache, blocks
        O, E, caches, ybufs, kbufs = _k1_round(tables, ZP3s, Y, params,
                                               st.O, st.E, fast, geom)
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
            cfg: EngineConfig, draw_blocks, ZO3s) -> None:
    """One harmony iteration (harmony.py:421-428): cluster, then the ridge
    correction by replaying the final round twice (normal equations;
    apply), then the type-1 convergence check. Updates `st` in place."""
    geom = partition_geometry(cfg)
    fast = fast_ent(cfg)
    ZP3s = _zp3s(st, data, cfg)
    rounds = cluster(st, ZP3s, params, cfg, draw_blocks)
    st.kmeans_rounds.append(rounds)
    st.n_rounds += 1
    st.n_harmony = append(st.obj_harmony, st.n_harmony,
                          st.obj_kmeans[st.n_kmeans - 1])

    with record_function("harmony::ridge_replay"):
        tables = mesh_round_tables(st.rep_blocks, parts(st.rep_cache), geom,
                                   [z.device for z in ZP3s])
        rep = (st.rep_Y, params.sigma, params.theta, params.Pr_b, st.rep_O,
               st.rep_E)
        S = replay_normal_eq(tables, ZP3s, ZO3s, rep, cfg, fast)
        W = solve_w(S, st.E, params, cfg)
        Zc3s, Zs3s, st.Ysum0 = replay_apply(tables, ZP3s, ZO3s, W, rep, cfg,
                                            fast)
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


@record_function("harmony::cluster")
def cluster_fused(st: HarmonyState, ZP3s, params: HarmonyParams,
                  cfg: EngineConfig, draw_blocks) -> int:
    """Stored-R fused k-means loop (JAX package engine.py:391-511): every
    round runs K2, which rewrites the chunk-major R3 in place in its
    storage dtype. The first centroid numerator comes from the stored R by
    a per-chunk product, window by window, and frame_sum. Returns the
    rounds run."""
    geom = partition_geometry(cfg)
    fast = fast_ent(cfg)
    nc = 2000.0 / cfg.N
    devs = [z.device for z in ZP3s]
    y_cs = []
    for s, (Z, R) in enumerate(zip(ZP3s, parts(st.R))):
        y_cs.append(torch.zeros((Z.shape[0], cfg.d, cfg.K),
                                dtype=torch.float32, device=Z.device))
        for lo, w in windows(one_device(cfg)):
            if holds_window(geom, s, lo, w):
                put_window(y_cs[-1], torch.einsum(
                    "jdc,jkc->jdk", window_of(Z, s, geom, lo, w)[:, cfg.B1:],
                    window_of(R, s, geom, lo, w).to(torch.float32)),
                    s, geom, lo, w)
    Ysum = frame_sum(y_cs, geom)
    for i in range(cfg.max_iter_kmeans):
        Y = l2_normalize_cols(Ysum).contiguous()                # harmony.py:443
        tables = mesh_round_tables(draw_blocks(), parts(st.cache), geom, devs)
        if len(ZP3s) == 1:
            _, O, E, cache, ybuf, kbuf = fused_estep_r(
                tables.slots[0], tables.removal, ZP3s[0], st.R, Y,
                params.sigma, params.theta, params.Pr_b, st.O, st.E, fast)
            caches, ybufs, kbufs = [cache], [ybuf], [kbuf]
        else:
            O, E, caches, ybufs, kbufs, _ = mesh_round(
                tables, ZP3s, Y, params.sigma, params.theta, params.Pr_b,
                st.O, st.E, fast, geom.J_fix, R3s=st.R)
        st.n_passes += 1
        st.Y, st.O, st.E, st.cache = Y, O, E, pack(caches)
        Ysum = frame_sum(ybufs, geom).T
        ko = frame_sum(kbufs, geom)
        if _round_end(st, i, (ko[0] * nc, ko[1] * nc,
                              cross_entropy_from_stats(O, E, params, cfg)),
                      cfg):
            return i + 1
    return cfg.max_iter_kmeans


@record_function("harmony::cluster")
def cluster_percell(st: HarmonyState, data: HarmonyData,
                    params: HarmonyParams, cfg: EngineConfig,
                    draw_blocks) -> int:
    """Per-cell k-means loop (JAX package engine.py:351-389): centroids
    from Z_cos R^T, the distances, one per-cell E-step over iid blocks, the
    objective from R. Returns the rounds run. On a mesh the centroid
    numerator and every block's O/E change are shard partials summed in
    shard order."""
    lead = st.Y.device
    for i in range(cfg.max_iter_kmeans):
        Y = l2_normalize_cols(shard_sum(                          # :443-444
            [z @ R.to(torch.float32).T
             for z, R in zip(parts(st.Z_cos), parts(st.R))], lead))
        blocks = draw_blocks()
        tables = [cell_slot_table(blocks, cfg, s).to(z.device)
                  for s, z in enumerate(parts(st.Z_cos))]
        dists = [2.0 * (1.0 - Y.to(z.device).T @ z)             # harmony.py:447
                 for z in parts(st.Z_cos)]
        st.R, st.E, st.O = update_r(pack(tables), st.R, pack(dists),
                                    data.Phi, st.E, st.O, params, cfg,
                                    data.mask)
        st.Y = Y
        if _round_end(st, i, compute_objective_terms(
                st.R, pack(dists), st.O, st.E, data.Phi, params, cfg), cfg):
            return i + 1
    return cfg.max_iter_kmeans


def iterate_stored(st: HarmonyState, data: HarmonyData,
                   params: HarmonyParams, cfg: EngineConfig,
                   draw_blocks) -> None:
    """One stored-R harmony iteration (JAX package engine.py:685-719):
    cluster, moe_correct_ridge on the stored R, normalize, the type-1
    convergence check. Updates `st` in place."""
    if cfg.fused_estep:
        rounds = cluster_fused(st, _zp3s(st, data, cfg), params, cfg,
                               draw_blocks)
    else:
        rounds = cluster_percell(st, data, params, cfg, draw_blocks)
    st.kmeans_rounds.append(rounds)
    st.n_rounds += 1
    st.n_harmony = append(st.obj_harmony, st.n_harmony,
                          st.obj_kmeans[st.n_kmeans - 1])
    with record_function("harmony::ridge"):
        st.Z_corr = moe_correct_ridge(data.Z_orig, data.Phi, st.R, st.E,
                                      params, cfg, data.mask)
    st.Z_cos = normalize_cells(st.Z_corr, cfg)                   # :569
    st.converged = check_conv_harmony(st.obj_harmony, st.n_harmony, cfg)


def fit(data: HarmonyData, params: HarmonyParams, cfg: EngineConfig,
        gen: torch.Generator, verbose: bool = False, init_Y=None,
        blocks_fn: Optional[Callable[[int], torch.Tensor]] = None,
        checkpoint_dir: Optional[str] = None, resume=None) -> HarmonyState:
    """init_cluster + harmonize (harmony.py:280-282, 419-435): the
    deferred-R, stored-R fused or per-cell fit as cfg selects.

    checkpoint_dir: write harmony_iter_{i}.npz after every harmony
    iteration i (utils/checkpoint.py). resume: (state, RngState) of a
    validated checkpoint on the fit's device, whose generator state `gen`
    already holds; the fit continues from its iteration n_rounds + 1 (JAX
    package api.py:395-436)."""
    cfg.validate()
    dev = _devices(data)[0]
    n_drawn = 0 if resume is None else resume[1].n_drawn

    def draw_blocks():
        nonlocal n_drawn
        if blocks_fn is not None:
            blocks = torch.as_tensor(blocks_fn(n_drawn), dtype=torch.int64,
                                     device=dev)
        elif cfg.fused_estep:
            geom = partition_geometry(cfg)
            blocks = stripe_blocks(gen, geom.NC_fixed, geom.L, geom.nb)
        else:
            blocks = iid_blocks(gen, cfg.N, cell_partition_len(cfg),
                                cfg.n_blocks)
        n_drawn += 1
        return blocks

    if resume is not None:
        st = resume[0]
    elif cfg.defer_r:
        st = init_defer(data, params, cfg, gen, init_Y)
    else:
        st = init_stored(data, params, cfg, gen, init_Y)
    if cfg.defer_r:
        geom = partition_geometry(cfg)
        ZO3s = [z.reshape(cfg.d, geom.nc_cap + 1, geom.CH).permute(
            1, 0, 2).contiguous() for z in parts(data.Z_orig)]

        def step():
            iterate(st, data, params, cfg, draw_blocks, ZO3s)
    else:
        def step():
            iterate_stored(st, data, params, cfg, draw_blocks)

    resumed = " (resumed)" if resume is not None else ""
    for i in range(st.n_rounds + 1, cfg.max_iter_harmony + 1):
        if st.converged:
            break
        if verbose:
            logger.info(f"Iteration {i} of {cfg.max_iter_harmony}{resumed}")
        step()
        if checkpoint_dir is not None:
            save_state(os.path.join(checkpoint_dir, f"harmony_iter_{i}.npz"),
                       st, RngState(gen.get_state(), gen.device.type,
                                    n_drawn), cfg)
        if st.converged:
            if verbose:
                logger.info(f"Converged after {i} iteration"
                            f"{'s' if i > 1 else ''}")
            break
    else:
        if verbose:
            logger.info("Stopped before convergence")
    return st
