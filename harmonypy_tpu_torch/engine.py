"""The Harmony engine on one device (JAX package engine.py:51-719): the
deferred-R fused path, the stored-R fused path and the per-cell path.

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
                            compute_objective_terms, cross_entropy_from_stats)
from .ops.partition import (cell_partition_len, cell_slot_table, frame_sum,
                            iid_blocks, partition_geometry, round_tables,
                            stripe_blocks)
from .ops.replay import replay_apply, replay_normal_eq, windows
from .ops.ridge import moe_correct_ridge, solve_w
from .ops.update_r import compute_scale_dist, update_r
from .ops.update_r_fused import chunk_stats, make_zp3
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


@record_function("harmony::init")
def init_defer(data: HarmonyData, params: HarmonyParams, cfg: EngineConfig,
               gen: torch.Generator, init_Y=None) -> HarmonyState:
    """Normalize, seed the centroids, and make one pass over the chunks for
    the cache, O/E, the first objective and the first centroid numerator:
    the initial soft assignments (softmax of -dist/sigma, harmony.py:380-389)
    are reduced away one window of chunks at a time."""
    geom = partition_geometry(cfg)
    Z_cos = l2_normalize_cols(data.Z_orig)                       # harmony.py:238
    with record_function("harmony::kmeans_init"):
        Y = kmeans_init(gen, Z_cos, cfg) if init_Y is None else init_Y
    Y = l2_normalize_cols(Y)                                     # harmony.py:377

    nc1, CH, K, d = geom.nc_cap + 1, geom.CH, cfg.K, cfg.d
    dev = Z_cos.device
    cache = torch.zeros((nc1, K, cfg.B1), dtype=torch.float32, device=dev)
    ybuf = torch.zeros((nc1, d, K), dtype=torch.float32, device=dev)
    kbuf = torch.zeros((nc1, 2), dtype=torch.float32, device=dev)
    z3 = Z_cos.reshape(d, nc1, CH).permute(1, 0, 2)
    p3 = data.Phi.reshape(cfg.B, nc1, CH).permute(1, 0, 2)
    m3 = data.mask.reshape(nc1, 1, CH)
    for lo, w in windows(cfg):
        sl = slice(lo, lo + w)
        dist = 2.0 * (1.0 - torch.einsum("dk,jdc->jkc", Y, z3[sl]))
        s = torch.exp(-dist / params.sigma[None, :, None])
        r = s / torch.sum(s, dim=1, keepdim=True) * m3[sl]      # (w, K, CH)
        cache[sl] = chunk_stats(r, p3[sl])
        ybuf[sl] = torch.einsum("jdc,jkc->jdk", z3[sl], r)
        kbuf[sl] = torch.stack(chunk_objective_partials(
            r, dist, params.sigma, k_axis=1, chunk_axis=0), dim=1)

    tot = frame_sum(cache, geom)                                  # (K, B+1)
    E = tot[:, 0:1] * params.Pr_b[None, :]
    O = tot[:, 1:]
    ko = frame_sum(kbuf, geom) * (2000.0 / cfg.N)
    terms = (ko[0], ko[1], cross_entropy_from_stats(O, E, params, cfg))
    hist = empty_histories(cfg, dev)
    st = HarmonyState(
        Z_corr=data.Z_orig, Z_cos=Z_cos,
        R=torch.zeros((1, 1), dtype=cfg.r_torch_dtype, device=dev),
        Y=Y, O=O, E=E, cache=cache,
        **hist, Ysum0=frame_sum(ybuf, geom), rep_Y=Y, rep_O=O, rep_E=E,
        rep_blocks=torch.zeros((geom.L,), dtype=torch.int64, device=dev),
        rep_cache=cache, rep_Zcos=Z_cos)
    _append_terms(st, terms)
    st.n_harmony = append(st.obj_harmony, 0, st.obj_kmeans[0])  # harmony.py:392
    return st


@record_function("harmony::init")
def init_stored(data: HarmonyData, params: HarmonyParams, cfg: EngineConfig,
                gen: torch.Generator, init_Y=None) -> HarmonyState:
    """Normalize, seed the centroids, and store the initial soft
    assignments R = softmax_k(-dist/sigma) (harmony.py:377-392) with O/E and
    the first objective (JAX package engine.py:221-284). Fused layout:
    per-chunk cache and partials from the fp32 R, reduced by frame_sum.
    Per-cell layout: O/E and the objective from the storage-rounded R,
    since its E-step re-reads the stored values."""
    Z_cos = l2_normalize_cols(data.Z_orig)                       # harmony.py:238
    with record_function("harmony::kmeans_init"):
        Y = kmeans_init(gen, Z_cos, cfg) if init_Y is None else init_Y
    Y = l2_normalize_cols(Y)                                     # harmony.py:377
    dev, K = Z_cos.device, cfg.K
    dist_mat = 2.0 * (1.0 - Y.T @ Z_cos)                         # harmony.py:380
    R = compute_scale_dist(dist_mat, params.sigma) * data.mask[None, :]
    if cfg.fused_estep:
        geom = partition_geometry(cfg)
        nc1, CH = geom.nc_cap + 1, geom.CH
        R = R.reshape(K, nc1, CH).permute(1, 0, 2)               # (nc1, K, CH)
        cache = chunk_stats(R, data.Phi.reshape(cfg.B, nc1, CH).permute(
            1, 0, 2))
        tot = frame_sum(cache, geom)
        E = tot[:, 0:1] * params.Pr_b[None, :]
        O = tot[:, 1:]
        kerr, ent = chunk_objective_partials(
            R, dist_mat.reshape(K, nc1, CH).permute(1, 0, 2), params.sigma,
            k_axis=1, chunk_axis=0)
        nc = 2000.0 / cfg.N
        terms = (frame_sum(kerr, geom) * nc, frame_sum(ent, geom) * nc,
                 cross_entropy_from_stats(O, E, params, cfg))
    else:
        R = R.to(cfg.r_torch_dtype).to(torch.float32)
        E = torch.outer(torch.sum(R, dim=1), params.Pr_b)      # harmony.py:388
        O = R @ data.Phi.T                                       # harmony.py:389
        cache = torch.zeros((1, 1, 1), dtype=torch.float32, device=dev)
        terms = compute_objective_terms(R, dist_mat, O, E, data.Phi, params,
                                        cfg)
    st = HarmonyState(
        Z_corr=data.Z_orig, Z_cos=Z_cos,
        R=R.to(cfg.r_torch_dtype).contiguous(), Y=Y, O=O, E=E, cache=cache,
        **empty_histories(cfg, dev), **defer_placeholders(cfg, dev))
    _append_terms(st, terms)
    st.n_harmony = append(st.obj_harmony, 0, st.obj_kmeans[0])  # harmony.py:392
    return st


@record_function("harmony::cluster")
def cluster(st: HarmonyState, ZP3, params: HarmonyParams, cfg: EngineConfig,
            draw_blocks: Callable[[], torch.Tensor]) -> int:
    """Deferred-R k-means loop (harmony.py:437-462): every round runs the
    fused E-step and keeps its start-of-round inputs for the replays.
    Updates `st` in place; returns the number of rounds run."""
    geom = partition_geometry(cfg)
    fast = fast_ent(cfg)
    nc = 2000.0 / cfg.N
    Ysum = st.Ysum0
    for i in range(cfg.max_iter_kmeans):
        Y = l2_normalize_cols(Ysum).contiguous()                # harmony.py:443
        blocks = draw_blocks()
        slots, removal = round_tables(blocks, st.cache, geom)
        st.rep_Y, st.rep_O, st.rep_E = Y, st.O, st.E
        st.rep_cache, st.rep_blocks = st.cache, blocks
        O, E, cache, ybuf, kbuf, _ = fused_estep(
            slots, removal, ZP3, Y, params.sigma, params.theta, params.Pr_b,
            st.O, st.E, fast)
        st.n_passes += 1
        st.Y, st.O, st.E, st.cache = Y, O, E, cache
        Ysum = frame_sum(ybuf, geom).T
        ko = frame_sum(kbuf, geom)
        if _round_end(st, i, (ko[0] * nc, ko[1] * nc,
                              cross_entropy_from_stats(O, E, params, cfg)),
                      cfg):
            return i + 1
    return cfg.max_iter_kmeans


def iterate(st: HarmonyState, data: HarmonyData, params: HarmonyParams,
            cfg: EngineConfig, draw_blocks, ZO3) -> None:
    """One harmony iteration (harmony.py:421-428): cluster, then the ridge
    correction by replaying the final round twice (normal equations;
    apply), then the type-1 convergence check. Updates `st` in place."""
    geom = partition_geometry(cfg)
    fast = fast_ent(cfg)
    ZP3 = make_zp3(st.Z_cos, data.Phi, data.mask, cfg)
    rounds = cluster(st, ZP3, params, cfg, draw_blocks)
    st.kmeans_rounds.append(rounds)
    st.n_rounds += 1
    st.n_harmony = append(st.obj_harmony, st.n_harmony,
                          st.obj_kmeans[st.n_kmeans - 1])

    with record_function("harmony::ridge_replay"):
        tables = round_tables(st.rep_blocks, st.rep_cache, geom)
        rep = (st.rep_Y, params.sigma, params.theta, params.Pr_b, st.rep_O,
               st.rep_E)
        S = replay_normal_eq(tables, ZP3, ZO3, *rep, cfg, fast)
        W = solve_w(S, st.E, params, cfg)
        Zc3, Zs3, st.Ysum0 = replay_apply(tables, ZP3, ZO3, W, *rep, cfg,
                                          fast)
        st.n_passes += 2 * len(windows(cfg))
    nc1, CH = geom.nc_cap + 1, geom.CH
    st.rep_Zcos = st.Z_cos
    st.Z_corr = Zc3.permute(1, 0, 2).reshape(cfg.d, nc1 * CH)
    st.Z_cos = Zs3.permute(1, 0, 2).reshape(cfg.d, nc1 * CH)
    st.converged = check_conv_harmony(st.obj_harmony, st.n_harmony, cfg)


def _round_end(st: HarmonyState, i: int, terms, cfg: EngineConfig) -> bool:
    """Append a round's objective terms; whether the loop has converged."""
    _append_terms(st, terms)
    return i > cfg.window_size and check_conv_kmeans(st.obj_kmeans,
                                                     st.n_kmeans, cfg)


@record_function("harmony::cluster")
def cluster_fused(st: HarmonyState, ZP3, params: HarmonyParams,
                  cfg: EngineConfig, draw_blocks) -> int:
    """Stored-R fused k-means loop (JAX package engine.py:391-511): every
    round runs K2, which rewrites the chunk-major R3 in place in its
    storage dtype. The first centroid numerator comes from the stored R by
    a per-chunk product and frame_sum. Returns the rounds run."""
    geom = partition_geometry(cfg)
    fast = fast_ent(cfg)
    nc = 2000.0 / cfg.N
    y_c = torch.einsum("jdc,jkc->jdk", ZP3[:, cfg.B1:, :],
                       st.R.to(torch.float32))
    Ysum = frame_sum(y_c, geom)
    for i in range(cfg.max_iter_kmeans):
        Y = l2_normalize_cols(Ysum).contiguous()                # harmony.py:443
        slots, removal = round_tables(draw_blocks(), st.cache, geom)
        R3, O, E, cache, ybuf, kbuf = fused_estep_r(
            slots, removal, ZP3, st.R, Y, params.sigma, params.theta,
            params.Pr_b, st.O, st.E, fast)
        st.n_passes += 1
        st.R, st.Y, st.O, st.E, st.cache = R3, Y, O, E, cache
        Ysum = frame_sum(ybuf, geom).T
        ko = frame_sum(kbuf, geom)
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
    objective from R. Returns the rounds run."""
    for i in range(cfg.max_iter_kmeans):
        Y = l2_normalize_cols(st.Z_cos @ st.R.to(torch.float32).T)  # :443-444
        slot_table = cell_slot_table(draw_blocks(), cfg)
        dist_mat = 2.0 * (1.0 - Y.T @ st.Z_cos)                  # harmony.py:447
        st.R, st.E, st.O = update_r(slot_table, st.R, dist_mat, data.Phi,
                                    st.E, st.O, params, cfg, data.mask)
        st.Y = Y
        if _round_end(st, i, compute_objective_terms(
                st.R, dist_mat, st.O, st.E, data.Phi, params, cfg), cfg):
            return i + 1
    return cfg.max_iter_kmeans


def iterate_stored(st: HarmonyState, data: HarmonyData,
                   params: HarmonyParams, cfg: EngineConfig,
                   draw_blocks) -> None:
    """One stored-R harmony iteration (JAX package engine.py:685-719):
    cluster, moe_correct_ridge on the stored R, normalize, the type-1
    convergence check. Updates `st` in place."""
    if cfg.fused_estep:
        ZP3 = make_zp3(st.Z_cos, data.Phi, data.mask, cfg)
        rounds = cluster_fused(st, ZP3, params, cfg, draw_blocks)
    else:
        rounds = cluster_percell(st, data, params, cfg, draw_blocks)
    st.kmeans_rounds.append(rounds)
    st.n_rounds += 1
    st.n_harmony = append(st.obj_harmony, st.n_harmony,
                          st.obj_kmeans[st.n_kmeans - 1])
    with record_function("harmony::ridge"):
        st.Z_corr = moe_correct_ridge(data.Z_orig, data.Phi, st.R, st.E,
                                      params, cfg, data.mask)
    st.Z_cos = l2_normalize_cols(st.Z_corr)                      # harmony.py:569
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
    dev = data.Z_orig.device
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
        ZO3 = data.Z_orig.reshape(cfg.d, geom.nc_cap + 1, geom.CH).permute(
            1, 0, 2).contiguous()

        def step():
            iterate(st, data, params, cfg, draw_blocks, ZO3)
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
