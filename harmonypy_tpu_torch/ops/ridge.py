"""Mixture-of-experts ridge correction, K-batched (reference
moe_correct_ridge, harmony.py:535-569; JAX package ops/ridge.py:38-146):

    W_k = (Phi_moe diag(R_k) Phi_moe^T + diag(lambda_k))^{-1}
          Phi_moe diag(R_k) Z_orig^T,        W_k[0, :] = 0
    Z_corr = Z_orig - sum_k W_k^T (Phi_moe * R_k)

The deferred-R path builds the normal equations from replayed r
(ops/replay.py) and shares solve_w; the stored-R paths read the stored R
here. The products are plain torch matmuls, as the JAX package leaves them
to XLA. On a mesh the fused layout computes each shard's per-chunk rows
over the one-device windows that hold its chunks (parallel/sharding.py)
and reduces them through the global frame (bitwise the one-device result);
the per-cell layout adds the shards' normal equations in shard order.
"""

from __future__ import annotations

import torch

from ..config import EngineConfig
from ..parallel.sharding import (embed_cols, extract_chunks, extract_cols,
                                 holds_window, one_device, pack, parts,
                                 window_of)
from ..state import HarmonyParams
from .objective import shard_sum
from .partition import frame_sum, partition_geometry

# Cap per-window stacked-feature temporaries at 64M floats (256 MB).
_CHUNK_BUDGET_ELEMS = 64 * 1024 * 1024


def _col_chunk(B1: int, d: int) -> int:
    rows = B1 * (B1 + d)
    return max(65536, (_CHUNK_BUDGET_ELEMS // rows) // 8192 * 8192)


def _products(a, z, r):
    """Per-chunk normal-equation products (j, B1*(B1+d), K) of design rows
    a (B1, j, c), Z_orig z (d, j, c) and soft assignments r (j, K, c):
    rows b*B1+c' hold sum a_b a_c' r, rows B1*B1 + b*d + x sum a_b z_x r."""
    B1, j, c = a.shape
    F = torch.cat([(a[:, None] * a[None, :]).reshape(B1 * B1, j, c),
                   (a[:, None] * z[None, :]).reshape(B1 * z.shape[0], j, c)])
    return torch.einsum("fjc,jkc->jfk", F, r.to(torch.float32))


def _correction(a, r, Wf):
    """sum_k sum_b W[k, b, :] a_b r_k for a (B1, j, c), r (j, K, c) and
    Wf = W.reshape(K, B1*d): returns (d, j, c)."""
    B1, j, c = a.shape
    T = torch.einsum("jkc,kf->jcf", r.to(torch.float32), Wf)
    T = T.reshape(j, c, B1, -1)
    return torch.einsum("bjc,jcbd->djc", a, T)


def solve_w(S, E, params: HarmonyParams, cfg: EngineConfig) -> torch.Tensor:
    """Solve all K ridge systems from the stacked normal equations S
    (B1*(B1+d), K): rows b*B1+c hold cov[k, b, c], rows B1*B1 + b*d + x hold
    rhs[k, b, x]. Returns W (K, B1, d) with the intercept row zeroed."""
    K, B1, d = cfg.K, cfg.B1, cfg.d
    cov = S[: B1 * B1].reshape(B1, B1, K).permute(2, 0, 1)
    rhs = S[B1 * B1:].reshape(B1, d, K).permute(2, 0, 1)
    if cfg.lambda_estimation:
        # alpha * E[k] per batch level (reference :541-544, 587-591), floored
        # so an unused level (E == 0) keeps the system regular and gets W = 0.
        lamb_k = torch.cat(
            [torch.zeros((K, 1), dtype=S.dtype, device=S.device),
             torch.clamp_min(cfg.alpha * E, 1e-6)], dim=1)      # (K, B1)
    else:
        lamb_k = params.lamb[None, :].expand(K, B1)
    cov = cov + torch.diag_embed(lamb_k)
    L = torch.linalg.cholesky(cov)                              # (K, B1, B1)
    W = torch.cholesky_solve(rhs, L)                            # (K, B1, d)
    W[:, 0, :] = 0.0                                            # keep intercept
    return W


def _design(Z_orig, Phi, mask, cfg: EngineConfig):
    """(A3, Z3, windows) of one device's (or one shard's) cells: the design
    rows Phi_moe = [mask; Phi] and Z_orig as (B1, n, c) and (d, n, c) — n
    chunks of CH cells (fused layout) or one row of all cells (per-cell
    layout) — and the windows of n the products run over."""
    B1, d = cfg.B1, cfg.d
    A = torch.cat([mask[None, :], Phi], dim=0)                  # Phi_moe
    if cfg.fused_estep:
        geom = partition_geometry(cfg)
        nc1, CH = geom.nc_cap + 1, geom.CH
        w = max(1, _CHUNK_BUDGET_ELEMS // (B1 * (B1 + d) * CH))
        return (A.reshape(B1, nc1, CH), Z_orig.reshape(d, nc1, CH),
                [(lo, min(w, nc1 - lo)) for lo in range(0, nc1, w)])
    Nl, CC = Z_orig.shape[1], _col_chunk(B1, d)
    return (A[:, None], Z_orig[:, None],
            [(lo, min(CC, Nl - lo)) for lo in range(0, Nl, CC)])


def _normal_eq(Z_orig, Phi, mask, cfg: EngineConfig, r_rows, keep=None):
    """Fused layout: the per-chunk normal equations (nc1, B1*(B1+d), K) of
    the windows `keep(lo, n)` accepts (every window when None; the other
    rows are left unset). Per-cell layout: their sum over the cells, in
    window order. r_rows(lo, n) gives R's rows of window (lo, n)."""
    A3, Z3, wins = _design(Z_orig, Phi, mask, cfg)
    if cfg.fused_estep:
        S_c = torch.empty((A3.shape[1], cfg.B1 * (cfg.B1 + cfg.d), cfg.K),
                          dtype=torch.float32, device=A3.device)
        for lo, n in wins:
            if keep is None or keep(lo, n):
                sl = slice(lo, lo + n)
                S_c[sl] = _products(A3[:, sl], Z3[:, sl], r_rows(lo, n))
        return S_c
    S = torch.zeros((cfg.B1 * (cfg.B1 + cfg.d), cfg.K), dtype=torch.float32,
                    device=A3.device)
    for lo, n in wins:
        sl = slice(lo, lo + n)
        S = S + _products(A3[..., sl], Z3[..., sl], r_rows(lo, n))[0]
    return S


def _apply(Z_orig, Phi, mask, W, cfg: EngineConfig, r_rows, keep=None):
    """Z_orig minus the correction, window by window (the windows `keep`
    accepts; the other columns are left unset)."""
    A3, Z3, wins = _design(Z_orig, Phi, mask, cfg)
    Wf = W.reshape(cfg.K, cfg.B1 * cfg.d)
    Z_corr = torch.empty_like(Z_orig)
    Zc3 = Z_corr.reshape(cfg.d, -1, Z3.shape[-1])
    for lo, n in wins:
        if keep is not None and not keep(lo, n):
            continue
        sl = slice(lo, lo + n)
        if cfg.fused_estep:
            Zc3[:, sl] = Z3[:, sl] - _correction(A3[:, sl], r_rows(lo, n), Wf)
        else:
            Zc3[..., sl] = Z3[..., sl] - _correction(A3[..., sl],
                                                     r_rows(lo, n), Wf)
    return Z_corr


def moe_correct_ridge(Z_orig, Phi, R, E, params: HarmonyParams,
                      cfg: EngineConfig, mask):
    """Z_corr (d, N_local) = Z_orig - the ridge correction, from the stored
    R in the layout of its path:
      - fused layout (cfg.fused_estep): R3 (nc1, K, CH) chunk-major; the
        normal equations are per-chunk products reduced by frame_sum
        (JAX _normal_eq_framed, ridge.py:43-64), in windows of chunks;
      - per-cell layout: R (K, N_local); the products are summed over
        column chunks in order (ridge.py:126-133).
    Both solve with solve_w and apply the correction window by window.
    mask zeroes padded cells out of the intercept row. On a mesh every
    cell-axis argument is a list of the shards' and so is Z_corr."""
    shards = list(zip(parts(Z_orig), parts(Phi), parts(R), parts(mask)))
    if cfg.fused_estep:
        geom, cfg1 = partition_geometry(cfg), one_device(cfg)

        def on_shard(fn, s, z, p, r, m, *args):
            """fn on shard s in the one-device layout: its cell inputs
            embedded whole, its R read window by window, only the windows
            that hold its chunks (parallel/sharding.py)."""
            return fn(embed_cols(z, s, cfg), embed_cols(p, s, cfg),
                      embed_cols(m[None], s, cfg)[0], *args, cfg1,
                      r_rows=lambda lo, n: window_of(r, s, geom, lo, n),
                      keep=lambda lo, n: holds_window(geom, s, lo, n))

        S = frame_sum([extract_chunks(on_shard(_normal_eq, s, *sh), s, geom)
                       for s, sh in enumerate(shards)], geom)
        W = solve_w(S, E, params, cfg)
        return pack(extract_cols(on_shard(_apply, s, *sh, W.to(sh[0].device)),
                                 s, cfg)
                    for s, sh in enumerate(shards))

    def cols(r):
        return lambda lo, n: r[None][..., lo: lo + n]

    S = shard_sum([_normal_eq(z, p, m, cfg, cols(r))
                   for z, p, r, m in shards], E.device)
    W = solve_w(S, E, params, cfg)
    return pack(_apply(z, p, m, W.to(z.device), cfg, cols(r))
                for z, p, r, m in shards)
