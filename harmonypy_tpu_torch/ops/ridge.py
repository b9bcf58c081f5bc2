"""Mixture-of-experts ridge correction, K-batched (reference
moe_correct_ridge, harmony.py:535-569; JAX package ops/ridge.py:38-146):

    W_k = (Phi_moe diag(R_k) Phi_moe^T + diag(lambda_k))^{-1}
          Phi_moe diag(R_k) Z_orig^T,        W_k[0, :] = 0
    Z_corr = Z_orig - sum_k W_k^T (Phi_moe * R_k)

The deferred-R path builds the normal equations from replayed r
(ops/replay.py) and shares solve_w; the stored-R paths read the stored R
here. The products are torch products, as the JAX package leaves them to
XLA, through ops/products.py: one bf16 pass with fp32 accumulation under
matmul_precision "default" on a card (`one`), fp32 otherwise; the
Cholesky factor and solve stay fp32 (a decomposition, not a product, in
the JAX package too). The fused layout computes the per-chunk rows over the replays'
one-device windows of chunks with the replays' window functions, each
window's cell inputs copied into new chunk-major arrays of the window's
shape; a mesh shard runs only the windows that hold its chunks
(parallel/sharding.py) and the rows are reduced through the global frame
(bitwise the one-device result, and the deferred fit's for the same r).
The per-cell layout adds the shards' normal equations in shard order
(ops/objective.shard_sum; across processes after one all-gather, so every
rank solves the same S).
"""

from __future__ import annotations

import torch

from ..config import EngineConfig
from ..parallel.mesh import local_shards
from ..parallel.sharding import (cells_window, holds_window, one_device,
                                 pack, parts, put_cells, put_window,
                                 window_of)
from ..state import HarmonyParams
from ..utils.profiling import span
from .objective import shard_sum
from .partition import frame_sum, partition_geometry
from .products import einsum
from .replay import (dense_normal_eq, normal_eq_rows, onehot_design,
                     window_apply, window_apply_onehot, window_design_sums,
                     window_normal_eq, windows)

# Cap per-window stacked-feature temporaries at 64M floats (256 MB).
_CHUNK_BUDGET_ELEMS = 64 * 1024 * 1024


def _col_chunk(B1: int, d: int) -> int:
    rows = B1 * (B1 + d)
    return max(65536, (_CHUNK_BUDGET_ELEMS // rows) // 8192 * 8192)


def _products(a, z, r, one: bool):
    """Per-chunk normal-equation products (j, B1*(B1+d), K) of design rows
    a (B1, j, c), Z_orig z (d, j, c) and soft assignments r (j, K, c):
    rows b*B1+c' hold sum a_b a_c' r, rows B1*B1 + b*d + x sum a_b z_x r.
    one: as one bf16 pass (ops/products.py)."""
    B1, j, c = a.shape
    F = torch.cat([(a[:, None] * a[None, :]).reshape(B1 * B1, j, c),
                   (a[:, None] * z[None, :]).reshape(B1 * z.shape[0], j, c)])
    return einsum("fjc,jkc->jfk", F, r.to(torch.float32), one)


def _correction(a, r, Wf, one: bool):
    """sum_k sum_b W[k, b, :] a_b r_k for a (B1, j, c), r (j, K, c) and
    Wf = W.reshape(K, B1*d): returns (d, j, c); one: both products as one
    bf16 pass."""
    B1, j, c = a.shape
    T = einsum("jkc,kf->jcf", r.to(torch.float32), Wf, one)
    T = T.reshape(j, c, B1, -1)
    return einsum("bjc,jcbd->djc", a, T, one)


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
    with span("sync::cholesky"):    # the factorization's status is read
        L = torch.linalg.cholesky(cov)                          # (K, B1, B1)
    W = torch.cholesky_solve(rhs, L)                            # (K, B1, d)
    W[:, 0, :] = 0.0                                            # keep intercept
    return W


def _design(Z_orig, Phi, mask, cfg: EngineConfig):
    """Per-cell layout: (A3, Z3, windows) of one device's (or one shard's)
    cells: the design rows Phi_moe = [mask; Phi] and Z_orig as (B1, 1, N)
    and (d, 1, N), and the column windows the products run over."""
    B1, d = cfg.B1, cfg.d
    A = torch.cat([mask[None, :], Phi], dim=0)                  # Phi_moe
    Nl, CC = Z_orig.shape[1], _col_chunk(B1, d)
    return (A[:, None], Z_orig[:, None],
            [(lo, min(CC, Nl - lo)) for lo in range(0, Nl, CC)])


def _normal_eq(Z_orig, Phi, mask, cfg: EngineConfig, R, one: bool):
    """Per-cell layout: the normal equations summed over the cells in
    column-window order."""
    A3, Z3, wins = _design(Z_orig, Phi, mask, cfg)
    S = torch.zeros((cfg.B1 * (cfg.B1 + cfg.d), cfg.K), dtype=torch.float32,
                    device=A3.device)
    for lo, n in wins:
        sl = slice(lo, lo + n)
        S = S + _products(A3[..., sl], Z3[..., sl], R[None][..., sl],
                          one)[0]
    return S


def _apply(Z_orig, Phi, mask, W, cfg: EngineConfig, R, one: bool):
    """Per-cell layout: Z_orig minus the correction, column window by
    column window."""
    A3, Z3, wins = _design(Z_orig, Phi, mask, cfg)
    Wf = W.reshape(cfg.K, cfg.B1 * cfg.d)
    Z_corr = torch.empty_like(Z_orig)
    Zc3 = Z_corr[:, None]
    for lo, n in wins:
        sl = slice(lo, lo + n)
        Zc3[..., sl] = Z3[..., sl] - _correction(
            A3[..., sl], R[None][..., sl], Wf, one)
    return Z_corr


def _fused_shard(z, p, m, R3, s: int, cfg: EngineConfig, one: bool,
                 W=None):
    """Shard s of the fused layout over the one-device windows of the
    replays (ops/replay.windows) that hold its chunks, each window's design
    rows and Z_orig copied into new chunk-major arrays of the window's
    shape (parallel.sharding.cells_window) and computed by the replays' own
    window functions (the one-hot forms for a one-hot design), so a stored
    fit's ridge is the deferred fit's bit for bit for the same r: with W
    None its per-chunk normal equations (nc1, normal_eq_rows, K), else its
    Z_corr (d, N_local) = Z_orig - the correction (zero on chunks no window
    holds)."""
    geom = partition_geometry(cfg)
    onehot = onehot_design(cfg)
    A = torch.cat([m[None, :], p], dim=0)                       # Phi_moe
    if W is None:
        out = torch.zeros((R3.shape[0], normal_eq_rows(cfg), cfg.K),
                          dtype=torch.float32, device=z.device)
    else:
        out = torch.zeros_like(z)
    for lo, n in windows(one_device(cfg)):
        if not holds_window(geom, s, lo, n):
            continue
        a = cells_window(A, s, geom, lo, n)                     # (n, B1, CH)
        zo = cells_window(z, s, geom, lo, n)                    # (n, d, CH)
        r = window_of(R3, s, geom, lo, n).to(torch.float32)
        if W is None:
            put_window(out, (window_design_sums if onehot else
                             window_normal_eq)(a, zo, r, one), s, geom, lo, n)
        else:
            put_cells(out, (window_apply_onehot if onehot else
                            window_apply)(a, zo, r, W, one), s, geom, lo, n)
    return out


def moe_correct_ridge(Z_orig, Phi, R, E, params: HarmonyParams,
                      cfg: EngineConfig, mask, one: bool):
    """Z_corr (d, N_local) = Z_orig - the ridge correction, from the stored
    R in the layout of its path:
      - fused layout (cfg.fused_estep): R3 (nc1, K, CH) chunk-major; the
        normal equations are per-chunk products reduced by frame_sum
        (JAX _normal_eq_framed, ridge.py:43-64), in windows of chunks;
      - per-cell layout: R (K, N_local); the products are summed over
        column chunks in order (ridge.py:126-133).
    Both solve with solve_w and apply the correction window by window.
    mask zeroes padded cells out of the intercept row. On a mesh every
    cell-axis argument is a list of the shards' and so is Z_corr. one: the
    products as one bf16 pass (ops/products.py)."""
    shards = list(zip(parts(Z_orig), parts(Phi), parts(mask), parts(R)))
    if cfg.fused_estep:
        ids = local_shards(cfg.n_devices)
        S = frame_sum([_fused_shard(*sh, s, cfg, one)
                       for s, sh in zip(ids, shards)],
                      partition_geometry(cfg))
        if onehot_design(cfg):
            S = dense_normal_eq(S, cfg)
        W = solve_w(S, E, params, cfg)
        return pack(_fused_shard(*sh, s, cfg, one, W.to(sh[0].device))
                    for s, sh in zip(ids, shards))
    S = shard_sum([_normal_eq(z, p, m, cfg, r, one)
                   for z, p, m, r in shards], E.device, cfg.n_devices)
    W = solve_w(S, E, params, cfg)
    return pack(_apply(z, p, m, W.to(z.device), cfg, r, one)
                for z, p, m, r in shards)
