"""Mixture-of-experts ridge correction, K-batched (reference
moe_correct_ridge, harmony.py:535-569; JAX package ops/ridge.py:38-146):

    W_k = (Phi_moe diag(R_k) Phi_moe^T + diag(lambda_k))^{-1}
          Phi_moe diag(R_k) Z_orig^T,        W_k[0, :] = 0
    Z_corr = Z_orig - sum_k W_k^T (Phi_moe * R_k)

The deferred-R path builds the normal equations from replayed r
(ops/replay.py) and shares solve_w; the stored-R paths read the stored R
here. The products are plain torch matmuls, as the JAX package leaves them
to XLA.
"""

from __future__ import annotations

import torch

from ..config import EngineConfig
from ..state import HarmonyParams
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


def moe_correct_ridge(Z_orig, Phi, R, E, params: HarmonyParams,
                      cfg: EngineConfig, mask) -> torch.Tensor:
    """Z_corr (d, N_local) = Z_orig - the ridge correction, from the stored
    R in the layout of its path:
      - fused layout (cfg.fused_estep): R3 (nc1, K, CH) chunk-major; the
        normal equations are per-chunk products reduced by frame_sum
        (JAX _normal_eq_framed, ridge.py:43-64), in windows of chunks;
      - per-cell layout: R (K, N_local); the products are summed over
        column chunks in order (ridge.py:126-133).
    Both solve with solve_w and apply the correction window by window.
    mask zeroes padded cells out of the intercept row."""
    B1, d, K = cfg.B1, cfg.d, cfg.K
    A = torch.cat([mask[None, :], Phi], dim=0)                  # Phi_moe
    if cfg.fused_estep:
        geom = partition_geometry(cfg)
        nc1, CH = geom.nc_cap + 1, geom.CH
        A3, Z3 = A.reshape(B1, nc1, CH), Z_orig.reshape(d, nc1, CH)
        w = max(1, _CHUNK_BUDGET_ELEMS // (B1 * (B1 + d) * CH))
        wins = [(lo, min(w, nc1 - lo)) for lo in range(0, nc1, w)]
        S_c = torch.empty((nc1, B1 * (B1 + d), K), dtype=torch.float32,
                          device=R.device)
        for lo, n in wins:
            sl = slice(lo, lo + n)
            S_c[sl] = _products(A3[:, sl], Z3[:, sl], R[sl])
        S = frame_sum(S_c, geom)
    else:
        Nl, CC = Z_orig.shape[1], _col_chunk(B1, d)
        wins = [(lo, min(CC, Nl - lo)) for lo in range(0, Nl, CC)]
        A3, Z3, R3 = A[:, None], Z_orig[:, None], R[None]
        S = torch.zeros((B1 * (B1 + d), K), dtype=torch.float32,
                        device=R.device)
        for lo, n in wins:
            sl = slice(lo, lo + n)
            S = S + _products(A3[..., sl], Z3[..., sl], R3[..., sl])[0]
    W = solve_w(S, E, params, cfg)

    Wf = W.reshape(K, B1 * d)
    Z_corr = torch.empty_like(Z_orig)
    Zc3 = Z_corr.reshape(d, -1, Z3.shape[-1])
    for lo, n in wins:
        sl = slice(lo, lo + n)
        if cfg.fused_estep:
            Zc3[:, sl] = Z3[:, sl] - _correction(A3[:, sl], R[sl], Wf)
        else:
            Zc3[..., sl] = Z3[..., sl] - _correction(A3[..., sl],
                                                     R3[..., sl], Wf)
    return Z_corr
