"""Mixture-of-experts ridge solve, K-batched (reference moe_correct_ridge,
harmony.py:535-569; JAX package ops/ridge.py:67-98):

    W_k = (Phi_moe diag(R_k) Phi_moe^T + diag(lambda_k))^{-1}
          Phi_moe diag(R_k) Z_orig^T,        W_k[0, :] = 0
"""

from __future__ import annotations

import torch

from ..config import EngineConfig
from ..state import HarmonyParams


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
