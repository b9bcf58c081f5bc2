"""The per-cell E-step: the diversity-penalized soft-assignment update of
reference update_R (harmony.py:464-513), one device (JAX package
ops/update_r.py:47-131).

  1. scale = softmax over clusters of -dist/sigma              (:466-468)
  2. cells in ceil(1/block_size) iid blocks (partition.iid_blocks)
  3. per block, in order: remove the block's cells from O/E, recompute
     their R with the weights (E/(O+E))^theta, re-add them    (:491-507)

This is the default below 20,480 cells. It is plain torch on every device:
the JAX package leaves it to XLA, and it has no kernel of its own.
"""

from __future__ import annotations

import torch

from ..config import EngineConfig
from ..state import HarmonyParams
from .update_r_fused import CLAMP, diversity_weights


def compute_scale_dist(dist_mat, sigma) -> torch.Tensor:
    """softmax_k(-dist/sigma) without max-subtraction (reference :466-468):
    dist lies in [0, 4], so exp(-dist/sigma) stays in fp32 range."""
    s = torch.exp(-dist_mat / sigma[:, None])
    return s / torch.sum(s, dim=0, keepdim=True)


def update_r(slot_table, R, dist_mat, Phi, E, O, params: HarmonyParams,
             cfg: EngineConfig, mask):
    """One E-step over all blocks. slot_table (nb, W) cell ids per block
    (sentinel N_local, partition.cell_slot_table); R (K, N_local) in its
    storage dtype, updated in place; dist_mat (K, N_local); Phi (B,
    N_local); E, O (K, B); mask (N_local,). Returns (R, E, O).

    The re-add uses the STORED (possibly bf16-rounded) values: the next
    removal re-reads the stored R, so O/E stay consistent with it."""
    Nl = cfg.N_local
    scale = compute_scale_dist(dist_mat, params.sigma)
    for idx in slot_table:
        valid = idx < Nl
        idx_c = torch.clamp_max(idx, Nl - 1)
        live = valid.to(torch.float32) * mask[idx_c]              # (W,)

        Rb = R[:, idx_c].to(torch.float32) * live[None, :]        # (K, W)
        Phib = Phi[:, idx_c] * live[None, :]                      # (B, W)
        E = E - torch.outer(torch.sum(Rb, dim=1), params.Pr_b)    # :491-492
        O = O - Rb @ Phib.T

        w_div = diversity_weights(O, E, params.theta)[1]          # :494-499
        R_new = scale[:, idx_c] * (w_div @ Phib)
        colsum = torch.clamp_min(torch.sum(R_new, dim=0), CLAMP)
        R_new = (R_new / colsum[None, :]) * live[None, :]

        R_store = R_new.to(R.dtype)                               # :506-507
        R_acc = R_store.to(torch.float32)
        E = E + torch.outer(torch.sum(R_acc, dim=1), params.Pr_b)
        O = O + R_acc @ Phib.T
        R[:, idx[valid]] = R_store[:, valid]
    return R, E, O
