"""The per-cell E-step: the diversity-penalized soft-assignment update of
reference update_R (harmony.py:464-513), on one device or a mesh (JAX
package ops/update_r.py:47-131).

  1. scale = softmax over clusters of -dist/sigma              (:466-468)
  2. cells in ceil(1/block_size) iid blocks (partition.iid_blocks)
  3. per block, in order: remove the block's cells from O/E, recompute
     their R with the weights (E/(O+E))^theta, re-add them    (:491-507)

This is the default below 20,480 cells. It is plain torch on every device:
the JAX package leaves it to XLA, and it has no kernel of its own. On a mesh
each block's removal and re-add are shard partials summed in shard order
(JAX ops/partition.py:29-32): equal to one device to reduction-order
tolerance, not bitwise.
"""

from __future__ import annotations

import torch

from ..config import EngineConfig
from ..parallel.sharding import pack, parts
from ..state import HarmonyParams
from .objective import shard_sum
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
    N_local); E, O (K, B); mask (N_local,). On a mesh the cell-axis
    arguments are lists of the shards'. Returns (R, E, O).

    The re-add uses the STORED (possibly bf16-rounded) values: the next
    removal re-reads the stored R, so O/E stay consistent with it."""
    Nl, lead, Pr_b = cfg.N_local, E.device, params.Pr_b
    shards = [dict(tbl=t, R=R_s, Phi=p, mask=m,
                   scale=compute_scale_dist(dm, params.sigma.to(dm.device)))
              for t, R_s, dm, p, m in zip(parts(slot_table), parts(R),
                                          parts(dist_mat), parts(Phi),
                                          parts(mask))]
    for b in range(cfg.n_blocks):
        for sh in shards:
            idx = sh["tbl"][b]
            sh["valid"] = valid = idx < Nl
            sh["idx_c"] = idx_c = torch.clamp_max(idx, Nl - 1)
            live = valid.to(torch.float32) * sh["mask"][idx_c]    # (W,)
            sh["live"] = live
            sh["Rb"] = sh["R"][:, idx_c].to(torch.float32) * live[None, :]
            sh["Phib"] = sh["Phi"][:, idx_c] * live[None, :]
        E = E - torch.outer(shard_sum([torch.sum(sh["Rb"], dim=1)
                                       for sh in shards], lead), Pr_b)
        O = O - shard_sum([sh["Rb"] @ sh["Phib"].T for sh in shards],
                          lead)                                   # :491-492

        w_div = diversity_weights(O, E, params.theta)[1]          # :494-499
        for sh in shards:
            live = sh["live"]
            R_new = sh["scale"][:, sh["idx_c"]] * (w_div.to(live.device)
                                                   @ sh["Phib"])
            colsum = torch.clamp_min(torch.sum(R_new, dim=0), CLAMP)
            R_new = (R_new / colsum[None, :]) * live[None, :]
            sh["R_store"] = R_new.to(sh["R"].dtype)               # :506-507
            sh["R_acc"] = sh["R_store"].to(torch.float32)
        E = E + torch.outer(shard_sum([torch.sum(sh["R_acc"], dim=1)
                                       for sh in shards], lead), Pr_b)
        O = O + shard_sum([sh["R_acc"] @ sh["Phib"].T for sh in shards],
                          lead)
        for sh in shards:
            idx, valid = sh["tbl"][b], sh["valid"]
            sh["R"][:, idx[valid]] = sh["R_store"][:, valid]
    return pack(sh["R"] for sh in shards), E, O
