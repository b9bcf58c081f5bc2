"""The per-cell E-step: the diversity-penalized soft-assignment update of
reference update_R (harmony.py:464-513), on one device or a mesh (JAX
package ops/update_r.py:47-131).

  1. scale = softmax over clusters of -dist/sigma              (:466-468)
  2. cells in ceil(1/block_size) iid blocks (partition.iid_blocks)
  3. per block, in order: remove the block's cells from O/E, recompute
     their R with the weights (E/(O+E))^theta, re-add them    (:491-507)

This is the default below 20,480 cells. It is plain torch on every device:
the JAX package leaves it to XLA, and it has no kernel of its own. Its
products (the block stats R Phi^T, the weights wdiv Phi) go through
ops/products.py: one bf16 pass under matmul_precision "default" on a card
(`one`), as the JAX package's precision scope runs them. On a mesh
each block's removal and re-add are shard partials summed in shard order
(JAX ops/partition.py:29-32): equal to one device to reduction-order
tolerance, not bitwise. Each phase packs a shard's E partial (K,) and O
partial (K, B) side by side, so a block makes two shard sums (across
processes two all-gathers) and the adds are the elementwise adds of the
separate sums. The block loop has no host wait: every index is a tensor
(no boolean selection), and the store goes through a scratch column.
"""

from __future__ import annotations

import torch

from ..config import EngineConfig
from ..parallel.sharding import pack, parts
from ..state import HarmonyParams
from .objective import shard_sum
from .products import matmul
from .update_r_fused import CLAMP, diversity_weights


def compute_scale_dist(dist_mat, sigma) -> torch.Tensor:
    """softmax_k(-dist/sigma) without max-subtraction (reference :466-468):
    dist lies in [0, 4], so exp(-dist/sigma) stays in fp32 range."""
    s = torch.exp(-dist_mat / sigma[:, None])
    return s / torch.sum(s, dim=0, keepdim=True)


def _stats(Rb, Phib, one: bool):
    """A shard's (K, B+1) block partial: [sum_cells R | R Phi^T]; one: the
    product as one bf16 pass (ops/products.py)."""
    return torch.cat([torch.sum(Rb, dim=1)[:, None],
                      matmul(Rb, Phib.T, one)], dim=1)


def update_r(slot_table, R, dist_mat, Phi, E, O, params: HarmonyParams,
             cfg: EngineConfig, mask, one: bool):
    """One E-step over all blocks. slot_table (nb, W) cell ids per block
    (sentinel N_local, partition.cell_slot_table); R (K, N_local) in its
    storage dtype, updated in place; dist_mat (K, N_local); Phi (B,
    N_local); E, O (K, B); mask (N_local,). On a mesh the cell-axis
    arguments are lists of this process's shards'. Returns (R, E, O).

    The re-add uses the STORED (possibly bf16-rounded) values: the next
    removal re-reads the stored R, so O/E stay consistent with it. Each
    shard's R is worked on in a copy with one scratch column (id
    N_local), where a block's sentinel slots store and nothing reads, and
    copied back at the end."""
    Nl, lead, Pr_b, S = cfg.N_local, E.device, params.Pr_b, cfg.n_devices
    shards = [dict(tbl=t, R=R_s, Phi=p, mask=m,
                   Rw=torch.cat([R_s, R_s.new_zeros((R_s.shape[0], 1))],
                                dim=1),
                   scale=compute_scale_dist(dm, params.sigma.to(dm.device)))
              for t, R_s, dm, p, m in zip(parts(slot_table), parts(R),
                                          parts(dist_mat), parts(Phi),
                                          parts(mask))]
    for b in range(cfg.n_blocks):
        for sh in shards:
            idx = sh["tbl"][b]
            sh["idx"] = idx
            sh["idx_c"] = idx_c = torch.clamp_max(idx, Nl - 1)
            live = (idx < Nl).to(torch.float32) * sh["mask"][idx_c]  # (W,)
            sh["live"] = live
            sh["Rb"] = sh["Rw"][:, idx_c].to(torch.float32) * live[None, :]
            sh["Phib"] = sh["Phi"][:, idx_c] * live[None, :]
        rem = shard_sum([_stats(sh["Rb"], sh["Phib"], one)
                         for sh in shards], lead, S)              # :491-492
        E = E - torch.outer(rem[:, 0], Pr_b)
        O = O - rem[:, 1:]

        w_div = diversity_weights(O, E, params.theta)[1]          # :494-499
        for sh in shards:
            live = sh["live"]
            R_new = sh["scale"][:, sh["idx_c"]] * matmul(
                w_div.to(live.device), sh["Phib"], one)
            colsum = torch.clamp_min(torch.sum(R_new, dim=0), CLAMP)
            R_new = (R_new / colsum[None, :]) * live[None, :]
            sh["R_store"] = R_new.to(sh["R"].dtype)               # :506-507
            sh["R_acc"] = sh["R_store"].to(torch.float32)
        add = shard_sum([_stats(sh["R_acc"], sh["Phib"], one)
                         for sh in shards], lead, S)
        E = E + torch.outer(add[:, 0], Pr_b)
        O = O + add[:, 1:]
        for sh in shards:
            # Real ids are unique within a block; sentinels hit column Nl.
            sh["Rw"][:, sh["idx"]] = sh["R_store"]
    for sh in shards:
        sh["R"].copy_(sh["Rw"][:, :Nl])
    return pack(sh["R"] for sh in shards), E, O
