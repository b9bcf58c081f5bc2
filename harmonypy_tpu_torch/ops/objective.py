"""Harmony objective pieces (reference compute_objective, harmony.py:394-417).

    J = [ sum(R * dist) + sum(sigma * R * log R)
        + sum(sigma * R * (theta * log((O+E)/E)) Phi) ] * 2000 / N

The fused E-step returns the first two terms as per-chunk partials; the
cross term comes from O and E alone, because O = R Phi^T. The per-cell path
takes all three from R (compute_objective_terms); on a mesh each shard
sums its cells and the shard sums are added in shard order.
"""

from __future__ import annotations

import torch

from ..config import EngineConfig
from ..state import HarmonyParams
from .normalize import safe_entropy

CLAMP = 1e-8


def chunk_objective_partials(r, dist, sigma, k_axis: int, chunk_axis: int):
    """Per-chunk k-means-error and sigma-weighted entropy partials, reduced
    over every axis except `chunk_axis`."""
    shape = [1] * r.ndim
    shape[k_axis] = -1
    axes = tuple(a for a in range(r.ndim) if a != chunk_axis)
    kerr = torch.sum(r * dist, dim=axes)
    ent = torch.sum(safe_entropy(r) * sigma.reshape(shape), dim=axes)
    return kerr, ent


def chunk_objective_partials_fast(r, dist, statsO, sigma, theta, logratio,
                                  logdd):
    """Per-chunk (kerr, ent) without a per-element log, valid when every
    cell carries one covariate level:

        sum_k sigma_k r log r = -sum_k r dist
                                + sum_kb sigma_k theta_b logratio_kb O_chunk
                                - sum_c (log D_c + log Dr_c) (sigma^T r)_c

    r/dist: (J, K, CH); statsO: (J, K, B); logratio: (K, B); logdd: (J, CH).
    """
    kerr = torch.sum(r * dist, dim=(1, 2))
    st = torch.sum((sigma[:, None] * theta[None, :] * logratio)[None]
                   * statsO, dim=(1, 2))
    sr = torch.sum(r * sigma[None, :, None], dim=1)             # (J, CH)
    ent = -kerr + st - torch.sum(sr * logdd, dim=1)
    return kerr, ent


def cross_entropy_from_stats(O, E, params: HarmonyParams, cfg: EngineConfig):
    """sum(R_sigma * (theta_log @ Phi)) == sum_kb sigma_k theta_log[k,b] O[k,b]
    (times 2000/N), from O/E alone."""
    norm_const = 2000.0 / cfg.N
    Oc, Ec = torch.clamp_min(O, CLAMP), torch.clamp_min(E, CLAMP)
    theta_log = params.theta[None, :] * torch.log((Oc + Ec) / Ec)   # (K, B)
    return torch.sum(params.sigma[:, None] * theta_log * O) * norm_const


def shard_sum(xs, device) -> torch.Tensor:
    """Shard partials added in shard order on `device` (one shard: its
    partial itself)."""
    acc = xs[0].to(device)
    for x in xs[1:]:
        acc = acc + x.to(device)
    return acc


def compute_objective_terms(R, dist_mat, O, E, Phi, params: HarmonyParams,
                            cfg: EngineConfig):
    """(kmeans_error, entropy, cross_entropy), each * 2000/N, from R
    (K, N_local) in any storage dtype, summed in fp32 (JAX package
    ops/objective.py:96-110). R, dist_mat and Phi may be sharded (lists):
    each shard's sums are added in shard order."""
    from ..parallel.sharding import parts
    norm_const = 2000.0 / cfg.N
    Oc, Ec = torch.clamp_min(O, CLAMP), torch.clamp_min(E, CLAMP)
    theta_log = params.theta[None, :] * torch.log((Oc + Ec) / Ec)   # (K, B)
    sums = []
    for R_s, dist_s, Phi_s in zip(parts(R), parts(dist_mat), parts(Phi)):
        dev = R_s.device
        sigma_col = params.sigma.to(dev)[:, None]
        R_s = R_s.to(torch.float32)
        sums.append((torch.sum(R_s * dist_s),
                     torch.sum(safe_entropy(R_s) * sigma_col),
                     torch.sum((R_s * sigma_col)
                               * (theta_log.to(dev) @ Phi_s))))
    return tuple(shard_sum([t[i] for t in sums], O.device) * norm_const
                 for i in range(3))
