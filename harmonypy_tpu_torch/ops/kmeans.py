"""k-means initialization: k-means++ or k-means|| seeding, then Lloyd
(replaces sklearn KMeans(init='k-means++', n_init=1, max_iter=25) at
reference harmony.py:366-374; JAX package ops/kmeans.py:45-273).

Above `kmeanspp_sample` cells, seeding and Lloyd run on a uniform sample of
that many cells drawn with replacement; Harmony's own fuzzy k-means loop
then refines the centroids on all cells. Every draw comes from the caller's
`torch.Generator`:
  - greedy k-means++ (sklearn's variant): each step draws
    T = 2 + floor(log K) candidates with P(i) proportional to the D^2
    potential (Gumbel-max) and keeps the one minimizing the potential;
  - k-means|| (Bahmani et al., VLDB 2012) when sampling: rounds of
    Gumbel-top-M D^2 oversampling with an exact `torch.topk`, then weighted
    greedy k-means++ over the candidates.
"""

from __future__ import annotations

import torch

from ..config import EngineConfig


def _sq_norms(X):
    return torch.sum(X * X, dim=0)


def _safe_log(x):
    """log(x) for x > 0, -inf elsewhere (Gumbel-max weights)."""
    return torch.where(x > 0.0, torch.log(torch.where(x > 0.0, x,
                                                      torch.ones_like(x))),
                       torch.full_like(x, -float("inf")))


def _gumbel(gen: torch.Generator, shape) -> torch.Tensor:
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=gen, device=gen.device)
    return -torch.log(-torch.log(u.clamp_(min=tiny, max=1.0 - 2 ** -24)))


def _greedy(X, w, centers, d2, gen, cfg: EngineConfig):
    """Weighted greedy k-means++ steps 1..K-1 over the columns of X (weights
    w, or None for unit weights); d2 is the potential of the first center."""
    xsq = _sq_norms(X)
    T = cfg.kmeanspp_trials
    for t in range(1, cfg.K):
        logp = _safe_log(d2 if w is None else d2 * w)
        picks = torch.argmax(logp[None, :] + _gumbel(gen, (T, X.shape[1])),
                             dim=1)                              # (T,)
        C = X[:, picks]                                          # (d, T)
        cand = xsq[None, :] + _sq_norms(C)[:, None] - 2.0 * (C.T @ X)
        nd2 = torch.minimum(d2[None, :], torch.clamp_min(cand, 0.0))
        pots = torch.sum(nd2 if w is None else nd2 * w[None, :], dim=1)
        best = torch.argmin(pots)
        centers[:, t] = C[:, best]
        d2 = nd2[best]
    return centers


def _first(X, w, gen, cfg: EngineConfig):
    """(centers with column 0 set, its potential): the first center drawn
    uniformly (or proportional to w)."""
    d, S = X.shape
    score = _gumbel(gen, (S,))
    if w is not None:
        score = _safe_log(w) + score
    c0 = X[:, torch.argmax(score)]
    centers = torch.zeros((d, cfg.K), dtype=X.dtype, device=X.device)
    centers[:, 0] = c0
    d2 = torch.clamp_min(_sq_norms(X) + torch.sum(c0 ** 2) - 2.0 * (c0 @ X),
                         0.0)
    return centers, d2


def kmeanspp_seed(gen, X, cfg: EngineConfig):
    """Greedy k-means++ seeding on a (d, S) sample; returns (d, K)."""
    centers, d2 = _first(X, None, gen, cfg)
    return _greedy(X, None, centers, d2, gen, cfg)


def kmeansbb_seed(gen, X, cfg: EngineConfig):
    """k-means|| seeding on a (d, S) sample; returns (d, K)."""
    S = X.shape[1]
    M = cfg.kmeansbb_oversample * cfg.K
    xsq = _sq_norms(X)

    def cand_d2(C):
        return torch.clamp_min(
            _sq_norms(C)[:, None] + xsq[None, :] - 2.0 * (C.T @ X), 0.0)

    c0 = X[:, torch.argmax(_gumbel(gen, (S,)))][:, None]
    cands = [c0]
    d2 = cand_d2(c0)[0]
    for _ in range(cfg.kmeansbb_rounds):
        # Gumbel top-M: M draws without replacement, P(i) ~ d2.
        _, sel = torch.topk(_safe_log(d2) + _gumbel(gen, (S,)), M)
        new_c = X[:, sel]
        cands.append(new_c)
        d2 = torch.minimum(d2, torch.min(cand_d2(new_c), dim=0).values)
    C = torch.cat(cands, dim=1)                                  # (d, n_cand)

    # Candidate weights: nearest-candidate counts over the sample.
    nearest = torch.argmin(_sq_norms(C)[:, None] - 2.0 * (C.T @ X), dim=0)
    w = torch.bincount(nearest, minlength=C.shape[1]).to(X.dtype)
    centers, cd2 = _first(C, w, gen, cfg)
    return _greedy(C, w, centers, cd2, gen, cfg)


def lloyd(centers, X, cfg: EngineConfig):
    """Lloyd iterations with sklearn's tolerance (tol * mean per-feature
    variance); returns (d, K)."""
    K, S = cfg.K, X.shape[1]
    mean = torch.sum(X, dim=1) / S
    var = torch.sum((X - mean[:, None]) ** 2, dim=1) / S
    tol = cfg.kmeans_tol * torch.mean(var)
    C = centers
    for _ in range(cfg.kmeans_max_iter):
        labels = torch.argmin(_sq_norms(C)[:, None] - 2.0 * (C.T @ X), dim=0)
        w = (labels[None, :] == torch.arange(K, device=X.device)[:, None]
             ).to(X.dtype)                                       # (K, S)
        sums = X @ w.T
        counts = torch.sum(w, dim=1)
        C_new = torch.where(counts[None, :] > 0.0,
                            sums / torch.clamp_min(counts, 1.0)[None, :], C)
        shift = torch.sum((C_new - C) ** 2)
        C = C_new
        if bool(shift <= tol):
            break
    return C


def kmeans_init(gen, Z_cos, cfg: EngineConfig):
    """k-means centroids (d, K) of the unit-normalized embedding Z_cos
    (d, N_local, real cells first). Not yet normalized (the caller does,
    reference harmony.py:377). On a mesh the engine gathers the (d, N) real
    cells to the lead device and calls this there, so the draws and the
    bits are one device's (the JAX package shards it, ops/kmeans.py:54-64;
    ROADMAP §1 item 11)."""
    S = min(cfg.kmeanspp_sample, cfg.N)
    if S < cfg.N:
        ids = torch.randint(0, cfg.N, (S,), generator=gen, device=gen.device)
    else:
        ids = torch.arange(cfg.N, device=Z_cos.device)
    Xs = Z_cos[:, ids.to(Z_cos.device)]
    if S < cfg.N and S >= cfg.kmeansbb_oversample * cfg.K:
        centers = kmeansbb_seed(gen, Xs, cfg)
    else:
        centers = kmeanspp_seed(gen, Xs, cfg)
    return lloyd(centers, Xs, cfg)
