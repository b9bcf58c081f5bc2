"""A plain LISI (Korsunsky et al., Nat Methods 2019; harmonypy lisi.py):
the yardstick for `compute_lisi`.

For each query cell: its 3 * perplexity - 1 nearest other cells by
Euclidean distance over every cell (brute force), a Gaussian kernel
exp(-beta * distance) whose entropy is bisected onto log(perplexity)
(beta from 1, doubled or halved until bracketed, at most 50 steps, stop
at |H - log U| < 1e-5), then the inverse Simpson index of the labels of
the neighbours under that kernel. `dtype` is the precision of the
distances and the bisection: float64 as the reference computes, float32
for the control one step below. Nothing here imports the measured
package.
"""

from __future__ import annotations

import math

import torch


def knn(X, queries, k: int, block: int = 256):
    """(distances, indices) (M, k) of the k nearest other rows of X (N, d)
    to the rows `queries` (M,) of X, nearest first."""
    mu = torch.mean(X, dim=0, keepdim=True)
    Xc = X - mu
    sq = torch.sum(Xc * Xc, dim=1)
    ds, ids = [], []
    for lo in range(0, queries.shape[0], block):
        q = queries[lo: lo + block]
        d2 = sq[q][:, None] + sq[None, :] - 2.0 * (Xc[q] @ Xc.T)
        d2[torch.arange(q.shape[0], device=X.device), q] = math.inf  # self
        v, i = torch.topk(d2, k, dim=1, largest=False)
        ds.append(torch.sqrt(torch.clamp_min(v, 0.0)))
        ids.append(i)
    return torch.cat(ds), torch.cat(ids)


def simpson(dist, labels, n_cat: int, perplexity: float, tol: float = 1e-5):
    """Inverse-Simpson denominators (M,) of each query's neighbours: dist
    (M, k), labels (M, k) category codes."""
    logU = math.log(perplexity)

    def entropy(beta):
        P = torch.exp(-dist * beta[:, None])
        s = torch.sum(P, dim=1)
        ok = s > 0
        s1 = torch.where(ok, s, torch.ones_like(s))
        H = torch.where(ok, torch.log(s1) + beta * torch.sum(dist * P, 1) / s1,
                        torch.zeros_like(s))
        return H, torch.where(ok[:, None], P / s1[:, None],
                              torch.zeros_like(P))

    beta = torch.ones(dist.shape[0], dtype=dist.dtype, device=dist.device)
    lo = torch.full_like(beta, -math.inf)
    hi = torch.full_like(beta, math.inf)
    H, P = entropy(beta)
    for _ in range(50):
        diff = H - logU
        go = torch.abs(diff) >= tol
        if not bool(torch.any(go)):
            break
        up = diff > 0
        lo = torch.where(go & up, beta, lo)
        hi = torch.where(go & ~up, beta, hi)
        nb = torch.where(
            up, torch.where(torch.isfinite(hi), (beta + hi) / 2, beta * 2),
            torch.where(torch.isfinite(lo), (beta + lo) / 2, beta / 2))
        beta = torch.where(go, nb, beta)
        H2, P2 = entropy(beta)
        H = torch.where(go, H2, H)
        P = torch.where(go[:, None], P2, P)
    onehot = labels[..., None] == torch.arange(n_cat, device=labels.device)
    mass = torch.sum(P[..., None] * onehot, dim=1)              # (M, n_cat)
    out = torch.sum(mass * mass, dim=1)
    return torch.where(H == 0, out - 1.0, out)


def lisi(X, codes, n_cats, queries, perplexity: float = 30,
         dtype=torch.float64):
    """LISI (M, len(codes)) of the rows `queries` of X (N, d), one column
    per label: codes[i] (N,) the category codes of label i, n_cats[i] its
    number of categories."""
    X = X.to(dtype)
    dist, idx = knn(X, queries, int(perplexity * 3) - 1)
    cols = [1.0 / simpson(dist, c[idx], n, perplexity)
            for c, n in zip(codes, n_cats)]
    return torch.stack(cols, dim=1)
