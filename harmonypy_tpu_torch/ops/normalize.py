"""Column L2 normalization with a zero-column guard (reference
harmony.py:238, 377, 444, 569) and safe entropy x*log(x) (harmony.py:572-576)."""

from __future__ import annotations

import torch


def l2_normalize_cols(X: torch.Tensor) -> torch.Tensor:
    """Normalize each column of X to unit L2 norm; zero columns stay zero."""
    norm = torch.sqrt(torch.sum(X * X, dim=0, keepdim=True))
    return X / torch.where(norm > 0.0, norm, torch.ones_like(norm))


def l2_normalize_cells(X: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Each cell's vector (along `dim`) scaled to unit L2 norm, zero vectors
    kept, with the sum of squares taken component after component by
    elementwise ops: a cell's bits depend on its own values only, not on
    the array's shape or layout, so a mesh shard's cells equal one
    device's, and a (d, cells) array and a chunk-major (chunks, d, CH)
    window give the same bits (a torch.sum picks its order, and so its
    rounding, by shape)."""
    xs = X.unbind(dim)
    ss = xs[0] * xs[0]
    for x in xs[1:]:
        ss = ss + x * x
    norm = torch.sqrt(ss).unsqueeze(dim)
    return X / torch.where(norm > 0.0, norm, torch.ones_like(norm))


def safe_entropy(x: torch.Tensor) -> torch.Tensor:
    """x * log(x), with 0 where x <= 0."""
    pos = x > 0.0
    return torch.where(pos, x * torch.log(torch.where(pos, x,
                                                      torch.ones_like(x))),
                       torch.zeros_like(x))
