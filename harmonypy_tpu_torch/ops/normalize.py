"""Column L2 normalization with a zero-column guard (reference
harmony.py:238, 377, 444, 569) and safe entropy x*log(x) (harmony.py:572-576)."""

from __future__ import annotations

import torch


def l2_normalize_cols(X: torch.Tensor) -> torch.Tensor:
    """Normalize each column of X to unit L2 norm; zero columns stay zero."""
    norm = torch.sqrt(torch.sum(X * X, dim=0, keepdim=True))
    return X / torch.where(norm > 0.0, norm, torch.ones_like(norm))


def safe_entropy(x: torch.Tensor) -> torch.Tensor:
    """x * log(x), with 0 where x <= 0."""
    pos = x > 0.0
    return torch.where(pos, x * torch.log(torch.where(pos, x,
                                                      torch.ones_like(x))),
                       torch.zeros_like(x))
