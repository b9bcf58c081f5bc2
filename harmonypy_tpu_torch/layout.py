"""Host-side cell-axis padding for one device (the JAX package's
parallel/sharding.py without the mesh). Every shard holds N_shard_real real
cells followed by its own zero padding, so the fused E-step's contract —
the final chunk is the all-zero dummy — holds. Padded cells carry zero
columns in Z and Phi and mask == 0."""

from __future__ import annotations

import numpy as np

from .config import EngineConfig


def pad_cells(arr: np.ndarray, cfg: EngineConfig) -> np.ndarray:
    """Lay a (x, N) array out as (x, N_pad) with per-shard padding."""
    arr = np.asarray(arr, dtype=np.float32)
    q, Nl = cfg.N_shard_real, cfg.N_local
    if arr.shape[-1] == cfg.N_pad and q == Nl:
        return np.ascontiguousarray(arr)
    out = np.zeros(arr.shape[:-1] + (cfg.N_pad,), dtype=np.float32)
    for i in range(cfg.n_devices):
        lo, hi = i * q, min((i + 1) * q, cfg.N)
        if hi <= lo:
            break
        out[..., i * Nl: i * Nl + (hi - lo)] = arr[..., lo:hi]
    return out


def unpad_cells(arr: np.ndarray, cfg: EngineConfig) -> np.ndarray:
    """Inverse of pad_cells: (x, N_pad) -> (x, N) real columns in order."""
    arr = np.asarray(arr)
    q, Nl = cfg.N_shard_real, cfg.N_local
    if arr.shape[-1] == cfg.N:
        return arr
    real = arr.reshape(arr.shape[:-1] + (cfg.n_devices, Nl))[..., :q]
    return real.reshape(arr.shape[:-1] + (cfg.n_devices * q,))[..., : cfg.N]


def shard_mask(cfg: EngineConfig) -> np.ndarray:
    """(N_pad,) float mask: 1.0 on real cells, 0.0 on per-shard padding."""
    q, Nl = cfg.N_shard_real, cfg.N_local
    off = np.arange(cfg.N_pad) % Nl
    gid = (np.arange(cfg.N_pad) // Nl) * q + off
    return ((off < q) & (gid < cfg.N)).astype(np.float32)
