"""Parameters, data and state of a fit, as dataclasses of tensors.

Layout (the JAX package's, cells are COLUMNS):
  Z_corr, Z_cos : (d, N_local)
  Phi           : (B, N_local)   one-hot batch design, zero on padding
  R             : stored soft assignments in cfg.r_dtype:
                  (n_chunks+1, K, CH) chunk-major on the fused stored path,
                  (K, N_local) on the per-cell path, a (1, 1) placeholder
                  on the deferred path
  Y             : (d, K)
  O, E          : (K, B)
  cache         : (n_chunks+1, K, B+1) per-chunk statistics (fused paths)

Deferred-R fits never hold R. The final k-means round's start-of-round
inputs (rep_*) let the ridge correction and the .R property replay that
round bitwise. Where the JAX state keeps the round's RNG key, this state
keeps the round's block assignment itself (`rep_blocks`), so a replay needs
no random numbers. On the stored paths these fields are placeholders.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .config import EngineConfig


@dataclasses.dataclass
class HarmonyParams:
    theta: torch.Tensor   # (B,)  diversity penalty per batch level
    sigma: torch.Tensor   # (K,)  soft k-means bandwidth per cluster
    lamb: torch.Tensor    # (B+1,) ridge penalty (intercept first, = 0)
    Pr_b: torch.Tensor    # (B,)  batch proportions


@dataclasses.dataclass
class HarmonyData:
    Z_orig: torch.Tensor  # (d, N_local) original embedding (zero on padding)
    Phi: torch.Tensor     # (B, N_local) one-hot design (zero on padding)
    mask: torch.Tensor    # (N_local,)  1.0 for real cells, 0.0 for padding


@dataclasses.dataclass
class HarmonyState:
    Z_corr: torch.Tensor
    Z_cos: torch.Tensor
    R: torch.Tensor
    Y: torch.Tensor
    O: torch.Tensor
    E: torch.Tensor
    cache: torch.Tensor

    # Objective ring buffers (float32, on the fit's device) and counters.
    obj_kmeans: torch.Tensor
    obj_dist: torch.Tensor
    obj_entropy: torch.Tensor
    obj_cross: torch.Tensor
    n_kmeans: int
    obj_harmony: torch.Tensor
    n_harmony: int
    kmeans_rounds: list
    n_rounds: int
    converged: bool

    # Deferred-R replay bundle: the next cluster loop's initial centroid
    # numerator, and the final round's start-of-round inputs.
    Ysum0: torch.Tensor
    rep_Y: torch.Tensor
    rep_O: torch.Tensor
    rep_E: torch.Tensor
    rep_blocks: torch.Tensor    # (L,) int64 block of every chunk
    rep_cache: torch.Tensor
    rep_Zcos: torch.Tensor      # the Z_cos the final round read

    # Fused E-step passes (k-means rounds + replay windows) run so far.
    n_passes: int = 0


def empty_histories(cfg: EngineConfig, device) -> dict:
    def z(n):
        return torch.zeros((n,), dtype=torch.float32, device=device)
    return dict(
        obj_kmeans=z(cfg.kmeans_hist_len), obj_dist=z(cfg.kmeans_hist_len),
        obj_entropy=z(cfg.kmeans_hist_len), obj_cross=z(cfg.kmeans_hist_len),
        n_kmeans=0, obj_harmony=z(cfg.harmony_hist_len), n_harmony=0,
        kmeans_rounds=[], n_rounds=0, converged=False)


def defer_placeholders(cfg: EngineConfig, device) -> dict:
    """(1, 1)-scale values for the deferred-R fields of a stored-R state."""
    one = torch.zeros((1, 1), dtype=torch.float32, device=device)
    return dict(Ysum0=one, rep_Y=one, rep_O=one, rep_E=one,
                rep_blocks=torch.zeros((1,), dtype=torch.int64,
                                       device=device),
                rep_cache=one[None], rep_Zcos=one)


def append(buf: torch.Tensor, n: int, value) -> int:
    """Ring-buffer append in place: buf[n] = value; returns n + 1."""
    buf[n] = value
    return n + 1


_TENSOR_FIELDS = ("Z_corr", "Z_cos", "Y", "O", "E", "cache", "obj_kmeans",
                  "obj_dist", "obj_entropy", "obj_cross", "obj_harmony",
                  "Ysum0", "rep_Y", "rep_O", "rep_E", "rep_cache", "rep_Zcos")


def state_from_numpy(arrays: Mapping[str, np.ndarray], cfg: EngineConfig,
                     rep_blocks=None, device="cpu") -> HarmonyState:
    """Build the port's state from a JAX package ``HarmonyState`` given as
    numpy arrays by field name (for example a JAX checkpoint ``.npz``).

    Deferred-R (cfg.defer_r): the JAX state's round key cannot be replayed
    here, so the caller passes the final round's block assignment
    `rep_blocks` ((L,) integers, the output of the JAX package's
    ``stripe_blocks`` for that key). Stored-R: ``R`` is the JAX state's
    (K, N_pad) array (bf16 given as float32); it is stored in cfg.r_dtype,
    chunk-major on the fused path."""
    fields = {k: torch.tensor(np.asarray(arrays[k], np.float32),
                              device=device) for k in _TENSOR_FIELDS}
    R = torch.tensor(np.asarray(arrays["R"], np.float32), device=device)
    checks = [("Z_corr", fields["Z_corr"], (cfg.d, cfg.N_local)),
              ("Y", fields["Y"], (cfg.d, cfg.K)),
              ("O", fields["O"], (cfg.K, cfg.B))]
    if cfg.fused_estep:
        checks.append(("cache", fields["cache"],
                       (cfg.N_local // cfg.chunk_size, cfg.K, cfg.B1)))
    if cfg.defer_r:
        checks.append(("rep_Zcos", fields["rep_Zcos"], (cfg.d, cfg.N_local)))
    else:
        checks.append(("R", R, (cfg.K, cfg.N_local)))
    for name, t, shape in checks:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape} for {cfg}")
    R = R.to(cfg.r_torch_dtype)
    if cfg.defer_r:
        if rep_blocks is None:
            raise ValueError("a deferred-R state needs rep_blocks")
        rep_blocks = torch.tensor(np.asarray(rep_blocks, np.int64),
                                  device=device)
    else:
        rep_blocks = torch.zeros((1,), dtype=torch.int64, device=device)
        if cfg.fused_estep:
            R = R.reshape(cfg.K, -1, cfg.chunk_size).permute(1, 0, 2)
    fields["R"] = R.contiguous()
    n_rounds = int(arrays["n_rounds"])
    return HarmonyState(
        **fields,
        n_kmeans=int(arrays["n_kmeans"]), n_harmony=int(arrays["n_harmony"]),
        kmeans_rounds=[int(x) for x in
                       np.asarray(arrays["kmeans_rounds"])[:n_rounds]],
        n_rounds=n_rounds, converged=bool(arrays["converged"]),
        rep_blocks=rep_blocks)
