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

On a mesh of several shards the cell-axis fields (Z_corr, Z_cos, a stored
R, cache, rep_cache, rep_Zcos) are lists of the shards' tensors (in a
multi-process run, this process's shards), each in the layout above at
shard size (N_local cells, the shard's chunks), and the rest is replicated
on the lead device (on every rank, bit for bit); `n_devices` records the
shards of the whole mesh.

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
    # Shards the cell-axis fields are split into.
    n_devices: int = 1


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


def sharded_fields(cfg: EngineConfig) -> dict:
    """The cell-axis fields of a state under cfg and the axis each one's
    shards are concatenated along in the global layout (cells of Z and
    the per-cell R; chunk rows of the caches and the chunk-major R)."""
    out = {"Z_corr": 1, "Z_cos": 1}
    if cfg.fused_estep:
        out["cache"] = 0
    if cfg.defer_r:
        out.update(rep_cache=0, rep_Zcos=1)
    else:
        out["R"] = 0 if cfg.fused_estep else 1
    return out


def state_from_numpy(arrays: Mapping[str, np.ndarray], cfg: EngineConfig,
                     rep_blocks=None, device="cpu", mesh=None) -> HarmonyState:
    """Build the port's state from a JAX package ``HarmonyState`` given as
    numpy arrays by field name (for example a JAX checkpoint ``.npz``), on
    `device` or, given a `mesh` of cfg.n_devices shards, split over it.

    The JAX arrays are global: (d, N_pad) cells, caches of n_devices *
    (nc_cap + 1) chunk rows. Deferred-R (cfg.defer_r): the JAX state's
    round key cannot be replayed here, so the caller passes the final
    round's block assignment `rep_blocks` ((L,) integers, the output of the
    JAX package's ``stripe_blocks`` for that key). Stored-R: ``R`` is the
    JAX state's (K, N_pad) array (bf16 given as float32); it is stored in
    cfg.r_dtype, chunk-major on the fused path."""
    from .parallel.sharding import split_cells
    lead = torch.device(device) if mesh is None else mesh.lead
    D = cfg.n_devices
    fields = {k: torch.tensor(np.asarray(arrays[k], np.float32))
              for k in _TENSOR_FIELDS}
    R = torch.tensor(np.asarray(arrays["R"], np.float32))
    checks = [("Z_corr", fields["Z_corr"], (cfg.d, cfg.N_pad)),
              ("Y", fields["Y"], (cfg.d, cfg.K)),
              ("O", fields["O"], (cfg.K, cfg.B))]
    if cfg.fused_estep:
        checks.append(("cache", fields["cache"],
                       (D * (cfg.N_local // cfg.chunk_size), cfg.K, cfg.B1)))
    if cfg.defer_r:
        checks.append(("rep_Zcos", fields["rep_Zcos"], (cfg.d, cfg.N_pad)))
    else:
        checks.append(("R", R, (cfg.K, cfg.N_pad)))
    for name, t, shape in checks:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape} for {cfg}")
    if cfg.defer_r:
        if rep_blocks is None:
            raise ValueError("a deferred-R state needs rep_blocks")
        rep_blocks = torch.tensor(np.asarray(rep_blocks, np.int64))
    else:
        rep_blocks = torch.zeros((1,), dtype=torch.int64)
        if cfg.fused_estep:                           # per shard chunk-major
            R = R.reshape(cfg.K, -1, cfg.chunk_size).permute(1, 0, 2)
    if cfg.defer_r:
        R = torch.zeros((1, 1))                       # the JAX placeholder
    fields["R"] = R.to(cfg.r_torch_dtype).contiguous()
    fields["rep_blocks"] = rep_blocks
    for name, t in fields.items():
        if name in sharded_fields(cfg) and mesh is not None:
            fields[name] = split_cells(t, cfg, mesh, sharded_fields(cfg)[name])
        else:
            fields[name] = t.to(lead)
    n_rounds = int(arrays["n_rounds"])
    return HarmonyState(
        **fields,
        n_kmeans=int(arrays["n_kmeans"]), n_harmony=int(arrays["n_harmony"]),
        kmeans_rounds=[int(x) for x in
                       np.asarray(arrays["kmeans_rounds"])[:n_rounds]],
        n_rounds=n_rounds, converged=bool(arrays["converged"]),
        n_devices=D)
