"""Cell-axis padding and sharding, and the one-device layout of a shard
(JAX package parallel/sharding.py).

Padding is per shard: every shard holds cfg.N_shard_real real cells (the
last shard possibly fewer) followed by its own zero padding, so the fused
paths' contract — each shard's final chunk is the all-zero dummy — holds on
any mesh. Padded cells carry zero columns in Z and Phi and mask == 0.
Outputs strip the padding again with unpad_cells.

On one device a sharded quantity is a tensor; on a mesh of several shards
it is the list of the shards' tensors, each on its shard's device (`parts`
and `pack` convert).

The one-device layout. Every N-axis computation outside the E-step kernel
runs on a mesh shard in the shapes one device uses, so cuBLAS, the
reductions and the elementwise kernels pick what they pick on one device
and every cell's values are the one-device bits:
  - the K-row work (the init pass and stored R, the first stored centroid
    numerator, the replays' and the stored ridge's products) runs over the
    one-device windows of chunks (`ops/replay.windows`, the ridge's own),
    each shard only over the windows that hold its chunks: `window_of`
    gives a window's rows with the shard's chunks in place and zeros
    elsewhere, `put_window` stores them back. Work and K-row memory per
    shard fall with the mesh;
  - the cell inputs (Z, Phi, the mask; the stored ridge's Z_corr: 2d +
    B + 1 rows at most) are held whole: `embed_cols` places a shard's
    columns where one device holds them, `extract_cols` takes them back,
    and `extract_chunks` takes a shard's rows of per-chunk results. Each
    shard holds these one-device sized, and the column normalisation runs
    over all of them.
On one device the helpers are the identity (or a slice).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import EngineConfig
from ..state import HarmonyData


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


def parts(x) -> list:
    """The shards of a sharded quantity (a tensor on one device)."""
    return list(x) if isinstance(x, (list, tuple)) else [x]


def pack(xs):
    """A sharded quantity from its shards: the tensor itself for one."""
    xs = list(xs)
    return xs[0] if len(xs) == 1 else xs


def split_cells(t: torch.Tensor, cfg: EngineConfig, mesh, axis: int = -1):
    """Cut a global padded array (cells on `axis`, N_pad long, or
    n_devices * rows) into its shards, each on its device."""
    n = t.shape[axis] // cfg.n_devices
    return pack(t.narrow(axis, s * n, n).to(dev).contiguous()
                for s, dev in enumerate(mesh.devices))


def cat_cells(x, axis: int = -1) -> torch.Tensor:
    """The global padded array of a sharded quantity, on the CPU."""
    return torch.cat([p.detach().cpu() for p in parts(x)], dim=axis)


def shard_inputs(Z: np.ndarray, Phi: np.ndarray, cfg: EngineConfig,
                 mesh) -> HarmonyData:
    """Upload (d, N) Z and (B, N) Phi, padded per shard, each shard to its
    device."""
    def up(a):
        return split_cells(torch.as_tensor(a), cfg, mesh)
    return HarmonyData(Z_orig=up(pad_cells(Z, cfg)), Phi=up(pad_cells(Phi,
                       cfg)), mask=up(shard_mask(cfg)))


def one_device(cfg: EngineConfig) -> EngineConfig:
    """The configuration of the same fit on one device."""
    return dataclasses.replace(cfg, n_devices=1)


def shard_cells(cfg: EngineConfig, s: int) -> tuple[int, int]:
    """(first global cell, real cells) of shard s."""
    q = cfg.N_shard_real
    return s * q, max(0, min(q, cfg.N - s * q))


def embed_cols(x: torch.Tensor, s: int, cfg: EngineConfig) -> torch.Tensor:
    """Shard s's (rows, N_local) columns in the one-device (rows, N_pad)
    layout, zero elsewhere, on the shard's device."""
    if cfg.n_devices == 1:
        return x
    lo, n = shard_cells(cfg, s)
    out = x.new_zeros(x.shape[:-1] + (one_device(cfg).N_pad,))
    out[..., lo: lo + n] = x[..., :n]
    return out


def extract_cols(y: torch.Tensor, s: int, cfg: EngineConfig) -> torch.Tensor:
    """Inverse of embed_cols: shard s's (rows, N_local) columns of a
    one-device-layout array, zero on the shard's padding."""
    if cfg.n_devices == 1:
        return y
    lo, n = shard_cells(cfg, s)
    out = y.new_zeros(y.shape[:-1] + (cfg.N_local,))
    out[..., :n] = y[..., lo: lo + n]
    return out


def shard_chunks(nc_cap: int, NC_real: int, s: int) -> tuple[int, int]:
    """(first global chunk, real chunks) of shard s."""
    return s * nc_cap, max(0, min(nc_cap, NC_real - s * nc_cap))


def extract_chunks(y3: torch.Tensor, s: int, geom) -> torch.Tensor:
    """Shard s's (nc_cap + 1, ...) rows of a one-device chunk-major array,
    zero past its real chunks."""
    if geom.n_devices == 1:
        return y3
    lo, n = shard_chunks(geom.nc_cap, geom.NC_real, s)
    out = y3.new_zeros((geom.nc_cap + 1,) + tuple(y3.shape[1:]))
    out[:n] = y3[lo: lo + n]
    return out


def window_rows(geom, s: int, lo: int, width: int):
    """Shard s's part of the global chunk window [lo, lo + width): (first
    local chunk, first window row, rows), rows 0 when it holds none."""
    c0, n = shard_chunks(geom.nc_cap, geom.NC_real, s)
    a, b = max(lo, c0), min(lo + width, c0 + n)
    if b <= a:
        return 0, 0, 0
    return a - c0, a - lo, b - a


def holds_window(geom, s: int, lo: int, width: int) -> bool:
    """Whether shard s holds any chunk of the global window [lo, lo +
    width): always on one device."""
    return geom.n_devices == 1 or window_rows(geom, s, lo, width)[2] > 0


def window_of(x3: torch.Tensor, s: int, geom, lo: int,
              width: int) -> torch.Tensor:
    """Rows [lo, lo + width) of a chunk-major array in the one-device
    layout: on one device the slice itself, on a mesh shard s's rows of the
    window in place and zeros elsewhere (the same shape and strides)."""
    if geom.n_devices == 1:
        return x3[lo: lo + width]
    l0, p0, n = window_rows(geom, s, lo, width)
    out = x3.new_zeros((width,) + tuple(x3.shape[1:]))
    out[p0: p0 + n] = x3[l0: l0 + n]
    return out


def put_window(buf: torch.Tensor, rows: torch.Tensor, s: int, geom, lo: int,
               width: int) -> None:
    """Store a window's rows (width, ...) into shard s's chunk-major buf."""
    if geom.n_devices == 1:
        buf[lo: lo + width] = rows
        return
    l0, p0, n = window_rows(geom, s, lo, width)
    buf[l0: l0 + n] = rows[p0: p0 + n]


def real_cols(xs, cfg: EngineConfig) -> torch.Tensor:
    """A sharded array's real columns in cell order on the lead device: on
    one device the padded array itself (real cells first), on a mesh the
    (rows, N) gather of every shard's."""
    xs = parts(xs)
    if len(xs) == 1:
        return xs[0]
    lead = xs[0].device
    return torch.cat([x[..., : shard_cells(cfg, s)[1]].to(lead)
                      for s, x in enumerate(xs)], dim=-1)
