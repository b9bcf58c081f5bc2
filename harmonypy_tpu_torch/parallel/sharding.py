"""Cell-axis padding and sharding, and the one-device layout of a shard
(JAX package parallel/sharding.py).

Padding is per shard: every shard holds cfg.N_shard_real real cells (the
last shard possibly fewer) followed by its own zero padding, so the fused
paths' contract — each shard's final chunk is the all-zero dummy — holds on
any mesh. Padded cells carry zero columns in Z and Phi and mask == 0.
Outputs strip the padding again with unpad_cells.

On one device a sharded quantity is a tensor; on a mesh of several shards
it is the list of this process's shards' tensors, each on its shard's
device (`parts` and `pack` convert). In a multi-process run a process
holds the shards `local_shards(cfg.n_devices)` (parallel/mesh.py), and
every function here that takes a shard index takes its global index:
shard s's cells start at s * N_local of the padded layout, as the JAX
package's io/loader.py:212-214 cuts them.

The one-device layout. Every N-axis computation outside the E-step kernel
runs on a mesh shard in the shapes one device uses, so cuBLAS, the
reductions and the elementwise kernels pick what they pick on one device
and every cell's values are the one-device bits. It runs over the
one-device windows of chunks (`ops/replay.windows`), each
shard only over the windows that hold its chunks: `window_of` gives a
window's rows of a chunk-major array (the init pass's stored R, the first
stored centroid numerator, the replays' and the stored ridge's products)
with the shard's chunks in place and zeros elsewhere, `put_window` stores
them back; `cells_window` and `put_cells` do the same for a shard's
(rows, N_local) cell inputs (Z, Phi, the mask; the stored ridge's Z_corr),
giving each window as a new chunk-major array. One device runs the same
windows, so no shard holds an array of the one-device width: work and
memory per shard fall with the mesh. The column normalisation needs no
window (ops/normalize.l2_normalize_cells). On one device window_of and
put_window slice, and cells_window copies the window like a shard's.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from ..config import EngineConfig
from ..state import HarmonyData
from ..utils.profiling import span
from .mesh import all_gather_cat, all_gather_rows, local_shards, \
    spans_processes


def pad_cells(arr: np.ndarray, cfg: EngineConfig,
              shards: range | None = None) -> np.ndarray:
    """Lay a (x, N) array out as (x, N_pad) with per-shard padding. With
    `shards` (a range of shard ids), arr holds only their cells (from cell
    shards[0] * N_shard_real on) and the result their (x, len(shards) *
    N_local) part of the padded layout."""
    arr = np.asarray(arr, dtype=np.float32)
    q, Nl = cfg.N_shard_real, cfg.N_local
    if shards is None:
        shards = range(cfg.n_devices)
        if arr.shape[-1] == cfg.N_pad and q == Nl:
            return np.ascontiguousarray(arr)
    out = np.zeros(arr.shape[:-1] + (len(shards) * Nl,), dtype=np.float32)
    base = shards[0] * q
    for i, s in enumerate(shards):
        lo, hi = s * q, min((s + 1) * q, cfg.N)
        if hi <= lo:
            break
        out[..., i * Nl: i * Nl + (hi - lo)] = arr[..., lo - base: hi - base]
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
    n_devices * rows) into this process's shards, each on its device."""
    n = t.shape[axis] // cfg.n_devices
    return pack(t.narrow(axis, s * n, n).to(dev).contiguous()
                for s, dev in zip(mesh.shard_ids, mesh.devices))


def cat_cells(x, axis: int = -1) -> torch.Tensor:
    """The shards of a sharded quantity held by this process, concatenated
    on the CPU (the global padded array in one process)."""
    with span("sync::readback"):
        return torch.cat([p.detach().cpu() for p in parts(x)], dim=axis)


def gather_cells(x, cfg: EngineConfig, axis: int = -1) -> torch.Tensor:
    """The global padded array of a sharded quantity, on the CPU, on every
    process (the JAX package's process_allgather(tiled=True)): in a
    multi-process run a collective that every rank calls, gathering the
    processes' parts in rank order (copies only)."""
    if not spans_processes(cfg.n_devices):
        return cat_cells(x, axis)
    xs = [p.detach() for p in parts(x)]
    local = torch.cat([p.to(xs[0].device) for p in xs], dim=axis)
    return all_gather_cat(local, axis).cpu()


def cell_range(cfg: EngineConfig, mesh) -> tuple[int, int]:
    """[first, end) of the real cells this process's shards hold."""
    q, ids = cfg.N_shard_real, mesh.shard_ids
    return min(ids[0] * q, cfg.N), min((ids[-1] + 1) * q, cfg.N)


@dataclasses.dataclass(frozen=True)
class OneHotCodes:
    """A one-hot design (B, N) held as its covariates' category codes:
    codes (V, N) integers, -1 where a cell's value is missing; covariate
    v's rows start at sum(n_cats[:v]). Row r of the design is 1.0 where
    the cell's code of r's covariate picks r, as pd.get_dummies lays out
    the categorical columns (a missing value leaves the column zero)."""

    codes: np.ndarray
    n_cats: tuple

    @property
    def shape(self) -> tuple[int, int]:
        return sum(self.n_cats), self.codes.shape[1]

    def cells(self, lo: int, hi: int) -> "OneHotCodes":
        return OneHotCodes(self.codes[:, lo:hi], self.n_cats)

    def counts(self) -> np.ndarray:
        """(B,) float32 cells per row, the design's row sums."""
        return np.concatenate([
            np.bincount(c[c >= 0], minlength=n) for c, n in
            zip(self.codes, self.n_cats)]).astype(np.float32)

    def single_onehot(self) -> bool:
        """Whether every column holds exactly one 1.0."""
        return bool(self.codes.shape[1] and np.all(
            np.sum(self.codes >= 0, axis=0) == 1))


def shard_inputs(Z: np.ndarray, Phi, cfg: EngineConfig, mesh) -> HarmonyData:
    """Upload (d, N) Z and the (B, N) design Phi (an array or OneHotCodes),
    padded per shard, each of this process's shards to its device."""
    lo, hi = cell_range(cfg, mesh)
    Phi = (Phi.cells(lo, hi) if isinstance(Phi, OneHotCodes)
           else np.asarray(Phi)[:, lo:hi])
    return shard_local_inputs(np.asarray(Z)[:, lo:hi], Phi, cfg, mesh)


def shard_local_inputs(Z: np.ndarray, Phi, cfg: EngineConfig,
                       mesh) -> HarmonyData:
    """shard_inputs from this process's cells alone: Z (d, n) and Phi (B,
    n) the cells of cell_range(cfg, mesh), so a process reads and uploads
    only its range (JAX package io/loader.py:218-247).

    Each shard's cells cross to its device as the caller holds them, and
    the padded layout is built there (api::layout): an array whose
    transpose is C-contiguous (cells first, as run_harmony's transposed
    (N, d) embedding) goes as the shard's (n, x) rows and is transposed
    on the device; any other array goes as its (x, n) columns. A
    OneHotCodes design goes as its codes, and the ones are scattered on
    the device. The values are copies, so every tensor is bitwise
    pad_cells' and shard_mask's."""
    ids, q, Nl = mesh.shard_ids, cfg.N_shard_real, cfg.N_local
    base = ids[0] * q
    Z = np.asarray(Z, dtype=np.float32)
    coded = isinstance(Phi, OneHotCodes)
    if not coded:
        Phi = np.asarray(Phi, dtype=np.float32)
    Zs, Phis, masks = [], [], []
    for s, dev in zip(ids, mesh.devices):
        lo = min(s * q, cfg.N) - base
        n = min((s + 1) * q, cfg.N) - base - lo
        Zs.append(_padded(Z, lo, n, Nl, dev))
        Phis.append(_one_hot(Phi, lo, n, Nl, dev) if coded
                    else _padded(Phi, lo, n, Nl, dev))
        with span("api::layout"):
            masks.append((torch.arange(Nl, device=dev) < n).to(
                torch.float32))
    return HarmonyData(Z_orig=pack(Zs), Phi=pack(Phis), mask=pack(masks))


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """a as a CPU tensor sharing its memory (read only here: a read-only
    array's warning says nothing)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return torch.from_numpy(a)


def _padded(a: np.ndarray, lo: int, n: int, Nl: int, dev) -> torch.Tensor:
    """Columns [lo, lo + n) of the float32 (x, n_all) array a, as (x, Nl)
    on dev, zero past n: uploaded in a's own layout, laid out there."""
    rows = a.T.flags.c_contiguous and not a.flags.c_contiguous
    with span("sync::upload"):
        raw = _host_tensor(a.T[lo: lo + n] if rows else
                           np.ascontiguousarray(a[:, lo: lo + n])).to(dev)
    with span("api::layout"):
        out = torch.empty((a.shape[0], Nl), dtype=torch.float32, device=dev)
        out[:, :n] = raw.T if rows else raw
        out[:, n:] = 0.0
    return out


def _one_hot(design: OneHotCodes, lo: int, n: int, Nl: int,
             dev) -> torch.Tensor:
    """Cells [lo, lo + n) of a OneHotCodes design, as its (B, Nl) float32
    one-hot on dev, zero past n: the codes uploaded, the ones scattered.
    A missing code writes 0.0 into its covariate's first row, which no
    other write of that cell touches."""
    with span("sync::upload"):
        codes = _host_tensor(np.ascontiguousarray(
            design.codes[:, lo: lo + n])).to(dev)
    with span("api::layout"):
        out = torch.zeros(design.shape[0], Nl, dtype=torch.float32,
                          device=dev)
        flat, cols = out.view(-1), torch.arange(n, device=dev)
        row0 = 0
        for c, m in zip(codes.long(), design.n_cats):
            if m:
                flat.scatter_(0, (c.clamp(min=0) + row0) * Nl + cols,
                              (c >= 0).to(torch.float32))
            row0 += m
    return out


def one_device(cfg: EngineConfig) -> EngineConfig:
    """The configuration of the same fit on one device."""
    return dataclasses.replace(cfg, n_devices=1)


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


def cells_window(x: torch.Tensor, s: int, geom, lo: int,
                 width: int) -> torch.Tensor:
    """The cell-axis twin of window_of: chunks [lo, lo + width) of shard
    s's (rows, N_local) cell array in the one-device layout, as a new
    chunk-major (width, rows, CH) array with the shard's real chunks of the
    window in place and zeros elsewhere (padding cells are zero anyway).
    The same shape and strides on one device and on every shard."""
    CH, rows = geom.CH, x.shape[0]
    out = x.new_zeros((width, rows, CH))
    l0, p0, n = window_rows(geom, s, lo, width)
    out[p0: p0 + n] = x[:, l0 * CH: (l0 + n) * CH].reshape(
        rows, n, CH).permute(1, 0, 2)
    return out


def put_cells(buf: torch.Tensor, rows3: torch.Tensor, s: int, geom, lo: int,
              width: int) -> None:
    """Store a chunk-major window (width, rows, CH) into shard s's
    (rows, N_local) cell array buf (its real chunks of the window)."""
    CH = geom.CH
    l0, p0, n = window_rows(geom, s, lo, width)
    buf[:, l0 * CH: (l0 + n) * CH] = rows3[p0: p0 + n].permute(
        1, 0, 2).reshape(buf.shape[0], n * CH)


def gather_cols(xs, ids: torch.Tensor, cfg: EngineConfig) -> torch.Tensor:
    """(rows, S) columns of a sharded array at global cell ids (each < N),
    on the lead device: on one device the columns themselves; on a mesh
    each shard's columns of the ids it owns, copied into place (the JAX
    package's owner-scatter, ops/kmeans.py:54-64, by index copy); across
    processes each rank's owned columns all-gathered, then each column
    taken from its owner's part (every rank calls it with the same ids).
    Copies only, so the bits are one device's on any mesh."""
    xs = parts(xs)
    if cfg.n_devices == 1:
        return xs[0][:, ids.to(xs[0].device)]
    lead, q = xs[0].device, cfg.N_shard_real
    ids = ids.to(lead)
    multi = spans_processes(cfg.n_devices)
    out = (xs[0].new_zeros if multi else xs[0].new_empty)(
        (xs[0].shape[0], ids.shape[0]))
    owner = torch.div(ids, q, rounding_mode="floor")
    for s, x in zip(local_shards(cfg.n_devices), xs):
        pos = torch.nonzero(owner == s).squeeze(1)
        out[:, pos] = x[:, (ids[pos] - s * q).to(x.device)].to(lead)
    if not multi:
        return out
    every = all_gather_rows(out[None])                   # (P, rows, S)
    rank = torch.div(owner, len(xs), rounding_mode="floor")
    return every[rank, :, torch.arange(ids.shape[0], device=lead)].T \
        .contiguous()
