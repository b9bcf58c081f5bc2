"""Deferred-R replays: the ridge correction and the .R property reproduce
the final k-means round instead of storing R (JAX package
ops/update_r_fused_xla.py:241-371).

Every replay reruns the whole round (the O/E evolution is sequential over
blocks) and takes the r of one window of chunks from its `r_window`
epilogue: the one-launch kernel on one device, the per-block entry on a
mesh (`round_r_windows`). The round and its replays run the same kernel on
the same tables, so the replayed r is the round's r bitwise. The per-chunk
design products then run in torch on that window; windows are bounded by a
memory budget, one replay per window.

Windows are global chunk ranges, the one-device ones on every mesh: a mesh
shard computes the products of the windows that hold its chunks, each in
the one-device window shape with its own chunks in place and zeros
elsewhere (parallel/sharding.py), so its rows are the one-device rows bit
for bit, and the rows are reduced through the global frame.
"""

from __future__ import annotations

import torch

from ..config import EngineConfig
from ..parallel.mesh import local_shards
from ..parallel.sharding import (one_device, put_window, window_of,
                                 window_rows)
from .cuda.fused_estep import fused_estep, fused_estep_mesh
from .normalize import l2_normalize_cells
from .partition import frame_sum, partition_geometry
from .products import einsum, operand

# Cap on the elements of one window of r (width * K * CH floats): 1 GiB.
WINDOW_ELEMS = 256 * 1024 * 1024
# The init pass (engine._init_pass) works in quarter-size windows: its
# temporaries, about five windows, then stay near one K x N array.
INIT_ELEMS = WINDOW_ELEMS // 4


def window_width(cfg: EngineConfig, budget: int = WINDOW_ELEMS) -> int:
    geom = partition_geometry(cfg)
    return max(1, min(geom.nc_cap, budget // max(geom.CH * cfg.K, 1)))


def windows(cfg: EngineConfig, budget: int = WINDOW_ELEMS):
    """(lo, width) chunk windows covering the real chunks."""
    nc, w = partition_geometry(cfg).nc_cap, window_width(cfg, budget)
    return [(lo, min(w, nc - lo)) for lo in range(0, nc, w)]


def replay_r(tables, ZP3, Y, sigma, theta, Pr_b, O, E, fast_ent: bool,
             lo: int, width: int, precision: str = "float32") -> torch.Tensor:
    """r (width, K, CH) of chunks lo..lo+width-1 in the replayed round on
    one device; `tables` = (slots, removal) of that round; precision: the
    round's (cfg.matmul_precision)."""
    slots, removal = tables
    return fused_estep(slots, removal, ZP3, Y, sigma, theta, Pr_b, O, E,
                       fast_ent, lo, width, precision=precision)[5]


def round_r_windows(tables, ZP3s, rep, fast_ent: bool, geom, lo: int,
                    width: int, precision: str = "float32") -> list:
    """r of the global chunk window [lo, lo + width) in the replayed round,
    per shard of this process: a (width, K, CH) tensor holding the shard's
    chunks of the window (zero elsewhere), or None for a shard that holds
    none. tables: MeshTables of the round; rep = (Y, sigma, theta, Pr_b, O,
    E); precision: the round's."""
    if geom.n_devices == 1:
        return [replay_r((tables.slots[0], tables.removal), ZP3s[0], *rep,
                         fast_ent, lo, width, precision)]
    wins = [(lo - s * geom.nc_cap, width)
            if window_rows(geom, s, lo, width)[2] else None
            for s in local_shards(geom.n_devices)]
    return fused_estep_mesh(tables, ZP3s, *rep, fast_ent, geom.J_fix,
                            windows=wins, precision=precision)[5]


def window_normal_eq(a, zo, r, one: bool) -> torch.Tensor:
    """The per-chunk ridge normal equations (w, B1*(B1+d), K) of one window
    of chunks: design rows a (w, B1, CH), Z_orig zo (w, d, CH), soft
    assignments r (w, K, CH). Rows b*B1+c hold sum a_b a_c r, rows B1*B1 +
    b*d + x sum a_b z_x r. The replays and the stored ridge share it, so
    the same r gives the same bits on both paths. one: the products as one
    bf16 pass (ops/products.py), r rounded once for all of them."""
    w, B1 = a.shape[:2]
    r = operand(r, one)
    Fa = (a[:, :, None, :] * a[:, None, :, :]).reshape(w, B1 * B1, -1)
    Sa = einsum("jfc,jkc->jfk", Fa, r, one)
    Sz = [einsum("jdc,jkc->jdk", a[:, b, None, :] * zo, r, one)
          for b in range(B1)]
    return torch.cat([Sa] + Sz, dim=1)


def window_apply(a, zo, r, W, one: bool) -> torch.Tensor:
    """Z_orig minus the ridge correction over one window of chunks
    (harmony.py:559-569): zo - sum_b a_b (W[:, b]^T r), (w, d, CH); shared
    by the replays and the stored ridge. one: as window_normal_eq's."""
    r = operand(r, one)
    corr = a[:, 0, None, :] * einsum("kd,jkc->jdc", W[:, 0, :], r, one)
    for b in range(1, a.shape[1]):
        corr = corr + (a[:, b, None, :]
                       * einsum("kd,jkc->jdc", W[:, b, :], r, one))
    return zo - corr


def replay_normal_eq(tables, ZP3s, ZO3s, rep, cfg: EngineConfig,
                     fast_ent: bool, budget: int = WINDOW_ELEMS, *,
                     one: bool):
    """Ridge normal equations from the replayed r: S (B1*(B1+d), K), rows
    b*B1+c for cov[., b, c] and B1*B1 + b*d + x for rhs[., b, x]. The design
    rows a = [mask; Phi] are the leading B1 rows of the slab; ZO3s are the
    shards' (nc1, d, CH) chunk-major Z_orig."""
    B1 = cfg.B1
    geom = partition_geometry(cfg)
    Sbufs = [torch.zeros((Z.shape[0], B1 * (B1 + cfg.d), cfg.K),
                         dtype=torch.float32, device=Z.device) for Z in ZP3s]
    for lo, w in windows(one_device(cfg), budget):
        rs = round_r_windows(tables, ZP3s, rep, fast_ent, geom, lo, w,
                             cfg.matmul_precision)
        for i, (s, r) in enumerate(zip(local_shards(cfg.n_devices), rs)):
            if r is None:
                continue
            put_window(Sbufs[i], window_normal_eq(
                window_of(ZP3s[i], s, geom, lo, w)[:, :B1, :],
                window_of(ZO3s[i], s, geom, lo, w), r,
                one), s, geom, lo, w)
    return frame_sum(Sbufs, geom)


def replay_apply(tables, ZP3s, ZO3s, W, rep, cfg: EngineConfig,
                 fast_ent: bool, budget: int = WINDOW_ELEMS, *,
                 one: bool):
    """Apply the ridge correction with the replayed r (harmony.py:559-569):
    returns per shard (Zc3, Zs3) (nc1, d, CH) — the corrected embedding and
    its L2-normalization, zero on the dummy chunk — and Ysum0 (d, K), the
    next cluster loop's initial centroid numerator Z_cos_new r^T."""
    B1, d = cfg.B1, cfg.d
    geom = partition_geometry(cfg)
    Zc3s, Zs3s, ybufs = [], [], []
    for Z in ZP3s:
        nc1, _, CH = Z.shape
        Zc3s.append(torch.zeros((nc1, d, CH), dtype=torch.float32,
                                device=Z.device))
        Zs3s.append(torch.zeros_like(Zc3s[-1]))
        ybufs.append(torch.zeros((nc1, d, cfg.K), dtype=torch.float32,
                                 device=Z.device))
    for lo, w in windows(one_device(cfg), budget):
        rs = round_r_windows(tables, ZP3s, rep, fast_ent, geom, lo, w,
                             cfg.matmul_precision)
        for i, (s, r) in enumerate(zip(local_shards(cfg.n_devices), rs)):
            if r is None:
                continue
            r = operand(r, one)
            zc = window_apply(window_of(ZP3s[i], s, geom, lo, w)[:, :B1, :],
                              window_of(ZO3s[i], s, geom, lo, w), r,
                              W.to(r.device), one)
            # Each cell's column normalised as the stored fit's
            # normalize_cells does it, so the two paths keep one Z_cos.
            zs = l2_normalize_cells(zc, dim=1)
            put_window(Zc3s[i], zc, s, geom, lo, w)
            put_window(Zs3s[i], zs, s, geom, lo, w)
            put_window(ybufs[i], einsum("jdc,jkc->jdk", zs, r, one), s,
                       geom, lo, w)
    return Zc3s, Zs3s, frame_sum(ybufs, geom)
