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
from ..parallel.sharding import (one_device, put_window, window_of,
                                 window_rows)
from .cuda.fused_estep import fused_estep
from .partition import frame_sum, partition_geometry
from .update_r_fused import mesh_round

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
             lo: int, width: int) -> torch.Tensor:
    """r (width, K, CH) of chunks lo..lo+width-1 in the replayed round on
    one device; `tables` = (slots, removal) of that round."""
    slots, removal = tables
    return fused_estep(slots, removal, ZP3, Y, sigma, theta, Pr_b, O, E,
                       fast_ent, lo, width)[5]


def round_r_windows(tables, ZP3s, rep, fast_ent: bool, geom, lo: int,
                    width: int) -> list:
    """r of the global chunk window [lo, lo + width) in the replayed round,
    per shard: a (width, K, CH) tensor holding the shard's chunks of the
    window (zero elsewhere), or None for a shard that holds none. tables:
    MeshTables of the round; rep = (Y, sigma, theta, Pr_b, O, E)."""
    if len(ZP3s) == 1:
        return [replay_r((tables.slots[0], tables.removal), ZP3s[0], *rep,
                         fast_ent, lo, width)]
    wins = [(lo - s * geom.nc_cap, width)
            if window_rows(geom, s, lo, width)[2] else None
            for s in range(len(ZP3s))]
    return mesh_round(tables, ZP3s, *rep, fast_ent, geom.J_fix,
                      windows=wins)[5]


def replay_normal_eq(tables, ZP3s, ZO3s, rep, cfg: EngineConfig,
                     fast_ent: bool, budget: int = WINDOW_ELEMS):
    """Ridge normal equations from the replayed r: S (B1*(B1+d), K), rows
    b*B1+c for cov[., b, c] and B1*B1 + b*d + x for rhs[., b, x]. The design
    rows a = [mask; Phi] are the leading B1 rows of the slab; ZO3s are the
    shards' (nc1, d, CH) chunk-major Z_orig."""
    B1 = cfg.B1
    geom = partition_geometry(cfg)
    Sbufs = [torch.zeros((Z.shape[0], B1 * (B1 + cfg.d), cfg.K),
                         dtype=torch.float32, device=Z.device) for Z in ZP3s]
    for lo, w in windows(one_device(cfg), budget):
        rs = round_r_windows(tables, ZP3s, rep, fast_ent, geom, lo, w)
        for s, r in enumerate(rs):
            if r is None:
                continue
            a = window_of(ZP3s[s], s, geom, lo, w)[:, :B1, :]
            zo = window_of(ZO3s[s], s, geom, lo, w)
            Fa = (a[:, :, None, :] * a[:, None, :, :]).reshape(w, B1 * B1, -1)
            Sa = torch.einsum("jfc,jkc->jfk", Fa, r)
            Sz = [torch.einsum("jdc,jkc->jdk", a[:, b, None, :] * zo, r)
                  for b in range(B1)]
            put_window(Sbufs[s], torch.cat([Sa] + Sz, dim=1), s, geom, lo, w)
    return frame_sum(Sbufs, geom)


def replay_apply(tables, ZP3s, ZO3s, W, rep, cfg: EngineConfig,
                 fast_ent: bool, budget: int = WINDOW_ELEMS):
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
        rs = round_r_windows(tables, ZP3s, rep, fast_ent, geom, lo, w)
        for s, r in enumerate(rs):
            if r is None:
                continue
            Ws = W.to(r.device)
            a = window_of(ZP3s[s], s, geom, lo, w)[:, :B1, :]
            corr = a[:, 0, None, :] * torch.einsum("kd,jkc->jdc", Ws[:, 0, :],
                                                   r)
            for b in range(1, B1):
                corr = corr + (a[:, b, None, :]
                               * torch.einsum("kd,jkc->jdc", Ws[:, b, :], r))
            zc = window_of(ZO3s[s], s, geom, lo, w) - corr
            norm = torch.sqrt(torch.sum(zc * zc, dim=1, keepdim=True))
            zs = zc / torch.where(norm > 0.0, norm, torch.ones_like(norm))
            put_window(Zc3s[s], zc, s, geom, lo, w)
            put_window(Zs3s[s], zs, s, geom, lo, w)
            put_window(ybufs[s], torch.einsum("jdc,jkc->jdk", zs, r), s, geom,
                       lo, w)
    return Zc3s, Zs3s, frame_sum(ybufs, geom)
