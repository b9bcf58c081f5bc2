"""Deferred-R replays: the ridge correction and the .R property reproduce
the final k-means round instead of storing R (JAX package
ops/update_r_fused_xla.py:241-371).

Every replay reruns the whole round through `fused_estep` (the O/E
evolution is sequential over blocks) and takes the r of one window of
chunks from its `r_window` epilogue. The round and its replays run the same
kernel on the same tables, so the replayed r is the round's r bitwise. The
per-chunk design products then run in torch on that window; windows are
bounded by a memory budget, one replay per window.
"""

from __future__ import annotations

import torch

from ..config import EngineConfig
from .cuda.fused_estep import fused_estep
from .partition import frame_sum, partition_geometry

# Cap on the elements of one window of r (width * K * CH floats): 1 GiB.
WINDOW_ELEMS = 256 * 1024 * 1024


def window_width(cfg: EngineConfig, budget: int = WINDOW_ELEMS) -> int:
    geom = partition_geometry(cfg)
    return max(1, min(geom.nc_cap, budget // max(geom.CH * cfg.K, 1)))


def windows(cfg: EngineConfig, budget: int = WINDOW_ELEMS):
    """(lo, width) chunk windows covering the real chunks."""
    nc, w = partition_geometry(cfg).nc_cap, window_width(cfg, budget)
    return [(lo, min(w, nc - lo)) for lo in range(0, nc, w)]


def replay_r(tables, ZP3, Y, sigma, theta, Pr_b, O, E, fast_ent: bool,
             lo: int, width: int) -> torch.Tensor:
    """r (width, K, CH) of chunks lo..lo+width-1 in the replayed round;
    `tables` = (slots, removal) of that round."""
    slots, removal = tables
    return fused_estep(slots, removal, ZP3, Y, sigma, theta, Pr_b, O, E,
                       fast_ent, lo, width)[5]


def replay_normal_eq(tables, ZP3, ZO3, Y, sigma, theta, Pr_b, O, E,
                     cfg: EngineConfig, fast_ent: bool,
                     budget: int = WINDOW_ELEMS) -> torch.Tensor:
    """Ridge normal equations from the replayed r: S (B1*(B1+d), K), rows
    b*B1+c for cov[., b, c] and B1*B1 + b*d + x for rhs[., b, x]. The design
    rows a = [mask; Phi] are the leading B1 rows of the slab; ZO3 is
    (nc1, d, CH) chunk-major Z_orig."""
    B1 = cfg.B1
    nc1 = ZP3.shape[0]
    Sbuf = torch.zeros((nc1, B1 * (B1 + cfg.d), cfg.K), dtype=torch.float32,
                       device=ZP3.device)
    for lo, w in windows(cfg, budget):
        r = replay_r(tables, ZP3, Y, sigma, theta, Pr_b, O, E, fast_ent,
                     lo, w)                                      # (w, K, CH)
        a = ZP3[lo: lo + w, :B1, :]
        zo = ZO3[lo: lo + w]
        Fa = (a[:, :, None, :] * a[:, None, :, :]).reshape(w, B1 * B1, -1)
        Sa = torch.einsum("jfc,jkc->jfk", Fa, r)
        Sz = [torch.einsum("jdc,jkc->jdk", a[:, b, None, :] * zo, r)
              for b in range(B1)]
        Sbuf[lo: lo + w] = torch.cat([Sa] + Sz, dim=1)
    return frame_sum(Sbuf, partition_geometry(cfg))


def replay_apply(tables, ZP3, ZO3, W, Y, sigma, theta, Pr_b, O, E,
                 cfg: EngineConfig, fast_ent: bool,
                 budget: int = WINDOW_ELEMS):
    """Apply the ridge correction with the replayed r (harmony.py:559-569):
    returns (Zc3, Zs3) (nc1, d, CH) — the corrected embedding and its
    L2-normalization, zero on the dummy chunk — and Ysum0 (d, K), the next
    cluster loop's initial centroid numerator Z_cos_new r^T."""
    B1, d = cfg.B1, cfg.d
    nc1, _, CH = ZP3.shape
    Zc3 = torch.zeros((nc1, d, CH), dtype=torch.float32, device=ZP3.device)
    Zs3 = torch.zeros_like(Zc3)
    ybuf = torch.zeros((nc1, d, cfg.K), dtype=torch.float32,
                       device=ZP3.device)
    for lo, w in windows(cfg, budget):
        r = replay_r(tables, ZP3, Y, sigma, theta, Pr_b, O, E, fast_ent,
                     lo, w)
        a = ZP3[lo: lo + w, :B1, :]
        corr = a[:, 0, None, :] * torch.einsum("kd,jkc->jdc", W[:, 0, :], r)
        for b in range(1, B1):
            corr = corr + (a[:, b, None, :]
                           * torch.einsum("kd,jkc->jdc", W[:, b, :], r))
        zc = ZO3[lo: lo + w] - corr
        norm = torch.sqrt(torch.sum(zc * zc, dim=1, keepdim=True))
        zs = zc / torch.where(norm > 0.0, norm, torch.ones_like(norm))
        Zc3[lo: lo + w] = zc
        Zs3[lo: lo + w] = zs
        ybuf[lo: lo + w] = torch.einsum("jdc,jkc->jdk", zs, r)
    return Zc3, Zs3, frame_sum(ybuf, partition_geometry(cfg))
