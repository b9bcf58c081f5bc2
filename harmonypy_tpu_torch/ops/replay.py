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

A design of one covariate (cfg.n_covariates == 1: every real cell in one
batch level) takes the one-hot forms (`onehot_design`): Phi_moe diag(r)
Phi_moe^T is then the intercept row and column plus a diagonal, all of
them the per-level sums of r, and Phi_moe diag(r) Z^T the per-level sums
of r z^T. `window_design_sums` forms each chunk's (B1, 1 + d, K) sums as
one product a [1; z] r^T; `dense_normal_eq` lays their frame sum out as
the dense normal equations solve_w takes; `window_apply_onehot` subtracts
sum_k r_kn (W[k, 0, :] + W[k, level_n, :]), W's rows picked per cell.
Neither has a B1-long loop of products nor a (w, B1^2, CH) temporary.
Multi-covariate designs keep the dense forms (`window_normal_eq`,
`window_apply`).
"""

from __future__ import annotations

import torch

from ..config import EngineConfig
from ..parallel.mesh import local_shards
from ..parallel.sharding import (one_device, put_window, window_of,
                                 window_rows)
from ..utils.profiling import span
from .cuda.fused_estep import fused_estep, fused_estep_mesh
from .normalize import l2_normalize_cells
from .partition import frame_sum, partition_geometry
from .products import einsum, operand

# Cap on the elements of one window of r (width * K * CH floats): 1 GiB.
WINDOW_ELEMS = 256 * 1024 * 1024
# The init pass (engine._init_pass) works in quarter-size windows: its
# temporaries, about five windows, then stay near one K x N array.
INIT_ELEMS = WINDOW_ELEMS // 4


def onehot_design(cfg: EngineConfig) -> bool:
    """Whether the ridge takes the one-hot forms: one covariate, so every
    real cell has exactly one batch level."""
    return cfg.n_covariates == 1


def normal_eq_rows(cfg: EngineConfig) -> int:
    """Rows of the per-chunk normal equations: B1 (1 + d) in the one-hot
    form (window_design_sums), B1 (B1 + d) in the dense one."""
    return cfg.B1 * ((1 if onehot_design(cfg) else cfg.B1) + cfg.d)


def dense_normal_eq(S, cfg: EngineConfig) -> torch.Tensor:
    """The dense normal equations (B1 (B1 + d), K) that solve_w takes,
    from the one-hot form's frame sum S (B1 (1 + d), K): cov[., b, c] is
    s_b on the diagonal and s_c, s_b in the intercept's row and column (s
    the level sums of r, s_0 every real cell's), 0 elsewhere; rhs the
    level rows as they are."""
    B1, d, K = cfg.B1, cfg.d, cfg.K
    S3 = S.reshape(B1, 1 + d, K)
    s = S3[:, 0]                                            # (B1, K)
    cov = torch.diag_embed(s.T).permute(1, 2, 0).clone()    # (B1, B1, K)
    cov[0, 1:] = s[1:]
    cov[1:, 0] = s[1:]
    return torch.cat([cov.reshape(B1 * B1, K),
                      S3[:, 1:].reshape(B1 * d, K)])


def window_width(cfg: EngineConfig, budget: int = WINDOW_ELEMS) -> int:
    geom = partition_geometry(cfg)
    return max(1, min(geom.nc_cap, budget // max(geom.CH * cfg.K, 1)))


def windows(cfg: EngineConfig, budget: int = WINDOW_ELEMS):
    """(lo, width) chunk windows covering the real chunks."""
    nc, w = partition_geometry(cfg).nc_cap, window_width(cfg, budget)
    return [(lo, min(w, nc - lo)) for lo in range(0, nc, w)]


def replay_r(tables, ZP3, Y, sigma, theta, Pr_b, O, E, fast_ent: bool,
             lo: int, width: int, precision: str = "float32",
             codes=None) -> torch.Tensor:
    """r (width, K, CH) of chunks lo..lo+width-1 in the replayed round on
    one device; `tables` = (slots, removal) of that round; precision: the
    round's (cfg.matmul_precision); codes: the round's (round_codes), so
    that the replay runs the round's plan."""
    slots, removal = tables
    return fused_estep(slots, removal, ZP3, Y, sigma, theta, Pr_b, O, E,
                       fast_ent, lo, width, precision=precision,
                       codes=codes)[5]


def round_r_windows(tables, ZP3s, rep, fast_ent: bool, geom, lo: int,
                    width: int, precision: str = "float32",
                    codes=None) -> list:
    """r of the global chunk window [lo, lo + width) in the replayed round,
    per shard of this process: a (width, K, CH) tensor holding the shard's
    chunks of the window (zero elsewhere), or None for a shard that holds
    none. tables: MeshTables of the round; rep = (Y, sigma, theta, Pr_b, O,
    E); precision: the round's; codes: the one-device round's codes
    (round_codes), or None."""
    if geom.n_devices == 1:
        return [replay_r((tables.slots[0], tables.removal), ZP3s[0], *rep,
                         fast_ent, lo, width, precision, codes)]
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


def onehot_step(w: int, d: int, rows: int) -> int:
    """Chunks a step of the one-hot forms takes at once, each chunk's
    temporary being `rows` values a cell: at most as many values as the
    window's zo (w, d, CH), so that no step holds more than the dense
    forms' own (w, d, CH) products did."""
    return max(1, (w * d) // rows)


def window_levels(a) -> torch.Tensor:
    """(w, CH) int64: the design row of each cell of a window of one-hot
    design rows a (w, B1, CH), 1 + its batch, and 0 (the intercept's) for
    a padding cell (mask 0)."""
    return torch.where(a[:, 0] > 0, torch.argmax(a[:, 1:], dim=1) + 1, 0)


def round_codes(Phi, mask, cfg: EngineConfig) -> torch.Tensor:
    """(nc1, CH) int32, chunk-major as the slab (ops/update_r_fused.
    make_zp3): each cell's batch level of a one-covariate design (Phi (B,
    N_local) one-hot, mask (N_local,)), -1 for a padding cell: the slab's
    window_levels less one, taken from the design the slab is built from.
    The codes plan of the round's kernel reads these instead of the B
    design rows."""
    geom = partition_geometry(cfg)
    lev = torch.where(mask > 0, torch.argmax(Phi, dim=0), -1)
    return lev.to(torch.int32).reshape(geom.nc_cap + 1, geom.CH).contiguous()


def window_design_sums(a, zo, r, one: bool, out=None) -> torch.Tensor:
    """The one-hot form of window_normal_eq: per chunk (w, B1 * (1 + d),
    K), rows b * (1 + d) hold sum a_b r and rows b * (1 + d) + 1 + x
    sum a_b z_x r (b = 0: the mask, every real cell). A one-hot design
    needs no other sums: cov[., b, c] is sum a_b r for b == c or one of
    them 0, else 0 (dense_normal_eq). One product a [1; z] r^T per chunk,
    over steps of chunks whose design rows a [1; z] hold at most as many
    values as the window's zo (onehot_step: fixed by the window's shape,
    so every mesh sums each chunk as one device does). one: as one bf16
    pass (a is 0 or 1: a z is z's operand exactly). out: the (w, B1 * (1
    + d), K) rows to write (else new ones)."""
    w, B1, CH = a.shape
    d, K = zo.shape[1], r.shape[1]
    with span("harmony::design_sums"):
        if out is None:
            out = r.new_empty((w, B1 * (1 + d), K), dtype=torch.float32)
        step = onehot_step(w, d, B1 * (1 + d))
        for j0 in range(0, w, step):
            j1 = min(w, j0 + step)
            x = operand(torch.cat([torch.ones_like(zo[j0:j1, :1]),
                                   zo[j0:j1]], dim=1), one)
            F = (operand(a[j0:j1], one)[:, :, None] * x[:, None]).reshape(
                j1 - j0, B1 * (1 + d), CH)
            out[j0:j1] = einsum("jfc,jkc->jfk", F, r[j0:j1], one)
    return out


def window_apply_onehot(a, zo, r, W, one: bool) -> torch.Tensor:
    """The one-hot form of window_apply: zo - sum_k r_kn (W[k, 0, :] +
    W[k, b_n, :]) for each real cell, b_n its design row (window_levels;
    Harmony zeroes W's intercept row), zo on padding cells. With no more
    design rows than clusters, each chunk's U = W^T r for every row (B1 d,
    CH), then each cell's d rows of its level; else each cell's (K, d) of W
    gathered and applied to its r. Both over steps of chunks whose U or
    gathered W hold at most as many values as the window's zo
    (onehot_step). one: the product as one bf16 pass."""
    w, B1, CH = a.shape
    K, _, d = W.shape
    with span("harmony::design_sums"):
        lev = window_levels(a)
        # Row 0 (padding) zero, row b the intercept's and level b's.
        Wc = torch.cat([torch.zeros_like(W[:, :1]), W[:, 1:] + W[:, :1]],
                       dim=1)                                # (K, B1, d)
        by_row = B1 <= K
        if by_row:
            Wc = Wc.reshape(K, B1 * d)
        else:
            Wc = operand(Wc.permute(1, 0, 2).reshape(B1, K * d), one)
        step = onehot_step(w, d, (B1 if by_row else K) * d)
        out = torch.empty_like(zo)
        for j0 in range(0, w, step):
            j1 = min(w, j0 + step)
            n = j1 - j0
            if by_row:
                U = einsum("kf,jkc->jfc", Wc, r[j0:j1], one)
                corr = U.view(n, B1, d, CH).gather(1, lev[j0:j1, None, None]
                                                   .expand(n, 1, d, CH))[:, 0]
            else:
                G = torch.index_select(Wc, 0, lev[j0:j1].reshape(-1))
                corr = einsum("jkc,jckd->jdc", r[j0:j1],
                              G.view(n, CH, K, d), one)
            out[j0:j1] = zo[j0:j1] - corr
    return out


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
                     one: bool, codes=None):
    """Ridge normal equations from the replayed r: S (B1*(B1+d), K), rows
    b*B1+c for cov[., b, c] and B1*B1 + b*d + x for rhs[., b, x], from
    per-chunk rows of the dense or, for a one-hot design, the one-hot form
    (normal_eq_rows). The design rows a = [mask; Phi] are the leading B1
    rows of the slab; ZO3s are the shards' (nc1, d, CH) chunk-major
    Z_orig; codes: the round's (round_r_windows)."""
    B1, onehot = cfg.B1, onehot_design(cfg)
    geom = partition_geometry(cfg)
    Sbufs = [torch.zeros((Z.shape[0], normal_eq_rows(cfg), cfg.K),
                         dtype=torch.float32, device=Z.device) for Z in ZP3s]
    for lo, w in windows(one_device(cfg), budget):
        rs = round_r_windows(tables, ZP3s, rep, fast_ent, geom, lo, w,
                             cfg.matmul_precision, codes)
        for i, (s, r) in enumerate(zip(local_shards(cfg.n_devices), rs)):
            if r is None:
                continue
            a = window_of(ZP3s[i], s, geom, lo, w)[:, :B1, :]
            zo = window_of(ZO3s[i], s, geom, lo, w)
            if not onehot:
                rows = window_normal_eq(a, zo, r, one)
            else:
                # On one device the sums go straight into Sbufs' window.
                rows = window_design_sums(
                    a, zo, r, one, out=window_of(Sbufs[i], s, geom, lo, w))
                if geom.n_devices == 1:
                    continue
            put_window(Sbufs[i], rows, s, geom, lo, w)
    S = frame_sum(Sbufs, geom)
    return dense_normal_eq(S, cfg) if onehot else S


def replay_apply(tables, ZP3s, ZO3s, W, rep, cfg: EngineConfig,
                 fast_ent: bool, budget: int = WINDOW_ELEMS, *,
                 one: bool, codes=None):
    """Apply the ridge correction with the replayed r (harmony.py:559-569):
    returns per shard (Zc3, Zs3) (nc1, d, CH) — the corrected embedding and
    its L2-normalization, zero on the dummy chunk — and Ysum0 (d, K), the
    next cluster loop's initial centroid numerator Z_cos_new r^T. codes:
    the round's (round_r_windows)."""
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
                             cfg.matmul_precision, codes)
        for i, (s, r) in enumerate(zip(local_shards(cfg.n_devices), rs)):
            if r is None:
                continue
            r = operand(r, one)
            zc = (window_apply_onehot if onehot_design(cfg) else
                  window_apply)(window_of(ZP3s[i], s, geom, lo, w)[:, :B1, :],
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
