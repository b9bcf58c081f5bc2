"""The fused chunk-granular E-step in plain PyTorch.

These are the plain versions of the hand-written kernels
(`ops/cuda/fused_estep.py`, `csrc/fused_estep.cu`): the CPU runs them, and
the tests and `chip_smoke.py` hold the kernels against them. They compute
what the JAX package's Pallas `_kernel_nor` / `_kernel` and their XLA twins
`fused_update_nor_xla3` / `fused_update_r_xla3` compute
(ops/pallas/update_r_fused.py:109-221, ops/update_r_fused_xla.py:43-238):

  for each block b, in order:
    O, E -= the block's cached stats (reference harmony.py:491-492)
    wdiv = (E / (O + E))^theta with the 1e-8 clamp chain   (:495-499)
    for each chunk of the block (independent within the block):
      dist = 2 (1 - Y^T z); r = softmax_k(-dist/sigma) * (wdiv Phi),
      column-normalised (clamp 1e-8)
      S = r [mask; Phi; Z]^T -> cache (K, B+1) and ybuf (K, d)
      kbuf = [sum r dist, sum sigma r log r]
    O, E += the block's new stats, in ascending slot order (:506-507)
    (write-R round only) R3[chunk] = r in the storage dtype

All N-scale inputs are chunk-major: ZP3 (n_chunks+1, 1+B+d, CH) holds
[mask; Phi; Z_cos] per chunk, and the last chunk is the all-zero dummy that
unfilled slots point at (its outputs come out exactly zero).
"""

from __future__ import annotations

import torch

from ..config import EngineConfig
from .objective import chunk_objective_partials, chunk_objective_partials_fast
from .partition import partition_geometry

CLAMP = 1e-8


def make_zp3(Z_cos, Phi, mask, cfg: EngineConfig) -> torch.Tensor:
    """Chunk-major feature slab (nc1, 1+B+d, CH) = [mask; Phi; Z] per chunk.
    Row 0 is the real-cell mask: the replay's ridge products use it as the
    intercept row, so padded cells stay exactly zero."""
    geom = partition_geometry(cfg)
    nc1, CH = geom.nc_cap + 1, geom.CH
    ZP = torch.cat([mask[None, :], Phi, Z_cos], dim=0)
    return ZP.reshape(1 + cfg.B + cfg.d, nc1, CH).permute(1, 0, 2).contiguous()


def chunk_stats(r3, p3) -> torch.Tensor:
    """Per-chunk cache (J, K, B+1) from soft assignments r3 (J, K, CH) and
    one-hot design p3 (J, B, CH): [:, :, 0] = chunk sums of r, [:, :, 1:] =
    chunk r Phi^T."""
    parts = [torch.sum(r3, dim=2)]
    parts += [torch.sum(r3 * p3[:, b, None, :], dim=2)
              for b in range(p3.shape[1])]
    return torch.stack(parts, dim=2)


def diversity_weights(O, E, theta):
    """(logratio, wdiv) of the block-removed O/E: logratio = log clip(E /
    max(O+E, 1e-8), 1e-8, 1) and wdiv = exp(theta * logratio)."""
    oe = torch.clamp_min(O + E, CLAMP)
    logratio = torch.log(torch.clamp(E / oe, CLAMP, 1.0))
    return logratio, torch.exp(theta[None, :] * logratio)


def block_core(O, E, rem_b, slots_b, ZP3, Y, sigma, theta, Pr_b):
    """One block's removal, reweighting and soft assignments. Returns
    (O_removed, E_removed, r, g, dist, logratio, logdd) with g the gathered
    (J, 1+B+d, CH) slab and logdd the per-cell log of the two softmax
    denominators."""
    E = E - rem_b[:, 0:1] * Pr_b[None, :]
    O = O - rem_b[:, 1:]
    logratio, wdiv = diversity_weights(O, E, theta)

    B1 = 1 + theta.shape[0]
    g = ZP3[slots_b]                                            # (J, 1+B+d, CH)
    pb = g[:, 1:B1, :]
    zb = g[:, B1:, :]
    dist = 2.0 * (1.0 - torch.einsum("dk,jdc->jkc", Y, zb))    # (J, K, CH)
    s = torch.exp(-dist / sigma[None, :, None])
    den = torch.sum(s, dim=1, keepdim=True)
    r = (s / den) * torch.einsum("kb,jbc->jkc", wdiv, pb)       # dummy -> 0
    den_r = torch.clamp_min(torch.sum(r, dim=1, keepdim=True), CLAMP)
    r = r / den_r
    logdd = (torch.log(den) + torch.log(den_r))[:, 0, :]        # (J, CH)
    return O, E, r, g, dist, logratio, logdd


def block_stats(r, g, B1: int):
    """All linear statistics of r in one batched contraction against the
    slab: (stats (J, K, B+1), yk (J, K, d))."""
    S = torch.einsum("jkc,jxc->jkx", r, g)
    return S[:, :, :B1], S[:, :, B1:]


def block_readd(O, E, stats, Pr_b):
    """Re-add the block (harmony.py:506-507): its slots' stats summed one by
    one in ascending slot order (== ascending within-block rank)."""
    acc = torch.zeros_like(stats[0])
    for j in range(stats.shape[0]):
        acc = acc + stats[j]
    return O + acc[:, 1:], E + acc[:, 0:1] * Pr_b[None, :]


def chunk_partials(r, dist, stats, sigma, theta, logratio, logdd,
                   fast_ent: bool):
    """Per-chunk (kerr, ent): the log-free form under fast_ent (one
    covariate, `fast_objective`), the elementwise form otherwise."""
    if fast_ent:
        return chunk_objective_partials_fast(
            r, dist, stats[:, :, 1:], sigma, theta, logratio, logdd)
    return chunk_objective_partials(r, dist, sigma, k_axis=1, chunk_axis=0)


def _round(slots, removal, ZP3, Y, sigma, theta, Pr_b, O, E,
           fast_ent: bool, store):
    """One round over all blocks; store(slots_b, r) gets each block's r.
    Returns (O, E, cache, ybuf, kbuf)."""
    nc1 = ZP3.shape[0]
    K, d, B1 = Y.shape[1], Y.shape[0], theta.shape[0] + 1
    f32 = dict(dtype=torch.float32, device=ZP3.device)
    cache = torch.zeros((nc1, K, B1), **f32)
    ybuf = torch.zeros((nc1, K, d), **f32)
    kbuf = torch.zeros((nc1, 2), **f32)
    slots = slots.long()
    for b in range(slots.shape[0]):
        sl = slots[b]
        O, E, r, g, dist, logratio, logdd = block_core(
            O, E, removal[b], sl, ZP3, Y, sigma, theta, Pr_b)
        stats, yk = block_stats(r, g, B1)
        O, E = block_readd(O, E, stats, Pr_b)
        kerr, ent = chunk_partials(r, dist, stats, sigma, theta, logratio,
                                   logdd, fast_ent)
        cache[sl] = stats
        ybuf[sl] = yk
        kbuf[sl] = torch.stack([kerr, ent], dim=1)
        store(sl, r)
    return O, E, cache, ybuf, kbuf


def fused_update_nor(slots, removal, ZP3, Y, sigma, theta, Pr_b, O, E,
                     fast_ent: bool, lo: int = 0, width: int = 0):
    """One deferred-R E-step round over all blocks — the plain version of
    the kernel K1, with the kernel's signature.

    slots (nb, J) chunk ids per block (dummy = n_chunks); removal
    (nb, K, B+1); ZP3 (nc1, 1+B+d, CH); Y (d, K); sigma (K,); theta, Pr_b
    (B,); O, E (K, B). With width > 0 the r of the chunks lo..lo+width-1
    is also returned (the `r_window` epilogue).

    Returns (O, E, cache (nc1, K, B+1), ybuf (nc1, K, d), kbuf (nc1, 2),
    Rw (width, K, CH) or None)."""
    K, CH = Y.shape[1], ZP3.shape[2]
    Rw = (torch.zeros((width + 1, K, CH), dtype=torch.float32,
                      device=ZP3.device) if width > 0 else None)

    def store(sl, r):
        if Rw is not None:
            w = sl - lo
            w = torch.where((w >= 0) & (w < width), w, torch.full_like(w, width))
            Rw[w] = r

    out = _round(slots, removal, ZP3, Y, sigma, theta, Pr_b, O, E, fast_ent,
                 store)
    return (*out, Rw[:width] if Rw is not None else None)


def fused_update_r(slots, removal, ZP3, R3, Y, sigma, theta, Pr_b, O, E,
                   fast_ent: bool):
    """One stored-R E-step round — the plain version of the kernel K2 (the
    Pallas `_kernel`, JAX package ops/pallas/update_r_fused.py:109-114, and
    its XLA twin fused_update_r_xla3): fused_update_nor plus
    R3[slots_b] = r.to(R3.dtype) for every block, written in place into the
    caller's chunk-major R3 (nc1, K, CH), fp32 or bf16. Every statistic
    uses the fp32 r. Every block's slots end with the dummy chunk, so the
    dummy chunk of R3 is written with zeros.

    Returns (R3, O, E, cache, ybuf, kbuf)."""
    def store(sl, r):
        R3[sl] = r.to(R3.dtype)

    out = _round(slots, removal, ZP3, Y, sigma, theta, Pr_b, O, E, fast_ent,
                 store)
    return (R3, *out)
