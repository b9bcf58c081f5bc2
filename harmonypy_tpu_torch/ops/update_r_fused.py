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


def fused_update_block(b: int, slots, removal, ZP3, Y, sigma, theta, Pr_b,
                       O, E, fast_ent: bool, out, Rw=None, lo: int = 0,
                       R3=None):
    """Block b of a round alone — the plain version of the per-block entry
    (`ops.cuda.fused_estep.fused_estep_block`), with its signature: from O,
    E at the block's start, write the rows of the block's slots into out =
    (cache, ybuf, kbuf), r of chunks lo..lo+width-1 into Rw (width, K, CH)
    or r of every slotted chunk into R3 in its dtype; return (O, E) with
    the block's cached stats removed."""
    cache, ybuf, kbuf = out
    B1 = theta.shape[0] + 1
    sl = slots[b].long()
    O, E, r, g, dist, logratio, logdd = block_core(
        O, E, removal[b], sl, ZP3, Y, sigma, theta, Pr_b)
    stats, yk = block_stats(r, g, B1)
    kerr, ent = chunk_partials(r, dist, stats, sigma, theta, logratio,
                               logdd, fast_ent)
    cache[sl] = stats
    ybuf[sl] = yk
    kbuf[sl] = torch.stack([kerr, ent], dim=1)
    if Rw is not None:
        w = sl - lo
        keep = (w >= 0) & (w < Rw.shape[0])
        Rw[w[keep]] = r[keep]
    if R3 is not None:
        R3[sl] = r.to(R3.dtype)
    return O, E


def _round(slots, removal, ZP3, Y, sigma, theta, Pr_b, O, E,
           fast_ent: bool, Rw=None, lo: int = 0, R3=None):
    """One round over all blocks: each block alone, then its re-add from
    its slots' cache rows. Returns (O, E, cache, ybuf, kbuf)."""
    nc1 = ZP3.shape[0]
    K, d, B1 = Y.shape[1], Y.shape[0], theta.shape[0] + 1
    f32 = dict(dtype=torch.float32, device=ZP3.device)
    out = (torch.zeros((nc1, K, B1), **f32), torch.zeros((nc1, K, d), **f32),
           torch.zeros((nc1, 2), **f32))
    for b in range(slots.shape[0]):
        O, E = fused_update_block(b, slots, removal, ZP3, Y, sigma, theta,
                                  Pr_b, O, E, fast_ent, out, Rw, lo, R3)
        O, E = block_readd(O, E, out[0][slots[b].long()], Pr_b)
    return (O, E, *out)


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
    Rw = (torch.zeros((width, K, CH), dtype=torch.float32,
                      device=ZP3.device) if width > 0 else None)
    out = _round(slots, removal, ZP3, Y, sigma, theta, Pr_b, O, E, fast_ent,
                 Rw, lo)
    return (*out, Rw)


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
    out = _round(slots, removal, ZP3, Y, sigma, theta, Pr_b, O, E, fast_ent,
                 R3=R3)
    return (R3, *out)


def mesh_round(tables, ZP3s, Y, sigma, theta, Pr_b, O, E, fast_ent: bool,
               J_fix: int, windows=None, R3s=None):
    """One E-step round on a mesh of several shards (the JAX package's
    fused_update_nor_xla3 / fused_update_r_xla3 under shard_map,
    ops/update_r_fused_xla.py:131-238): for each block, every shard runs
    the block on its own chunks through the per-block entry (the kernel on
    a CUDA shard, `fused_update_block` on a CPU shard), then the block's
    stats are re-added on the lead device (the device of O).

    The re-add copies each shard's rows of the block into the (J_fix, K,
    B+1) rank frame (row = the chunk's within-block rank, ascending global
    chunk id; ranks no shard holds stay zero) and sums the frame one row
    after the other from zero, then forms O + sum[:, 1:] and E + sum[:, 0]
    Pr_b, each product and sum rounded on its own: the order and roundings
    of the one-launch round's in-kernel re-add, which sums a block's slots
    in ascending slot order (= ascending global id, the zero dummy slots
    last). The per-chunk rows are the one-device round's bitwise: the
    kernel splits each chunk into units by the global geometry
    (kernel_geometry's J_glob), and a CPU shard pads its slot table to the
    one-device width J_fix + 1 with its dummy chunk, so its batched
    products have the one-device shapes. The result equals the one-device
    round bit for bit.

    tables: ops.partition.MeshTables. ZP3s: each shard's slab. windows:
    per shard None or (lo, width), the chunks whose r to return (lo may be
    negative). R3s: per shard the stored R to rewrite (K2).

    Returns (O, E, caches, ybufs, kbufs, Rws) with the per-chunk buffers
    and r windows per shard (R3s are written in place)."""
    from .cuda.fused_estep import fused_estep_block
    nb = tables.removal.shape[0]
    K, d, B1 = Y.shape[1], Y.shape[0], theta.shape[0] + 1
    lead = O.device
    shards = []
    for s, ZP3 in enumerate(ZP3s):
        dev, nc1, CH = ZP3.device, ZP3.shape[0], ZP3.shape[2]
        slots, granks = tables.slots[s], tables.granks[s]
        if dev.type == "cpu" and slots.shape[1] < J_fix + 1:
            pad = J_fix + 1 - slots.shape[1]
            slots = torch.cat([slots, slots.new_full((nb, pad), nc1 - 1)], 1)
            granks = torch.cat([granks, granks.new_full((nb, pad), J_fix)],
                               1)
        f32 = dict(dtype=torch.float32, device=dev)
        out = (torch.zeros((nc1, K, B1), **f32),
               torch.zeros((nc1, K, d), **f32), torch.zeros((nc1, 2), **f32))
        win = None if windows is None else windows[s]
        Rw = (None if win is None
              else torch.zeros((win[1], K, CH), **f32))
        consts = [t.to(dev) for t in (tables.removal, Y, sigma, theta, Pr_b)]
        shards.append(dict(
            ZP3=ZP3, slots=slots.contiguous(), gidx=slots.long().to(dev),
            granks=granks.to(lead), out=out, Rw=Rw,
            lo=0 if win is None else win[0], consts=consts,
            R3=None if R3s is None else R3s[s]))
    for b in range(nb):
        frame = torch.zeros((J_fix + 1, K, B1), dtype=torch.float32,
                            device=lead)     # row J_fix: unfilled slots
        Or = Er = None
        for sh in shards:
            removal, Ys, sig, th, prb = sh["consts"]
            dev = sh["ZP3"].device
            Ob, Eb = fused_estep_block(
                b, sh["slots"], removal, sh["ZP3"], Ys, sig, th, prb,
                O.to(dev), E.to(dev), fast_ent, sh["out"], J_fix + 1,
                Rw=sh["Rw"], lo=sh["lo"], R3=sh["R3"])
            if Or is None:
                Or, Er = Ob.to(lead), Eb.to(lead)
            frame[sh["granks"][b]] = sh["out"][0][sh["gidx"][b]].to(lead)
        acc = torch.zeros((K, B1), dtype=torch.float32, device=lead)
        for r in range(J_fix):
            acc = acc + frame[r]
        O = Or + acc[:, 1:]
        E = Er + acc[:, 0:1] * Pr_b[None, :]
    return (O, E, [sh["out"][0] for sh in shards],
            [sh["out"][1] for sh in shards], [sh["out"][2] for sh in shards],
            [sh["Rw"] for sh in shards])
