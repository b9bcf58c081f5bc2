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

`one_pass=True` is the plain version of the kernels' one-pass variant
(matmul_precision="default" on a card): each operand of the three
products (Y^T and z for dist, wdiv and Phi for the weights, r and [mask;
Phi; Z] for S) rounded to bf16 to nearest even (`round_bf16`), the
products taken in fp32. Everything else stays fp32. The CPU path of a fit
never selects it.
"""

from __future__ import annotations

import torch

from ..config import EngineConfig
from ..parallel.mesh import all_gather_rows, spans_processes
from .objective import chunk_objective_partials, chunk_objective_partials_fast
from .partition import partition_geometry
from .products import plain_operand, round_bf16  # noqa: F401 (re-export)

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


def block_core(O, E, rem_b, slots_b, ZP3, Y, sigma, theta, Pr_b,
               one_pass: bool = False):
    """One block's removal, reweighting and soft assignments. Returns
    (O_removed, E_removed, r, g, dist, logratio, logdd) with g the gathered
    (J, 1+B+d, CH) slab and logdd the per-cell log of the two softmax
    denominators. one_pass: the products' operands rounded to bf16."""
    E = E - rem_b[:, 0:1] * Pr_b[None, :]
    O = O - rem_b[:, 1:]
    logratio, wdiv = diversity_weights(O, E, theta)

    def op(x):
        return plain_operand(x, one_pass)

    B1 = 1 + theta.shape[0]
    g = ZP3[slots_b]                                            # (J, 1+B+d, CH)
    pb = g[:, 1:B1, :]
    zb = g[:, B1:, :]
    J = zb.shape[0]
    dist = 2.0 * (1.0 - torch.bmm(op(Y.T).expand(J, -1, -1),
                                  op(zb)))                      # (J, K, CH)
    s = torch.exp(-dist / sigma[None, :, None])
    den = torch.sum(s, dim=1, keepdim=True)
    r = (s / den) * torch.bmm(op(wdiv).expand(J, -1, -1), pb)  # dummy -> 0
    den_r = torch.clamp_min(torch.sum(r, dim=1, keepdim=True), CLAMP)
    r = r / den_r
    logdd = (torch.log(den) + torch.log(den_r))[:, 0, :]        # (J, CH)
    return O, E, r, g, dist, logratio, logdd


def block_stats(r, g, B1: int, one_pass: bool = False):
    """All linear statistics of r in one batched contraction against the
    slab: (stats (J, K, B+1), yk (J, K, d)); one_pass: both operands
    rounded to bf16 (r only here: every other use of r takes it fp32)."""
    S = torch.einsum("jkc,jxc->jkx", plain_operand(r, one_pass),
                     plain_operand(g, one_pass))
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
                       R3=None, one_pass: bool = False):
    """Block b of a round alone — the plain version of the per-block entry
    (`ops.cuda.fused_estep._BlockLaunch`), with its arguments: from O,
    E at the block's start, write the rows of the block's slots into out =
    (cache, ybuf, kbuf), r of chunks lo..lo+width-1 into Rw (width, K, CH)
    or r of every slotted chunk into R3 in its dtype; return (O, E) with
    the block's cached stats removed. one_pass: the one-pass variant's."""
    cache, ybuf, kbuf = out
    B1 = theta.shape[0] + 1
    sl = slots[b].long()
    O, E, r, g, dist, logratio, logdd = block_core(
        O, E, removal[b], sl, ZP3, Y, sigma, theta, Pr_b, one_pass)
    stats, yk = block_stats(r, g, B1, one_pass)
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
           fast_ent: bool, Rw=None, lo: int = 0, R3=None,
           one_pass: bool = False):
    """One round over all blocks: each block alone, then its re-add from
    its slots' cache rows. Returns (O, E, cache, ybuf, kbuf)."""
    nc1 = ZP3.shape[0]
    K, d, B1 = Y.shape[1], Y.shape[0], theta.shape[0] + 1
    f32 = dict(dtype=torch.float32, device=ZP3.device)
    out = (torch.zeros((nc1, K, B1), **f32), torch.zeros((nc1, K, d), **f32),
           torch.zeros((nc1, 2), **f32))
    for b in range(slots.shape[0]):
        O, E = fused_update_block(b, slots, removal, ZP3, Y, sigma, theta,
                                  Pr_b, O, E, fast_ent, out, Rw, lo, R3,
                                  one_pass)
        O, E = block_readd(O, E, out[0][slots[b].long()], Pr_b)
    return (O, E, *out)


def fused_update_nor(slots, removal, ZP3, Y, sigma, theta, Pr_b, O, E,
                     fast_ent: bool, lo: int = 0, width: int = 0,
                     one_pass: bool = False):
    """One deferred-R E-step round over all blocks — the plain version of
    the kernel K1, with the kernel's signature.

    slots (nb, J) chunk ids per block (dummy = n_chunks); removal
    (nb, K, B+1); ZP3 (nc1, 1+B+d, CH); Y (d, K); sigma (K,); theta, Pr_b
    (B,); O, E (K, B). With width > 0 the r of the chunks lo..lo+width-1
    is also returned (the `r_window` epilogue). one_pass: the one-pass
    variant's plain version.

    Returns (O, E, cache (nc1, K, B+1), ybuf (nc1, K, d), kbuf (nc1, 2),
    Rw (width, K, CH) or None)."""
    K, CH = Y.shape[1], ZP3.shape[2]
    Rw = (torch.zeros((width, K, CH), dtype=torch.float32,
                      device=ZP3.device) if width > 0 else None)
    out = _round(slots, removal, ZP3, Y, sigma, theta, Pr_b, O, E, fast_ent,
                 Rw, lo, one_pass=one_pass)
    return (*out, Rw)


def fused_update_r(slots, removal, ZP3, R3, Y, sigma, theta, Pr_b, O, E,
                   fast_ent: bool, one_pass: bool = False):
    """One stored-R E-step round — the plain version of the kernel K2 (the
    Pallas `_kernel`, JAX package ops/pallas/update_r_fused.py:109-114, and
    its XLA twin fused_update_r_xla3): fused_update_nor plus
    R3[slots_b] = r.to(R3.dtype) for every block, written in place into the
    caller's chunk-major R3 (nc1, K, CH), fp32 or bf16. Every statistic
    uses the fp32 r. Every block's slots end with the dummy chunk, so the
    dummy chunk of R3 is written with zeros. one_pass: as fused_update_nor's.

    Returns (R3, O, E, cache, ybuf, kbuf)."""
    out = _round(slots, removal, ZP3, Y, sigma, theta, Pr_b, O, E, fast_ent,
                 R3=R3, one_pass=one_pass)
    return (R3, *out)


def frame_readd(rows, granks, Or, Er, Pr_b, J_fix: int):
    """Re-add one block across the shards of a mesh (the JAX package's
    `_block_readd`, ops/update_r_fused_xla.py:104-114) — the plain version
    of the re-add kernel (csrc/frame_readd.cuh, `ops.cuda.fused_estep.
    _Readd`). rows[s] (J_s, K, B+1) are shard s's block stats in
    slot order and granks[s] (J_s,) their within-block ranks (J_fix: no
    rank). The rows go to the (J_fix, K, B+1) rank frame on the device of
    Or (ranks no shard holds stay zero), the frame is summed one row after
    the other from zero, and O = Or + sum[:, 1:], E = Er + sum[:, 0] Pr_b,
    each product and sum rounded on its own: the order and roundings of the
    one-launch round's in-kernel re-add, which sums a block's slots in
    ascending slot order (= ascending rank, the zero dummy slots last).
    Or, Er: the block-removed O, E."""
    lead = Or.device
    frame = torch.zeros((J_fix + 1,) + tuple(rows[0].shape[1:]),
                        dtype=torch.float32, device=lead)   # row J_fix: none
    for r, g in zip(rows, granks):
        frame[g.to(lead)] = r.to(lead)
    acc = torch.zeros_like(frame[0])
    for i in range(J_fix):
        acc = acc + frame[i]
    return Or + acc[:, 1:], Er + acc[:, 0:1] * Pr_b[None, :]


def fused_update_block_folded(b: int, slots, removal, ZP3, Y, sigma, theta,
                              Pr_b, O, E, fast_ent: bool, out, prev=None,
                              Rw=None, lo: int = 0, R3=None,
                              one_pass: bool = False):
    """Block b of a mesh round started from block b - 1's re-add — the
    plain version of the per-block launch with the re-add folded into its
    prologue (`ops.cuda.fused_estep._BlockLaunch.launch(b, readd_prev=
    True)`): prev = (rows, granks, J_fix), every shard's rows of block
    b - 1 and their ranks, with O, E block b - 1's block-removed O', E';
    the block starts from `frame_readd(rows, granks, O, E, Pr_b, J_fix)`.
    Without prev it starts from O, E. Then `fused_update_block`, whose
    arguments and results it has."""
    if prev is not None:
        rows, granks, J_fix = prev
        O, E = frame_readd(rows, granks, O, E, Pr_b, J_fix)
    return fused_update_block(b, slots, removal, ZP3, Y, sigma, theta, Pr_b,
                              O, E, fast_ent, out, Rw, lo, R3, one_pass)


def mesh_round(tables, ZP3s, Y, sigma, theta, Pr_b, O, E, fast_ent: bool,
               J_fix: int, windows=None, R3s=None, one_pass: bool = False):
    """One E-step round on a mesh of several shards (the JAX package's
    fused_update_nor_xla3 / fused_update_r_xla3 under shard_map,
    ops/update_r_fused_xla.py:131-238) — the plain version of the kernels'
    mesh round (`ops.cuda.fused_estep.fused_estep_mesh`, which runs it on
    CPU shards): for each block, every shard runs the block on its own
    chunks (`fused_update_block`), then the block is re-added on the lead
    device (the device of O) from every shard's rows of it (`frame_readd`).
    The kernels fold that re-add into the next block's launch on every
    shard (`fused_update_block_folded`), which forms the same bits; only
    the last block's is a launch of its own. Across processes
    (parallel.mesh.spans_processes) each block's rows are all-gathered, and
    every rank re-adds the block from the gathered rows, in rank order from
    zero: the same bits on every rank.

    The per-chunk rows are the one-device round's bitwise: a CPU shard pads
    its slot table to the one-device width J_fix + 1 with its dummy chunk,
    so its batched products have the one-device shapes; the re-add takes
    the one-device order. The result equals the one-device round bit for
    bit.

    tables: ops.partition.MeshTables. ZP3s: this process's shards' slabs.
    windows: per shard None or (lo, width), the chunks whose r to return
    (lo may be negative). R3s: per shard the stored R to rewrite (K2).
    one_pass: the one-pass variant's plain version.

    Returns (O, E, caches, ybufs, kbufs, Rws) with the per-chunk buffers
    and r windows per shard (R3s are written in place)."""
    nb = tables.removal.shape[0]
    K, d, B1 = Y.shape[1], Y.shape[0], theta.shape[0] + 1
    lead = O.device
    multi = spans_processes(len(tables.granks))
    pad = 0
    if ZP3s[0].device.type == "cpu":
        pad = max(0, J_fix + 1 - tables.slots[0].shape[1])
    granks = [g.to(lead) if not pad else torch.cat(
        [g.to(lead), g.new_full((nb, pad), J_fix, device=lead)], 1)
        for g in tables.granks]
    shards = []
    for i, ZP3 in enumerate(ZP3s):
        dev, nc1, CH = ZP3.device, ZP3.shape[0], ZP3.shape[2]
        slots = tables.slots[i]
        if pad:
            slots = torch.cat([slots, slots.new_full((nb, pad), nc1 - 1)], 1)
        f32 = dict(dtype=torch.float32, device=dev)
        win = None if windows is None else windows[i]
        shards.append(dict(
            ZP3=ZP3, slots=slots, gidx=slots.long(),
            out=(torch.zeros((nc1, K, B1), **f32),
                 torch.zeros((nc1, K, d), **f32),
                 torch.zeros((nc1, 2), **f32)),
            Rw=None if win is None else torch.zeros((win[1], K, CH), **f32),
            lo=0 if win is None else win[0],
            consts=[t.to(dev) for t in (tables.removal, Y, sigma, theta,
                                        Pr_b)],
            R3=None if R3s is None else R3s[i]))
    for b in range(nb):
        rows, Or, Er = [], None, None
        for sh in shards:
            removal, Ys, sig, th, prb = sh["consts"]
            dev = sh["ZP3"].device
            Ob, Eb = fused_update_block(
                b, sh["slots"], removal, sh["ZP3"], Ys, sig, th, prb,
                O.to(dev), E.to(dev), fast_ent, sh["out"], Rw=sh["Rw"],
                lo=sh["lo"], R3=sh["R3"], one_pass=one_pass)
            if Or is None:
                Or, Er = Ob.to(lead), Eb.to(lead)
            rows.append(sh["out"][0][sh["gidx"][b]])
        if multi:
            rows = list(all_gather_rows(torch.stack(
                [r.to(lead) for r in rows])).unbind(0))
        O, E = frame_readd(rows, [g[b] for g in granks], Or, Er, Pr_b, J_fix)
    return (O, E, [sh["out"][0] for sh in shards],
            [sh["out"][1] for sh in shards], [sh["out"][2] for sh in shards],
            [sh["Rw"] for sh in shards])
