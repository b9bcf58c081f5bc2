#!/usr/bin/env python3
"""Smoke test of harmonypy_tpu_torch on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --mesh-ab PARENT   # the mesh pass of the parent
                                             # checkout at PARENT and of this
                                             # one, in turns (mesh_ab)
    python3 chip_smoke.py --cards            # several cards: only what
                                             # exists across them (cards_main)
    python3 chip_smoke.py --round-ab PARENT  # the one-launch round of the
                                             # parent checkout and of this
                                             # one, in turns (round_ab)

Builds the hand-written kernels from the checkout, then, printing one JSON
line per phase:
  1. ptxas    registers, stack and spill bytes of every kernel built (the
              one-launch round's and the per-block entry's instantiations
              of estep_round, the re-add kernel), and ptxas's lines;
     device   the card (nvidia-smi name and power limit), torch/CUDA
              versions, the kernel build time;
  Every kernel phase runs both variants of the kernels' products:
  matmul_precision "float32" (3xTF32, held at TOL) and "default" (one
  bf16 pass, held against the one-pass plain version at RHO's derived
  bounds, below).
  2. kernel   the deferred-R E-step kernel K1 against its plain PyTorch
              version at the full 858,000 x 29 PCs, K=100, B=3, CH=2048
              shape (data made from a seed as bench.py makes it): one round
              and one r-window replay, bitwise repeat, and the replay's
              per-chunk stats equal to the round's cache bitwise; ms per
              round by CUDA events and by the profiler's kernel time,
              launches per round (1), both bounds and the roofline shares;
              the one-pass r window of every chunk timed; the one-pass
              outputs' distance from the 3xTF32 ones (no gate);
  2b. kernel2 the stored-R kernel K2 (write_r) on the same round inputs,
              fp32 and bf16 R: against its plain version, its stats and fp32
              r equal to K1's round and r window bitwise, its bf16 R equal
              to K1's r rounded to bf16, the dummy chunk zero, a bitwise
              repeat, its times, launches and bounds;
  2c. shapes  the checks of 2 and 2b at small N for odd shapes (K in
              {7, 100, 200, 280}, d in {5, 30, 50}, B in {1, 3, 5}, CH in
              {128, 2048}), both objective forms;
  3. fit      run_harmony on that data on the card, default parameters (the
              deferred-R fit, the one-pass K1) and under "float32", in
              turns: wall clock of 3 fits each after a warm-up fit, peak
              device memory, k-means rounds, objective, and the kernel
              launch count, which must be one per E-step pass the engine
              ran, every one of the fit's variant;
  3b. fit_stored  the stored-R fits (defer_r=False, in fp32 and with
              low_memory=True; and fp32 under "float32") on that data: the
              same numbers, K2 launches = k-means rounds; then the stored
              fit against the deferred fit of the same seed, every round
              run, under each precision, at the JAX package's tolerances
              for its two paths (tests/test_defer.py:62-76);
  3b'. products  every torch product of the fit outside the kernels
              (ops/products.py: k-means init, init pass, stored centroid
              numerator, replays' and stored ridge, per-cell fit), recorded
              at the main path's shapes from one-iteration default fits
              (deferred and stored 858k, per-cell 20,000 x 29): the
              one-pass cuBLAS product against its plain version at
              product_check's derived bound and, with an operand not exact
              in bf16, SKIP_CAST_MARGIN times nearer it than the fp32
              product; its ms beside the fp32 and plain products'; every
              port function of the product table
              recorded; TF32 and the float32 matmul precision unchanged;
  3c. profile one deferred and one stored fit under torch.profiler: device
              busy time by kernel, the device's idle share, and the host and
              device spans of the engine's ranges (harmony::init,
              ::cluster, ::ridge_replay or ::ridge);
  3d. profile_fit  utils.profiling.profile_fit(split_init=True) on the
              858k deferred config (K1; its A/B against the stored round,
              K2) and stored config (K2): dispatch, init (seeding, stats),
              one k-means round by differencing, the ridge, the round
              against its H100 floor (the bound of phase kernel) and HBM
              rate, the K1 / K2 launches the probes made; then trace()
              around a pbmc fit names the estep_round kernel;
  3d'. precision  the default deferred, stored and low_memory 858k fits
              in turns with their "float32" twins (2 each): wall s,
              harmony iterations, k-means rounds, E-step passes beside the
              reference's 3 / [18, 7, 5] (REFERENCE_858K); profile_fit of
              each: init s (seeding, stats), ridge s per iteration;
  3e. io      the native TSV parser on pbmc_3500_pcs.tsv.gz: bitwise at 1
              and all threads, equal to pandas, both parse times;
  4. golden   pbmc_3500 with chunk_size=128 on the card, under each
              precision: per-PC Pearson r against the R package's output
              >= 0.99;
  4b. golden_default  pbmc_3500 at default settings (the per-cell fit) and
              with chunk_size=128, defer_r=False (the stored fit, K2): min
              per-PC r >= 0.99 each;
  5. lisi_golden  the R LISI fixture (400 cells) through compute_lisi on
              the card: np.allclose at default tolerances;
  5b. lisi    compute_lisi on the deferred fit's Z_corr (858,000 x 29,
              labels batch and group, knn="exact": the pruned path): the
              index (clusters, p_max, visit count, certification rate,
              fallback rows), CUDA-event times of the index build, scan,
              fallback, Simpson step and whole call, peak memory, a bitwise
              repeat, brute force on 16,384 sampled queries at the
              tolerances of tests/test_lisi.py, and one profiled call:
              device time by kind (GEMM, top-k, gather), idle share, and
              the scan's bounds;
  5c. checkpoint  pbmc_3500 with chunk_size=128, deferred and stored: a fit
              resumed from harmony_iter_1.npz equals the checkpointing fit
              bitwise; an incompatible resume raises ValueError;
  5d. cli     `python -m harmonypy_tpu_torch correct` (no --device: CUDA)
              on the pbmc files, golden r >= 0.99, then `lisi` on its
              output against an in-process compute_lisi;
  5e. capacity  memory_envelope >= the measured peak of the three 858k
              fits, and CapacityError for a config that cannot fit;
  5f. mesh    the device mesh on 4 logical shards of the card
              (make_mesh(["cuda:0"] * 4): N_shard_real 215,040, nc_cap 105,
              J_shard 7): the kernel's per-block entry on the round of
              phase kernel cut into shards — each shard's rows equal the
              one-launch round's bitwise, against its plain version at TOL
              (no r, r window, K2 fp32 / bf16; each precision, and the
              one-pass rows and mesh round equal to the one-pass round's
              bitwise), a bitwise repeat, the
              re-add kernel bitwise against frame_readd, the mesh round
              (every shard and block, the re-add of block b - 1 folded
              into block b's launches, the re-add kernel after the last
              block) equal to the one-launch round bitwise; the folded
              launch of every block b > 0 equal to frame_readd plus the
              unfolded launch bitwise (K1, K2 fp32 / bf16, both objective
              forms); 50 passes of each through one plan bitwise equal
              (the double buffers under the shards' concurrent streams;
              one plan made, no allocation after the first pass); ms per
              launch with and without the folded prologue and per pass,
              bounds, one native call per pass, one profiled pass (host
              and device ms, kernel ms per block, the other device
              operations, one re-add per pass);
              the deferred, stored and low_memory fits (and the deferred
              and stored fits under "float32") bitwise equal to
              phases fit / fit_stored (Z_corr, R, histories, kmeans_rounds)
              with blocks x shards per-block and one re-add launch per
              pass and their wall clock; two short fits (deferred,
              stored) with every mesh pass metered: one native call, and
              no caching-allocator allocation in a pass after its plan's
              first; pbmc per-cell fit against one device at 3
              iterations: within 5e-4 max|Z| under "float32", and under
              "default" with every round pinned (PINNED) within
              percell_flip_bound; the default fit at the golden gate;
              compute_lisi on the mesh fit's output equal to phase lisi's
              values bitwise (pruned, and brute on the sampled queries); a
              resume on the mesh bitwise, one on 2 shards refused; each
              mesh fit's peak device memory per card under memory_envelope;
              the same checks but the per-block ones on a mesh of every
              card when there are several, and there the mesh round on the
              cards in reverse order (its lead not the current device)
              bitwise equal to the one-launch round;
  5g. multiprocess  multi-process runs at 858k, worker processes of this
              script (each with a time limit; one failing fails the run):
              2 ranks on cuda:0 under gloo with 2 shards each (NCCL
              refuses two ranks on one card) — the deferred, stored and
              low_memory fits, .R and a checkpoint resume; 1 NCCL rank
              with 4 shards, whose blocks cross through a real NCCL
              all-gather — the deferred and stored fits; one NCCL rank per
              card when there are several — the deferred fit. Each bitwise
              equal to phases fit / fit_stored (so to the one-process mesh
              of phase mesh), with every worker's per-block and re-add
              launches, each warm-up fit's passes metered (n_blocks + 1
              native calls per pass, no allocation after a plan's first),
              the ms per mesh pass (CUDA events), one profiled pass, and
              the host's waits per pass: under NCCL the host must not wait
              inside the block loop. The gloo, nccl and
              cards workers then fit the per-cell path at its full width
              (20,000 x 29 PCs, 3 batches, K=100, default settings) and
              pbmc_3500 at default settings, each bitwise equal to the
              one-process mesh of as many shards on cuda:0, pbmc at the
              golden gate: ms per k-means round, host waits per round and
              per block of the E-step (0 under NCCL), collectives per
              round (2 n_blocks + 2); the gloo and cards workers run
              compute_lisi on the 858k deferred fit's Z_corr (the pruned
              path, the index broadcast from rank 0) and brute force on
              16,384 sampled queries, bitwise equal to phase lisi's, with
              wall seconds and bytes received per rank;
  6. kernels  every kernel (K1, K2, their per-block entries, in each
              variant; the one-pass r window; the re-add) with its launches
              on its path's fit (the 3xTF32 variants' on the float32 fits),
              error against the plain version, time, and bound (the
              per-block entries as a pass runs them after its first block:
              with the folded re-add).
The last line is {"ok": true, "device": {...}}. Any failed check raises and
exits non-zero without it; so does a machine without a CUDA card.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Full-size workload: the reference README's 858k-cell x 29-PC benchmark,
# synthesized as bench.py does (24 groups, 3 batches, seed 0).
N_CELLS, N_PCS, N_BATCHES, N_GROUPS, K = 858_000, 29, 3, 24, 100
CHUNK = 2048
# Kernel vs plain tolerances (rtol, atol): both sum the same fp32 products
# in a different order (tile partials vs one batched matmul), over 2048-cell
# chunks for cache/ybuf/kbuf and ~43k-cell blocks for O/E; r is in [0, 1].
TOL = dict(O=(1e-5, 1e-3), E=(1e-5, 1e-3), cache=(1e-5, 1e-4),
           ybuf=(1e-5, 1e-4), kbuf=(1e-5, 1e-3), r=(1e-5, 1e-5))
# A bf16 R is held at one bf16 ulp (bit patterns at most 1 apart): an fp32
# difference of ~1e-7 at a rounding midpoint moves the stored value by one.
# The stored fit against the deferred fit: tests/test_defer.py:62-76.
TOL_FIT = dict(Z_corr=(2e-4, 2e-4), R=(1e-3, 2e-5))
# The one-pass variant (matmul_precision="default") against its plain
# version (one_pass=True) on the same inputs, derived:
#  * Both round the same fp32 operands to bf16 by the same rule, and the
#    product of two bf16 values is exact in fp32: apart from the order of
#    the fp32 sums (TOL's reason), they differ only where an operand is
#    itself a result whose fp32 value differs at rounding level and whose
#    bf16 roundings then land one bf16 ulp apart (2^-8 to 2^-7 of it): r as
#    the A operand of S, and the diversity weights wdiv (from O and E, whose
#    sums run in another order after a round's first block).
#  * r's roundings: the flip term F = sum_c (bf16(r_kernel) -
#    bf16(r_plain)) bf16(slab), per chunk, is computed from both r in
#    float64 (exact products) and taken out. cache - F, ybuf - F and O, E
#    less F summed over the chunks (E through Pr_b) are then held at TOL,
#    the order bound.
#  * wdiv's roundings: weights w_j moved by eps_j, |eps_j| <= 2^-7, move
#    r_k = s_k w_k / sum_j s_j w_j by at most (|eps_k| + |sum_j eps_j r_j|)
#    / (1 - |sum_j eps_j r_j|) <= 2^-6 / (1 - 2^-7) = RHO of itself (sum_j
#    r_j = 1), whatever the number of weights moved: r is held at rtol
#    RHO + TOL's, atol TOL's. kbuf sums r dist (|change| <= RHO sum r dist)
#    and sigma r log r (|d(r log r)| <= RHO r (|log r| + 1), so the chunk's
#    entropy moves by at most RHO (|ent| + max sigma x CH), both objective
#    forms computing the same entropy): |change| <= RHO (|kbuf| + max sigma
#    x CH) on top of TOL's.
#  * A stored bf16 R is bf16(r): K2's equals K1's r rounded (bitwise, as in
#    fp32), and against the plain version it is held at r's bound plus one
#    bf16 ulp (2^-8 of it).
RHO = 2.0 ** -6 / (1.0 - 2.0 ** -7)


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def ptxas_kernels(logs) -> dict:
    """Registers, stack frame and spill bytes of every kernel in ptxas -v
    reports ({source: report}), by a readable name: estep_round<float or
    bf16, NRG, PRE, round or block> (block: the per-block entry's FOLD
    instantiation), with ", one_pass" before the ">" for the one-pass
    variant's instantiations (and ", timed" for the stamped ones), and
    frame_readd_kernel."""
    import re
    out, entry, mangled, props = {}, None, None, None
    for log in logs.values():
        for ln in log.splitlines():
            m = re.search(r"Function properties for (\w+)", ln)
            if m:
                props = m.group(1)
                continue
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            if m:
                name = mangled = m.group(1)
                t = re.search(r"estep_roundI(f|13__nv_bfloat16)Li(\d+)ELb"
                              r"([01])E(?:Lb([01])E)?(?:Lb([01])E)?"
                              r"(?:Lb([01])E)?E", name)
                if t:
                    name = (f"estep_round<{'float' if t[1] == 'f' else 'bf16'}"
                            f", {t[2]}, {t[3]}, "
                            f"{'block' if t[4] == '1' else 'round'}"
                            f"{', one_pass' if t[5] == '1' else ''}"
                            f"{', timed' if t[6] == '1' else ''}>")
                elif "frame_readd_kernel" in name:
                    name = "frame_readd_kernel"
                entry = out.setdefault(name, {})
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", ln)
            if m and entry is not None and props == mangled:
                entry.update(stack=int(m[1]), spill_stores=int(m[2]),
                             spill_loads=int(m[3]))
            m = re.search(r"Used (\d+) registers", ln)
            if m and entry is not None and "registers" not in entry:
                entry["registers"] = int(m[1])
    return out


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def synthetic(seed=0, N=N_CELLS, d=N_PCS, B=N_BATCHES):
    import numpy as np
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((N_GROUPS, d), np.float32) * 5.0
    shifts = rng.standard_normal((B, d), np.float32) * 1.5
    groups = rng.integers(0, N_GROUPS, size=N)
    batches = rng.integers(0, B, size=N)
    noise = rng.standard_normal((N, d), np.float32)
    X = centers[groups] + shifts[batches] + noise               # (N, d)
    return X.astype(np.float32), batches, groups


def cuda_ms(fn, reps, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def diff(a, b, rtol, atol):
    """(max |a-b|, max |a-b| / max(|b|, atol), max |a-b| / (atol + rtol |b|))
    — the last <= 1 is numpy's allclose."""
    d = (a.double() - b.double()).abs()
    bb = b.double().abs()
    return (float(d.max()), float((d / bb.clamp_min(atol)).max()),
            float((d / (atol + rtol * bb)).max()))


def fit_inputs(ht_mods, X, batches, n_clusters=K, chunk=CHUNK):
    """(cfg, data, params) of the deferred fused fit of X on the card, one
    device: the engine's own inputs, as run_harmony builds them."""
    import numpy as np
    import torch
    (config, engine, layout, partition, fe, plain_mod, state_mod) = ht_mods
    dev = torch.device("cuda")
    (N, d), B = X.shape, int(batches.max()) + 1
    cfg = config.EngineConfig(N=N, d=d, K=n_clusters, B=B, n_devices=1,
                              use_fused_xla=True, defer_r=True,
                              chunk_size=chunk)
    Phi = (batches[None, :] == np.arange(B)[:, None]).astype(np.float32)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    data = state_mod.HarmonyData(Z_orig=t(layout.pad_cells(X.T, cfg)),
                                 Phi=t(layout.pad_cells(Phi, cfg)),
                                 mask=t(layout.shard_mask(cfg)))
    params = state_mod.HarmonyParams(
        theta=t(np.full(B, 2.0)), sigma=t(np.full(n_clusters, 0.1)),
        lamb=t([0.0] + [1.0] * B), Pr_b=t(Phi.mean(axis=1)))
    return cfg, data, params


def round_inputs(ht_mods, X, batches, n_clusters=K, chunk=CHUNK,
                 with_state=False):
    """The main path's own inputs of one E-step round (the full shape by
    default): init statistics and one round's tables. with_state: also
    return (cfg, the round's blocks, the init state)."""
    import torch
    (config, engine, layout, partition, fe, plain_mod, state_mod) = ht_mods
    cfg, data, params = fit_inputs(ht_mods, X, batches, n_clusters, chunk)
    geom = partition.partition_geometry(cfg)
    gen = torch.Generator(device=torch.device("cuda"))
    gen.manual_seed(0)
    # The main path's own inputs: init statistics, one round's tables.
    st = engine.init_defer(data, params, cfg, gen)
    ZP3 = plain_mod.make_zp3(st.Z_cos, data.Phi, data.mask, cfg)
    Y = engine.l2_normalize_cols(st.Ysum0)
    blocks = partition.stripe_blocks(gen, geom.NC_fixed, geom.L, geom.nb)
    slots, removal = partition.round_tables(blocks, st.cache, geom)
    args = (slots, removal, ZP3, Y, params.sigma, params.theta, params.Pr_b,
            st.O, st.E)
    if with_state:
        return geom, args, (cfg, blocks, st)
    return geom, args


def device_ms(fn, reps=10):
    """(device ms of the fused E-step kernel per call, its launches per
    call) from torch.profiler's kernel events over `reps` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, n = 0.0, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "estep_round" in e.name:
            us += e.time_range.elapsed_us()
            n += 1
    check(n > 0, "the profiler saw no estep_round kernel")
    return us / 1e3 / reps, n / reps


def launches_of(fe, fn):
    """Kernel launches (K1 + K2 counts) of one call of fn."""
    n0 = fe.launches + fe.launches_write_r
    fn()
    return fe.launches + fe.launches_write_r - n0


def flip_term(plain_mod, rk, rp, ZP3):
    """F (n, K, 1+B+d) float64: per chunk, sum over its cells of
    (bf16(rk) - bf16(rp)) bf16(slab), rk and rp the kernel's and the plain
    version's r of chunks 0..n-1 (RHO's note)."""
    import torch
    bf = plain_mod.round_bf16
    n = rk.shape[0]
    return torch.einsum("jkc,jxc->jkx", bf(rk).double() - bf(rp).double(),
                        bf(ZP3[:n]).double())


def one_pass_errs(plain_mod, kern, plain, rk, rp, ZP3, Pr_b, sigma,
                  readded=True):
    """The one-pass variant's errors against its plain version (RHO's
    note): kern, plain = (O, E, cache, ybuf, kbuf); rk, rp their r of
    chunks 0..n-1 (the chunks the outputs were written for; rows past n
    are compared as they are). readded: O, E hold the new stats (a round),
    else they are a block's block-removed O, E (compared at TOL). Returns
    {name: (max abs, max rel, ratio to the bound)} and the cells whose bf16
    r differ."""
    import torch
    F = flip_term(plain_mod, rk, rp, ZP3)
    n, B1 = F.shape[0], Pr_b.shape[0] + 1
    O, E, cache, ybuf, kbuf = (t.double() for t in kern)
    if readded:
        tot = F.sum(dim=0)
        O = O - tot[:, 1:B1]
        E = E - tot[:, 0:1] * Pr_b.double()[None, :]
    cache, ybuf = cache.clone(), ybuf.clone()
    cache[:n] -= F[:, :, :B1]
    ybuf[:n] -= F[:, :, B1:]
    errs = {nm: diff(a, b, *TOL[nm]) for nm, a, b in zip(
        ("O", "E", "cache", "ybuf"), (O, E, cache, ybuf), plain[:4])}
    bound_scale = float(sigma.max()) * ZP3.shape[2]
    dk = (kbuf - plain[4].double()).abs()
    pk = plain[4].double().abs()
    at, rt = TOL["kbuf"][1], TOL["kbuf"][0]
    errs["kbuf"] = (float(dk.max()), float((dk / pk.clamp_min(at)).max()),
                    float((dk / (at + rt * pk + RHO * (pk + bound_scale)))
                          .max()))
    rt_r, at_r = TOL["r"]
    errs["r"] = diff(rk, rp, rt_r + RHO, at_r)
    errs["r_beyond_TOL_share"] = (float((
        (rk.double() - rp.double()).abs()
        > at_r + rt_r * rp.double().abs()).double().mean()), 0.0, 0.0)
    flips = int((plain_mod.round_bf16(rk) != plain_mod.round_bf16(rp)).sum())
    return errs, flips


def check_k1(fe, plain_mod, args, fast, lo, width, precision="float32"):
    """K1 (round with an r window) against its plain version, a bitwise
    repeat, and the round without a window equal to it bitwise. "float32":
    at TOL; "default" (the one-pass variant): the window is every real
    chunk, held at RHO's bounds against the one-pass plain version.
    Returns (errors, K1 outputs, round outputs, the plain version's r
    window)."""
    import torch
    one = precision == "default"
    if one:
        lo, width = 0, args[2].shape[0] - 1
    kern = fe.fused_estep(*args, fast, lo=lo, width=width,
                          precision=precision)
    plain = plain_mod.fused_update_nor(*args, fast, lo=lo, width=width,
                                       one_pass=one)
    torch.cuda.synchronize()
    tag = f"fast_objective={fast}, {precision}"
    if one:
        errs, flips = one_pass_errs(plain_mod, kern[:5], plain[:5], kern[5],
                                    plain[5], args[2], args[6], args[4])
        errs["bf16_r_flips"] = (flips, 0.0, 0.0)
    else:
        names = ("O", "E", "cache", "ybuf", "kbuf", "r")
        errs = {n: diff(a, b, *TOL[n]) for n, a, b in zip(names, kern,
                                                           plain)}
    for n, (_, _, ratio) in errs.items():
        check(ratio <= 1.0, f"K1 vs plain {n} ({tag}) beyond its bound: "
                            f"{errs}")
    again = fe.fused_estep(*args, fast, lo=lo, width=width,
                           precision=precision)
    rnd = fe.fused_estep(*args, fast, precision=precision)
    check(all(torch.equal(a, b) for a, b in zip(kern, again)),
          f"K1 repeat is not bitwise equal ({tag})")
    check(all(torch.equal(a, b) for a, b in zip(kern[:5], rnd[:5])),
          f"replay stats differ from the round's bitwise ({tag})")
    return errs, kern, rnd, plain[5]


def check_k2(fe, plain_mod, args, fast, dt, k1_round, k1_r, k1_w, lo,
             width, precision="float32", plain_r=None):
    """K2 with an R3 of dtype dt against its plain version ("float32": at
    TOL, bf16 R within one ulp; "default": at RHO's bounds, with plain_r
    the one-pass plain version's r of every real chunk), and bitwise: a
    repeat, its stats equal to K1's round, its R equal to K1's r (fp32) or
    K1's r rounded to bf16, its fp32 R window equal to K1's r window, the
    dummy chunk zero. Returns the errors."""
    import torch
    nc1, _, CH = args[2].shape
    nc, Kc = nc1 - 1, args[3].shape[1]
    one = precision == "default"

    def k2():
        R3 = torch.empty((nc1, Kc, CH), dtype=dt, device="cuda")
        return fe.fused_estep_r(args[0], args[1], args[2], R3, *args[3:],
                                fast, precision=precision)

    kern = k2()
    plain = plain_mod.fused_update_r(
        args[0], args[1], args[2],
        torch.empty((nc1, Kc, CH), dtype=dt, device="cuda"), *args[3:], fast,
        one_pass=one)
    torch.cuda.synchronize()
    tag = f"({dt}, fast_objective={fast}, {precision})"
    if one:
        # The statistics come from fp32 r in both (K2's equals K1's,
        # checked bitwise below): the flip term from K1's r and the plain
        # version's.
        errs, _ = one_pass_errs(plain_mod, kern[1:], plain[1:], k1_r,
                                plain_r, args[2], args[6], args[4])
        rb = diff(kern[0][:nc].float(), plain[0][:nc].float(),
                  TOL["r"][0] + RHO + (2.0 ** -8 if dt == torch.bfloat16
                                       else 0.0), TOL["r"][1])
        errs["R"] = rb
    else:
        names = ("r", "O", "E", "cache", "ybuf", "kbuf")
        errs = {n: diff(a.float(), b.float(), *TOL[n])
                for n, a, b in zip(names, kern, plain)}
        if dt == torch.bfloat16:
            ulps = bf16_ulps(kern[0], plain[0])
            check(ulps <= 1, f"K2 bf16 R vs plain: {ulps} bf16 ulps {tag}")
            errs["r"] = (float((kern[0].float() - plain[0].float()).abs()
                               .max()), errs["r"][1], 0.0)
    for n, (_, _, ratio) in errs.items():
        check(ratio <= 1.0, f"K2 vs plain {n} {tag} beyond its bound: "
                            f"{errs}")
    again = k2()
    for ok, what in (
            (all(torch.equal(a, b) for a, b in zip(kern, again)), "repeat"),
            (all(torch.equal(a, b) for a, b in zip(kern[1:], k1_round[:5])),
             "stats vs K1's round"),
            (torch.equal(kern[0][:nc], k1_r.to(dt)), "R vs K1's r"),
            (dt != torch.float32
             or torch.equal(kern[0][lo: lo + width], k1_w), "R vs K1's r "
             "window"),
            (not bool(kern[0][nc].float().any()), "dummy chunk zero")):
        check(ok, f"K2 {what} not bitwise {tag}")
    return errs


def timing(fe, fn, bound, reps=20):
    """CUDA-event ms per call, profiler device ms per call, launches per
    call and the roofline shares against both bounds."""
    ms = cuda_ms(fn, reps=reps)
    dev_ms, prof_launches = device_ms(fn)
    return dict(ms=ms, device_ms=dev_ms, launches_per_round=launches_of(
                    fe, fn), profiler_launches_per_round=prof_launches,
                roofline_share=bound["bound_ms"] / ms,
                roofline_share_tc=bound["bound_tc_ms"] / ms)


PRECISIONS = ("float32", "default")


def _max_abs(errs) -> float:
    """Largest error against the plain version over the outputs (for the
    one-pass variant O, E, cache and ybuf after the flip term)."""
    return max(e[0] for n, e in errs.items()
               if n in ("O", "E", "cache", "ybuf", "kbuf", "r", "R"))


def phase_kernel(ht_mods, cfg, geom, args):
    """K1 against its plain version at the full shape under both
    precisions: "float32" (3xTF32) at TOL, "default" (one pass) at RHO's
    bounds; their times, launches and bounds; the one-pass round's r
    window over every real chunk (what a fit's replays run) timed; the
    one-pass outputs' distance from the 3xTF32 ones, recorded without a
    gate. Returns ({precision: the kernels line's numbers}, {precision:
    profiler device ms}, the one-pass r window's numbers)."""
    import torch
    from harmonypy_tpu_torch.utils.profiling import round_bound
    (config, engine, layout, partition, fe, plain_mod, state_mod) = ht_mods
    lo, width, nc = 200, 16, geom.nc_cap
    res, info, dev_ms, times = {}, {}, {}, {}
    window = None
    for prec in PRECISIONS:
        one = prec == "default"
        worst = 0.0
        for fast in (False, True):
            errs, kern, _, _ = check_k1(fe, plain_mod, args, fast, lo, width,
                                        prec)
            worst = max(worst, _max_abs(errs))
            res[f"{prec},fast_objective={fast}"] = dict(
                max_abs={n: e[0] for n, e in errs.items()},
                max_rel={n: e[1] for n, e in errs.items()},
                ratio_to_bound={n: e[2] for n, e in errs.items()},
                repeat_bitwise=True, replay_equals_round_bitwise=True)
            if one and not fast:
                window = dict(max_abs_err=errs["r"][0])
            del kern
        bound = round_bound(cfg, one_pass=one)
        t = timing(fe, lambda: fe.fused_estep(*args, False, precision=prec),
                   bound)
        check(t["launches_per_round"] == 1,
              f"K1 ({prec}) launched {t['launches_per_round']} kernels per "
              f"round")
        plain_ms = cuda_ms(lambda: plain_mod.fused_update_nor(
            *args, False, one_pass=one), reps=5, warmup=1)
        times[prec] = dict(t, plain_ms=plain_ms, bound=bound,
                           grid=fe.launch_grid(K, N_BATCHES, N_PCS,
                                               precision=prec))
        info[prec] = dict(ms=t["ms"], plain_ms=plain_ms, max_abs_err=worst,
                          bound_ms=bound["bound_ms"],
                          bound_by=bound["bound_by"])
        dev_ms[prec] = t["device_ms"]
    # The one-pass r window of every real chunk, as the fit's replays run
    # it (one window at 858k): K1's round plus the fp32 store of r.
    wb = round_bound(cfg, r_bytes=4, one_pass=True)
    window.update(
        ms=cuda_ms(lambda: fe.fused_estep(*args, False, lo=0, width=nc,
                                          precision="default"), reps=10),
        plain_ms=cuda_ms(lambda: plain_mod.fused_update_nor(
            *args, False, lo=0, width=nc, one_pass=True), reps=3, warmup=1),
        bound_ms=wb["bound_ms"], bound_by=wb["bound_by"])
    # The one-pass variant against the 3xTF32 one (no gate).
    a = fe.fused_estep(*args, False, lo=lo, width=width, precision="float32")
    b = fe.fused_estep(*args, False, lo=lo, width=width, precision="default")
    from_tf32 = {n: dict(max_abs=float((x - y).abs().max()),
                         max_rel=float(((x - y).abs()
                                        / y.abs().clamp_min(1e-6)).max()))
                 for n, x, y in zip(("O", "E", "cache", "ybuf", "kbuf", "r"),
                                    b, a)}
    del a, b
    torch.cuda.synchronize()
    emit(dict(phase="kernel", shape=dict(N=N_CELLS, d=N_PCS, K=K,
                                         B=N_BATCHES, CH=CHUNK,
                                         chunks=geom.nc_cap, J=geom.J_shard,
                                         n_blocks=geom.nb),
              tolerance=TOL, one_pass_rho=RHO, results=res, times=times,
              one_pass_r_window=window, one_pass_vs_3xtf32=from_tf32))
    return info, dev_ms, window


def bf16_ulps(a, b) -> int:
    """Largest distance in bf16 bit patterns between two non-negative bf16
    tensors."""
    import torch
    ia = a.contiguous().view(torch.int16).to(torch.int32)
    ib = b.contiguous().view(torch.int16).to(torch.int32)
    return int((ia - ib).abs().max())


def k1_refs(fe, plain_mod, args, fast, lo, width, precision):
    """K1's round, its r of every real chunk and of the window [lo, lo +
    width), and (one pass) the plain version's r of every real chunk."""
    nc = args[2].shape[0] - 1
    k1 = fe.fused_estep(*args, fast, precision=precision)
    k1r = fe.fused_estep(*args, fast, lo=0, width=nc,
                         precision=precision)[5]
    k1w = fe.fused_estep(*args, fast, lo=lo, width=width,
                         precision=precision)[5]
    plain_r = (plain_mod.fused_update_nor(*args, fast, lo=0, width=nc,
                                          one_pass=True)[5]
               if precision == "default" else None)
    return k1, k1r, k1w, plain_r


def phase_kernel2(ht_mods, cfg, geom, args):
    """K2 on the round of phase kernel, fp32 and bf16 R, both objective
    forms, both precisions: against its plain version, and bitwise against
    K1 of its precision. Returns ({(precision, R dtype): the kernels line's
    numbers}, {precision: fp32-R profiler device ms})."""
    import torch
    from harmonypy_tpu_torch.utils.profiling import round_bound
    (config, engine, layout, partition, fe, plain_mod, state_mod) = ht_mods
    dev = torch.device("cuda")
    nc, CH = geom.nc_cap, geom.CH
    dtypes = dict(float32=torch.float32, bfloat16=torch.bfloat16)
    width = 16
    lo = min(200, nc - width)

    res, worst = {}, {}
    for prec in PRECISIONS:
        for fast in (False, True):
            k1, k1r, k1w, plain_r = k1_refs(fe, plain_mod, args, fast, lo,
                                            width, prec)
            for name, dt in dtypes.items():
                errs = check_k2(fe, plain_mod, args, fast, dt, k1, k1r, k1w,
                                lo, width, prec, plain_r)
                key = (prec, name)
                worst[key] = max(worst.get(key, 0.0), _max_abs(errs))
                res[f"{prec},{name},fast_objective={fast}"] = dict(
                    max_abs={n: e[0] for n, e in errs.items()},
                    max_rel={n: e[1] for n, e in errs.items()},
                    repeat_bitwise=True, stats_equal_k1_round=True,
                    r_equals_k1_r=True, r_window_equals_k1=True,
                    dummy_chunk_zero=True)
            del k1, k1r, k1w, plain_r

    # K1 and K2 (fp32, bf16), each precision, timed in turns, three times
    # over: the spread within one call, and K2's cost over K1 on the same
    # card.
    R3s = {name: torch.empty((nc + 1, K, CH), dtype=dt, device=dev)
           for name, dt in dtypes.items()}
    runs = {}
    for prec in PRECISIONS:
        runs[prec, "k1"] = (lambda p=prec: fe.fused_estep(*args, False,
                                                          precision=p))
        for name, R3 in R3s.items():
            runs[prec, name] = (lambda R3=R3, p=prec: fe.fused_estep_r(
                args[0], args[1], args[2], R3, *args[3:], False,
                precision=p))
    samples = {n: [] for n in runs}
    for _ in range(3):
        for n, fn in runs.items():
            samples[n].append(cuda_ms(fn, reps=20))
    times = {f"{p},{n}": dict(ms=sorted(v)[1], ms_samples=v)
             for (p, n), v in samples.items()}
    info, dev_ms = {}, {}
    for prec in PRECISIONS:
        one = prec == "default"
        for name, R3 in R3s.items():
            fn = runs[prec, name]
            tk = times[f"{prec},{name}"]
            bound = round_bound(cfg, r_bytes=R3.element_size(), one_pass=one)
            t = timing(fe, fn, bound)
            check(t["launches_per_round"] == 1,
                  f"K2 {name} ({prec}) launched {t['launches_per_round']} "
                  f"kernels")
            tk.update(
                device_ms=t["device_ms"],
                launches_per_round=t["launches_per_round"],
                profiler_launches_per_round=t["profiler_launches_per_round"],
                roofline_share=bound["bound_ms"] / tk["ms"],
                roofline_share_tc=bound["bound_tc_ms"] / tk["ms"],
                bound=bound,
                plain_ms=cuda_ms(lambda R3=R3: plain_mod.fused_update_r(
                    args[0], args[1], args[2], R3, *args[3:], False,
                    one_pass=one), reps=5, warmup=1))
            info[prec, name] = dict(ms=tk["ms"], plain_ms=tk["plain_ms"],
                                    max_abs_err=worst[prec, name],
                                    bound_ms=bound["bound_ms"],
                                    bound_by=bound["bound_by"])
            if name == "float32":
                dev_ms[prec] = t["device_ms"]
    emit(dict(phase="kernel2", tolerance=TOL, one_pass_rho=RHO,
              bf16_r_tolerance="1 bf16 ulp (float32); one pass: r's bound "
                               "+ 2^-8",
              grid_bf16={p: fe.launch_grid(K, N_BATCHES, N_PCS, True, p)
                         for p in PRECISIONS},
              results=res, times=times))
    return info, dev_ms


# Shapes of phase shapes: (N, d, K, B, CH). Every K in {7, 100, 200}, d in
# {5, 30, 50}, B in {1, 3, 5} and CH in {128, 2048} appears; the last two
# take the kernel's compact layout (operands split at each load).
def block_shape_checks(fe, plain_mod, args, fast, prec, rnd, k1r):
    """The per-block entry on block 0 of the one-device table, under each
    tail its shape takes (the cluster tail where fe.block_tail picks it,
    the ticket tail always), with no store, K2 fp32 and K2 bf16:
    its block-removed O, E, its slots' rows and R bitwise the round's (rnd:
    the round's outputs, k1r: its r of every real chunk, as K2 equals
    K1); "float32" also against the plain per-block version at TOL.
    Returns (ng, the tails, the worst tolerance ratio)."""
    import torch
    slots, removal, ZP3, Y, sigma, theta, Pr_b, O, E = args
    nc1, _, CH = ZP3.shape
    d, Kc = Y.shape
    B, J, nc = theta.shape[0], slots.shape[1], nc1 - 1
    ng = fe.kernel_geometry(Kc, B, d, CH, J, fe._sm_count(0)).ng
    tails = [t for t in fe.BLOCK_TAILS
             if t != "cluster" or fe.block_tail(ng) == t]
    sl = slots[0].long()
    real = sl[sl < nc]
    worst = 0.0

    def outs():
        return (torch.zeros((nc1, Kc, B + 1), device="cuda"),
                torch.zeros((nc1, Kc, d), device="cuda"),
                torch.zeros((nc1, 2), device="cuda"))
    for tail in tails:
        for dt in (None, torch.float32, torch.bfloat16):
            tag = f"tail {tail}, R {dt}, fast_objective={fast}, {prec}"
            out = outs()
            R3 = (None if dt is None else torch.zeros(
                (nc1, Kc, CH), dtype=dt, device="cuda"))
            Ob, Eb = block_launch(fe, 0, *args, fast, out, J, R3=R3,
                                  precision=prec, tail=tail)
            check(_eq(Ob, O - removal[0][:, 1:])
                  and _eq(Eb, E - removal[0][:, 0:1] * Pr_b[None, :]),
                  f"per-block removed O/E ({tag})")
            check(all(_eq(a[real], b[real]) for a, b in zip(out, rnd[2:5])),
                  f"per-block rows differ from the round's ({tag})")
            check(dt is None or (_eq(R3[real], k1r[real].to(dt))
                                 and not bool(R3[nc].float().any())),
                  f"per-block R differs from the round's r ({tag})")
            if prec == "float32" and dt is None:
                kp = outs()
                p_ = plain_mod.fused_update_block(0, *args, fast, kp)
                for name, a, b in zip(("O", "E", "cache", "ybuf", "kbuf"),
                                      (Ob, Eb, *out), (*p_, *kp)):
                    e = diff(a, b, *TOL[name])
                    worst = max(worst, e[2])
                    check(e[2] <= 1.0, f"per-block {name} vs plain beyond "
                                       f"{TOL[name]} ({tag}): {e}")
    return ng, tails, worst


SHAPES = [(6_000, 5, 7, 1, 128), (6_000, 30, 100, 3, 128),
          (45_000, 5, 200, 1, 2048), (45_000, 50, 7, 3, 2048),
          (6_000, 5, 100, 5, 128), (45_000, 50, 200, 5, 2048),
          (6_000, 30, 280, 3, 128)]
# Wide designs at the atlas widths d = 50, K = 100: B = 49 (O, E, wdiv and
# S in shared memory under "default", the wide plan under "float32"), 64,
# 128 and 486 (the HLCA's individuals) in the wide plan under both
# (csrc/fused_estep.cuh layout_wide). The fifth has units enough for every
# CTA of the wide plan's grid (192 at 132 SMs), each with its own scratch
# slab, as an atlas-sized round launches. The last, K = 300 at B = 128,
# takes the dense wide plan under both, whose codes plan exceeds shared
# memory (layout_codes keeps S's dense accumulator and two ring stages).
WIDE_SHAPES = [(45_000, 50, 100, 49, 2048), (45_000, 50, 100, 64, 2048),
               (45_000, 50, 100, 128, 2048), (45_000, 50, 100, 486, 2048),
               (200_000, 50, 100, 486, 2048), (45_000, 50, 300, 128, 2048)]


def block_refused(fe, args, fast, prec) -> str:
    """The per-block entry at a shape only the wide plan takes: it raises
    ValueError (it has no wide plan); returns the message."""
    import torch
    slots, removal, ZP3, Y, sigma, theta, Pr_b, O, E = args
    nc1, _, CH = ZP3.shape
    d, Kc = Y.shape
    B = theta.shape[0]
    out = (torch.zeros((nc1, Kc, B + 1), device="cuda"),
           torch.zeros((nc1, Kc, d), device="cuda"),
           torch.zeros((nc1, 2), device="cuda"))
    try:
        block_launch(fe, 0, *args, fast, out, slots.shape[1], precision=prec)
    except ValueError as e:
        return str(e)
    check(False, f"the per-block entry ran at K={Kc}, B={B}, d={d}, "
                 f"{prec}, which only the wide plan takes")


def codes_refused(fe, args, fast, prec) -> str:
    """A round given codes at a shape whose codes plan exceeds shared
    memory: it raises ValueError (the fit passes none there); returns the
    message."""
    import torch
    from harmonypy_tpu_torch.ops.replay import window_levels
    ZP3, B = args[2], args[5].shape[0]
    codes = (window_levels(ZP3[:, :B + 1]) - 1).to(torch.int32).contiguous()
    try:
        fe.fused_estep(*args, fast, precision=prec, codes=codes)
    except ValueError as e:
        return str(e)
    check(False, f"a round took codes at K={args[3].shape[1]}, B={B}, "
                 f"{prec}, whose codes plan does not fit")


def plan_sizes(fe, Kc, B, d) -> dict:
    """fused_estep.plan_floats of each precision, checked against the
    library's sizes of the plans the shape can take (the memory model's
    mirror of csrc/fused_estep.cuh)."""
    out = {}
    for p in PRECISIONS:
        lib = fe._kernel_lib(p == "default")
        mine = fe.plan_floats(Kc, B, d, p == "default")
        lib_sizes = dict(
            narrow=lib.fused_estep_smem(Kc, B, d) // 4,
            wide=lib.fused_estep_smem_wide(Kc, B, d) // 4,
            codes=lib.fused_estep_smem_codes(Kc, B, d) // 4,
            codes_scratch=lib.fused_estep_codes_floats(Kc, B, d),
            codes_shared=lib.fused_estep_codes_shared_floats(Kc, B, d))
        check(mine == lib_sizes, f"plan_floats {mine} is not the library's "
                                 f"{lib_sizes} at K={Kc}, B={B}, d={d}, {p}")
        out[p] = mine
    return out


def codes_checks(fe, args, fast, prec, lo, width):
    """The codes plan against the dense wide plan on the same inputs, in
    the same library: K1's round, its r window and K2 (fp32 and bf16 R),
    bitwise (tensor_digest of every output), and both plans' ms per round.
    The codes are the slab's window_levels less one. Returns the
    launches_codes of the codes calls, the round's digest and the ms."""
    import torch
    from harmonypy_tpu_torch.ops.replay import window_levels
    slots, removal, ZP3, Y = args[:4]
    nc1, _, CH = ZP3.shape
    Kc, B = Y.shape[1], args[5].shape[0]
    codes = (window_levels(ZP3[:, :B + 1]) - 1).to(torch.int32).contiguous()
    tag = f"K={Kc}, B={B}, fast_objective={fast}, {prec}"

    def runs(**kw):
        rnd = fe.fused_estep(*args, fast, precision=prec, **kw)
        win = fe.fused_estep(*args, fast, lo=lo, width=width,
                             precision=prec, **kw)
        k2 = [fe.fused_estep_r(slots, removal, ZP3, torch.empty(
            (nc1, Kc, CH), dtype=dt, device="cuda"), *args[3:], fast,
            precision=prec, **kw) for dt in (torch.float32, torch.bfloat16)]
        return [[tensor_digest(t) for t in out if t is not None]
                for out in (rnd, win, *k2)]

    n0, c0 = fe.launches_wide, fe.launches_codes
    dense = runs()
    check(fe.launches_codes == c0 and fe.launches_wide == n0 + 4,
          f"the dense wide plan took the codes plan ({tag})")
    coded = runs(codes=codes)
    n_codes = fe.launches_codes - c0
    check(n_codes == 4, f"{n_codes} codes-plan launches of 4 ({tag})")
    for what, a, b in zip(("round", "r window", "K2 fp32", "K2 bf16"),
                          dense, coded):
        check(a == b, f"codes plan {what} not the dense wide plan's "
                      f"bitwise ({tag}): {a} vs {b}")
    ms = {plan: cuda_ms(lambda kw=kw: fe.fused_estep(
        *args, fast, precision=prec, **kw), reps=3)
        for plan, kw in (("dense", {}), ("codes", dict(codes=codes)))}
    return dict(launches_codes=n_codes, round_digest=dense[0][0], ms=ms)


def two_covariate_fits(ht, fe) -> dict:
    """Wide designs fitted on the card (45,000 x 50, one harmony iteration
    of two rounds, the default precision): of one covariate of 70 levels
    at K 100, every wide launch in the codes plan; of two covariates of 40
    and 30 levels (B = 70), none; of one covariate of 128 levels at K 300,
    whose codes plan exceeds shared memory, none, and the fit runs in the
    dense wide plan. Returns the launches of each."""
    import numpy as np
    import pandas as pd
    rng = np.random.default_rng(11)
    N = 45_000
    one, x, y, wide = (rng.integers(0, n, N) for n in (70, 40, 30, 128))
    X = (rng.standard_normal((N, 50)) + (one % 7)[:, None]).astype(
        np.float32)
    out = {}
    for name, meta, K in (
            ("one_covariate", pd.DataFrame({"a": pd.Categorical(one)}), 100),
            ("two_covariates", pd.DataFrame({"a": pd.Categorical(x),
                                             "b": pd.Categorical(y)}), 100),
            ("one_covariate_k300",
             pd.DataFrame({"a": pd.Categorical(wide)}), 300)):
        n0, c0 = fe.launches_wide, fe.launches_codes
        ho = ht.run_harmony(X, meta, list(meta.columns), device="cuda:0",
                            verbose=False, max_iter_harmony=1,
                            max_iter_kmeans=2, epsilon_cluster=0.0,
                            nclust=K)
        out[name] = dict(B=ho.cfg.B, K=K, n_covariates=ho.cfg.n_covariates,
                         launches_wide=fe.launches_wide - n0,
                         launches_codes=fe.launches_codes - c0,
                         finite=bool(np.isfinite(ho.Z_corr).all()))
    one, two, k300 = (out[k] for k in ("one_covariate", "two_covariates",
                                       "one_covariate_k300"))
    check(k300["launches_wide"] > 0 and k300["launches_codes"] == 0
          and k300["finite"],
          f"a one-covariate fit whose codes plan does not fit: {k300}")
    check(one["launches_wide"] > 0
          and one["launches_codes"] == one["launches_wide"],
          f"a one-covariate wide fit not in the codes plan: {one}")
    check(two["n_covariates"] == 2 and two["launches_wide"] > 0
          and two["launches_codes"] == 0,
          f"a two-covariate wide fit took the codes plan: {two}")
    return out


def phase_shapes(ht_mods, shapes=SHAPES + WIDE_SHAPES):
    """K1 (round and r window), K2 fp32 and K2 bf16 against their plain
    versions and each other at small N and odd shapes, both objective
    forms and both precisions, with the checks of phases kernel and
    kernel2; the per-block entry under each tail the shape takes
    (block_shape_checks), or its ValueError where the shape takes the wide
    plan. Each shape's shared memory against the card's limit, and the
    wide plan's where it takes that. Where the wide plan takes a shape,
    its codes plan (a one-covariate design's batch codes) bitwise the
    dense wide plan's (codes_checks); then a one-covariate and a
    two-covariate wide fit (two_covariate_fits: only the first in the
    codes plan)."""
    import torch
    import harmonypy_tpu_torch as ht
    (config, engine, layout, partition, fe, plain_mod, state_mod) = ht_mods
    out = []
    for i, (N, d, Kc, B, CH) in enumerate(shapes):
        X, batches, _ = synthetic(seed=i + 1, N=N, d=d, B=B)
        geom, args = round_inputs(ht_mods, X, batches, n_clusters=Kc,
                                  chunk=CH)
        nc = geom.nc_cap
        lo, width = nc // 3, max(1, min(5, nc - nc // 3))
        worst, flips, refused = {}, 0, None
        wide = {p: fe.wide_plan(Kc, B, d, p == "default") for p in PRECISIONS}
        wide0, codes = fe.launches_wide, {}
        for prec in PRECISIONS:
            w = 0.0
            for fast in (False, True):
                errs, kw, rnd, plain_r = check_k1(fe, plain_mod, args, fast,
                                                  lo, width, prec)
                flips += int(errs.get("bf16_r_flips", (0,))[0])
                k1r = fe.fused_estep(*args, fast, lo=0, width=nc,
                                     precision=prec)[5]
                k1w = fe.fused_estep(*args, fast, lo=lo, width=width,
                                     precision=prec)[5]
                w = max(w, *(e[2] for e in errs.values()))
                if wide[prec]:
                    ng, tails, wb = None, [], 0.0
                    refused = block_refused(fe, args, fast, prec)
                else:
                    ng, tails, wb = block_shape_checks(
                        fe, plain_mod, args, fast, prec, rnd, k1r)
                w = max(w, wb)
                for dt in (torch.float32, torch.bfloat16):
                    e2 = check_k2(fe, plain_mod, args, fast, dt, rnd, k1r,
                                  k1w, lo, width, prec, plain_r)
                    w = max(w, *(e[2] for e in e2.values()))
                if wide[prec] and fe.codes_fit(Kc, B, d, prec == "default"):
                    codes[f"{prec},fast_objective={fast}"] = codes_checks(
                        fe, args, fast, prec, lo, width)
                elif wide[prec]:
                    codes[f"{prec},fast_objective={fast}"] = dict(
                        refused=codes_refused(fe, args, fast, prec))
            worst[prec] = w
        out.append(dict(N=N, d=d, K=Kc, B=B, CH=CH, chunks=nc, J=geom.J_shard,
                        grid={p: fe.launch_grid(Kc, B, d, precision=p)
                              for p in PRECISIONS},
                        smem_bytes={p: fe._kernel_lib(
                            p == "default").fused_estep_smem(Kc, B, d)
                            for p in PRECISIONS},
                        smem_limit=fe._kernel_lib(False)
                        .fused_estep_smem_limit(),
                        wide_plan=wide,
                        wide_smem_bytes={p: fe._kernel_lib(
                            p == "default").fused_estep_smem_wide(Kc, B, d)
                            for p in PRECISIONS if wide[p]},
                        wide_scratch_floats_per_cta={p: fe._kernel_lib(
                            p == "default").fused_estep_wide_floats(Kc, B, d)
                            for p in PRECISIONS if wide[p]},
                        launches_wide=fe.launches_wide - wide0,
                        codes_plan=codes,
                        codes_fit={p: fe.codes_fit(Kc, B, d, p == "default")
                                   for p in PRECISIONS if wide[p]},
                        plan_floats=plan_sizes(fe, Kc, B, d),
                        units=fe.kernel_geometry(
                            Kc, B, d, CH, args[0].shape[1],
                            fe._sm_count(0)).n_units,
                        wide_ctas=(fe.wide_ctas if any(wide.values())
                                   else None),
                        worst_tolerance_ratio=worst,
                        one_pass_bf16_r_flips=flips,
                        block=dict(units_per_slot=ng, tails=tails,
                                   refused=refused)))
        check(any(wide.values()) == (fe.launches_wide > wide0),
              f"wide plan {wide} but {fe.launches_wide - wide0} wide "
              f"launches at K={Kc}, B={B}, d={d}")
        del args
    fits = two_covariate_fits(ht, fe) if any(
        fe.wide_plan(Kc, B, d, True) for _, d, Kc, B, _ in shapes) else None
    emit(dict(phase="shapes", tolerance=TOL, one_pass_rho=RHO,
              wide_fits=fits,
              bf16_r_tolerance="1 bf16 ulp (float32); one pass: r's bound "
                               "+ 2^-8",
              checks="K1 round + r window, K2 fp32 and bf16 vs plain; "
                     "repeat, replay, K2 == K1 bitwise; both objective "
                     "forms; both precisions; the per-block entry under "
                     "each tail bitwise the round (block 0) and, float32, "
                     "vs its plain version", shapes=out))


def timed_fit(ht, fe, X, meta, **kw):
    """One fit on the card with every launch count set to 0 just before
    it: (Harmony, seconds, K1 launches, K2 launches). Sets ho.peak_bytes,
    the fit's peak device allocation above what was allocated before it,
    and ho.one_pass_launches, the one-pass launches among K1's and K2's;
    checks that a fit runs one variant: one pass under "default", 3xTF32
    under "float32"."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _zero_counts(fe)
    t0 = time.perf_counter()
    ho = ht.run_harmony(X, meta, ["batch"], device="cuda:0", verbose=False,
                        **kw)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    ho.peak_bytes = torch.cuda.max_memory_allocated() - base
    ho.one_pass_launches = (fe.launches_one_pass,
                            fe.launches_write_r_one_pass)
    one = kw.get("matmul_precision", "default") == "default"
    want = (fe.launches, fe.launches_write_r) if one else (0, 0)
    check(ho.one_pass_launches == want,
          f"fit {kw}: one-pass launches {ho.one_pass_launches} of "
          f"{(fe.launches, fe.launches_write_r)}, expected {want}")
    return ho, s, fe.launches, fe.launches_write_r


def phase_fit(ht, fe, X, batches):
    """The default deferred fit (matmul_precision "default": the one-pass
    K1) and the same fit under "float32" (3xTF32), timed in turns after a
    warm-up fit of each. Returns ({precision: K1 launches}, meta, the
    default fit, its peak bytes, the float32 fit)."""
    import numpy as np
    import pandas as pd
    import torch
    meta = pd.DataFrame({"batch": pd.Categorical.from_codes(
        batches, [f"b{i}" for i in range(N_BATCHES)])})

    warm = {p: timed_fit(ht, fe, X, meta, matmul_precision=p)[1]
            for p in ("default", "float32")}
    fit_s, peaks, res, hos, counts = {}, {}, {}, {}, {}
    for _ in range(3):
        for prec in ("default", "float32"):
            ho, s, launches, k2 = timed_fit(ht, fe, X, meta,
                                            matmul_precision=prec)
            fit_s.setdefault(prec, []).append(s)
            peaks.setdefault(prec, []).append(ho.peak_bytes)
            nb = ho.cfg.n_blocks
            passes = ho.state.n_passes
            check(ho.cfg.defer_r, "default config did not select deferred-R")
            check(launches > 0 and launches == passes,
                  f"K1 launches {launches} != {passes} E-step passes "
                  f"({nb} blocks each, {prec})")
            check(k2 == 0, f"the deferred fit launched K2 {k2} times")
            hos[prec], counts[prec] = ho, launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    for prec, ho in hos.items():
        obj = ho.objective_harmony
        check(obj[-1] < obj[0], f"objective did not decrease ({prec}): "
                                f"{obj}")
        Z = ho.Z_corr
        check(Z.shape == (N_CELLS, N_PCS) and np.all(np.isfinite(Z)),
              f"Z_corr not finite / wrong shape ({prec})")
        Rm = ho.R
        row_err = float(np.abs(Rm.sum(axis=1) - 1.0).max())
        check(Rm.shape == (N_CELLS, K) and row_err < 1e-4,
              f".R rows do not sum to 1 ({prec}): {row_err}")
        res[prec] = dict(warmup_fit_s=warm[prec], fit_s=fit_s[prec],
                         kmeans_rounds=ho.kmeans_rounds,
                         objective_harmony=obj,
                         estep_passes=ho.state.n_passes,
                         kernel_launches=counts[prec],
                         R_row_sum_max_err=row_err,
                         fit_peak_bytes=peaks[prec])
    ho = hos["default"]
    emit(dict(phase="fit", N=N_CELLS, d=N_PCS, K=ho.K, B=N_BATCHES,
              chunk_size=ho.cfg.chunk_size, defer_r=ho.cfg.defer_r,
              peak_mem_gib=peak_gib, fits=res,
              default_vs_float32=dict(
                  Z_corr_max_abs=float(np.abs(
                      ho.Z_corr - hos["float32"].Z_corr).max()))))
    return counts, meta, ho, max(peaks["default"]), hos["float32"]


def phase_fit_stored(ht, fe, X, meta):
    """The stored-R fits: fp32 (defer_r=False) and bf16 (low_memory=True)
    at default settings (the one-pass K2), and the fp32 one under
    "float32" (3xTF32); then the stored fit against the deferred fit with
    every round run, under each precision. Returns (K2 launches of each
    fit, {name: (cfg, peak)}, {name: fit})."""
    import numpy as np
    import torch
    out, launches, fits, hos = {}, {}, {}, {}
    for name, kw in (("stored", dict(defer_r=False)),
                     ("low_memory", dict(defer_r=False, low_memory=True)),
                     ("stored_float32", dict(defer_r=False,
                                             matmul_precision="float32"))):
        _, warm_s, _, _ = timed_fit(ht, fe, X, meta, **kw)
        fit_s, peaks = [], []
        for _ in range(3):
            ho, s, k1, k2 = timed_fit(ht, fe, X, meta, **kw)
            fit_s.append(s)
            peaks.append(ho.peak_bytes)
            rounds = sum(ho.kmeans_rounds)
            nb = ho.cfg.n_blocks
            check(not ho.cfg.defer_r and ho.cfg.use_fused_xla,
                  f"{name}: not the stored fused config")
            check(k2 > 0 and k2 == rounds,
                  f"{name}: K2 launches {k2} != {rounds} rounds ({nb} "
                  f"blocks each)")
            check(k1 == 0, f"{name}: K1 launched {k1} times")
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        obj = ho.objective_harmony
        check(obj[-1] < obj[0], f"{name}: objective did not decrease: {obj}")
        Z = ho.Z_corr
        check(Z.shape == (N_CELLS, N_PCS) and np.all(np.isfinite(Z)),
              f"{name}: Z_corr not finite / wrong shape")
        Rm = ho.R
        row_err = float(np.abs(Rm.sum(axis=1) - 1.0).max())
        # bf16 storage rounds each r by at most 2^-9 of itself.
        row_tol = 1e-4 if ho.cfg.r_dtype == "float32" else 2 ** -8
        check(Rm.shape == (N_CELLS, K) and row_err < row_tol,
              f"{name}: .R rows do not sum to 1: {row_err}")
        out[name] = dict(r_dtype=ho.cfg.r_dtype, warmup_fit_s=warm_s,
                         fit_s=fit_s, peak_mem_gib=peak_gib,
                         kmeans_rounds=ho.kmeans_rounds,
                         objective_harmony=obj, k2_launches=k2,
                         R_row_sum_max_err=row_err, fit_peak_bytes=peaks)
        if name != "stored_float32":
            fits[name] = (ho.cfg, max(peaks))
        hos[name] = ho
        launches[name] = k2

    every_round = dict(max_iter_harmony=2, epsilon_cluster=0,
                       epsilon_harmony=-1)
    vs = {}
    for prec in ("float32", "default"):
        st, _, _, _ = timed_fit(ht, fe, X, meta, defer_r=False,
                                matmul_precision=prec, **every_round)
        de, _, _, _ = timed_fit(ht, fe, X, meta, matmul_precision=prec,
                                **every_round)
        check(de.cfg.defer_r and st.kmeans_rounds == de.kmeans_rounds
              == [20, 20], f"rounds {st.kmeans_rounds} vs "
                           f"{de.kmeans_rounds} ({prec})")
        errs = {n: diff(torch.as_tensor(getattr(st, n)),
                        torch.as_tensor(getattr(de, n)), *TOL_FIT[n])
                for n in TOL_FIT}
        vs[prec] = dict(tolerance=TOL_FIT, kmeans_rounds=st.kmeans_rounds,
                        max_abs={n: e[0] for n, e in errs.items()},
                        ratio={n: e[2] for n, e in errs.items()},
                        objective_stored=st.objective_harmony,
                        objective_deferred=de.objective_harmony)
        for n, (_, _, ratio) in errs.items():
            check(ratio <= 1.0, f"stored vs deferred {n} ({prec}) beyond "
                                f"{TOL_FIT[n]}: {errs}")
    emit(dict(phase="fit_stored", N=N_CELLS, fits=out,
              stored_vs_deferred=vs))
    return launches, fits, hos


# The port's torch products outside the kernels, by the module that takes
# them from ops/products.py and the names it imports them under.
PRODUCT_MODULES = (("engine", ("einsum", "matmul")),
                   ("ops.kmeans", ("matmul",)), ("ops.update_r", ("matmul",)),
                   ("ops.objective", ("matmul",)), ("ops.replay", ("einsum",)),
                   ("ops.ridge", ("einsum",)))
# The port function of every product of the JAX package's four precision
# scopes that runs outside the kernels (PERF.md's product table;
# tests/test_torch_precision_scope.py holds the JAX scopes against it).
PRODUCT_CALLERS = {"_first", "_greedy", "cand_d2", "kmeansbb_seed", "lloyd",
                   "_init_pass", "init_stored", "cluster_fused",
                   "cluster_percell", "_stats", "update_r",
                   "compute_objective_terms", "window_normal_eq",
                   "window_apply", "replay_apply", "_products",
                   "_correction"}
# The reference's default fit at 858k: the JAX package on one TPU v5e at
# matmul_precision "default", deferred R (the last line of BENCH_r05.json,
# bench.py:126-133). An iteration count, not a time.
REFERENCE_858K = dict(iterations=3, kmeans_rounds=[18, 7, 5],
                      source="BENCH_r05.json (JAX package, TPU v5e)")


class ProductRecorder:
    """While active, records the first one-pass call of every torch
    product of the fit (products.matmul / einsum with `one` set, from
    every module of PRODUCT_MODULES) per (module, calling function,
    product, shapes): its operands, cloned with their strides; a later
    call replaces a record whose operand is all zeros (the ridge's
    intercept row of W). Restores the modules' names on exit."""

    def __enter__(self):
        import importlib
        self.seen, self.zero, self.saved = {}, set(), []
        for mod_name, names in PRODUCT_MODULES:
            mod = importlib.import_module(f"harmonypy_tpu_torch.{mod_name}")
            for n in names:
                fn = getattr(mod, n)
                self.saved.append((mod, n, fn))
                setattr(mod, n, self._wrap(mod_name, n, fn))
        return self

    def _wrap(self, mod_name, name, fn):
        def recorded(*args):
            *eq, a, b, one = args
            if one:
                key = (mod_name, sys._getframe(1).f_code.co_name,
                       eq[0] if eq else "@", tuple(a.shape), tuple(b.shape))
                if key not in self.seen or key in self.zero:
                    self.seen[key] = (a.detach().clone(), b.detach().clone())
                    if a.any() and b.any():
                        self.zero.discard(key)
                    else:
                        self.zero.add(key)
            return fn(*args)
        return recorded

    def __exit__(self, *exc):
        for mod, n, fn in self.saved:
            setattr(mod, n, fn)


# How much nearer its plain version a one-pass product must lie than the
# fp32 product does (product_check).
SKIP_CAST_MARGIN = 16


def product_check(products, eq, a, b):
    """One recorded product on the card: the one-pass product (bf16 cuBLAS,
    fp32 result) against its plain version (round_bf16 operands, fp32
    product) on the same operands, at the derived bound, and the ms of
    the one-pass, fp32 and plain products.

    Bound: every product of two bf16 values is exact in fp32, so both
    results are fp32 sums of the same n exact terms (n the contraction
    length) in different orders. Round-to-nearest sums are within gamma_n
    sum|terms| of the exact sum (gamma_n = n u / (1 - n u), u = 2^-24);
    tensor-core accumulation truncates where it aligns, at most 2u per
    add (Fasi et al., PeerJ CS 2021), so 2 gamma_n. Together |one-pass -
    plain| <= 3 gamma_n sum|terms|, held at 4 gamma_n (sum|terms| in
    float64 from the rounded operands).

    That bound cannot tell a one-pass product from an fp32 one at large n,
    so where an operand is not exact in bf16 (and its rounding moves the
    fp32 product at all) the one-pass result must also lie nearer the
    plain version than the fp32 product does, by SKIP_CAST_MARGIN: the
    fp32 product differs from the plain one by the operands' rounding
    (each term by up to 2^-8 of it), the one-pass product by the order of
    its fp32 sums (u = 2^-24 per add), some 2^15 times less."""
    import torch
    a32, b32 = a.float(), b.float()
    if eq == "@":
        def one():
            return products.matmul(a, b, True)

        def f32():
            return products.matmul(a32, b32, False)

        def plain():
            return products.matmul_plain(a32, b32)
        ra, rb = (products.round_bf16(x).double().abs() for x in (a32, b32))
        mag = ra @ rb
        n = a.shape[-1]
    else:
        def one():
            return products.einsum(eq, a, b, True)

        def f32():
            return products.einsum(eq, a32, b32, False)

        def plain():
            return products.einsum_plain(eq, a32, b32)
        ra, rb = (products.round_bf16(x).double().abs() for x in (a32, b32))
        mag = torch.einsum(eq, ra, rb)
        ins, out = eq.split("->")
        sa, sb = ins.split(",")
        size = dict(zip(sa, a.shape)) | dict(zip(sb, b.shape))
        n = 1
        for c in sa:
            if c in sb and c not in out:
                n *= size[c]
    got, want = one(), plain()
    check(got.dtype == torch.float32 and got.shape == want.shape,
          f"product {eq}: {got.dtype} {tuple(got.shape)}")
    gamma = n * 2.0 ** -24 / (1 - n * 2.0 ** -24)
    err = (got.double() - want.double()).abs()
    ratio = float((err / (4 * gamma * mag).clamp_min(1e-300)).max())
    exact = all(torch.equal(products.round_bf16(x), x) for x in (a32, b32))
    fp32_err = float((f32().double() - want.double()).abs().max())
    check(exact or fp32_err == 0.0
          or float(err.max()) * SKIP_CAST_MARGIN < fp32_err,
          f"product {eq}: the one-pass result is {float(err.max())} from "
          f"the plain version, the fp32 product {fp32_err}: not one pass")
    reps = 10
    return dict(eq=eq, a=list(a.shape), b=list(b.shape), n=n,
                max_abs_err=float(err.max()), bound_ratio=ratio,
                operands_exact_in_bf16=exact, fp32_vs_plain_max_abs=fp32_err,
                vs_fp32_max_abs=float((got - f32()).abs().max()),
                one_pass_ms=cuda_ms(one, reps), fp32_ms=cuda_ms(f32, reps),
                plain_ms=cuda_ms(plain, reps))


def phase_products(ht, fe, X, meta):
    """Every one-pass torch product of the fit at the shapes the main path
    gives it: recorded from the default deferred and stored 858k fits and
    the per-cell fit at its full width (PC_CELLS x 29, K = 100), one
    harmony iteration each, then each held against its plain version at
    product_check's bound and timed beside the fp32 product. The recorded
    calling functions are PRODUCT_CALLERS, every one. No process-wide
    matmul setting moves across the fits (TF32 off, float32 matmul
    precision "highest")."""
    import torch
    from harmonypy_tpu_torch.ops import products
    settings = (torch.backends.cuda.matmul.allow_tf32,
                torch.get_float32_matmul_precision())
    Xp, bp, _ = synthetic(N=PC_CELLS)
    with ProductRecorder() as rec:
        for kw in (dict(), dict(defer_r=False)):
            timed_fit(ht, fe, X, meta, max_iter_harmony=1, **kw)
        ho = ht.run_harmony(Xp, batch_meta(bp), ["batch"], device="cuda:0",
                            verbose=False, max_iter_harmony=1)
        check(not ho.cfg.fused_estep, f"products: {ho.cfg} not per-cell")
    check((torch.backends.cuda.matmul.allow_tf32,
           torch.get_float32_matmul_precision()) == settings == (
               False, "highest"), f"products: matmul settings {settings}")
    callers = {k[1] for k in rec.seen}
    check(callers == PRODUCT_CALLERS,
          f"products: callers {sorted(callers)}, expected "
          f"{sorted(PRODUCT_CALLERS)}")
    res = []
    for (mod, caller, eq, _, _), (a, b) in rec.seen.items():
        r = product_check(products, eq, a, b)
        check(r["bound_ratio"] <= 1.0,
              f"product {mod}.{caller} {eq}: {r}")
        res.append(dict(module=mod, caller=caller, **r))
    del rec
    emit(dict(phase="products", n=len(res), bound="4 gamma_n sum|a b|",
              skip_cast_margin=SKIP_CAST_MARGIN, products=res))


def phase_precision(ht, fe, X, meta, smi):
    """The default deferred, stored and low_memory 858k fits in turns with
    their "float32" twins (2 timed fits each): wall s, harmony iterations,
    k-means rounds and E-step passes beside the reference's; then
    profile_fit (8 reps, split init) of each: init s (seeding, stats) and
    ridge s per iteration. With one-pass products on the card, the
    default fits run every product as one bf16 pass."""
    from harmonypy_tpu_torch.utils.profiling import profile_fit
    paths = (("deferred", {}), ("stored", dict(defer_r=False)),
             ("low_memory", dict(defer_r=False, low_memory=True)))
    res, hos = {}, {}
    for _ in range(2):
        for name, kw in paths:
            for prec in ("default", "float32"):
                ho, s, k1, k2 = timed_fit(ht, fe, X, meta,
                                          matmul_precision=prec, **kw)
                r = res.setdefault(f"{name}/{prec}", dict(fit_s=[]))
                r["fit_s"].append(s)
                r.update(iterations=len(ho.kmeans_rounds),
                         kmeans_rounds=ho.kmeans_rounds,
                         estep_passes=ho.state.n_passes,
                         objective_harmony=ho.objective_harmony)
                hos[name, prec] = ho
    for (name, prec), ho in hos.items():
        prof = profile_fit(ho.cfg, ho.mesh, ho._data, ho._params, reps=8,
                           split_init=True)
        res[f"{name}/{prec}"].update(
            {k: prof[k] for k in ("phase_init_s", "phase_init_seeding_s",
                                  "phase_init_stats_s", "phase_ridge_s",
                                  "phase_kmeans_round_s") if k in prof})
    emit(dict(phase="precision", nvidia_smi=smi, N=N_CELLS,
              reference=REFERENCE_858K, fits=res))


def _union_us(spans):
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def phase_profile(ht, X, meta, label, **kw):
    """One fit under torch.profiler. Device busy time is the union of the
    device's kernel and copy intervals (the engine's ranges, which the
    profiler mirrors onto the device timeline, are not work and are reported
    apart); the idle share is the rest of the fit's wall clock. Host ranges
    nest: harmony::kmeans_init lies inside harmony::init."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ht.run_harmony(X, meta, ["batch"], device="cuda:0", verbose=False,
                       **kw)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    host, dev_ranges, work, spans = {}, {}, {}, []
    for e in prof.events():
        ms = e.time_range.elapsed_us() / 1e3
        ranged = e.name.startswith("harmony::")
        if e.device_type == DeviceType.CUDA:
            if ranged or getattr(e, "is_user_annotation", False):
                dev_ranges[e.name] = dev_ranges.get(e.name, 0.0) + ms
            else:
                spans.append((e.time_range.start, e.time_range.end))
                t, n = work.get(e.name, (0.0, 0))
                work[e.name] = (t + ms, n + 1)
        elif ranged:
            host[e.name] = host.get(e.name, 0.0) + ms
    busy_ms = _union_us(spans) / 1e3
    check(busy_ms > 0, "the profiler saw no device time")
    top = sorted(work.items(), key=lambda kv: -kv[1][0])[:10]
    emit(dict(phase="profile", fit=label, wall_s_profiled=wall_s,
              device_busy_ms=busy_ms,
              device_idle_share=1.0 - busy_ms / (wall_s * 1e3),
              host_ranges_ms=host, device_ranges_ms=dev_ranges,
              top_device=[dict(name=k[:80], ms=ms, count=n)
                          for k, (ms, n) in top]))


def phase_profile_fit(ht, mods, X, batches, smi, k1_dev_ms, k2_dev_ms,
                      k1_bound_ms):
    """utils.profiling.profile_fit(split_init=True) through the engine at
    858k on the card: the deferred config (K1, and the stored round's A/B,
    K2) and the stored config (K2), with the launches its probes made; the
    profiler's fp32 floor equal to phase kernel's fp32 bound, and the
    deferred profile's floor the one-pass bound (the configs run at
    "default": the one-pass kernels, whose device ms k1_dev_ms and
    k2_dev_ms are); a differenced round no shorter than its kernel's
    device time (x 0.9). Then trace() around a pbmc fit (chunk 128,
    deferred) names the estep_round kernel."""
    import dataclasses
    import glob
    import tempfile

    import pandas as pd
    import torch
    from harmonypy_tpu_torch.parallel.mesh import make_mesh
    from harmonypy_tpu_torch.utils.profiling import (estep_vpu_floor_s,
                                                     profile_fit,
                                                     round_bound, trace)
    fe = mods[4]
    cfg, data, params = fit_inputs(mods, X, batches)
    check(abs(estep_vpu_floor_s(cfg) * 1e3 - k1_bound_ms) <= 1e-12,
          f"profiler floor {estep_vpu_floor_s(cfg)} s != K1 bound "
          f"{k1_bound_ms} ms")
    mesh = make_mesh(["cuda:0"])
    out = {}
    for name, cfg_v, kernel_ms in (
            ("deferred", cfg, k1_dev_ms),
            ("stored", dataclasses.replace(cfg, defer_r=False), k2_dev_ms)):
        fe.launches = fe.launches_write_r = 0
        t0 = time.perf_counter()
        res = profile_fit(cfg_v, mesh, data, params, split_init=True)
        wall_s = time.perf_counter() - t0
        k1, k2 = fe.launches, fe.launches_write_r
        tag = f"profile_fit {name}"
        check("phases_truncated" not in res, f"{tag}: {res}")
        check(res.get("estep_vpu_floor_frac", 0.0) <= 1.05
              and res.get("estep_hbm_frac_of_peak", 0.0) <= 1.05,
              f"{tag}: a round past its floor: {res}")
        check(res["phase_kmeans_round_s"] * 1e3 >= 0.9 * kernel_ms,
              f"{tag}: round {res['phase_kmeans_round_s']} s under its "
              f"kernel's {kernel_ms} ms")
        if name == "deferred":
            check(k1 > 0 and "pallas_stored_round_s" in res,
                  f"{tag}: K1 launches {k1}, keys {sorted(res)}")
            one_floor = round_bound(cfg, one_pass=True)["bound_ms"] / 1e3
            check(res["estep_vpu_floor_s"] == one_floor,
                  f"{tag}: floor {res['estep_vpu_floor_s']} s, not the "
                  f"one-pass bound {one_floor} s")
            check(res["pallas_stored_round_s"] * 1e3 >= 0.9 * k2_dev_ms,
                  f"{tag}: stored round {res['pallas_stored_round_s']} s "
                  f"under K2's {k2_dev_ms} ms")
        check(k2 > 0, f"{tag}: K2 launches {k2}")
        out[name] = dict(result=res, k1_launches=k1, k2_launches=k2,
                         wall_s=wall_s, kernel_device_ms=kernel_ms)
    rounds = 17
    host = iteration_profile(mods[1], dataclasses.replace(
        cfg, max_iter_kmeans=rounds, epsilon_kmeans=0.0, max_iter_harmony=1),
        data, params)
    del data

    meta = pd.read_csv(os.path.join(DATA, "pbmc_3500_meta.tsv.gz"), sep="\t")
    pcs = pd.read_csv(os.path.join(DATA, "pbmc_3500_pcs.tsv.gz"), sep="\t")
    with tempfile.TemporaryDirectory() as td:
        with trace(td):
            ho = ht.run_harmony(pcs, meta, ["donor"], device="cuda:0",
                                verbose=False, chunk_size=128)
            torch.cuda.synchronize()
        files = glob.glob(os.path.join(td, "*.json"))
        check(ho.cfg.defer_r and files, f"trace: defer_r {ho.cfg.defer_r}, "
                                        f"files {os.listdir(td)}")
        named = 0
        for f in files:
            with open(f) as fh:
                named += fh.read().count("estep_round")
        check(named > 0, f"trace {files}: no estep_round kernel")
        trace_mb = sum(os.path.getsize(f) for f in files) / 1e6
    emit(dict(phase="profile_fit", nvidia_smi=smi, N=N_CELLS, d=N_PCS, K=K,
              B=N_BATCHES, reps=16, fits=out,
              deferred_iteration_profiled=dict(kmeans_rounds=rounds, **host),
              trace=dict(fit="pbmc_3500 chunk_size=128", files=len(files),
                         mb=trace_mb, estep_round_mentions=named)))


def iteration_profile(engine, cfg, data, params):
    """One harmony iteration of cfg (pinned rounds) under torch.profiler:
    wall ms, device busy ms, the host ms of harmony::cluster and
    harmony::ridge_replay, the host's waits for the device (CUDA
    synchronize calls and scalar reads: count, ms) and the host ops of
    most self time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    st = engine.init_defer(data, params, cfg, gen)
    step = engine.HarmonyStep(data, params, cfg, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(st)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, ranges, waits = [], {}, {}
    for e in prof.events():
        ms = e.time_range.elapsed_us() / 1e3
        if e.device_type == DeviceType.CUDA:
            if not (e.name.startswith("harmony::")
                    or getattr(e, "is_user_annotation", False)):
                spans.append((e.time_range.start, e.time_range.end))
        elif e.name.startswith("harmony::"):
            ranges[e.name] = ranges.get(e.name, 0.0) + ms
        elif "Synchronize" in e.name or e.name == "aten::_local_scalar_dense":
            n, t = waits.get(e.name, (0, 0.0))
            waits[e.name] = (n + 1, t + ms)
    top = sorted((a for a in prof.key_averages()
                  if a.device_type != DeviceType.CUDA),
                 key=lambda a: -a.self_cpu_time_total)[:12]
    return dict(wall_ms=wall_ms, device_busy_ms=_union_us(spans) / 1e3,
                host_ranges_ms=ranges,
                host_waits={k: dict(count=n, ms=t)
                            for k, (n, t) in waits.items()},
                top_host_self=[dict(name=a.key[:60], count=a.count,
                                    self_ms=a.self_cpu_time_total / 1e3)
                               for a in top])


def phase_io():
    """The port's native TSV parser on pbmc_3500_pcs.tsv.gz: bitwise equal
    at one thread and at one per core, equal to the pandas path at rtol
    1e-6; both parse times. Without it, the build's message."""
    import numpy as np
    from harmonypy_tpu_torch.io import loader
    path = os.path.join(DATA, "pbmc_3500_pcs.tsv.gz")
    ok = loader.native_available()
    res = dict(native_available=ok)
    if not ok:
        res["build_error"] = loader._build_error
        emit(dict(phase="io", **res))
        return

    def best_s(fn, reps=5):
        out, best = None, float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            best = min(best, time.perf_counter() - t0)
        return out, best

    a0, native_s = best_s(lambda: loader.load_matrix_tsv(path))
    a1, native1_s = best_s(lambda: loader.load_matrix_tsv(path, n_threads=1))
    lib = loader._lib
    loader._lib = None              # the pandas path alone
    try:
        b, pandas_s = best_s(lambda: loader.load_matrix_tsv(path))
    finally:
        loader._lib = lib
    check(np.array_equal(a0, a1), "native parse differs across threads")
    err = float(np.abs(a0 - b).max())
    check(a0.shape == b.shape and np.allclose(a0, b, rtol=1e-6, atol=0),
          f"native vs pandas max |diff| {err}")
    emit(dict(phase="io", **res, shape=list(a0.shape), library=lib._name,
              native_s=native_s, native_one_thread_s=native1_s,
              pandas_s=pandas_s, max_abs_diff_vs_pandas=err,
              threads_bitwise=True))


def golden_fit(ht, **kw):
    """pbmc_3500 on the card: (Harmony, per-PC Pearson r against the R
    package's output, fit seconds)."""
    import numpy as np
    import torch
    pcs, meta, gold = pbmc_inputs()
    t0 = time.perf_counter()
    ho = ht.run_harmony(pcs, meta, ["donor"], device="cuda:0", verbose=False,
                        **kw)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    Z = ho.Z_corr
    r = [float(np.corrcoef(Z[:, i], gold.iloc[:, i].values)[0, 1])
         for i in range(Z.shape[1])]
    return ho, r, fit_s


def phase_golden(ht):
    """pbmc_3500 with chunk_size=128 (the deferred fused fit) under each
    precision: "default" runs the one-pass K1, "float32" the 3xTF32 one."""
    res = {}
    for prec in PRECISIONS:
        ho, r, fit_s = golden_fit(ht, chunk_size=128, matmul_precision=prec)
        check(ho.cfg.defer_r and ho.cfg.matmul_precision == prec,
              f"golden {prec}: unexpected config {ho.cfg}")
        check(min(r) >= 0.99, f"golden pbmc ({prec}) min per-PC r {min(r)} "
                              f"< 0.99")
        res[prec] = dict(min_pc_r=min(r), fit_s=fit_s,
                         kmeans_rounds=ho.kmeans_rounds)
    emit(dict(phase="golden", data="pbmc_3500", chunk_size=128,
              min_pc_r=res["default"]["min_pc_r"], results=res))


def phase_golden_default(ht):
    """pbmc_3500 at default settings (the per-cell fit) and as a stored
    fused fit (chunk_size=128, defer_r=False: K2) on the card."""
    res = {}
    for name, kw in (("default", {}),
                     ("stored_chunk128", dict(chunk_size=128,
                                              defer_r=False))):
        ho, r, fit_s = golden_fit(ht, **kw)
        check(ho.cfg.fused_estep == bool(kw) and not ho.cfg.defer_r,
              f"golden {name}: unexpected config {ho.cfg}")
        check(min(r) >= 0.99, f"golden pbmc {name} min per-PC r {min(r)} "
                              f"< 0.99")
        res[name] = dict(min_pc_r=min(r), fit_s=fit_s,
                         kmeans_rounds=ho.kmeans_rounds)
    emit(dict(phase="golden_default", data="pbmc_3500", results=res))


DATA = os.path.join(HERE, "harmonypy_tpu", "data")
# H100 SXM published FP64 tensor-core peak (NVIDIA H100 datasheet, dense):
# the kNN runs in float64.
PEAK_FP64_TC_FLOPS = 67e12
# Pruned vs brute at 858k: tests/test_lisi.py:126-137 (squared distances
# within 1e-4 of the squared data radius) and :153 (LISI rtol/atol 1e-4).
TOL_LISI = dict(d2_rel_R2=1e-4, lisi=(1e-4, 1e-4))
LISI_SAMPLE = 16_384


def phase_lisi_golden(ht):
    """The R LISI package's output on the 400-cell fixture through
    compute_lisi on the card, at np.allclose's default tolerances
    (tests/test_lisi.py:17)."""
    import numpy as np
    import pandas as pd
    X = pd.read_csv(os.path.join(DATA, "lisi_x.tsv.gz"), sep="\t")
    meta = pd.read_csv(os.path.join(DATA, "lisi_metadata.tsv.gz"), sep="\t")
    ref = pd.read_csv(os.path.join(DATA, "lisi_lisi.tsv.gz"),
                      sep="\t").iloc[:, -2:].to_numpy()
    lisi = ht.compute_lisi(X, meta, meta.columns, 30, device="cuda:0")
    err = float(np.abs(lisi - ref).max())
    check(np.allclose(lisi, ref), f"LISI golden max |diff| {err}")
    emit(dict(phase="lisi_golden", cells=int(X.shape[0]),
              labels=list(meta.columns), max_abs_diff=err))


def _events():
    import torch
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def _timed(fn):
    """(result, CUDA-event ms) of one call."""
    import torch
    e0, e1 = _events()
    torch.cuda.synchronize()
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


def _kernel_kind(name: str) -> str:
    n = name.lower()
    if any(t in n for t in ("gemm", "xmma", "cutlass", "dmma", "sm90")):
        return "gemm"
    if any(t in n for t in ("topk", "radix", "sort", "bitonic", "select",
                            "kthcount", "withinkcount", "digitcumsum")):
        return "topk"
    if any(t in n for t in ("index", "gather", "scatter")):
        return "gather"
    if "memcpy" in n or "memset" in n:
        return "copy"
    return "elementwise"


def profile_device(fn):
    """Run fn once under torch.profiler: (wall s, device busy ms, device ms
    by kernel kind, top kernels)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    spans, kinds, work = [], {}, {}
    for e in prof.events():
        if (e.device_type != DeviceType.CUDA or e.name.startswith("lisi::")
                or getattr(e, "is_user_annotation", False)):
            continue
        ms = e.time_range.elapsed_us() / 1e3
        spans.append((e.time_range.start, e.time_range.end))
        kind = _kernel_kind(e.name)
        kinds[kind] = kinds.get(kind, 0.0) + ms
        t, n = work.get(e.name, (0.0, 0))
        work[e.name] = (t + ms, n + 1)
    busy_ms = _union_us(spans) / 1e3
    check(busy_ms > 0, "the profiler saw no device time")
    top = sorted(work.items(), key=lambda kv: -kv[1][0])[:12]
    return wall_s, busy_ms, kinds, [dict(name=k[:90], ms=ms, count=n)
                                    for k, (ms, n) in top]


def phase_lisi(ht, Z, batches, groups):
    """compute_lisi on the deferred fit's Z_corr (858,000 x 29) with labels
    batch (3) and group (24), knn="exact", which takes the pruned path at
    this size: the index, times by CUDA events of the build, scan,
    fallback, Simpson step and total, peak memory, a bitwise repeat, brute
    force on 16,384 sampled queries, and a profile with the scan's bounds."""
    import numpy as np
    import pandas as pd
    import torch
    from harmonypy_tpu_torch import lisi as L
    from harmonypy_tpu_torch.ops import knn_pruned as kp
    N = Z.shape[0]
    labels = ["batch", "group"]
    meta = pd.DataFrame({
        "batch": pd.Categorical.from_codes(
            batches, [f"b{i}" for i in range(N_BATCHES)]),
        "group": pd.Categorical.from_codes(
            groups, [f"g{i}" for i in range(N_GROUPS)])})
    perplexity = 30
    n_nb = int(perplexity * 3) - 1
    check(N >= L._PRUNED_MIN_N, "858k is below the pruned threshold")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    lisi1, total_ms = _timed(lambda: ht.compute_lisi(Z, meta, labels,
                                                     perplexity,
                                                     device="cuda:0"))
    wall1 = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    lisi2, total2_ms = _timed(lambda: ht.compute_lisi(Z, meta, labels,
                                                      perplexity,
                                                      device="cuda:0"))
    check(np.array_equal(lisi1, lisi2), "LISI repeat is not bitwise equal")
    check(lisi1.shape == (N, 2) and np.all(np.isfinite(lisi1)),
          "LISI not finite / wrong shape")
    check(np.all(lisi1 >= 1 - 1e-9) and np.all(lisi1[:, 0] <= N_BATCHES
                                                + 1e-9),
          "LISI outside [1, n_categories]")

    # The same pipeline piece by piece, each timed.
    Xd = torch.tensor(Z, dtype=torch.float64, device="cuda")
    ids = torch.arange(N, device="cuda")
    stats = {}
    index, build_ms = _timed(lambda: kp.build_index(
        Xd, kp.default_n_clusters(N, n_nb + 1)))
    res, scan_ms = _timed(lambda: kp.pruned_knn(Xd, n_nb, index=index,
                                                stats=stats))
    check(res is not None, f"the pruned search bailed to brute: {stats}")
    dist, idx, cert = res
    dist, idx = L._drop_self_by_id(dist, idx, ids)
    (dist, idx), fb_ms = _timed(lambda: L._fallback(Xd, dist, idx, cert,
                                                    n_nb, stats))
    simpson_ms, pieces = 0.0, np.zeros((N, 2))
    for i, lab in enumerate(labels):
        codes = torch.as_tensor(meta[lab].cat.codes.to_numpy().astype(
            np.int64), device="cuda")
        sim, ms = _timed(lambda: L._simpson_label(
            dist, idx, codes, len(meta[lab].cat.categories), perplexity))
        simpson_ms += ms
        pieces[:, i] = 1 / sim.cpu().numpy()
    check(np.array_equal(pieces, lisi1),
          "the timed pieces differ from compute_lisi")

    # Brute force on sampled queries against the pruned rows.
    (sv, sidx), brute_ms = _timed(lambda: ht.compute_lisi(
        Z, meta, labels, perplexity, sample=LISI_SAMPLE, knn="brute",
        device="cuda:0"))
    q = torch.as_tensor(sidx, device="cuda")
    bd, bi = L._knn_batched(Xd[q], Xd, n_nb, qid=q)
    Xc = Xd - Xd.mean(0)
    R2 = float(torch.max(torch.sum(Xc * Xc, dim=1)))
    d2_err = float(torch.max(torch.abs(dist[q] ** 2 - bd ** 2)))
    check(d2_err <= TOL_LISI["d2_rel_R2"] * R2,
          f"pruned vs brute squared distances {d2_err} > 1e-4 R^2 ({R2})")
    ids_equal = float(torch.mean((idx[q] == bi).double()))
    rtol, atol = TOL_LISI["lisi"]
    lisi_err = float(np.abs(sv - lisi1[sidx]).max())
    check(np.allclose(sv, lisi1[sidx], rtol=rtol, atol=atol),
          f"pruned vs brute LISI max |diff| {lisi_err}")
    del bd, bi, Xc

    # One profiled pruned call, and the scan's bounds for this run's index.
    from harmonypy_tpu_torch.utils.profiling import PEAK_BYTES_S
    wall_p, busy_ms, kinds, top = profile_device(
        lambda: ht.compute_lisi(Z, meta, labels, perplexity,
                                device="cuda:0"))
    C, P, V = stats["n_clusters"], stats["p_max"], stats["visit"]
    W, d = V * P, Z.shape[1]
    flop = 2.0 * d * C * P * (W + C)        # candidate + certificate products
    nbytes = 2.0 * 8 * C * P * W            # d^2 slabs written and read once
    bound = dict(flop=flop, bytes=nbytes,
                 ops_ms=flop / PEAK_FP64_TC_FLOPS * 1e3,
                 bytes_ms=nbytes / PEAK_BYTES_S * 1e3)
    bound["bound_ms"] = max(bound["ops_ms"], bound["bytes_ms"])
    bound["bound_by"] = ("operations" if bound["ops_ms"] >= bound["bytes_ms"]
                         else "bytes")
    emit(dict(phase="lisi", N=N, d=d, labels=labels, perplexity=perplexity,
              knn="exact", index=stats, total_ms=total_ms,
              total_ms_repeat=total2_ms, wall_s=wall1, build_ms=build_ms,
              scan_ms=scan_ms, fallback_ms=fb_ms, simpson_ms=simpson_ms,
              peak_mem_gib=peak / 2 ** 30,
              mean_lisi=dict(zip(labels, lisi1.mean(axis=0).tolist())),
              repeat_bitwise=True, pieces_equal_call=True,
              brute_sample=dict(queries=LISI_SAMPLE, ms=brute_ms,
                                d2_max_abs=d2_err, R2=R2,
                                ids_equal=ids_equal,
                                lisi_max_abs=lisi_err, tolerance=TOL_LISI),
              profile=dict(wall_s=wall_p, device_busy_ms=busy_ms,
                           device_idle_share=1.0 - busy_ms / (wall_p * 1e3),
                           device_ms_by_kind=kinds, top_device=top),
              scan_bound=bound, scan_share=bound["bound_ms"] / scan_ms))
    return lisi1, sv, sidx


def phase_checkpoint(ht):
    """pbmc_3500 with chunk_size=128, deferred and stored, 4 harmony
    iterations on the card: a fit resumed from harmony_iter_1.npz equals
    the checkpointing fit bitwise; an incompatible resume raises."""
    import tempfile

    import numpy as np
    import pandas as pd
    meta = pd.read_csv(os.path.join(DATA, "pbmc_3500_meta.tsv.gz"), sep="\t")
    pcs = pd.read_csv(os.path.join(DATA, "pbmc_3500_pcs.tsv.gz"), sep="\t")
    hist = ("objective_harmony", "objective_kmeans", "objective_kmeans_dist",
            "objective_kmeans_entropy", "objective_kmeans_cross")
    res = {}
    for name, kw in (("deferred", {}), ("stored", dict(defer_r=False))):
        args = dict(verbose=False, chunk_size=128, max_iter_harmony=4,
                    device="cuda:0", **kw)
        with tempfile.TemporaryDirectory() as td:
            full = ht.run_harmony(pcs, meta, ["donor"], checkpoint_dir=td,
                                  **args)
            check(full.cfg.defer_r == (name == "deferred"),
                  f"checkpoint {name}: unexpected config {full.cfg}")
            path = os.path.join(td, "harmony_iter_1.npz")
            resumed = ht.run_harmony(pcs, meta, ["donor"], resume_from=path,
                                     **args)
            for a in ("Z_corr", "R") + hist:
                check(np.array_equal(np.asarray(getattr(full, a)),
                                     np.asarray(getattr(resumed, a))),
                      f"checkpoint {name}: resumed {a} differs")
            try:
                ht.run_harmony(pcs, meta, ["donor"], resume_from=path,
                               **{**args, "max_iter_harmony": 5})
                raise RuntimeError(f"chip_smoke: checkpoint {name}: an "
                                   f"incompatible resume did not raise")
            except ValueError as e:
                check("Mismatches" in str(e) and "obj_harmony" in str(e),
                      f"checkpoint {name}: unexpected message {e}")
            res[name] = dict(kmeans_rounds=full.kmeans_rounds,
                             files=sorted(os.listdir(td)),
                             file_mb=os.path.getsize(path) / 1e6)
    emit(dict(phase="checkpoint", data="pbmc_3500", chunk_size=128,
              resumed_from="harmony_iter_1.npz", bitwise=True,
              incompatible_raises=True, fits=res))


def phase_cli(ht):
    """`python -m harmonypy_tpu_torch correct` on the pbmc fixture files
    without --device (CUDA), its golden r, then `lisi` on its output
    against an in-process compute_lisi of the same array."""
    import tempfile

    import numpy as np
    import pandas as pd
    gold = pd.read_csv(os.path.join(DATA, "pbmc_3500_pcs_harmonized.tsv.gz"),
                       sep="\t")
    if gold.iloc[:, 0].dtype == "object":
        gold = gold.iloc[:, 1:]
    meta_path = os.path.join(DATA, "pbmc_3500_meta.tsv.gz")
    env = {**os.environ, "PYTHONPATH": HERE}
    with tempfile.TemporaryDirectory() as td:
        out, tsv = os.path.join(td, "corr.npy"), os.path.join(td, "lisi.tsv")
        runs = {}
        for name, argv in (
                ("correct", ["correct", "--pcs",
                             os.path.join(DATA, "pbmc_3500_pcs.tsv.gz"),
                             "--meta", meta_path, "--vars", "donor",
                             "--out", out, "--quiet"]),
                ("lisi", ["lisi", "--x", out, "--meta", meta_path,
                          "--labels", "donor", "--out", tsv])):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "harmonypy_tpu_torch", *argv],
                cwd=HERE, env=env, capture_output=True, text=True,
                timeout=600)
            runs[name] = dict(s=time.perf_counter() - t0,
                              stdout=proc.stdout.strip()[-200:])
            check(proc.returncode == 0, f"cli {name} failed: "
                                        f"{proc.stderr[-3000:]}")
        Z = np.load(out)
        r = [float(np.corrcoef(Z[:, i], gold.iloc[:, i].values)[0, 1])
             for i in range(Z.shape[1])]
        check(min(r) >= 0.99, f"cli correct min per-PC r {min(r)} < 0.99")
        got = pd.read_csv(tsv, sep="\t")
        meta = pd.read_csv(meta_path, sep="\t")
        ref = ht.compute_lisi(Z, meta, ["donor"])
        check(got.shape == (Z.shape[0], 1), f"cli lisi shape {got.shape}")
        err = float(np.abs(got.to_numpy() - ref).max())
        check(np.allclose(got.to_numpy(), ref, rtol=1e-12, atol=0),
              f"cli lisi vs compute_lisi max |diff| {err}")
    emit(dict(phase="cli", min_pc_r=min(r), lisi_max_abs_diff=err,
              runs=runs))


def phase_capacity(fits):
    """memory_envelope against the measured peak of the 858k fits (each
    model >= its peak), and check_capacity on a config that cannot fit."""
    import torch
    from harmonypy_tpu_torch.config import EngineConfig
    from harmonypy_tpu_torch.utils.memory import (CapacityError,
                                                  check_capacity,
                                                  device_capacity_bytes,
                                                  memory_envelope)
    out = {}
    for name, (cfg, peak) in fits.items():
        env = memory_envelope(cfg)
        check(env["total"] >= peak, f"capacity {name}: modeled "
                                    f"{env['total']} < measured peak {peak}")
        out[name] = dict(modeled_bytes=env["total"], measured_peak=peak,
                         ratio=env["total"] / peak,
                         peak_phase=env["peak_phase"])
    big = EngineConfig(N=250_000_000, d=N_PCS, K=K, B=N_BATCHES,
                       n_devices=1, use_fused_xla=True)
    try:
        check_capacity(big, torch.device("cuda"))
        raise RuntimeError("chip_smoke: an over-budget config passed "
                           "check_capacity")
    except CapacityError as e:
        msg = str(e)
        check("defer_r" in msg, f"no defer_r remedy in: {msg}")
    emit(dict(phase="capacity", fits=out,
              usable_bytes=device_capacity_bytes(torch.device("cuda")),
              over_budget=dict(N=big.N, K=big.K, r_dtype=big.r_dtype,
                               modeled_bytes=memory_envelope(big)["total"],
                               message=msg[:600])))


# Phase mesh: MESH_SHARDS logical shards of the one card (a mesh may repeat
# a device) at the 858k shape: N_shard_real 215,040, nc_cap 105 and
# J_shard 7 slots per block, against the one-device round's J_fix + 1 = 22.
MESH_SHARDS = 4
# Mesh passes run back to back for each kernel, each bitwise equal to the
# first: the parity double buffers of the folded re-add under real
# concurrency of the shards' streams.
MESH_REPEATS = 50
# Passes whose host issue time mesh_timing takes the median of.
MESH_HOST_PASSES = 31
HIST = ("objective_harmony", "objective_kmeans", "objective_kmeans_dist",
        "objective_kmeans_entropy", "objective_kmeans_cross",
        "kmeans_rounds")
# Per-cell fit on a mesh against one device: shard partials summed in shard
# order (tests/test_fused_xla.py:135-150).
TOL_PERCELL_REL = 5e-4
# Convergence tests that never pass: every k-means round and harmony
# iteration runs, so two fits take the same branches.
PINNED = dict(epsilon_cluster=0.0, epsilon_harmony=float("-inf"))
DEFAULTS_KMEANS = 20        # run_harmony's max_iter_kmeans


def percell_flip_bound(ho_default, ho_float32) -> float:
    """The bound on a pinned per-cell mesh fit's distance from one device
    under "default": max|Z_default - Z_float32| of the one-device fits, the
    effect of rounding every product's operands to bf16. The mesh changes
    the last bits of its shard sums only; those flip the rounding of some
    operands by one bf16 ulp, where the one-pass products round every
    operand by up to half of one, so a fault-free mesh drifts less than
    that effect, and a fault of the mesh's products (a layout, a shard's
    partial) moves the fit by more. tests/test_torch_precision_scope.py
    holds the JAX package's per-cell fit, its DEFAULT dots rounded the
    same way on the CPU, and the port's at the same bound."""
    import numpy as np
    return float(np.abs(ho_default.Z_corr - ho_float32.Z_corr).max())


def block_bound(n_cells, n_slots, r_bytes=0, fold_J_fix=0, one_pass=False):
    """Least work of one per-block launch: its real cells read once (the
    slab), its slots' rows written once (cache, ybuf, kbuf, and r with
    r_bytes per element), the products of round_bound on those cells (of
    the one-pass variant with one_pass); with fold_J_fix > 0 also the
    previous block's re-add folded into its prologue (readd_bound)."""
    from harmonypy_tpu_torch.utils.profiling import estep_bound
    b = dict(estep_bound(n_cells, n_slots, N_PCS, K, N_BATCHES, CHUNK,
                         r_bytes, one_pass), cells=n_cells, slots=n_slots)
    if fold_J_fix:
        rb = readd_bound(fold_J_fix)
        for k in ("flop", "bytes", "ops_ms", "bytes_ms", "ops_tc_ms"):
            b[k] += rb[k if k != "ops_tc_ms" else "ops_ms"]
        b["bound_ms"] = max(b["ops_ms"], b["bytes_ms"])
        b["bound_by"] = ("operations" if b["ops_ms"] >= b["bytes_ms"]
                         else "bytes")
        b["bound_tc_ms"] = max(b["ops_tc_ms"], b["bytes_ms"])
    return b


def readd_bound(J_fix):
    """Least work of one re-add launch: the block's J_fix frame rows (K,
    B+1) and the rank row read once, O', E' read and O, E written once;
    J_fix (B+1) K adds and 2 K B operations to form O, E."""
    from harmonypy_tpu_torch.utils.profiling import (PEAK_BYTES_S,
                                                     PEAK_FP32_FLOPS)
    B1 = N_BATCHES + 1
    nbytes = 4 * (J_fix * K * B1 + J_fix + 4 * K * N_BATCHES + N_BATCHES)
    flops = J_fix * K * B1 + 2 * K * N_BATCHES
    ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    return dict(flop=flops, bytes=nbytes, ops_ms=ops_ms, bytes_ms=bytes_ms,
                bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def _eq(a, b) -> bool:
    import torch
    return bool(torch.equal(a, b))


def allocations() -> int:
    """Allocations through torch's caching allocator so far, every card."""
    import torch
    return sum(torch.cuda.memory_stats(i).get("allocation.all.allocated", 0)
               for i in range(torch.cuda.device_count()))


class PassMeter:
    """Meter every mesh pass the engine and the replays run while active
    (the port's fused_estep_mesh, wrapped in engine and ops.replay): per
    pass the native calls (ops.cuda.fused_estep.native_calls), the
    caching-allocator allocations on every card and the plans made. A
    pass that makes no plan must allocate nothing; `summary(nb)` checks
    that and the native calls per pass (1 in one process, nb + 1 across
    processes: one per block and one for the last re-add)."""

    def __init__(self, fe):
        from harmonypy_tpu_torch import engine
        from harmonypy_tpu_torch.ops import replay
        self.fe, self.mods, self.passes = fe, (engine, replay), []

    def __enter__(self):
        fe, real = self.fe, self.fe.fused_estep_mesh

        def metered(*a, **kw):
            n0, p0, a0 = fe.native_calls, fe.plans_made, allocations()
            out = real(*a, **kw)
            self.passes.append((fe.native_calls - n0, allocations() - a0,
                                fe.plans_made - p0))
            return out
        for m in self.mods:
            m.fused_estep_mesh = metered
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m.fused_estep_mesh = self.fe.fused_estep_mesh

    def summary(self, nb: int, multi: bool, tag: str) -> dict:
        calls = sorted({c for c, _, _ in self.passes})
        later = [a for _, a, p in self.passes if not p]
        want = nb + 1 if multi else 1
        check(self.passes and calls == [want],
              f"{tag}: native calls per mesh pass {calls}, not {want}")
        check(max(later, default=0) == 0,
              f"{tag}: passes after a plan's first allocated "
              f"{max(later)} times (caching allocator)")
        return dict(passes=len(self.passes), native_calls_per_pass=want,
                    plans_made=sum(p for _, _, p in self.passes),
                    allocations_first_passes=sum(
                        a for _, a, p in self.passes if p),
                    allocations_per_pass_after_first=0,
                    passes_after_first=len(later))


def host_issue_ms(fn, sync, passes=MESH_HOST_PASSES) -> float:
    """The host's ms to issue fn() (median of `passes`, each synchronised
    apart by sync(), no profiler)."""
    issue = []
    for _ in range(passes):
        sync()
        t = time.perf_counter()
        fn()
        issue.append(time.perf_counter() - t)
    sync()
    return sorted(issue)[len(issue) // 2] * 1e3


def mesh_pass_profile(run, n_blocks, shards, passes=5):
    """`passes` calls of run() (one mesh pass each) under torch.profiler,
    after one warm-up: the host's ms to issue one pass and the wall ms per
    pass to the last synchronise, device-busy ms per pass (union of every
    kernel, copy and fill interval), the per-block kernel's device ms per
    launch (kernels named estep_*; n_blocks x shards per pass), the re-add
    kernel's, the other device operations per pass by name, and the host's
    waits per pass (CUDA runtime calls named *Synchronize, the profile's
    closing synchronise not counted)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    # A profile that did not record every per-block kernel is taken again,
    # at most four times (torch.profiler has dropped a session's kernel
    # records, all of them once in three runs of unchanged code and 7 of
    # 400 once; PERF.md §7).
    for _ in range(5):
        issue = []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(passes):
                t = time.perf_counter()
                run()
                issue.append(time.perf_counter() - t)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if sum(e.device_type == DeviceType.CUDA and "estep" in e.name
               for e in prof.events()) == passes * n_blocks * shards:
            break
    spans, block, readd, other, waits = [], [], [], {}, -1
    for e in prof.events():
        if e.device_type == DeviceType.CPU and "Synchronize" in e.name:
            waits += 1
        if (e.device_type != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        spans.append((e.time_range.start, e.time_range.end))
        us = e.time_range.elapsed_us()
        if "estep" in e.name:
            block.append(us)
        elif "readd" in e.name:
            readd.append(us)
        else:
            other[e.name[:80]] = other.get(e.name[:80], 0) + 1
    check(len(block) == passes * n_blocks * shards,
          f"profiled {len(block)} per-block kernels in {passes} passes, not "
          f"{passes * n_blocks * shards}")
    busy_ms = _union_us(spans) / 1e3
    return dict(
        passes=passes, host_issue_ms_per_pass=sorted(issue)[passes // 2]
        * 1e3, wall_ms_per_pass=wall * 1e3 / passes,
        device_busy_ms_per_pass=busy_ms / passes,
        device_idle_share=1.0 - busy_ms / (wall * 1e3),
        block_kernel_device_ms=sum(block) / len(block) / 1e3,
        block_kernel_device_ms_per_pass=sum(block) / passes / 1e3,
        readd_launches_per_pass=len(readd) / passes,
        readd_kernel_device_ms=(sum(readd) / len(readd) / 1e3
                                if readd else None),
        other_ops_per_pass=sum(other.values()) / passes,
        other_ops=dict(sorted(other.items(), key=lambda kv: -kv[1])[:12]),
        host_waits_per_pass=waits / passes)


def block_launch(fe, b, *args, **kw):
    """Block b of a round alone through the mesh pass's per-block launch
    (`_BlockLaunch(*args, **kw).launch(b)`); returns its block-removed O,
    E."""
    ln = fe._BlockLaunch(*args, **kw)
    ln.launch(b)
    return ln.removed(b)


def fold_chain_checks(fe, plain_mod, tabs, ZP3s, consts, O, E, fast, J_fix,
                      dtype=None):
    """A mesh pass driven block by block on one stream, twice: every shard's
    launch b > 0 starting from block b - 1's re-add in its prologue, and the
    unfolded launch from frame_readd of block b - 1 (the plain re-add, on
    the card). Each block's block-removed O, E and rows, then the pass's
    per-chunk rows and stored R (dtype), bitwise equal. Returns the blocks
    checked."""
    import torch
    S, (nb, J) = len(ZP3s), tabs.slots[0].shape
    Pr_b = consts[3]
    frame = torch.empty((2, S, J, K, N_BATCHES + 1), device="cuda")
    src = fe.rank_table(tabs.granks, J_fix, J, "cuda")
    start = torch.stack([O, E])

    def outs():
        return [tuple(torch.zeros(sh, device="cuda") for sh in (
            (z.shape[0], K, N_BATCHES + 1), (z.shape[0], K, N_PCS),
            (z.shape[0], 2))) for z in ZP3s]

    def r3s():
        return [None if dtype is None else torch.zeros(
            (z.shape[0], K, CHUNK), dtype=dtype, device="cuda")
            for z in ZP3s]
    of, orf, rf, rr = outs(), outs(), r3s(), r3s()
    fold = [fe._BlockLaunch(tabs.slots[s], tabs.removal, ZP3s[s], *consts,
                            O, E, fast, of[s], J_fix + 1, R3=rf[s],
                            brows=frame[:, s], frame=frame, src=src,
                            J_fix=J_fix) for s in range(S)]
    ref = [fe._BlockLaunch(tabs.slots[s], tabs.removal, ZP3s[s], *consts,
                           start[0], start[1], fast, orf[s], J_fix + 1,
                           R3=rr[s]) for s in range(S)]
    tag = f"fast_objective={fast}, R {dtype}"
    for b in range(nb):
        for s in range(S):
            fold[s].launch(b, b > 0)
            ref[s].launch(b)
        for s in range(S):
            check(all(_eq(x, y) for x, y in zip(fold[s].removed(b),
                                                 ref[s].removed(b)))
                  and _eq(frame[b & 1, s], ref[s].brows[b & 1]),
                  f"folded launch of block {b}, shard {s} differs from "
                  f"frame_readd + the unfolded launch ({tag})")
        start.copy_(torch.stack(plain_mod.frame_readd(
            [ln.brows[b & 1] for ln in ref], [g[b] for g in tabs.granks],
            *ref[0].removed(b), Pr_b, J_fix)))
    for s in range(S):
        check(all(_eq(x, y) for x, y in zip(of[s], orf[s]))
              and (dtype is None or _eq(rf[s], rr[s])),
              f"folded pass's per-chunk rows of shard {s} differ ({tag})")
    return nb - 1


def repeat_pass_checks(fe, tabs, ZP3s, consts, O, E, J_fix, want, dtype,
                       reps):
    """`reps` mesh passes through one plan (a mesh_plans block, as a fit
    runs them: shards on their own streams, the plan's outputs used in
    turn; a race on the double-buffered rows or O', E' shows here), each
    bitwise equal to the first; the first's O, E equal to want = (O, E) of
    the one-launch round. Returns (reps, plans made, allocations of the
    passes after the first)."""
    import torch
    first, p0 = None, fe.plans_made
    # A fit's O, E after its first pass are a pass's outputs, contiguous
    # (the init's O is a column slice: the pass copies such an O once).
    O, E = O.contiguous(), E.contiguous()
    with fe.mesh_plans():
        for _ in range(reps):
            R3s = (None if dtype is None else [torch.zeros(
                (z.shape[0], K, CHUNK), dtype=dtype, device="cuda")
                for z in ZP3s])
            a0 = allocations()
            m = fe.fused_estep_mesh(tabs, ZP3s, *consts, O, E, False, J_fix,
                                    R3s=R3s)
            got = [m[0], m[1], *m[2], *m[3], *m[4], *(R3s or ())]
            if first is None:
                first = [t.clone() for t in got]
                later = 0
                check(_eq(m[0], want[0]) and _eq(m[1], want[1]),
                      f"mesh pass (R {dtype}) differs from the one-launch "
                      f"round")
            else:
                later += allocations() - a0
                check(all(_eq(a, b) for a, b in zip(got, first)),
                      f"a repeated mesh pass (R {dtype}) is not bitwise the "
                      f"first")
    plans = fe.plans_made - p0
    check(plans == 1 and later == 0,
          f"{reps} passes of one geometry made {plans} plans and allocated "
          f"{later} times after the first")
    return dict(passes=reps, plans_made=plans,
                allocations_after_first=later)


def readd_launch(fe, rows, granks, Or, Er, Pr_b, J_fix):
    """One block's re-add by the re-add kernel (`_Readd(...).launch(0)`):
    rows[s] shard s's block rows, granks[s] (J_s,) their ranks."""
    import torch
    O, E = torch.empty_like(Or), torch.empty_like(Er)
    fe._Readd(rows, [g.reshape(1, -1) for g in granks], Or.contiguous(),
              Er.contiguous(), Pr_b, J_fix, O, E).launch(0)
    return O, E


def mesh_kernel_checks(mods, X, batches, mesh):
    """The per-block entry on the 858k round inputs cut into the mesh's
    shards: each shard's block-0 rows equal the one-launch round's rows
    bitwise (the global work split), the entry against its plain version
    at TOL (no r, r window, K2 fp32 and bf16), a bitwise repeat, and the
    mesh round (every shard, every block, the folded re-adds and the last
    block's re-add kernel) equal to the one-launch round bitwise for K1,
    its r window and K2; the folded launch of every block b > 0 equal to
    frame_readd plus the unfolded launch bitwise (K1, K2 fp32 and bf16);
    MESH_REPEATS passes of each bitwise equal; times, with and without the
    folded prologue."""
    import dataclasses

    import torch
    (config, engine, layout, partition, fe, plain_mod, state_mod) = mods
    from harmonypy_tpu_torch.parallel import sharding
    geom, args, (cfg, blocks, st) = round_inputs(mods, X, batches,
                                                 with_state=True)
    slots1, removal, ZP3, Y, sigma, theta, Pr_b, O, E = args
    D = mesh.size
    geomD = partition.partition_geometry(
        dataclasses.replace(cfg, n_devices=D))
    J1, nc = geom.J_fix + 1, geomD.nc_cap
    ZP3s = [sharding.extract_chunks(ZP3, s, geomD).contiguous()
            for s in range(D)]
    caches = [sharding.extract_chunks(st.cache, s, geomD) for s in range(D)]
    tabs = partition.mesh_round_tables(blocks, caches, geomD, mesh.devices)
    check(_eq(tabs.removal, removal), "mesh removal differs from the "
                                      "one-device removal")
    consts = (Y, sigma, theta, Pr_b)

    def outs(nc1):
        return (torch.zeros((nc1, K, N_BATCHES + 1), device="cuda"),
                torch.zeros((nc1, K, N_PCS), device="cuda"),
                torch.zeros((nc1, 2), device="cuda"))

    lo, width = 200, 16
    # Worst error against the plain version: K1's entry (no r, r window)
    # and K2's (fp32 and bf16 R), each its own.
    errs, worst = {}, dict(k1=0.0, k2=0.0, readd=0.0)
    folded, repeats = 0, {}
    for fast in (False, True):
        rnd = fe.fused_estep(*args, fast)
        rnd_w = fe.fused_estep(*args, fast, lo=lo, width=width)[5]
        tag = f"fast_objective={fast}"
        # Block 0 of every shard, under each tail: its rows are the
        # one-launch round's.
        for s, tail in [(s, t) for s in range(D) for t in fe.BLOCK_TAILS]:
            out = outs(nc + 1)
            Ob, Eb = block_launch(fe, 0, tabs.slots[s], removal, ZP3s[s],
                                  *consts, O, E, fast, out, J1, tail=tail)
            sl = tabs.slots[s][0].long()
            n_real = sharding.shard_chunks(nc, geom.NC_real, s)[1]
            sl = sl[sl < n_real]
            gid = s * nc + sl
            for name, a, b in zip(("cache", "ybuf", "kbuf"), out, rnd[2:5]):
                check(_eq(a[sl], b[gid]), f"per-block {name} rows of shard "
                                          f"{s} differ from the round's "
                                          f"({tag}, tail {tail})")
            check(_eq(Ob, O - removal[0][:, 1:])
                  and _eq(Eb, E - removal[0][:, 0:1] * Pr_b[None, :]),
                  f"per-block removed O/E of shard {s} ({tag}, tail {tail})")
        # The same entry on the one-device table (J = 22 slots).
        out1 = outs(geom.nc_cap + 1)
        block_launch(fe, 0, slots1, removal, ZP3, *consts, O, E, fast, out1,
                     J1)
        sl = slots1[0].long()
        check(all(_eq(a[sl], b[sl]) for a, b in zip(out1, rnd[2:5])),
              f"per-block rows on the one-device table differ ({tag})")
        # The one-pass entry's block-0 rows of every shard, under each
        # tail: the one-pass round's rows.
        rnd1 = fe.fused_estep(*args, fast, precision="default")
        for s, tail in [(s, t) for s in range(D) for t in fe.BLOCK_TAILS]:
            out = outs(nc + 1)
            block_launch(fe, 0, tabs.slots[s], removal, ZP3s[s], *consts, O,
                         E, fast, out, J1, precision="default", tail=tail)
            sl = tabs.slots[s][0].long()
            n_real = sharding.shard_chunks(nc, geom.NC_real, s)[1]
            sl = sl[sl < n_real]
            check(all(_eq(a[sl], b[s * nc + sl])
                      for a, b in zip(out, rnd1[2:5])),
                  f"one-pass per-block rows of shard {s} differ from the "
                  f"one-pass round's ({tag}, tail {tail})")
        m1 = fe.fused_estep_mesh(tabs, ZP3s, *consts, O, E, fast, geom.J_fix,
                                 precision="default")
        check(_eq(m1[0], rnd1[0]) and _eq(m1[1], rnd1[1])
              and all(_eq(partition.frame_rows(p_, geomD), f[: geom.nc_cap])
                      for p_, f in zip(m1[2:5], rnd1[2:5])),
              f"one-pass mesh round differs from the one-pass round ({tag})")
        del rnd1, m1
        # The one-pass entry's r of block 0 on shard 0 (its K2 fp32 store)
        # and the plain version's: the flip term of RHO's note.
        r1k = torch.zeros((nc + 1, K, CHUNK), device="cuda")
        r1p = torch.zeros_like(r1k)
        block_launch(fe, 0, tabs.slots[0], removal, ZP3s[0], *consts, O, E,
                     fast, outs(nc + 1), J1, R3=r1k, precision="default")
        plain_mod.fused_update_block(0, tabs.slots[0], removal, ZP3s[0],
                                     *consts, O, E, fast, outs(nc + 1),
                                     R3=r1p, one_pass=True)
        # Against the plain version, shard 0, every variant, each
        # precision.
        for var, prec in [(v, p) for p in PRECISIONS for v in (
                "round", "r_window", "float32", "bfloat16")]:
            one = prec == "default"
            kw, plain_kw = dict(precision=prec), dict(one_pass=one)
            if var == "r_window":
                kw.update(Rw=torch.zeros((width, K, CHUNK), device="cuda"),
                          lo=lo)
                plain_kw.update(Rw=torch.zeros_like(kw["Rw"]), lo=kw["lo"])
            elif var != "round":
                dt = getattr(torch, var)
                kw.update(R3=torch.zeros((nc + 1, K, CHUNK), dtype=dt,
                                         device="cuda"))
                plain_kw.update(R3=torch.zeros_like(kw["R3"]))
            ko, kp = outs(nc + 1), outs(nc + 1)
            k = block_launch(fe, 0, tabs.slots[0], removal, ZP3s[0],
                             *consts, O, E, fast, ko, J1, **kw)
            p_ = plain_mod.fused_update_block(0, tabs.slots[0], removal,
                                              ZP3s[0], *consts, O, E, fast,
                                              kp, **plain_kw)
            kw2 = {n: torch.zeros_like(v) if torch.is_tensor(v) else v
                   for n, v in kw.items()}
            ko2 = outs(nc + 1)
            ka = block_launch(fe, 0, tabs.slots[0], removal, ZP3s[0],
                              *consts, O, E, fast, ko2, J1, **kw2)
            check(all(_eq(a, b) for a, b in zip((*ka, *ko2, *(
                v for v in kw2.values() if torch.is_tensor(v))), (*k, *ko, *(
                    v for v in kw.values() if torch.is_tensor(v))))),
                  f"per-block {var} repeat not bitwise ({tag}, {prec})")
            kk = ("k1" if var in ("round", "r_window") else "k2") + (
                "_one" if one else "")
            if one:
                # Rows are the block's; O, E the block-removed ones.
                e1, _ = one_pass_errs(plain_mod, (k[0], k[1], *ko),
                                      (p_[0], p_[1], *kp), r1k, r1p,
                                      ZP3s[0], Pr_b, sigma, readded=False)
                if var == "r_window":
                    e1["r_window"] = diff(kw["Rw"], plain_kw["Rw"],
                                          TOL["r"][0] + RHO, TOL["r"][1])
                if "R3" in kw:
                    e1["R"] = diff(kw["R3"].float(), plain_kw["R3"].float(),
                                   TOL["r"][0] + RHO + (
                                       2.0 ** -8 if var == "bfloat16"
                                       else 0.0), TOL["r"][1])
                for name, e in e1.items():
                    if name in ("O", "E", "cache", "ybuf", "kbuf", "r",
                                "r_window", "R"):
                        worst[kk] = max(worst.get(kk, 0.0), e[0])
                    errs[f"{var},{tag},{prec},{name}"] = e[0]
                    check(e[2] <= 1.0, f"one-pass per-block {var} vs plain "
                                       f"{name} beyond its bound ({tag}): "
                                       f"{e1}")
                continue
            pairs = list(zip(("O", "E", "cache", "ybuf", "kbuf"),
                             (k[0], k[1], *ko), (p_[0], p_[1], *kp)))
            if var == "r_window":
                pairs.append(("r", kw["Rw"], plain_kw["Rw"]))
            for name, a, b in pairs:
                e = diff(a, b, *TOL[name])
                worst[kk] = max(worst[kk], e[0])
                errs[f"{var},{tag},{name}"] = e[0]
                check(e[2] <= 1.0, f"per-block {var} vs plain {name} beyond "
                                   f"{TOL[name]} ({tag}): {e}")
            if "R3" in kw:
                if var == "bfloat16":
                    ulps = bf16_ulps(kw["R3"], plain_kw["R3"])
                    check(ulps <= 1, f"per-block bf16 R vs plain: {ulps} "
                                     f"ulps ({tag})")
                else:
                    e = diff(kw["R3"], plain_kw["R3"], *TOL["r"])
                    worst[kk] = max(worst[kk], e[0])
                    check(e[2] <= 1.0, f"per-block K2 R vs plain ({tag})")
        # The re-add kernel against its plain version, bitwise, on block
        # 0's rows of every shard (from the per-block launches above).
        rows, grk = [], []
        for s in range(D):
            out = outs(nc + 1)
            block_launch(fe, 0, tabs.slots[s], removal, ZP3s[s], *consts,
                         O, E, fast, out, J1)
            rows.append(out[0][tabs.slots[s][0].long()])
            grk.append(tabs.granks[s][0])
        Or = O - removal[0][:, 1:]
        Er = E - removal[0][:, 0:1] * Pr_b[None, :]
        rk = readd_launch(fe, rows, grk, Or, Er, Pr_b, geom.J_fix)
        rp = plain_mod.frame_readd(rows, grk, Or, Er, Pr_b, geom.J_fix)
        worst["readd"] = max(worst["readd"], *(
            float((a - b).abs().max()) for a, b in zip(rk, rp)))
        check(_eq(rk[0], rp[0]) and _eq(rk[1], rp[1]),
              f"re-add kernel differs from frame_readd ({tag})")
        # The mesh round (per-block and re-add kernels) against the
        # one-launch round, bitwise.
        wins = [(lo - s * nc, width)
                if sharding.window_rows(geomD, s, lo, width)[2] else None
                for s in range(D)]
        m = fe.fused_estep_mesh(tabs, ZP3s, *consts, O, E, fast, geom.J_fix,
                                windows=wins)
        check(_eq(m[0], rnd[0]) and _eq(m[1], rnd[1]),
              f"mesh round O/E differ from the round's ({tag})")
        for name, parts_, full in zip(("cache", "ybuf", "kbuf"), m[2:5],
                                      rnd[2:5]):
            check(_eq(partition.frame_rows(parts_, geomD),
                      full[: geom.nc_cap]),
                  f"mesh round {name} rows differ ({tag})")
        for s, Rw in enumerate(m[5]):
            if Rw is None:
                continue
            l0, p0, n = sharding.window_rows(geomD, s, lo, width)
            check(_eq(Rw[p0: p0 + n], rnd_w[p0: p0 + n]),
                  f"mesh round r window of shard {s} differs ({tag})")
        for dt in (torch.float32, torch.bfloat16):
            R3 = torch.zeros((geom.nc_cap + 1, K, CHUNK), dtype=dt,
                             device="cuda")
            k2 = fe.fused_estep_r(slots1, removal, ZP3, R3, *consts, O, E,
                                  fast)
            R3s = [torch.zeros((nc + 1, K, CHUNK), dtype=dt, device="cuda")
                   for _ in range(D)]
            m2 = fe.fused_estep_mesh(tabs, ZP3s, *consts, O, E, fast,
                                     geom.J_fix, R3s=R3s)
            check(_eq(m2[0], k2[1]) and _eq(m2[1], k2[2])
                  and _eq(partition.frame_rows(R3s, geomD),
                          R3[: geom.nc_cap]),
                  f"mesh K2 round ({dt}) differs from the round's ({tag})")
            folded += fold_chain_checks(fe, plain_mod, tabs, ZP3s, consts,
                                        O, E, fast, geom.J_fix, dt)
            if not fast:
                repeats[str(dt)] = repeat_pass_checks(
                    fe, tabs, ZP3s, consts, O, E, geom.J_fix, k2[1:3], dt,
                    MESH_REPEATS)
        folded += fold_chain_checks(fe, plain_mod, tabs, ZP3s, consts, O, E,
                                    fast, geom.J_fix)
        if not fast:
            repeats["K1"] = repeat_pass_checks(
                fe, tabs, ZP3s, consts, O, E, geom.J_fix, rnd[:2], None,
                MESH_REPEATS)
        del rnd, m
    # Times: one per-block launch (shard 0, its block b > 0 with the most
    # real cells), K1 and K2 fp32, without and with the folded re-add in
    # its prologue (in turns: without, with, with, without): the launch the
    # mesh pass issues (checks and scratch once, then launch(b) back to
    # back) by CUDA events, and its kernel's device time alone (profiler);
    # the plain version (fused_update_block; with the fold,
    # fused_update_block_folded); the re-add kernel (launch(b) back to
    # back) and its plain version; one mesh round (every shard and block)
    # by CUDA events and under the profiler.
    out = outs(nc + 1)
    R3 = torch.zeros((nc + 1, K, CHUNK), device="cuda")
    cells = ZP3s[0][tabs.slots[0].long(), 0, :].sum(dim=(1, 2))
    bt = 1 + int(torch.argmax(cells[1:]))
    n_cells = int(cells[bt])
    n_slots = int(torch.unique(tabs.slots[0][bt]).numel())
    _zero_counts(fe)
    J = tabs.slots[0].shape[1]
    # Each variant's launches, the fp32 one and the one-pass one, with its
    # own frame (the fold reads block bt - 1's rows of its own variant).
    frames = {p: torch.zeros((2, D, J, K, N_BATCHES + 1), device="cuda")
              for p in PRECISIONS}
    src = fe.rank_table(tabs.granks, geom.J_fix, J, "cuda")
    args0 = (tabs.slots[0], removal, ZP3s[0], *consts, O, E, False, out, J1)
    R3s1 = {p: torch.zeros((nc + 1, K, CHUNK), device="cuda")
            for p in PRECISIONS}
    R3s1["float32"] = R3
    lns = {}
    for prec in PRECISIONS:
        fold_kw = dict(brows=frames[prec][:, 0], frame=frames[prec], src=src,
                       J_fix=geom.J_fix, precision=prec)
        sfx = "" if prec == "float32" else "_one"
        lns["k1" + sfx] = fe._BlockLaunch(*args0, **fold_kw)
        lns["k2" + sfx] = fe._BlockLaunch(*args0, R3=R3s1[prec], **fold_kw)
    for x in lns.values():  # block bt - 1's rows, O', E' for the fold
        x.launch(bt - 1)
    ms = {}
    for fold in (False, True, True, False):
        for name, x in lns.items():
            ms.setdefault((name, fold), []).append(
                cuda_ms(lambda: x.launch(bt, fold), reps=200))
    ms = {key: sum(v) / len(v) for key, v in ms.items()}
    # Device ms per kernel the profiler recorded (it may drop a few of the
    # 50 back-to-back launches' events).
    dev = {}
    for fold in (False, True):
        for name, x in lns.items():
            t, per = device_ms(lambda: x.launch(bt, fold), reps=50)
            check(0 < per <= 1, f"profiled {per} kernels per per-block "
                                f"launch ({name}, fold {fold})")
            dev[name, fold] = t / per
    ln = lns["k1"]
    frame = frames["float32"]
    rows_prev = [frame[(bt - 1) & 1, s] for s in range(D)]
    prev = (rows_prev, [g[bt - 1] for g in tabs.granks], geom.J_fix)
    Op, Ep = ln.removed(bt - 1)
    plain_ms = cuda_ms(lambda: plain_mod.fused_update_block(
        bt, *args0[:-1]), reps=10)
    plain_ms_k2 = cuda_ms(lambda: plain_mod.fused_update_block(
        bt, *args0[:-1], R3=R3), reps=10)
    plain_ms_fold = cuda_ms(lambda: plain_mod.fused_update_block_folded(
        bt, *args0[:7], Op, Ep, False, out, prev=prev), reps=10)
    plain_ms_fold_k2 = cuda_ms(lambda: plain_mod.fused_update_block_folded(
        bt, *args0[:7], Op, Ep, False, out, prev=prev, R3=R3), reps=10)
    # The one-pass plain versions, from the one-pass variant's block bt - 1.
    rows1 = [frames["default"][(bt - 1) & 1, s] for s in range(D)]
    prev1 = (rows1, prev[1], geom.J_fix)
    Op1, Ep1 = lns["k1_one"].removed(bt - 1)
    plain_one = dict(
        fold=cuda_ms(lambda: plain_mod.fused_update_block_folded(
            bt, *args0[:7], Op1, Ep1, False, out, prev=prev1,
            one_pass=True), reps=10),
        fold_k2=cuda_ms(lambda: plain_mod.fused_update_block_folded(
            bt, *args0[:7], Op1, Ep1, False, out, prev=prev1,
            R3=R3s1["default"], one_pass=True), reps=10))
    n_launch = 1 + 4 * (2 + 200) + 2 * (1 + 50)
    check(fe.launches_block == 2 * n_launch
          and fe.launches_block_write_r == 2 * n_launch
          and fe.launches_block_one_pass == n_launch
          and fe.launches_block_write_r_one_pass == n_launch,
          f"per-block launches counted {fe.launches_block}, "
          f"{fe.launches_block_write_r} (one pass "
          f"{fe.launches_block_one_pass}, "
          f"{fe.launches_block_write_r_one_pass}), not {2 * n_launch} "
          f"({n_launch})")
    rd_rows = [torch.zeros((int(t.shape[1]), K, N_BATCHES + 1),
                           device="cuda") for t in tabs.slots]
    Od, Ed = torch.empty_like(O), torch.empty_like(E)
    rd = fe._Readd(rd_rows, tabs.granks, Op, Ep, Pr_b, geom.J_fix, Od, Ed)
    ms_readd = cuda_ms(lambda: rd.launch(bt), reps=200)
    plain_ms_readd = cuda_ms(lambda: plain_mod.frame_readd(
        rd_rows, [g[bt] for g in tabs.granks], Op, Ep, Pr_b, geom.J_fix),
        reps=20)
    n0, r0, c0 = fe.launches_block, fe.launches_readd, fe.native_calls

    def mesh_pass():
        return fe.fused_estep_mesh(tabs, ZP3s, *consts, O, E, False,
                                   geom.J_fix)
    # Timed as a fit runs it: through its plan, made on the first pass.
    with fe.mesh_plans():
        ms_pass = cuda_ms(mesh_pass, reps=5, warmup=1)
        per_pass = (fe.launches_block - n0) // 6
        readd_per_pass = (fe.launches_readd - r0) / 6
        calls_per_pass = (fe.native_calls - c0) / 6
        check(per_pass == geom.nb * D and readd_per_pass == 1
              and calls_per_pass == 1,
              f"mesh round launched {per_pass} per-block and "
              f"{readd_per_pass} re-add kernels in {calls_per_pass} native "
              f"calls per pass, not {geom.nb * D}, 1 and 1")
    # The pass profiled in a process of its own (mesh_timing): after the
    # profiler sessions of the earlier phases, torch.profiler dropped 7-9
    # of a mesh profile's 400 per-block kernel records in this process.
    timing = mesh_timing_run(HERE)
    prof = timing["pass_profile"]
    check(prof["readd_launches_per_pass"] == 1,
          f"profiled {prof['readd_launches_per_pass']} re-add kernels per "
          f"pass, not 1")
    b1, b2 = block_bound(n_cells, n_slots), block_bound(n_cells, n_slots, 4)
    bf1 = block_bound(n_cells, n_slots, 0, geom.J_fix)
    bf2 = block_bound(n_cells, n_slots, 4, geom.J_fix)
    bf1_one = block_bound(n_cells, n_slots, 0, geom.J_fix, one_pass=True)
    bf2_one = block_bound(n_cells, n_slots, 4, geom.J_fix, one_pass=True)
    br = readd_bound(geom.J_fix)
    return dict(
        shape=dict(shards=D, N_shard_real=geomD.nc_cap * CHUNK,
                   nc_cap=geomD.nc_cap, J_shard=geomD.J_shard, J_glob=J1,
                   units_per_slot=lns["k1"].n_units // J, tail=lns["k1"].tail,
                   clusters_at_once={p: fe._block_lib(p == "default")
                                     .fused_estep_block_clusters(
                                         K, N_BATCHES, N_PCS,
                                         lns["k1"].n_units // J)
                                     for p in PRECISIONS}),
        rows_equal_round=True, repeat_bitwise=True, readd_bitwise=True,
        mesh_round_equals_round=True, max_abs=errs,
        folded_blocks_bitwise=folded, repeated_passes_bitwise=repeats,
        timed_block=bt, ms_block=ms["k1", False],
        ms_block_write_r=ms["k2", False], ms_block_fold=ms["k1", True],
        ms_block_write_r_fold=ms["k2", True],
        device_ms_block=dev["k1", False],
        device_ms_block_write_r=dev["k2", False],
        device_ms_block_fold=dev["k1", True],
        device_ms_block_write_r_fold=dev["k2", True],
        plain_ms_block=plain_ms, plain_ms_block_write_r=plain_ms_k2,
        plain_ms_block_fold=plain_ms_fold,
        plain_ms_block_write_r_fold=plain_ms_fold_k2,
        ms_readd=ms_readd, plain_ms_readd=plain_ms_readd,
        ms_per_pass=ms_pass, launches_per_pass=per_pass,
        readd_launches_per_pass=readd_per_pass,
        native_calls_per_pass=calls_per_pass, pass_profile=prof,
        timing_process=timing,
        bound_block=b1, bound_block_write_r=b2, bound_block_fold=bf1,
        bound_block_write_r_fold=bf2, bound_readd=br,
        one_pass=dict(
            ms_block=ms["k1_one", False], ms_block_write_r=ms["k2_one", False],
            ms_block_fold=ms["k1_one", True],
            ms_block_write_r_fold=ms["k2_one", True],
            device_ms_block_fold=dev["k1_one", True],
            device_ms_block_write_r_fold=dev["k2_one", True],
            plain_ms_block_fold=plain_one["fold"],
            plain_ms_block_write_r_fold=plain_one["fold_k2"],
            bound_block_fold=bf1_one, bound_block_write_r_fold=bf2_one,
            roofline_share_block_fold=bf1_one["bound_ms"]
            / ms["k1_one", True]),
        roofline_share_block=b1["bound_ms"] / ms["k1", False],
        roofline_share_block_device=b1["bound_ms"] / dev["k1", False],
        roofline_share_block_fold=bf1["bound_ms"] / ms["k1", True],
        roofline_share_block_tc=b1["bound_tc_ms"] / ms["k1", False]), worst


def mesh_cards_round_checks(mods, X, batches, mesh):
    """The mesh round on `mesh`, real cards whose lead need not be the
    current device: K1 with r windows and K2 fp32 bitwise equal to the
    one-launch round on cuda:0 (streams, events and copies between cards
    order every launch); ms per pass on the host's clock, every card
    synchronised."""
    import dataclasses

    import torch
    (config, engine, layout, partition, fe, plain_mod, state_mod) = mods
    from harmonypy_tpu_torch.parallel import sharding
    geom, args, (cfg, blocks, st) = round_inputs(mods, X, batches,
                                                 with_state=True)
    D, lead, devs = mesh.size, mesh.lead, mesh.devices
    geomD = partition.partition_geometry(
        dataclasses.replace(cfg, n_devices=D))
    nc = geomD.nc_cap
    ZP3s = [sharding.extract_chunks(args[2], s, geomD).to(dv).contiguous()
            for s, dv in enumerate(devs)]
    # The round's blocks on the lead card, as the engine draws them there.
    tabs = partition.mesh_round_tables(
        blocks.to(lead), [sharding.extract_chunks(st.cache, s, geomD).to(dv)
                          for s, dv in enumerate(devs)], geomD, devs)
    consts = [t.to(lead) for t in args[3:]]
    lo, width = 200, 16
    rnd = fe.fused_estep(*args, False, lo=lo, width=width)
    wins = [(lo - s * nc, width)
            if sharding.window_rows(geomD, s, lo, width)[2] else None
            for s in range(D)]
    m = fe.fused_estep_mesh(tabs, ZP3s, *consts, False, geom.J_fix,
                            windows=wins)
    check(_eq(m[0].cpu(), rnd[0].cpu()) and _eq(m[1].cpu(), rnd[1].cpu()),
          f"mesh round on {devs}: O/E differ from the round's")
    for name, parts_, full in zip(("cache", "ybuf", "kbuf"), m[2:5],
                                  rnd[2:5]):
        check(_eq(partition.frame_rows(parts_, geomD).cpu(),
                  full[: geom.nc_cap].cpu()),
              f"mesh round on {devs}: {name} rows differ")
    for s, Rw in enumerate(m[5]):
        if Rw is not None:
            l0, p0, n = sharding.window_rows(geomD, s, lo, width)
            check(_eq(Rw[p0: p0 + n].cpu(), rnd[5][p0: p0 + n].cpu()),
                  f"mesh round on {devs}: r window of shard {s} differs")
    R3 = torch.zeros((geom.nc_cap + 1, K, CHUNK), device="cuda")
    k2 = fe.fused_estep_r(args[0], args[1], args[2], R3, *args[3:], False)
    R3s = [torch.zeros((nc + 1, K, CHUNK), device=dv) for dv in devs]
    m2 = fe.fused_estep_mesh(tabs, ZP3s, *consts, False, geom.J_fix,
                             R3s=R3s)
    check(_eq(m2[0].cpu(), k2[1].cpu()) and _eq(m2[1].cpu(), k2[2].cpu())
          and _eq(partition.frame_rows(R3s, geomD).cpu(),
                  R3[: geom.nc_cap].cpu()),
          f"mesh K2 round on {devs} differs from the round's")

    def sync():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    def mesh_pass():
        fe.fused_estep_mesh(tabs, ZP3s, *consts, False, geom.J_fix)
    with fe.mesh_plans():
        mesh_pass()
        sync()
        t0 = time.perf_counter()
        for _ in range(5):
            mesh_pass()
        sync()
        ms = (time.perf_counter() - t0) * 200
    return dict(devices=[str(dv) for dv in devs],
                current_device=torch.cuda.current_device(),
                round_bitwise=True, write_r_bitwise=True,
                ms_per_pass_host_clock=ms)


# The mesh fits of mesh_fit_checks: the default deferred, stored and
# low_memory fits (the one-pass kernels), and the deferred and stored fits
# under "float32" (3xTF32) where refs holds their one-device fits.
MESH_FITS = (("deferred", {}), ("stored", dict(defer_r=False)),
             ("low_memory", dict(defer_r=False, low_memory=True)),
             ("deferred_float32", dict(matmul_precision="float32")),
             ("stored_float32", dict(defer_r=False,
                                     matmul_precision="float32")))


def mesh_fit_checks(ht, fe, X, meta, mesh, refs):
    """The fits of MESH_FITS that refs holds on `mesh`, each with every
    launch count set to 0 just before it (the one-pass launches all of a
    default fit's, none of a float32 fit's):
    Z_corr, R, the five histories and kmeans_rounds bitwise equal to the
    one-device fit refs[name]; per-block launches = blocks x shards per
    pass (deferred: every round and replay window; stored: every round),
    one re-add launch per pass (after its last block), and no one-launch
    round; each
    card's peak allocation during the fit
    (above what it held before) at most memory_envelope(cfg, the shards it
    holds). Returns (results, launch counts, the deferred fit)."""
    import collections

    import numpy as np
    import torch
    from harmonypy_tpu_torch.utils.memory import memory_envelope
    out, counts = {}, {}
    cards = collections.Counter(mesh.devices)
    for name, kw in MESH_FITS:
        if name not in refs:
            continue
        torch.cuda.synchronize()
        base = {}
        for dv in cards:
            torch.cuda.reset_peak_memory_stats(dv)
            base[dv] = torch.cuda.memory_allocated(dv)
        _zero_counts(fe)
        t0 = time.perf_counter()
        ho = ht.run_harmony(X, meta, ["batch"], mesh=mesh, verbose=False,
                            **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _counts(fe)
        one = _one_pass_counts(fe)
        check(one == (got[:4] if "float32" not in name else (0,) * 4),
              f"mesh {name}: one-pass launches {one} of {got[:4]}")
        memory = {}
        for dv, shards in cards.items():
            peak = torch.cuda.max_memory_allocated(dv) - base[dv]
            env = memory_envelope(ho.cfg, shards)
            check(env["total"] >= peak,
                  f"mesh {name} on {dv} ({shards} shards): modeled "
                  f"{env['total']} < measured peak {peak}")
            memory[str(dv)] = dict(shards=shards, modeled_bytes=env["total"],
                                   measured_peak=peak,
                                   ratio=env["total"] / peak,
                                   peak_phase=env["peak_phase"])
        nb = ho.cfg.n_blocks
        passes, rounds = ho.state.n_passes, sum(ho.kmeans_rounds)
        want = ((0, 0, nb * mesh.size * passes, 0, passes)
                if name.startswith("deferred")
                else (0, 0, 0, nb * mesh.size * rounds, rounds))
        check(got == want and max(got) > 0,
              f"mesh {name}: launches (K1, K2, K1 per-block, K2 per-block, "
              f"re-add) {got}, expected {want}")
        ref = refs[name]
        for a in ("Z_corr", "R") + HIST:
            check(np.array_equal(np.asarray(getattr(ho, a)),
                                 np.asarray(getattr(ref, a))),
                  f"mesh {name}: {a} differs from the one-device fit")
        out[name] = dict(wall_s=wall, kmeans_rounds=ho.kmeans_rounds,
                         passes=passes, launches=dict(zip(
                             ("k1", "k2", "k1_block", "k2_block", "readd"),
                             got)),
                         bitwise_equal_one_device=True, memory=memory)
        counts[name] = got
        if name == "deferred":
            mesh_ho = ho
    return out, counts, mesh_ho


def mesh_path_checks(ht, fe, X, batches, groups, meta, mesh, refs,
                     lisi_ref):
    """On `mesh`: the three 858k fits bitwise (mesh_fit_checks); the
    per-cell pbmc fit against one device at 3 harmony iterations: within
    TOL_PERCELL_REL under "float32", and under "default" with every round
    pinned (PINNED) within percell_flip_bound; at default settings at the
    golden gate (every distance recorded); compute_lisi on
    the mesh fit's output bitwise equal to lisi_ref = (one-device values,
    sampled brute values, sampled ids); a checkpoint resume bitwise and a
    resume on another mesh size refused. Returns (results, launch
    counts)."""
    import tempfile

    import numpy as np
    from harmonypy_tpu_torch.parallel.mesh import make_mesh
    fits, counts, mesh_ho = mesh_fit_checks(ht, fe, X, meta, mesh, refs)
    # Each pass of two short fits metered: native calls, allocations and
    # plans (kept apart from the timed fits above).
    metered = {}
    for name, kw in (("deferred", {}), ("stored", dict(defer_r=False))):
        with PassMeter(fe) as meter:
            ho = ht.run_harmony(X, meta, ["batch"], mesh=mesh, verbose=False,
                                max_iter_harmony=2, **kw)
        metered[name] = meter.summary(ho.cfg.n_blocks, False,
                                      f"mesh {name} on {mesh.devices}")
        check(metered[name]["plans_made"] == (2 if name == "deferred"
                                              else 1),
              f"mesh {name}: {metered[name]['plans_made']} plans made")

    # pbmc_3500 at default settings: the per-cell fit. Held at 3 harmony
    # iterations under "float32", as tests/test_fused_xla.py:135-150 holds
    # it (fp32 products, on the CPU): every round of those runs (20 each),
    # so no convergence test decides the round count from objectives that
    # differ in the last bits. Under "default" the products take bf16
    # operands: a shard sum's last-bit difference can flip an operand's
    # rounding by one bf16 ulp, and at the default tolerances the rounds
    # differ. So under "default" every round and iteration is pinned to run
    # (PINNED), both fits take the same branches, and the mesh's drift is
    # held at percell_flip_bound. The unpinned 3-iteration fit is recorded,
    # and the default fit is held at the golden gate.
    per_cell = {}
    for iters, prec, pin in ((3, "float32", False), (3, "default", True),
                             (3, "default", False),
                             (None, "default", False)):
        kw = dict(matmul_precision=prec, **(PINNED if pin else {}))
        if iters is not None:
            kw["max_iter_harmony"] = iters
        ho1, r1, _ = golden_fit(ht, **kw)
        hoD, rD, fit_s = golden_fit(ht, mesh=mesh, **kw)
        check(not hoD.cfg.fused_estep and hoD.cfg.n_devices == mesh.size,
              f"pbmc mesh: unexpected config {hoD.cfg}")
        scale = float(np.abs(ho1.Z_corr).max())
        pc_err = float(np.abs(hoD.Z_corr - ho1.Z_corr).max())
        rec = dict(max_abs=pc_err, max_abs_over_max_Z=pc_err / scale,
                   min_pc_r=min(rD), min_pc_r_one_device=min(r1),
                   fit_s=fit_s, kmeans_rounds=hoD.kmeans_rounds,
                   kmeans_rounds_one_device=ho1.kmeans_rounds)
        if iters is None:
            check(min(rD) >= 0.99, f"per-cell mesh golden min r {min(rD)}")
            rec["gate"] = "golden min r >= 0.99"
        elif prec == "float32":
            check(pc_err <= TOL_PERCELL_REL * scale,
                  f"per-cell mesh vs one device {pc_err} > "
                  f"{TOL_PERCELL_REL} x {scale} (rounds "
                  f"{hoD.kmeans_rounds} vs {ho1.kmeans_rounds})")
            rec["gate"] = f"max_abs <= {TOL_PERCELL_REL} max|Z|"
        elif pin:
            check(hoD.kmeans_rounds == ho1.kmeans_rounds
                  == [DEFAULTS_KMEANS] * iters,
                  f"pinned per-cell fits: rounds {hoD.kmeans_rounds} and "
                  f"{ho1.kmeans_rounds}")
            bound = percell_flip_bound(ho1, golden_fit(
                ht, **dict(kw, matmul_precision="float32"))[0])
            check(pc_err <= bound,
                  f"pinned per-cell mesh vs one device under 'default' "
                  f"{pc_err} > {bound}, one-pass rounding's own effect")
            rec.update(gate="max_abs <= max|Z_default - Z_float32| on one "
                            "device (percell_flip_bound)", bound=bound,
                       bound_over_max_Z=bound / scale, pinned=True)
        name = "default" if iters is None else f"max_iter_harmony={iters}"
        per_cell[f"{prec}/{name}" + ("/pinned" if pin else "")] = rec

    # LISI on the mesh fit's Z_corr.
    lisi1, sv, sidx = lisi_ref
    labels = ["batch", "group"]
    meta_l = lisi_meta(batches, groups)
    Z = mesh_ho.Z_corr
    lm, lisi_ms = _timed(lambda: ht.compute_lisi(Z, meta_l, labels, 30,
                                                 mesh=mesh))
    check(np.array_equal(lm, lisi1), "mesh LISI (pruned) differs from "
                                     "one device")
    (sm, sim), brute_ms = _timed(lambda: ht.compute_lisi(
        Z, meta_l, labels, 30, sample=LISI_SAMPLE, knn="brute", mesh=mesh))
    check(np.array_equal(sim, sidx) and np.array_equal(sm, sv),
          "mesh LISI (brute, sampled) differs from one device")

    # Checkpoint resume on the mesh; another mesh size refused.
    pcs, pmeta, _ = pbmc_inputs()
    args = dict(verbose=False, chunk_size=128, max_iter_harmony=3)
    other = make_mesh([mesh.lead] * (3 if mesh.size == 2 else 2))
    with tempfile.TemporaryDirectory() as td:
        full = ht.run_harmony(pcs, pmeta, ["donor"], mesh=mesh,
                              checkpoint_dir=td, **args)
        path = os.path.join(td, "harmony_iter_1.npz")
        resumed = ht.run_harmony(pcs, pmeta, ["donor"], mesh=mesh,
                                 resume_from=path, **args)
        for a in ("Z_corr", "R") + HIST:
            check(np.array_equal(np.asarray(getattr(full, a)),
                                 np.asarray(getattr(resumed, a))),
                  f"mesh checkpoint: resumed {a} differs")
        try:
            ht.run_harmony(pcs, pmeta, ["donor"], mesh=other,
                           resume_from=path, **args)
            raise RuntimeError(f"chip_smoke: a resume on a {other.size}-"
                               f"shard mesh did not raise")
        except ValueError as e:
            check("mesh:" in str(e), f"mesh resume: unexpected message {e}")
    return dict(
        devices=[str(dv) for dv in mesh.devices], fits=fits,
        metered_passes=metered, per_cell=dict(
            data="pbmc_3500", tolerance_over_max_Z=TOL_PERCELL_REL,
            fits=per_cell),
        lisi=dict(pruned_bitwise=True, brute_sample_bitwise=True,
                  queries=LISI_SAMPLE, ms=lisi_ms, brute_ms=brute_ms),
        checkpoint=dict(resume_bitwise=True,
                        other_mesh_size_raises=other.size)), counts


def lisi_meta(batches, groups):
    import pandas as pd
    return pd.DataFrame({
        "batch": pd.Categorical.from_codes(
            batches, [f"b{i}" for i in range(N_BATCHES)]),
        "group": pd.Categorical.from_codes(
            groups, [f"g{i}" for i in range(N_GROUPS)])})


def phase_mesh(ht, mods, X, batches, groups, meta, refs, lisi_ref):
    """The device mesh on MESH_SHARDS logical shards of the card: the
    per-block entry (mesh_kernel_checks) and mesh_path_checks; the latter
    also on a mesh of the real cards when there are several. Returns the
    kernels line's numbers of the per-block entry."""
    import torch
    from harmonypy_tpu_torch.parallel.mesh import make_mesh
    fe = mods[4]
    mesh = make_mesh(["cuda:0"] * MESH_SHARDS)
    kinfo, worst = mesh_kernel_checks(mods, X, batches, mesh)
    res, counts = mesh_path_checks(ht, fe, X, batches, groups, meta, mesh,
                                   refs, lisi_ref)
    cards = torch.cuda.device_count()
    real = f"skipped: {cards} card"
    if cards > 1:
        real = mesh_path_checks(ht, fe, X, batches, groups, meta, make_mesh(),
                                refs, lisi_ref)[0]
        # The lead card is not the current device (cuda:0).
        real["lead_not_current"] = mesh_cards_round_checks(
            mods, X, batches,
            make_mesh([f"cuda:{i}" for i in reversed(range(cards))]))
    emit(dict(phase="mesh", shards=MESH_SHARDS, kernel=kinfo,
              kernel_tolerance=TOL, **res, real_cards=real))
    # The per-block entries as a pass runs them for every block but its
    # first: with the previous block's re-add in the prologue. The 3xTF32
    # entries' launches are the float32 mesh fits', the one-pass entries'
    # the default fits'.
    one = kinfo["one_pass"]
    return dict(
        k1=dict(launches=counts["deferred_float32"][2],
                ms=kinfo["ms_block_fold"],
                plain_ms=kinfo["plain_ms_block_fold"],
                max_abs_err=worst["k1"],
                bound_ms=kinfo["bound_block_fold"]["bound_ms"],
                bound_by=kinfo["bound_block_fold"]["bound_by"]),
        k2=dict(launches=counts["stored_float32"][3],
                ms=kinfo["ms_block_write_r_fold"],
                plain_ms=kinfo["plain_ms_block_write_r_fold"],
                max_abs_err=worst["k2"],
                bound_ms=kinfo["bound_block_write_r_fold"]["bound_ms"],
                bound_by=kinfo["bound_block_write_r_fold"]["bound_by"]),
        k1_one=dict(launches=counts["deferred"][2], ms=one["ms_block_fold"],
                    plain_ms=one["plain_ms_block_fold"],
                    max_abs_err=worst["k1_one"],
                    bound_ms=one["bound_block_fold"]["bound_ms"],
                    bound_by=one["bound_block_fold"]["bound_by"]),
        k2_one=dict(launches=counts["stored"][3],
                    ms=one["ms_block_write_r_fold"],
                    plain_ms=one["plain_ms_block_write_r_fold"],
                    max_abs_err=worst["k2_one"],
                    bound_ms=one["bound_block_write_r_fold"]["bound_ms"],
                    bound_by=one["bound_block_write_r_fold"]["bound_by"]),
        readd=dict(launches=counts["deferred"][4], ms=kinfo["ms_readd"],
                   plain_ms=kinfo["plain_ms_readd"],
                   max_abs_err=worst["readd"],
                   bound_ms=kinfo["bound_readd"]["bound_ms"],
                   bound_by=kinfo["bound_readd"]["bound_by"]))


# Multi-process runs (phase multiprocess): worker processes of this script,
# each with a time limit; a collective waits at most MP_COLLECTIVE_S.
MP_WORKER_S, MP_COLLECTIVE_S = 420, 300


def digest(a) -> str:
    """sha256 of an array's dtype, shape and bytes: bitwise equality of two
    results compared across processes without moving them."""
    import hashlib

    import numpy as np
    a = np.ascontiguousarray(np.asarray(a))
    h = hashlib.sha256(f"{a.dtype}{a.shape}".encode())
    h.update(a.tobytes())
    return h.hexdigest()[:32]


def fit_digests(ho) -> dict:
    """digest of Z_corr, R, the five histories and kmeans_rounds."""
    return {a: digest(getattr(ho, a)) for a in ("Z_corr", "R") + HIST}


def _counts(fe):
    return (fe.launches, fe.launches_write_r, fe.launches_block,
            fe.launches_block_write_r, fe.launches_readd)


def _one_pass_counts(fe):
    """The one-pass launches among _counts' first four."""
    return (fe.launches_one_pass, fe.launches_write_r_one_pass,
            fe.launches_block_one_pass, fe.launches_block_write_r_one_pass)


def _zero_counts(fe):
    fe.launches = fe.launches_write_r = 0
    fe.launches_block = fe.launches_block_write_r = fe.launches_readd = 0
    fe.launches_one_pass = fe.launches_write_r_one_pass = 0
    fe.launches_block_one_pass = fe.launches_block_write_r_one_pass = 0


# The per-cell fit's full width: the largest N at which a default
# run_harmony picks it (config._PER_CELL_MAX_N is 20,480).
PC_CELLS = 20_000


class Collectives:
    """Counts the process group's all-gathers and broadcasts that the port
    issues (calls, and bytes each rank receives) while active: wraps
    torch.distributed's functions, restored on exit. Counts nothing of the
    timed fused passes, which run outside it."""

    NAMES = ("all_gather_single", "all_gather_into_tensor", "broadcast")

    def __enter__(self):
        import torch.distributed as dist
        self.calls = self.bytes = 0
        self.saved = {n: getattr(dist, n) for n in self.NAMES
                      if hasattr(dist, n)}

        def wrap(fn):
            def counted(out, *a, **kw):
                self.calls += 1
                self.bytes += out.numel() * out.element_size()
                return fn(out, *a, **kw)
            return counted
        for n, fn in self.saved.items():
            setattr(dist, n, wrap(fn))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        for n, fn in self.saved.items():
            setattr(dist, n, fn)


def waits_in_ranges(prof, name):
    """(host waits inside the profiler ranges called `name`, the number of
    such ranges): CUDA runtime calls named *Synchronize that start within
    one of them."""
    from torch.autograd import DeviceType
    spans, waits = [], []
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        if e.name == name:
            spans.append((e.time_range.start, e.time_range.end))
        elif "Synchronize" in e.name:
            waits.append(e.time_range.start)
    return (sum(1 for w in waits if any(a <= w < b for a, b in spans)),
            len(spans))


def pbmc_inputs():
    """pbmc_3500's PCs, metadata and the R package's harmonized PCs."""
    import pandas as pd
    meta = pd.read_csv(os.path.join(DATA, "pbmc_3500_meta.tsv.gz"),
                       sep="\t")
    pcs = pd.read_csv(os.path.join(DATA, "pbmc_3500_pcs.tsv.gz"), sep="\t")
    gold = pd.read_csv(os.path.join(DATA, "pbmc_3500_pcs_harmonized.tsv.gz"),
                       sep="\t")
    if gold.iloc[:, 0].dtype == "object":
        gold = gold.iloc[:, 1:]
    return pcs, meta, gold


def batch_meta(batches):
    import pandas as pd
    return pd.DataFrame({"batch": pd.Categorical.from_codes(
        batches, [f"b{i}" for i in range(N_BATCHES)])})


def percell_refs(ht, size):
    """Digests of the one-process `size`-shard mesh's per-cell fits on
    cuda:0 (default settings): the PC_CELLS synthetic (and its wall
    seconds, after a warm-up fit) and pbmc_3500."""
    import torch
    from harmonypy_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(["cuda:0"] * size)
    X, batches, _ = synthetic(N=PC_CELLS)
    meta = batch_meta(batches)
    ht.run_harmony(X, meta, ["batch"], mesh=mesh, verbose=False,
                   max_iter_harmony=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ho = ht.run_harmony(X, meta, ["batch"], mesh=mesh, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(not ho.cfg.fused_estep and ho.cfg.n_devices == size,
          f"per-cell reference: unexpected config {ho.cfg}")
    pcs, meta, _ = pbmc_inputs()
    pb = ht.run_harmony(pcs, meta, ["donor"], mesh=mesh, verbose=False)
    return dict(percell=fit_digests(ho), pbmc=fit_digests(pb),
                kmeans_rounds=ho.kmeans_rounds, wall_s=wall)


def mp_percell(ht, mesh) -> dict:
    """The per-cell task of a worker at full width (PC_CELLS x N_PCS, K =
    100, default settings, not cut): a warm-up fit of one harmony
    iteration under torch.profiler (host waits per k-means round, and
    inside the E-step's block loop per block), then the fit digested with
    each k-means loop timed to a synchronise and its collectives counted
    (2 n_blocks + 2 per round), then pbmc_3500 at default settings
    (digested, golden r)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from harmonypy_tpu_torch import engine
    X, batches, _ = synthetic(N=PC_CELLS)
    meta = batch_meta(batches)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        warm = ht.run_harmony(X, meta, ["batch"], mesh=mesh, verbose=False,
                              max_iter_harmony=1)
        torch.cuda.synchronize()
    rounds0, nb = warm.kmeans_rounds[0], warm.cfg.n_blocks
    round_waits, n_loops = waits_in_ranges(prof, "harmony::cluster")
    estep_waits, n_esteps = waits_in_ranges(prof, "harmony::estep")
    check(n_loops == 1 and n_esteps == rounds0,
          f"per-cell profile: {n_loops} k-means loops, {n_esteps} E-steps "
          f"for {rounds0} rounds")
    del prof, warm

    loops = dict(ms=0.0, rounds=0, collectives=0)
    real = engine.cluster_percell
    with Collectives() as coll:
        def timed(st, *a):
            torch.cuda.synchronize()
            c0, t0 = coll.calls, time.perf_counter()
            n = real(st, *a)
            torch.cuda.synchronize()
            loops["ms"] += (time.perf_counter() - t0) * 1e3
            loops["rounds"] += n
            loops["collectives"] += coll.calls - c0
            return n
        engine.cluster_percell = timed
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ho = ht.run_harmony(X, meta, ["batch"], mesh=mesh, verbose=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            engine.cluster_percell = real
        check(not ho.cfg.fused_estep and ho.cfg.K == K,
              f"per-cell task: unexpected config {ho.cfg}")
        fit = fit_digests(ho)
        pcs, pmeta, gold = pbmc_inputs()
        pb = ht.run_harmony(pcs, pmeta, ["donor"], mesh=mesh, verbose=False)
        pb_r = [float(np.corrcoef(pb.Z_corr[:, i], gold.iloc[:, i].values)
                      [0, 1]) for i in range(pb.Z_corr.shape[1])]
    return dict(
        wall_s=wall, kmeans_rounds=ho.kmeans_rounds, n_blocks=nb,
        digests=fit, ms_per_round=loops["ms"] / loops["rounds"],
        collectives_per_round=loops["collectives"] / loops["rounds"],
        host_waits_per_round=round_waits / rounds0,
        host_waits_per_block=estep_waits / (rounds0 * nb),
        pbmc=dict(digests=fit_digests(pb), min_pc_r=min(pb_r),
                  fused=pb.cfg.fused_estep, kmeans_rounds=pb.kmeans_rounds))


def mp_lisi(ht, mesh, Z, batches, groups) -> dict:
    """The LISI task of a worker: compute_lisi on the deferred fit's
    Z_corr (N_CELLS x N_PCS, labels batch and group, knn="exact": the
    pruned path), the whole X on every rank, timed to a synchronise with
    the bytes its collectives moved to this rank; then brute force on
    LISI_SAMPLE sampled queries. Digests of both."""
    import torch
    labels, meta = ["batch", "group"], lisi_meta(batches, groups)
    with Collectives() as coll:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm = ht.compute_lisi(Z, meta, labels, 30, mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        calls, nbytes = coll.calls, coll.bytes
        t0 = time.perf_counter()
        sv, sidx = ht.compute_lisi(Z, meta, labels, 30, sample=LISI_SAMPLE,
                                   knn="brute", mesh=mesh)
        torch.cuda.synchronize()
        brute_s = time.perf_counter() - t0
    return dict(wall_s=wall, collectives=calls, bytes_received=nbytes,
                digest=digest(lm), brute_s=brute_s,
                brute_digests=[digest(sv), digest(sidx)],
                brute_bytes_received=coll.bytes - nbytes)


def mp_worker(spec: dict) -> None:
    """One rank of a multi-process run (phase multiprocess): join the
    process group, fit the 858k data on the mesh of every rank's
    `devices` (after a warm-up fit; each fit with the five launch counts
    set to 0 just before it), digest its Z_corr, R, histories and kmeans_rounds; the gloo run
    also resumes the deferred fit from its first checkpoint; then one mesh
    pass (the deferred fit's final round replayed) timed by CUDA events and
    profiled; then the tasks of spec["tasks"]: "percell" (mp_percell) and
    "lisi" (mp_lisi on the deferred fit's Z_corr). Writes
    <dir>/<tag>_<rank>.json."""
    import numpy as np
    import torch
    sys.path.insert(0, HERE)
    import harmonypy_tpu_torch as ht
    from harmonypy_tpu_torch import engine
    from harmonypy_tpu_torch.ops.cuda import fused_estep as fe
    from harmonypy_tpu_torch.ops.partition import (mesh_round_tables,
                                                   partition_geometry)
    from harmonypy_tpu_torch.ops.update_r_fused import make_zp3
    from harmonypy_tpu_torch.parallel import mesh as pm
    from harmonypy_tpu_torch.parallel.sharding import parts
    tag, rank, tmp = spec["tag"], spec["rank"], spec["dir"]
    pm.initialize_distributed(
        f"file://{tmp}/pg_{tag}", spec["world"], rank,
        backend=spec["backend"], device=spec["devices"][0],
        timeout_s=MP_COLLECTIVE_S)
    try:
        with np.load(os.path.join(tmp, "data.npz")) as z:
            X, batches, groups = z["X"], z["batches"], z["groups"]
        meta = batch_meta(batches)
        mesh = pm.make_mesh(spec["devices"])
        res = dict(tag=tag, rank=rank, backend=spec["backend"],
                   devices=[str(d) for d in mesh.devices],
                   shard_ids=list(mesh.shard_ids), shards=mesh.size,
                   fits={})
        ck = os.path.join(tmp, f"ck_{tag}")
        # A first fit in a new process pays for its context, libraries and
        # communicators: one short fit first, not timed, its passes metered.
        with PassMeter(fe) as meter:
            wu = ht.run_harmony(X, meta, ["batch"], mesh=mesh, verbose=False,
                                max_iter_harmony=1)
        res["metered_passes"] = meter.summary(wu.cfg.n_blocks, True,
                                              f"{tag} rank {rank}")
        for name in spec["fits"]:
            kw = dict(stored=dict(defer_r=False),
                      low_memory=dict(defer_r=False, low_memory=True)
                      ).get(name, {})
            if name == "deferred" and spec.get("resume"):
                kw = dict(checkpoint_dir=ck)
            torch.cuda.synchronize()
            _zero_counts(fe)
            t0 = time.perf_counter()
            ho = ht.run_harmony(X, meta, ["batch"], mesh=mesh,
                                verbose=False, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = _counts(fe)
            res["fits"][name] = dict(
                wall_s=wall, launches=got, n_blocks=ho.cfg.n_blocks,
                passes=ho.state.n_passes, rounds=sum(ho.kmeans_rounds),
                kmeans_rounds=ho.kmeans_rounds, digests=fit_digests(ho))
            if name == "deferred":
                dho = ho
        if spec.get("resume"):
            ho = ht.run_harmony(
                X, meta, ["batch"], mesh=mesh, verbose=False,
                resume_from=os.path.join(ck, "harmony_iter_1.npz"))
            res["resume"] = fit_digests(ho)
        # One mesh pass: the deferred fit's final round, replayed.
        st, cfg = dho.state, dho.cfg
        geom = partition_geometry(cfg)
        ZP3s = [make_zp3(z, p, m, cfg) for z, p, m in zip(
            parts(st.rep_Zcos), parts(dho._data.Phi), parts(dho._data.mask))]
        tables = mesh_round_tables(st.rep_blocks, parts(st.rep_cache), geom,
                                   [z.device for z in ZP3s])
        rep = (st.rep_Y, dho._params.sigma, dho._params.theta,
               dho._params.Pr_b, st.rep_O, st.rep_E)
        fast = engine.fast_ent(cfg)

        def run():
            return fe.fused_estep_mesh(tables, ZP3s, *rep, fast, geom.J_fix,
                                       precision=cfg.matmul_precision)

        # Through one plan, as a fit runs its passes.
        with fe.mesh_plans():
            O, E = run()[:2]
            check(torch.equal(O, st.O) and torch.equal(E, st.E),
                  f"{tag} rank {rank}: the replayed pass's O, E differ from "
                  f"the fit's")
            res["ms_per_pass"] = cuda_ms(run, reps=10)
            res["pass_profile"] = mesh_pass_profile(run, geom.nb,
                                                    len(mesh.devices))
        # One block's all-gather alone, as the pass issues it: host us per
        # call, and us per call to the last synchronise.
        J = tables.slots[0].shape[1]
        send = torch.zeros((len(ZP3s), J, cfg.K, cfg.B1), device=O.device)
        gather = pm.gatherer(send.new_empty((mesh.size,) + send.shape[1:]),
                             send)
        for _ in range(10):
            gather()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            gather()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        res["allgather_us"] = dict(host=host / 200 * 1e6,
                                   wall=(time.perf_counter() - t0) / 200
                                   * 1e6, bytes=send.numel() * 4)
        tasks = spec.get("tasks", ())
        if "lisi" in tasks:
            res["lisi"] = mp_lisi(ht, mesh, dho.Z_corr, batches, groups)
        if "percell" in tasks:
            res["percell"] = mp_percell(ht, mesh)
        with open(os.path.join(tmp, f"{tag}_{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        pm.shutdown_distributed()


def run_workers(tag, backend, devices, fits, tmp, resume=False, env=None,
                tasks=(), script=None):
    """Start one worker per entry of `devices` (that rank's devices), with
    `env` added to the environment and `tasks` to run after the fits, wait
    for all (MP_WORKER_S), kill the rest if one fails or hangs; returns
    their results by rank. script: the chip_smoke.py whose --mp-worker
    runs (default this one; another checkout's runs its own package)."""
    import subprocess
    procs, logs = [], []
    try:
        for rank, devs in enumerate(devices):
            spec = dict(tag=tag, rank=rank, world=len(devices), dir=tmp,
                        backend=backend, devices=devs, fits=fits,
                        resume=resume, tasks=list(tasks))
            log = open(os.path.join(tmp, f"{tag}_{rank}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, script or os.path.abspath(__file__),
                 "--mp-worker", json.dumps(spec)], stdout=log,
                stderr=subprocess.STDOUT, cwd=HERE,
                env=dict(os.environ, **(env or {}))))
        deadline = time.time() + MP_WORKER_S
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            late = time.time() > deadline and None in codes
            if bad or late:
                rank = bad[0] if bad else codes.index(None)
                with open(os.path.join(tmp, f"{tag}_{rank}.log")) as f:
                    tail = f.read()[-3000:]
                why = f"exit {codes[rank]}" if bad else "timed out"
                raise RuntimeError(f"chip_smoke: {tag} worker {rank} {why}:"
                                   f"\n{tail}")
            if None not in codes:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    out = []
    for rank in range(len(devices)):
        with open(os.path.join(tmp, f"{tag}_{rank}.json")) as f:
            out.append(json.load(f))
    return out


def check_tasks(tag, res, want, nccl):
    """A worker's per-cell and LISI tasks: the per-cell fits bitwise equal
    to the one-process mesh's of as many shards (want["percell"][size]),
    pbmc at the golden gate, 2 n_blocks + 2 collectives per k-means round,
    no host wait inside the block loop under NCCL; LISI bitwise equal to
    phase lisi's values and the sampled brute force's (want["lisi"]).
    Returns the summary."""
    out = {}
    who = f"{tag} rank {res['rank']}"
    if "percell" in res:
        pc, ref = res["percell"], want["percell"][res["shards"]]
        check(pc["digests"] == ref["percell"],
              f"{who}: the per-cell fit differs from the one-process "
              f"mesh's: {pc['digests']} vs {ref['percell']}")
        check(pc["pbmc"]["digests"] == ref["pbmc"] and not
              pc["pbmc"]["fused"], f"{who}: the per-cell pbmc fit differs "
              f"from the one-process mesh's")
        check(pc["pbmc"]["min_pc_r"] >= 0.99,
              f"{who}: per-cell pbmc min r {pc['pbmc']['min_pc_r']}")
        want_c = 2 * pc["n_blocks"] + 2
        check(pc["collectives_per_round"] == want_c,
              f"{who}: {pc['collectives_per_round']} collectives per "
              f"k-means round, expected {want_c}")
        check(not nccl or pc["host_waits_per_block"] == 0,
              f"{who}: the host waited {pc['host_waits_per_block']} times "
              f"per block in the per-cell E-step under NCCL")
        out["percell"] = dict(
            cells=PC_CELLS, wall_s=pc["wall_s"],
            kmeans_rounds=pc["kmeans_rounds"], bitwise_equal=True,
            ms_per_round=pc["ms_per_round"],
            collectives_per_round=pc["collectives_per_round"],
            host_waits_per_round=pc["host_waits_per_round"],
            host_waits_per_block=pc["host_waits_per_block"],
            pbmc=dict(bitwise_equal=True, min_pc_r=pc["pbmc"]["min_pc_r"],
                      kmeans_rounds=pc["pbmc"]["kmeans_rounds"]))
    if "lisi" in res:
        li = res["lisi"]
        check(li["digest"] == want["lisi"][0],
              f"{who}: LISI differs from phase lisi's")
        check(li["brute_digests"] == want["lisi"][1:],
              f"{who}: the sampled brute LISI differs from phase lisi's")
        out["lisi"] = dict(li, bitwise_equal=True)
    return out


def check_workers(tag, results, want, nccl=False):
    """Every rank's fits bitwise equal to the one-device fits (phase mesh
    holds the one-process meshes to them), their launch counts those of a
    mesh pass on the rank's shards, and the resume bitwise; the tasks
    (check_tasks). Returns the phase line's summary."""
    summary = []
    for res in results:
        local = len(res["devices"])
        for name, fit in res["fits"].items():
            check(fit["digests"] == want[name],
                  f"{tag} rank {res['rank']}: {name} differs from the "
                  f"one-process fit: {fit['digests']} vs {want[name]}")
            nb = fit["n_blocks"]
            exp = ((0, 0, nb * local * fit["passes"], 0, fit["passes"])
                   if name == "deferred"
                   else (0, 0, 0, nb * local * fit["rounds"], fit["rounds"]))
            check(tuple(fit["launches"]) == exp and max(exp) > 0,
                  f"{tag} rank {res['rank']} {name}: launches (K1, K2, K1 "
                  f"per-block, K2 per-block, re-add) {fit['launches']}, "
                  f"expected {exp}")
        if "resume" in res:
            check(res["resume"] == want["deferred"],
                  f"{tag} rank {res['rank']}: the resumed fit differs")
        prof = res["pass_profile"]
        summary.append(dict(
            rank=res["rank"], devices=res["devices"],
            shard_ids=res["shard_ids"],
            fits={k: dict(wall_s=v["wall_s"], launches=dict(zip(
                ("k1", "k2", "k1_block", "k2_block", "readd"),
                v["launches"])), kmeans_rounds=v["kmeans_rounds"],
                passes=v["passes"], bitwise_equal=True)
                for k, v in res["fits"].items()},
            resume_bitwise="resume" in res or None,
            metered_passes=res["metered_passes"],
            ms_per_pass=res["ms_per_pass"],
            allgather_us=res["allgather_us"],
            host_waits_per_pass=prof["host_waits_per_pass"],
            host_waited_in_block_loop=(prof["host_waits_per_pass"]
                                       >= res["fits"]["deferred"]
                                       ["n_blocks"]),
            pass_profile=prof, **check_tasks(tag, res, want, nccl)))
    return summary


def phase_multiprocess(refs, X, batches, groups, smi, lisi_ref):
    """Multi-process runs at 858k, one worker process per rank: 2 ranks on
    cuda:0 under gloo with 2 shards each (NCCL refuses two ranks on one
    card): the deferred, stored and low_memory fits, .R and a checkpoint
    resume; 1 rank under NCCL with 4 shards on cuda:0, whose blocks cross
    through a real NCCL all-gather: the deferred and stored fits (and the
    deferred fit again with torch's flight recorder on, its cost per
    collective); on a machine with several cards one NCCL rank per card:
    the deferred fit.
    Each bitwise equal to the one-device fits refs (so to the one-process
    mesh, phase mesh), with the per-block and re-add launches of every
    worker, the ms per mesh pass, and whether the host waited inside the
    block loop (NCCL: it must not). The gloo, nccl and cards workers also
    run the per-cell task (PC_CELLS cells and pbmc_3500, bitwise equal to
    the one-process mesh of as many shards on cuda:0, fitted here), the
    gloo and cards workers the LISI task (bitwise equal to phase lisi's
    lisi_ref = (values, sampled brute values, sampled ids))."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import harmonypy_tpu_torch as ht
    want = {name: fit_digests(ho) for name, ho in refs.items()}
    want["lisi"] = [digest(a) for a in lisi_ref]
    cards = torch.cuda.device_count()
    t0 = time.perf_counter()
    want["percell"] = {n: percell_refs(ht, n) for n in sorted(
        {MESH_SHARDS} | ({cards} if cards > 1 else set()))}
    refs_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mp_")
    out = {}
    try:
        np.savez(os.path.join(tmp, "data.npz"), X=X, batches=batches,
                 groups=groups)
        # nccl_fr: the NCCL run with torch's flight recorder at its
        # default size, which initialize_distributed turns off.
        runs = [("gloo", "gloo", [["cuda:0"] * 2] * 2,
                 ["deferred", "stored", "low_memory"], True, None,
                 ("percell", "lisi")),
                ("nccl", "nccl", [["cuda:0"] * 4], ["deferred", "stored"],
                 False, None, ("percell",)),
                ("nccl_fr", "nccl", [["cuda:0"] * 4], ["deferred"], False,
                 dict(TORCH_FR_BUFFER_SIZE="2000"), ())]
        if cards > 1:
            runs.append(("cards", "nccl", [[f"cuda:{i}"] for i in
                                           range(cards)], ["deferred"],
                         False, None, ("percell", "lisi")))
        for tag, backend, devices, fits, resume, env, tasks in runs:
            t0 = time.perf_counter()
            res = run_workers(tag, backend, devices, fits, tmp, resume, env,
                              tasks)
            out[tag] = dict(backend=backend, ranks=len(devices),
                            shards=res[0]["shards"], tasks=list(tasks),
                            command_s=time.perf_counter() - t0,
                            workers=check_workers(tag, res, want,
                                                  backend == "nccl"))
        check(not any(w["host_waited_in_block_loop"]
                      for tag in out if tag != "gloo"
                      for w in out[tag]["workers"]),
              "NCCL: the host waited inside the block loop")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit(dict(phase="multiprocess", nvidia_smi=smi, N=N_CELLS, d=N_PCS,
              K=K, B=N_BATCHES, percell_cells=PC_CELLS, percell_refs=dict(
                  seconds=refs_s, one_process_fit={
                      n: dict(wall_s=r["wall_s"],
                              kmeans_rounds=r["kmeans_rounds"])
                      for n, r in want["percell"].items()}), runs=out,
              real_cards=(out["cards"]["workers"][0]["ms_per_pass"]
                          if "cards" in out else f"skipped: {cards} card")))


def mesh_timing(root: str) -> dict:
    """The mesh pass of the checkout at `root` (its package and kernels,
    built there): 858k on 4 logical shards of cuda:0, the round of phase
    kernel; K1 and K2 (fp32) ms per pass by CUDA events, the host's ms to
    issue a K1 pass (host_issue_ms), profiled K1 passes (host issue,
    device busy, idle share, other device operations), re-add launches per
    pass; then the same K1 pass with the process in a one-rank NCCL group
    (the blocks' rows cross an all-gather, as in phase multiprocess); with
    several cards, the one-process pass over every card (ms per pass on
    the host's clock, every card synchronised; host issue; a profile: the
    device busy time is the union over the cards) and the deferred, stored
    and low_memory fits on that mesh, each after a warm-up fit. Passes run
    as a fit runs them: in a mesh_plans block where the checkout has one.
    Runs in a process of its own (`--mesh-timing`), so two checkouts'
    packages do not meet."""
    import contextlib
    import dataclasses

    import torch
    sys.path.insert(0, root)
    import harmonypy_tpu_torch as ht
    check(os.path.dirname(os.path.abspath(ht.__file__))
          == os.path.join(os.path.abspath(root), "harmonypy_tpu_torch"),
          f"harmonypy_tpu_torch imported from {ht.__file__}, not {root}")
    from harmonypy_tpu_torch import config, engine, layout, state
    from harmonypy_tpu_torch.ops import partition, update_r_fused
    from harmonypy_tpu_torch.ops.cuda import build
    from harmonypy_tpu_torch.ops.cuda import fused_estep as fe
    from harmonypy_tpu_torch.parallel import sharding
    plans = getattr(fe, "mesh_plans", contextlib.nullcontext)
    build.build_all()
    X, batches, _ = synthetic()
    mods = (config, engine, layout, partition, fe, update_r_fused, state)
    geom, args, (cfg, blocks, st) = round_inputs(mods, X, batches,
                                                 with_state=True)
    D = MESH_SHARDS
    devs = [torch.device("cuda:0")] * D
    geomD = partition.partition_geometry(
        dataclasses.replace(cfg, n_devices=D))
    ZP3s = [sharding.extract_chunks(args[2], s, geomD).contiguous()
            for s in range(D)]
    tabs = partition.mesh_round_tables(
        blocks, [sharding.extract_chunks(st.cache, s, geomD)
                 for s in range(D)], geomD, devs)
    rest = args[3:]
    R3s = [torch.zeros((geomD.nc_cap + 1, K, CHUNK), device="cuda")
           for _ in range(D)]

    def k1():
        fe.fused_estep_mesh(tabs, ZP3s, *rest, False, geom.J_fix)

    def k2():
        fe.fused_estep_mesh(tabs, ZP3s, *rest, False, geom.J_fix, R3s=R3s)
    r0 = fe.launches_readd
    with plans():
        ms_k1 = cuda_ms(k1, reps=30, warmup=3)
        readd = (fe.launches_readd - r0) / 33
        ms_k2 = cuda_ms(k2, reps=30, warmup=3)
        out = dict(root=root, ms_per_pass=ms_k1, ms_per_pass_write_r=ms_k2,
                   host_issue_ms=host_issue_ms(k1, torch.cuda.synchronize),
                   readd_launches_per_pass=readd,
                   pass_profile=mesh_pass_profile(k1, geom.nb, D, passes=10))
    cards = torch.cuda.device_count()
    if cards > 1:
        from harmonypy_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh()
        lead, cdevs = mesh.lead, list(mesh.devices)
        gC = partition.partition_geometry(
            dataclasses.replace(cfg, n_devices=mesh.size))
        cZ = [sharding.extract_chunks(args[2], s, gC).to(dv).contiguous()
              for s, dv in enumerate(cdevs)]
        ctabs = partition.mesh_round_tables(
            blocks.to(lead), [sharding.extract_chunks(st.cache, s, gC)
                              .to(dv) for s, dv in enumerate(cdevs)],
            gC, cdevs)
        crest = [t.to(lead) for t in rest]

        def sync():
            for i in range(cards):
                torch.cuda.synchronize(i)

        def cpass():
            fe.fused_estep_mesh(ctabs, cZ, *crest, False, geom.J_fix)
        with plans():
            for _ in range(3):
                cpass()
            sync()
            t0 = time.perf_counter()
            for _ in range(20):
                cpass()
            sync()
            out["cards_ms_per_pass"] = (time.perf_counter() - t0) * 50
            out["cards_host_issue_ms"] = host_issue_ms(cpass, sync)
            out["cards_pass_profile"] = mesh_pass_profile(
                cpass, geom.nb, mesh.size, passes=10)
        meta = batch_meta(batches)
        for name, kw in (("deferred", {}), ("stored", dict(defer_r=False)),
                         ("low_memory", dict(defer_r=False,
                                             low_memory=True))):
            ht.run_harmony(X, meta, ["batch"], mesh=mesh, verbose=False,
                           max_iter_harmony=1, **kw)
            sync()
            t0 = time.perf_counter()
            ht.run_harmony(X, meta, ["batch"], mesh=mesh, verbose=False,
                           **kw)
            sync()
            out[f"cards_fit_s_{name}"] = time.perf_counter() - t0
    import tempfile
    from harmonypy_tpu_torch.parallel import mesh as pm
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    pm.initialize_distributed(f"file://{tmp}/pg", 1, 0, backend="nccl",
                              device="cuda:0", timeout_s=MP_COLLECTIVE_S)
    try:
        check(pm.spans_processes(D), "the one-rank group does not gather")
        with plans():
            out.update(nccl_ms_per_pass=cuda_ms(k1, reps=30, warmup=3),
                       nccl_host_issue_ms=host_issue_ms(
                           k1, torch.cuda.synchronize))
    finally:
        pm.shutdown_distributed()
    return out


def mesh_timing_run(root: str) -> dict:
    """mesh_timing(root) in a process of its own."""
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--mesh-timing",
         os.path.abspath(root)], capture_output=True, text=True, cwd=HERE,
        timeout=900)
    check(out.returncode == 0, f"mesh timing of {root} failed:\n"
                               f"{out.stdout[-2000:]}{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def mesh_ab(parent: str) -> int:
    """The one-process mesh pass of the parent checkout at `parent` and of
    this one, each in a process of its own (mesh_timing), in the order
    parent, this, this, parent, parent, this: on one card 4 logical shards
    and a one-rank NCCL group; on a machine with several cards also the
    mesh of every card (pass and fits). Prints each run and each
    checkout's means, and whether the one-launch round's instantiations
    compiled to the same registers and spills in both."""
    import shutil
    import tempfile
    from harmonypy_tpu_torch.ops.cuda import build
    # Each checkout's one-launch round, compiled apart for its ptxas report
    # (a run may find its kernels built already, with no report).
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ab_")
    comp = [subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-o", os.path.join(tmp, f"{i}.so"),
         os.path.join(root, "harmonypy_tpu_torch", "csrc", "fused_estep.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i, root in enumerate((parent, HERE))]
    reports = []
    for c in comp:
        out = c.communicate()[0]
        check(c.returncode == 0, f"nvcc failed:\n{out[-3000:]}")
        reports.append(ptxas_kernels({"fused_estep": out}))
    shutil.rmtree(tmp, ignore_errors=True)
    runs = []
    for root in (parent, HERE, HERE, parent, parent, HERE):
        runs.append(mesh_timing_run(root))
        emit(dict(phase="mesh_ab_run", **runs[-1]))
    keys = [k for k in ("ms_per_pass", "ms_per_pass_write_r",
                        "host_issue_ms", "nccl_ms_per_pass",
                        "nccl_host_issue_ms", "cards_ms_per_pass",
                        "cards_host_issue_ms", "cards_fit_s_deferred",
                        "cards_fit_s_stored", "cards_fit_s_low_memory")
            if k in runs[0]]
    prof_keys = ("host_issue_ms_per_pass", "wall_ms_per_pass",
                 "device_busy_ms_per_pass", "device_idle_share",
                 "other_ops_per_pass", "block_kernel_device_ms")

    def mean(rs):
        m = {k: sum(r[k] for r in rs) / len(rs) for k in keys}
        for pk in ("pass_profile", "cards_pass_profile"):
            if pk in rs[0]:
                m[pk] = {k: sum(r[pk][k] for r in rs) / len(rs)
                         for k in prof_keys}
        m["readd_launches_per_pass"] = rs[0]["readd_launches_per_pass"]
        return m
    ptx = {name: (reports[0].get(name), reports[1].get(name))
           for name in sorted(set(reports[0]) | set(reports[1]))
           if name.endswith("round>")}
    same = all(a == b for a, b in ptx.values()) and len(ptx) == 32
    emit(dict(phase="mesh_ab", nvidia_smi=smi_line(),
              parent=mean(runs[0::3] + runs[4:5]),
              change=mean(runs[1:3] + runs[5:]),
              round_ptxas_same=same, round_ptxas=ptx))
    return 0


# --round-ab: the one-launch round's entries timed and digested in each run.
ROUND_REPS = 20


def round_entries(fe, args, nc, R3s):
    """The one-launch round's entries that --round-ab times: the one-pass
    K1 round, its r window over every real chunk (a fit's replay), K2 one
    pass into fp32 and bf16 R, and the 3xTF32 K1 round: {name: fn(fast)}."""
    return {
        "k1_one_pass": lambda f: fe.fused_estep(*args, f,
                                                precision="default"),
        "r_window_one_pass": lambda f: fe.fused_estep(
            *args, f, lo=0, width=nc, precision="default"),
        "k2_one_pass_fp32": lambda f: fe.fused_estep_r(
            args[0], args[1], args[2], R3s[0], *args[3:], f,
            precision="default"),
        "k2_one_pass_bf16": lambda f: fe.fused_estep_r(
            args[0], args[1], args[2], R3s[1], *args[3:], f,
            precision="default"),
        "k1_3xtf32": lambda f: fe.fused_estep(*args, f, precision="float32")}


def tensor_digest(t) -> str:
    """digest of a card tensor (bf16 by its bit patterns)."""
    import torch
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return digest(t.cpu().numpy())


def round_timing(root: str) -> dict:
    """The one-launch round of the checkout at `root` (its package and
    kernels): on the 858k round of phase kernel, for each of round_entries
    the digest of every output under both objective forms, ms per call by
    CUDA events (ROUND_REPS calls) and the profiler's device ms; the
    default 858k deferred fit's wall s after a warm-up fit (no gate); and,
    where the checkout has the stamped round (ops/cuda/round_timing.py),
    its phase split (round_timing.decode), its outputs' digests (which
    must equal the round's) and its ms beside the unstamped round's. Runs
    in a process of its own (`--round-timing`), so two checkouts' packages
    do not meet."""
    import importlib.util

    import torch
    sys.path.insert(0, root)
    import harmonypy_tpu_torch as ht
    check(os.path.dirname(os.path.abspath(ht.__file__))
          == os.path.join(os.path.abspath(root), "harmonypy_tpu_torch"),
          f"harmonypy_tpu_torch imported from {ht.__file__}, not {root}")
    from harmonypy_tpu_torch import config, engine, layout, state
    from harmonypy_tpu_torch.ops import partition, update_r_fused
    from harmonypy_tpu_torch.ops.cuda import fused_estep as fe
    timed = importlib.util.find_spec(
        "harmonypy_tpu_torch.ops.cuda.round_timing") is not None
    X, batches, _ = synthetic()
    mods = (config, engine, layout, partition, fe, update_r_fused, state)
    geom, args = round_inputs(mods, X, batches)
    nc = geom.nc_cap
    R3s = [torch.zeros((nc + 1, K, CHUNK), dtype=dt, device="cuda")
           for dt in (torch.float32, torch.bfloat16)]
    out = dict(root=root, digests={}, ms={}, device_ms={})
    for name, fn in round_entries(fe, args, nc, R3s).items():
        for fast in (False, True):
            res = fn(fast)
            out["digests"][f"{name},fast_objective={fast}"] = [
                tensor_digest(t) for t in res if t is not None]
            del res
        out["ms"][name] = cuda_ms(lambda: fn(False), reps=ROUND_REPS)
        out["device_ms"][name] = device_ms(lambda: fn(False))[0]
    if timed:
        from harmonypy_tpu_torch.ops.cuda import round_timing as rt
        res, stamps, grid, names = rt.timed_round(*args, False)
        out["timed_digests"] = [tensor_digest(t) for t in res]
        check(out["timed_digests"]
              == out["digests"]["k1_one_pass,fast_objective=False"][:5],
              "the stamped round's outputs differ from the round's")
        out["split"] = dict(rt.decode(stamps.cpu().numpy(), geom.nb, grid,
                                      names), grid=grid)
        # The stamps' own cost: stamped and unstamped rounds in turns.
        pair = [[], []]
        for _ in range(3):
            pair[0].append(cuda_ms(lambda: rt.timed_round(
                *args, False, stamps=stamps), reps=ROUND_REPS))
            pair[1].append(cuda_ms(lambda: fe.fused_estep(
                *args, False, precision="default"), reps=ROUND_REPS))
        out["split"].update(timed_ms=sorted(pair[0])[1],
                            untimed_ms=sorted(pair[1])[1])
    meta = batch_meta(batches)
    ht.run_harmony(X, meta, ["batch"], device="cuda:0", verbose=False,
                   max_iter_harmony=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ho = ht.run_harmony(X, meta, ["batch"], device="cuda:0", verbose=False)
    torch.cuda.synchronize()
    out["fit"] = dict(s=time.perf_counter() - t0,
                      kmeans_rounds=list(ho.kmeans_rounds),
                      digests=fit_digests(ho))
    return out


def round_build(root: str) -> dict:
    """Build every kernel source of the checkout at `root` (the stamped
    ones too, where it has them), all at once; the ptxas reports
    (ptxas_kernels) of its one-launch round libraries and of its
    per-block libraries."""
    sys.path.insert(0, root)
    from harmonypy_tpu_torch.ops.cuda import build
    names = sorted(f[:-3] for f in os.listdir(build.CSRC)
                   if f.endswith(".cu"))
    t0 = time.perf_counter()
    if hasattr(build, "ON_DEMAND"):
        build.build_all(names)
    else:                        # a checkout that builds every source
        build.build_all()
    logs = {n: build.build_log.get(n, "") for n in names
            if n.startswith("fused_estep") and "block" not in n}
    blocks = {n: build.build_log.get(n, "") for n in names
              if n.startswith("fused_estep_block")}
    return dict(root=root, build_s=time.perf_counter() - t0,
                ptxas=ptxas_kernels(logs), block_ptxas=ptxas_kernels(blocks))


def round_sub(flag: str, root: str, timeout: int) -> dict:
    """`chip_smoke.py flag root` in a process of its own: its last line."""
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), flag,
         os.path.abspath(root)], capture_output=True, text=True, cwd=HERE,
        timeout=timeout)
    check(out.returncode == 0, f"{flag} {root} failed:\n"
                               f"{out.stdout[-2000:]}{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def round_ab(parent: str) -> int:
    """The one-launch round of the parent checkout at `parent` and of this
    one: both built at once (their ptxas reports of the round's
    instantiations), then round_timing in the order parent, this, this,
    parent, parent, this, each in a process of its own. Checks that every
    digest of every run equals the first run's (the change keeps the
    parent's bits); prints each run, each checkout's mean ms and device ms
    per entry, the fits' wall s, and this checkout's phase split."""
    builds = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--round-build",
         os.path.abspath(root)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=HERE)
        for root in (parent, HERE)]
    reports = []
    for b in builds:
        o, e = b.communicate(timeout=900)
        check(b.returncode == 0, f"build failed:\n{o[-2000:]}{e[-3000:]}")
        reports.append(json.loads(o.strip().splitlines()[-1]))
    emit(dict(phase="round_ab_build", builds=reports))
    runs = []
    for root in (parent, HERE, HERE, parent, parent, HERE):
        runs.append(round_sub("--round-timing", root, 600))
        emit(dict(phase="round_ab_run", **runs[-1]))
    for r in runs[1:]:
        check(r["digests"] == runs[0]["digests"],
              f"round digests of {r['root']} differ from {runs[0]['root']}")
        check(r["fit"]["digests"] == runs[0]["fit"]["digests"],
              f"fit digests of {r['root']} differ from {runs[0]['root']}")

    def mean(rs):
        return dict(
            ms={k: sum(r["ms"][k] for r in rs) / len(rs) for k in rs[0]["ms"]},
            ms_turns={k: [r["ms"][k] for r in rs] for k in rs[0]["ms"]},
            device_ms={k: sum(r["device_ms"][k] for r in rs) / len(rs)
                       for k in rs[0]["device_ms"]},
            fit_s=[r["fit"]["s"] for r in rs],
            kmeans_rounds=rs[0]["fit"]["kmeans_rounds"])
    par, chg = mean(runs[0::3] + runs[4:5]), mean(runs[1:3] + runs[5:])
    emit(dict(phase="round_ab", nvidia_smi=smi_line(), parent=par,
              change=chg, digests_equal=True,
              faster={k: chg["ms"][k] < par["ms"][k] for k in par["ms"]},
              split=[r.get("split") for r in runs[1:3] + runs[5:]],
              ptxas={"parent": reports[0]["ptxas"],
                     "change": reports[1]["ptxas"]}))
    return 0


# --block-ab / --block-timing: the per-block entry of the mesh-858k pass,
# one launch of shard 0 alone or of the four shards at once.
BLOCK_REPS = 200
BLOCK_ENTRIES = ("k1", "r_window", "k2_fp32", "k2_bf16")
# Stamped launches decoded per case (the one of median span is kept).
BLOCK_STAMPED = 5


def import_checkout(root: str, extra=()):
    """harmonypy_tpu_torch of the checkout at `root` and the modules a
    round's inputs take (config, engine, layout, partition, fused_estep,
    update_r_fused, state), its default kernels and the sources `extra`
    built, all at once."""
    sys.path.insert(0, root)
    import harmonypy_tpu_torch as ht
    check(os.path.dirname(os.path.abspath(ht.__file__))
          == os.path.join(os.path.abspath(root), "harmonypy_tpu_torch"),
          f"harmonypy_tpu_torch imported from {ht.__file__}, not {root}")
    from harmonypy_tpu_torch import config, engine, layout, state
    from harmonypy_tpu_torch.ops import partition, update_r_fused
    from harmonypy_tpu_torch.ops.cuda import build
    from harmonypy_tpu_torch.ops.cuda import fused_estep as fe
    build.build_all(build.default_sources() + list(extra))
    return ht, (config, engine, layout, partition, fe, update_r_fused, state)


def mesh_block_inputs(mods, X, batches, shards=MESH_SHARDS):
    """The 858k round's inputs cut into `shards` logical shards of cuda:0
    (as phase mesh cuts them) and the block timed: shard 0's block b > 0
    with the most real cells."""
    import dataclasses

    import torch
    partition = mods[3]
    from harmonypy_tpu_torch.parallel import sharding
    geom, args, (cfg, blocks, st) = round_inputs(mods, X, batches,
                                                 with_state=True)
    geomD = partition.partition_geometry(
        dataclasses.replace(cfg, n_devices=shards))
    ZP3s = [sharding.extract_chunks(args[2], s, geomD).contiguous()
            for s in range(shards)]
    tabs = partition.mesh_round_tables(
        blocks, [sharding.extract_chunks(st.cache, s, geomD)
                 for s in range(shards)], geomD,
        [torch.device("cuda:0")] * shards)
    cells = ZP3s[0][tabs.slots[0].long(), 0, :].sum(dim=(1, 2))
    return dict(J_fix=geom.J_fix, nc=geomD.nc_cap, tabs=tabs, ZP3s=ZP3s,
                consts=args[3:7], O=args[7], E=args[8],
                bt=1 + int(torch.argmax(cells[1:])),
                J=int(tabs.slots[0].shape[1]))


def block_launchers(fe, inp, entry, shards, make=None, **kw):
    """Per-block launchers of `entry` (BLOCK_ENTRIES) for shards 0..shards-1
    of `inp` (mesh_block_inputs), each with its outputs and store, sharing
    one frame (every shard's rows by parity) as a mesh pass does; shard s >
    0 on a stream of its own. make: the launcher's constructor (default
    fe._BlockLaunch); kw: its further arguments. Returns [(launcher,
    outputs, store)]."""
    import torch
    make = make or fe._BlockLaunch
    tabs, ZP3s, nc = inp["tabs"], inp["ZP3s"], inp["nc"]
    frame = torch.zeros((2, len(ZP3s), inp["J"], K, N_BATCHES + 1),
                        device="cuda")
    src = fe.rank_table(tabs.granks, inp["J_fix"], inp["J"], "cuda")
    made = []
    for s in range(shards):
        out = tuple(torch.zeros(sh, device="cuda") for sh in (
            (nc + 1, K, N_BATCHES + 1), (nc + 1, K, N_PCS), (nc + 1, 2)))
        store, extra = None, {}
        if entry == "r_window":
            store = torch.zeros((nc, K, CHUNK), device="cuda")
            extra = dict(Rw=store, lo=0)
        elif entry.startswith("k2"):
            store = torch.zeros((nc + 1, K, CHUNK), device="cuda",
                                dtype=(torch.bfloat16 if entry == "k2_bf16"
                                       else torch.float32))
            extra = dict(R3=store)
        ln = make(tabs.slots[s], tabs.removal, ZP3s[s], *inp["consts"],
                  inp["O"], inp["E"], False, out, inp["J_fix"] + 1,
                  stream=torch.cuda.Stream() if s else None,
                  brows=frame[:, s], frame=frame, src=src,
                  J_fix=inp["J_fix"], **extra, **kw)
        made.append((ln, out, store))
    return made


def launch_together(made, fn):
    """fn(launcher) for every launcher of `made` at once: the side streams
    wait for the current stream, which then waits for them (a mesh
    block's fork and join)."""
    import torch
    cur = torch.cuda.current_stream()
    fork = torch.cuda.Event()
    fork.record(cur)
    for ln, _, _ in made[1:]:
        ln.stream.wait_event(fork)
    for ln, _, _ in made:
        fn(ln)
    for ln, _, _ in made[1:]:
        done = torch.cuda.Event()
        done.record(ln.stream)
        cur.wait_event(done)


def block_digests(made, inp):
    """Digests of what launch bt of each launcher (shard s of `made`)
    wrote: its block-removed O, E, its block rows, its slots' cache, ybuf
    and kbuf rows and r."""
    import torch
    torch.cuda.synchronize()
    out, bt = [], inp["bt"]
    for s, (ln, rows, store) in enumerate(made):
        sl = inp["tabs"].slots[s][bt].long()
        got = [*ln.removed(bt), ln.brows[bt & 1], *(r[sl] for r in rows)]
        if store is not None:
            got.append(store[sl[sl < store.shape[0]]])
        out.append([tensor_digest(t) for t in got])
    return out


def block_run(root: str) -> dict:
    """The per-block entry of the checkout at `root` (its package and
    kernels): for each of BLOCK_ENTRIES, both precisions, with and without
    the folded re-add, shard 0's launch of block bt alone and the four
    shards' launches at once: the digests of what each launch wrote and ms
    per launch (or per four-shard block) by CUDA events over BLOCK_REPS.
    Runs in a process of its own (`--block-run`), so two checkouts'
    packages do not meet."""
    import torch
    ht, mods = import_checkout(root)
    fe = mods[4]
    X, batches, _ = synthetic()
    inp = mesh_block_inputs(mods, X, batches)
    bt = inp["bt"]
    out = dict(root=root, block=bt, digests={}, ms={})
    for entry in BLOCK_ENTRIES:
        for prec in PRECISIONS:
            made = block_launchers(fe, inp, entry, MESH_SHARDS,
                                   precision=prec)
            launch_together(made, lambda ln: ln.launch(bt - 1))
            for fold in (False, True):
                key = f"{entry},{prec},fold={fold}"
                made[0][0].launch(bt, fold)
                out["digests"][key + ",alone"] = block_digests(made[:1], inp)
                out["ms"][key + ",alone"] = cuda_ms(
                    lambda: made[0][0].launch(bt, fold), reps=BLOCK_REPS)
                launch_together(made, lambda ln: ln.launch(bt, fold))
                out["digests"][key + ",four"] = block_digests(made, inp)
                out["ms"][key + ",four"] = cuda_ms(lambda: launch_together(
                    made, lambda ln: ln.launch(bt, fold)),
                    reps=BLOCK_REPS // 2)
            del made
    # The 4-shard K1 pass (every block, the folded re-adds, the last
    # re-add) through one plan, as a fit runs it.
    for prec in PRECISIONS:
        def mesh_pass():
            return fe.fused_estep_mesh(
                inp["tabs"], inp["ZP3s"], *inp["consts"], inp["O"],
                inp["E"], False, inp["J_fix"], precision=prec)
        with fe.mesh_plans():
            m = mesh_pass()
            out["digests"][f"pass,{prec}"] = [tensor_digest(t) for t in (
                m[0], m[1], *m[2], *m[3], *m[4])]
            out["ms"][f"pass,{prec}"] = cuda_ms(mesh_pass, reps=30,
                                                warmup=3)
    return out


def block_timing(root: str) -> dict:
    """The stamped per-block entry (ops/cuda/block_timing.py) of the
    checkout at `root`: K1 and K2 (fp32 R) one pass, with and without the
    folded re-add, shard 0's launch of block bt alone and the four shards'
    launches at once, under each tail the checkout has (fe.BLOCK_TAILS:
    the cluster and the ticket tail); per case the decode
    (block_timing.decode) of the stamped launch of median span of
    BLOCK_STAMPED, and the spans of all; the stamped launches' outputs
    equal to the unstamped ones' (digests); the stamps' cost (ms of a
    stamped and an unstamped launch of the shape's own tail, in turns)."""
    import torch
    ht, mods = import_checkout(root, ["fused_estep_block_timed"])
    fe = mods[4]
    from harmonypy_tpu_torch.ops.cuda import block_timing as bt_mod
    names = bt_mod.stamp_names()
    X, batches, _ = synthetic()
    inp = mesh_block_inputs(mods, X, batches)
    bt = inp["bt"]
    out = dict(root=root, block=bt, names=names, cases={})
    tails = getattr(fe, "BLOCK_TAILS", (None,))
    for entry, tail in [(e, t) for t in tails for e in ("k1", "k2_fp32")]:
        kw = {} if tail is None else dict(tail=tail)
        timed = block_launchers(fe, inp, entry, MESH_SHARDS,
                                make=bt_mod.launcher, **kw)
        plain = block_launchers(fe, inp, entry, MESH_SHARDS,
                                precision="default")
        stamps = [bt_mod.stamp_buffer(ln) for ln, _, _ in timed]
        grid = stamps[0].numel() // (len(names) + bt_mod.N_SPAN)
        ix = {id(ln): s for s, (ln, _, _) in enumerate(timed)}

        def stamped(ln, b, fold):
            bt_mod.launch(ln, b, fold, stamps[ix[id(ln)]])
        launch_together(timed, lambda ln: stamped(ln, bt - 1, False))
        launch_together(plain, lambda ln: ln.launch(bt - 1))
        for fold in (False, True):
            stamped(timed[0][0], bt, fold)
            plain[0][0].launch(bt, fold)
            check(block_digests(timed[:1], inp)
                  == block_digests(plain[:1], inp),
                  f"the stamped {entry} launch (fold {fold}) differs from "
                  f"the unstamped one")
            for mode, made in (("alone", timed[:1]), ("four", timed)):
                runs = []
                for _ in range(BLOCK_STAMPED + 1):
                    for st in stamps:
                        st.zero_()
                    launch_together(made, lambda ln: stamped(ln, bt, fold))
                    torch.cuda.synchronize()
                    runs.append(bt_mod.decode(
                        [st.cpu().numpy() for st in stamps[:len(made)]],
                        grid, names))
                runs = runs[1:]
                order = sorted(range(len(runs)),
                               key=lambda i: runs[i]["span_us"])
                case = f"{entry},fold={fold},{mode}"
                if tail is not None:
                    case += f",tail={tail}"
                out["cases"][case] = dict(
                    spans_us=[r["span_us"] for r in runs],
                    **runs[order[len(runs) // 2]])
        if entry == "k1" and tail == tails[0]:
            pair = [[], []]
            for _ in range(3):
                pair[0].append(cuda_ms(lambda: stamped(timed[0][0], bt,
                                                       True),
                                       reps=BLOCK_REPS))
                pair[1].append(cuda_ms(lambda: plain[0][0].launch(bt, True),
                                       reps=BLOCK_REPS))
            out["stamp_cost"] = dict(timed_ms=pair[0], untimed_ms=pair[1])
        del timed, plain
    from harmonypy_tpu_torch.ops.cuda import build
    out["ptxas"] = {k: v for k, v in ptxas_kernels(build.build_log).items()
                    if "block" in k}
    out["nvidia_smi"] = smi_line()
    return out


def ptxas_apart(roots, sources):
    """ptxas_kernels of csrc/<source>.cu for each source of each checkout
    in `roots`, each compiled apart into a temporary directory, all at
    once (a checkout's build directory may hold libraries built earlier,
    which leave no report). Returns one report per root."""
    import shutil
    import tempfile
    from harmonypy_tpu_torch.ops.cuda import build
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ptxas_")
    try:
        comp = [[subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o",
             os.path.join(tmp, f"{i}_{src}.so"),
             os.path.join(root, "harmonypy_tpu_torch", "csrc", src + ".cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src in sources] for i, root in enumerate(roots)]
        reports = []
        for procs in comp:
            logs = {}
            for src, c in zip(sources, procs):
                logs[src] = c.communicate()[0]
                check(c.returncode == 0, f"nvcc failed:\n{logs[src][-3000:]}")
            reports.append(ptxas_kernels(logs))
        return reports
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def block_ab(parent: str) -> int:
    """The per-block entry of the parent checkout at `parent` and of this
    one: both built at once, then block_run in the order parent, this,
    this, parent, parent, this, each in a process of its own. Checks that
    every digest of every run equals the first run's (the change keeps the
    parent's bits); prints each run, each checkout's ms per case (mean and
    turns), whether the change was faster in every turn, whether the
    one-launch round's 48 instantiations (both variants, compiled apart)
    have the parent's registers, stack and spills, and this checkout's
    stamped split (block_timing)."""
    sys.path.insert(0, HERE)
    builds = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--round-build",
         os.path.abspath(root)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=HERE)
        for root in (parent, HERE)]
    round_ptxas = ptxas_apart((parent, HERE), ("fused_estep",
                                               "fused_estep_one"))
    reports = []
    for b in builds:
        o, e = b.communicate(timeout=900)
        check(b.returncode == 0, f"build failed:\n{o[-2000:]}{e[-3000:]}")
        reports.append(json.loads(o.strip().splitlines()[-1]))
    emit(dict(phase="block_ab_build", builds=reports))
    runs = []
    for root in (parent, HERE, HERE, parent, parent, HERE):
        runs.append(round_sub("--block-run", root, 600))
        emit(dict(phase="block_ab_run", root=runs[-1]["root"],
                  ms=runs[-1]["ms"]))
    for r in runs[1:]:
        check(r["digests"] == runs[0]["digests"],
              f"per-block digests of {r['root']} differ from "
              f"{runs[0]['root']}")
    par, chg = runs[0::3] + runs[4:5], runs[1:3] + runs[5:]
    keys = list(runs[0]["ms"])
    emit(dict(phase="block_ab", nvidia_smi=smi_line(), block=runs[0]["block"],
              digests_equal=True, digests=len(runs[0]["digests"]),
              parent={k: [r["ms"][k] for r in par] for k in keys},
              change={k: [r["ms"][k] for r in chg] for k in keys},
              parent_mean={k: sum(r["ms"][k] for r in par) / 3 for k in keys},
              change_mean={k: sum(r["ms"][k] for r in chg) / 3 for k in keys},
              faster_every_turn={k: max(r["ms"][k] for r in chg)
                                 < min(r["ms"][k] for r in par)
                                 for k in keys},
              round_ptxas_same=(round_ptxas[0] == round_ptxas[1]
                                and len(round_ptxas[0]) == 48),
              round_ptxas=round_ptxas[1]))
    emit(dict(phase="block_timing",
              **round_sub("--block-timing", HERE, 600)))
    return 0


def cards_pass(parent: str) -> int:
    """`--cards-pass PARENT`, on a machine with several cards: one NCCL
    rank per card (each checkout's own `chip_smoke.py --mp-worker`, its
    own package and kernels, both built first), the 858k deferred fit and
    a replayed mesh pass timed by CUDA events, in the order parent, this,
    this, parent. Checks that every run's fit digests equal the first's;
    prints each run (ms per pass per rank, the fit's wall s, the pass
    profile of rank 0) and each checkout's means."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    check(cards >= 2, f"--cards-pass needs several CUDA cards, found {cards}")
    builds = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--round-build",
         os.path.abspath(root)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=HERE)
        for root in (parent, HERE)]
    for b in builds:
        o, e = b.communicate(timeout=900)
        check(b.returncode == 0, f"build failed:\n{o[-2000:]}{e[-3000:]}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cp_")
    runs = []
    try:
        X, batches, groups = synthetic()
        np.savez(os.path.join(tmp, "data.npz"), X=X, batches=batches,
                 groups=groups)
        for i, root in enumerate((parent, HERE, HERE, parent)):
            res = run_workers(f"cp{i}", "nccl", [[f"cuda:{c}"] for c in
                                                 range(cards)], ["deferred"],
                              tmp, script=os.path.join(
                                  os.path.abspath(root), "chip_smoke.py"))
            fit = [r["fits"]["deferred"] for r in res]
            runs.append(dict(
                root=root, ms_per_pass=[r["ms_per_pass"] for r in res],
                fit_s=[f["wall_s"] for f in fit], passes=fit[0]["passes"],
                digests=fit[0]["digests"],
                pass_profile=res[0]["pass_profile"]))
            emit(dict(phase="cards_pass_run", **runs[-1]))
            check(all(f["digests"] == runs[0]["digests"] for f in fit),
                  f"the ranks of {root} differ from the first run's fit")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def mean(rs):
        return dict(ms_per_pass=sum(max(r["ms_per_pass"]) for r in rs)
                    / len(rs), fit_s=sum(max(r["fit_s"]) for r in rs)
                    / len(rs))
    emit(dict(phase="cards_pass", nvidia_smi=smi_line(), cards=cards,
              digests_equal=True, parent=mean([runs[0], runs[3]]),
              change=mean(runs[1:3]),
              ms_turns=[max(r["ms_per_pass"]) for r in runs]))
    return 0


def cards_main() -> int:
    """`--cards`: on a machine with several cards, only what exists across
    cards, and what it is compared with: the one-device 858k fits and
    phase lisi (the references), then the mesh of every card
    (mesh_path_checks: the three fits bitwise with their launches and
    per-card peaks, per-cell, LISI, resume), the mesh round with the lead
    card not the current device, and one NCCL rank per card (the deferred
    fit, the per-cell and LISI tasks), as phases mesh and multiprocess
    run them there. The last line is {"ok": true, ...}."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < 2:
        print(f"chip_smoke --cards: needs several CUDA cards, found {cards}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import harmonypy_tpu_torch as ht
    from harmonypy_tpu_torch import config, engine, layout, state
    from harmonypy_tpu_torch.ops import partition, update_r_fused
    from harmonypy_tpu_torch.ops.cuda import build
    from harmonypy_tpu_torch.ops.cuda import fused_estep as fe
    from harmonypy_tpu_torch.parallel.mesh import make_mesh
    smi = smi_line()
    t0 = time.perf_counter()
    build.build_all()
    emit(dict(phase="device", nvidia_smi=smi, cards=cards,
              build_s=time.perf_counter() - t0))
    X, batches, groups = synthetic()
    meta = batch_meta(batches)
    refs = {}
    for name, kw in (("deferred", {}), ("stored", dict(defer_r=False)),
                     ("low_memory", dict(defer_r=False, low_memory=True))):
        timed_fit(ht, fe, X, meta, **kw)
        refs[name] = timed_fit(ht, fe, X, meta, **kw)[0]
    lisi_ref = phase_lisi(ht, refs["deferred"].Z_corr, batches, groups)
    mods = (config, engine, layout, partition, fe, update_r_fused, state)
    real, counts = mesh_path_checks(ht, fe, X, batches, groups, meta,
                                    make_mesh(), refs, lisi_ref)
    real["lead_not_current"] = mesh_cards_round_checks(
        mods, X, batches,
        make_mesh([f"cuda:{i}" for i in reversed(range(cards))]))
    emit(dict(phase="mesh_cards", nvidia_smi=smi, real_cards=real))
    want = {name: fit_digests(ho) for name, ho in refs.items()}
    want["lisi"] = [digest(a) for a in lisi_ref]
    want["percell"] = {cards: percell_refs(ht, cards)}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mp_")
    try:
        np.savez(os.path.join(tmp, "data.npz"), X=X, batches=batches,
                 groups=groups)
        t0 = time.perf_counter()
        res = run_workers("cards", "nccl", [[f"cuda:{i}"] for i in
                                            range(cards)], ["deferred"],
                          tmp, False, None, ("percell", "lisi"))
        out = dict(backend="nccl", ranks=cards,
                   command_s=time.perf_counter() - t0,
                   workers=check_workers("cards", res, want, True))
        check(not any(w["host_waited_in_block_loop"]
                      for w in out["workers"]),
              "NCCL: the host waited inside the block loop")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit(dict(phase="multiprocess_cards", nvidia_smi=smi, cards=out))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": cards}})
    return 0


def shapes_main(which: str) -> int:
    """Phase shapes alone (`--shapes all|wide`: every shape, or the wide
    designs), after building the round's and the per-block libraries."""
    import torch
    check(torch.cuda.is_available(), "no CUDA device")
    sys.path.insert(0, HERE)
    from harmonypy_tpu_torch import config, engine, layout, state
    from harmonypy_tpu_torch.ops import partition, update_r_fused
    from harmonypy_tpu_torch.ops.cuda import build
    from harmonypy_tpu_torch.ops.cuda import fused_estep as fe
    build.build_all()
    emit(dict(phase="ptxas", kernels=ptxas_kernels(build.build_log)))
    mods = (config, engine, layout, partition, fe, update_r_fused, state)
    phase_shapes(mods, WIDE_SHAPES if which == "wide"
                 else SHAPES + WIDE_SHAPES)
    emit({"ok": True, "device": torch.cuda.get_device_name(0)})
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import harmonypy_tpu_torch as ht
    check(os.path.dirname(os.path.abspath(ht.__file__))
          == os.path.join(HERE, "harmonypy_tpu_torch"),
          f"harmonypy_tpu_torch imported from {ht.__file__}, not {HERE}")
    from harmonypy_tpu_torch import config, engine, layout, state
    from harmonypy_tpu_torch.ops import partition, update_r_fused
    from harmonypy_tpu_torch.ops.cuda import build
    from harmonypy_tpu_torch.ops.cuda import fused_estep as fe

    smi = smi_line()
    t0 = time.perf_counter()
    build.build_all()
    for one in (False, True):
        fe._kernel_lib(one)
        fe._block_lib(one)
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for log in build.build_log.values()
             for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    emit(dict(phase="ptxas", kernels=ptxas_kernels(build.build_log),
              lines=ptxas))
    emit(dict(phase="device", nvidia_smi=smi,
              name=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda, python=sys.version.split()[0],
              allow_tf32=torch.backends.cuda.matmul.allow_tf32,
              build_s=build_s, build_seconds=build.build_seconds,
              ptxas=build.build_log))
    X, batches, groups = synthetic()
    mods = (config, engine, layout, partition, fe, update_r_fused, state)
    geom, args, (cfg, _, st) = round_inputs(mods, X, batches,
                                            with_state=True)
    del st
    kinfo, k1_dev_ms, winfo = phase_kernel(mods, cfg, geom, args)
    k2info, k2_dev_ms = phase_kernel2(mods, cfg, geom, args)
    del args
    phase_shapes(mods)
    launches, meta, fit_ho, fit_peak, fit32 = phase_fit(ht, fe, X, batches)
    launches_r, fits, stored_hos = phase_fit_stored(ht, fe, X, meta)
    phase_products(ht, fe, X, meta)
    fits["deferred"] = (fit_ho.cfg, fit_peak)
    refs = dict(deferred=fit_ho, stored=stored_hos["stored"],
                low_memory=stored_hos["low_memory"])
    phase_profile(ht, X, meta, "deferred")
    phase_profile(ht, X, meta, "stored", defer_r=False)
    phase_profile_fit(ht, mods, X, batches, smi, k1_dev_ms["default"],
                      k2_dev_ms["default"], kinfo["float32"]["bound_ms"])
    phase_precision(ht, fe, X, meta, smi)
    phase_io()
    phase_golden(ht)
    phase_golden_default(ht)
    phase_lisi_golden(ht)
    lisi_ref = phase_lisi(ht, fit_ho.Z_corr, batches, groups)
    phase_checkpoint(ht)
    phase_cli(ht)
    phase_capacity(fits)
    minfo = phase_mesh(ht, mods, X, batches, groups, meta,
                       dict(refs, deferred_float32=fit32,
                            stored_float32=stored_hos["stored_float32"]),
                       lisi_ref)
    phase_multiprocess(refs, X, batches, groups, smi, lisi_ref)
    # The r window's launches on the default deferred fit: its passes
    # that were not k-means rounds (the ridge's replays).
    window_launches = launches["default"] - sum(fit_ho.kmeans_rounds)
    del fit_ho, stored_hos, fit32, refs
    src = "harmonypy_tpu_torch/csrc/fused_estep.cu"
    block_src = "harmonypy_tpu_torch/csrc/fused_estep_block.cu"
    pallas = "harmonypy_tpu/ops/pallas/update_r_fused.py"
    # Each kernel with its launches on its path's fit: the 3xTF32 variants
    # on the float32 fits, the one-pass variants on the default fits.
    emit({"kernels": [
        dict(name="fused_estep", route="cuda", source=src,
             replaces=f"{pallas}:117", launches=launches["float32"],
             **kinfo["float32"], library_ms=None),
        dict(name="fused_estep_write_r", route="cuda", source=src,
             replaces=f"{pallas}:109",
             launches=launches_r["stored_float32"],
             **k2info["float32", "float32"], library_ms=None),
        dict(name="fused_estep_one_pass", route="cuda", source=src,
             replaces=f"{pallas}:117", launches=launches["default"],
             **kinfo["default"], library_ms=None),
        dict(name="fused_estep_r_window_one_pass", route="cuda", source=src,
             replaces=f"{pallas}:117", launches=window_launches, **winfo,
             library_ms=None),
        dict(name="fused_estep_write_r_one_pass", route="cuda", source=src,
             replaces=f"{pallas}:109", launches=launches_r["stored"],
             **k2info["default", "float32"], library_ms=None),
        dict(name="fused_estep_write_r_bf16_one_pass", route="cuda",
             source=src, replaces=f"{pallas}:109",
             launches=launches_r["low_memory"],
             **k2info["default", "bfloat16"], library_ms=None),
        dict(name="fused_estep_block", route="cuda", source=block_src,
             replaces=f"{pallas}:117", **minfo["k1"], library_ms=None),
        dict(name="fused_estep_block_write_r", route="cuda",
             source=block_src, replaces=f"{pallas}:109", **minfo["k2"],
             library_ms=None),
        dict(name="fused_estep_block_one_pass", route="cuda",
             source=block_src, replaces=f"{pallas}:117", **minfo["k1_one"],
             library_ms=None),
        dict(name="fused_estep_block_write_r_one_pass", route="cuda",
             source=block_src, replaces=f"{pallas}:109",
             **minfo["k2_one"], library_ms=None),
        dict(name="frame_readd", route="cuda",
             source="harmonypy_tpu_torch/csrc/frame_readd.cuh",
             replaces=f"{pallas}:215", **minfo["readd"], library_ms=None)]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--mp-worker":
        mp_worker(json.loads(sys.argv[2]))
        sys.exit(0)
    if len(sys.argv) == 3 and sys.argv[1] == "--mesh-timing":
        emit(mesh_timing(sys.argv[2]))
        sys.exit(0)
    if len(sys.argv) == 3 and sys.argv[1] == "--mesh-ab":
        sys.exit(mesh_ab(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] in ("--round-timing",
                                              "--round-build"):
        import torch
        check(torch.cuda.is_available(), "no CUDA device")
        emit((round_timing if sys.argv[1] == "--round-timing"
              else round_build)(sys.argv[2]))
        sys.exit(0)
    if len(sys.argv) == 3 and sys.argv[1] == "--round-ab":
        sys.exit(round_ab(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] in ("--block-run",
                                              "--block-timing"):
        import torch
        check(torch.cuda.is_available(), "no CUDA device")
        emit((block_run if sys.argv[1] == "--block-run"
              else block_timing)(sys.argv[2]))
        sys.exit(0)
    if len(sys.argv) == 3 and sys.argv[1] == "--block-ab":
        sys.exit(block_ab(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--cards-pass":
        sys.exit(cards_pass(sys.argv[2]))
    if len(sys.argv) == 2 and sys.argv[1] == "--cards":
        sys.exit(cards_main())
    if len(sys.argv) == 3 and sys.argv[1] == "--shapes":
        sys.exit(shapes_main(sys.argv[2]))
    sys.exit(main())
