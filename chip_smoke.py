#!/usr/bin/env python3
"""Smoke test of harmonypy_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written kernels from the checkout, then, printing one JSON
line per phase:
  1. ptxas    registers, shared memory and spills of every kernel built;
     device   the card (nvidia-smi name and power limit), torch/CUDA
              versions, the kernel build time;
  2. kernel   the deferred-R E-step kernel K1 against its plain PyTorch
              version at the full 858,000 x 29 PCs, K=100, B=3, CH=2048
              shape (data made from a seed as bench.py makes it): one round
              and one r-window replay, tolerances below, bitwise repeat,
              and the replay's per-chunk stats equal to the round's cache
              bitwise; ms per round by CUDA events and by the profiler's
              kernel time, launches per round (1), both bounds and the
              roofline shares;
  2b. kernel2 the stored-R kernel K2 (write_r) on the same round inputs,
              fp32 and bf16 R: against its plain version, its stats and fp32
              r equal to K1's round and r window bitwise, its bf16 R equal
              to K1's r rounded to bf16, the dummy chunk zero, a bitwise
              repeat, its times, launches and bounds;
  2c. shapes  the checks of 2 and 2b at small N for odd shapes (K in
              {7, 100, 200, 280}, d in {5, 30, 50}, B in {1, 3, 5}, CH in
              {128, 2048}), both objective forms;
  3. fit      run_harmony on that data on the card, default parameters (the
              deferred-R fit): wall clock of 3 fits after a warm-up fit,
              peak device memory, k-means rounds, objective, and the kernel
              launch count, which must be one per E-step pass the engine
              ran;
  3b. fit_stored  the stored-R fits (defer_r=False, in fp32 and with
              low_memory=True) on that data: the same numbers, K2 launches
              = k-means rounds; then the stored fit against the deferred fit
              of the same seed, every round run, at the JAX package's
              tolerances for its two paths (tests/test_defer.py:62-76);
  3c. profile one deferred and one stored fit under torch.profiler: device
              busy time by kernel, the device's idle share, and the host and
              device spans of the engine's ranges (harmony::init,
              ::cluster, ::ridge_replay or ::ridge);
  4. golden   pbmc_3500 with chunk_size=128 on the card: per-PC Pearson r
              against the R package's output >= 0.99;
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
              (no r, r window, K2 fp32 / bf16), a bitwise repeat, the mesh
              round (every shard and block, the frame re-add) equal to the
              one-launch round bitwise, ms per launch and per pass, bounds;
              the deferred, stored and low_memory fits bitwise equal to
              phases fit / fit_stored (Z_corr, R, histories, kmeans_rounds)
              with blocks x shards per-block launches per pass and their
              wall clock; pbmc per-cell fit within 5e-4 max|Z| of one device
              at 3 iterations, the default fit at the golden gate;
              compute_lisi on the mesh fit's output equal to phase lisi's
              values bitwise (pruned, and brute on the sampled queries); a
              resume on the mesh bitwise, one on 2 shards refused; each
              mesh fit's peak device memory per card under memory_envelope;
              the same checks but the per-block ones on a mesh of every
              card when there are several;
  6. kernels  every kernel with its launches on its path's fit, error
              against the plain version, time, and bound.
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
# H100 SXM published peaks (NVIDIA H100 datasheet): fp32 on CUDA cores,
# TF32 on tensor cores (dense), HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_S = 3.35e12
# Kernel vs plain tolerances (rtol, atol): both sum the same fp32 products
# in a different order (tile partials vs one batched matmul), over 2048-cell
# chunks for cache/ybuf/kbuf and ~43k-cell blocks for O/E; r is in [0, 1].
TOL = dict(O=(1e-5, 1e-3), E=(1e-5, 1e-3), cache=(1e-5, 1e-4),
           ybuf=(1e-5, 1e-4), kbuf=(1e-5, 1e-3), r=(1e-5, 1e-5))
# A bf16 R is held at one bf16 ulp (bit patterns at most 1 apart): an fp32
# difference of ~1e-7 at a rounding midpoint moves the stored value by one.
# The stored fit against the deferred fit: tests/test_defer.py:62-76.
TOL_FIT = dict(Z_corr=(2e-4, 2e-4), R=(1e-3, 2e-5))


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


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


def round_inputs(ht_mods, X, batches, n_clusters=K, chunk=CHUNK,
                 with_state=False):
    """The main path's own inputs of one E-step round (the full shape by
    default): init statistics and one round's tables. with_state: also
    return (cfg, the round's blocks, the init state)."""
    import numpy as np
    import torch
    (config, engine, layout, partition, fe, plain_mod, state_mod) = ht_mods
    dev = torch.device("cuda")
    (N, d), B = X.shape, int(batches.max()) + 1
    cfg = config.EngineConfig(N=N, d=d, K=n_clusters, B=B, n_devices=1,
                              use_fused_xla=True, defer_r=True,
                              chunk_size=chunk)
    geom = partition.partition_geometry(cfg)
    Phi = (batches[None, :] == np.arange(B)[:, None]).astype(np.float32)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    data = state_mod.HarmonyData(Z_orig=t(layout.pad_cells(X.T, cfg)),
                                 Phi=t(layout.pad_cells(Phi, cfg)),
                                 mask=t(layout.shard_mask(cfg)))
    params = state_mod.HarmonyParams(
        theta=t(np.full(B, 2.0)), sigma=t(np.full(n_clusters, 0.1)),
        lamb=t([0.0] + [1.0] * B), Pr_b=t(Phi.mean(axis=1)))
    gen = torch.Generator(device=dev)
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


def round_bound(geom, r_bytes=0):
    """Least work of one round: every real cell once; K2 also writes R
    (r_bytes per element of the (nc1, K, CH) store). bound_ms takes the
    products and the wdiv Phi weights at the fp32 CUDA-core rate (the bound
    kept since PR 1); bound_tc_ms takes the two products as 3xTF32 on the
    tensor cores (3 passes at the dense TF32 rate) and wdiv Phi at the fp32
    rate, against the same bytes."""
    R = 1 + N_BATCHES + N_PCS
    products = N_CELLS * (2 * N_PCS * K + 2 * K * R)
    weights = N_CELLS * 2 * K * N_BATCHES
    flops = products + weights
    nbytes = (4 * (N_CELLS * R + (geom.nc_cap + 1) * (K * R + 2))
              + r_bytes * (geom.nc_cap + 1) * K * geom.CH)
    bound = dict(flop=flops, bytes=nbytes,
                 ops_ms=flops / PEAK_FP32_FLOPS * 1e3,
                 bytes_ms=nbytes / PEAK_BYTES_S * 1e3,
                 ops_tc_ms=(3 * products / PEAK_TF32_FLOPS
                            + weights / PEAK_FP32_FLOPS) * 1e3)
    bound["bound_ms"] = max(bound["ops_ms"], bound["bytes_ms"])
    bound["bound_by"] = ("operations" if bound["ops_ms"] >= bound["bytes_ms"]
                         else "bytes")
    bound["bound_tc_ms"] = max(bound["ops_tc_ms"], bound["bytes_ms"])
    return bound


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


def check_k1(fe, plain_mod, args, fast, lo, width):
    """K1 (round with an r window) against its plain version at TOL, a
    bitwise repeat, and the round without a window equal to it bitwise.
    Returns (errors, K1 outputs, round outputs)."""
    import torch
    kern = fe.fused_estep(*args, fast, lo=lo, width=width)
    plain = plain_mod.fused_update_nor(*args, fast, lo=lo, width=width)
    torch.cuda.synchronize()
    names = ("O", "E", "cache", "ybuf", "kbuf", "r")
    errs = {n: diff(a, b, *TOL[n]) for n, a, b in zip(names, kern, plain)}
    for n, (_, _, ratio) in errs.items():
        check(ratio <= 1.0, f"K1 vs plain {n} (fast_objective={fast}) beyond"
                            f" rtol/atol {TOL[n]}: {errs}")
    again = fe.fused_estep(*args, fast, lo=lo, width=width)
    rnd = fe.fused_estep(*args, fast)
    check(all(torch.equal(a, b) for a, b in zip(kern, again)),
          "K1 repeat is not bitwise equal")
    check(all(torch.equal(a, b) for a, b in zip(kern[:5], rnd[:5])),
          "replay stats differ from the round's bitwise")
    return errs, kern, rnd


def check_k2(fe, plain_mod, args, fast, dt, k1_round, k1_r, k1_w, lo,
             width):
    """K2 with an R3 of dtype dt against its plain version (bf16 R within
    one ulp), and bitwise: a repeat, its stats equal to K1's round, its R
    equal to K1's r (fp32) or K1's r rounded to bf16, its fp32 R window
    equal to K1's r window, the dummy chunk zero. Returns the errors."""
    import torch
    nc1, _, CH = args[2].shape
    nc, Kc = nc1 - 1, args[3].shape[1]

    def k2():
        R3 = torch.empty((nc1, Kc, CH), dtype=dt, device="cuda")
        return fe.fused_estep_r(args[0], args[1], args[2], R3, *args[3:],
                                fast)

    kern = k2()
    plain = plain_mod.fused_update_r(
        args[0], args[1], args[2],
        torch.empty((nc1, Kc, CH), dtype=dt, device="cuda"), *args[3:], fast)
    torch.cuda.synchronize()
    names = ("r", "O", "E", "cache", "ybuf", "kbuf")
    errs = {n: diff(a.float(), b.float(), *TOL[n])
            for n, a, b in zip(names, kern, plain)}
    tag = f"({dt}, fast_objective={fast})"
    if dt == torch.bfloat16:
        ulps = bf16_ulps(kern[0], plain[0])
        check(ulps <= 1, f"K2 bf16 R vs plain: {ulps} bf16 ulps {tag}")
        errs["r"] = (float((kern[0].float() - plain[0].float()).abs().max()),
                     errs["r"][1], 0.0)
    for n, (_, _, ratio) in errs.items():
        check(ratio <= 1.0, f"K2 vs plain {n} {tag} beyond {TOL[n]}: {errs}")
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


def phase_kernel(ht_mods, geom, args):
    (config, engine, layout, partition, fe, plain_mod, state_mod) = ht_mods
    lo, width = 200, 16
    res = {}
    for fast in (False, True):
        errs, _, _ = check_k1(fe, plain_mod, args, fast, lo, width)
        res[f"fast_objective={fast}"] = dict(
            max_abs={n: e[0] for n, e in errs.items()},
            max_rel={n: e[1] for n, e in errs.items()},
            repeat_bitwise=True, replay_equals_round_bitwise=True)
    bound = round_bound(geom)
    t = timing(fe, lambda: fe.fused_estep(*args, False), bound)
    check(t["launches_per_round"] == 1,
          f"K1 launched {t['launches_per_round']} kernels per round")
    plain_ms = cuda_ms(lambda: plain_mod.fused_update_nor(*args, False),
                       reps=5, warmup=1)
    max_abs = max(v for r in res.values() for v in r["max_abs"].values())
    emit(dict(phase="kernel", shape=dict(N=N_CELLS, d=N_PCS, K=K,
                                         B=N_BATCHES, CH=CHUNK,
                                         chunks=geom.nc_cap, J=geom.J_shard,
                                         n_blocks=geom.nb),
              grid=fe.launch_grid(K, N_BATCHES, N_PCS),
              tolerance=TOL, results=res, ms_per_round=t["ms"],
              device_ms_per_round=t["device_ms"],
              plain_ms_per_round=plain_ms, **{k: v for k, v in t.items()
                                               if k not in ("ms", "device_ms")},
              bound=bound))
    return dict(ms=t["ms"], plain_ms=plain_ms, max_abs_err=max_abs,
                bound_ms=bound["bound_ms"], bound_by=bound["bound_by"])


def bf16_ulps(a, b) -> int:
    """Largest distance in bf16 bit patterns between two non-negative bf16
    tensors."""
    import torch
    ia = a.contiguous().view(torch.int16).to(torch.int32)
    ib = b.contiguous().view(torch.int16).to(torch.int32)
    return int((ia - ib).abs().max())


def phase_kernel2(ht_mods, geom, args):
    """K2 on the round of phase kernel, fp32 and bf16 R, both objective
    forms: against its plain version, and bitwise against K1."""
    import torch
    (config, engine, layout, partition, fe, plain_mod, state_mod) = ht_mods
    dev = torch.device("cuda")
    nc, CH = geom.nc_cap, geom.CH
    dtypes = dict(float32=torch.float32, bfloat16=torch.bfloat16)
    width = 16
    lo = min(200, nc - width)

    res, max_abs = {}, 0.0
    for fast in (False, True):
        k1 = fe.fused_estep(*args, fast)
        k1r = fe.fused_estep(*args, fast, lo=0, width=nc)[5]
        k1w = fe.fused_estep(*args, fast, lo=lo, width=width)[5]
        for name, dt in dtypes.items():
            errs = check_k2(fe, plain_mod, args, fast, dt, k1, k1r, k1w, lo,
                            width)
            max_abs = max(max_abs, *(e[0] for e in errs.values()))
            res[f"{name},fast_objective={fast}"] = dict(
                max_abs={n: e[0] for n, e in errs.items()},
                max_rel={n: e[1] for n, e in errs.items()},
                repeat_bitwise=True, stats_equal_k1_round=True,
                r_equals_k1_r=True, r_window_equals_k1=True,
                dummy_chunk_zero=True)
        del k1, k1r, k1w

    # K1 and K2 (fp32, bf16) timed in turns, three times over: the spread
    # within one call, and K2's cost over K1 on the same card.
    R3s = {name: torch.empty((nc + 1, K, CH), dtype=dt, device=dev)
           for name, dt in dtypes.items()}
    runs = dict(k1=lambda: fe.fused_estep(*args, False),
                **{name: (lambda R3=R3: fe.fused_estep_r(
                    args[0], args[1], args[2], R3, *args[3:], False))
                   for name, R3 in R3s.items()})
    samples = {n: [] for n in runs}
    for _ in range(3):
        for n, fn in runs.items():
            samples[n].append(cuda_ms(fn, reps=20))
    times = {n: dict(ms=sorted(v)[1], ms_samples=v) for n, v in samples.items()}
    for name, R3 in R3s.items():
        fn = runs[name]
        bound = round_bound(geom, r_bytes=R3.element_size())
        t = timing(fe, fn, bound)
        check(t["launches_per_round"] == 1,
              f"K2 {name} launched {t['launches_per_round']} kernels")
        times[name].update(
            device_ms=t["device_ms"],
            launches_per_round=t["launches_per_round"],
            profiler_launches_per_round=t["profiler_launches_per_round"],
            roofline_share=bound["bound_ms"] / times[name]["ms"],
            roofline_share_tc=bound["bound_tc_ms"] / times[name]["ms"],
            bound=bound,
            plain_ms=cuda_ms(lambda R3=R3: plain_mod.fused_update_r(
                args[0], args[1], args[2], R3, *args[3:], False), reps=5,
                warmup=1))
    emit(dict(phase="kernel2", tolerance=TOL, bf16_r_tolerance="1 bf16 ulp",
              grid_bf16=fe.launch_grid(K, N_BATCHES, N_PCS, True),
              results=res, times=times))
    t32 = times["float32"]
    return dict(ms=t32["ms"], plain_ms=t32["plain_ms"], max_abs_err=max_abs,
                bound_ms=t32["bound"]["bound_ms"],
                bound_by=t32["bound"]["bound_by"])


# Shapes of phase shapes: (N, d, K, B, CH). Every K in {7, 100, 200}, d in
# {5, 30, 50}, B in {1, 3, 5} and CH in {128, 2048} appears; the last two
# take the kernel's compact layout (operands split at each load).
SHAPES = [(6_000, 5, 7, 1, 128), (6_000, 30, 100, 3, 128),
          (45_000, 5, 200, 1, 2048), (45_000, 50, 7, 3, 2048),
          (6_000, 5, 100, 5, 128), (45_000, 50, 200, 5, 2048),
          (6_000, 30, 280, 3, 128)]


def phase_shapes(ht_mods):
    """K1 (round and r window), K2 fp32 and K2 bf16 against their plain
    versions and each other at small N and odd shapes, both objective
    forms, with the checks of phases kernel and kernel2."""
    import torch
    (config, engine, layout, partition, fe, plain_mod, state_mod) = ht_mods
    out = []
    for i, (N, d, Kc, B, CH) in enumerate(SHAPES):
        X, batches, _ = synthetic(seed=i + 1, N=N, d=d, B=B)
        geom, args = round_inputs(ht_mods, X, batches, n_clusters=Kc,
                                  chunk=CH)
        nc = geom.nc_cap
        lo, width = nc // 3, max(1, min(5, nc - nc // 3))
        worst = 0.0
        for fast in (False, True):
            errs, kw, rnd = check_k1(fe, plain_mod, args, fast, lo, width)
            k1r = fe.fused_estep(*args, fast, lo=0, width=nc)[5]
            worst = max(worst, *(e[2] for e in errs.values()))
            for dt in (torch.float32, torch.bfloat16):
                e2 = check_k2(fe, plain_mod, args, fast, dt, rnd, k1r, kw[5],
                              lo, width)
                worst = max(worst, *(e[2] for e in e2.values()))
        out.append(dict(N=N, d=d, K=Kc, B=B, CH=CH, chunks=nc, J=geom.J_shard,
                        grid=fe.launch_grid(Kc, B, d),
                        smem_bytes=fe._kernel_lib().fused_estep_smem(Kc, B, d),
                        worst_tolerance_ratio=worst))
        del args
    emit(dict(phase="shapes", tolerance=TOL, bf16_r_tolerance="1 bf16 ulp",
              checks="K1 round + r window, K2 fp32 and bf16 vs plain; "
                     "repeat, replay, K2 == K1 bitwise; both objective "
                     "forms", shapes=out))


def timed_fit(ht, fe, X, meta, **kw):
    """One fit on the card with both launch counts set to 0 just before it:
    (Harmony, seconds, K1 launches, K2 launches). Sets ho.peak_bytes, the
    fit's peak device allocation above what was allocated before it."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fe.launches = fe.launches_write_r = 0
    t0 = time.perf_counter()
    ho = ht.run_harmony(X, meta, ["batch"], device="cuda:0", verbose=False,
                        **kw)
    torch.cuda.synchronize()
    ho.peak_bytes = torch.cuda.max_memory_allocated() - base
    return ho, time.perf_counter() - t0, fe.launches, fe.launches_write_r


def phase_fit(ht, fe, X, batches):
    import numpy as np
    import pandas as pd
    import torch
    meta = pd.DataFrame({"batch": pd.Categorical.from_codes(
        batches, [f"b{i}" for i in range(N_BATCHES)])})

    _, warm_s, _, _ = timed_fit(ht, fe, X, meta)
    fit_s, peaks = [], []
    for _ in range(3):
        ho, s, launches, k2 = timed_fit(ht, fe, X, meta)
        fit_s.append(s)
        peaks.append(ho.peak_bytes)
        nb = ho.cfg.n_blocks
        passes = ho.state.n_passes
        check(ho.cfg.defer_r, "default config did not select deferred-R")
        check(launches > 0 and launches == passes,
              f"K1 launches {launches} != {passes} E-step passes "
              f"({nb} blocks each)")
        check(k2 == 0, f"the deferred fit launched K2 {k2} times")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    obj = ho.objective_harmony
    check(obj[-1] < obj[0], f"objective did not decrease: {obj}")
    Z = ho.Z_corr
    check(Z.shape == (N_CELLS, N_PCS) and np.all(np.isfinite(Z)),
          "Z_corr not finite / wrong shape")
    Rm = ho.R
    row_err = float(np.abs(Rm.sum(axis=1) - 1.0).max())
    check(Rm.shape == (N_CELLS, K) and row_err < 1e-4,
          f".R rows do not sum to 1: {row_err}")
    emit(dict(phase="fit", N=N_CELLS, d=N_PCS, K=ho.K, B=N_BATCHES,
              chunk_size=ho.cfg.chunk_size, defer_r=ho.cfg.defer_r,
              warmup_fit_s=warm_s, fit_s=fit_s, peak_mem_gib=peak_gib,
              kmeans_rounds=ho.kmeans_rounds, objective_harmony=obj,
              estep_passes=passes, kernel_launches=launches,
              R_row_sum_max_err=row_err, fit_peak_bytes=peaks))
    return launches, meta, ho, max(peaks)


def phase_fit_stored(ht, fe, X, meta):
    """The stored-R fits: fp32 (defer_r=False) and bf16 (low_memory=True),
    then the stored fit against the deferred fit with every round run."""
    import numpy as np
    import torch
    out, launches, fits, hos = {}, None, {}, {}
    for name, kw in (("stored", dict(defer_r=False)),
                     ("low_memory", dict(defer_r=False, low_memory=True))):
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
        fits[name] = (ho.cfg, max(peaks))
        hos[name] = ho
        if name == "stored":
            launches = k2

    every_round = dict(max_iter_harmony=2, epsilon_cluster=0,
                       epsilon_harmony=-1)
    st, _, _, _ = timed_fit(ht, fe, X, meta, defer_r=False, **every_round)
    de, _, _, _ = timed_fit(ht, fe, X, meta, **every_round)
    check(de.cfg.defer_r and st.kmeans_rounds == de.kmeans_rounds
          == [20, 20], f"rounds {st.kmeans_rounds} vs {de.kmeans_rounds}")
    errs = {n: diff(torch.as_tensor(getattr(st, n)),
                    torch.as_tensor(getattr(de, n)), *TOL_FIT[n])
            for n in TOL_FIT}
    for n, (_, _, ratio) in errs.items():
        check(ratio <= 1.0, f"stored vs deferred {n} beyond {TOL_FIT[n]}: "
                            f"{errs}")
    emit(dict(phase="fit_stored", N=N_CELLS, fits=out,
              stored_vs_deferred=dict(
                  tolerance=TOL_FIT, kmeans_rounds=st.kmeans_rounds,
                  max_abs={n: e[0] for n, e in errs.items()},
                  objective_stored=st.objective_harmony,
                  objective_deferred=de.objective_harmony)))
    return launches, fits, hos


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


def golden_fit(ht, **kw):
    """pbmc_3500 on the card: (Harmony, per-PC Pearson r against the R
    package's output, fit seconds)."""
    import numpy as np
    import pandas as pd
    import torch
    d = os.path.join(HERE, "harmonypy_tpu", "data")
    meta = pd.read_csv(os.path.join(d, "pbmc_3500_meta.tsv.gz"), sep="\t")
    pcs = pd.read_csv(os.path.join(d, "pbmc_3500_pcs.tsv.gz"), sep="\t")
    gold = pd.read_csv(os.path.join(d, "pbmc_3500_pcs_harmonized.tsv.gz"),
                       sep="\t")
    if gold.iloc[:, 0].dtype == "object":
        gold = gold.iloc[:, 1:]
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
    ho, r, fit_s = golden_fit(ht, chunk_size=128)
    check(min(r) >= 0.99, f"golden pbmc min per-PC r {min(r)} < 0.99")
    emit(dict(phase="golden", data="pbmc_3500", chunk_size=128,
              min_pc_r=min(r), fit_s=fit_s, kmeans_rounds=ho.kmeans_rounds))


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
HIST = ("objective_harmony", "objective_kmeans", "objective_kmeans_dist",
        "objective_kmeans_entropy", "objective_kmeans_cross",
        "kmeans_rounds")
# Per-cell fit on a mesh against one device: shard partials summed in shard
# order (tests/test_fused_xla.py:135-150).
TOL_PERCELL_REL = 5e-4


def block_bound(n_cells, n_slots, r_bytes=0):
    """Least work of one per-block launch: its real cells read once (the
    slab), its slots' rows written once (cache, ybuf, kbuf, and r with
    r_bytes per element), the products of round_bound on those cells."""
    R = 1 + N_BATCHES + N_PCS
    products = n_cells * (2 * N_PCS * K + 2 * K * R)
    weights = n_cells * 2 * K * N_BATCHES
    flops = products + weights
    nbytes = (4 * (n_cells * R + n_slots * (K * R + 2))
              + r_bytes * n_slots * K * CHUNK)
    bound = dict(flop=flops, bytes=nbytes, cells=n_cells, slots=n_slots,
                 ops_ms=flops / PEAK_FP32_FLOPS * 1e3,
                 bytes_ms=nbytes / PEAK_BYTES_S * 1e3,
                 ops_tc_ms=(3 * products / PEAK_TF32_FLOPS
                            + weights / PEAK_FP32_FLOPS) * 1e3)
    bound["bound_ms"] = max(bound["ops_ms"], bound["bytes_ms"])
    bound["bound_by"] = ("operations" if bound["ops_ms"] >= bound["bytes_ms"]
                         else "bytes")
    bound["bound_tc_ms"] = max(bound["ops_tc_ms"], bound["bytes_ms"])
    return bound


def _eq(a, b) -> bool:
    import torch
    return bool(torch.equal(a, b))


def mesh_kernel_checks(mods, X, batches, mesh):
    """The per-block entry on the 858k round inputs cut into the mesh's
    shards: each shard's block-0 rows equal the one-launch round's rows
    bitwise (the global work split), the entry against its plain version
    at TOL (no r, r window, K2 fp32 and bf16), a bitwise repeat, and the
    mesh round (every shard, every block, the frame re-add) equal to the
    one-launch round bitwise for K1, its r window and K2; times."""
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
    errs, worst = {}, dict(k1=0.0, k2=0.0)
    for fast in (False, True):
        rnd = fe.fused_estep(*args, fast)
        rnd_w = fe.fused_estep(*args, fast, lo=lo, width=width)[5]
        tag = f"fast_objective={fast}"
        # Block 0 of every shard: its rows are the one-launch round's.
        for s in range(D):
            out = outs(nc + 1)
            Ob, Eb = fe.fused_estep_block(0, tabs.slots[s], removal, ZP3s[s],
                                          *consts, O, E, fast, out, J1)
            sl = tabs.slots[s][0].long()
            n_real = sharding.shard_chunks(nc, geom.NC_real, s)[1]
            sl = sl[sl < n_real]
            gid = s * nc + sl
            for name, a, b in zip(("cache", "ybuf", "kbuf"), out, rnd[2:5]):
                check(_eq(a[sl], b[gid]), f"per-block {name} rows of shard "
                                          f"{s} differ from the round's "
                                          f"({tag})")
            check(_eq(Ob, O - removal[0][:, 1:])
                  and _eq(Eb, E - removal[0][:, 0:1] * Pr_b[None, :]),
                  f"per-block removed O/E of shard {s} ({tag})")
        # The same entry on the one-device table (J = 22 slots).
        out1 = outs(geom.nc_cap + 1)
        fe.fused_estep_block(0, slots1, removal, ZP3, *consts, O, E, fast,
                             out1, J1)
        sl = slots1[0].long()
        check(all(_eq(a[sl], b[sl]) for a, b in zip(out1, rnd[2:5])),
              f"per-block rows on the one-device table differ ({tag})")
        # Against the plain version, shard 0, every variant.
        for var in ("round", "r_window", "float32", "bfloat16"):
            kw, plain_kw = {}, {}
            if var == "r_window":
                kw = dict(Rw=torch.zeros((width, K, CHUNK), device="cuda"),
                          lo=lo)
                plain_kw = dict(Rw=torch.zeros_like(kw["Rw"]), lo=kw["lo"])
            elif var != "round":
                dt = getattr(torch, var)
                kw = dict(R3=torch.zeros((nc + 1, K, CHUNK), dtype=dt,
                                         device="cuda"))
                plain_kw = dict(R3=torch.zeros_like(kw["R3"]))
            ko, kp = outs(nc + 1), outs(nc + 1)
            k = fe.fused_estep_block(0, tabs.slots[0], removal, ZP3s[0],
                                     *consts, O, E, fast, ko, J1, **kw)
            p_ = plain_mod.fused_update_block(0, tabs.slots[0], removal,
                                              ZP3s[0], *consts, O, E, fast,
                                              kp, **plain_kw)
            kw2 = {n: torch.zeros_like(v) if torch.is_tensor(v) else v
                   for n, v in kw.items()}
            ko2 = outs(nc + 1)
            ka = fe.fused_estep_block(0, tabs.slots[0], removal, ZP3s[0],
                                      *consts, O, E, fast, ko2, J1, **kw2)
            check(all(_eq(a, b) for a, b in zip((*ka, *ko2, *(
                v for v in kw2.values() if torch.is_tensor(v))), (*k, *ko, *(
                    v for v in kw.values() if torch.is_tensor(v))))),
                  f"per-block {var} repeat not bitwise ({tag})")
            pairs = list(zip(("O", "E", "cache", "ybuf", "kbuf"),
                             (k[0], k[1], *ko), (p_[0], p_[1], *kp)))
            if var == "r_window":
                pairs.append(("r", kw["Rw"], plain_kw["Rw"]))
            kk = "k1" if var in ("round", "r_window") else "k2"
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
        # The mesh round against the one-launch round, bitwise.
        wins = [(lo - s * nc, width)
                if sharding.window_rows(geomD, s, lo, width)[2] else None
                for s in range(D)]
        m = plain_mod.mesh_round(tabs, ZP3s, *consts, O, E, fast,
                                 geom.J_fix, windows=wins)
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
            m2 = plain_mod.mesh_round(tabs, ZP3s, *consts, O, E, fast,
                                      geom.J_fix, R3s=R3s)
            check(_eq(m2[0], k2[1]) and _eq(m2[1], k2[2])
                  and _eq(partition.frame_rows(R3s, geomD),
                          R3[: geom.nc_cap]),
                  f"mesh K2 round ({dt}) differs from the round's ({tag})")
        del rnd, m
    # Times: one per-block launch (shard 0, its block with the most real
    # cells), K1 and K2 fp32, the plain version, and one mesh round (every
    # shard and block).
    out = outs(nc + 1)
    R3 = torch.zeros((nc + 1, K, CHUNK), device="cuda")
    cells = ZP3s[0][tabs.slots[0].long(), 0, :].sum(dim=(1, 2))
    bt = int(torch.argmax(cells))
    n_cells = int(cells[bt])
    n_slots = int(torch.unique(tabs.slots[0][bt]).numel())
    fe.launches_block = fe.launches_block_write_r = 0
    ms_block = cuda_ms(lambda: fe.fused_estep_block(
        bt, tabs.slots[0], removal, ZP3s[0], *consts, O, E, False, out, J1),
        reps=50)
    ms_block_k2 = cuda_ms(lambda: fe.fused_estep_block(
        bt, tabs.slots[0], removal, ZP3s[0], *consts, O, E, False, out, J1,
        R3=R3), reps=50)
    plain_ms = cuda_ms(lambda: plain_mod.fused_update_block(
        bt, tabs.slots[0], removal, ZP3s[0], *consts, O, E, False, out),
        reps=10)
    plain_ms_k2 = cuda_ms(lambda: plain_mod.fused_update_block(
        bt, tabs.slots[0], removal, ZP3s[0], *consts, O, E, False, out,
        R3=R3), reps=10)
    n0 = fe.launches_block
    ms_pass = cuda_ms(lambda: plain_mod.mesh_round(
        tabs, ZP3s, *consts, O, E, False, geom.J_fix), reps=5, warmup=1)
    per_pass = (fe.launches_block - n0) // 6
    check(per_pass == geom.nb * D, f"mesh round launched {per_pass} "
                                   f"per-block kernels, not {geom.nb * D}")
    b1, b2 = block_bound(n_cells, n_slots), block_bound(n_cells, n_slots, 4)
    return dict(
        shape=dict(shards=D, N_shard_real=geomD.nc_cap * CHUNK,
                   nc_cap=geomD.nc_cap, J_shard=geomD.J_shard, J_glob=J1,
                   units_per_slot=fe.kernel_geometry(
                       K, N_BATCHES, N_PCS, CHUNK, geomD.J_shard, 132,
                       J1).ng),
        rows_equal_round=True, repeat_bitwise=True,
        mesh_round_equals_round=True, max_abs=errs,
        timed_block=bt, ms_block=ms_block, ms_block_write_r=ms_block_k2,
        plain_ms_block=plain_ms, plain_ms_block_write_r=plain_ms_k2,
        ms_per_pass=ms_pass, launches_per_pass=per_pass,
        bound_block=b1, bound_block_write_r=b2,
        roofline_share_block=b1["bound_ms"] / ms_block,
        roofline_share_block_tc=b1["bound_tc_ms"] / ms_block), worst


def mesh_fit_checks(ht, fe, X, meta, mesh, refs):
    """The default deferred fit, the stored fit and the low_memory fit on
    `mesh`, each with the four launch counts set to 0 just before it:
    Z_corr, R, the five histories and kmeans_rounds bitwise equal to the
    one-device fit refs[name]; per-block launches = blocks x shards per
    pass (deferred: every round and replay window; stored: every round),
    and no one-launch round; each card's peak allocation during the fit
    (above what it held before) at most memory_envelope(cfg, the shards it
    holds). Returns (results, launch counts, the deferred fit)."""
    import collections

    import numpy as np
    import torch
    from harmonypy_tpu_torch.utils.memory import memory_envelope
    out, counts = {}, {}
    cards = collections.Counter(mesh.devices)
    for name, kw in (("deferred", {}), ("stored", dict(defer_r=False)),
                     ("low_memory", dict(defer_r=False, low_memory=True))):
        torch.cuda.synchronize()
        base = {}
        for dv in cards:
            torch.cuda.reset_peak_memory_stats(dv)
            base[dv] = torch.cuda.memory_allocated(dv)
        fe.launches = fe.launches_write_r = 0
        fe.launches_block = fe.launches_block_write_r = 0
        t0 = time.perf_counter()
        ho = ht.run_harmony(X, meta, ["batch"], mesh=mesh, verbose=False,
                            **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = (fe.launches, fe.launches_write_r, fe.launches_block,
               fe.launches_block_write_r)
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
        per = ho.cfg.n_blocks * mesh.size
        passes, rounds = ho.state.n_passes, sum(ho.kmeans_rounds)
        want = ((0, 0, per * passes, 0) if name == "deferred"
                else (0, 0, 0, per * rounds))
        check(got == want and max(got) > 0,
              f"mesh {name}: launches (K1, K2, K1 per-block, K2 per-block) "
              f"{got}, expected {want}")
        ref = refs[name]
        for a in ("Z_corr", "R") + HIST:
            check(np.array_equal(np.asarray(getattr(ho, a)),
                                 np.asarray(getattr(ref, a))),
                  f"mesh {name}: {a} differs from the one-device fit")
        out[name] = dict(wall_s=wall, kmeans_rounds=ho.kmeans_rounds,
                         passes=passes, launches=dict(zip(
                             ("k1", "k2", "k1_block", "k2_block"), got)),
                         bitwise_equal_one_device=True, memory=memory)
        counts[name] = got
        if name == "deferred":
            mesh_ho = ho
    return out, counts, mesh_ho


def mesh_path_checks(ht, fe, X, batches, groups, meta, mesh, refs,
                     lisi_ref):
    """On `mesh`: the three 858k fits bitwise (mesh_fit_checks); the
    per-cell pbmc fit within TOL_PERCELL_REL of one device at 3 harmony
    iterations and at the golden gate at default settings; compute_lisi on
    the mesh fit's output bitwise equal to lisi_ref = (one-device values,
    sampled brute values, sampled ids); a checkpoint resume bitwise and a
    resume on another mesh size refused. Returns (results, launch
    counts)."""
    import tempfile

    import numpy as np
    import pandas as pd
    from harmonypy_tpu_torch.parallel.mesh import make_mesh
    fits, counts, mesh_ho = mesh_fit_checks(ht, fe, X, meta, mesh, refs)

    # pbmc_3500 at default settings: the per-cell fit. Held at 3 harmony
    # iterations, as tests/test_fused_xla.py:135-150 holds it: every round
    # of those runs (20 each), so no convergence test decides the round
    # count from objectives that differ in the last bits; the full default
    # fit is held at the golden gate, its distance recorded.
    per_cell = {}
    for iters in (3, None):
        kw = {} if iters is None else dict(max_iter_harmony=iters)
        ho1, r1, _ = golden_fit(ht, **kw)
        hoD, rD, fit_s = golden_fit(ht, mesh=mesh, **kw)
        check(not hoD.cfg.fused_estep and hoD.cfg.n_devices == mesh.size,
              f"pbmc mesh: unexpected config {hoD.cfg}")
        scale = float(np.abs(ho1.Z_corr).max())
        pc_err = float(np.abs(hoD.Z_corr - ho1.Z_corr).max())
        if iters is None:
            check(min(rD) >= 0.99, f"per-cell mesh golden min r {min(rD)}")
        else:
            check(pc_err <= TOL_PERCELL_REL * scale,
                  f"per-cell mesh vs one device {pc_err} > "
                  f"{TOL_PERCELL_REL} x {scale} (rounds "
                  f"{hoD.kmeans_rounds} vs {ho1.kmeans_rounds})")
        per_cell["default" if iters is None else f"max_iter_harmony={iters}"
                 ] = dict(max_abs=pc_err, max_abs_over_max_Z=pc_err / scale,
                          gated=iters is not None, min_pc_r=min(rD),
                          min_pc_r_one_device=min(r1), fit_s=fit_s,
                          kmeans_rounds=hoD.kmeans_rounds,
                          kmeans_rounds_one_device=ho1.kmeans_rounds)

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
    d = os.path.join(HERE, "harmonypy_tpu", "data")
    pmeta = pd.read_csv(os.path.join(d, "pbmc_3500_meta.tsv.gz"), sep="\t")
    pcs = pd.read_csv(os.path.join(d, "pbmc_3500_pcs.tsv.gz"), sep="\t")
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
        per_cell=dict(data="pbmc_3500", tolerance_over_max_Z=(
            TOL_PERCELL_REL), fits=per_cell),
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
    real = (mesh_path_checks(ht, fe, X, batches, groups, meta, make_mesh(),
                             refs, lisi_ref)[0]
            if cards > 1 else f"skipped: {cards} card")
    emit(dict(phase="mesh", shards=MESH_SHARDS, kernel=kinfo,
              kernel_tolerance=TOL, **res, real_cards=real))
    return dict(
        k1=dict(launches=counts["deferred"][2], ms=kinfo["ms_block"],
                plain_ms=kinfo["plain_ms_block"], max_abs_err=worst["k1"],
                bound_ms=kinfo["bound_block"]["bound_ms"],
                bound_by=kinfo["bound_block"]["bound_by"]),
        k2=dict(launches=counts["stored"][3], ms=kinfo["ms_block_write_r"],
                plain_ms=kinfo["plain_ms_block_write_r"],
                max_abs_err=worst["k2"],
                bound_ms=kinfo["bound_block_write_r"]["bound_ms"],
                bound_by=kinfo["bound_block_write_r"]["bound_by"]))


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
    fe._kernel_lib()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for log in build.build_log.values()
             for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    emit(dict(phase="ptxas", lines=ptxas))
    emit(dict(phase="device", nvidia_smi=smi,
              name=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda, python=sys.version.split()[0],
              allow_tf32=torch.backends.cuda.matmul.allow_tf32,
              build_s=build_s, ptxas=build.build_log))
    X, batches, groups = synthetic()
    mods = (config, engine, layout, partition, fe, update_r_fused, state)
    geom, args = round_inputs(mods, X, batches)
    kinfo = phase_kernel(mods, geom, args)
    k2info = phase_kernel2(mods, geom, args)
    del args
    phase_shapes(mods)
    launches, meta, fit_ho, fit_peak = phase_fit(ht, fe, X, batches)
    launches_r, fits, stored_hos = phase_fit_stored(ht, fe, X, meta)
    fits["deferred"] = (fit_ho.cfg, fit_peak)
    phase_profile(ht, X, meta, "deferred")
    phase_profile(ht, X, meta, "stored", defer_r=False)
    phase_golden(ht)
    phase_golden_default(ht)
    phase_lisi_golden(ht)
    lisi_ref = phase_lisi(ht, fit_ho.Z_corr, batches, groups)
    phase_checkpoint(ht)
    phase_cli(ht)
    phase_capacity(fits)
    minfo = phase_mesh(ht, mods, X, batches, groups, meta,
                       dict(deferred=fit_ho, **stored_hos), lisi_ref)
    del fit_ho, stored_hos
    src = "harmonypy_tpu_torch/csrc/fused_estep.cu"
    pallas = "harmonypy_tpu/ops/pallas/update_r_fused.py"
    emit({"kernels": [
        dict(name="fused_estep", route="cuda", source=src,
             replaces=f"{pallas}:117", launches=launches, **kinfo,
             library_ms=None),
        dict(name="fused_estep_write_r", route="cuda", source=src,
             replaces=f"{pallas}:109", launches=launches_r, **k2info,
             library_ms=None),
        dict(name="fused_estep_block", route="cuda", source=src,
             replaces=f"{pallas}:117", **minfo["k1"], library_ms=None),
        dict(name="fused_estep_block_write_r", route="cuda", source=src,
             replaces=f"{pallas}:109", **minfo["k2"], library_ms=None)]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
