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
  5. kernels  every kernel with its launches on its path's fit, error
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
    return X.astype(np.float32), batches


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


def round_inputs(ht_mods, X, batches, n_clusters=K, chunk=CHUNK):
    """The main path's own inputs of one E-step round (the full shape by
    default): init statistics and one round's tables."""
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
        X, batches = synthetic(seed=i + 1, N=N, d=d, B=B)
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
    (Harmony, seconds, K1 launches, K2 launches)."""
    import torch
    fe.launches = fe.launches_write_r = 0
    t0 = time.perf_counter()
    ho = ht.run_harmony(X, meta, ["batch"], device="cuda", verbose=False,
                        **kw)
    torch.cuda.synchronize()
    return ho, time.perf_counter() - t0, fe.launches, fe.launches_write_r


def phase_fit(ht, fe, X, batches):
    import numpy as np
    import pandas as pd
    import torch
    meta = pd.DataFrame({"batch": pd.Categorical.from_codes(
        batches, [f"b{i}" for i in range(N_BATCHES)])})

    _, warm_s, _, _ = timed_fit(ht, fe, X, meta)
    fit_s = []
    for _ in range(3):
        torch.cuda.reset_peak_memory_stats()
        ho, s, launches, k2 = timed_fit(ht, fe, X, meta)
        fit_s.append(s)
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
              R_row_sum_max_err=row_err))
    return launches, meta


def phase_fit_stored(ht, fe, X, meta):
    """The stored-R fits: fp32 (defer_r=False) and bf16 (low_memory=True),
    then the stored fit against the deferred fit with every round run."""
    import numpy as np
    import torch
    out, launches = {}, None
    for name, kw in (("stored", dict(defer_r=False)),
                     ("low_memory", dict(defer_r=False, low_memory=True))):
        _, warm_s, _, _ = timed_fit(ht, fe, X, meta, **kw)
        fit_s = []
        for _ in range(3):
            torch.cuda.reset_peak_memory_stats()
            ho, s, k1, k2 = timed_fit(ht, fe, X, meta, **kw)
            fit_s.append(s)
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
                         R_row_sum_max_err=row_err)
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
    return launches


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
        ht.run_harmony(X, meta, ["batch"], device="cuda", verbose=False,
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
    ho = ht.run_harmony(pcs, meta, ["donor"], device="cuda", verbose=False,
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

    X, batches = synthetic()
    mods = (config, engine, layout, partition, fe, update_r_fused, state)
    geom, args = round_inputs(mods, X, batches)
    kinfo = phase_kernel(mods, geom, args)
    k2info = phase_kernel2(mods, geom, args)
    del args
    phase_shapes(mods)
    launches, meta = phase_fit(ht, fe, X, batches)
    launches_r = phase_fit_stored(ht, fe, X, meta)
    phase_profile(ht, X, meta, "deferred")
    phase_profile(ht, X, meta, "stored", defer_r=False)
    phase_golden(ht)
    phase_golden_default(ht)
    src = "harmonypy_tpu_torch/csrc/fused_estep.cu"
    pallas = "harmonypy_tpu/ops/pallas/update_r_fused.py"
    emit({"kernels": [
        dict(name="fused_estep", route="cuda", source=src,
             replaces=f"{pallas}:117", launches=launches, **kinfo,
             library_ms=None),
        dict(name="fused_estep_write_r", route="cuda", source=src,
             replaces=f"{pallas}:109", launches=launches_r, **k2info,
             library_ms=None)]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
