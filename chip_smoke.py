#!/usr/bin/env python3
"""Smoke test of harmonypy_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written kernels from the checkout, then, printing one JSON
line per phase:
  1. device   the card (nvidia-smi name and power limit), torch/CUDA
              versions, the kernel build time;
  2. kernel   the deferred-R E-step kernel K1 against its plain PyTorch
              version at the full 858,000 x 29 PCs, K=100, B=3, CH=2048
              shape (data made from a seed as bench.py makes it): one round
              and one r-window replay, tolerances below, bitwise repeat,
              and the replay's per-chunk stats equal to the round's cache
              bitwise;
  2b. kernel2 the stored-R kernel K2 (write_r) on the same round inputs,
              fp32 and bf16 R: against its plain version, its stats and fp32
              r equal to K1's round and r window bitwise, its bf16 R equal
              to K1's r rounded to bf16, the dummy chunk zero, a bitwise
              repeat, its time and bound;
  3. fit      run_harmony on that data on the card, default parameters (the
              deferred-R fit): wall clock of 3 fits after a warm-up fit,
              peak device memory, k-means
              rounds, objective, and the kernel launch count, which must be
              2 * n_blocks per E-step pass the engine ran;
  3b. fit_stored  the stored-R fits (defer_r=False, in fp32 and with
              low_memory=True) on that data: the same numbers, K2 launches
              = 2 * n_blocks * rounds; then the stored fit against the
              deferred fit of the same seed, every round run, at the JAX
              package's tolerances for its two paths (tests/test_defer.py:
              62-76);
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
# HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
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


def synthetic(seed=0):
    import numpy as np
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((N_GROUPS, N_PCS), np.float32) * 5.0
    shifts = rng.standard_normal((N_BATCHES, N_PCS), np.float32) * 1.5
    groups = rng.integers(0, N_GROUPS, size=N_CELLS)
    batches = rng.integers(0, N_BATCHES, size=N_CELLS)
    noise = rng.standard_normal((N_CELLS, N_PCS), np.float32)
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


def round_inputs(ht_mods, X, batches):
    """The main path's own inputs of one E-step round at the full shape:
    init statistics and one round's tables."""
    import numpy as np
    import torch
    (config, engine, layout, partition, fe, plain_mod, state_mod) = ht_mods
    dev = torch.device("cuda")
    cfg = config.EngineConfig(N=N_CELLS, d=N_PCS, K=K, B=N_BATCHES,
                              n_devices=1, use_fused_xla=True, defer_r=True,
                              chunk_size=CHUNK)
    geom = partition.partition_geometry(cfg)
    Phi = (batches[None, :] == np.arange(N_BATCHES)[:, None]).astype(
        np.float32)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    data = state_mod.HarmonyData(Z_orig=t(layout.pad_cells(X.T, cfg)),
                                 Phi=t(layout.pad_cells(Phi, cfg)),
                                 mask=t(layout.shard_mask(cfg)))
    params = state_mod.HarmonyParams(
        theta=t(np.full(N_BATCHES, 2.0)), sigma=t(np.full(K, 0.1)),
        lamb=t([0.0] + [1.0] * N_BATCHES), Pr_b=t(Phi.mean(axis=1)))
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
    (r_bytes per element of the (nc1, K, CH) store)."""
    R = 1 + N_BATCHES + N_PCS
    flops = N_CELLS * (2 * N_PCS * K + 2 * K * R + 2 * K * N_BATCHES)
    nbytes = (4 * (N_CELLS * R + (geom.nc_cap + 1) * (K * R + 2))
              + r_bytes * (geom.nc_cap + 1) * K * geom.CH)
    bound = dict(flop=flops, bytes=nbytes,
                 ops_ms=flops / PEAK_FP32_FLOPS * 1e3,
                 bytes_ms=nbytes / PEAK_BYTES_S * 1e3)
    bound["bound_ms"] = max(bound["ops_ms"], bound["bytes_ms"])
    bound["bound_by"] = ("operations" if bound["ops_ms"] >= bound["bytes_ms"]
                         else "bytes")
    return bound


def phase_kernel(ht_mods, geom, args):
    import torch
    (config, engine, layout, partition, fe, plain_mod, state_mod) = ht_mods
    lo, width = 200, 16

    res = {}
    for fast in (False, True):
        kern = fe.fused_estep(*args, fast, lo=lo, width=width)
        plain = plain_mod.fused_update_nor(*args, fast, lo=lo, width=width)
        torch.cuda.synchronize()
        names = ("O", "E", "cache", "ybuf", "kbuf", "r")
        errs = {n: diff(a, b, *TOL[n]) for n, a, b in zip(names, kern, plain)}
        for n, (_, _, ratio) in errs.items():
            check(ratio <= 1.0, f"kernel vs plain {n} (fast_objective="
                                f"{fast}) beyond rtol/atol {TOL[n]}: {errs}")
        again = fe.fused_estep(*args, fast, lo=lo, width=width)
        rnd = fe.fused_estep(*args, fast)
        repeat = all(torch.equal(a, b) for a, b in zip(kern, again))
        replay = all(torch.equal(a, b) for a, b in zip(kern[:5], rnd[:5]))
        check(repeat, "kernel repeat is not bitwise equal")
        check(replay, "replay stats differ from the round's bitwise")
        res[f"fast_objective={fast}"] = dict(
            max_abs={n: e[0] for n, e in errs.items()},
            max_rel={n: e[1] for n, e in errs.items()},
            repeat_bitwise=repeat, replay_equals_round_bitwise=replay)

    ms = cuda_ms(lambda: fe.fused_estep(*args, False), reps=20)
    plain_ms = cuda_ms(lambda: plain_mod.fused_update_nor(*args, False),
                       reps=5, warmup=1)
    bound = round_bound(geom)
    max_abs = max(v for r in res.values() for v in r["max_abs"].values())
    emit(dict(phase="kernel", shape=dict(N=N_CELLS, d=N_PCS, K=K,
                                         B=N_BATCHES, CH=CHUNK,
                                         chunks=geom.nc_cap, J=geom.J_shard,
                                         n_blocks=geom.nb),
              tolerance=TOL, results=res, ms_per_round=ms,
              plain_ms_per_round=plain_ms, launches_per_round=2 * geom.nb,
              bound=bound))
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=max_abs,
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

    def empty(dt):
        return torch.empty((nc + 1, K, CH), dtype=dt, device=dev)

    def k2(dt, fast):
        R3 = empty(dt)
        return fe.fused_estep_r(args[0], args[1], args[2], R3, *args[3:],
                                fast)

    res, max_abs = {}, 0.0
    for fast in (False, True):
        k1 = fe.fused_estep(*args, fast)
        k1r = fe.fused_estep(*args, fast, lo=0, width=nc)[5]
        k1w = fe.fused_estep(*args, fast, lo=lo, width=width)[5]
        for name, dt in dtypes.items():
            kern = k2(dt, fast)
            plain = plain_mod.fused_update_r(args[0], args[1], args[2],
                                             empty(dt), *args[3:], fast)
            torch.cuda.synchronize()
            names = ("r", "O", "E", "cache", "ybuf", "kbuf")
            errs = {n: diff(a.float(), b.float(), *TOL[n])
                    for n, a, b in zip(names, kern, plain)}
            if dt == torch.bfloat16:
                ulps = bf16_ulps(kern[0], plain[0])
                check(ulps <= 1, f"K2 bf16 R vs plain: {ulps} bf16 ulps")
                errs.pop("r")
            for n, (_, _, ratio) in errs.items():
                check(ratio <= 1.0, f"K2 vs plain {n} ({name}, fast_objective"
                                    f"={fast}) beyond {TOL[n]}: {errs}")
            again = k2(dt, fast)
            repeat = all(torch.equal(a, b) for a, b in zip(kern, again))
            stats_k1 = all(torch.equal(a, b) for a, b in zip(kern[1:], k1))
            r_k1 = torch.equal(kern[0][:nc], k1r.to(dt))
            window = (dt != torch.float32
                      or torch.equal(kern[0][lo: lo + width], k1w))
            dummy_zero = not bool(kern[0][nc].float().any())
            for ok, what in ((repeat, "repeat"),
                             (stats_k1, "stats vs K1's round"),
                             (r_k1, "R vs K1's r"),
                             (window, "R vs K1's r window"),
                             (dummy_zero, "dummy chunk zero")):
                check(ok, f"K2 {what} not bitwise ({name}, fast_objective="
                          f"{fast})")
            max_abs = max(max_abs, *(e[0] for e in errs.values()))
            if dt == torch.bfloat16:
                max_abs = max(max_abs, float(
                    (kern[0].float() - plain[0].float()).abs().max()))
            res[f"{name},fast_objective={fast}"] = dict(
                max_abs={n: e[0] for n, e in errs.items()},
                max_rel={n: e[1] for n, e in errs.items()},
                repeat_bitwise=repeat, stats_equal_k1_round=stats_k1,
                r_equals_k1_r=r_k1, r_window_equals_k1=window,
                dummy_chunk_zero=dummy_zero)

    # K1 and K2 (fp32, bf16) timed in turns, three times over: the spread
    # within one call, and K2's cost over K1 on the same card.
    R3s = {name: empty(dt) for name, dt in dtypes.items()}
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
        times[name]["plain_ms"] = cuda_ms(lambda: plain_mod.fused_update_r(
            args[0], args[1], args[2], R3, *args[3:], False), reps=5,
            warmup=1)
        times[name]["bound"] = round_bound(geom, r_bytes=R3.element_size())
    emit(dict(phase="kernel2", tolerance=TOL, bf16_r_tolerance="1 bf16 ulp",
              results=res, times=times, launches_per_round=2 * geom.nb))
    t32 = times["float32"]
    return dict(ms=t32["ms"], plain_ms=t32["plain_ms"], max_abs_err=max_abs,
                bound_ms=t32["bound"]["bound_ms"],
                bound_by=t32["bound"]["bound_by"])


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
        check(launches > 0 and launches == 2 * nb * passes,
              f"launches {launches} != 2 * {nb} blocks * {passes} passes")
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
            check(k2 > 0 and k2 == 2 * nb * rounds,
                  f"{name}: K2 launches {k2} != 2 * {nb} * {rounds} rounds")
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
