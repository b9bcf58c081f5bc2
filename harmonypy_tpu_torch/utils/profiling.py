"""Profiling and tracing helpers (JAX package utils/profiling.py).

  span(name)        the port's profiler range: a torch.profiler
                    record_function while a profiler records, else a
                    shared no-op; a `with` block or a decorator.
  trace(dir)        context manager around torch.profiler.profile: writes a
                    TensorBoard-readable trace of everything inside (CPU
                    activity, and the card's kernels when there is one).
  phase_timer()     host wall clock per named phase, the device synced at
                    each boundary when asked.
  round_bound(cfg)  the least time one H100 could take for one fused E-step
                    round: the floor `profile_fit` holds a round against
                    and the bound chip_smoke.py reports for K1 and K2.
  profile_fit(...)  per-phase time of a fit (init, one k-means round, the
                    ridge) measured through the real engine, with the
                    round's position against that floor.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import time

import torch
from torch.profiler import record_function

from ..ops.products import runs_one_pass

# H100 SXM published peaks (NVIDIA H100 datasheet, dense): fp32 on the CUDA
# cores, TF32 and bf16 on the tensor cores, HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12

_recording = torch._C._autograd._profiler_enabled


def _spanned(name: str, fn):
    """fn with span(name) opened around each call."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)
    return call


class _Idle:
    """span(name) while no profiler records: enters nothing. One per name,
    shared."""
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return _spanned(self.name, fn)


class _Range(record_function):
    """span(name) while a profiler records."""

    def __call__(self, fn):
        return _spanned(self.name, fn)


_IDLE: dict = {}


def span(name: str):
    """The profiler range `name` (a torch.profiler.record_function) while
    a profiler records; otherwise a shared no-op context, so the range
    costs one flag check (a record_function entered and left with no
    profiler costs microseconds). Use `with span(name):`, or `@span(name)`
    on a function: the decorator decides at each call, whatever recorded
    when it was applied."""
    if _recording():
        return _Range(name)
    idle = _IDLE.get(name)
    if idle is None:
        idle = _IDLE[name] = _Idle(name)
    return idle


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile everything inside into a TensorBoard trace in log_dir."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


def _first_tensor(x):
    """The first tensor in x (a tensor, a list, tuple or dict of them, or a
    dataclass such as HarmonyState), or None."""
    if isinstance(x, torch.Tensor):
        return x
    if dataclasses.is_dataclass(x):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    elif isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def device_sync(x) -> None:
    """Wait for the device of the first tensor in x: the card's
    synchronize; nothing on the CPU, where torch runs eagerly."""
    t = _first_tensor(x)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class phase_timer:
    """Accumulate wall clock per named phase, the device synced at exit.

    >>> pt = phase_timer()
    >>> with pt("cluster", sync=state):   # doctest: +SKIP
    ...     step(state)
    >>> pt.timings                        # doctest: +SKIP
    {'cluster': 0.0123}
    """

    def __init__(self):
        self.timings: dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                device_sync(sync)
            self.timings[name] = (self.timings.get(name, 0.0)
                                  + time.perf_counter() - t0)


def estep_traffic_model_gb(cfg) -> float:
    """Minimum per-kmeans-round HBM traffic of the fused E-step (JAX
    package utils/profiling.py:67-75): read Z_cos + Phi once, write R once,
    except in deferred-R mode, where R is never written."""
    r_bytes = 0 if cfg.defer_r else (2 if cfg.r_dtype == "bfloat16" else 4)
    return cfg.N * (4 * cfg.d + 4 * cfg.B + r_bytes * cfg.K) / 1e9


def estep_bound(n_cells: int, n_rows: int, d: int, K: int, B: int, CH: int,
                r_bytes: int = 0, one_pass: bool = False) -> dict:
    """Least work of the fused E-step over n_cells real cells whose chunks
    give n_rows per-chunk output rows: each cell's [mask; Phi; Z] read once
    and each row's cache, centroid numerator and objective partials written
    once (and, for K2, the rows' r of CH cells, r_bytes per element); the
    two products dist = Y^T Z and [mask; Phi; Z] r^T, and the wdiv Phi
    weights.

    bound_ms takes the products and the weights at the fp32 CUDA-core rate;
    bound_tc_ms takes the products as 3xTF32 on the tensor cores (three
    passes at the dense TF32 rate) and the weights at the fp32 rate, against
    the same bytes. The transcendentals run on the SFUs, 16 per SM and
    clock: 2 K N of them (the softmax's exp, the entropy's log) is ~1.7e8
    at 858k x K = 100, ~0.04 ms at 132 SMs x 1.98 GHz, below the products'
    floor at this shape, so they add no term.

    one_pass: the one-pass variant's bound (matmul_precision "default" on
    a card), the products and the weights as one pass at the dense bf16
    tensor-core rate (ops_ms and ops_tc_ms both), against the same bytes.
    At 858k x 29, K = 100: 11.15 GFLOP in 0.0113 ms, under the 118.8 MB's
    0.0355 ms: bound by bytes."""
    R = 1 + B + d
    products = n_cells * (2 * d * K + 2 * K * R)
    weights = n_cells * 2 * K * B
    flops = products + weights
    nbytes = (4 * (n_cells * R + n_rows * (K * R + 2))
              + r_bytes * n_rows * K * CH)
    if one_pass:
        ops_ms = ops_tc_ms = flops / PEAK_BF16_FLOPS * 1e3
    else:
        ops_ms = flops / PEAK_FP32_FLOPS * 1e3
        ops_tc_ms = (3 * products / PEAK_TF32_FLOPS
                     + weights / PEAK_FP32_FLOPS) * 1e3
    b = dict(flop=flops, bytes=nbytes, ops_ms=ops_ms,
             bytes_ms=nbytes / PEAK_BYTES_S * 1e3, ops_tc_ms=ops_tc_ms)
    b["bound_ms"] = max(b["ops_ms"], b["bytes_ms"])
    b["bound_by"] = "operations" if b["ops_ms"] >= b["bytes_ms"] else "bytes"
    b["bound_tc_ms"] = max(b["ops_tc_ms"], b["bytes_ms"])
    return b


def round_bound(cfg, r_bytes: int = 0, one_pass: bool = False) -> dict:
    """estep_bound of one round of cfg's fit on one device: every real
    cell once, one row per chunk of the one-device geometry (the dummy
    chunk included); one_pass: the one-pass variant's."""
    # Imported here: ops/partition.py and parallel/sharding.py import span
    # from this module.
    from ..ops.partition import partition_geometry
    from ..parallel.sharding import one_device
    geom = partition_geometry(one_device(cfg))
    return estep_bound(cfg.N, geom.nc_cap + 1, cfg.d, cfg.K, cfg.B, geom.CH,
                       r_bytes, one_pass)


def estep_vpu_floor_s(cfg, one_pass: bool = False) -> float:
    """Floor of one deferred k-means round on an H100, in seconds:
    round_bound's bound_ms (the fp32 CUDA-core floor; the JAX package's
    name, whose TPU floor counted transcendentals on the vector unit).
    858k x 29, K = 100, B = 3: 11.15 GFLOP, 118.8 MB, 0.1665 ms; with
    one_pass the one-pass variant's floor, 0.0355 ms (bytes)."""
    return round_bound(cfg, one_pass=one_pass)["bound_ms"] / 1e3


def profile_fit(cfg, mesh, data, params, seed: int = 0, reps: int = 16,
                budget_s: float | None = None,
                hbm_peak_gbps: float | None = None,
                split_init: bool = False) -> dict:
    """Per-phase time through the real engine (JAX package
    utils/profiling.py:90-281), in seconds:

      dispatch_s            floor of a synced call (min of 5 one-element
                            adds on the lead device)
      phase_init_s          engine.init_defer / init_stored (seeding +
                            initial statistics), less dispatch_s
      phase_init_seeding_s  (split_init) normalize_cells + kmeans_init +
      phase_init_stats_s    l2_normalize_cols alone, and init less it
      phase_kmeans_round_s  one k-means round: an iteration pinned to
                            1 + reps rounds less one pinned to 1 round, over
                            reps (epsilon_kmeans = 0 makes the trip counts
                            exact)
      phase_ridge_s         the ridge, amortized over a fit pinned to reps
                            harmony iterations of 1 round
      estep_hbm_gbps[_frac_of_peak]  estep_traffic_model_gb over the round,
                            against hbm_peak_gbps; estep_round_noisy
                            instead when that would pass the peak
      estep_vpu_floor_s[_frac]  (deferred) the round's H100 floor
                            (round_bound, of the variant the fit runs:
                            runs_one_pass) and its share of the round
      fused_xla_round_s     (use_pallas) the round with use_fused_xla: in
                            this package both flags reach the same
                            hand-written kernel
      pallas_stored_round_s (deferred, on a card, pallas_supported) the
                            stored round (K2) on the same inputs

    Each timed init and each iteration draws from a fresh generator seeded
    with `seed` on the lead device, so every call seeds the same centroids
    and draws the same stripes, and the differenced rounds compare like
    with like. Every time is the minimum of its repetitions (noise only
    adds). The round covers the E-step launch, the Y update, the objective
    and the convergence check: the kernel and the host work around it.

    When the probes pass `budget_s` (default $BENCH_PHASE_BUDGET_S or
    360), the rest are skipped and "phases_truncated" says so.
    hbm_peak_gbps defaults to $BENCH_HBM_PEAK_GBPS or 3350 (the H100 SXM's
    HBM3)."""
    from .. import engine
    from ..config import pallas_supported

    if budget_s is None:
        budget_s = float(os.environ.get("BENCH_PHASE_BUDGET_S", 360))
    if hbm_peak_gbps is None:
        hbm_peak_gbps = float(os.environ.get("BENCH_HBM_PEAK_GBPS", 3350))
    lead = mesh.lead
    t_start = time.perf_counter()

    class OverBudget(Exception):
        pass

    def check_budget():
        if time.perf_counter() - t_start > budget_s:
            raise OverBudget(f"phase-probe budget {budget_s}s exceeded")

    def sync():
        for dev in dict.fromkeys(mesh.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def new_gen():
        gen = torch.Generator(device=lead)
        gen.manual_seed(seed)
        return gen

    def timed(fn, reps_min: int = 2):
        """Min of reps_min synced calls after a warm-up call."""
        fn()
        sync()
        best = float("inf")
        for _ in range(reps_min):
            t0 = time.perf_counter()
            fn()
            sync()
            best = min(best, time.perf_counter() - t0)
        return best

    def iter_time(cfg_v):
        """(min of 3 synced harmony iterations after a warm-up, each from a
        fresh init; the init's own time)."""
        init = engine.init_defer if cfg_v.defer_r else engine.init_stored
        t_init = timed(lambda: init(data, params, cfg_v, new_gen()))
        best = float("inf")
        for i in range(4):
            gen = new_gen()
            st = init(data, params, cfg_v, gen)
            step = engine.HarmonyStep(data, params, cfg_v, gen)
            sync()
            t0 = time.perf_counter()
            step(st)
            sync()
            if i:
                best = min(best, time.perf_counter() - t0)
        return best, t_init

    def round_time(base_cfg):
        t = {}
        for n_rounds in (reps + 1, 1):
            check_budget()
            cfg_v = dataclasses.replace(
                base_cfg, max_iter_kmeans=n_rounds, epsilon_kmeans=0.0,
                max_iter_harmony=1)
            t[n_rounds], t_init = iter_time(cfg_v)
        # Guard against noise exceeding the differenced signal.
        return max((t[reps + 1] - t[1]) / reps, 1e-6), t_init

    res = {}
    try:
        x = torch.zeros((), device=lead)
        d0 = timed(lambda: x + 1, reps_min=5)
        res["dispatch_s"] = d0

        t_round, t_init_meas = round_time(cfg)
        t_init = max(t_init_meas - d0, 0.0)
        round_gb = estep_traffic_model_gb(cfg)
        res["phase_init_s"] = t_init
        res["phase_kmeans_round_s"] = t_round
        frac = round_gb / t_round / hbm_peak_gbps
        if frac <= 1.0:
            res["estep_hbm_gbps"] = round_gb / t_round
            res["estep_hbm_frac_of_peak"] = frac
        else:
            # A differenced round past the peak bandwidth is noise.
            res["estep_round_noisy"] = True
        if cfg.defer_r:
            vf = estep_vpu_floor_s(cfg, runs_one_pass(cfg, mesh.lead))
            res["estep_vpu_floor_s"] = vf
            res["estep_vpu_floor_frac"] = vf / t_round

        if split_init:
            # The front half of init_defer / init_stored (engine.py).
            check_budget()
            from ..ops.kmeans import kmeans_init
            from ..ops.normalize import l2_normalize_cols

            def seed_only():
                Z_cos = engine.normalize_cells(data.Z_orig)
                return l2_normalize_cols(kmeans_init(
                    new_gen(), Z_cos, cfg, runs_one_pass(cfg, mesh.lead)))

            t_seed = max(timed(seed_only) - d0, 0.0)
            res["phase_init_seeding_s"] = t_seed
            res["phase_init_stats_s"] = max(t_init - t_seed, 0.0)

        # Ridge, amortized: fit = init + reps * (round + ridge).
        check_budget()
        cfg_r = dataclasses.replace(
            cfg, max_iter_kmeans=1, epsilon_kmeans=0.0,
            max_iter_harmony=reps, epsilon_harmony=-1e30)
        t_fit_r = timed(lambda: engine.fit(data, params, cfg_r, new_gen()))
        res["phase_ridge_s"] = max((t_fit_r - d0 - t_init) / reps - t_round,
                                   0.0)

        if cfg.use_pallas:
            cfg_x = dataclasses.replace(cfg, use_pallas=False,
                                        use_fused_xla=True)
            res["fused_xla_round_s"] = round_time(cfg_x)[0]
        elif (cfg.defer_r and lead.type == "cuda"
              and pallas_supported(cfg.N, cfg.n_devices, cfg.block_size,
                                   cfg.chunk_size)):
            # A/B against the stored round (K2).
            check_budget()
            cfg_p = dataclasses.replace(cfg, defer_r=False,
                                        use_fused_xla=False, use_pallas=True)
            res["pallas_stored_round_s"] = round_time(cfg_p)[0]
    except OverBudget as e:
        res["phases_truncated"] = str(e)
    return res
