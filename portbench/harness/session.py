"""One run of one cell: set-up, the measured window, the check, the result.

  set-up   the cell's input sets made from the seed on the device and
           copied to the host; one warm call on the first set, with the
           traffic's warm_kwargs (the same shapes, fewer iterations; on a
           fresh checkout it builds the kernel libraries); setup_s runs
           from process start to here.
  window   a closed loop of one caller, calls back to back over the input
           sets in turn, until the first completion at or after
           `seconds` (traced: at most the traffic's trace_seconds); peak
           device memory reset at its start. With trace, torch.profiler
           records the window.
  check    after the window, with the program's state freed: the entry's
           comparisons with the plain reference, each value beside its
           limit.
  result   one JSON object: correct, attempted, failed, metrics, device,
           breakdown (traced runs) and, last, checks. JAX, jaxlib, flax or
           the JAX package loaded after the window, or after the check and
           the readers, stops the run with no result.
"""

from __future__ import annotations

import gc
import math
import os
import sys
import tempfile
import time
import traceback

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from . import entries
from .manifest import Bench
from .tracefile import Trace

FORBIDDEN = ("jax", "jaxlib", "flax", "harmonypy_tpu")


class NoCards(RuntimeError):
    pass


class ForbiddenModules(RuntimeError):
    pass


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: harmonypy_tpu_torch is neither)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_info(device, chips: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": chips}
    return {"platform": "cpu", "kind": "cpu", "count": chips}


class Run:
    """What a per-layer reader sees: the cell, its configuration, the
    window's calls (t0, t1, ok, counters) and the window's trace."""

    def __init__(self, cell, config, traffic, calls, trace):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.calls, self.trace = calls, trace


def run_cell(bench: Bench, workload: str, seed: int, seconds: float,
             trace: bool, t_start: float, device: str = "cuda",
             require_cards: bool = True, log=sys.stderr) -> dict:
    cell = bench.cell(workload)
    config, traffic = bench.config(cell), bench.traffic(cell)
    limits = bench.limits(cell)
    dev = torch.device(device)
    if require_cards and (not torch.cuda.is_available()
                          or torch.cuda.device_count() < cell["chips"]):
        raise NoCards(f"{workload} needs {cell['chips']} CUDA device(s); "
                      f"found {torch.cuda.device_count()}")
    cuda = dev.type == "cuda"
    if cuda:
        if dev.index is None:
            dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    entry = entries.ENTRIES[traffic["entry"]](config, traffic, seed, dev)
    sets = entry.make_inputs()
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    entry.call(sets[0], warm=True)           # warm: every shape, one call
    gc.collect()
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start

    # A traced run reads its trace once the window has closed; a mix of
    # many short calls traces a shorter window (the traffic's
    # trace_seconds), so that reading it keeps the run inside its limit.
    if trace:
        seconds = min(seconds, float(traffic.get("trace_seconds", seconds)))
    calls, first_error = [], None
    prof = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            if trace else None)
    if prof is not None:
        prof.__enter__()
    w0 = time.perf_counter()
    with record_function("portbench::window"):
        while True:
            k = len(calls)
            inp = k % len(sets)
            with record_function("portbench::call"):
                t0 = time.perf_counter()
                try:
                    out, counters = entry.call(sets[inp])
                    ok = True
                except Exception:                       # counted as failed
                    out, counters, ok = None, {}, False
                    first_error = first_error or traceback.format_exc()
                t1 = time.perf_counter()
            calls.append({"t0": t0, "t1": t1, "ok": ok,
                          "counters": counters})
            if ok:
                entry.keep(inp, out)
            del out
            if t1 - w0 >= seconds:
                break
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    trace_obj = None
    if prof is not None:
        prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            del prof
            trace_obj = Trace(path)
        finally:
            os.remove(path)
    bad = forbidden_modules()
    if bad:
        raise ForbiddenModules(f"loaded after the window: {bad}")
    if first_error:
        print(first_error, file=log)
    print("call_s " + " ".join(f"{c['t1'] - c['t0']:.4f}" for c in calls),
          file=log)

    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    done = [c for c in calls if c["ok"]]
    checks = []
    if done:
        for name, value, limit in entry.check(sets, calls, limits):
            checks.append((name, value, limit))
    correct = bool(done) and len(done) == len(calls) and all(
        v <= lim for _, v, lim in checks)

    run = Run(cell, config, traffic, calls, trace_obj)
    values = {"setup_s": setup_s,
              "peak_mem_mib": peak / 2 ** 20,
              traffic["call_metric"]:
                  (sum(c["t1"] - c["t0"] for c in done) / len(done)
                   if done else math.inf)}
    metrics = {}
    if trace:
        for m in bench.per_layer(workload):
            v = bench.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in bench.end_to_end(workload):
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    info = device_info(dev, cell["chips"])
    info["memory_peak_bytes"] = int(peak)
    result = {"correct": correct, "attempted": len(calls),
              "failed": len(calls) - len(done), "metrics": metrics,
              "device": info}
    if trace_obj is not None:
        lo, hi = trace_obj.window()
        info["busy_s"] = float(sum(e - s for s, e in trace_obj.busy())
                               / cell["chips"])
        info["window_s"] = float(hi - lo)
        result["breakdown"] = trace_obj.breakdown()
        print(f"trace: {len(trace_obj.device)} device ops, "
              f"{trace_obj.unmatched_launches()} without a launch record",
              file=log)
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in checks}
    for n, v, lim in checks:
        print(f"check {n} {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAIL'}", file=log)
    # Again once the check and the readers have run: what they import
    # counts as much as what the window did.
    bad = forbidden_modules()
    if bad:
        raise ForbiddenModules(f"loaded after the check and the readers: "
                               f"{bad}")
    return result
