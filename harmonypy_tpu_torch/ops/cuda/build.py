"""Build the package's CUDA sources at first use and load them with ctypes.

Each `csrc/<name>.cu` is compiled by `nvcc` into a shared library with a
plain C interface, `harmonypy_tpu_torch/build/lib<name>-<hash>.so`, for
Hopper (`sm_90a`). The hash of the source and of the `csrc/` headers it
includes (`#include "..."`, followed into their own includes) names the
library, so an edited source or header is rebuilt and an unchanged one is
loaded as it is. All sources are compiled in parallel, one `nvcc` process
each, except those in ON_DEMAND, which `load` builds alone when asked for.
Any failure raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Sources that no fit runs (the stamped round, ops/cuda/round_timing.py,
# and the stamped per-block entry, ops/cuda/block_timing.py): left out of
# build_all's default set.
ON_DEMAND = ("fused_estep_timed", "fused_estep_block_timed")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}   # ptxas report of each source built here
build_seconds: dict[str, float] = {}  # its nvcc's wall seconds


def _nvcc() -> str:
    cands = [shutil.which("nvcc"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc")]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels of harmonypy_tpu_torch cannot be built")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _sources(path: str, seen: dict) -> dict:
    """path and every csrc/ file it includes with quotes, recursively:
    {path: contents}."""
    if path not in seen:
        with open(path, "rb") as f:
            seen[path] = f.read()
        for inc in _INCLUDE.findall(seen[path]):
            _sources(os.path.join(os.path.dirname(path), inc.decode()), seen)
    return seen


def _target(name: str) -> str:
    files = _sources(os.path.join(CSRC, name + ".cu"), {})
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(files):
        digest.update(os.path.basename(path).encode() + b"\0" + files[path])
    return os.path.join(BUILD, f"lib{name}-{digest.hexdigest()[:12]}.so")


def default_sources() -> list[str]:
    """The csrc/*.cu that build_all builds by default: all but ON_DEMAND."""
    return sorted(f[:-3] for f in os.listdir(CSRC)
                  if f.endswith(".cu") and f[:-3] not in ON_DEMAND)


def build_all(names=None) -> dict[str, str]:
    """Compile every csrc/*.cu (or the sources `names`) that has no
    library yet, all at once; by default default_sources(). Returns {name:
    library path}."""
    if names is None:
        names = default_sources()
    targets = {n: _target(n) for n in names}
    todo = {n: t for n, t in targets.items() if not os.path.isfile(t)}
    if todo:
        os.makedirs(BUILD, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        t0 = time.perf_counter()
        for n, t in todo.items():
            tmp = f"{t}.{os.getpid()}.tmp"
            procs[n] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, n + ".cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

        def wait(n, p):
            build_log[n] = p.communicate()[0]
            build_seconds[n] = time.perf_counter() - t0
        waits = [threading.Thread(target=wait, args=(n, p))
                 for n, (_, p) in procs.items()]
        for w in waits:
            w.start()
        for w in waits:
            w.join()
        failed = []
        for n, (tmp, p) in procs.items():
            out = build_log[n]
            if p.returncode != 0:
                failed.append(f"{n}.cu (nvcc exit {p.returncode}):\n{out}")
            else:
                os.replace(tmp, todo[n])
        if failed:
            raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            paths = build_all([name] if name in ON_DEMAND else None)
            lib = _libs[name] = ctypes.CDLL(paths[name])
        return lib
