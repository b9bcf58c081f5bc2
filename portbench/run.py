#!/usr/bin/env python3
"""The benchmark of harmonypy_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout that holds BENCHMARK.json. The cell's
configuration, traffic mix, per-layer readers and correctness limits are
found by name (harness/manifest.py). Prints the comparisons with the
plain reference as the last lines on standard error and one JSON result
as the last line on standard output; exits non-zero with no result where
the cell's CUDA devices are missing, where JAX or the JAX package was
loaded, or where anything fails.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Caches of the program's toolchain live at fixed paths in the checkout
# (the kernel libraries already do: harmonypy_tpu_torch/build).
CACHE = os.path.join(HERE, ".cache")
os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(CACHE, "cuda"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", os.path.join(CACHE, "inductor"))
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)


def _finite(x):
    """Result numbers as JSON allows them (no infinities or NaN)."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return 1e300 if x > 0 else -1e300
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    from harness.manifest import Bench
    from harness.session import run_cell
    result = run_cell(Bench(ROOT), a.workload, a.seed, a.seconds,
                      bool(a.trace), T_START)
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
