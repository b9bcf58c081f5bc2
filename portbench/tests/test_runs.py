"""Tiny cells run end to end on the CPU, the harness's look for a card
skipped."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from conftest import PB, ROOT, TINY_HARMONY
from harness.manifest import Bench
from harness.session import run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(root, workload, trace, seconds=0.5, seed=2 ** 31 + 12345):
    torch.set_num_threads(2)
    return run_cell(Bench(root), workload, seed, seconds, trace,
                    time.perf_counter(), device="cpu", require_cards=False)


@pytest.mark.parametrize("trace", [False, True])
def test_fit_runs_every_round_and_is_correct(tiny_root, trace):
    r = _run(tiny_root, "tiny.fit", trace)
    assert r["correct"], r["checks"]
    want = TINY_HARMONY["max_iter_harmony"] * TINY_HARMONY["max_iter_kmeans"]
    assert r["checks"]["rounds_off"]["value"] == 0
    if trace:
        assert r["metrics"]["kmeans_rounds.fit"]["value"] == want
        for name in ("host_prep_s.fit", "init_s.fit", "cluster_s.fit",
                     "ridge_s.fit"):
            assert 0 < r["metrics"][name]["value"]
        # A CPU run reads no device metric.
        assert "device_idle_pct.fit" not in r["metrics"]
        assert "cluster_roofline_pct.fit" not in r["metrics"]


@pytest.mark.parametrize("workload", ["tiny.fit", "tiny.lisi"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(tiny_root, workload, trace):
    r = _run(tiny_root, workload, trace)
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(r) == want
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    if trace:
        assert set(r["device"]) >= {"busy_s", "window_s"}
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in r["breakdown"].values())
    else:
        b = Bench(tiny_root)
        assert set(r["metrics"]) == {e["name"] for e in
                                     b.end_to_end(workload)}
    json.dumps(r, allow_nan=False)


def test_no_jax_loaded_after_a_run(tiny_root):
    code = (
        "import sys, time\n"
        f"sys.path[:0] = [{PB!r}, {ROOT!r}]\n"
        "from harness.manifest import Bench\n"
        "from harness.session import run_cell, forbidden_modules\n"
        f"run_cell(Bench({tiny_root!r}), 'tiny.lisi', 7, 0.1, False,\n"
        "         time.perf_counter(), device='cpu', require_cards=False)\n"
        "mods = {m.split('.')[0] for m in sys.modules}\n"
        "assert 'harmonypy_tpu_torch' in mods\n"
        "assert not {'jax', 'jaxlib', 'flax', 'harmonypy_tpu'} & mods, mods\n"
        "assert not forbidden_modules()\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=600)


def test_reader_loading_jax_gives_no_result(tiny_root, tmp_path):
    """A per-layer reader that loads a forbidden module after the window
    (here a stand-in registered as flax) stops the run: non-zero exit,
    nothing on standard output, the module named on standard error."""
    root = tmp_path / "root"
    shutil.copytree(tiny_root, root)
    (root / "portbench" / "metrics" / "knn_s.lisi.py").write_text(
        "import sys, types\n\n\n"
        "def read(run):\n"
        "    sys.modules['flax'] = types.ModuleType('flax')\n"
        "    return None\n")
    code = (
        "import json, sys, time\n"
        f"sys.path[:0] = [{PB!r}, {ROOT!r}]\n"
        "from harness.manifest import Bench\n"
        "from harness.session import run_cell\n"
        f"r = run_cell(Bench({str(root)!r}), 'tiny.lisi', 7, 0.1, True,\n"
        "             time.perf_counter(), device='cpu',\n"
        "             require_cards=False)\n"
        "print(json.dumps(r))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "flax" in proc.stderr


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from harness import session
    monkeypatch.setitem(sys.modules, "harmonypy_tpu_torch_like", sys)
    assert "harmonypy_tpu" not in session.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert session.forbidden_modules() == ["jax"]


def test_run_refuses_without_cards():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run(
        [sys.executable, os.path.join(PB, "run.py"), "--workload",
         "hlca-2400k.fit", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr
