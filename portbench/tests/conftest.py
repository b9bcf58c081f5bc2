"""Tiny cells on the CPU: a root with its own BENCHMARK.json, the
harness's code, readers and traffic as they are, and tiny configurations
and limits."""

import copy
import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
ROOT = os.path.dirname(PB)
sys.path.insert(0, PB)
sys.path.insert(1, ROOT)

TINY_DATA = {"n_cells": 24000, "n_pcs": 12, "n_batches": 3, "n_groups": 8,
             "center_scale": 5.0, "batch_shift_scale": 1.5,
             "noise_scale": 1.0}
TINY_HARMONY = {"nclust": 20, "theta": 2.0, "sigma": 0.1, "lamb": 1.0,
                "block_size": 0.05, "max_iter_harmony": 3,
                "max_iter_kmeans": 4, "matmul_precision": "default",
                "low_memory": False}
TINY_LIMITS = {
    "tiny.fit": {"rounds_off": 0, "repeat_mismatch": 0, "zcorr_err": 1e-3,
                 "zcorr_gap": 1e-2, "zcorr_raw": 0.1},
    "tiny.lisi": {"repeat_mismatch": 0, "lisi_out_of_range": 0,
                  "lisi_gap": 1e-9}}


def tiny_manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        m = json.load(f)
    m = copy.deepcopy(m)
    m["configs"] = [{"name": "tiny", "source": "https://example.org/tiny",
                     "file": "portbench/configs/tiny.json", "reduced": [],
                     "why": "a CPU-sized deployment for the tests"}]
    m["workloads"] = [
        {"name": "tiny.fit", "config": "tiny", "traffic": "fit", "chips": 1,
         "why": "tests"},
        {"name": "tiny.lisi", "config": "tiny", "traffic": "lisi",
         "chips": 1, "why": "tests"}]
    rename = {"hlca-2400k.fit": "tiny.fit", "large-858k.fit": None,
              "large-858k.lisi": "tiny.lisi"}
    for e in m["end_to_end"] + m["per_layer"]:
        if "workloads" in e:
            e["workloads"] = [rename[w] for w in e["workloads"]
                              if rename[w]]
    return m


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("root")
    pb = root / "portbench"
    for d in ("harness", "reference", "metrics", "traffic"):
        shutil.copytree(os.path.join(PB, d), pb / d)
    (pb / "configs").mkdir()
    (pb / "limits").mkdir()
    (pb / "configs" / "tiny.json").write_text(json.dumps(
        {"name": "tiny", "data": TINY_DATA, "harmony": TINY_HARMONY}))
    for w, lim in TINY_LIMITS.items():
        (pb / "limits" / f"{w}.json").write_text(json.dumps(lim))
    lisi = json.loads((pb / "traffic" / "lisi.json").read_text())
    lisi["check_queries"] = 512
    (pb / "traffic" / "lisi.json").write_text(json.dumps(lisi))
    (root / "BENCHMARK.json").write_text(json.dumps(tiny_manifest()))
    return str(root)
