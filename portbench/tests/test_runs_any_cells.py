"""The tiny runs of test_runs.py and test_faults.py (a run comes out
correct, its result keys, the planted faults come out not correct, no JAX
loaded after a run) on a tiny root built from BENCHMARK.json whatever
cells it lists: conftest's tiny_manifest maps each listed cell through a
fixed table of the first three and raises KeyError on any other name, so
its tiny_root errors once the manifest lists more cells. Here the cells
outside that table leave the tiny manifest, as large-858k.fit does
there."""

import copy
import json
import os
import shutil

import pytest

from conftest import PB, ROOT, TINY_DATA, TINY_HARMONY, TINY_LIMITS
from harness.manifest import validate
from test_faults import (  # noqa: F401  (collected here with tiny_root below)
    test_fit_fault_is_not_correct, test_lisi_fault_is_not_correct)
from test_runs import (  # noqa: F401
    test_fit_runs_every_round_and_is_correct, test_no_jax_loaded_after_a_run,
    test_reader_loading_jax_gives_no_result, test_result_keys)

RENAME = {"hlca-2400k.fit": "tiny.fit", "large-858k.lisi": "tiny.lisi"}


def tiny_manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        m = copy.deepcopy(json.load(f))
    m["configs"] = [{"name": "tiny", "source": "https://example.org/tiny",
                     "file": "portbench/configs/tiny.json", "reduced": [],
                     "why": "a CPU-sized deployment for the tests"}]
    m["workloads"] = [
        {"name": w, "config": "tiny", "traffic": w.split(".")[1],
         "chips": 1, "why": "tests"} for w in TINY_LIMITS]
    for key in ("end_to_end", "per_layer"):
        for e in m[key]:
            if "workloads" in e:
                e["workloads"] = [RENAME[w] for w in e["workloads"]
                                  if w in RENAME]
        # A metric read only in cells outside the table leaves with them.
        m[key] = [e for e in m[key] if e.get("workloads", True)]
    return m


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """conftest's tiny_root, from the manifest above."""
    root = tmp_path_factory.mktemp("root_any_cells")
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


def test_every_listed_cell_outside_the_table_leaves():
    m = tiny_manifest()
    validate(m)
    listed = {w for e in m["end_to_end"] + m["per_layer"]
              for w in e.get("workloads", [])}
    assert listed == {"tiny.fit", "tiny.lisi"}
