"""The control on a card, at a size a test run holds: the plain reference
put in the program's place one precision step below the stated one fails
the cell's limits, and the program's answer passes them (fit: bf16
products stated, fp8 control; LISI: float64 stated, float32 control).
The benchmark's own runs never run the control."""

import copy

import pytest
import torch

from conftest import ROOT
from harness import entries
from harness.manifest import Bench


def _cell(workload, n_cells):
    b = Bench(ROOT)
    cell = b.cell(workload)
    config = copy.deepcopy(b.config(cell))
    config["data"]["n_cells"] = n_cells
    return config, b.traffic(cell), b.limits(cell)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_fit_control_fails_program_passes(seed):
    dev = _card()
    config, traffic, limits = _cell("large-858k.fit", 200_000)
    e = entries.Fit(config, traffic, seed, dev)
    inp = e.make_inputs()[0]
    out, counters = e.call(inp)
    assert counters["kmeans_rounds"] == e.expected_rounds()
    got = {n: (v, lim) for n, v, lim in e.compare(inp, out, limits)}
    assert all(v <= lim for v, lim in got.values()), got
    ctrl = e.reference(inp, "fp8")[0].cpu().numpy()
    bad = {n: (v, lim) for n, v, lim in e.compare(inp, ctrl, limits)}
    assert any(v > lim for v, lim in bad.values()), bad


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [21, 22, 23])
def test_lisi_control_fails_program_passes(seed):
    dev = _card()
    config, traffic, limits = _cell("large-858k.lisi", 120_000)
    traffic = dict(traffic, check_queries=4096)
    e = entries.Lisi(config, traffic, seed, dev)
    inp = e.make_inputs()[0]
    out, _ = e.call(inp)
    got = {n: (v, lim) for n, v, lim in e.compare(inp, out, limits)}
    assert all(v <= lim for v, lim in got.values()), got
    q = e.queries(out.shape[0])
    ctrl = out.copy()
    ctrl[q] = e.reference(inp, q, "float32")
    bad = {n: (v, lim) for n, v, lim in e.compare(inp, ctrl, limits)}
    assert any(v > lim for v, lim in bad.values()), bad
