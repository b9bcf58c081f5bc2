"""The yardstick's arithmetic: intervals taken as unions, the trace's
launch attribution, the readers on a made-up trace, and the round's
work counted from shapes."""

import json

import numpy as np
import pytest

from harness.manifest import Bench
from harness.roofline import round_least_s, round_work
from harness.session import Run
from harness.tracefile import Trace, intersect, length, union

from conftest import ROOT


def test_union_never_counts_overlap_twice():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (2.9, 4)]
    assert union(iv).tolist() == [[0, 4], [5, 6]]
    assert length(iv) == pytest.approx(5.0)
    assert length(intersect(iv, [(1, 5.5)])) == pytest.approx(3.5)


def test_round_work_of_the_858k_round():
    flop, nbytes = round_work(858_000, 29, 100, 3, 2048)
    assert flop == pytest.approx(11.15e9, rel=1e-3)
    assert nbytes == pytest.approx(118.8e6, rel=1e-3)
    assert round_least_s(858_000, 29, 100, 3, 2048) == pytest.approx(
        118.8e6 / 3.35e12, rel=1e-3)


def _event(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


@pytest.fixture
def trace(tmp_path):
    """Two calls of 100 us; in each, init 10 us, cluster 40 us with a
    nested estep range, ridge 10 us; one 20 us kernel launched in each
    cluster range and one 5 us copy launched outside every range."""
    ev = [_event("user_annotation", "portbench::window", 0, 220)]
    for c, t0 in enumerate((0, 110)):
        ev += [_event("user_annotation", "portbench::call", t0, 100),
               _event("user_annotation", "harmony::init", t0 + 10, 10),
               _event("user_annotation", "harmony::cluster", t0 + 30, 40),
               _event("user_annotation", "harmony::estep", t0 + 35, 10),
               _event("user_annotation", "harmony::ridge_replay", t0 + 75,
                      10),
               _event("cuda_runtime", "cudaLaunchKernel", t0 + 40, 1,
                      correlation=2 * c),
               _event("kernel", "k1", t0 + 50, 20, correlation=2 * c),
               _event("cuda_runtime", "cudaMemcpyAsync", t0 + 90, 1,
                      correlation=2 * c + 1),
               _event("gpu_memcpy", "Memcpy DtoH", t0 + 91, 5,
                      correlation=2 * c + 1),
               _event("cpu_op", "aten::copy_", t0 + 88, 9)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return Trace(str(path))


def _read(trace, name, calls=None):
    b = Bench(ROOT)
    cell = b.cell("large-858k.fit")
    calls = calls or [{"ok": True, "counters": {"kmeans_rounds": 200}}] * 2
    return b.reader(name)(Run(cell, b.config(cell), b.traffic(cell), calls,
                              trace))


def test_launches_attributed_to_their_host_range(trace):
    assert len(trace.launched_in("harmony::cluster")) == 2
    assert trace.unmatched_launches() == 0
    assert length(trace.busy()) == pytest.approx(50e-6)


def test_readers_give_per_call_unions(trace):
    assert _read(trace, "init_s.fit") == pytest.approx(10e-6)
    assert _read(trace, "cluster_s.fit") == pytest.approx(40e-6)
    assert _read(trace, "ridge_s.fit") == pytest.approx(10e-6)
    assert _read(trace, "host_prep_s.fit") == pytest.approx(40e-6)
    assert _read(trace, "device_idle_pct.fit") == pytest.approx(
        100 * 170 / 220)
    assert _read(trace, "kmeans_rounds.fit") == 200
    least = 400 * round_least_s(858_000, 29, 100, 3, 2048)
    assert _read(trace, "cluster_roofline_pct.fit") == pytest.approx(
        100 * least / 40e-6)


def test_breakdown_names_the_host_range_of_each_gap(trace):
    b = trace.breakdown()
    assert b["device_ops"][0] == ["k1", pytest.approx(40e-6)]
    gaps = dict(b["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx(170e-6)
    assert "portbench::call / aten::copy_" in gaps
    assert all(len(v) <= 10 for v in b.values())
