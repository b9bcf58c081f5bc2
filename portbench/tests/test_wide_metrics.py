"""The readers of the wide plan's, the one-hot ridge's and the mesh pass's
ranges (harmony::k1_wide, harmony::design_sums, harmony::mesh_pass) on a
made-up trace, each against its value computed by hand; none reads
anything from a trace without those ranges, and the readers that were
there before them read the same with and without them."""

import json

import pytest

from harness.manifest import Bench
from harness.session import Run
from harness.tracefile import Trace

from conftest import ROOT

NEW = ("wide_rounds_pct.fit", "design_sums_s.fit", "mesh_pass_ms.fit")
OLD = ("cluster_s.fit", "ridge_s.fit", "k1_roofline_pct.fit",
       "device_idle_pct.fit", "sync_s.fit")


def _range(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "args": {}}


def _launch(ts, corr, name, dev_ts, dev_dur):
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "ts": ts, "dur": 0.5, "args": {"correlation": corr}},
            {"ph": "X", "cat": "kernel", "name": name, "ts": dev_ts,
             "dur": dev_dur, "args": {"correlation": corr}}]


def _events(spans: bool) -> list:
    """Two calls of 100 us. In each: the k-means loop 40 us with four
    rounds (harmony::k1 of 4 us each, a 6 us kernel launched in each), the
    replay 20 us with a 2 us kernel and a 3 us one launched in it. With
    spans: the first three rounds' launches (not the fourth's) each hold a
    harmony::k1_wide, the replay's two kernels are launched in
    harmony::design_sums (two ranges), and each round is one
    harmony::mesh_pass of 5 us (first call) or 7 us (second)."""
    ev = [_range("portbench::window", 0, 220)]
    corr = 0
    for c, t0 in enumerate((0, 110)):
        ev += [_range("portbench::call", t0, 100),
               _range("harmony::cluster", t0 + 10, 40),
               _range("harmony::ridge_replay", t0 + 60, 20)]
        for i in range(4):
            s = t0 + 11 + 9 * i
            ev += [_range("harmony::k1", s, 4)]
            ev += _launch(s + 1, corr, "estep_round", s + 2, 6)
            corr += 1
            if spans:
                ev += [_range("harmony::mesh_pass", s, 5 + 2 * c)]
                if i < 3:
                    ev += [_range("harmony::k1_wide", s + 0.5, 1)]
        ev += _launch(t0 + 62, corr, "design", t0 + 63, 2)
        ev += _launch(t0 + 70, corr + 1, "gather", t0 + 72, 3)
        corr += 2
        if spans:
            ev += [_range("harmony::design_sums", t0 + 61, 2),
                   _range("harmony::design_sums", t0 + 69, 2)]
    return ev


def _trace(tmp_path, spans: bool) -> Trace:
    path = tmp_path / f"t{int(spans)}.json"
    path.write_text(json.dumps({"traceEvents": _events(spans)}))
    return Trace(str(path))


def _read(trace, name, cell="hlca-2400k-donors.fit"):
    b = Bench(ROOT)
    c = b.cell(cell)
    calls = [{"ok": True, "counters": {"kmeans_rounds": 4}}] * 2
    return b.reader(name)(Run(c, b.config(c), b.traffic(c), calls, trace))


def test_each_new_reader_reads_its_value(tmp_path):
    t = _trace(tmp_path, spans=True)
    want = {"wide_rounds_pct.fit": 75.0, "design_sums_s.fit": 5e-6,
            "mesh_pass_ms.fit": 6e-3}
    for name in NEW:
        assert _read(t, name) == pytest.approx(want[name], rel=1e-9), name


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_without_the_ranges(tmp_path, name):
    got = _read(_trace(tmp_path, spans=False), name)
    # Rounds without a wide launch read 0; the others have nothing.
    assert got == (0.0 if name == "wide_rounds_pct.fit" else None)


@pytest.mark.parametrize("name", OLD)
def test_older_readers_read_the_same_with_the_ranges(tmp_path, name):
    assert _read(_trace(tmp_path, spans=True), name) == _read(
        _trace(tmp_path, spans=False), name)


def test_new_cells_and_readers_in_the_manifest():
    """The two cells and three readers, each reader listing only cells
    that report fit_s; the 4-card cell off the one-card roofline shares."""
    b = Bench(ROOT)
    assert b.cell("hlca-2400k-4card.fit")["chips"] == 4
    four = [p["name"] for p in b.per_layer("hlca-2400k-4card.fit")]
    assert "mesh_pass_ms.fit" in four and "design_sums_s.fit" in four
    assert not any("roofline" in n for n in four)
    donor = [p["name"] for p in b.per_layer("hlca-2400k-donors.fit")]
    assert {"wide_rounds_pct.fit", "k1_roofline_pct.fit",
            "cluster_roofline_pct.fit"} <= set(donor)
    assert b.traffic(b.cell("hlca-2400k-4card.fit"))["kwargs"][
        "device"] == "cuda"
