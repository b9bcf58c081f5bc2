"""The readers of the program's own spans (api::*, harmony::k1,
harmony::tables, sync::*) on a made-up trace, each against its value
computed by hand; none reads anything from a trace without those spans,
and the readers that were there before them read the same with and
without them."""

import json

import pytest

from harness.manifest import Bench
from harness.roofline import round_least_s
from harness.session import Run
from harness.tracefile import Trace

from conftest import ROOT

NEW = ("design_s.fit", "upload_s.fit", "readback_s.fit",
       "host_syncs_per_round.fit", "sync_s.fit", "k1_roofline_pct.fit",
       "host_syncs.lisi")
OLD = ("host_prep_s.fit", "init_s.fit", "cluster_s.fit", "kmeans_rounds.fit",
       "ridge_s.fit", "cluster_roofline_pct.fit", "device_idle_pct.fit",
       "knn_s.lisi", "device_idle_pct.lisi")
ROUNDS = 3          # per call


def _range(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "args": {}}


def _launch(ts, corr, kind, name, dev_ts, dev_dur):
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "ts": ts, "dur": 0.5, "args": {"correlation": corr}},
            {"ph": "X", "cat": kind, "name": name, "ts": dev_ts,
             "dur": dev_dur, "args": {"correlation": corr}}]


def _events(spans: bool) -> list:
    """Two calls of 100 us. In each: init 10 us, the k-means loop 40 us
    (a 20 us kernel launched inside harmony::k1, a 5 us one launched in
    the loop outside it), the replay 10 us, a 3 us copy launched in the
    readback, 1 us of pruned scan. With spans: the design in two ranges
    (5 + 2 us), the upload 2 us, the readback 8 us, and waits: 1 us in
    the upload, two of 1 and 0.5 us in the loop's tables, 2 us at the
    loop's convergence test, 2 us at the harmony test outside every
    harmony:: range, 6 us in the readback, 0.2 us in the scan."""
    ev = [_range("portbench::window", 0, 220)]
    for c, t0 in enumerate((0, 110)):
        ev += [_range("portbench::call", t0, 100),
               _range("harmony::init", t0 + 10, 10),
               _range("harmony::cluster", t0 + 30, 40),
               _range("harmony::ridge_replay", t0 + 75, 10),
               _range("lisi::scan", t0 + 98.5, 1)]
        ev += _launch(t0 + 37, 3 * c, "kernel", "k1", t0 + 45, 20)
        ev += _launch(t0 + 65, 3 * c + 1, "kernel", "frame_sum", t0 + 66, 5)
        ev += _launch(t0 + 91, 3 * c + 2, "gpu_memcpy", "Memcpy DtoH",
                      t0 + 93, 3)
        if spans:
            ev += [_range("api::design", t0, 5),
                   _range("api::design", t0 + 6, 2),
                   _range("api::upload", t0 + 8, 2),
                   _range("sync::upload", t0 + 8.5, 1),
                   _range("harmony::tables", t0 + 31, 4),
                   _range("sync::tables", t0 + 32, 1),
                   _range("sync::tables", t0 + 33.5, 0.5),
                   _range("harmony::k1", t0 + 36, 4),
                   _range("sync::conv_kmeans", t0 + 60, 2),
                   _range("sync::conv_harmony", t0 + 86, 2),
                   _range("api::readback", t0 + 90, 8),
                   _range("sync::readback", t0 + 91, 6),
                   _range("sync::lisi_scan", t0 + 99, 0.2)]
    return ev


def _trace(tmp_path, spans: bool) -> Trace:
    path = tmp_path / f"t{int(spans)}.json"
    path.write_text(json.dumps({"traceEvents": _events(spans)}))
    return Trace(str(path))


def _read(trace, name):
    b = Bench(ROOT)
    cell = b.cell("large-858k.fit")
    calls = [{"ok": True, "counters": {"kmeans_rounds": ROUNDS}}] * 2
    return b.reader(name)(Run(cell, b.config(cell), b.traffic(cell), calls,
                              trace))


def test_each_reader_of_the_spans_reads_its_value(tmp_path):
    t = _trace(tmp_path, spans=True)
    least = 2 * ROUNDS * round_least_s(858_000, 29, 100, 3, 2048)
    want = {"design_s.fit": 7e-6, "upload_s.fit": 2e-6,
            "readback_s.fit": 8e-6,
            "host_syncs_per_round.fit": 3 / ROUNDS,
            "sync_s.fit": (1 + 1 + 0.5 + 2 + 2 + 6 + 0.2) * 1e-6,
            "k1_roofline_pct.fit": 100 * least / 40e-6,
            "host_syncs.lisi": 7}
    for name in NEW:
        assert _read(t, name) == pytest.approx(want[name], rel=1e-9), name
    # The kernel alone, not the loop's other launches.
    assert _read(t, "k1_roofline_pct.fit") > _read(
        t, "cluster_roofline_pct.fit")


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_without_the_spans(tmp_path, name):
    assert _read(_trace(tmp_path, spans=False), name) is None


@pytest.mark.parametrize("name", OLD)
def test_older_readers_read_the_same_with_the_spans(tmp_path, name):
    assert _read(_trace(tmp_path, spans=True), name) == _read(
        _trace(tmp_path, spans=False), name)

