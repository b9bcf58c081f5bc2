"""The reader of the codes plan's range (harmony::k1_codes) on made-up
traces, against its value computed by hand: 100%, 50% and 0% of the
rounds' harmony::k1 ranges holding one, nothing without harmony::k1
ranges, and nothing from a program that has no codes plan; the readers
that were there before it read the same with and without the range."""

import json

import pytest

from harness.manifest import Bench
from harness.session import Run
from harness.tracefile import Trace

from conftest import ROOT

NAME = "codes_rounds_pct.fit"
OLD = ("wide_rounds_pct.fit", "cluster_s.fit", "k1_roofline_pct.fit",
       "device_idle_pct.fit")


def _range(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "args": {}}


def _events(coded, rounds=True) -> list:
    """One call of 100 us whose loop holds four rounds (harmony::k1 of 4
    us, each holding a harmony::k1_wide, a 6 us kernel launched in each);
    the first `coded` rounds also hold a harmony::k1_codes inside their
    harmony::k1_wide. rounds=False: no harmony::k1 ranges at all."""
    ev = [_range("portbench::window", 0, 120),
          _range("portbench::call", 0, 100),
          _range("harmony::cluster", 10, 40)]
    for i in range(4):
        s = 11 + 9 * i
        if rounds:
            ev.append(_range("harmony::k1", s, 4))
        ev.append(_range("harmony::k1_wide", s + 0.5, 2))
        if i < coded:
            ev.append(_range("harmony::k1_codes", s + 0.75, 1))
        ev += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": s + 1, "dur": 0.5, "args": {"correlation": i}},
               {"ph": "X", "cat": "kernel", "name": "estep_round",
                "ts": s + 2, "dur": 6, "args": {"correlation": i}}]
    return ev


def _read(tmp_path, name, coded, rounds=True):
    path = tmp_path / f"t{coded}{int(rounds)}.json"
    path.write_text(json.dumps({"traceEvents": _events(coded, rounds)}))
    b = Bench(ROOT)
    c = b.cell("hlca-2400k-donors.fit")
    calls = [{"ok": True, "counters": {"kmeans_rounds": 4}}]
    return b.reader(name)(Run(c, b.config(c), b.traffic(c), calls,
                              Trace(str(path))))


@pytest.mark.parametrize("coded,want", [(4, 100.0), (2, 50.0), (0, 0.0)])
def test_the_reader_reads_the_share_of_rounds(tmp_path, coded, want):
    assert _read(tmp_path, NAME, coded) == pytest.approx(want, rel=1e-12)


def test_nothing_to_read_without_rounds(tmp_path):
    assert _read(tmp_path, NAME, 4, rounds=False) is None


def test_nothing_to_read_from_a_program_without_the_plan(tmp_path,
                                                         monkeypatch):
    """A program whose kernel wrapper has no codes plan (no
    launches_codes): the reader returns nothing, whatever the trace."""
    from harmonypy_tpu_torch.ops.cuda import fused_estep
    monkeypatch.delattr(fused_estep, "launches_codes")
    assert _read(tmp_path, NAME, 4) is None


@pytest.mark.parametrize("name", OLD)
def test_older_readers_read_the_same_with_the_range(tmp_path, name):
    assert _read(tmp_path, name, 4) == _read(tmp_path, name, 0)


def test_the_reader_in_the_manifest():
    """Appended last, of the Kernels layer, moving fit_s, in the donors
    cell alone."""
    b = Bench(ROOT)
    entry = b.m["per_layer"][-1]
    assert entry == {"name": NAME, "unit": "%", "better": "higher",
                     "source": "program_counter", "layer": "Kernels",
                     "moves": "fit_s",
                     "workloads": ["hlca-2400k-donors.fit"]}
    assert NAME in [p["name"] for p in b.per_layer("hlca-2400k-donors.fit")]
    assert NAME not in [p["name"] for p in b.per_layer("hlca-2400k.fit")]
