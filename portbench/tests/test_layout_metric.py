"""The reader of api::layout, the on-device build of the padded embedding,
one-hot design and mask, on a made-up trace: the share of calls whose
api::upload range holds an api::layout range, and nothing to read where
the trace has no api::upload range."""

import json

import pytest

from harness.manifest import Bench
from harness.session import Run
from harness.tracefile import Trace

from conftest import ROOT

NAME = "layout_on_card_pct.fit"


def _range(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "args": {}}


def _trace(tmp_path, upload: bool, layout=(0, 1)) -> Trace:
    """Two calls of 100 us, each with a 2 us upload at 9 us; the calls in
    `layout` hold a 0.3 us api::layout range inside their upload. A third
    layout range lies outside every upload and counts for nothing."""
    ev = [_range("portbench::window", 0, 220),
          _range("api::layout", 215, 0.3)]
    for c, t0 in enumerate((0, 110)):
        ev.append(_range("portbench::call", t0, 100))
        if upload:
            ev.append(_range("api::upload", t0 + 9, 2))
            if c in layout:
                ev.append(_range("api::layout", t0 + 9.6, 0.3))
    tag = f"{int(upload)}{''.join(map(str, layout))}"
    path = tmp_path / f"t{tag}.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return Trace(str(path))


def _read(trace):
    b = Bench(ROOT)
    cell = b.cell("large-858k.fit")
    calls = [{"ok": True, "counters": {"kmeans_rounds": 3}}] * 2
    return b.reader(NAME)(Run(cell, b.config(cell), b.traffic(cell), calls,
                              trace))


@pytest.mark.parametrize("layout,pct", [((0, 1), 100.0), ((0,), 50.0),
                                        ((), 0.0)])
def test_layout_share_counts_the_calls_that_lay_out_on_the_device(
        tmp_path, layout, pct):
    """A call whose upload holds no api::layout range (the host's pad, as
    before the range existed) counts against the share."""
    assert _read(_trace(tmp_path, True, layout)) == pct


def test_nothing_to_read_without_the_upload_range(tmp_path):
    assert _read(_trace(tmp_path, False)) is None
