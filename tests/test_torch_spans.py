"""The port's profiler ranges (utils/profiling.span) on the CPU: which
ranges a fit and a LISI call record and where they lie, that a call with
no profiler recording enters no record_function, and that a fit's Z_corr
and a pruned LISI are the same bits with the profiler on and off."""

import numpy as np
import pandas as pd
import pytest
import torch
from torch.autograd.profiler import record_function
from torch.profiler import ProfilerActivity, profile

# Test workers share the CPU cores: one intra-op thread each.
torch.set_num_threads(1)

import harmonypy_tpu_torch as ht
from harmonypy_tpu_torch.utils.profiling import span

# Fixed work: neither convergence test can fire (both are strict <).
FIT = dict(nclust=6, chunk_size=128, max_iter_harmony=2, max_iter_kmeans=6,
           epsilon_cluster=0.0, epsilon_harmony=-np.inf, verbose=False,
           device="cpu")
WINDOW = 3          # Harmony.window_size: the k-means test starts after it


def _problem(N=3000, d=8, seed=0):
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 3, N)
    X = (rng.normal(size=(6, d))[rng.integers(0, 6, N)] * 4
         + rng.normal(size=(3, d))[b] + rng.normal(size=(N, d)))
    return X.astype(np.float32), pd.DataFrame({"batch": [f"b{i}" for i in b]})


def _ranges(prof) -> dict:
    """Every range of the port in a profile: name -> (n, 2) start, end."""
    out = {}
    for e in prof.events():
        if e.name.split("::")[0] in ("api", "harmony", "sync", "lisi"):
            out.setdefault(e.name, []).append((e.time_range.start,
                                               e.time_range.end))
    return {k: np.asarray(sorted(v)) for k, v in out.items()}


def _inside(iv, outer) -> np.ndarray:
    """For each interval of iv, whether one interval of outer holds it."""
    return np.asarray([np.any((outer[:, 0] <= s) & (e <= outer[:, 1]))
                       for s, e in iv], dtype=bool)


def _fit(defer_r: bool):
    X, meta = _problem()
    ho = ht.run_harmony(X, meta, ["batch"], defer_r=defer_r, **FIT)
    return ho, ho.Z_corr


@pytest.fixture(scope="module", params=[True, False],
                ids=["deferred", "stored"])
def traced(request):
    """(Harmony, ranges, Z_corr) of one fit under the profiler, and the
    Z_corr of the same fit with no profiler recording."""
    _, z_off = _fit(request.param)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ho, z_on = _fit(request.param)
    assert ho.cfg.defer_r == request.param and ho.cfg.fused_estep
    return ho, _ranges(prof), z_on, z_off


def test_api_ranges_split_the_call(traced):
    ho, r, _, _ = traced
    # run_harmony's one-hot and broadcasting, then Harmony's configuration.
    assert len(r["api::design"]) == 2
    assert len(r["api::upload"]) == 1 and len(r["api::readback"]) == 1
    fit = np.concatenate([v for k, v in r.items()
                          if k.startswith("harmony::")])
    assert r["api::design"][-1, 1] <= r["api::upload"][0, 0] <= fit.min()
    assert fit.max() <= r["api::readback"][0, 0]
    # 4 parameters, Z and the design's codes: the mask is made on the device.
    assert r["sync::upload"].shape[0] == 6
    assert _inside(r["sync::upload"], r["api::upload"]).all()
    # Z's, Phi's and the mask's layout on the device, each after its copy.
    assert r["api::layout"].shape[0] == 3
    assert _inside(r["api::layout"], r["api::upload"]).all()
    assert not _inside(r["api::layout"], r["sync::upload"]).any()
    assert _inside(r["sync::readback"], r["api::readback"]).all()


def test_k1_once_per_round(traced):
    ho, r, _, _ = traced
    assert len(r["harmony::k1"]) == sum(ho.kmeans_rounds) == 12
    assert _inside(r["harmony::k1"], r["harmony::cluster"]).all()


def test_tables_per_round_and_per_replay(traced):
    ho, r, _, _ = traced
    iters = len(ho.kmeans_rounds)
    tables = r["harmony::tables"]
    in_loop = _inside(tables, r["harmony::cluster"])
    assert in_loop.sum() == sum(ho.kmeans_rounds)
    if ho.cfg.defer_r:          # the replays' tables, one per iteration
        assert len(tables) == sum(ho.kmeans_rounds) + iters
        assert _inside(tables[~in_loop], r["harmony::ridge_replay"]).all()
        for name in ("harmony::normal_eq", "harmony::solve",
                     "harmony::apply"):
            assert len(r[name]) == iters
            assert _inside(r[name], r["harmony::ridge_replay"]).all()
    else:
        assert len(tables) == sum(ho.kmeans_rounds)


def test_host_waits_lie_in_the_loop_or_the_replay(traced):
    ho, r, _, _ = traced
    rounds = ho.kmeans_rounds
    conv = r["sync::conv_kmeans"]
    assert len(conv) == sum(n - WINDOW - 1 for n in rounds)
    # Per tables call: a bincount and six boolean selections.
    assert len(r["sync::tables"]) == 7 * len(r["harmony::tables"])
    holders = np.concatenate([r["harmony::cluster"],
                              r.get("harmony::ridge_replay",
                                    np.zeros((0, 2)))])
    assert _inside(np.concatenate([conv, r["sync::tables"]]), holders).all()
    assert len(r["sync::conv_harmony"]) == len(rounds)
    assert not _inside(r["sync::conv_harmony"], holders).any()


def test_fit_bits_with_the_profiler_on_and_off(traced):
    _, _, z_on, z_off = traced
    assert np.array_equal(z_on, z_off)


def test_no_profiler_enters_no_record_function(monkeypatch):
    entered = []
    enter = record_function.__enter__

    def counting(self):
        entered.append(self.name)
        return enter(self)

    monkeypatch.setattr(record_function, "__enter__", counting)
    _fit(True)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        _fit(True)
    assert "harmony::k1" in entered and "api::design" in entered


def test_span_decides_at_each_call(monkeypatch):
    assert span("a") is span("a")              # the shared no-op

    @span("test::idle_when_applied")
    def f():
        return 1

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        @span("test::recording_when_applied")
        def g():
            return 2

        assert f() + g() == 3
    names = {e.name for e in prof.events()}
    assert {"test::idle_when_applied",
            "test::recording_when_applied"} <= names
    entered = []
    enter = record_function.__enter__
    monkeypatch.setattr(record_function, "__enter__",
                        lambda self: entered.append(self) or enter(self))
    assert f() + g() == 3 and entered == []


def test_pruned_lisi_ranges_and_bits():
    X, meta = _problem(N=4000, d=6, seed=1)
    kw = dict(knn="pruned", device="cpu")
    off = ht.compute_lisi(X, meta, ["batch"], **kw)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = ht.compute_lisi(X, meta, ["batch"], **kw)
    r = _ranges(prof)
    assert "lisi::scan" in r and "lisi::brute" not in r   # the pruned path
    assert np.array_equal(on, off)
    assert len(r["sync::lisi_result"]) == 1
    assert len(r["sync::lisi_fallback"]) == 1
    assert _inside(r["sync::lisi_scan"], r["lisi::scan"]).all()
    assert _inside(r["sync::lisi_index"], r["lisi::build_index"]).all()
