"""The codes plan of the one-launch round's wide plan, on the CPU.

A fit of one covariate whose shape takes the kernel's wide plan passes
each cell's batch level (ops/replay.round_codes) to every round, replay
and stored round; the card's kernel then reads the codes instead of the
B design rows (csrc/fused_estep.cuh layout_codes, the same bits), and the
CPU's plain round reads the design rows and ignores them. Here:

  - the codes equal the slab's window_levels less one, -1 on padding
    cells, with a level no cell holds;
  - the plan choice (ops/cuda/fused_estep.codes_plan, engine.fit_codes):
    the codes plan only where the wide plan holds, the codes plan fits a
    CTA's shared memory and the design has one covariate; a two-covariate
    wide design, or one whose codes plan does not fit, keeps the dense
    wide plan;
  - plan_floats, the layouts' sizes as the library gives them;
  - the fit hands the codes to every K1 round, every replay and every K2
    round, and its bits do not move;
  - utils/memory.py's model of the codes plan's scratch."""

import dataclasses

import numpy as np
import pandas as pd
import pytest
import torch

# Test workers share the CPU cores: one intra-op thread each.
torch.set_num_threads(1)

import harmonypy_tpu_torch as ht
from harmonypy_tpu_torch import engine
from harmonypy_tpu_torch.config import EngineConfig
from harmonypy_tpu_torch.ops import replay
from harmonypy_tpu_torch.ops.cuda import fused_estep as fe
from harmonypy_tpu_torch.ops.partition import partition_geometry
from harmonypy_tpu_torch.ops.update_r_fused import make_zp3
from harmonypy_tpu_torch.state import HarmonyData
from harmonypy_tpu_torch.utils import memory

N, D, K, B, UNUSED, CH = 9_000, 8, 12, 70, 33, 256
SEED = 2 ** 31 + 11
CUDA = torch.device("cuda")


def _design(n=N, b=B, unused=UNUSED, seed=3):
    """(cfg, Phi, mask, levels) of one covariate of b levels (level
    `unused` in no cell) over n cells, padded to the fused layout."""
    rng = np.random.default_rng(seed)
    lev = rng.integers(0, b - 1, n)
    lev[lev >= unused] += 1
    cfg = EngineConfig(N=n, d=D, K=K, B=b, n_devices=1, use_fused_xla=True,
                       defer_r=True, chunk_size=CH)
    n_pad = cfg.N_local
    Phi = torch.zeros((b, n_pad))
    Phi[torch.as_tensor(lev), torch.arange(n)] = 1.0
    mask = (torch.arange(n_pad) < n).float()
    return cfg, Phi, mask, lev


def test_codes_are_the_slabs_levels_less_one():
    """round_codes is (nc1, CH) int32, chunk-major as the slab: each real
    cell's level and -1 on padding, equal to window_levels of the slab's
    design rows less one; the unused level appears nowhere."""
    cfg, Phi, mask, lev = _design()
    geom = partition_geometry(cfg)
    codes = replay.round_codes(Phi, mask, cfg)
    assert codes.dtype == torch.int32 and codes.is_contiguous()
    assert tuple(codes.shape) == (geom.nc_cap + 1, geom.CH)
    Z = torch.randn((D, cfg.N_local))
    ZP3 = make_zp3(Z, Phi, mask, cfg)
    want = replay.window_levels(ZP3[:, :cfg.B1]) - 1
    assert torch.equal(codes.long(), want)
    flat = codes.reshape(-1)
    assert torch.equal(flat[:N], torch.as_tensor(lev, dtype=torch.int32))
    assert bool((flat[N:] == -1).all()) and int((flat == -1).sum()) > 0
    assert not bool((flat == UNUSED).any())


@pytest.mark.parametrize("precision", ["default", "float32"])
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("n_covariates", [1, 2])
def test_the_codes_plan_needs_the_wide_plan_and_one_covariate(
        monkeypatch, precision, wide, n_covariates):
    """codes_plan holds exactly where wide_plan does (asked for the
    precision's variant) and the design has one covariate; fit_codes
    returns the codes there, on one card of the fused path, else None."""
    asked = []

    def wide_plan(k, b, d, one):
        asked.append((k, b, d, one))
        return wide

    monkeypatch.setattr(fe, "wide_plan", wide_plan)
    monkeypatch.setattr(fe, "codes_fit", lambda k, b, d, one: True)
    monkeypatch.setattr(engine, "_devices", lambda data: [CUDA])
    cfg, Phi, mask, _ = _design()
    cfg = dataclasses.replace(cfg, n_covariates=n_covariates,
                              matmul_precision=precision)
    want = wide and n_covariates == 1
    assert fe.codes_plan(K, B, D, precision, n_covariates) == want
    if n_covariates == 1:
        assert asked[-1] == (K, B, D, precision == "default")
    data = HarmonyData(Z_orig=torch.zeros((D, cfg.N_local)), Phi=Phi,
                       mask=mask)
    codes = engine.fit_codes(data, cfg)
    if want:
        assert torch.equal(codes, replay.round_codes(Phi, mask, cfg))
    else:
        assert codes is None
    # Never on a mesh or off the fused path, whatever the shape.
    for other in (dataclasses.replace(cfg, n_devices=2),
                  dataclasses.replace(cfg, use_fused_xla=False,
                                      defer_r=False)):
        assert engine.fit_codes(data, other) is None


def test_no_codes_off_the_card():
    """On the CPU the fit passes no codes (the plain round reads the design
    rows): fit_codes asks nothing of the kernel library."""
    cfg, Phi, mask, _ = _design()
    data = HarmonyData(Z_orig=torch.zeros((D, cfg.N_local)), Phi=Phi,
                       mask=mask)
    assert engine.fit_codes(data, cfg) is None


# The library's sizes in floats (shared memory of the plan with O, E,
# wdiv and S in it, of the dense wide plan and of the codes plan; the
# codes plan's scratch per CTA) as an H100 build of csrc/fused_estep.cu
# and fused_estep_one.cu reported them, at d = 50, K = 100.
LIB_SIZES = {
    (49, "default"): (57768, None, None, None),
    (49, "float32"): (63144, 23136, 37000, 5488),
    (64, "default"): (62752, 20992, 33508, 7168),
    (64, "float32"): (67936, 23136, 38692, 7168),
    (128, "default"): (95008, 25344, 37156, 14336),
    (128, "float32"): (103776, 27488, 45924, 14336),
    (486, "default"): (280464, 50912, 57564, 54432),
    (486, "float32"): (310032, 53600, 31948, 108864),
}


@pytest.mark.parametrize("b,precision", sorted(LIB_SIZES))
def test_plan_floats_are_the_librarys_sizes(b, precision):
    """plan_floats, the memory model's copy of csrc/fused_estep.cuh's
    layouts, gives the sizes the card's library reported (chip_smoke.py
    checks every shape it runs against the library there)."""
    p = fe.plan_floats(100, b, 50, precision == "default")
    narrow, wide, codes, scratch = LIB_SIZES[b, precision]
    assert p["narrow"] == narrow
    if wide is not None:
        assert (p["wide"], p["codes"], p["codes_scratch"]) == (
            wide, codes, scratch)


class _SizedLib:
    """The round library's size entries, from plan_floats."""

    def __init__(self, one):
        self.one = one

    def _p(self, K, B, d):
        return fe.plan_floats(K, B, d, self.one)

    def fused_estep_smem_limit(self):
        return fe.MAX_SMEM

    def fused_estep_smem(self, K, B, d):
        return 4 * self._p(K, B, d)["narrow"]

    def fused_estep_smem_wide(self, K, B, d):
        return 4 * self._p(K, B, d)["wide"]

    def fused_estep_smem_codes(self, K, B, d):
        return 4 * self._p(K, B, d)["codes"]


# (K, B, d, precision, the plan a one-covariate fit's rounds take).
PLAN_CASES = [
    (100, 3, 50, "default", "narrow"),
    (100, 49, 50, "default", "narrow"),
    (100, 49, 50, "float32", "codes"),
    (100, 486, 50, "default", "codes"),
    (100, 486, 50, "float32", "codes"),
    (300, 128, 50, "default", "wide"),
    (300, 128, 50, "float32", "wide"),
    (100, 128, 112, "float32", "codes"),
    (100, 64, 128, "default", "codes"),
    (100, 64, 128, "float32", "wide"),
]


@pytest.mark.parametrize("K,b,d,precision,plan", PLAN_CASES)
def test_the_plan_follows_the_layout_sizes(monkeypatch, K, b, d, precision,
                                           plan):
    """codes_plan from the layouts' sizes: the codes plan where the wide
    plan holds and the codes plan fits a CTA's shared memory; the dense
    wide plan where only it fits (K = 300 at B = 128, and d = 128 under
    "float32": S's dense [mask; Z] accumulator and two ring stages do not
    fit beside them); the
    memory model (codes_plan_holds, the codes' bytes) agrees, and a round
    handed codes where they do not fit raises before any launch."""
    monkeypatch.setattr(fe, "_kernel_lib", _SizedLib)
    one = precision == "default"
    assert fe.wide_plan(K, b, d, one) == (plan != "narrow")
    assert fe.codes_plan(K, b, d, precision, 1) == (plan == "codes")
    assert not fe.codes_plan(K, b, d, precision, 2)
    cfg = EngineConfig(N=50_000, d=d, K=K, B=b, n_devices=1,
                       use_fused_xla=True, defer_r=True,
                       matmul_precision=precision)
    assert memory.codes_plan_holds(cfg) == (plan == "codes")
    env = memory.memory_envelope(cfg)
    assert ("batch codes" in env["persistent"]) == (plan == "codes")
    if plan == "wide":
        assert not fe.codes_fit(K, b, d, one)
        args = _round_args(K, b, d)
        with pytest.raises(ValueError, match="codes plan"):
            fe._launch("fused_estep_round", [], *args, False, one,
                       codes=torch.zeros((3, CH), dtype=torch.int32))


def _round_args(K, b, d):
    """Round inputs of (K, b, d) shapes over two chunks of CH cells, on
    the CPU, for the wrapper's checks before a launch."""
    nc1 = 3
    return (torch.zeros((1, 2), dtype=torch.int32),
            torch.zeros((1, K, b + 1)), torch.zeros((nc1, 1 + b + d, CH)),
            torch.zeros((d, K)), torch.ones(K), torch.ones(b),
            torch.ones(b) / b, torch.zeros((K, b)), torch.zeros((K, 1)))


def _data(n_cov):
    rng = np.random.default_rng(7)
    groups = rng.integers(0, 6, N)
    X = (rng.normal(size=(6, D))[groups] * 5.0
         + rng.normal(size=(N, D))).astype(np.float32)
    if n_cov == 1:
        lev = rng.integers(0, B - 1, N)
        lev[lev >= UNUSED] += 1
        X += rng.normal(size=(B, D))[lev].astype(np.float32)
        meta = pd.DataFrame({"batch": pd.Categorical.from_codes(
            lev, categories=[f"b{i}" for i in range(B)])})
    else:
        meta = pd.DataFrame({"a": pd.Categorical(rng.integers(0, 40, N)),
                             "b": pd.Categorical(rng.integers(0, 30, N))})
    return X, meta


def _fit(X, meta, **kw):
    return ht.run_harmony(X, meta, list(meta.columns), nclust=K,
                          random_state=SEED, max_iter_harmony=2,
                          max_iter_kmeans=3, epsilon_cluster=0.0,
                          epsilon_harmony=-np.inf, device="cpu",
                          verbose=False, chunk_size=CH, **kw)


@pytest.mark.parametrize("defer_r", [True, False], ids=["deferred", "stored"])
def test_the_fit_hands_its_codes_to_every_round_and_replay(monkeypatch,
                                                           defer_r):
    """With the codes plan chosen (fit_codes as on a card), every K1 round,
    every r-window replay of the ridge and of .R, and every K2 round gets
    the fit's codes; the CPU's plain round ignores them, so the fit's
    Z_corr and R are the fit's without them bit for bit."""
    X, meta = _data(1)
    plain = _fit(X, meta, defer_r=defer_r)
    plain_R = plain.R
    made = []

    def fit_codes(data, cfg):
        made.append(cfg)
        return replay.round_codes(data.Phi, data.mask, cfg)

    seen = []

    def record(fn, kind):
        def run(*args, **kw):
            seen.append((kind, kw.get("codes")))
            return fn(*args, **kw)
        return run

    monkeypatch.setattr(engine, "fit_codes", fit_codes)
    monkeypatch.setattr(engine, "fused_estep",
                        record(fe.fused_estep, "k1"))
    monkeypatch.setattr(replay, "fused_estep",
                        record(fe.fused_estep, "replay"))
    monkeypatch.setattr(engine, "fused_estep_r",
                        record(fe.fused_estep_r, "k2"))
    ho = _fit(X, meta, defer_r=defer_r)
    R = ho.R
    assert made and all(c.n_covariates == 1 for c in made)
    want = replay.round_codes(*_phi_mask(ho))
    kinds = {k for k, _ in seen}
    assert kinds == ({"k1", "replay"} if defer_r else {"k2"})
    for kind, codes in seen:
        assert codes is not None and torch.equal(codes, want), kind
    if defer_r:
        # Each iteration's two ridge replays per window, and .R's.
        assert sum(k == "replay" for k, _ in seen) >= 2 * 2 + 1
    assert np.array_equal(ho.Z_corr, plain.Z_corr)
    assert np.array_equal(R, plain_R)


def _phi_mask(ho):
    return ho._data.Phi, ho._data.mask, ho.cfg


def test_a_two_covariate_wide_design_keeps_the_dense_plan(monkeypatch):
    """Two covariates of 40 and 30 levels (B = 70): the fit's config counts
    two, and with the shape in the wide plan codes_plan still says no, so
    no round gets codes."""
    monkeypatch.setattr(fe, "wide_plan", lambda k, b, d, one: True)
    X, meta = _data(2)
    seen = []

    def run(*args, **kw):
        seen.append(kw.get("codes"))
        return fe.fused_estep(*args, **kw)

    monkeypatch.setattr(engine, "fused_estep", run)
    monkeypatch.setattr(fe, "codes_fit", lambda k, b, d, one: True)
    monkeypatch.setattr(engine, "fit_codes", lambda data, cfg: (
        replay.round_codes(data.Phi, data.mask, cfg)
        if fe.codes_plan(cfg.K, cfg.B, cfg.d, cfg.matmul_precision,
                         cfg.n_covariates) else None))
    ho = _fit(X, meta)
    assert ho.cfg.B == 70 and ho.cfg.n_covariates == 2
    assert seen and all(c is None for c in seen)


def test_codes_are_checked_beside_the_slab():
    """fused_estep takes codes of the slab's (nc1, CH) in int32 only."""
    cfg, Phi, mask, _ = _design()
    ZP3 = make_zp3(torch.randn((D, cfg.N_local)), Phi, mask, cfg)
    codes = replay.round_codes(Phi, mask, cfg)
    fe._check_codes(codes, ZP3)
    fe._check_codes(None, ZP3)
    with pytest.raises(TypeError):
        fe._check_codes(codes.long(), ZP3)
    with pytest.raises(ValueError):
        fe._check_codes(codes[1:], ZP3)


def test_memory_model_of_the_codes_scratch(monkeypatch):
    """A one-covariate design is modelled with the codes plan's scratch
    as _launch allocates it, gtotal floats (layout_codes: S's design
    columns, (B, K padded to 16)) for each of 132 CTAs plus the gshared
    floats they share (O', E' and the bf16 table of wdiv by block parity),
    and with the batch codes, N_local int32, where the codes plan holds;
    two covariates with the dense wide plan's, 3 K (1 + B + d) + 2 K B a
    CTA. At the donors' shape the codes plan's scratch is the smaller, and
    the harmony iteration's working set holds the scratch as the model
    gives it. The narrow plan's one-covariate fits (B = 49, B = 3) hold no
    codes."""
    cfg = EngineConfig(N=2_400_000, d=50, K=100, B=486, n_devices=1,
                       use_fused_xla=True, defer_r=True)
    two = dataclasses.replace(cfg, n_covariates=2)
    codes, dense = (memory.wide_scratch_bytes(c) for c in (cfg, two))
    table = 486 * 112 // 2
    assert codes == (132 * 486 * 112 + 2 * (2 * 100 * 486 + table)) * 4
    assert dense == 132 * (3 * 100 * 537 + 2 * 100 * 486) * 4
    assert codes < dense
    for c, scratch in ((cfg, codes), (two, dense)):
        env = memory.memory_envelope(c)
        assert ("batch codes" in env["persistent"]) == (c is cfg)
        with monkeypatch.context() as mp:
            mp.setattr(memory, "wide_scratch_bytes", lambda c: 0)
            bare = memory.memory_envelope(c)
        assert (env["phases"]["harmony iteration"]
                - bare["phases"]["harmony iteration"]) == scratch
    assert memory.memory_envelope(cfg)["persistent"]["batch codes"] == (
        cfg.N_local * 4)
    for b in (49, 3):
        narrow = dataclasses.replace(cfg, B=b)
        assert not memory.codes_plan_holds(narrow)
        assert "batch codes" not in memory.memory_envelope(
            narrow)["persistent"]
    # On a mesh no shard holds codes.
    mesh = memory.memory_envelope(dataclasses.replace(cfg, n_devices=4), 1)
    assert "batch codes" not in mesh["persistent"]
