"""matmul_precision="default" over the whole fit on the CPU: the torch
products outside the kernels (ops/products.py).

The JAX package computes every product of its init, its iterations and its
.R replay inside jax.default_matmul_precision (engine.py:175, 205, 611,
685): one bf16-input pass with fp32 accumulation on the TPU. The port does
the same on a card through `products.matmul` / `products.einsum` with
`one` set. Here:
  - the card's layouts (`einsum_bmm`) equal torch.einsum, in float64;
  - each ported product's plain one-pass version against float64 numpy of
    the bf16-rounded operands, at the fp32 summation bound;
  - with `one` off, the helpers and the functions built on them are
    today's ops bit for bit;
  - deferred, stored and per-cell pbmc fits with the plain one-pass
    products forced through engine.fit's `one_pass`: the golden gate,
    stored against deferred at tests/test_defer.py:62-76's tolerances, a
    bitwise repeat, and a fused fit on 1 and 4 CPU shards bitwise;
  - the JAX scopes lowered on the CPU: their dot_generals, site by site,
    against the port's table, and every port function of the table takes
    its products through the helper."""

import ast
import collections
import contextlib
import dataclasses
import inspect
import textwrap

import numpy as np
import pytest
import torch

# Test workers share the CPU cores with each other and with JAX's own
# thread pool: one intra-op thread each keeps torch from oversubscribing.
torch.set_num_threads(1)

import jax
from jax.extend import core as jcore

import harmonypy_tpu as hm
from harmonypy_tpu.engine import HarmonyEngine
from harmonypy_tpu.parallel.mesh import make_mesh as jax_mesh
import harmonypy_tpu_torch as ht
from harmonypy_tpu_torch import engine
from harmonypy_tpu_torch.config import EngineConfig
from harmonypy_tpu_torch.ops import kmeans, objective, replay, ridge
from harmonypy_tpu_torch.ops import update_r as update_r_mod
from harmonypy_tpu_torch.ops.products import (einsum, einsum_bmm, matmul,
                                              operand, round_bf16,
                                              runs_one_pass)
from harmonypy_tpu_torch.parallel.mesh import make_mesh

U = 2.0 ** -24      # fp32 unit roundoff

# Every einsum the port runs through products.einsum, with the operand
# shapes of its call site (small): init pass / replays / stored centroid
# numerator / ridge.
EINSUMS = {
    "dk,jdc->jkc": ((6, 7), (3, 6, 16)),          # init pass dist
    "jdc,jkc->jdk": ((3, 6, 16), (3, 7, 16)),     # ybuf, Sz, y_c
    "jfc,jkc->jfk": ((3, 16, 16), (3, 7, 16)),    # window Sa
    "kd,jkc->jdc": ((7, 6), (3, 7, 16)),          # window_apply
    "fjc,jkc->jfk": ((40, 3, 16), (3, 7, 16)),    # per-cell ridge S
    "jkc,kf->jcf": ((3, 7, 16), (7, 24)),         # per-cell ridge T
    "bjc,jcbd->djc": ((4, 3, 16), (3, 16, 4, 6)),  # per-cell ridge apply
}
# Every a @ b it runs through products.matmul: k-means (C^T X, c0 X,
# X w^T), per-cell dist, centroids, block stats, weights, objective.
MATMULS = [((5, 6), (6, 40)), ((6,), (6, 40)), ((6, 40), (40, 7)),
           ((7, 3), (3, 40))]


def _view(shape, rng, dtype=torch.float32):
    """A non-contiguous tensor of `shape` (a permuted copy's view), as call
    sites pass transposes and slices."""
    x = torch.tensor(rng.normal(size=shape[::-1]), dtype=dtype)
    return x.permute(*reversed(range(len(shape))))


def _contraction(eq):
    ins, out = eq.split("->")
    sa, sb = ins.split(",")
    return [c for c in sa if c in sb and c not in out]


@pytest.mark.parametrize("eq", sorted(EINSUMS))
def test_card_layout_equals_einsum(eq):
    """einsum_bmm, the card's bmm over explicit layouts (broadcast batch
    included), computes torch.einsum's function: float64, with torch.bmm
    in place of the card's out_dtype bmm, within 1e-12."""
    rng = np.random.default_rng(0)
    a, b = (_view(s, rng, torch.float64) for s in EINSUMS[eq])
    got = einsum_bmm(eq, a, b, torch.bmm)
    want = torch.einsum(eq, a, b)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-12)


def _gamma(n):
    """gamma_n = n u / (1 - n u): |fl(sum) - sum| <= gamma_n sum |terms| for
    fp32 sums of n exact terms in any order (each product of two bf16
    values is exact in fp32: 8 + 8 significant bits)."""
    return n * U / (1 - n * U)


@pytest.mark.parametrize("case", sorted(EINSUMS) + [
    f"mm{i}" for i in range(len(MATMULS))])
def test_one_pass_products_against_float64_of_the_rounded_operands(case):
    """The plain one-pass product (one on the CPU) against float64 of the
    same bf16-rounded operands: |got - ref| <= gamma_n (|A| |B|), n the
    contraction length, gamma_n = n u / (1 - n u), u = 2^-24 (the products
    are exact, the fp32 sums are not). It differs from the fp32 product:
    the operands were rounded."""
    rng = np.random.default_rng(1)
    if case.startswith("mm"):
        sa, sb = MATMULS[int(case[2:])]
        a, b = _view(sa, rng), _view(sb, rng)
        got = matmul(a, b, True)
        ra, rb = (round_bf16(x).double().numpy() for x in (a, b))
        want = ra @ rb
        mag = np.abs(ra) @ np.abs(rb)
        n, f32 = sa[-1], a @ b
    else:
        eq = case
        a, b = (_view(s, rng) for s in EINSUMS[eq])
        got = einsum(eq, a, b, True)
        ra, rb = (round_bf16(x).double().numpy() for x in (a, b))
        want = np.einsum(eq, ra, rb)
        mag = np.einsum(eq, np.abs(ra), np.abs(rb))
        sizes = dict(zip(eq.split("->")[0].replace(",", ""),
                         list(a.shape) + list(b.shape)))
        n = int(np.prod([sizes[c] for c in _contraction(eq)]))
        f32 = torch.einsum(eq, a, b)
    assert got.dtype == torch.float32
    err = np.abs(got.double().numpy() - want)
    assert np.all(err <= _gamma(n) * mag), err.max()
    assert not torch.equal(got, f32)


def _cfg(**kw):
    return EngineConfig(N=100, d=6, K=7, B=3, n_devices=1, **kw)


def test_helpers_off_are_todays_ops_bitwise():
    """With `one` off, matmul / einsum / operand are a @ b, torch.einsum
    and x itself, bit for bit."""
    rng = np.random.default_rng(2)
    for eq, shapes in EINSUMS.items():
        a, b = (_view(s, rng) for s in shapes)
        assert torch.equal(einsum(eq, a, b, False), torch.einsum(eq, a, b))
    for sa, sb in MATMULS:
        a, b = _view(sa, rng), _view(sb, rng)
        assert torch.equal(matmul(a, b, False), a @ b)
    x = _view((3, 4), rng)
    assert operand(x, False) is x
    assert torch.equal(operand(x, True), round_bf16(x))
    assert not runs_one_pass(_cfg(), "cpu")
    assert runs_one_pass(_cfg(), "cuda:0")
    assert not runs_one_pass(_cfg(matmul_precision="float32"), "cuda")


def test_ported_functions_off_are_todays_bitwise():
    """The ridge's window functions, the per-cell ridge products and the
    per-cell block stats with `one` off compute the fp32 formulas they
    computed before the helper existed (written out here), bit for bit;
    with `one` on they differ."""
    rng = np.random.default_rng(3)
    w, B1, d, K, CH = 3, 4, 6, 7, 16
    a = torch.tensor(rng.integers(0, 2, (w, B1, CH)), dtype=torch.float32)
    zo = _view((w, d, CH), rng)
    r = torch.tensor(rng.uniform(size=(w, K, CH)), dtype=torch.float32)
    W = torch.tensor(rng.normal(size=(K, B1, d)), dtype=torch.float32)

    Fa = (a[:, :, None, :] * a[:, None, :, :]).reshape(w, B1 * B1, -1)
    S = torch.cat([torch.einsum("jfc,jkc->jfk", Fa, r)]
                  + [torch.einsum("jdc,jkc->jdk", a[:, b, None, :] * zo, r)
                     for b in range(B1)], dim=1)
    assert torch.equal(replay.window_normal_eq(a, zo, r, False), S)
    assert not torch.equal(replay.window_normal_eq(a, zo, r, True), S)
    corr = a[:, 0, None, :] * torch.einsum("kd,jkc->jdc", W[:, 0, :], r)
    for b in range(1, B1):
        corr = corr + (a[:, b, None, :]
                       * torch.einsum("kd,jkc->jdc", W[:, b, :], r))
    assert torch.equal(replay.window_apply(a, zo, r, W, False), zo - corr)
    assert not torch.equal(replay.window_apply(a, zo, r, W, True), zo - corr)

    a3 = a.permute(1, 0, 2)                                  # (B1, j, c)
    z3 = zo.permute(1, 0, 2)
    F = torch.cat([(a3[:, None] * a3[None, :]).reshape(B1 * B1, w, CH),
                   (a3[:, None] * z3[None, :]).reshape(B1 * d, w, CH)])
    assert torch.equal(ridge._products(a3, z3, r, False),
                       torch.einsum("fjc,jkc->jfk", F, r))
    Wf = W.reshape(K, B1 * d)
    T = torch.einsum("jkc,kf->jcf", r, Wf).reshape(w, CH, B1, -1)
    assert torch.equal(ridge._correction(a3, r, Wf, False),
                       torch.einsum("bjc,jcbd->djc", a3, T))
    Rb, Phib = r[0], a[0, 1:]
    assert torch.equal(update_r_mod._stats(Rb, Phib, False),
                       torch.cat([torch.sum(Rb, dim=1)[:, None], Rb @ Phib.T],
                                 dim=1))


# ---- forced fits on pbmc ----------------------------------------------------

def _forced(pcs, meta, n_iter=10, mesh=None, **kw):
    """A CPU fit of pbmc through engine.fit with one_pass=True, the
    parameter run_harmony gives it on a card (runs_one_pass): the inputs and
    config run_harmony builds, then the fit. kw selects the path as
    run_harmony resolves it (chunk_size=128: deferred; with defer_r=False
    stored; neither: per-cell)."""
    defer = kw.pop("defer_r", None) is not False and "chunk_size" in kw
    ho = ht.run_harmony(pcs, meta, ["donor"], device="cpu", mesh=mesh,
                        verbose=False, max_iter_harmony=0, defer_r=False,
                        **kw)
    ho.cfg = dataclasses.replace(ho.cfg, max_iter_harmony=n_iter,
                                 defer_r=defer)
    gen = torch.Generator()
    gen.manual_seed(0)
    ho.state = engine.fit(ho._data, ho._params, ho.cfg, gen, one_pass=True)
    return ho


def _corrs(Z, harmonized):
    harm = harmonized
    if harm.iloc[:, 0].dtype == "object":
        harm = harm.iloc[:, 1:]
    return np.array([np.corrcoef(Z[:, i], harm.iloc[:, i].values)[0, 1]
                     for i in range(Z.shape[1])])


@pytest.fixture(scope="module")
def forced_fits(pbmc):
    meta, pcs, harmonized = pbmc
    fits = {"deferred": _forced(pcs, meta, chunk_size=128),
            "stored": _forced(pcs, meta, chunk_size=128, defer_r=False),
            "per_cell": _forced(pcs, meta)}
    return fits, harmonized


@pytest.mark.parametrize("path", ["deferred", "stored", "per_cell"])
def test_forced_one_pass_fit_passes_the_golden_gate(forced_fits, path):
    """tests/test_harmony_golden.py's gate (min per-PC r >= 0.99) with the
    plain one-pass products forced; the fit it ran is the path asked for."""
    fits, harmonized = forced_fits
    ho = fits[path]
    assert ho.cfg.defer_r == (path == "deferred")
    assert ho.cfg.fused_estep == (path != "per_cell")
    cors = _corrs(ho.Z_corr, harmonized)
    assert np.all(cors >= 0.99), cors
    obj = ho.objective_harmony
    assert obj[-1] < obj[0] and len(ho.kmeans_rounds) == len(obj) - 1


def test_forced_stored_matches_deferred(forced_fits):
    """The forced stored fit against the forced deferred fit at
    tests/test_defer.py:62-76's tolerances (Z_corr rtol/atol 2e-4, R rtol
    1e-3 atol 2e-5, objective_kmeans rtol 1e-5, the same rounds)."""
    fits, _ = forced_fits
    st, de = fits["stored"], fits["deferred"]
    np.testing.assert_allclose(st.Z_corr, de.Z_corr, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(st.R, de.R, rtol=1e-3, atol=2e-5)
    np.testing.assert_allclose(st.objective_kmeans, de.objective_kmeans,
                               rtol=1e-5)
    assert st.kmeans_rounds == de.kmeans_rounds


def _same(a, b):
    assert np.array_equal(a.Z_corr, b.Z_corr)
    assert np.array_equal(a.R, b.R)
    for h in ("objective_harmony", "objective_kmeans",
              "objective_kmeans_dist", "objective_kmeans_entropy",
              "objective_kmeans_cross", "kmeans_rounds"):
        assert getattr(a, h) == getattr(b, h), h


def test_forced_fit_repeats_and_is_bitwise_on_four_shards(pbmc):
    """The forced deferred fit (three iterations) twice on one device and
    once on make_mesh(["cpu"] * 4): the same bits each time (Z_corr, R,
    every history, rounds), and not the fp32 fit's."""
    meta, pcs, _ = pbmc
    one = _forced(pcs, meta, n_iter=3, chunk_size=128)
    _same(one, _forced(pcs, meta, n_iter=3, chunk_size=128))
    _same(one, _forced(pcs, meta, n_iter=3, chunk_size=128,
                       mesh=make_mesh(["cpu"] * 4)))
    f32 = ht.run_harmony(pcs, meta, ["donor"], device="cpu", verbose=False,
                         chunk_size=128, max_iter_harmony=3)
    assert not np.array_equal(one.Z_corr, f32.Z_corr)


# Convergence tests that never pass (chip_smoke.PINNED): every k-means
# round and harmony iteration runs, so two fits take the same branches.
PINNED = dict(epsilon_cluster=0.0, epsilon_harmony=float("-inf"))


@contextlib.contextmanager
def _jax_one_pass_dots():
    """The JAX package's dots as its default precision runs them on the
    TPU, on the CPU: the f32 operands of every dot_general at DEFAULT
    precision rounded to bf16 (to nearest even), the product in f32; the
    HIGHEST ones (LISI, the kNN) untouched. Nothing in the package changes:
    the primitive's bind is wrapped while the block runs, and the compiled
    functions are dropped before and after it."""
    from jax import lax
    p = lax.dot_general_p
    bind = p.bind

    def one_pass(lhs, rhs, **params):
        prec = params.get("precision")
        default = prec is None or (isinstance(prec, tuple) and all(
            x in (None, lax.Precision.DEFAULT) for x in prec))
        if default and lhs.dtype == rhs.dtype == np.float32:
            lhs, rhs = (lax.reduce_precision(x, exponent_bits=8,
                                             mantissa_bits=7)
                        for x in (lhs, rhs))
        return bind(lhs, rhs, **params)

    jax.clear_caches()
    p.bind = one_pass
    try:
        yield
    finally:
        del p.bind
        jax.clear_caches()


def _jax_percell(pcs, meta, n_devices):
    ho = hm.run_harmony(pcs, meta, ["donor"], mesh=jax_mesh(
        n_devices=n_devices), verbose=False, max_iter_harmony=3, **PINNED)
    assert not ho.cfg.fused_estep
    return ho


def _percell_fits(pcs, meta, impl):
    """(fp32 on one shard, one pass on one shard, one pass on four) of the
    per-cell pbmc fit, 3 iterations, every round pinned."""
    if impl == "port":
        f32 = ht.run_harmony(pcs, meta, ["donor"], device="cpu",
                             verbose=False, max_iter_harmony=3, **PINNED)
        return (f32, _forced(pcs, meta, n_iter=3, **PINNED),
                _forced(pcs, meta, n_iter=3, mesh=make_mesh(["cpu"] * 4),
                        **PINNED))
    f32 = _jax_percell(pcs, meta, 1)
    with _jax_one_pass_dots():
        return f32, _jax_percell(pcs, meta, 1), _jax_percell(pcs, meta, 4)


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_pinned_percell_mesh_drift_within_the_one_pass_rounding(pbmc, impl):
    """chip_smoke's per-cell mesh gate under "default" (percell_flip_bound)
    on the CPU, for the port with its plain one-pass products forced and
    for the JAX package with its DEFAULT dots rounded as the TPU rounds
    them: with every round pinned, the fits on one and four shards run the
    same rounds, and the four-shard fit lies within max|Z_one_pass -
    Z_fp32| of the one-shard fit. The mesh changes its shard sums' last
    bits only; the bf16 operand roundings those flip move the fit less
    than rounding every operand does."""
    meta, pcs, _ = pbmc
    f32, one, four = _percell_fits(pcs, meta, impl)
    assert one.kmeans_rounds == four.kmeans_rounds == [20] * 3
    bound = float(np.abs(one.Z_corr - f32.Z_corr).max())
    assert bound > 0.0                      # the one-pass products ran
    drift = float(np.abs(four.Z_corr - one.Z_corr).max())
    assert drift <= bound, (drift, bound)
    # The fp32 fits' tolerance (tests/test_fused_xla.py:135-150) does not
    # hold here, for the JAX package either: why the card's gate under
    # "default" is the rounding's effect.
    scale = float(np.abs(one.Z_corr).max())
    assert drift > 5e-4 * scale, (drift, scale)
    print(f"{impl}: drift {drift}, bound {bound}, max|Z| {scale}")


# ---- the JAX scopes' products against the port's table ------------------

# JAX package site (first frame in harmonypy_tpu/) -> the port function
# that computes it through products.matmul / einsum, or "kernel" for the
# E-step's products inside K1 / K2 (their one-pass instantiations).
PORT = {
    "ops/kmeans.py:78": kmeans._first,
    "ops/kmeans.py:88": kmeans._greedy,
    "ops/kmeans.py:117": kmeans.kmeansbb_seed,
    "ops/kmeans.py:164": kmeans.kmeansbb_seed,
    "ops/kmeans.py:185": kmeans._first,
    "ops/kmeans.py:197": kmeans._greedy,
    "ops/kmeans.py:219": kmeans.lloyd,
    "ops/kmeans.py:227": kmeans.lloyd,
    "engine.py:221": engine.init_stored,          # fused: _init_pass
    "engine.py:257": engine.init_stored,
    "engine.py:303": engine._init_pass,
    "engine.py:310": engine._init_pass,
    "engine.py:360": engine.cluster_percell,
    "engine.py:362": engine.cluster_percell,
    "engine.py:488": engine.cluster_fused,
    "ops/objective.py:108": objective.compute_objective_terms,
    "ops/update_r.py:106": update_r_mod._stats,
    "ops/update_r.py:110": update_r_mod.update_r,
    "ops/update_r.py:123": update_r_mod._stats,
    "ops/ridge.py:60": replay.window_normal_eq,   # via ridge._fused_shard
    "ops/ridge.py:132": ridge._products,
    "ops/ridge.py:143": ridge._correction,        # fused: window_apply
    "ops/ridge.py:145": ridge._correction,
    "ops/update_r_fused_xla.py:271": replay.window_normal_eq,
    "ops/update_r_fused_xla.py:276": replay.window_normal_eq,
    "ops/update_r_fused_xla.py:319": replay.window_apply,
    "ops/update_r_fused_xla.py:322": replay.window_apply,
    "ops/update_r_fused_xla.py:328": replay.replay_apply,
    "ops/update_r_fused_xla.py:85": "kernel",
    "ops/update_r_fused_xla.py:89": "kernel",
    "ops/update_r_fused_xla.py:100": "kernel",
}
K1 = ["ops/update_r_fused_xla.py:85", "ops/update_r_fused_xla.py:89",
      "ops/update_r_fused_xla.py:100"]
KM_FULL = ["ops/kmeans.py:78", "ops/kmeans.py:88", "ops/kmeans.py:219",
           "ops/kmeans.py:227"]
KM_SAMPLE = ["ops/kmeans.py:117", "ops/kmeans.py:117", "ops/kmeans.py:164",
             "ops/kmeans.py:185", "ops/kmeans.py:197", "ops/kmeans.py:219",
             "ops/kmeans.py:227"]
RIDGE = ["ops/ridge.py:143", "ops/ridge.py:145"]
B1 = 4
# Each scope's dot_generals at B = 3 (so B1 = 4 design rows).
SCOPES = {
    ("deferred", "init"): ["engine.py:303", "engine.py:310"],
    ("deferred", "iter"): 3 * K1 + [
        "ops/update_r_fused_xla.py:271"]
        + B1 * ["ops/update_r_fused_xla.py:276"]
        + ["ops/update_r_fused_xla.py:319"]
        + (B1 - 1) * ["ops/update_r_fused_xla.py:322"]
        + ["ops/update_r_fused_xla.py:328"],
    ("deferred", "R"): K1,
    ("stored", "init"): ["engine.py:221"],
    ("stored", "iter"): ["engine.py:488"] + K1 + ["ops/ridge.py:60"] + RIDGE,
    ("per_cell", "init"): ["engine.py:221", "engine.py:257",
                           "ops/objective.py:108"],
    ("per_cell", "iter"): [
        "engine.py:360", "engine.py:362", "ops/update_r.py:106",
        "ops/update_r.py:110", "ops/update_r.py:123", "ops/objective.py:108",
        "ops/ridge.py:132"] + RIDGE,
}


def _subjaxprs(eqn):
    for v in eqn.params.values():
        for x in (v if isinstance(v, (list, tuple)) else [v]):
            if isinstance(x, jcore.ClosedJaxpr):
                yield x.jaxpr
            elif isinstance(x, jcore.Jaxpr):
                yield x


def _dots(jaxpr, out):
    """(site, precision) of every dot_general in jaxpr and its sub-jaxprs:
    the first frame of its traceback in the JAX package."""
    for e in jaxpr.eqns:
        if e.primitive.name == "dot_general":
            frames = [f"{f.file_name.split('harmonypy_tpu/')[-1]}:"
                      f"{f.line_num}"
                      for f in e.source_info.traceback.frames
                      if "/harmonypy_tpu/" in f.file_name]
            out.append((frames[0], e.params["precision"]))
        for j in _subjaxprs(e):
            _dots(j, out)
    return out


def _scope_dots():
    """The dot_generals of each lowered scope of a tiny JAX fit under
    matmul_precision="default": init (k-means++ on all cells and k-means||
    on a sample), one iteration, and the .R window replay."""
    rng = np.random.default_rng(0)
    import pandas as pd
    mesh = jax_mesh(n_devices=1)
    found = {}
    for path, kw, N in (("deferred", dict(chunk_size=128), 3000),
                        ("stored", dict(chunk_size=128), 3000),
                        ("per_cell", {}, 1500)):
        X = rng.normal(size=(N, 10)).astype(np.float32)
        meta = pd.DataFrame({"batch": [f"b{i}" for i in
                                       rng.integers(0, 3, N)]})
        ho = hm.run_harmony(X, meta, ["batch"], mesh=mesh, verbose=False,
                            max_iter_harmony=0, defer_r=False, **kw)
        cfg = dataclasses.replace(ho.cfg, max_iter_harmony=1,
                                  defer_r=path == "deferred",
                                  matmul_precision="default")
        key = jax.random.PRNGKey(0)
        for sample in (cfg.kmeanspp_sample, 512):
            eng = HarmonyEngine(dataclasses.replace(
                cfg, kmeanspp_sample=sample), mesh)
            km = KM_FULL if sample >= N else KM_SAMPLE
            found[(path, "init", sample < N)] = (km, _dots(jax.make_jaxpr(
                eng.init_fn)(ho._data, ho._params, key).jaxpr, []))
        st = jax.eval_shape(eng.init_fn, ho._data, ho._params, key)
        found[(path, "iter")] = ([], _dots(jax.make_jaxpr(eng.iter_fn)(
            st, ho._data, ho._params).jaxpr, []))
        if path == "deferred":
            found[(path, "R")] = ([], _dots(jax.make_jaxpr(
                eng.r_window_fn(2))(st, ho._data, ho._params, 0).jaxpr, []))
    return found


def test_jax_scopes_products_against_the_port_table():
    """Lowered on the CPU at matmul_precision="default", each JAX scope's
    dot_generals (all at DEFAULT precision) are exactly the sites of
    SCOPES, each once per product, so a product the JAX package adds
    later fails here until it is in the table; every site has a port
    counterpart in PORT."""
    for key, (km, dots) in _scope_dots().items():
        want = km + SCOPES[key[:2]]
        assert all(p == (jax.lax.Precision.DEFAULT,) * 2
                   for _, p in dots), (key, dots)
        got = collections.Counter(site for site, _ in dots)
        assert got == collections.Counter(want), key
        assert all(site in PORT for site in got), key


def _calls(fn):
    """(helper calls, raw products) in fn's body: calls of matmul / einsum
    and whether their last argument is `one`; `@` and torch.einsum."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    helper, raw = [], 0
    for node in ast.walk(tree):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
            raw += 1
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name) and f.id in ("matmul", "einsum"):
                last = node.args[-1]
                helper.append(isinstance(last, ast.Name)
                              and last.id == "one")
            if (isinstance(f, ast.Attribute) and f.attr == "einsum"
                    and isinstance(f.value, ast.Name)
                    and f.value.id == "torch"):
                raw += 1
    return helper, raw


@pytest.mark.parametrize("fn", sorted(
    {f for f in PORT.values() if f != "kernel"},
    key=lambda f: f.__module__ + f.__name__),
    ids=lambda f: f"{f.__module__.split('.')[-1]}.{f.__name__}")
def test_port_table_functions_take_products_through_the_helper(fn):
    """Every port function of the table computes its products through
    products.matmul / einsum with its `one`, and none with a raw `@` or
    torch.einsum."""
    helper, raw = _calls(fn)
    assert helper and all(helper), (fn, helper)
    assert raw == 0, fn
