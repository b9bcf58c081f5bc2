"""matmul_precision in the port on the CPU.

On a card, "default" runs the fused E-step kernels' products as one bf16
pass and "float32" as 3xTF32; on the CPU both compute in fp32, as XLA
computes an f32 product in f32 on the CPU: the fits are bitwise equal, and
the deferred fit under "default" is held against the JAX package's at
"default". The one-pass variant's plain version (`one_pass=True` of
`block_core` / `block_stats`), which the card's checks hold the kernel
against, is held here against torch's bf16 rounding and a float64
reference of the same rounded operands; turned off, it is today's
`block_core` bit for bit. The one-pass bound follows the fp32 bound's
counts."""

import dataclasses

import numpy as np
import pandas as pd
import pytest
import torch

# Test workers share the CPU cores with each other and with JAX's own
# thread pool: one intra-op thread each keeps torch from oversubscribing.
torch.set_num_threads(1)

import jax

import harmonypy_tpu as hm
from harmonypy_tpu.ops.partition import partition_geometry, stripe_blocks
from harmonypy_tpu.parallel.mesh import make_mesh
import harmonypy_tpu_torch as ht
from harmonypy_tpu_torch.config import EngineConfig
from harmonypy_tpu_torch.ops.cuda import fused_estep as fe
from harmonypy_tpu_torch.ops.update_r_fused import (CLAMP, block_core,
                                                    block_stats,
                                                    diversity_weights,
                                                    round_bf16)
from harmonypy_tpu_torch.utils.profiling import (PEAK_BF16_FLOPS,
                                                 PEAK_BYTES_S, round_bound,
                                                 runs_one_pass)


def _problem(N=5000, d=10, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(6, d)) * 4
    g = rng.integers(0, 6, N)
    b = rng.integers(0, 3, N)
    shifts = rng.normal(size=(3, d)) * 2
    X = (centers[g] + shifts[b] + rng.normal(size=(N, d))).astype(np.float32)
    return X, pd.DataFrame({"batch": [f"b{i}" for i in b]})


HIST = ("objective_harmony", "objective_kmeans", "objective_kmeans_dist",
        "objective_kmeans_entropy", "objective_kmeans_cross")


@pytest.mark.parametrize("kw", [dict(chunk_size=128),
                                dict(chunk_size=128, defer_r=False),
                                dict()], ids=["deferred", "stored",
                                              "per_cell"])
def test_fits_bitwise_equal_under_both_precisions_on_cpu(kw):
    """The deferred, stored and per-cell fits on the CPU: "default" and
    "float32" give the same bits (Z_corr, R, every history, rounds)."""
    X, meta = _problem()
    fits = [ht.run_harmony(X, meta, ["batch"], device="cpu", verbose=False,
                           max_iter_harmony=2, matmul_precision=p, **kw)
            for p in ("default", "float32")]
    a, b = fits
    assert a.cfg.matmul_precision == "default"
    assert b.cfg.matmul_precision == "float32"
    assert a.cfg.fused_estep == bool(kw)
    assert a.cfg.defer_r == (kw.get("defer_r", True) and bool(kw))
    assert np.array_equal(a.Z_corr, b.Z_corr)
    assert np.array_equal(a.R, b.R)
    for h in HIST:
        assert np.array_equal(getattr(a, h), getattr(b, h)), h
    assert a.kmeans_rounds == b.kmeans_rounds


def test_default_deferred_fit_against_the_jax_package_at_default():
    """The deferred fit under "default" on the CPU against the JAX
    package's deferred fit at "default" (XLA's CPU f32 products), with its
    init centroids and partitions injected: tests/test_torch_fit.py's
    tolerances (objectives rtol 1e-4, Z_corr atol 1e-4)."""
    X, meta = _problem()
    ho_j = hm.run_harmony(X, meta, ["batch"], mesh=make_mesh(n_devices=1),
                          verbose=False, chunk_size=128, max_iter_harmony=1,
                          random_state=0, matmul_precision="default")
    assert ho_j.cfg.defer_r and ho_j.cfg.matmul_precision == "default"
    Y0 = np.array(ho_j._engine.init_fn(ho_j._data, ho_j._params,
                                       jax.random.PRNGKey(0)).Y)
    geom = partition_geometry(ho_j.cfg)
    key, _ = jax.random.split(jax.random.PRNGKey(0))
    blocks = []
    for _ in range(ho_j.cfg.max_iter_kmeans):
        key, k_r = jax.random.split(key)
        blocks.append(np.array(stripe_blocks(k_r, geom.NC_fixed, geom.L,
                                             geom.nb)))
    ho_t = ht.run_harmony(X, meta, ["batch"], device="cpu", verbose=False,
                          chunk_size=128, max_iter_harmony=1,
                          matmul_precision="default", _init_Y=Y0,
                          _blocks_fn=lambda i: blocks[i])
    assert ho_t.cfg.defer_r
    assert ho_t.kmeans_rounds == ho_j.kmeans_rounds
    np.testing.assert_allclose(ho_t.objective_kmeans, ho_j.objective_kmeans,
                               rtol=1e-4)
    np.testing.assert_allclose(ho_t.objective_harmony,
                               ho_j.objective_harmony, rtol=1e-4)
    np.testing.assert_allclose(ho_t.Z_corr, ho_j.Z_corr, atol=1e-4)


def test_round_bf16_equals_torch_on_ties_and_near_ties():
    """round_bf16 (the kernels' __float2bfloat16_rn, on the bits) equals
    torch's .to(torch.bfloat16) bitwise on exact ties (low 16 bits 0x8000,
    both parities of the kept part), on the values one ulp either side of
    a tie, on values already in bf16 and on random finite values of either
    sign, subnormals and the largest finite ones included."""
    rng = np.random.default_rng(0)
    hi = rng.integers(0, 0x7F7F, 4000, dtype=np.int64)     # finite, >= 0
    hi = np.concatenate([hi, [0, 1, 2, 3, 0x7F7E, 0x007F, 0x0080, 0x3F80]])
    low = np.array([0x8000, 0x7FFF, 0x8001, 0x0000, 0xFFFF, 0x0001],
                   dtype=np.int64)
    bits = (hi[:, None] << 16 | low[None, :]).ravel()
    bits = np.concatenate([bits, bits | (1 << 31),
                           rng.integers(0, 0x7F7FFFFF, 4000)])
    x = torch.from_numpy(bits.astype(np.uint32).view(np.float32))
    assert torch.isfinite(x).all()
    want = x.to(torch.bfloat16).to(torch.float32)
    got = round_bf16(x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # A tie rounds to the even kept part: up from an odd one, down from an
    # even one.
    tie_odd = torch.tensor([0x3F818000], dtype=torch.int32).view(
        torch.float32)
    tie_even = torch.tensor([0x3F808000], dtype=torch.int32).view(
        torch.float32)
    assert int(round_bf16(tie_odd).view(torch.int32)) == 0x3F820000
    assert int(round_bf16(tie_even).view(torch.int32)) == 0x3F800000


def _block_inputs(K=12, d=10, B=3, J=3, CH=128, seed=0):
    """One block's inputs: a slab of J + 1 chunks ([mask; one-hot Phi;
    unit-norm Z] per cell, the last chunk the all-zero dummy), unit-norm
    centroids, block-removed O, E > 0 and the block's cached stats."""
    rng = np.random.default_rng(seed)
    nc1 = J + 1
    Z = rng.normal(size=(nc1, d, CH))
    Z /= np.linalg.norm(Z, axis=1, keepdims=True)
    Phi = np.eye(B)[rng.integers(0, B, (nc1, CH))].transpose(0, 2, 1)
    ZP3 = np.concatenate([np.ones((nc1, 1, CH)), Phi, Z], axis=1)
    ZP3[-1] = 0.0
    Y = rng.normal(size=(d, K))
    Y /= np.linalg.norm(Y, axis=0, keepdims=True)
    O = rng.uniform(50, 150, (K, B))
    E = rng.uniform(50, 150, (K, B))
    rem = rng.uniform(0, 5, (K, B + 1))
    Pr_b = Phi[:-1].mean(axis=(0, 2))

    def t(x):
        return torch.tensor(np.asarray(x, np.float32))
    slots = torch.tensor(list(range(J)) + [nc1 - 1])
    return (t(O), t(E), t(rem), slots, t(ZP3), t(Y), t(np.full(K, 0.1)),
            t(np.full(B, 2.0)), t(Pr_b))


def _bf(x):
    return round_bf16(x).double().numpy()


def test_one_pass_products_against_float64_of_the_rounded_operands():
    """block_core / block_stats with one_pass=True against float64 numpy
    built from the same bf16-rounded operands (round_bf16 of Y, z, wdiv,
    the slab and r): the products of two bf16 values are exact in fp32, so
    what is left is the fp32 sums' rounding: dist within 1e-6 (|y^T z| <=
    1 over d = 10 terms, each sum rounded at ~6e-8), r within rtol 1e-4,
    atol 1e-6 (dist's error over sigma = 0.1, through the softmax), the
    stats within rtol 1e-5, atol 1e-5 (128-cell sums). The one-pass
    results differ from the fp32 ones: the operands are rounded."""
    args = _block_inputs()
    O, E, rem, slots, ZP3, Y, sigma, theta, Pr_b = args
    Ob, Eb, r, g, dist, logratio, _ = block_core(*args, one_pass=True)
    _, wdiv = diversity_weights(Ob, Eb, theta)
    B1 = theta.shape[0] + 1
    g64 = _bf(g)
    dist64 = 2.0 * (1.0 - np.einsum("xk,jxc->jkc", _bf(Y), g64[:, B1:]))
    np.testing.assert_allclose(dist.double().numpy(), dist64, rtol=0,
                               atol=1e-6)
    s = np.exp(-dist64 / sigma.double().numpy()[None, :, None])
    w = np.einsum("kb,jbc->jkc", _bf(wdiv), g64[:, 1:B1])
    r64 = s / s.sum(axis=1, keepdims=True) * w
    r64 /= np.maximum(r64.sum(axis=1, keepdims=True), CLAMP)
    np.testing.assert_allclose(r.double().numpy(), r64, rtol=1e-4,
                               atol=1e-6)
    stats, yk = block_stats(r, g, B1, one_pass=True)
    S64 = np.einsum("jkc,jxc->jkx", _bf(r), g64)
    np.testing.assert_allclose(stats.double().numpy(), S64[:, :, :B1],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(yk.double().numpy(), S64[:, :, B1:],
                               rtol=1e-5, atol=1e-5)
    f32 = block_core(*args)
    assert not torch.equal(f32[4], dist) and not torch.equal(f32[2], r)
    assert not torch.equal(block_stats(r, g, B1)[1], yk)


def test_one_pass_off_is_todays_block_core_bitwise():
    """block_core and block_stats with one_pass=False compute exactly the
    fp32 formulas they computed before the one-pass variant existed
    (written out here), bit for bit."""
    args = _block_inputs(seed=3)
    O, E, rem_b, slots_b, ZP3, Y, sigma, theta, Pr_b = args
    got = block_core(*args, one_pass=False)
    E = E - rem_b[:, 0:1] * Pr_b[None, :]
    O = O - rem_b[:, 1:]
    logratio, wdiv = diversity_weights(O, E, theta)
    B1 = 1 + theta.shape[0]
    g = ZP3[slots_b]
    pb, zb = g[:, 1:B1, :], g[:, B1:, :]
    J = zb.shape[0]
    dist = 2.0 * (1.0 - torch.bmm(Y.T.expand(J, -1, -1), zb))
    s = torch.exp(-dist / sigma[None, :, None])
    den = torch.sum(s, dim=1, keepdim=True)
    r = (s / den) * torch.bmm(wdiv.expand(J, -1, -1), pb)
    den_r = torch.clamp_min(torch.sum(r, dim=1, keepdim=True), CLAMP)
    r = r / den_r
    logdd = (torch.log(den) + torch.log(den_r))[:, 0, :]
    for a, b in zip(got, (O, E, r, g, dist, logratio, logdd)):
        assert torch.equal(a, b)
    S = torch.einsum("jkc,jxc->jkx", r, g)
    stats, yk = block_stats(r, g, B1, one_pass=False)
    assert torch.equal(stats, S[:, :, :B1]) and torch.equal(yk, S[:, :, B1:])


def test_cpu_wrappers_compute_fp32_under_either_precision():
    """fused_estep and fused_estep_r on CPU tensors run the plain fp32
    version under "default" and "float32" alike (bitwise), and refuse any
    other precision."""
    args = _block_inputs(J=3)
    O, E, rem, slots, ZP3, Y, sigma, theta, Pr_b = args
    tabs = (slots[None, :].to(torch.int32), rem[None])
    common = (*tabs, ZP3, Y, sigma, theta, Pr_b, O, E)
    a = fe.fused_estep(*common, False, 0, 2, precision="default")
    b = fe.fused_estep(*common, False, 0, 2, precision="float32")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    R3s = [torch.zeros((ZP3.shape[0], Y.shape[1], ZP3.shape[2]))
           for _ in range(2)]
    a = fe.fused_estep_r(*tabs, ZP3, R3s[0], *common[3:], True,
                         precision="default")
    b = fe.fused_estep_r(*tabs, ZP3, R3s[1], *common[3:], True,
                         precision="float32")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="precision"):
        fe.fused_estep(*common, False, precision="highest")
    with pytest.raises(ValueError, match="precision"):
        fe.one_pass("bfloat16")


def test_one_pass_round_bound_follows_the_fp32_counts():
    """round_bound(one_pass=True) counts the fp32 bound's operations and
    bytes and takes the operations at the dense bf16 tensor-core rate: at
    858k x 29, K = 100, B = 3, chunk 2048, 11.15 GFLOP in 0.0113 ms under
    the 118.8 MB's 0.0355 ms, so bytes bound it; with K2's fp32 r store
    too. The variant a fit runs: one pass only for "default" on a card."""
    cfg = EngineConfig(N=858_000, d=29, K=100, B=3, n_devices=1,
                       use_fused_xla=True, defer_r=True, chunk_size=2048)
    for r_bytes in (0, 2, 4):
        f32 = round_bound(cfg, r_bytes)
        one = round_bound(cfg, r_bytes, one_pass=True)
        assert one["flop"] == f32["flop"] and one["bytes"] == f32["bytes"]
        assert one["bytes_ms"] == f32["bytes_ms"]
        assert one["ops_ms"] == one["ops_tc_ms"] == pytest.approx(
            f32["flop"] / PEAK_BF16_FLOPS * 1e3, rel=1e-12)
        assert one["bound_by"] == "bytes"
        assert one["bound_ms"] == one["bound_tc_ms"] == one["bytes_ms"]
        assert one["bytes_ms"] == pytest.approx(
            f32["bytes"] / PEAK_BYTES_S * 1e3, rel=1e-12)
    one = round_bound(cfg, one_pass=True)
    assert f"{one['ops_ms']:.3g}" == "0.0113"
    assert f"{one['bound_ms']:.3g}" == "0.0355"
    assert runs_one_pass(cfg, "cuda:0") and not runs_one_pass(cfg, "cpu")
    assert not runs_one_pass(
        dataclasses.replace(cfg, matmul_precision="float32"), "cuda")
