"""The port's stored-R fused path on the CPU: the write-R round (plain
version of the kernel K2) against the JAX package's Pallas kernel with
write_r=True in interpret mode, in fp32 and bf16; the stored-R and
low_memory fits against the JAX package's defer_r=False fits with the JAX
init and partitions injected; a JAX stored state carried across; and, on a
CUDA card only, K2 against its plain version."""

import dataclasses

import numpy as np
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
from harmonypy_tpu_torch.api import stored_r
from harmonypy_tpu_torch.ops.cuda import fused_estep as fe
from harmonypy_tpu_torch.ops.cuda.fused_estep import fused_estep, fused_estep_r
from harmonypy_tpu_torch.ops.update_r_fused import (fused_update_nor,
                                                    fused_update_r)
from harmonypy_tpu_torch.state import state_from_numpy
from test_pallas import _chunk_problem
from test_torch_fit import SEED, _problem
from test_torch_fused_estep import _jax_round, _port_inputs

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _bf16_bits(x) -> np.ndarray:
    """bf16 bit patterns (as int32) of values exactly representable in
    bf16, given as a torch tensor or a float32 / bfloat16 numpy array."""
    t = torch.tensor(np.asarray(x, np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().astype(np.int32)


def _assert_within_one_bf16_ulp(a, b):
    """Non-negative bf16 values a and b differ by at most one unit in the
    last place: their bit patterns are at most 1 apart."""
    diff = np.abs(_bf16_bits(a) - _bf16_bits(b))
    assert diff.max() <= 1, diff.max()


@pytest.mark.parametrize("r_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fast", [False, True])
def test_plain_write_r_round_matches_pallas_kernel(r_dtype, fast):
    cfg, p = _chunk_problem(block_size=0.25)
    cfg = dataclasses.replace(cfg, fast_objective=fast, r_dtype=r_dtype)
    (R_j, O_j, E_j, cache_j, ybuf_j, kbuf_j), blocks, _ = _jax_round(
        cfg, p, write_r=True)
    _, geom, args = _port_inputs(cfg, p, blocks)
    nc1, K, CH = geom.nc_cap + 1, cfg.K, geom.CH
    R3 = torch.empty((nc1, K, CH), dtype=_DTYPES[r_dtype])
    out = fused_update_r(args[0], args[1], args[2], R3, *args[3:], fast)
    assert out[0] is R3
    R_port = R3.permute(1, 0, 2).reshape(K, nc1 * CH)
    if r_dtype == "float32":
        np.testing.assert_allclose(R_port.numpy(), R_j, rtol=1e-5, atol=1e-6)
    else:
        _assert_within_one_bf16_ulp(R_port.float(), R_j)
    # The dummy chunk, allocated with torch.empty, comes out exactly zero.
    assert not R3[geom.nc_cap].float().any()
    O, E, cache, ybuf, kbuf = out[1:]
    np.testing.assert_allclose(cache.numpy(), cache_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ybuf.numpy(), ybuf_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(O.numpy(), O_j, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(E.numpy(), E_j, rtol=1e-5, atol=1e-4)
    nc = geom.nc_cap
    np.testing.assert_allclose(kbuf[:nc].numpy(), kbuf_j[:nc], rtol=1e-5)
    # Its statistics are the no-R round's, bit for bit, and its fp32 r is
    # the r window's.
    nor = fused_update_nor(*args, fast, lo=0, width=nc)
    for a, b in zip(out[1:], nor[:5]):
        assert torch.equal(a, b)
    if r_dtype == "float32":
        assert torch.equal(R3[:nc], nor[5])
    else:
        assert torch.equal(R3[:nc], nor[5].to(torch.bfloat16))


def _jax_blocks(cfg, n_rounds):
    """The per-round (L,) chunk assignments of a JAX fit with seed SEED,
    from its key splits (api.py:394, engine.py:209, 429)."""
    geom = partition_geometry(cfg)
    key, _ = jax.random.split(jax.random.PRNGKey(SEED))
    blocks = []
    for _ in range(n_rounds):
        key, k_r = jax.random.split(key)
        blocks.append(np.array(stripe_blocks(k_r, geom.NC_fixed, geom.L,
                                             geom.nb)))
    return blocks


@pytest.fixture(scope="module", params=[False, True],
                ids=["float32", "low_memory"])
def jax_stored_fit(request):
    """One stored-R fused JAX fit (defer_r=False, 1 device, chunk_size=128,
    one harmony iteration), its init centroids and per-round partitions."""
    X, meta = _problem()
    ho = hm.run_harmony(X, meta, ["batch"], mesh=make_mesh(n_devices=1),
                        verbose=False, chunk_size=128, max_iter_harmony=1,
                        defer_r=False, low_memory=request.param,
                        random_state=SEED)
    assert ho.cfg.use_fused_xla and not ho.cfg.defer_r
    st0 = ho._engine.init_fn(ho._data, ho._params, jax.random.PRNGKey(SEED))
    blocks = _jax_blocks(ho.cfg, ho.cfg.max_iter_kmeans)
    return X, meta, request.param, ho, np.array(st0.Y), blocks


def test_stored_fit_matches_jax_with_injected_init_and_partitions(
        jax_stored_fit):
    X, meta, low_memory, ho_j, Y0, blocks = jax_stored_fit
    ho_t = ht.run_harmony(X, meta, ["batch"], device="cpu", verbose=False,
                          chunk_size=128, max_iter_harmony=1, defer_r=False,
                          low_memory=low_memory, _init_Y=Y0,
                          _blocks_fn=lambda i: blocks[i])
    assert not ho_t.cfg.defer_r and ho_t.cfg.r_dtype == ho_j.cfg.r_dtype
    assert ho_t.kmeans_rounds == ho_j.kmeans_rounds
    np.testing.assert_allclose(ho_t.objective_kmeans, ho_j.objective_kmeans,
                               rtol=1e-4)
    np.testing.assert_allclose(ho_t.objective_harmony,
                               ho_j.objective_harmony, rtol=1e-4)
    if not low_memory:
        np.testing.assert_allclose(ho_t.Z_corr, ho_j.Z_corr, atol=1e-4)
        np.testing.assert_allclose(ho_t.R, ho_j.R, atol=1e-5)
        return
    # bf16 storage: an fp32 r within ~1e-7 of a rounding midpoint lands on
    # the neighbouring bf16 value in one package and not the other, so a
    # few stored r differ by one ulp. Cells whose stored R rows agree bit
    # for bit get the fp32 tolerance; the others differ by one ulp of r
    # (at most 2^-9 for r < 1) times their ridge coefficients.
    R_t, R_j = ho_t.R, ho_j.R
    _assert_within_one_bf16_ulp(R_t, R_j)
    same = np.all(_bf16_bits(R_t) == _bf16_bits(R_j), axis=1)
    assert same.mean() > 0.9, same.mean()
    np.testing.assert_allclose(ho_t.Z_corr[same], ho_j.Z_corr[same],
                               atol=1e-4)
    np.testing.assert_allclose(ho_t.Z_corr, ho_j.Z_corr, atol=4e-3)


def test_stored_state_carried_across_gives_jax_R(jax_stored_fit):
    """A JAX stored-R state, as numpy arrays, through state_from_numpy: the
    port's .R (chunk-major storage in its r_dtype) equals the JAX
    package's bit for bit."""
    _, _, _, ho_j, _, _ = jax_stored_fit
    arrays = {k: np.asarray(v) for k, v in ho_j.state._asdict().items()}
    cfg = ht.api.EngineConfig(
        N=ho_j.N, d=ho_j.d, K=ho_j.K, B=ho_j.B, n_devices=1,
        use_fused_xla=True, chunk_size=ho_j.cfg.chunk_size,
        r_dtype=ho_j.cfg.r_dtype, max_iter_harmony=1)
    st = state_from_numpy(arrays, cfg, device="cpu")
    assert st.R.dtype == cfg.r_torch_dtype
    assert st.R.shape == (cfg.N_pad // cfg.chunk_size, cfg.K, cfg.chunk_size)
    np.testing.assert_array_equal(stored_r(cfg, st), ho_j.R)
    assert st.kmeans_rounds == ho_j.kmeans_rounds


@pytest.mark.parametrize("bad", [-1, "nc1"])
@pytest.mark.parametrize("write_r", [False, True])
def test_cpu_path_rejects_slot_ids_out_of_range(bad, write_r):
    """On the CPU both wrappers check the slot range on the host (on the
    card the kernel traps instead, with no host synchronise)."""
    cfg, p = _chunk_problem(block_size=0.25)
    _, blocks, _ = _jax_round(cfg, p, write_r=False)
    _, geom, args = _port_inputs(cfg, p, blocks)
    nc1 = geom.nc_cap + 1
    slots = args[0].clone()
    slots[0, 0] = nc1 if bad == "nc1" else bad
    with pytest.raises(ValueError, match="slot ids"):
        if write_r:
            R3 = torch.empty((nc1, cfg.K, geom.CH))
            fused_estep_r(slots, args[1], args[2], R3, *args[3:], False)
        else:
            fused_estep(slots, *args[1:], False)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("r_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fast", [False, True])
def test_kernel_write_r_matches_plain_on_cuda(cuda_device, r_dtype, fast):
    cfg, p = _chunk_problem(block_size=0.25)
    _, blocks, _ = _jax_round(cfg, p, write_r=False)
    _, geom, args = _port_inputs(cfg, p, blocks, device=cuda_device)
    nc1, K, CH, nc = geom.nc_cap + 1, cfg.K, geom.CH, geom.nc_cap
    dt = _DTYPES[r_dtype]

    def run():
        R3 = torch.empty((nc1, K, CH), dtype=dt, device=cuda_device)
        return fused_estep_r(args[0], args[1], args[2], R3, *args[3:], fast)

    n0 = fe.launches_write_r
    kern = run()
    assert fe.launches_write_r == n0 + 1   # one cooperative launch per round
    R3p = torch.empty((nc1, K, CH), dtype=dt, device=cuda_device)
    plain = fused_update_r(args[0], args[1], args[2], R3p, *args[3:], fast)
    torch.cuda.synchronize()
    tol = dict(R3=(1e-5, 1e-6), O=(1e-5, 1e-4), E=(1e-5, 1e-4),
               cache=(1e-5, 1e-5), ybuf=(1e-5, 1e-5), kbuf=(1e-5, 1e-5))
    for (name, (rtol, atol)), a, b in zip(tol.items(), kern, plain):
        if name == "R3" and r_dtype == "bfloat16":
            _assert_within_one_bf16_ulp(a.float().cpu(), b.float().cpu())
            continue
        np.testing.assert_allclose(a.float().cpu().numpy(),
                                   b.float().cpu().numpy(), rtol=rtol,
                                   atol=atol, err_msg=name)
    assert not kern[0][nc].float().any()
    # K2's statistics are K1's round bit for bit, its r K1's r window.
    again = run()
    k1 = fused_estep(*args, fast, lo=0, width=nc)
    for a, b, c in zip(kern[1:], again[1:], k1[:5]):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(kern[0], again[0])
    assert torch.equal(kern[0][:nc], k1[5].to(dt))
