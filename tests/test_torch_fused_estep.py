"""The port's fused E-step round against the JAX package's Pallas kernel
(run in interpret mode, as tests/test_pallas.py runs it) and against that
file's sequential chunk oracle; the replay epilogue against the round; and,
on a CUDA card only, the hand-written kernel against the plain version."""

import numpy as np
import pytest
import torch

# Test workers share the CPU cores with each other and with JAX's own
# thread pool: one intra-op thread each keeps torch from oversubscribing.
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from harmonypy_tpu.config import EngineConfig as JConfig
from harmonypy_tpu.ops.pallas.update_r_fused import (chunk_stats as
                                                     j_chunk_stats,
                                                     fused_update_r,
                                                     pallas_geometry)
from harmonypy_tpu.ops.partition import (partition_geometry,
                                         removal_from_cache,
                                         single_device_tables, stripe_blocks)
from harmonypy_tpu_torch.config import EngineConfig as TConfig
from harmonypy_tpu_torch.ops import partition as tp
from harmonypy_tpu_torch.ops.cuda import fused_estep as fe
from harmonypy_tpu_torch.ops.cuda.fused_estep import (TILE, fused_estep,
                                                      kernel_geometry)
from harmonypy_tpu_torch.ops.replay import replay_r
from harmonypy_tpu_torch.ops.update_r_fused import (chunk_stats,
                                                    fused_update_nor,
                                                    make_zp3)
from test_pallas import _chunk_problem, _oracle_chunked


def _port_inputs(cfg, p, blocks, device="cpu"):
    """The port's round inputs for test_pallas's chunk problem, with the
    partition given as the JAX package's (L,) block assignment."""
    tc = TConfig(**{f: getattr(cfg, f) for f in
                    ("N", "d", "K", "B", "n_devices", "chunk_size",
                     "block_size", "fast_objective")},
                 use_fused_xla=True, defer_r=True)
    geom = tp.partition_geometry(tc)
    t = {k: torch.as_tensor(v, device=device) for k, v in p.items()
         if isinstance(v, np.ndarray)}
    nc1, CH = geom.nc_cap + 1, geom.CH
    mask = torch.ones(nc1 * CH, device=device)          # JAX's mask=None
    ZP3 = make_zp3(t["Zc"], t["Phi"], mask, tc)
    r3 = t["R"].reshape(cfg.K, nc1, CH).permute(1, 0, 2)
    cache = chunk_stats(r3, ZP3[:, 1:1 + cfg.B, :])
    slots, removal = tp.round_tables(
        torch.as_tensor(blocks, dtype=torch.int64, device=device), cache,
        geom)
    args = (slots, removal, ZP3, t["Y"], t["sigma"], t["theta"],
            t["Pr_b"].float(), t["O"], t["E"])
    return tc, geom, args


def _jax_round(cfg, p, write_r):
    pgeom = partition_geometry(cfg)
    key = jax.random.PRNGKey(3)
    slots, _, gtbl = single_device_tables(key, cfg)
    cache = j_chunk_stats(jnp.asarray(p["R"]), jnp.asarray(p["Phi"]), cfg)
    removal = removal_from_cache(cache[: pgeom.nc_cap], gtbl, pgeom)
    out = fused_update_r(
        np.asarray(slots).reshape(-1), removal, jnp.asarray(p["Zc"]),
        jnp.asarray(p["Phi"]), None, jnp.asarray(p["Y"]),
        jnp.asarray(p["sigma"]), jnp.asarray(p["theta"]),
        jnp.asarray(p["Pr_b"]), jnp.asarray(p["O"]), jnp.asarray(p["E"]),
        cfg, interpret=True, write_r=write_r)
    blocks = np.array(stripe_blocks(key, pgeom.NC_fixed, pgeom.L,
                                      pgeom.nb))
    return [None if x is None else np.asarray(x) for x in out], blocks, \
        np.asarray(slots)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("block_size", [0.25, 0.3])
def test_plain_round_matches_pallas_kernel(block_size, fast):
    import dataclasses
    cfg, p = _chunk_problem(block_size=block_size)
    cfg = dataclasses.replace(cfg, fast_objective=fast)
    (_, O_j, E_j, cache_j, ybuf_j, kbuf_j), blocks, slots_j = _jax_round(
        cfg, p, write_r=False)
    (R_j, *_), _, _ = _jax_round(cfg, p, write_r=True)
    tc, geom, args = _port_inputs(cfg, p, blocks)
    np.testing.assert_array_equal(args[0].numpy(), slots_j)
    O, E, cache, ybuf, kbuf, Rw = fused_update_nor(
        *args, fast, lo=0, width=geom.nc_cap)

    K, CH, nc = cfg.K, geom.CH, geom.nc_cap
    R_port = Rw.permute(1, 0, 2).reshape(K, nc * CH).numpy()
    np.testing.assert_allclose(R_port, R_j[:, : nc * CH], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(cache.numpy(), cache_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ybuf.numpy(), ybuf_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(O.numpy(), O_j, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(E.numpy(), E_j, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(kbuf[:nc].numpy(), kbuf_j[:nc], rtol=1e-5)
    # The dummy chunk comes out exactly zero.
    assert not cache[nc].any() and not ybuf[nc].any() and not kbuf[nc].any()

    # And against test_pallas's sequential chunk oracle.
    R_ref, E_ref, O_ref = _oracle_chunked(p, slots_j, pallas_geometry(cfg))
    np.testing.assert_allclose(R_port, R_ref[:, : nc * CH], atol=2e-5)
    np.testing.assert_allclose(O.numpy(), O_ref, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(E.numpy(), E_ref, rtol=1e-4, atol=1e-3)


def test_replay_reproduces_round_bitwise_on_cpu():
    cfg, p = _chunk_problem(block_size=0.25)
    _, blocks, _ = _jax_round(cfg, p, write_r=False)
    tc, geom, args = _port_inputs(cfg, p, blocks)
    rnd = fused_update_nor(*args, False)
    rep = fused_estep(*args, False, lo=5, width=7)
    for a, b in zip(rnd[:5], rep[:5]):
        assert torch.equal(a, b)
    # Any window of the replay holds the same r.
    full = replay_r(args[:2], *args[2:], False, 0, geom.nc_cap)
    part = replay_r(args[:2], *args[2:], False, 5, 7)
    assert torch.equal(full[5:12], part)
    # The replayed r is the round's r: its statistics are the round's cache.
    stats = chunk_stats(full, args[2][: geom.nc_cap, 1:1 + cfg.B, :])
    np.testing.assert_allclose(stats[..., 0].numpy(),
                               rnd[2][: geom.nc_cap, :, 0].numpy(),
                               rtol=1e-5, atol=1e-5)


_GEOM_CASES = [(K, CH) for K in (7, 100, 200) for CH in (128, 2048)]


@pytest.mark.parametrize("K,CH", _GEOM_CASES)
@pytest.mark.parametrize("J,n_sm", [(22, 132), (3, 132), (400, 16)])
def test_kernel_geometry_covers_each_cell_once_in_tile_order(K, CH, J, n_sm):
    geo = kernel_geometry(K, 3, 29, CH, J, n_sm)
    assert geo.n_units == J * geo.ng and 1 <= geo.ng <= geo.tiles
    seen = np.zeros((J, geo.tiles * TILE), dtype=np.int64)
    last = {}
    for u in range(geo.n_units):
        j, t0, t1 = geo.unit_tiles(u)
        assert t0 < t1, "empty unit"
        # Units of a slot run over its tiles in ascending order.
        assert t0 == last.get(j, 0)
        last[j] = t1
        seen[j, t0 * TILE: t1 * TILE] += 1
    assert all(last[j] == geo.tiles for j in range(J))
    assert (seen == 1).all()
    assert geo.tiles * TILE >= CH > (geo.tiles - 1) * TILE


@pytest.mark.parametrize("K,CH", _GEOM_CASES)
@pytest.mark.parametrize("B,d", [(1, 5), (3, 29), (5, 50)])
def test_kernel_geometry_padding(K, CH, B, d):
    geo = kernel_geometry(K, B, d, CH, 22, 132)
    R = 1 + B + d
    assert geo.K_pad % 16 == 0 and K <= geo.K_pad < K + 16
    assert geo.d_pad % 8 == 0 and d <= geo.d_pad < d + 8
    assert geo.R_pad % 8 == 0 and R <= geo.R_pad < R + 8


@pytest.mark.parametrize("K,CH", _GEOM_CASES)
def test_kernel_geometry_partial_shapes(K, CH):
    J, n_sm = 22, 132
    geo = kernel_geometry(K, 3, 29, CH, J, n_sm)
    tiles = CH // TILE
    # As many units as the card runs two CTAs of per SM, at most one per
    # tile: 12 per slot at CH 2048, both tiles of a 128-cell chunk.
    assert geo.ng == min(tiles, 2 * n_sm // J)
    assert geo.part_shape == (J * geo.ng, K, 1 + 3 + 29)
    assert geo.kpart_shape == (J * geo.ng, 2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
def test_kernel_matches_plain_on_cuda(cuda_device, fast):
    cfg, p = _chunk_problem(block_size=0.25)
    _, blocks, _ = _jax_round(cfg, p, write_r=False)
    _, geom, args = _port_inputs(cfg, p, blocks, device=cuda_device)
    n0 = fe.launches
    kern = fused_estep(*args, fast, lo=2, width=5)
    assert fe.launches == n0 + 1       # one cooperative launch per round
    plain = fused_update_nor(*args, fast, lo=2, width=5)
    torch.cuda.synchronize()
    tol = dict(O=(1e-5, 1e-4), E=(1e-5, 1e-4), cache=(1e-5, 1e-5),
               ybuf=(1e-5, 1e-5), kbuf=(1e-5, 1e-5), Rw=(1e-5, 1e-6))
    for (name, (rtol, atol)), a, b in zip(tol.items(), kern, plain):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=rtol, atol=atol, err_msg=name)
    again = fused_estep(*args, fast, lo=2, width=5)
    rnd = fused_estep(*args, fast)
    for a, b, c in zip(kern[:5], again[:5], rnd[:5]):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(kern[5], again[5])
