"""The port's chunk partition tables against the JAX package's
(harmonypy_tpu/ops/partition.py), and the structural checks of
tests/test_partition.py on the port's own torch.Generator draws."""

import numpy as np
import pytest
import torch

# Test workers share the CPU cores with each other and with JAX's own
# thread pool: one intra-op thread each keeps torch from oversubscribing.
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from harmonypy_tpu.config import EngineConfig as JConfig
from harmonypy_tpu.ops import partition as jp
from harmonypy_tpu_torch.config import EngineConfig as TConfig
from harmonypy_tpu_torch.ops import partition as tp

_GEOMS = [(8000, 128, 0.05), (70_000, 2048, 0.05), (5000, 128, 0.25),
          (4096, 128, 0.3), (858_000, 2048, 0.05)]


def _cfgs(N, CH, bs):
    kw = dict(N=N, d=4, K=5, B=2, n_devices=1, use_fused_xla=True,
              chunk_size=CH, block_size=bs)
    return JConfig(**kw), TConfig(**kw, defer_r=True)


@pytest.mark.parametrize("N,CH,bs", _GEOMS)
def test_tables_equal_jax_given_its_blocks(N, CH, bs):
    jc, tc = _cfgs(N, CH, bs)
    jg, tg = jp.partition_geometry(jc), tp.partition_geometry(tc)
    assert tuple(jg) == tuple(getattr(tg, f) for f in jg._fields)
    key = jax.random.PRNGKey(N % 97)
    blocks = np.array(jp.stripe_blocks(key, jg.NC_fixed, jg.L, jg.nb))
    j_slots, j_granks, j_gtbl = map(np.asarray,
                                    jp.single_device_tables(key, jc))
    t_slots, t_granks, t_gtbl = tp.single_device_tables(
        torch.as_tensor(blocks, dtype=torch.int64), tg)
    np.testing.assert_array_equal(t_slots.numpy(), j_slots)
    np.testing.assert_array_equal(t_granks.numpy(), j_granks)
    np.testing.assert_array_equal(t_gtbl.numpy(), j_gtbl)

    rng = np.random.default_rng(0)
    cache = rng.random((jg.nc_cap, jc.K, jc.B + 1)).astype(np.float32)
    j_rem = np.asarray(jp.removal_from_cache(jnp.asarray(cache),
                                             jnp.asarray(j_gtbl), jg))
    t_rem = tp.removal_from_cache(torch.as_tensor(cache), t_gtbl, tg)
    np.testing.assert_allclose(t_rem.numpy(), j_rem, rtol=1e-6)
    slots32, rem = tp.round_tables(torch.as_tensor(blocks),
                                   torch.as_tensor(cache), tg)
    assert slots32.dtype == torch.int32
    np.testing.assert_array_equal(slots32.numpy(), j_slots)
    np.testing.assert_array_equal(rem.numpy(), t_rem.numpy())


@pytest.mark.parametrize("N,CH,bs", _GEOMS)
@pytest.mark.parametrize("seed", [0, 1])
def test_torch_draws_structure(N, CH, bs, seed):
    """tests/test_partition.py:88-138 on the port's own draws."""
    _, tc = _cfgs(N, CH, bs)
    geom = tp.partition_geometry(tc)
    gen = torch.Generator().manual_seed(seed)
    blocks = tp.stripe_blocks(gen, geom.NC_fixed, geom.L, geom.nb)
    b = blocks.numpy()
    # One permutation of the block ids per stripe.
    for s in range(geom.NC_fixed // geom.nb):
        assert sorted(b[s * geom.nb:(s + 1) * geom.nb]) == list(range(geom.nb))
    ranks = tp.block_ranks(blocks, geom.nb, geom.J_fix).numpy()
    gtbl = tp.global_slot_table(blocks, torch.as_tensor(ranks), geom).numpy()
    assert sorted(gtbl.reshape(-1).tolist()) == list(range(geom.NC_fixed))
    seen = {}
    for g in range(min(geom.nc_cap, geom.NC_fixed)):
        key = (b[g], ranks[g])
        assert key not in seen
        seen[key] = g
        assert gtbl[key] == g
    slots, granks, gtbl2 = tp.single_device_tables(blocks, geom)
    np.testing.assert_array_equal(gtbl2.numpy(), gtbl)
    assert slots.shape == (geom.nb, geom.J_shard) == granks.shape
    s = slots.numpy()
    real = s[s < geom.nc_cap]
    assert sorted(real.tolist()) == list(range(min(geom.nc_cap,
                                                   geom.NC_fixed)))
    # Every block ends in at least one dummy slot, ascending before it.
    assert np.all(s[:, -1] == geom.nc_cap)
    assert np.all(np.diff(s, axis=1) >= 0)


def test_torch_draws_depend_on_seed_only():
    _, tc = _cfgs(70_000, 2048, 0.05)
    geom = tp.partition_geometry(tc)

    def draw(seed):
        return tp.stripe_blocks(torch.Generator().manual_seed(seed),
                                geom.NC_fixed, geom.L, geom.nb)

    assert torch.equal(draw(3), draw(3))
    assert not torch.equal(draw(3), draw(4))


def test_frame_sum_is_the_chunk_sum():
    _, tc = _cfgs(5000, 128, 0.25)
    geom = tp.partition_geometry(tc)
    vals = torch.rand((geom.nc_cap + 1, 3, 4),
                      generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(tp.frame_sum(vals, geom).numpy(),
                               vals[:-1].numpy().sum(0), rtol=1e-6)
