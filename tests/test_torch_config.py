"""The port's EngineConfig and chunk-size rules equal the JAX package's."""

import itertools

import pytest

from harmonypy_tpu import config as jcfg
from harmonypy_tpu_torch import config as tcfg

_PROPS = ("fused_estep", "N_pad", "N_local", "N_shard_real", "B1",
          "n_blocks", "cell_block_width", "kmeans_hist_len",
          "harmony_hist_len", "rounds_hist_len", "kmeanspp_trials")

_GRID = list(itertools.product(
    (1, 128, 3_500, 20_479, 20_480, 30_000, 41_000, 858_000),   # N
    (0.05, 0.25, 0.3, 1.0),                                     # block_size
    (None, 128, 1000, 2048)))                                   # chunk_size


@pytest.mark.parametrize("fused", [False, True])
def test_derived_geometry_matches_jax(fused):
    for N, bs, cs in _GRID:
        for K, mi_h, mi_k in ((1, 0, 0), (7, 1, 1), (100, 10, 20)):
            ch = jcfg.auto_chunk_size(N, bs, cs)
            kw = dict(N=N, d=29, K=K, B=3, n_devices=1, block_size=bs,
                      chunk_size=ch, use_fused_xla=fused, defer_r=fused,
                      max_iter_harmony=mi_h, max_iter_kmeans=mi_k)
            a, b = jcfg.EngineConfig(**kw), tcfg.EngineConfig(**kw)
            for p in _PROPS:
                assert getattr(a, p) == getattr(b, p), (p, kw)


def test_chunk_rules_match_jax():
    for N, bs, cs in _GRID:
        assert tcfg.auto_chunk_size(N, bs, cs) == jcfg.auto_chunk_size(
            N, bs, cs), (N, bs, cs)
        for ch in (128, 1000, 2048):
            assert tcfg.fused_geometry_ok(N, 1, bs, ch) == \
                jcfg.fused_geometry_ok(N, 1, bs, ch), (N, bs, ch)
    assert tcfg._PER_CELL_MAX_N == jcfg._PER_CELL_MAX_N
    for N in (1, 29, 30, 3_500, 858_000):
        assert tcfg.default_nclust(N) == jcfg.default_nclust(N)
    for N, bs, cs in _GRID:
        for nd in (1, 2):
            assert tcfg.pallas_supported(N, nd, bs, cs or 2048) == \
                jcfg.pallas_supported(N, nd, bs, cs or 2048)


def test_cell_tile_rules_match_jax():
    assert tcfg.CELL_TILE_M == jcfg.CELL_TILE_M
    for nb in (1, 2, 3, 4, 10, 20, 100):
        assert tcfg.cell_tile_geom(nb) == jcfg.cell_tile_geom(nb)
        assert tcfg.expected_skip_fraction(nb) == \
            jcfg.expected_skip_fraction(nb)


def test_config_fields_match_jax():
    """The port keeps every field of the JAX config, with the same
    defaults."""
    import dataclasses
    jf = {f.name: f.default for f in dataclasses.fields(jcfg.EngineConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tcfg.EngineConfig)}
    assert jf == tf


def test_validate_accepts_only_the_ported_path():
    """Deferred-R, stored-R fused (either fused flag), per-cell and bf16 R
    validate on one device and on a mesh; no devices and inconsistent flags
    do not."""
    base = dict(N=5000, d=4, K=5, B=2, n_devices=1, chunk_size=128)
    for ok in (dict(use_fused_xla=True, defer_r=True),
               dict(use_pallas=True, defer_r=True),
               dict(use_fused_xla=True), dict(use_pallas=True), dict(),
               dict(use_fused_xla=True, r_dtype="bfloat16"),
               dict(r_dtype="bfloat16")):
        tcfg.EngineConfig(**base, **ok).validate()
    for ok in (dict(use_fused_xla=True, defer_r=True), dict()):
        tcfg.EngineConfig(**{**base, "n_devices": 4}, **ok).validate()
    for bad in (dict(n_devices=0), dict(defer_r=True),
                dict(use_pallas=True, use_fused_xla=True),
                dict(use_fused_xla=True, r_dtype="float16"),
                dict(use_pallas=True, chunk_size=2048)):
        with pytest.raises(ValueError):
            tcfg.EngineConfig(**{**base, **bad}).validate()
