"""The port's phase profiler (utils/profiling.py) on the CPU against the JAX
package's (tests/test_profiling.py): the same probes through the real
engine, the same result keys, the same traffic model; the H100 floor of
the deferred round; trace and phase_timer; and the harmony iteration that
fit and profile_fit share."""

import dataclasses
import glob
import os
import time

import numpy as np
import pytest
import torch

# Test workers share the CPU cores with each other and with JAX's own
# thread pool: one intra-op thread each keeps torch from oversubscribing.
torch.set_num_threads(1)

import jax

from harmonypy_tpu.config import EngineConfig as JaxConfig
from harmonypy_tpu.parallel.mesh import make_mesh as jax_mesh
from harmonypy_tpu.parallel.sharding import shard_inputs as jax_shard_inputs
from harmonypy_tpu.state import HarmonyParams as JaxParams
from harmonypy_tpu.utils.profiling import (
    estep_traffic_model_gb as jax_traffic_gb, profile_fit as jax_profile_fit)
from harmonypy_tpu_torch import engine
from harmonypy_tpu_torch.config import EngineConfig
from harmonypy_tpu_torch.parallel.mesh import make_mesh
from harmonypy_tpu_torch.parallel.sharding import shard_inputs
from harmonypy_tpu_torch.state import HarmonyParams
from harmonypy_tpu_torch.utils import device_sync, phase_timer, trace
from harmonypy_tpu_torch.utils.profiling import (
    estep_traffic_model_gb, estep_vpu_floor_s, profile_fit, round_bound)

N, D, K, B = 512, 8, 6, 3
# tests/test_profiling.py's deferred and default configurations.
CFG_KW = dict(N=N, d=D, K=K, B=B, n_devices=1, use_fused_xla=True,
              chunk_size=64, block_size=0.25)
HBM_PAIR = {"estep_hbm_gbps", "estep_hbm_frac_of_peak", "estep_round_noisy"}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(D, N)).astype(np.float32)
    batch = rng.integers(0, B, size=N)
    Phi = (batch[None, :] == np.arange(B)[:, None]).astype(np.float32)
    return Z, Phi


def _port(defer_r=True):
    cfg = EngineConfig(**CFG_KW, defer_r=defer_r)
    mesh = make_mesh(["cpu"])
    Z, Phi = _inputs()
    params = HarmonyParams(
        theta=torch.full((B,), 2.0), sigma=torch.full((K,), 0.1),
        lamb=torch.tensor([0.0] + [1.0] * B),
        Pr_b=torch.as_tensor(Phi.sum(axis=1) / N, dtype=torch.float32))
    return cfg, mesh, shard_inputs(Z, Phi, cfg, mesh), params


def test_profile_fit_smoke():
    cfg, mesh, data, params = _port(defer_r=True)
    res = profile_fit(cfg, mesh, data, params, reps=3)
    for k in ("dispatch_s", "phase_init_s", "phase_kmeans_round_s",
              "phase_ridge_s"):
        assert k in res, (k, res)
        assert res[k] >= 0.0
    assert ("estep_hbm_gbps" in res) != ("estep_round_noisy" in res)
    assert "fused_xla_round_s" not in res  # only added for use_pallas
    assert "pallas_stored_round_s" not in res  # only on a card
    assert estep_traffic_model_gb(cfg) > 0.0
    assert res["estep_vpu_floor_s"] > 0.0
    assert abs(res["estep_vpu_floor_frac"]
               - res["estep_vpu_floor_s"] / res["phase_kmeans_round_s"]) < 0.1

    # budget exceeded -> partial result, no exception
    res2 = profile_fit(cfg, mesh, data, params, reps=3, budget_s=0.0)
    assert "phases_truncated" in res2


def test_profile_fit_split_init():
    cfg, mesh, data, params = _port(defer_r=False)
    res = profile_fit(cfg, mesh, data, params, reps=3, split_init=True)
    assert res["phase_init_seeding_s"] >= 0.0
    assert "estep_vpu_floor_s" not in res      # deferred configs only
    assert abs(res["phase_init_stats_s"]
               - max(res["phase_init_s"]
                     - res["phase_init_seeding_s"], 0.0)) < 1e-3


def test_profile_fit_pallas_config_times_the_fused_xla_round():
    """use_pallas adds the same round under use_fused_xla (JAX package
    profiling.py:260-267); in the port both reach the one kernel."""
    cfg, mesh, data, params = _port(defer_r=False)
    cfg = dataclasses.replace(cfg, use_fused_xla=False, use_pallas=True)
    res = profile_fit(cfg, mesh, data, params, reps=2)
    assert res["fused_xla_round_s"] > 0.0
    assert "pallas_stored_round_s" not in res
    assert "phases_truncated" not in res


def test_profile_fit_keys_match_jax():
    """The same numpy inputs and a deferred config through both profilers:
    the same keys, every value >= 0; of the timing-dependent pair (HBM
    rate, or the noisy flag) each holds exactly one side."""
    cfg, mesh, data, params = _port(defer_r=True)
    port = profile_fit(cfg, mesh, data, params, reps=3, split_init=True)

    jcfg = JaxConfig(**CFG_KW, defer_r=True)
    jmesh = jax_mesh(n_devices=1)
    Z, Phi = _inputs()
    jnp = jax.numpy
    jparams = JaxParams(
        theta=jnp.full((B,), 2.0, jnp.float32),
        sigma=jnp.full((K,), 0.1, jnp.float32),
        lamb=jnp.asarray([0.0] + [1.0] * B, jnp.float32),
        Pr_b=jnp.asarray(Phi.sum(axis=1) / N, jnp.float32))
    ref = jax_profile_fit(jcfg, jmesh, jax_shard_inputs(Z, Phi, jcfg, jmesh),
                          jparams, reps=3, split_init=True)

    assert set(port) - HBM_PAIR == set(ref) - HBM_PAIR
    for res in (port, ref):
        assert ("estep_hbm_gbps" in res) != ("estep_round_noisy" in res)
        assert ("estep_hbm_gbps" in res) == ("estep_hbm_frac_of_peak" in res)
    assert all(v >= 0 for v in port.values()), port


@pytest.mark.parametrize("defer_r,r_dtype", [(True, "float32"),
                                             (False, "float32"),
                                             (False, "bfloat16")])
def test_traffic_model_equals_jax(defer_r, r_dtype):
    kw = dict(N=858_000, d=29, K=100, B=3, n_devices=1, use_fused_xla=True,
              defer_r=defer_r, r_dtype=r_dtype)
    assert estep_traffic_model_gb(EngineConfig(**kw)) == jax_traffic_gb(
        JaxConfig(**kw))


def test_vpu_floor_is_the_h100_round_bound_at_858k():
    """The deferred round's floor at 858k x 29, K = 100, B = 3, chunk
    2048: 11.15 GFLOP at the fp32 CUDA-core rate, 0.1665 ms, above its
    118.8 MB at the HBM rate."""
    cfg = EngineConfig(N=858_000, d=29, K=100, B=3, n_devices=1,
                       use_fused_xla=True, defer_r=True, chunk_size=2048)
    assert f"{estep_vpu_floor_s(cfg):.4g}" == "0.0001665"
    b = round_bound(cfg)
    assert b["flop"] == 11_154_000_000 and b["bound_by"] == "operations"
    assert round(b["bytes"] / 1e6, 1) == 118.8
    # The floor does not depend on how the cells are spread over a mesh.
    assert (estep_vpu_floor_s(dataclasses.replace(cfg, n_devices=4))
            == estep_vpu_floor_s(cfg))


def test_trace_writes_a_file_and_phase_timer_accumulates(tmp_path):
    x = torch.arange(1000, dtype=torch.float32)
    with trace(str(tmp_path)):
        (x @ x).item()
    assert glob.glob(os.path.join(str(tmp_path), "*.json"))

    pt = phase_timer()
    for _ in range(2):
        with pt("phase", sync=[x]):
            time.sleep(0.02)
    assert list(pt.timings) == ["phase"] and pt.timings["phase"] >= 0.04
    device_sync({"a": [x]})            # nothing to wait for on the CPU


@pytest.mark.parametrize("defer_r", [True, False])
def test_fit_is_init_then_harmony_steps(defer_r):
    """engine.fit runs init and then HarmonyStep, the iteration that
    profile_fit times: stepping by hand gives the fit's bits."""
    cfg, _, data, params = _port(defer_r=defer_r)
    cfg = dataclasses.replace(cfg, max_iter_harmony=3)

    def gen():
        return torch.Generator().manual_seed(5)

    full = engine.fit(data, params, cfg, gen())
    g = gen()
    init = engine.init_defer if defer_r else engine.init_stored
    st = init(data, params, cfg, g)
    step = engine.HarmonyStep(data, params, cfg, g)
    for _ in range(cfg.max_iter_harmony):
        if st.converged:
            break
        step(st)
    assert step.n_drawn == sum(st.kmeans_rounds) > 0
    for f in ("Z_corr", "Z_cos", "obj_harmony", "obj_kmeans", "Y", "O", "E"):
        assert torch.equal(getattr(full, f), getattr(st, f)), f
    assert full.kmeans_rounds == st.kmeans_rounds
