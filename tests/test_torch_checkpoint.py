"""Checkpoint / resume in the port on the CPU: a state round trip (bf16 R
included), resumed fits bitwise equal to the uninterrupted ones on the
deferred, stored and per-cell paths, the mismatch report of an
incompatible resume, and the generator state and draw count a resumed fit
continues from."""

import dataclasses

import numpy as np
import pytest
import torch

# Test workers share the CPU cores with each other and with JAX's own
# thread pool: one intra-op thread each keeps torch from oversubscribing.
torch.set_num_threads(1)

import harmonypy_tpu_torch as ht
from harmonypy_tpu_torch.ops.partition import partition_geometry, stripe_blocks
from harmonypy_tpu_torch.state import HarmonyState
from harmonypy_tpu_torch.utils.checkpoint import (RngState, load_state,
                                                  save_state)
from test_torch_fit import _problem

HISTORIES = ("objective_harmony", "objective_kmeans", "objective_kmeans_dist",
             "objective_kmeans_entropy", "objective_kmeans_cross")
PATHS = {"deferred": dict(chunk_size=128),
         "stored": dict(chunk_size=128, defer_r=False),
         "percell": dict()}


def _fit(X, meta, **kw):
    args = dict(device="cpu", verbose=False, max_iter_harmony=3,
                max_iter_kmeans=6, random_state=3)
    args.update(kw)
    return ht.run_harmony(X, meta, ["batch"], **args)


@pytest.fixture(scope="module")
def data():
    return _problem(N=2600, d=6)


@pytest.mark.parametrize("path", list(PATHS))
def test_resume_matches_uninterrupted(data, path, tmp_path):
    """A fit resumed from harmony_iter_1.npz equals the checkpointing fit
    and a fit without checkpoints bitwise: Z_corr, R, all five objective
    histories and kmeans_rounds."""
    X, meta = data
    kw = PATHS[path]
    full = _fit(X, meta, checkpoint_dir=str(tmp_path), **kw)
    assert full.cfg.defer_r == (path == "deferred")
    assert full.cfg.fused_estep == (path != "percell")
    plain = _fit(X, meta, **kw)
    resumed = _fit(X, meta, resume_from=str(tmp_path / "harmony_iter_1.npz"),
                   **kw)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"harmony_iter_{i}.npz" for i in range(1, 4)]
    for other in (plain, resumed):
        np.testing.assert_array_equal(other.Z_corr, full.Z_corr)
        np.testing.assert_array_equal(other.R, full.R)
        for h in HISTORIES:
            assert getattr(other, h) == getattr(full, h), h
        assert other.kmeans_rounds == full.kmeans_rounds


def test_state_roundtrip_bf16(data, tmp_path):
    """save_state / load_state keep every field bitwise, a bf16 R (saved as
    its int16 bit pattern) and the generator state included."""
    X, meta = data
    ho = _fit(X, meta, max_iter_harmony=1, chunk_size=128, defer_r=False,
              low_memory=True)
    assert ho.state.R.dtype == torch.bfloat16
    gen = torch.Generator()
    gen.manual_seed(9)
    rng = RngState(gen.get_state(), "cpu", 5)
    path = str(tmp_path / "s.npz")
    save_state(path, ho.state, rng, ho.cfg)
    loaded, rng2 = load_state(path)
    for f in dataclasses.fields(HarmonyState):
        a, b = getattr(ho.state, f.name), getattr(loaded, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype, f.name
            assert torch.equal(a, b), f.name
        else:
            assert a == b, f.name
    assert torch.equal(rng2.gen_state, rng.gen_state)
    assert (rng2.device_type, rng2.n_drawn) == ("cpu", 5)


def test_incompatible_resume_lists_every_mismatch(data, tmp_path):
    """Another max_iter_harmony and low_memory: one ValueError naming the
    history lengths and the R dtype; a CUDA generator's state on the CPU
    is refused too."""
    X, meta = data
    _fit(X, meta, chunk_size=128, defer_r=False, max_iter_harmony=2,
         checkpoint_dir=str(tmp_path))
    path = str(tmp_path / "harmony_iter_1.npz")
    with pytest.raises(ValueError) as exc:
        _fit(X, meta, chunk_size=128, defer_r=False, max_iter_harmony=4,
             low_memory=True, resume_from=path)
    msg = str(exc.value)
    for name in ("obj_kmeans", "obj_dist", "obj_entropy", "obj_cross",
                 "obj_harmony", "R: dtype float32, expected bfloat16"):
        assert name in msg, (name, msg)
    with np.load(path) as z:
        arrays = dict(z)
    arrays["gen_device"] = np.asarray("cuda")
    bad = str(tmp_path / "cuda_gen.npz")
    np.savez(bad, **arrays)
    with pytest.raises(ValueError, match="a cuda generator's state"):
        _fit(X, meta, chunk_size=128, defer_r=False, max_iter_harmony=2,
             resume_from=bad)


def test_resume_restores_generator_and_draw_count(data, tmp_path):
    """The draw count goes on where it stopped: an injected blocks_fn is
    asked, after a resume, for the rounds the uninterrupted fit asked for
    after iteration 1, and the fits agree bitwise. Each checkpoint holds
    the generator state of its iteration and the draws made so far."""
    X, meta = data
    geom = partition_geometry(_fit(X, meta, chunk_size=128, defer_r=False,
                                   max_iter_harmony=0).cfg)
    seen = {"full": [], "resumed": []}

    def blocks_fn(tag):
        def fn(i):
            seen[tag].append(i)
            g = torch.Generator()
            g.manual_seed(1000 + i)
            return stripe_blocks(g, geom.NC_fixed, geom.L, geom.nb)
        return fn

    full = _fit(X, meta, chunk_size=128, checkpoint_dir=str(tmp_path),
                _blocks_fn=blocks_fn("full"))
    after1 = full.kmeans_rounds[0]
    assert seen["full"] == list(range(sum(full.kmeans_rounds)))
    resumed = _fit(X, meta, chunk_size=128, _blocks_fn=blocks_fn("resumed"),
                   resume_from=str(tmp_path / "harmony_iter_1.npz"))
    assert seen["resumed"] == seen["full"][after1:]
    np.testing.assert_array_equal(resumed.Z_corr, full.Z_corr)

    plain = _fit(X, meta, chunk_size=128, checkpoint_dir=str(tmp_path))
    _, rng1 = load_state(str(tmp_path / "harmony_iter_1.npz"))
    _, rng2 = load_state(str(tmp_path / "harmony_iter_2.npz"))
    assert rng1.n_drawn == plain.kmeans_rounds[0]
    assert rng2.n_drawn == sum(plain.kmeans_rounds[:2])
    assert rng1.device_type == "cpu"
    assert not torch.equal(rng1.gen_state, rng2.gen_state)
