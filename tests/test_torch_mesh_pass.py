"""The port's mesh pass on the CPU: the frame re-add against the JAX
package's `_block_readd` on its CPU mesh, the k-means sample gathered from
its owner shards, no one-device-wide cell array and no (d, N) gather on a
mesh shard during a fit, the memory model's per-card terms, and the
wrapper's input checks once per pass. On the card: the re-add kernel
against its plain version, and a mesh of several cards whose lead card is
not the current device against a mesh on one card."""

import dataclasses
import types

import numpy as np
import pytest
import torch

# Test workers share the CPU cores with each other and with JAX's own
# thread pool: one intra-op thread each keeps torch from oversubscribing.
torch.set_num_threads(1)

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from harmonypy_tpu.ops.update_r_fused_xla import _block_readd
from harmonypy_tpu.parallel.mesh import AXIS as J_AXIS
from harmonypy_tpu.parallel.mesh import make_mesh as jax_mesh
import harmonypy_tpu_torch as ht
from harmonypy_tpu_torch import engine
from harmonypy_tpu_torch.config import EngineConfig, cdiv
from harmonypy_tpu_torch.ops import replay
from harmonypy_tpu_torch.ops.cuda import fused_estep as fe
from harmonypy_tpu_torch.ops.update_r_fused import frame_readd
from harmonypy_tpu_torch.parallel import sharding
from harmonypy_tpu_torch.parallel.mesh import make_mesh
from harmonypy_tpu_torch.utils.memory import memory_envelope
from test_torch_mesh import FIT, _problem, _round_inputs


def _frame_case(shards, J_fix, Js, seed):
    """Shard rows (Js, K, B+1) each, the ranks 0..J_fix-1 dealt out among
    the shards' slots in ascending order per shard (the rest: J_fix), and
    Or, Er, Pr_b."""
    rng = np.random.default_rng(seed)
    K, B = 7, 3
    owner = np.sort(rng.permutation(np.repeat(np.arange(shards), Js))[
        :J_fix])
    granks = np.full((shards, Js), J_fix, np.int32)
    for s in range(shards):
        mine = np.flatnonzero(owner == s)
        granks[s, : mine.size] = mine
    rows = rng.normal(size=(shards, Js, K, B + 1)).astype(np.float32) * 50
    Or = rng.uniform(1, 900, size=(K, B)).astype(np.float32)
    Er = rng.uniform(1, 900, size=(K, B)).astype(np.float32)
    Pr_b = rng.dirichlet(np.ones(B)).astype(np.float32)
    return rows, granks, Or, Er, Pr_b


@pytest.mark.parametrize("shards,J_fix,Js", [(2, 11, 7), (4, 22, 7),
                                             (4, 9, 4)])
def test_frame_readd_equals_jax_block_readd(shards, J_fix, Js):
    """frame_readd (the re-add kernel's plain version and the CPU path)
    against the JAX package's _block_readd
    (ops/update_r_fused_xla.py:104-114) under shard_map on as many virtual
    CPU devices: the frame sums (O' = E' = 0, Pr_b = 1) and O bit for bit,
    and E bit for bit with Pr_b = 1. With another Pr_b XLA:CPU contracts
    E' + sum0 * Pr_b into one fused multiply-add, while the port rounds the
    product first, as its one-launch kernel does (the 1 == N contract on
    the card): there E is within one ulp of JAX's, and equal to the
    separately rounded value of JAX's own frame sum."""
    rows, granks, Or, Er, Pr_b = _frame_case(shards, J_fix, Js, shards + J_fix)
    geom = types.SimpleNamespace(J_fix=J_fix)
    f = jax.jit(jax.shard_map(
        lambda O, E, st, g, p: _block_readd(O, E, st, g, p, geom, J_AXIS),
        mesh=jax_mesh(n_devices=shards),
        in_specs=(P(), P(), P(J_AXIS), P(J_AXIS), P()), out_specs=(P(), P()),
        check_vma=False))
    zero, one = np.zeros_like(Or), np.ones_like(Pr_b)
    for o, e, prb in ((zero, zero, one), (Or, Er, one), (Or, Er, Pr_b)):
        Oj, Ej = (np.asarray(x) for x in f(
            jnp.asarray(o), jnp.asarray(e),
            jnp.asarray(rows.reshape(-1, *rows.shape[2:])),
            jnp.asarray(granks.reshape(-1)), jnp.asarray(prb)))
        args = ([torch.as_tensor(r) for r in rows],
                [torch.as_tensor(g) for g in granks],
                *(torch.as_tensor(x) for x in (o, e, prb)), J_fix)
        O, E = (x.numpy() for x in frame_readd(*args))
        np.testing.assert_array_equal(O, Oj)
        if prb is one:
            np.testing.assert_array_equal(E, Ej)
        else:
            np.testing.assert_array_max_ulp(E, Ej, maxulp=1)
            np.testing.assert_array_equal(
                E, e + (sum0 * prb[None, :]).astype(np.float32))
        if o is zero:
            sum0 = Ej[:, :1]                    # JAX's frame sum, column 0


def _old_real_cols(xs, cfg):
    """The gather of every real column to the lead device that k-means
    init used before it gathered its sample only."""
    q = cfg.N_shard_real
    return torch.cat([x[:, : max(0, min(q, cfg.N - s * q))]
                      for s, x in enumerate(xs)], dim=1)


@pytest.mark.parametrize("shards", [2, 4])
def test_kmeans_sample_from_owners_equals_real_cols_gather(shards):
    """parallel.sharding.gather_cols copies each sampled column from the
    shard that owns it: the old (d, N) gather's columns bit for bit, and
    one device's."""
    rng = np.random.default_rng(shards)
    N, d = 5000, 6
    X = rng.normal(size=(d, N)).astype(np.float32)
    cfg = EngineConfig(N=N, d=d, K=12, B=2, n_devices=shards,
                       use_fused_xla=True, chunk_size=128)
    mesh = make_mesh(["cpu"] * shards)
    xs = sharding.split_cells(torch.as_tensor(sharding.pad_cells(X, cfg)),
                              cfg, mesh)
    gen = torch.Generator()
    gen.manual_seed(shards)
    ids = torch.randint(0, N, (1500,), generator=gen)
    got = sharding.gather_cols(xs, ids, cfg)
    assert torch.equal(got, _old_real_cols(xs, cfg)[:, ids])
    cfg1 = sharding.one_device(cfg)
    one = torch.as_tensor(sharding.pad_cells(X, cfg1))
    assert torch.equal(sharding.gather_cols(one, ids, cfg1), got)


class _Widths(torch.utils._python_dispatch.TorchDispatchMode):
    """Records every op whose result has a dimension in `banned`."""

    def __init__(self, banned):
        super().__init__()
        self.banned, self.seen, self.ops = set(banned), [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and self.banned & set(t.shape):
                self.seen.append((str(func), tuple(t.shape)))
        return out


@pytest.mark.parametrize("kw", [{}, dict(defer_r=False)])
def test_no_shard_holds_one_device_width_or_all_cells(monkeypatch, kw):
    """During a 4-shard fit (deferred, stored) no tensor has a dimension of
    the one-device width (padded, or its real chunks) or of all N cells:
    the cell inputs run in windows of chunks (5 chunks here: at this size
    the default window would span every chunk) and k-means init gathers
    its sample (1,000 cells) only."""
    X, meta = _problem()
    fit, seen = engine.fit, {}
    width = replay.window_width
    monkeypatch.setattr(replay, "window_width",
                        lambda cfg, *a: min(5, width(cfg, *a)))

    def guarded(data, params, cfg, *a, **k):
        cfg = dataclasses.replace(cfg, kmeanspp_sample=1000)
        one = sharding.one_device(cfg)
        banned = (one.N_pad, cfg.N, cdiv(cfg.N, 128) * 128)
        assert cfg.n_devices == 4 and cfg.N_local not in banned
        assert replay.windows(one)[0][1] == 5
        with _Widths(banned) as mode:
            torch.zeros((2, banned[0]))          # the guard sees one
            st = fit(data, params, cfg, *a, **k)
        seen.update(found=mode.seen, ops=mode.ops)
        return st

    monkeypatch.setattr(engine, "fit", guarded)
    ht.run_harmony(X, meta, ["batch"], mesh=make_mesh(["cpu"] * 4),
                   **{**FIT, **kw})
    assert seen["ops"] > 1000
    assert seen["found"] == [("aten.zeros.default", (2, 6144))]


@pytest.mark.parametrize("N,d,B", [(858_000, 29, 3), (5_000_000, 50, 6)])
@pytest.mark.parametrize("kw", [dict(defer_r=True), dict(defer_r=False),
                                dict(defer_r=False, r_dtype="bfloat16")])
def test_memory_model_per_card_falls_with_the_mesh(N, d, B, kw):
    """memory_envelope per card (one shard each) falls as the shard count
    rises, and no term of it grows with the total N at a fixed number of
    cells per shard (the k-means gather and the one-device-wide cell
    arrays are gone)."""
    def env(n, cells=N):
        return memory_envelope(EngineConfig(
            N=cells, d=d, K=100, B=B, n_devices=n, use_fused_xla=True,
            **kw), 1)
    totals = [env(n)["total"] for n in (1, 2, 4, 8)]
    assert all(a > b for a, b in zip(totals, totals[1:])), totals
    a, b = env(8, 4 * N), env(16, 8 * N)
    for part in ("persistent", "phases"):
        for name, v in a[part].items():
            assert b[part][name] <= v, (part, name, v, b[part][name])


@pytest.mark.parametrize("n_dev", [2, 4])
def test_mesh_pass_checks_inputs_once_per_shard(monkeypatch, n_dev):
    """fused_estep_mesh checks each shard's inputs once per pass, whatever
    the blocks: n_dev checks for a round of nb blocks, and a mesh fit
    n_dev per E-step pass."""
    X, meta = _problem()
    g1, g, _, tabs, ZP3s, common = _round_inputs(n_dev, X, meta)
    assert g.nb > 1
    check, calls = fe._check_round, []

    def counted(*a):
        calls.append(1)
        return check(*a)
    monkeypatch.setattr(fe, "_check_round", counted)
    fe.fused_estep_mesh(tabs, ZP3s, *common, False, g.J_fix)
    assert len(calls) == n_dev
    calls.clear()
    ho = ht.run_harmony(X, meta, ["batch"], mesh=make_mesh(["cpu"] * n_dev),
                        **FIT)
    assert len(calls) == n_dev * ho.state.n_passes


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_readd_kernel_equals_frame_readd_on_the_card(cuda_device):
    """The re-add kernel (one launch) against its plain version on the
    same card tensors, bit for bit."""
    rows, granks, Or, Er, Pr_b = _frame_case(4, 22, 7, 0)

    def t(x):
        return torch.as_tensor(x, device=cuda_device)
    args = ([t(r) for r in rows], [t(g) for g in granks], t(Or), t(Er),
            t(Pr_b), 22)
    O, E = torch.empty_like(args[2]), torch.empty_like(args[3])
    n0 = fe.launches_readd
    fe._Readd(args[0], [g.reshape(1, -1) for g in args[1]], *args[2:], O,
              E).launch(0)
    assert fe.launches_readd == n0 + 1
    Op, Ep = frame_readd(*args)
    assert torch.equal(O, Op) and torch.equal(E, Ep)


def _tables_on(tabs, devices):
    return tabs._replace(
        slots=[s.to(dv) for s, dv in zip(tabs.slots, devices)],
        granks=[g.to(dv) for g, dv in zip(tabs.granks, devices)],
        removal=tabs.removal.to(devices[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["round", "r_window", "float32"])
def test_mesh_of_cards_with_lead_not_current_equals_one_card(cuda_device,
                                                             kind):
    """fused_estep_mesh on two cards whose lead is not the current device
    (shard 0 on cuda:1; shard 1, and the current device, cuda:0) equals the
    same round on two logical shards of cuda:0 bit for bit: O, E, the
    per-chunk rows, the r windows and the stored R (the streams, events
    and copies between cards order every shard's launch)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    X, meta = _problem()
    g1, g, _, tabs, ZP3s, common = _round_inputs(2, X, meta)
    fast = kind == "r_window"
    lo, width = 5, 9
    wins = ([(lo - s * g.nc_cap, width)
             if sharding.window_rows(g, s, lo, width)[2] else None
             for s in range(2)] if fast else None)
    got = []
    for devs in ([torch.device("cuda:0")] * 2,
                 [torch.device("cuda:1"), torch.device("cuda:0")]):
        torch.cuda.set_device(0)
        R3s = (None if kind in ("round", "r_window") else
               [torch.zeros((g.nc_cap + 1, 12, g.CH), device=dv)
                for dv in devs])
        out = fe.fused_estep_mesh(
            _tables_on(tabs, devs), [z.to(dv) for z, dv in zip(ZP3s, devs)],
            *(c.to(devs[0]) for c in common), fast, g.J_fix, windows=wins,
            R3s=R3s)
        got.append([t.cpu() for t in (*out[:2], *out[2], *out[3], *out[4],
                                      *(r for r in out[5] if r is not None),
                                      *(R3s or ()))])
    assert len(got[0]) == len(got[1])
    for a, b in zip(*got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_dev", [1, 4])
def test_stored_fit_equals_deferred_fit_bitwise(n_dev):
    """With every round run, the stored fused fit equals the deferred fit
    bit for bit, on one shard and on four: the stored ridge runs the
    replays' window functions on the stored r (K2's r is K1's bitwise), and
    both paths normalise each cell in one order (chip_smoke.py's phase
    fit_stored holds the two at the JAX package's 2e-4 at 858k)."""
    X, meta = _problem()
    kw = dict(FIT, epsilon_cluster=0, epsilon_harmony=-1)
    mesh = make_mesh(["cpu"] * n_dev)
    de = ht.run_harmony(X, meta, ["batch"], mesh=mesh, **kw)
    st = ht.run_harmony(X, meta, ["batch"], mesh=mesh, defer_r=False, **kw)
    assert de.cfg.defer_r and not st.cfg.defer_r
    assert st.kmeans_rounds == de.kmeans_rounds == [20, 20]
    np.testing.assert_array_equal(st.Z_corr, de.Z_corr)
    np.testing.assert_array_equal(st.R, de.R)
