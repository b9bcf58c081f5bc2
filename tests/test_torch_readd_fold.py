"""The mesh re-add folded into the next block's per-block launch.

On the CPU: its plain version (`fused_update_block_folded`: frame_readd of
block b - 1, then fused_update_block of block b) against the JAX package's
`_block_readd` followed by `_block_core` under shard_map on its CPU mesh;
the shared rank table against the table the re-add built before; the
folded chain over a whole pass against mesh_round; the per-block launch's
checks of a folded start. On the card: the folded launch of every block
b > 0 of a 4-shard pass against frame_readd plus the unfolded launch, bit
for bit, and a mesh pass's re-add launched once."""

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

from harmonypy_tpu.ops.update_r_fused_xla import (_block_core, _block_readd,
                                                  _block_stats)
from harmonypy_tpu.parallel.mesh import AXIS as J_AXIS
from harmonypy_tpu.parallel.mesh import make_mesh as jax_mesh
from harmonypy_tpu_torch.ops.cuda import fused_estep as fe
from harmonypy_tpu_torch.ops.update_r_fused import (frame_readd,
                                                    fused_update_block_folded,
                                                    mesh_round)
from test_torch_mesh import _problem, _round_inputs

K, B, D, CH = 7, 3, 5, 16
B1 = B + 1


def _fold_case(shards, J_fix, Js, seed):
    """One block b's inputs on `shards` shards, and block b - 1's: every
    shard's rows of block b - 1 (positive stats) with their ranks 0..J_fix-1
    dealt out in ascending order per shard (the rest: J_fix), the
    block-removed Or, Er after it; block b's removal and, per shard, a slab
    of Js + 1 chunks (the last the zero dummy) and its Js slots."""
    rng = np.random.default_rng(seed)
    owner = np.sort(rng.permutation(np.repeat(np.arange(shards), Js))[
        :J_fix])
    granks = np.full((shards, Js), J_fix, np.int32)
    for s in range(shards):
        mine = np.flatnonzero(owner == s)
        granks[s, : mine.size] = mine
    rows = rng.uniform(0, 20, size=(shards, Js, K, B1)).astype(np.float32)
    Or = rng.uniform(200, 900, size=(K, B)).astype(np.float32)
    Er = rng.uniform(200, 900, size=(K, B)).astype(np.float32)
    rem = rng.uniform(0, 50, size=(K, B1)).astype(np.float32)
    nc1 = Js + 1
    zp3 = np.zeros((shards, nc1, 1 + B + D, CH), np.float32)
    z = rng.normal(size=(shards, Js, D, CH))
    zp3[:, :Js, 0] = 1.0
    zp3[:, :Js, 1 + B:] = z / np.linalg.norm(z, axis=2, keepdims=True)
    lvl = rng.integers(0, B, size=(shards, Js, CH))
    for b in range(B):
        zp3[:, :Js, 1 + b] = lvl == b
    slots = np.stack([rng.permutation(nc1)[:Js] for _ in range(shards)])
    slots = slots.astype(np.int32)
    y = rng.normal(size=(D, K))
    Y = (y / np.linalg.norm(y, axis=0)).astype(np.float32)
    sigma = np.full(K, 0.1, np.float32)
    theta = np.full(B, 2.0, np.float32)
    return rows, granks, Or, Er, rem, zp3, slots, Y, sigma, theta


def _jax_readd_then_core(shards, J_fix):
    geom = types.SimpleNamespace(J_fix=J_fix)

    def body(Or, Er, st, g, prb, rem, sl, zp3, Y, sig, th):
        O, E = _block_readd(Or, Er, st, g, prb, geom, J_AXIS)
        O, E, r, gg, *_ = _block_core(O, E, rem, sl, zp3, Y, sig, th, prb)
        return (O, E) + _block_stats(r, gg, B1)

    rep, sh = P(), P(J_AXIS)
    return jax.jit(jax.shard_map(
        body, mesh=jax_mesh(n_devices=shards),
        in_specs=(rep, rep, sh, sh, rep, rep, sh, sh, rep, rep, rep),
        out_specs=(rep, rep, sh, sh), check_vma=False))


@pytest.mark.parametrize("shards,J_fix,Js", [
    (1, 5, 6), (1, 12, 13), (2, 6, 4), (2, 11, 7), (4, 9, 4), (4, 22, 7)])
def test_folded_plain_entry_equals_jax_readd_then_block_core(shards, J_fix,
                                                            Js):
    """fused_update_block_folded on every shard against the JAX package's
    _block_readd (ops/update_r_fused_xla.py:104-114) then _block_core
    (:57-87) and _block_stats under shard_map on as many CPU devices.
    Tolerances: the block-removed O bit for bit; E bit for bit with
    Pr_b = 1 and within 2 ulp with another Pr_b (XLA:CPU contracts
    E' + sum0 Pr_b and E - rem0 Pr_b into fused multiply-adds, the port
    rounds each product first, as its kernels do: the 1 == N contract on
    the card); the slots' stats (r from exp and two contractions, in
    torch's and XLA's orders) to 1e-5 relative, 1e-6 absolute, as the
    round's cache is held against the Pallas kernel
    (test_torch_fused_estep.py)."""
    rows, granks, Or, Er, rem, zp3, slots, Y, sigma, theta = _fold_case(
        shards, J_fix, Js, 10 * shards + J_fix)
    f = _jax_readd_then_core(shards, J_fix)
    rng = np.random.default_rng(J_fix)
    for prb in (np.ones(B, np.float32),
                rng.dirichlet(np.ones(B)).astype(np.float32)):
        ins = (Or, Er, rows.reshape(-1, K, B1), granks.reshape(-1), prb,
               rem, slots.reshape(-1), zp3.reshape(-1, *zp3.shape[2:]), Y,
               sigma, theta)
        Oj, Ej, stj, ykj = (np.asarray(x)
                            for x in f(*(jnp.asarray(x) for x in ins)))
        t = torch.as_tensor
        prev = ([t(r) for r in rows], [t(g) for g in granks], J_fix)
        for s in range(shards):
            out = (torch.zeros((Js + 1, K, B1)), torch.zeros((Js + 1, K, D)),
                   torch.zeros((Js + 1, 2)))
            O, E = (x.numpy() for x in fused_update_block_folded(
                0, t(slots[s][None]), t(rem[None]), t(zp3[s]), t(Y),
                t(sigma), t(theta), t(prb), t(Or), t(Er), False, out,
                prev=prev))
            np.testing.assert_array_equal(O, Oj)
            if (prb == 1).all():
                np.testing.assert_array_equal(E, Ej)
            else:
                np.testing.assert_array_max_ulp(E, Ej, maxulp=2)
            sl = slots[s].astype(np.int64)
            got = np.concatenate([out[0][sl].numpy(), out[1][sl].numpy()],
                                 axis=2)
            want = np.concatenate([stj, ykj], axis=2)[s * Js:(s + 1) * Js]
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _old_readd_table(granks, J_fix, jmax):
    """The rank table the re-add built in its own constructor before the
    per-block launches shared it."""
    nb = granks[0].shape[0]
    src = torch.full((nb, J_fix + 1), -1, dtype=torch.int32)
    for s, g in enumerate(granks):
        code = s * jmax + torch.arange(g.shape[1], dtype=torch.int32)
        src.scatter_(1, g.to(torch.int64).clamp_(0, J_fix),
                     code.expand(nb, -1).contiguous())
    return src


@pytest.mark.parametrize("shards,J_fix,Js,nb", [
    (1, 5, 6, 3), (2, 11, 7, 4), (4, 22, 7, 5), (4, 9, 4, 2)])
def test_rank_table_equals_old_readd_table(shards, J_fix, Js, nb):
    """fe.rank_table equals the table _Readd built before, and decodes:
    rank r of block b is held by shard code // jmax, slot code % jmax, or
    by no shard (-1)."""
    rng = np.random.default_rng(shards + J_fix + nb)
    granks = []
    for _ in range(nb):
        owner = np.sort(rng.permutation(np.repeat(np.arange(shards), Js))[
            :J_fix])
        g = np.full((shards, Js), J_fix, np.int32)
        for s in range(shards):
            mine = np.flatnonzero(owner == s)
            g[s, rng.permutation(Js)[: mine.size]] = mine
        granks.append(g)
    granks = [torch.as_tensor(np.stack([g[s] for g in granks]))
              for s in range(shards)]
    src = fe.rank_table(granks, J_fix, Js, "cpu")
    assert src.dtype == torch.int32 and tuple(src.shape) == (nb, J_fix + 1)
    assert torch.equal(src[:, :J_fix], _old_readd_table(granks, J_fix,
                                                        Js)[:, :J_fix])
    for b in range(nb):
        held = {}
        for s, g in enumerate(granks):
            for j, r in enumerate(g[b].tolist()):
                if r < J_fix:
                    held[r] = s * Js + j
        assert src[b, :J_fix].tolist() == [held.get(r, -1)
                                           for r in range(J_fix)]


@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("kind", ["round", "bfloat16"])
def test_folded_chain_equals_mesh_round(n_dev, kind):
    """A pass run as the kernels run it, block 0 from O, E and every block
    b > 0 by fused_update_block_folded from block b - 1's block-removed
    O', E' and rows, then one frame_readd of the last block, equals
    mesh_round bit for bit: O, E, the per-chunk rows and the stored R."""
    X, meta = _problem()
    g1, g, _, tabs, ZP3s, common = _round_inputs(n_dev, X, meta)
    Y, sigma, theta, Pr_b, O, E = common
    nb, J = tabs.slots[0].shape
    pad = g.J_fix + 1 - J      # CPU shards run the one-device width
    def r3s():
        return ([torch.zeros((g.nc_cap + 1, 12, g.CH), dtype=torch.bfloat16)
                 for _ in range(n_dev)] if kind == "bfloat16" else None)
    R3s, ref_R3s = r3s(), r3s()
    ref = mesh_round(tabs, ZP3s, *common, False, g.J_fix, R3s=ref_R3s)
    slots = [torch.cat([s, s.new_full((nb, pad), z.shape[0] - 1)], 1)
             for s, z in zip(tabs.slots, ZP3s)]
    granks = [torch.cat([gr, gr.new_full((nb, pad), g.J_fix)], 1)
              for gr in tabs.granks]
    outs = [(torch.zeros((z.shape[0], 12, B1)),
             torch.zeros((z.shape[0], 12, Y.shape[0])),
             torch.zeros((z.shape[0], 2))) for z in ZP3s]
    prev, Ob, Eb = None, O, E
    for b in range(nb):
        res = [fused_update_block_folded(
            b, slots[s], tabs.removal, ZP3s[s], Y, sigma, theta, Pr_b, Ob,
            Eb, False, outs[s], prev=prev,
            R3=None if R3s is None else R3s[s]) for s in range(n_dev)]
        Ob, Eb = res[0]
        assert all(torch.equal(o, Ob) and torch.equal(e, Eb) for o, e in res)
        prev = ([outs[s][0][slots[s][b].long()] for s in range(n_dev)],
                [gr[b] for gr in granks], g.J_fix)
    O2, E2 = frame_readd(prev[0], prev[1], Ob, Eb, Pr_b, g.J_fix)
    assert torch.equal(O2, ref[0]) and torch.equal(E2, ref[1])
    for got, want in zip(zip(*outs), ref[2:5]):
        assert all(torch.equal(a, w) for a, w in zip(got, want))
    if R3s is not None:
        assert all(torch.equal(a, w) for a, w in zip(R3s, ref_R3s))


def test_block_launch_refuses_a_start_without_a_previous_block():
    """_BlockLaunch.launch(b, readd_prev=True) needs b > 0 and a frame:
    both refused before any launch (here on CPU tensors, which prepare
    nothing to launch)."""
    X, meta = _problem()
    g1, g, (slots1, removal, ZP3), tabs, ZP3s, common = _round_inputs(
        2, X, meta)
    nc1 = ZP3s[0].shape[0]
    out = (torch.zeros((nc1, 12, B1)), torch.zeros((nc1, 12, X.shape[1])),
           torch.zeros((nc1, 2)))
    ln = fe._BlockLaunch(tabs.slots[0], tabs.removal, ZP3s[0], *common,
                         False, out, g.J_fix + 1)
    for b in (0, 1):
        with pytest.raises(ValueError, match="cannot start from"):
            ln.launch(b, readd_prev=True)
    J = tabs.slots[0].shape[1]
    frame = torch.zeros((2, 2, J, 12, B1))
    src = fe.rank_table(tabs.granks, g.J_fix, J, "cpu")
    folds = fe._BlockLaunch(tabs.slots[0], tabs.removal, ZP3s[0], *common,
                            False, out, g.J_fix + 1, frame=frame, src=src,
                            J_fix=g.J_fix)
    with pytest.raises(ValueError, match="cannot start from"):
        folds.launch(0, readd_prev=True)
    with pytest.raises(ValueError, match="parity copy"):
        fe._BlockLaunch(tabs.slots[0], tabs.removal, ZP3s[0], *common,
                        False, out, g.J_fix + 1, frame=_strided(frame),
                        src=src, J_fix=g.J_fix)


def _strided(frame):
    """frame's values with each parity copy not contiguous."""
    return frame.transpose(3, 4).contiguous().transpose(3, 4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["round", "float32", "bfloat16"])
def test_folded_launch_equals_readd_then_launch_on_the_card(cuda_device,
                                                             kind):
    """On 4 shards of one card, every block b > 0 launched from block
    b - 1's re-add in its prologue equals frame_readd of block b - 1 then
    the unfolded launch, bit for bit: the block-removed O, E, the block's
    rows, and after the pass the per-chunk rows and the stored R. A mesh
    pass launches the re-add kernel once and gives the same O, E."""
    X, meta = _problem()
    g1, g, _, tabs, ZP3s, common = _round_inputs(4, X, meta)
    cd = cuda_device
    tabs = tabs._replace(slots=[s.to(cd) for s in tabs.slots],
                         granks=[r.to(cd) for r in tabs.granks],
                         removal=tabs.removal.to(cd))
    ZP3s = [z.to(cd) for z in ZP3s]
    common = [c.to(cd) for c in common]
    Y, sigma, theta, Pr_b, O, E = common
    nb, J = tabs.slots[0].shape

    def outs():
        return [(torch.zeros((z.shape[0], 12, B1), device=cd),
                 torch.zeros((z.shape[0], 12, Y.shape[0]), device=cd),
                 torch.zeros((z.shape[0], 2), device=cd)) for z in ZP3s]

    def r3s():
        if kind == "round":
            return [None] * 4
        return [torch.zeros((g.nc_cap + 1, 12, g.CH),
                            dtype=getattr(torch, kind), device=cd)
                for _ in ZP3s]
    frame = torch.empty((2, 4, J, 12, B1), device=cd)
    src = fe.rank_table(tabs.granks, g.J_fix, J, cd)
    of, orf, rf, rr = outs(), outs(), r3s(), r3s()
    fold = [fe._BlockLaunch(tabs.slots[s], tabs.removal, ZP3s[s], *common,
                            False, of[s], g.J_fix + 1, R3=rf[s],
                            brows=frame[:, s], frame=frame, src=src,
                            J_fix=g.J_fix) for s in range(4)]
    start = torch.stack([O, E])
    ref = [fe._BlockLaunch(tabs.slots[s], tabs.removal, ZP3s[s], Y, sigma,
                           theta, Pr_b, start[0], start[1], False, orf[s],
                           g.J_fix + 1, R3=rr[s]) for s in range(4)]
    for b in range(nb):
        for s in range(4):
            fold[s].launch(b, b > 0)
            ref[s].launch(b)
        for s in range(4):
            assert all(torch.equal(x, y) for x, y in zip(
                fold[s].removed(b), ref[s].removed(b))), (b, s)
            assert torch.equal(frame[b & 1, s], ref[s].brows[b & 1]), (b, s)
        start.copy_(torch.stack(frame_readd(
            [ln.brows[b & 1] for ln in ref], [r[b] for r in tabs.granks],
            *ref[0].removed(b), Pr_b, g.J_fix)))
    for a, w in zip(of + [rf], orf + [rr]):
        assert all(x is None and y is None or torch.equal(x, y)
                   for x, y in zip(a, w))
    n0 = fe.launches_readd
    m = fe.fused_estep_mesh(tabs, ZP3s, *common, False, g.J_fix,
                            R3s=None if kind == "round" else r3s())
    assert fe.launches_readd == n0 + 1
    assert torch.equal(m[0], start[0]) and torch.equal(m[1], start[1])
