"""The per-block entry's schedule, on the Python side: the work split and
the cluster geometry its bits rest on, a model of the spread slot sums
(cluster_tail) against the last-unit sums (block_tail), the stamped
entry's names and decoding, and the on-demand build of its library. On a
CUDA card only: the cluster and ticket tails give the same bits."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from harmonypy_tpu_torch import config
from harmonypy_tpu_torch.ops import partition
from harmonypy_tpu_torch.ops.cuda import block_timing as bt
from harmonypy_tpu_torch.ops.cuda import build
from harmonypy_tpu_torch.ops.cuda import fused_estep as fe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "harmonypy_tpu_torch", "csrc")
CUH = os.path.join(CSRC, "fused_estep.cuh")


def _geometry(N, d, K, B, CH, shards):
    cfg = config.EngineConfig(N=N, d=d, K=K, B=B, n_devices=shards,
                              use_fused_xla=True, defer_r=True,
                              chunk_size=CH)
    return partition.partition_geometry(cfg)


def test_block_split_pinned_at_858k_on_4_shards():
    # The reference README's workload on 4 shards of an H100 (132 SMs): a
    # shard's block is 7 slots of 12 units (the one-device round's split,
    # J_glob 22), 84 CTAs in 7 clusters of 12.
    g = _geometry(858_000, 29, 100, 3, 2048, 4)
    assert (g.J_shard, g.J_fix + 1, g.nc_cap) == (7, 22, 105)
    geo = fe.kernel_geometry(100, 3, 29, 2048, g.J_shard, 132, g.J_fix + 1)
    assert (geo.tiles, geo.ng, geo.n_units) == (32, 12, 84)
    assert fe.block_tail(geo.ng) == "cluster"
    # Runs of 2 or 3 tiles, the round's: 4 of each slot's 12 units have 2.
    tiles = [geo.unit_tiles(u)[2] - geo.unit_tiles(u)[1]
             for u in range(geo.ng)]
    assert tiles == [2, 3, 3, 2, 3, 3, 2, 3, 3, 2, 3, 3]
    # The same split as the one-device round (ng from J_glob, not J).
    assert fe.kernel_geometry(100, 3, 29, 2048, 22, 132).ng == geo.ng


# chip_smoke.SHAPES run through the per-block entry on their one-device
# table: (N, d, K, B, CH) and the (J, ng, tail) they give.
SHAPES = [((6_000, 5, 7, 1, 128), (4, 2, "cluster")),
          ((6_000, 30, 100, 3, 128), (4, 2, "cluster")),
          ((45_000, 5, 200, 1, 2048), (3, 32, "ticket")),
          ((45_000, 50, 7, 3, 2048), (3, 32, "ticket")),
          ((6_000, 5, 100, 5, 128), (4, 2, "cluster")),
          ((45_000, 50, 200, 5, 2048), (3, 32, "ticket")),
          ((6_000, 30, 280, 3, 128), (4, 2, "cluster"))]


@pytest.mark.parametrize("shape,want", SHAPES)
def test_block_tail_pinned_at_phase_shapes(shape, want):
    N, d, K, B, CH = shape
    J = _geometry(*shape, 1).J_shard
    geo = fe.kernel_geometry(K, B, d, CH, J, 132, J)
    assert (J, geo.ng, fe.block_tail(geo.ng)) == want


@pytest.mark.parametrize("ng,want", [(1, "cluster"), (8, "cluster"),
                                     (12, "cluster"), (16, "cluster"),
                                     (17, "ticket"), (32, "ticket")])
def test_block_tail_rule(ng, want):
    assert fe.block_tail(ng) == want
    assert fe.BLOCK_TAILS == ("cluster", "ticket")


def test_cluster_limit_matches_the_kernel():
    src = open(CUH).read()
    m = re.search(r"constexpr int CLUSTER_MAX = (\d+);", src)
    assert int(m[1]) == fe.CLUSTER_MAX == 16
    blk = open(os.path.join(CSRC, "fused_estep_block.cu")).read()
    assert "(a.tickets == nullptr && a.ng > CLUSTER_MAX)" in blk


# --- A model of the two tails on one slot's unit partials ---------------


def _partials(ng, K, R, seed):
    rng = np.random.default_rng(seed)
    # Magnitudes far apart, so that any other order of the adds rounds
    # differently.
    scale = 10.0 ** rng.integers(-4, 5, (ng, K, R))
    return (rng.standard_normal((ng, K, R)) * scale).astype(np.float32)


def _ordered(vals):
    """Sum from 0 in the order given, each add rounded to float32."""
    s = np.float32(0.0)
    for v in vals:
        s = np.float32(s + v)
    return s


def ticket_tail(P, B1, d):
    """block_tail: the last unit's CTA sums each entry over the units with
    slot_sum (loads in batches of 16, added in ascending unit order)."""
    ng, K, R = P.shape
    cache = np.zeros((K, B1), np.float32)
    ybuf = np.zeros((K, d), np.float32)

    def slot_sum(k, x):
        s = np.float32(0.0)
        for q0 in range(0, ng, 16):
            batch = [P[q, k, x] for q in range(q0, min(ng, q0 + 16))]
            for v in batch:
                s = np.float32(s + v)
        return s
    for item in range(K * B1):
        cache[item // B1, item % B1] = slot_sum(item // B1, item % B1)
    for i in range(K * d):
        ybuf[i // d, i % d] = slot_sum(i // d, B1 + i % d)
    return cache, ybuf


def cluster_tail(P, B1, d):
    """cluster_tail: rank q of the slot's cluster sums rows
    [q K / ng, (q + 1) K / ng) of the slot's S, four adjacent entries of a
    row at a time (one 16-byte load from each unit's S tile, in batches of
    UB units), each entry's values added in ascending unit order from
    zero; entries past the row's 1 + B + d (the tile's padding) are not
    written. Returns the rows and which rank wrote each row."""
    ng, K, R = P.shape
    PSA = -(-R // 8) * 8 + 8            # a padded pitch, a multiple of 4
    S = np.zeros((ng, K, PSA), np.float32)
    S[:, :, :R] = P
    cache = np.zeros((K, B1), np.float32)
    ybuf = np.zeros((K, d), np.float32)
    owner = np.full(K, -1)
    for q in range(ng):
        for k in range(q * K // ng, (q + 1) * K // ng):
            assert owner[k] == -1
            owner[k] = q
            for c in range(0, PSA, 4):
                acc = np.zeros(4, np.float32)
                for r0 in range(0, ng, 8):          # UB units at once
                    for v in [S[r, k, c:c + 4]
                              for r in range(r0, min(ng, r0 + 8))]:
                        acc = (acc + v).astype(np.float32)
                for h in range(4):
                    col = c + h
                    if col < B1:
                        cache[k, col] = acc[h]
                    elif col < R:
                        ybuf[k, col - B1] = acc[h]
    return cache, ybuf, owner


@pytest.mark.parametrize("ng,K,B,d", [(12, 100, 3, 29), (2, 7, 1, 5),
                                      (16, 20, 5, 50), (1, 9, 2, 3),
                                      (7, 30, 3, 30)])
def test_spread_tail_sums_in_ascending_unit_order(ng, K, B, d):
    B1 = B + 1
    P = _partials(ng, K, B1 + d, seed=ng * 1000 + K)
    tc, ty = ticket_tail(P, B1, d)
    cc, cy, owner = cluster_tail(P, B1, d)
    # Every row written once, by one rank, the ranks' shares within one
    # row of each other.
    assert (owner >= 0).all()
    counts = np.bincount(owner, minlength=ng)
    assert counts.max() - counts.min() <= 1
    # The same bits as the last unit's sums, and as the plain ascending
    # order from zero.
    assert np.array_equal(cc.view(np.int32), tc.view(np.int32))
    assert np.array_equal(cy.view(np.int32), ty.view(np.int32))
    plain = np.zeros_like(P[0])
    for q in range(ng):
        plain = (plain + P[q]).astype(np.float32)
    assert np.array_equal(cc.view(np.int32),
                          plain[:, :B1].view(np.int32))
    assert np.array_equal(cy.view(np.int32),
                          plain[:, B1:].view(np.int32))


def test_other_orders_round_differently():
    # The model's data tells orders apart: descending unit order does not
    # give the ascending sums' bits.
    P = _partials(12, 100, 33, seed=1)
    asc = np.zeros_like(P[0])
    for q in range(12):
        asc = (asc + P[q]).astype(np.float32)
    desc = np.zeros_like(P[0])
    for q in reversed(range(12)):
        desc = (desc + P[q]).astype(np.float32)
    assert not np.array_equal(asc, desc)


def test_cluster_tail_in_the_kernel_follows_the_model():
    src = open(CUH).read()
    body = src[src.index("__device__ void cluster_tail"):]
    body = body[:body.index("\n}\n")]
    # The model's split (rows by rank) and order (16-byte loads of UB
    # units, added in ascending unit order from zero); kbuf on rank 0; a
    # barrier before the sums and one before exit.
    assert "const int k0 = q * K / ng, k1 = (q + 1) * K / ng;" in body
    assert "float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);" in body
    assert "for (int r0 = 0; r0 < ng; r0 += UB) {" in body
    assert "acc.x = __fadd_rn(acc.x, v[r].x);" in body
    assert "if (q == 0) {" in body
    assert body.count("cl.sync();") == 2
    assert re.search(r"constexpr int UB = 8;", src)


# --- The stamped per-block entry -----------------------------------------


def _kernel_names():
    src = open(CUH).read()
    nst = int(re.search(r"constexpr int NST = (\d+);", src)[1])
    maxt = int(re.search(r"constexpr int MAXT = (\d+);", src)[1])
    body = re.search(r"BLOCK_STAMP_NAMES =\s*((?:\"[^\"]*\"\s*)+);", src)[1]
    names = "".join(re.findall(r"\"([^\"]*)\"", body)).split(",")
    return nst, maxt, names, src


def test_block_stamp_names_match_the_kernel_layout():
    nst, maxt, names, src = _kernel_names()
    assert len(names) == nst
    assert names[:3] == ["setup", "fold", "prologue"]
    tiles = [f"t{i}_{k}" for i in range(maxt)
             for k in ("ready", "pass1", "pass2", "S")]
    assert names[3:3 + 4 * maxt] == tiles
    assert names[3 + 4 * maxt:] == ["partial", "wait_slot", "sum_kbuf",
                                    "sum_cache", "sum_ybuf"]
    # The stamp indices the kernel writes: SB_* share the round's ST_*.
    m = re.search(r"enum \{ SB_SETUP = ST_START, SB_FOLD = ST_WAIT, "
                  r"SB_SLOT = ST_ARRIVE,\s+SB_KBUF, SB_CACHE, SB_YBUF \};",
                  src)
    assert m
    st = re.search(r"ST_START = 0, ST_WAIT = 1, ST_PRO = 2, ST_TILE = 3,\s+"
                   r"ST_PART = ST_TILE \+ 4 \* MAXT, ST_ARRIVE", src)
    assert st
    part = 3 + 4 * maxt
    assert names.index("partial") == part
    assert names.index("wait_slot") == part + 1   # ST_ARRIVE
    assert names.index("sum_ybuf") == nst - 1
    assert bt.stamp_count(84, nst) == 84 * nst + 84 * 4


def _stamps(grid, names, step, t0=10_000, g0=1_000_000, skew=0,
            ns_per_cycle=0.5, tail=()):
    """One launch's stamp buffer: CTA c starts skew * c ns after g0 and
    each of its phases lasts step(c, name) cycles; tiles t2, t3 unused by
    even CTAs and t3 by all; the sum_* phases only on CTAs in tail."""
    n = len(names)
    st = np.zeros(bt.stamp_count(grid, n), dtype=np.int64)
    body = st[:grid * n].reshape(grid, n)
    span = st[grid * n:].reshape(grid, bt.N_SPAN)
    for c in range(grid):
        t = t0
        span[c, 1] = t
        for i, name in enumerate(names):
            if name.startswith("t3") or (name.startswith("t2")
                                         and c % 2 == 0):
                continue
            if name.startswith("sum_") and c not in tail:
                continue
            t += step(c, name)
            body[c, i] = t
        span[c, 3] = t + 100
        span[c, 0] = g0 + skew * c
        span[c, 2] = span[c, 0] + int((t + 100 - t0) * ns_per_cycle)
    return st


def test_decode_last_cta_skew_and_phases():
    _, _, names, _ = _kernel_names()
    grid = 6

    def step(c, name):
        return 1000 if name == "sum_ybuf" else 100 * (c + 1)
    st = _stamps(grid, names, step, skew=500, tail=(3,))
    out = bt.decode([st], grid, names)
    assert out["ns_per_cycle"] == pytest.approx(0.5)
    (ln,) = out["launches"]
    us = 0.5 / 1e3
    # CTA 5 starts last (2.5 us after CTA 0) and ends last.
    assert ln["last"]["cta"] == 5
    assert ln["skew_us"]["max"] == pytest.approx(2.5)
    assert ln["skew_us"]["median"] == pytest.approx(1.25)
    ph = ln["last"]["phases"]
    assert ph["setup"] == pytest.approx(600 * us)
    assert ph["t2_S"] == pytest.approx(600 * us)
    assert "t3_S" not in ph and "sum_ybuf" not in ph
    assert ph["exit"] == pytest.approx(100 * us)
    assert ln["last"]["tiles"] == 3
    assert ln["summing_ctas"] == 1
    # The summing CTA's sums, and the median CTA's setup.
    assert ln["median_us"]["sum_ybuf"] == pytest.approx(1000 * us)
    assert ln["median_us"]["setup"] == pytest.approx(350 * us)
    assert out["span_us"] == pytest.approx(ln["span_us"])


def test_decode_launches_together_share_one_clock():
    _, _, names, _ = _kernel_names()
    grid = 4
    a = _stamps(grid, names, lambda c, n: 100, g0=1_000_000)
    b = _stamps(grid, names, lambda c, n: 100, g0=1_003_000)
    out = bt.decode([a, b], grid, names)
    first, second = out["launches"]
    assert first["start_us"] == 0.0
    assert second["start_us"] == pytest.approx(3.0)
    assert out["span_us"] == pytest.approx(3.0 + second["span_us"])


def test_decode_needs_the_span_stamps():
    _, _, names, _ = _kernel_names()
    st = np.zeros(bt.stamp_count(3, len(names)), dtype=np.int64)
    with pytest.raises(ValueError, match="start and end"):
        bt.decode([st], 3, names)


def test_stamped_launcher_needs_a_card():
    K, B, d, CH, nc1 = 7, 1, 5, 128, 3
    f = torch.zeros
    args = (torch.zeros((1, 2), dtype=torch.int32), f((1, K, B + 1)),
            f((nc1, 1 + B + d, CH)), f((d, K)), f(K), f(B), f(B), f((K, B)),
            f((K, B)), False, (f((nc1, K, B + 1)), f((nc1, K, d)),
                               f((nc1, 2))), 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bt.launcher(*args)


def test_stamped_block_library_built_only_on_demand():
    assert build.ON_DEMAND == ("fused_estep_timed",
                               "fused_estep_block_timed")
    src = open(os.path.join(CSRC, "fused_estep_block_timed.cu")).read()
    assert "#define ESTEP_ONE true" in src
    assert "#define ESTEP_TIMED true" in src
    assert '#include "fused_estep_block.cu"' in src
    assert build.default_sources() == ["fused_estep", "fused_estep_block",
                                       "fused_estep_block_one",
                                       "fused_estep_one"]
    assert bt.NAME == "fused_estep_block_timed"


def test_fit_path_does_not_import_the_stamped_block():
    # A mesh fit on CPU shards walks the per-block path's Python (plans,
    # tables); neither stamped module is imported.
    code = (
        "import sys, numpy as np, pandas as pd\n"
        "import harmonypy_tpu_torch as ht\n"
        "from harmonypy_tpu_torch.parallel.mesh import make_mesh\n"
        "rng = np.random.default_rng(0)\n"
        "X = rng.standard_normal((600, 5)).astype(np.float32)\n"
        "meta = pd.DataFrame({'b': rng.integers(0, 2, 600).astype(str)})\n"
        "ht.run_harmony(X, meta, ['b'], mesh=make_mesh(['cpu'] * 2),\n"
        "               verbose=False, max_iter_harmony=1, chunk_size=128)\n"
        "for m in ('block_timing', 'round_timing'):\n"
        "    assert 'harmonypy_tpu_torch.ops.cuda.' + m not in sys.modules\n"
        "print('ok')\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


# --- On a card --------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float32", "default"])
@pytest.mark.parametrize("store", [None, torch.float32, torch.bfloat16])
def test_cluster_and_ticket_tails_agree_on_cuda(cuda_device, precision,
                                                store):
    from harmonypy_tpu_torch.ops.update_r_fused import make_zp3
    K, B, d, CH, N = 7, 3, 5, 128, 6_000
    cfg = config.EngineConfig(N=N, d=d, K=K, B=B, n_devices=1,
                              use_fused_xla=True, defer_r=True,
                              chunk_size=CH)
    geom = partition.partition_geometry(cfg)
    rng = np.random.default_rng(0)
    nc1 = geom.nc_cap + 1
    Z = rng.standard_normal((d, nc1 * CH)).astype(np.float32)
    Z /= np.linalg.norm(Z, axis=0, keepdims=True)
    lab = rng.integers(0, B, nc1 * CH)
    Phi = (lab[None] == np.arange(B)[:, None]).astype(np.float32)
    mask = np.ones(nc1 * CH, np.float32)
    mask[N:] = 0.0
    t = lambda x: torch.as_tensor(x, device=cuda_device)
    ZP3 = make_zp3(t(Z), t(Phi), t(mask), cfg)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    blocks = partition.stripe_blocks(gen, geom.NC_fixed, geom.L, geom.nb)
    cache = torch.zeros((nc1, K, B + 1), device=cuda_device)
    slots, removal = partition.round_tables(blocks, cache, geom)
    Y = rng.standard_normal((d, K)).astype(np.float32)
    Y /= np.linalg.norm(Y, axis=0, keepdims=True)
    O = rng.uniform(1, 50, (K, B)).astype(np.float32)
    args = (slots, removal, ZP3, t(Y), t(np.full(K, 0.1, np.float32)),
            t(np.full(B, 2.0, np.float32)), t(Phi.mean(axis=1)), t(O),
            t(O * 0.9))
    got = {}
    for tail in fe.BLOCK_TAILS:
        for fast in (False, True):
            out = (torch.zeros((nc1, K, B + 1), device=cuda_device),
                   torch.zeros((nc1, K, d), device=cuda_device),
                   torch.zeros((nc1, 2), device=cuda_device))
            R3 = (None if store is None else torch.zeros(
                (nc1, K, CH), dtype=store, device=cuda_device))
            ln = fe._BlockLaunch(*args, fast, out, slots.shape[1], R3=R3,
                                 precision=precision, tail=tail)
            assert ln.tail == tail
            ln.launch(0)
            ln.launch(1)
            torch.cuda.synchronize()
            got[tail, fast] = [*ln.removed(0), *ln.removed(1), *out,
                               *ln.brows.unbind(0),
                               *(() if R3 is None else (R3,))]
    for fast in (False, True):
        for a, b in zip(got["cluster", fast], got["ticket", fast]):
            assert torch.equal(a, b)
