"""The one-launch round's schedule, on the Python side: the work split its
bits rest on, the scratch and sync buffer the wrapper hands the kernel,
the stamped round's buffer and its decoding into phases, and the on-demand
build of the stamped library. On a CUDA card only: repeated launches
through one sync buffer, which the kernel leaves fit for the next."""

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
from harmonypy_tpu_torch.ops.cuda import build
from harmonypy_tpu_torch.ops.cuda import fused_estep as fe
from harmonypy_tpu_torch.ops.cuda import round_timing as rt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUH = os.path.join(ROOT, "harmonypy_tpu_torch", "csrc", "fused_estep.cuh")


def _slots_per_block(N, d, K, B, CH):
    cfg = config.EngineConfig(N=N, d=d, K=K, B=B, n_devices=1,
                              use_fused_xla=True, defer_r=True,
                              chunk_size=CH)
    return partition.partition_geometry(cfg).J_shard


def test_kernel_geometry_pinned_at_858k():
    # The reference README's workload on an H100 (132 SMs): 22 slots per
    # block, 32 tiles per slot, 12 units per slot of 2 or 3 tiles.
    J = _slots_per_block(858_000, 29, 100, 3, 2048)
    assert J == 22
    geo = fe.kernel_geometry(100, 3, 29, 2048, J, 132)
    assert (geo.tiles, geo.ng, geo.n_units) == (32, 12, 264)
    runs = [geo.unit_tiles(u)[1:] for u in range(geo.ng)]
    assert runs == [(0, 2), (2, 5), (5, 8), (8, 10), (10, 13), (13, 16),
                    (16, 18), (18, 21), (21, 24), (24, 26), (26, 29),
                    (29, 32)]
    assert geo.unit_tiles(12 * 21 + 5) == (21, 13, 16)


# chip_smoke.SHAPES: (N, d, K, B, CH) and the (J, tiles, ng) they give.
SHAPES = [((6_000, 5, 7, 1, 128), (4, 2, 2)),
          ((6_000, 30, 100, 3, 128), (4, 2, 2)),
          ((45_000, 5, 200, 1, 2048), (3, 32, 32)),
          ((45_000, 50, 7, 3, 2048), (3, 32, 32)),
          ((6_000, 5, 100, 5, 128), (4, 2, 2)),
          ((45_000, 50, 200, 5, 2048), (3, 32, 32)),
          ((6_000, 30, 280, 3, 128), (4, 2, 2))]


@pytest.mark.parametrize("shape,want", SHAPES)
def test_kernel_geometry_pinned_at_phase_shapes(shape, want):
    N, d, K, B, CH = shape
    J = _slots_per_block(*shape)
    geo = fe.kernel_geometry(K, B, d, CH, J, 132)
    assert (J, geo.tiles, geo.ng) == want
    # Every unit has one tile: every CTA shares the ybuf rows.
    assert all(geo.unit_tiles(u)[2] - geo.unit_tiles(u)[1] == 1
               for u in range(geo.n_units))


def test_round_scratch_copies():
    geo = fe.kernel_geometry(100, 3, 29, 2048, 22, 132)
    shapes = fe.round_scratch(geo)
    # Partials of S by block mod 3, of (kerr, ent) by block parity.
    assert shapes["part"] == (3, 264, 100, 33)
    assert shapes["kpart"] == (2, 264, 2)
    assert (fe.PART_COPIES, fe.KPART_COPIES) == (3, 2)


def test_sync_buffer_size_zero_and_per_stream():
    dev = torch.device("cpu")
    fe._syncs.clear()
    a = fe.round_sync(dev, 1)
    # Three counters (units, reducing CTAs, CTAs ended) and their values at
    # the last launch's end.
    assert fe.SYNC_WORDS == 6
    assert a.dtype == torch.int32 and a.numel() == 6
    assert not bool(a.any())
    a[3] = 40                    # what a launch left: kept as it is
    assert fe.round_sync(dev, 1) is a and int(a[3]) == 40
    b = fe.round_sync(dev, 2)    # another stream, another buffer
    assert b is not a and not bool(b.any())
    fe._syncs.clear()


def test_sync_words_match_the_kernel():
    src = open(CUH).read()
    assert re.search(r"enum \{ SY_UNITS, SY_REDUCED, SY_EXITS, SY_GEN, "
                     r"SY_WORDS = SY_GEN \+ 3 \};", src)


def reducing_ctas(tiles, ng, J, grid):
    """The CTAs of a launch of `grid` that reduce each block (the kernel's
    yrank >= 0): with one CTA per unit and units of unequal tiles, those
    whose unit has the fewest; else every CTA."""
    if grid != J * ng or tiles % ng == 0:
        return grid
    return J * sum((r + 1) * tiles // ng - r * tiles // ng == tiles // ng
                   for r in range(ng))


@pytest.mark.parametrize("tiles,ng,J,grid,want", [
    (32, 12, 22, 264, 88),      # 858k: the 2-tile units, 4 of 12 per slot
    (32, 12, 22, 132, 132),     # a CTA runs two units: every CTA
    (2, 2, 4, 8, 8),            # every unit one tile: every CTA
    (32, 32, 3, 96, 96),
    (7, 3, 5, 15, 10)])         # runs of 2, 2, 3 tiles
def test_reducing_ctas(tiles, ng, J, grid, want):
    assert reducing_ctas(tiles, ng, J, grid) == want
    # The kernel's own rule, on its source: light runs, J of each.
    src = open(CUH).read()
    assert "yhelp = J * nl;" in src and "T % a.ng != 0" in src


def _kernel_names():
    src = open(CUH).read()
    nst = int(re.search(r"constexpr int NST = (\d+);", src)[1])
    maxt = int(re.search(r"constexpr int MAXT = (\d+);", src)[1])
    body = re.search(r"STAMP_NAMES =\s*((?:\"[^\"]*\"\s*)+);", src)[1]
    names = "".join(re.findall(r"\"([^\"]*)\"", body)).split(",")
    return nst, maxt, names


def test_stamp_names_match_the_kernel_layout():
    nst, maxt, names = _kernel_names()
    assert len(names) == nst
    assert names[:3] == ["start", "wait_sums", "prologue"]
    tiles = [f"t{i}_{k}" for i in range(maxt)
             for k in ("ready", "pass1", "pass2", "S")]
    assert names[3:3 + 4 * maxt] == tiles
    assert names[3 + 4 * maxt:] == ["partial", "arrive", "off_window",
                                    "wait_units", "off_reduce"]
    assert rt.stamp_count(20, 264, nst) == 20 * 264 * nst + 264 * 4


def _stamps(nb, grid, names, step, wait_us, ns_per_cycle=0.5):
    """A stamp buffer: every used phase of CTA c lasts step(c, phase)
    cycles (wait_* phases wait_us microseconds); tiles t2, t3 unused by
    CTAs of even index and t3 by all."""
    n = len(names)
    st = np.zeros(rt.stamp_count(nb, grid, n), dtype=np.int64)
    body = st[:nb * grid * n].reshape(nb, grid, n)
    span = st[nb * grid * n:].reshape(grid, rt.N_SPAN)
    wait_cyc = int(wait_us * 1e3 / ns_per_cycle)
    t0 = 10_000
    for b in range(nb):
        for c in range(grid):
            t = t0 + b * 100_000
            body[b, c, 0] = t
            for i, name in enumerate(names[1:], 1):
                if name == "-" or name.startswith("t3") or (
                        name.startswith("t2") and c % 2 == 0):
                    continue
                t += wait_cyc if name.startswith("wait") else step(c, name)
                body[b, c, i] = t
    span[:, 1] = 0
    span[:, 3] = 2_000_000
    span[:, 0] = 0
    span[:, 2] = int(2_000_000 * ns_per_cycle)
    return st


def test_decode_phases_critical_cta_and_kinds():
    _, _, names = _kernel_names()
    nb, grid = 4, 6

    def step(c, name):
        if name.startswith("off_"):
            return 25_000           # long, but off the chain
        return 100 * (c + 1)        # CTA 5 is the busiest on the chain
    st = _stamps(nb, grid, names, step, wait_us=2.0)
    out = rt.decode(st, nb, grid, names)
    assert out["ns_per_cycle"] == pytest.approx(0.5)
    us = 0.5 / 1e3
    # CTA 5 (odd: tiles t0-t2), not CTA 0 with its long off-chain window.
    crit = out["critical_us"]
    assert crit["prologue"] == pytest.approx(600 * us)
    assert crit["t2_S"] == pytest.approx(600 * us)
    assert crit["t3_S"] == 0.0
    assert crit["wait_sums"] == pytest.approx(2.0)
    assert out["tiles"] == 3.0
    assert out["by_kind_us"]["pass1"] == pytest.approx(3 * 600 * us)
    assert out["critical_wait_us"] == pytest.approx(4.0)
    assert out["critical_off_us"] == pytest.approx(50_000 * us)
    chain = [n for n in names[1:] if n != "-" and not n.startswith("t3")
             and not n.startswith("wait") and not n.startswith("off_")]
    assert out["critical_busy_us"] == pytest.approx(len(chain) * 600 * us)
    # An even CTA skips t2: its t3-less, t2-less stamps are not counted.
    assert out["mean_us"]["t2_ready"] == pytest.approx(
        np.mean([100 * (c + 1) for c in range(1, grid, 2)]) * us)
    assert out["block_us"] == pytest.approx(100_000 * us)


def test_decode_needs_the_span_stamps():
    _, _, names = _kernel_names()
    st = np.zeros(rt.stamp_count(2, 3, len(names)), dtype=np.int64)
    with pytest.raises(ValueError, match="start and end"):
        rt.decode(st, 2, 3, names)


def test_timed_round_needs_a_card():
    K, B, d, CH, nc1 = 7, 1, 5, 128, 3
    f = torch.zeros
    args = (torch.zeros((1, 2), dtype=torch.int32), f((1, K, B + 1)),
            f((nc1, 1 + B + d, CH)), f((d, K)), f(K), f(B), f(B), f((K, B)),
            f((K, B)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        rt.timed_round(*args)


def test_stamped_library_built_only_on_demand():
    assert "fused_estep_timed" in build.ON_DEMAND
    assert os.path.isfile(os.path.join(build.CSRC, "fused_estep_timed.cu"))
    assert build.default_sources() == ["fused_estep", "fused_estep_block",
                                       "fused_estep_block_one",
                                       "fused_estep_one"]


def test_fit_path_does_not_import_the_stamped_round():
    code = (
        "import sys, numpy as np, pandas as pd\n"
        "import harmonypy_tpu_torch as ht\n"
        "rng = np.random.default_rng(0)\n"
        "X = rng.standard_normal((300, 5)).astype(np.float32)\n"
        "meta = pd.DataFrame({'b': rng.integers(0, 2, 300).astype(str)})\n"
        "ht.run_harmony(X, meta, ['b'], device='cpu', verbose=False,\n"
        "               max_iter_harmony=1, chunk_size=128)\n"
        "assert 'harmonypy_tpu_torch.ops.cuda.round_timing' not in "
        "sys.modules\n"
        "print('ok')\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float32", "default"])
def test_launches_share_one_sync_buffer_on_cuda(cuda_device, precision):
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
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    first = fe.fused_estep(*args, False, precision=precision)
    sync = fe.round_sync(cuda_device, stream)
    torch.cuda.synchronize()
    start = sync.cpu().numpy().astype(np.int64)
    for _ in range(3):
        again = fe.fused_estep(*args, False, precision=precision)
        for a, b in zip(first[:5], again[:5]):
            assert torch.equal(a, b)
    torch.cuda.synchronize()
    # Each launch counts its units, its reducing CTAs' blocks and its CTAs,
    # and records the counts it ends at for the next.
    J = slots.shape[1]
    geo = fe.kernel_geometry(K, B, d, CH, J, fe._sm_count(0))
    grid = min(fe.launch_grid(K, B, d, precision=precision), geo.n_units)
    helpers = reducing_ctas(geo.tiles, geo.ng, J, grid)
    step = np.array([geom.nb * geo.n_units, geom.nb * helpers, grid])
    now = sync.cpu().numpy().astype(np.int64)
    assert (now[:3] == start[:3] + 3 * step).all()
    assert (now[3:] == now[:3]).all()
