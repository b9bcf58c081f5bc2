"""Wrappers of the hand-written fused E-step kernels (csrc/fused_estep.cu).

`fused_estep` (K1) computes one deferred-R E-step round — what the JAX
package's Pallas `_kernel_nor` computes (ops/pallas/update_r_fused.py:
117-221) — and, with width > 0, also returns the r of a window of chunks
(the replay epilogue). `fused_estep_r` (K2) computes the stored-R round of
the Pallas `_kernel` (:109-114): the same round, writing r of every chunk
into the caller's R3 in its dtype. On CUDA tensors each launches its kernel
(one cooperative launch per round) or raises; on CPU tensors each runs its
plain version (`ops.update_r_fused.fused_update_nor` / `fused_update_r`).
`launches` and `launches_write_r` count the launches of K1 and K2.

`fused_estep_mesh` is the round on a mesh of several shards: for each
block, the kernel's per-block entry on every shard (`_BlockLaunch`: block b
of K1, of its r window or of K2, a launch of one CTA per unit, each slot's
units one cluster (`block_tail`), csrc/fused_estep_block.cu), whose
prologue re-adds block b - 1 across the
shards from every shard's rows of it; after the last block, the re-add
kernel (csrc/frame_readd.cuh, `_Readd`) on the lead device, once per pass.
A plan (`_MeshPlan`) made once per pass geometry (`plan_key`) while a
`mesh_plans` block is active (engine.fit holds one) holds the scratch, the
streams, the events, the outputs and the pass's order (`pass_schedule`),
and the whole pass is one native call that walks that order (across
processes one per block, each followed by the block's all-gather, and one
for the last re-add). Its plain version is
`ops.update_r_fused.mesh_round` (per block `fused_update_block`, then
`frame_readd`; one folded launch is `fused_update_block_folded`);
`launches_block` (K1 and its r window), `launches_block_write_r` (K2) and
`launches_readd` count the launches, `native_calls` the native calls and
`plans_made` the plans.

`precision` (EngineConfig.matmul_precision) picks the kernels' products on
a card: "float32" runs them as 3xTF32 (error near fp32 rounding),
"default" as one bf16 tensor-core pass with fp32 accumulation, each
operand rounded to nearest even (the one-pass variant, as the JAX
package's default runs its products on the TPU). Every launch of a round,
its replays and its K2 passes one precision, and a plan serves one. CPU
tensors run the plain fp32 version under either value, as XLA computes an
f32 product in f32 on the CPU; `one_pass=True` of the plain functions is
the one-pass variant's plain version, which the card's checks use.
`launches_one_pass`, `launches_write_r_one_pass`, `launches_block_one_pass`
and `launches_block_write_r_one_pass` count the one-pass launches among
those of K1, K2 and their per-block entries.

The kernel's static work split is `kernel_geometry`: the padded sizes, the
units (runs of 64-cell tiles of one slot) and the shapes of the partials.

Its memory plan is chosen by shape (`wide_plan`): O, E, the diversity
weights and the S accumulator in shared memory where they fit, else the
one-launch round's wide plan, which keeps them in a per-CTA scratch of
global memory that the wrapper allocates (csrc/fused_estep.cuh
layout_wide: at d = 50, K = 100 from B = 51 under "default", B = 33 under
"float32"). The round, its r window and K2
take it (`launches_wide` counts those launches, each inside a
`harmony::k1_wide` range); the per-block entry of a mesh has no wide plan
and raises for such shapes. Given `codes`, a one-covariate design's batch
level of each cell (chunk-major (nc1, CH) int32, -1 for padding; the fit
passes them where `codes_plan` holds), a round in the wide plan takes its
codes plan instead (csrc/fused_estep.cuh layout_codes): the slab's [mask;
Z] rows and the codes, not the B design rows, the same bits
(`launches_codes` counts those launches, each also inside a
`harmony::k1_codes` range).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import threading
import weakref

import torch

from ...parallel.mesh import gatherer, spans_processes
from ..partition import rank_table
from ..products import PRECISIONS, one_pass
from ...utils.profiling import span
from ..update_r_fused import fused_update_nor, fused_update_r, mesh_round
from . import build

launches = 0
launches_write_r = 0
launches_block = 0
launches_block_write_r = 0
launches_readd = 0
launches_wide = 0    # one-launch rounds (K1, r window, K2) in the wide plan
launches_codes = 0   # ... of those, in its codes plan
wide_ctas = 0        # CTAs (scratch slabs) of the last such launch
native_calls = 0     # mesh_plan_run calls (the native mesh pass)
plans_made = 0       # mesh pass plans (_MeshPlan) made
# The one-pass launches among the counts above.
launches_one_pass = 0
launches_write_r_one_pass = 0
launches_block_one_pass = 0
launches_block_write_r_one_pass = 0

TILE = 64            # cells per tile (csrc/fused_estep.cu TILE)
UNITS_PER_SM = 2     # units per block aimed at for each SM

_P, _I = ctypes.c_void_p, ctypes.c_int
N_PTRS = 17          # pointers every round entry takes first (ESTEP_PTRS)
# The loaded libraries by variant (one pass or not): csrc/fused_estep.cu
# and fused_estep_block.cu hold the 3xTF32 instantiations,
# fused_estep_one.cu and fused_estep_block_one.cu the one-pass ones.
_libs = {}
_blocks = {}


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


# Copies of the one-launch round's scratch: unit partials of S by block
# mod PART_COPIES (a block's ybuf rows are summed during the next block,
# whose units may already write the partials of the one after), the
# (kerr, ent) partials by block parity (a slot's kbuf is summed after the
# block's sums are out, while the next block runs).
PART_COPIES = 3
KPART_COPIES = 2
_syncs = {}


def round_scratch(geo: "KernelGeometry") -> dict:
    """Shapes of the one-launch round's scratch of geometry geo: the unit
    partials of S (part) and of (kerr, ent) (kpart), by copy."""
    return dict(part=(PART_COPIES, *geo.part_shape),
                kpart=(KPART_COPIES, *geo.kpart_shape))


# Words of the round's sync buffer (csrc/fused_estep.cuh SY_WORDS): three
# counters that only grow (units that wrote their partials, reducing CTAs
# done with a block, CTAs that ended), then the values they had when the
# last launch ended, from which the next launch counts.
SYNC_WORDS = 6


def round_sync(device, stream: int):
    """The one-launch round's sync buffer on `device` for its launches on
    `stream` (a cuda_stream handle): SYNC_WORDS int32, zero when made. Each
    launch counts from the values the previous one left and records its
    own at its end: no launch clears the buffer, and none needs a value
    from the host. Rounds on one stream run one at a time, so they share
    it."""
    key = (str(device), stream)
    buf = _syncs.get(key)
    if buf is None:
        buf = _syncs[key] = torch.zeros(SYNC_WORDS, dtype=torch.int32,
                                        device=device)
    return buf


@dataclasses.dataclass(frozen=True)
class KernelGeometry:
    """The kernel's padded sizes and static work split for one round.

    A slot's chunk is cut into `tiles` tiles of TILE cells; unit u covers
    slot u // ng and its tiles [run * tiles // ng, (run + 1) * tiles // ng)
    with run = u % ng. Partials are indexed by unit and summed in ascending
    unit order within a slot."""
    K_pad: int       # K to a multiple of 16 (S m-tiles)
    d_pad: int       # d to a multiple of 8 (dist k-steps)
    R_pad: int       # 1+B+d to a multiple of 8 (S n-tiles)
    tiles: int       # tiles per slot: ceil(CH / TILE)
    ng: int          # units per slot
    n_units: int     # J * ng
    part_shape: tuple   # (n_units, K, 1+B+d) partials of S
    kpart_shape: tuple  # (n_units, 2) partials of (kerr, ent)

    def unit_tiles(self, u: int) -> tuple[int, int, int]:
        """(slot index j, first tile, end tile) of unit u."""
        j, run = divmod(u, self.ng)
        return (j, run * self.tiles // self.ng,
                (run + 1) * self.tiles // self.ng)


def kernel_geometry(K: int, B: int, d: int, CH: int, J: int,
                    n_sm: int, J_glob: int | None = None) -> KernelGeometry:
    """The work split of one round: a function of the shape and the card's
    SM count only, never of occupancy, so K1, its r window and K2 (whose
    instantiations may fit differently) sum in the same order.

    J is the launch's slots per block; J_glob (default J) the slots per
    block of the one-device round, J_fix + 1, which sets the units per slot
    `ng`. A chunk's statistics are the sum of its ng unit partials, so ng
    must not depend on the shard: a mesh shard (J = J_shard < J_fix + 1)
    splits each chunk as the one-device round does, and sums it in the
    same order."""
    tiles = -(-CH // TILE)
    ng = max(1, min(tiles, UNITS_PER_SM * n_sm // (J_glob or J)))
    R = 1 + B + d
    return KernelGeometry(K_pad=_up(K, 16), d_pad=_up(d, 8), R_pad=_up(R, 8),
                          tiles=tiles, ng=ng, n_units=J * ng,
                          part_shape=(J * ng, K, R),
                          kpart_shape=(J * ng, 2))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _kernel_lib(one: bool = False):
    """csrc/fused_estep.cu (one: fused_estep_one.cu): the one-launch
    round."""
    lib = _libs.get(one)
    if lib is None:
        name = "fused_estep_one" if one else "fused_estep"
        lib = build.load(name)
        common = [_P] * N_PTRS + [_P]        # ... and the sync buffer
        wide = [_P, _I, _P]                  # the wide plan's scratch, codes
        tail = [_I] * 9 + [_P]
        lib.fused_estep_round.argtypes = common + wide + tail
        lib.fused_estep_r_window.argtypes = (common + [_P, _I, _I] + wide
                                             + tail)
        lib.fused_estep_write_r.argtypes = common + [_P, _I] + wide + tail
        for fn in (lib.fused_estep_round, lib.fused_estep_r_window,
                   lib.fused_estep_write_r):
            fn.restype = _I
        sizes = (lib.fused_estep_smem, lib.fused_estep_smem_wide,
                 lib.fused_estep_wide_floats, lib.fused_estep_smem_codes,
                 lib.fused_estep_codes_floats,
                 lib.fused_estep_codes_shared_floats)
        for fn in sizes:
            fn.argtypes = [_I, _I, _I]
        for fn in (lib.fused_estep_grid, lib.fused_estep_grid_codes):
            fn.argtypes = [_I, _I, _I, _I]
        for fn in (*sizes, lib.fused_estep_smem_limit, lib.fused_estep_tile,
                   lib.fused_estep_grid, lib.fused_estep_grid_codes,
                   lib.fused_estep_one_pass):
            fn.restype = _I
        if lib.fused_estep_tile() != TILE:
            raise RuntimeError(f"{name}.cu tiles {lib.fused_estep_tile()}"
                               f" cells, the wrapper {TILE}")
        if lib.fused_estep_one_pass() != one:
            raise RuntimeError(f"{name}.cu holds the wrong variant")
        _libs[one] = lib
    return lib


def _block_lib(one: bool = False):
    """csrc/fused_estep_block.cu (one: fused_estep_block_one.cu): the
    per-block entry, the re-add kernel and the native mesh pass."""
    lib = _blocks.get(one)
    if lib is None:
        name = "fused_estep_block_one" if one else "fused_estep_block"
        lib = _blocks[one] = block_signatures(build.load(name), name, one)
    return lib


# How a per-block launch sums each slot's ng unit partials: "cluster", the
# slot's units as one thread-block cluster, each CTA summing a share of the
# slot's rows over distributed shared memory (csrc/fused_estep.cuh
# cluster_tail); or "ticket", the last unit to finish summing them all
# from L2 (block_tail). Both add every value in ascending unit order: the
# same bits.
BLOCK_TAILS = ("cluster", "ticket")
CLUSTER_MAX = 16     # units per slot a cluster takes (csrc CLUSTER_MAX)


def block_tail(ng: int) -> str:
    """The tail a per-block launch of ng units per slot takes: a cluster up
    to CLUSTER_MAX units (16, the largest cluster Hopper schedules), else
    tickets."""
    return "cluster" if ng <= CLUSTER_MAX else "ticket"


def block_signatures(lib, name: str, one: bool):
    """Set the C signatures of a per-block library's entries (csrc/
    fused_estep_block.cu, built as `name`) and check its table layout and
    variant; returns lib."""
    lib.fused_estep_block_prepare.argtypes = (
        [_P] * 17 + [_P, _P, _I, _P, _I, _P, _I, _P] + [_I] * 3
        + [_I] * 9 + [_P, _I, _P])
    lib.fused_estep_block_launch.argtypes = [_P, _I, _I]
    lib.fused_estep_block_setup.argtypes = [_I] * 4
    lib.fused_estep_block_clusters.argtypes = [_I] * 4
    lib.frame_readd_prepare.argtypes = [_P, _I, _P, _I, _I, _P, _P, _P,
                                        _P, _P, _I, _I, _I, _P, _P]
    lib.frame_readd_launch.argtypes = [_P, _I]
    lib.mesh_plan_create.argtypes = [_I, _P, _P, _P, _P, _I, _P, _P]
    lib.mesh_plan_run.argtypes = [_P, _P, _I, _P, _I, _I]
    lib.mesh_plan_destroy.argtypes = [_P]
    lib.mesh_plan_layout.argtypes = [_P]
    lib.mesh_plan_layout.restype = None
    for fn in (lib.fused_estep_block_prepare, lib.fused_estep_block_launch,
               lib.fused_estep_block_call_size,
               lib.fused_estep_block_setup, lib.frame_readd_prepare,
               lib.frame_readd_launch, lib.frame_readd_max_shards,
               lib.frame_readd_call_size, lib.mesh_plan_create,
               lib.mesh_plan_run, lib.mesh_plan_destroy,
               lib.fused_estep_block_one_pass, lib.fused_estep_block_clusters,
               lib.fused_estep_block_cluster_max):
        fn.restype = _I
    if lib.fused_estep_block_cluster_max() != CLUSTER_MAX:
        raise RuntimeError(f"{name}.cu takes clusters of up to "
                           f"{lib.fused_estep_block_cluster_max()} units, "
                           f"the wrapper {CLUSTER_MAX}")
    layout = (ctypes.c_int * 3)()
    lib.mesh_plan_layout(layout)
    want = (_OP_WIDTH, len(BLOCK_FIELDS), len(READD_FIELDS))
    if tuple(layout) != want:
        raise RuntimeError(f"{name}.cu's mesh plan layout "
                           f"{tuple(layout)}, the wrapper's {want}")
    if lib.fused_estep_block_one_pass() != one:
        raise RuntimeError(f"{name}.cu holds the wrong variant")
    return lib


def launch_grid(K: int, B: int, d: int, r_bf16: bool = False,
                precision: str = "float32") -> int:
    """CTAs of one round's launch on the current card (K2 in bf16 with
    r_bf16; the variant of `precision`)."""
    grid = _kernel_lib(one_pass(precision)).fused_estep_grid(
        K, B, d, int(r_bf16))
    if grid < 0:
        raise RuntimeError(f"fused_estep occupancy query failed: CUDA error "
                           f"{-grid}")
    return grid


@functools.lru_cache(maxsize=None)
def wide_plan(K: int, B: int, d: int, one: bool) -> bool:
    """Whether a round of (K, B, d) takes the wide plan on a card (one:
    the one-pass variant's): its plan with O, E, wdiv and S in shared
    memory exceeds the card's limit. Raises ValueError where even the wide
    plan does not fit."""
    lib = _kernel_lib(one)
    limit = lib.fused_estep_smem_limit()
    smem = lib.fused_estep_smem(K, B, d)
    if smem <= limit:
        return False
    wide = lib.fused_estep_smem_wide(K, B, d)
    if wide > limit:
        raise ValueError(
            f"fused_estep: K={K}, B={B}, d={d} needs {smem} bytes of shared "
            f"memory per CTA, above the card's {limit}, and {wide} in the "
            f"wide plan")
    return True


def codes_fit(K: int, B: int, d: int, one: bool) -> bool:
    """Whether the codes plan of (K, B, d) fits a CTA's shared memory (one:
    the one-pass variant's). Its S keeps the dense [mask; Z] accumulator and
    two ring stages there, which the dense wide plan does not: past K ~ 270
    at d = 50, or d > 120 under "float32", only the dense wide plan fits."""
    lib = _kernel_lib(one)
    return lib.fused_estep_smem_codes(K, B, d) <= lib.fused_estep_smem_limit()


def codes_plan(K: int, B: int, d: int, precision: str,
               n_covariates: int) -> bool:
    """Whether a fit's rounds on a card take the codes plan: the shape
    takes the wide plan (`wide_plan`, in the variant of `precision`), the
    codes plan fits (`codes_fit`) and the design has one covariate
    (cfg.n_covariates == 1, as ops/replay.onehot_design decides for the
    ridge), so that each cell's design rows are one level. A design of
    several covariates keeps the dense wide plan: its cells have several
    ones, whose sum's order the dense product sets."""
    one = one_pass(precision)
    return (n_covariates == 1 and wide_plan(K, B, d, one)
            and codes_fit(K, B, d, one))


# csrc/fused_estep.cuh's constants that size its memory plans.
_THREADS, _PT, _KSC, _KSC1, _NRG_MAX, _CG = 256, TILE + 4, 4, 2, 8, 4
MAX_SMEM = 232448    # bytes of shared memory a CTA may take (MAX_SMEM)


def plan_floats(K: int, B: int, d: int, one: bool) -> dict:
    """The round's memory plans of (K, B, d) in floats, as csrc/
    fused_estep.cuh's layout, layout_wide and layout_codes size them (one:
    the one-pass variant's): the shared memory of each ("narrow", "wide",
    "codes"), the codes plan's scratch per CTA ("codes_scratch", gtotal)
    and the region its CTAs share ("codes_shared", gshared). For the
    memory model, which has no library to ask; chip_smoke.py holds these
    to the library's sizes."""
    def up4(x):
        return _up(x, 4)

    def ring(dist_rows, nr, nrg):      # (ring rows RR, S pitch PSA)
        nrp = _up(nr, nrg)
        return (_up(max(dist_rows, 8 * nrp), 8),
                8 * nrp + (0 if nrp & 1 else 8))

    Kp, step = _up(K, 16), 16 if one else 8
    ksr = max(-(-d // step), _KSC1 if one else _KSC)
    yw = Kp // 16 * 128                # floats of one Y^T or wdiv k-step
    common = 2 * up4(Kp) + Kp * _PT + TILE + _THREADS
    nr = _up(1 + B + d, 8) // 8
    rr, psa = ring(B + 1 + step * ksr, nr, min(nr, _NRG_MAX))
    for pre in (0,) if one else (1, 0):   # operands split ahead if they fit
        narrow = ((yw * ksr + yw * -(-(B + 1) // step)) * (1 + pre) + common
                  + 2 * up4(K * B) + 2 * rr * _PT + up4(Kp * psa))
        if 4 * narrow <= MAX_SMEM:
            break
    wide = yw * ksr + common + rr * _PT
    rr, psa = ring(1 + step * ksr, _up(1 + d, 8) // 8, _CG)
    codes = (yw * ksr + common + 2 * rr * _PT + up4(Kp * psa)
             + 4 * TILE + 4 + up4(B))
    table = up4(B * Kp // 2 if one else B * Kp)
    in_smem = 4 * (codes + table) <= MAX_SMEM
    return dict(narrow=narrow, wide=wide, codes=codes + table * in_smem,
                codes_scratch=up4(B * Kp) + table * (not in_smem),
                codes_shared=2 * (2 * up4(K * B) + table))


def _check(name, t, shape, dtype, device, contiguous=True):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_round(slots, removal, ZP3, Y, sigma, theta, Pr_b, O, E,
                 precision: str = "float32"):
    """Check the inputs every round takes (on a card, for the variant of
    `precision`); returns (nc1, K, B, d, CH). The slot range is checked
    here on the CPU and by the kernel on the card."""
    one = one_pass(precision)
    if ZP3.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_estep runs on cuda or cpu, not {ZP3.device}")
    nc1, R, CH = ZP3.shape
    d, K = Y.shape
    B = theta.shape[0]
    nb, J = slots.shape
    dev, f32 = ZP3.device, torch.float32
    for name, t, shape, dtype in (
            ("ZP3", ZP3, (nc1, 1 + B + d, CH), f32), ("Y", Y, (d, K), f32),
            ("sigma", sigma, (K,), f32), ("theta", theta, (B,), f32),
            ("Pr_b", Pr_b, (B,), f32),
            ("removal", removal, (nb, K, B + 1), f32),
            ("slots", slots, (nb, J), torch.int32)):
        _check(name, t, shape, dtype, dev)
    # O and E are copied for the kernel: any layout.
    _check("O", O, (K, B), f32, dev, contiguous=False)
    _check("E", E, (K, B), f32, dev, contiguous=False)
    if dev.type == "cpu":
        lo_s, hi_s = torch.aminmax(slots)
        if int(lo_s) < 0 or int(hi_s) >= nc1:
            raise ValueError(f"slot ids must lie in [0, {nc1}), got "
                             f"[{int(lo_s)}, {int(hi_s)}]")
    else:
        wide_plan(K, B, d, one)
        if CH % 4 or ZP3.data_ptr() % 16:
            raise ValueError(f"fused_estep copies the slab in 16-byte pieces:"
                             f" chunk size {CH} must be a multiple of 4 and "
                             f"ZP3 16-byte aligned")
    return nc1, K, B, d, CH


def _check_codes(codes, ZP3):
    """codes: None, or the (nc1, CH) int32 batch levels beside ZP3."""
    if codes is not None:
        _check("codes", codes, (ZP3.shape[0], ZP3.shape[2]), torch.int32,
               ZP3.device)
        if ZP3.device.type == "cuda" and codes.data_ptr() % 16:
            raise ValueError("fused_estep copies the codes in 16-byte "
                             "pieces: codes must be 16-byte aligned")


def _launch(entry, extra, slots, removal, ZP3, Y, sigma, theta, Pr_b, O, E,
            fast_ent, one, J_glob=None, out=None, lib=None, codes=None):
    """Allocate the outputs and scratch and run one round through the
    library function `entry` (extra: its arguments between the common
    pointers with the sync buffer (round_sync) and the dimensions; one: the
    one-pass variant; lib: the library, default the variant's, whose round
    entries also take the wide plan's scratch, allocated here where the
    shape takes it, and the codes, which make a wide round take the codes
    plan). out: the caller's (cache, ybuf, kbuf) to write into, else new
    ones. Returns (O, E, cache, ybuf, kbuf)."""
    nc1, _, CH = ZP3.shape
    d, K = Y.shape
    B = theta.shape[0]
    wide = lib is None and wide_plan(K, B, d, one)
    by_codes = wide and codes is not None
    if by_codes and not codes_fit(K, B, d, one):
        raise ValueError(f"fused_estep: the codes plan of K={K}, B={B}, "
                         f"d={d} exceeds a CTA's shared memory; pass codes "
                         f"only where codes_plan holds")
    nb, J = slots.shape
    dev, f32 = ZP3.device, torch.float32
    geo = kernel_geometry(K, B, d, CH, J, _sm_count(dev.index or 0), J_glob)
    shapes = round_scratch(geo)
    part = torch.empty(shapes["part"], dtype=f32, device=dev)
    kpart = torch.empty(shapes["kpart"], dtype=f32, device=dev)
    bsum = torch.empty((K, B + 1), dtype=f32, device=dev)
    if out is None:
        # Only slotted chunks are written; every real chunk is in exactly
        # one slot and the dummy chunk in at least one, so nothing stays
        # unset.
        out = (torch.empty((nc1, K, B + 1), dtype=f32, device=dev),
               torch.empty((nc1, K, d), dtype=f32, device=dev),
               torch.empty((nc1, 2), dtype=f32, device=dev))
    cache, ybuf, kbuf = out
    O0, E0 = O.contiguous(), E.contiguous()
    O1 = torch.empty((K, B), dtype=f32, device=dev)
    E1 = torch.empty((K, B), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in (ZP3, Y, sigma, theta, Pr_b, removal,
                                   slots, O0, E0, part, kpart, bsum, cache,
                                   ybuf, kbuf, O1, E1,
                                   round_sync(dev, stream))]
    if lib is None:
        lib = _kernel_lib(one)
        scratch, ctas = None, 0
        if wide:
            # One slab per CTA of the launch (at most one per unit).
            with torch.cuda.device(dev):
                ctas = min((lib.fused_estep_grid_codes if by_codes else
                            lib.fused_estep_grid)(K, B, d, 0), geo.n_units)
            if ctas < 1:
                raise RuntimeError(f"fused_estep occupancy query failed: "
                                   f"CUDA error {-ctas}")
            # The codes plan's CTAs also share a region after theirs.
            floats = ctas * (lib.fused_estep_codes_floats if by_codes else
                             lib.fused_estep_wide_floats)(K, B, d)
            if by_codes:
                floats += lib.fused_estep_codes_shared_floats(K, B, d)
            scratch = torch.empty((floats,), dtype=f32, device=dev)
        extra = [*extra, None if scratch is None else scratch.data_ptr(),
                 ctas, codes.data_ptr() if by_codes else None]
    ranged = span("harmony::k1_wide") if wide else contextlib.nullcontext()
    coded = span("harmony::k1_codes") if by_codes else \
        contextlib.nullcontext()
    with torch.cuda.device(dev), ranged, coded:
        err = getattr(lib, entry)(
            *ptrs, *extra, K, B, d, CH, nb, J, geo.ng, nc1,
            int(bool(fast_ent)), stream)
    if err != 0:
        raise RuntimeError(f"{entry} cooperative launch failed: CUDA error "
                           f"{err}")
    if wide:
        global launches_wide, launches_codes, wide_ctas
        launches_wide += 1
        launches_codes += by_codes
        wide_ctas = ctas
    return O1, E1, cache, ybuf, kbuf


def _check_pair(name, t, shape, device):
    """t: two float32 copies of `shape` by block parity, t[p] contiguous,
    apart (or a stride-0 pair: one buffer)."""
    _check(name, t, (2, *shape), torch.float32, device, contiguous=False)
    if not t[0].is_contiguous() or 0 < t.stride(0) < t[0].numel():
        raise ValueError(f"{name}: each parity copy must be contiguous, "
                         f"the two apart or one")


class _BlockLaunch:
    """One shard's per-block launches of a round (K1, its r window or K2):
    the inputs checked, the shared memory allowed and the scratch allocated
    once; `launch(b)` issues block b from `O0`, `E0` (the given O, E), or
    with readd_prev from block b - 1's re-add: that block's block-removed
    O, E plus its frame. Launch b writes the block-removed O, E into
    `O1[b & 1]`, `E1[b & 1]` (`removed(b)`) and the slots' cache rows into
    `brows[b & 1]` (J, K, B+1) in slot order, on `stream` (default: the
    current stream of the shard's device).

    brows: the caller's (2, J, K, B+1) rows by block parity (a stride-0
    pair is one buffer), default a new pair. frame: (2, S, J, K, B+1), every
    shard's block rows stacked shard-major, by parity; src: the pass's
    `rank_table` (codes s * J + j) on the shard's device; without them no
    launch starts from a re-add. precision: the products' variant. tail:
    how a slot's unit partials are summed (`block_tail`; default its rule
    for the shape). lib: the library whose entries prepare and launch
    (default the variant's; ops/cuda/block_timing.py passes the stamped
    one)."""

    def __init__(self, slots, removal, ZP3, Y, sigma, theta, Pr_b, O, E,
                 fast_ent: bool, out, J_glob: int, Rw=None, lo: int = 0,
                 R3=None, stream=None, brows=None, frame=None, src=None,
                 J_fix: int = 0, precision: str = "float32", tail=None,
                 lib=None):
        nc1, K, B, d, CH = _check_round(slots, removal, ZP3, Y, sigma,
                                        theta, Pr_b, O, E, precision)
        self.one = one_pass(precision)
        dev, f32 = ZP3.device, torch.float32
        for name, t, shape in (("cache", out[0], (nc1, K, B + 1)),
                               ("ybuf", out[1], (nc1, K, d)),
                               ("kbuf", out[2], (nc1, 2))):
            _check(name, t, shape, f32, dev)
        if Rw is not None:
            _check("Rw", Rw, (Rw.shape[0], K, CH), f32, dev)
        if R3 is not None:
            _check("R3", R3, (nc1, K, CH), (torch.float32, torch.bfloat16),
                   dev)
        nb, J = slots.shape
        self.nb, self.write_r = nb, R3 is not None
        self.zp3_shape, self.slots_shape = tuple(ZP3.shape), (nb, J)
        self.r3_shape = None if R3 is None else tuple(R3.shape)
        self.r3_dtype = None if R3 is None else R3.dtype
        self.folds = frame is not None
        if self.folds:
            _check_pair("frame", frame, (frame.shape[1], J, K, B + 1), dev)
            _check("src", src, (nb, J_fix + 1), torch.int32, dev)
        if dev.type == "cpu":
            return
        if wide_plan(K, B, d, self.one):
            smem = _kernel_lib(self.one).fused_estep_smem(K, B, d)
            raise ValueError(
                f"fused_estep_block: K={K}, B={B}, d={d} needs {smem} bytes "
                f"of shared memory per CTA, above the card's "
                f"{_kernel_lib(self.one).fused_estep_smem_limit()}; the "
                f"per-block entry of a mesh has no wide plan")
        lib = lib or _block_lib(self.one)
        geo = kernel_geometry(K, B, d, CH, J, _sm_count(dev.index or 0),
                              J_glob)
        self.tail = tail or block_tail(geo.ng)
        if self.tail not in BLOCK_TAILS or (
                self.tail == "cluster" and geo.ng > CLUSTER_MAX):
            raise ValueError(f"tail {self.tail!r}: one of {BLOCK_TAILS}, "
                             f"a cluster of at most {CLUSTER_MAX} units "
                             f"(ng {geo.ng})")
        cluster = self.tail == "cluster"
        with torch.cuda.device(dev):
            err = lib.fused_estep_block_setup(K, B, d,
                                              geo.ng if cluster else 0)
        if err != 0:
            raise RuntimeError(
                f"fused_estep_block: K={K}, B={B}, d={d}"
                f"{f' in clusters of {geo.ng} CTAs' if cluster else ''} "
                f"refused on {dev}: CUDA error {err}")
        self.n_units = geo.n_units
        # A ticketed launch's scratch: unit partials and tickets.
        self.part = self.kpart = self.tickets = None
        if not cluster:
            self.part = torch.empty(geo.part_shape, dtype=f32, device=dev)
            self.kpart = torch.empty(geo.kpart_shape, dtype=f32, device=dev)
            self.tickets = torch.zeros((J,), dtype=torch.int32, device=dev)
        if brows is None:
            brows = torch.empty((2, J, K, B + 1), dtype=f32, device=dev)
        _check_pair("brows", brows, (J, K, B + 1), dev)
        self.brows = brows
        self.O0, self.E0 = O.contiguous(), E.contiguous()
        self.O1 = torch.empty((2, K, B), dtype=f32, device=dev)
        self.E1 = torch.empty((2, K, B), dtype=f32, device=dev)
        # The kernel reads and writes these through the pointers below.
        self._keep = (slots, removal, ZP3, Y, sigma, theta, Pr_b, out, Rw,
                      R3, frame, src)
        if R3 is not None:
            store = (R3.data_ptr(), int(R3.dtype == torch.bfloat16), 0, nc1)
        elif Rw is not None:
            store = (Rw.data_ptr(), 0, lo, Rw.shape[0])
        else:
            store = (None, 0, 0, 0)
        fold = ((frame.data_ptr(), frame.stride(0), src.data_ptr(), J_fix)
                if self.folds else (None, 0, None, 0))
        stream = self.stream = stream or torch.cuda.current_stream(dev)
        # The launch's arguments, converted once: each launch passes the
        # record, the block and whether it starts from a re-add.
        self._call = ctypes.create_string_buffer(
            lib.fused_estep_block_call_size())
        err = lib.fused_estep_block_prepare(
            *[None if t is None else t.data_ptr() for t in (
                ZP3, Y, sigma, theta, Pr_b, removal, slots, self.O0, self.E0,
                self.part, self.kpart, None, out[0], out[1], out[2], self.O1,
                self.E1, self.tickets, brows)], brows.stride(0), *fold,
            *store, K, B, d, CH, nb,
            J, geo.ng, nc1, int(bool(fast_ent)), stream.cuda_stream,
            dev.index or 0, self._call)
        if err != 0:
            raise RuntimeError(f"fused_estep_block_prepare failed: CUDA "
                               f"error {err}")
        self._fn = lib.fused_estep_block_launch
        self.device = dev

    def launch(self, b: int, readd_prev: bool = False) -> None:
        global launches_block, launches_block_write_r
        global launches_block_one_pass, launches_block_write_r_one_pass
        if not 0 <= b < self.nb:
            raise ValueError(f"block {b} outside [0, {self.nb})")
        if readd_prev and (b == 0 or not self.folds):
            raise ValueError(f"block {b} cannot start from the previous "
                             f"block's re-add (block 0, or no frame)")
        err = self._fn(self._call, b, int(bool(readd_prev)))
        if err != 0:
            raise RuntimeError(f"fused_estep_block launch failed: CUDA "
                               f"error {err}")
        if self.write_r:
            launches_block_write_r += 1
            launches_block_write_r_one_pass += self.one
        else:
            launches_block += 1
            launches_block_one_pass += self.one

    def removed(self, b: int):
        """Block b's block-removed O, E (after launch(b))."""
        return self.O1[b & 1], self.E1[b & 1]

    def release_inputs(self) -> None:
        """Drop the inputs the record was prepared with (a mesh plan binds
        each pass's own into its copy of the record); the scratch stays."""
        self._keep = self.O0 = self.E0 = None


class _Readd:
    """The re-add launches of a round on the lead device: rows[s] (J_s, K,
    B+1) hold shard s's block rows (on the lead device), granks[s] (nb,
    J_s) their ranks, from which the pass's `rank_table` is built once (or
    src, that table, given); `launch(b)` forms O, E of block b from Or,
    Er. one: from the one-pass library (a plan's records and walker come
    from one library; the re-add's arithmetic is the same in both)."""

    def __init__(self, rows, granks, Or, Er, Pr_b, J_fix: int, O, E,
                 src=None, one: bool = False):
        lead = Or.device
        K, B = Or.shape
        nb = granks[0].shape[0]
        for s, (r, g) in enumerate(zip(rows, granks)):
            _check(f"rows[{s}]", r, (r.shape[0], K, B + 1), torch.float32,
                   lead)
            if tuple(g.shape) != (nb, r.shape[0]):
                raise ValueError(f"granks[{s}] has shape {tuple(g.shape)}, "
                                 f"expected {(nb, r.shape[0])}")
        for name, t in (("Or", Or), ("Er", Er), ("O", O), ("E", E)):
            _check(name, t, (K, B), torch.float32, lead)
        _check("Pr_b", Pr_b, (B,), torch.float32, lead)
        lib = _block_lib(one)
        if len(rows) > lib.frame_readd_max_shards():
            raise ValueError(f"the re-add kernel takes at most "
                             f"{lib.frame_readd_max_shards()}"
                             f" shards, got {len(rows)}")
        jmax = max(r.shape[0] for r in rows)
        if src is None:
            src = rank_table(granks, J_fix, jmax, lead)
        _check("src", src, (nb, J_fix + 1), torch.int32, lead)
        # The rows' pointers go to the kernel by value, in the call record
        # prepared once: each launch passes the record and the block.
        ptrs = (ctypes.c_void_p * len(rows))(*[r.data_ptr() for r in rows])
        self._call = ctypes.create_string_buffer(lib.frame_readd_call_size())
        err = lib.frame_readd_prepare(
            ptrs, len(rows), src.data_ptr(), J_fix, jmax, Or.data_ptr(),
            Er.data_ptr(), Pr_b.data_ptr(), O.data_ptr(), E.data_ptr(), K, B,
            lead.index or 0, torch.cuda.current_stream(lead).cuda_stream,
            self._call)
        if err != 0:
            raise RuntimeError(f"frame_readd_prepare failed: CUDA error "
                               f"{err}")
        self._fn = lib.frame_readd_launch
        # The kernel reads and writes these through the record's pointers.
        self._keep = (rows, src, Or, Er, Pr_b, O, E)

    def release_inputs(self) -> None:
        """Drop the tensors the record points at (a mesh plan holds the
        rows and O', E' and binds each pass's src, Pr_b and O, E)."""
        self._keep = None

    def launch(self, b: int) -> None:
        global launches_readd
        err = self._fn(self._call, b)
        if err != 0:
            raise RuntimeError(f"frame_readd launch failed: CUDA error "
                               f"{err}")
        launches_readd += 1


def _one_copy(t):
    """t as a parity pair of one buffer (stride 0)."""
    return t.expand(2, *t.shape)


# ---- The mesh pass: a plan made once per pass geometry, one native call ----

# The lead inputs of a pass that a shard on another card gets copies of.
INPUTS = ("O", "E", "removal", "Y", "sigma", "theta", "Pr_b", "src")
# The fields of a shard's per-block call record and of the re-add record
# that the native pass binds at every pass, in csrc/fused_estep_block.cu's
# order (F_*, R_*).
BLOCK_FIELDS = ("ZP3", "Y", "sigma", "theta", "Pr_b", "removal", "slots",
                "O", "E", "cache", "ybuf", "kbuf", "rw", "lo", "src",
                "stream")
READD_FIELDS = ("src", "Pr_b", "O", "E", "stream")
_OP_CODES = dict(record=0, wait=1, copy=2, zero=3, launch=4, readd=5)
_OP_WIDTH = 8


def _stream(s: int, lead_card: int):
    """The stream symbol of shard s: the lead card's current stream for
    shard 0, a side stream of its own for every other shard."""
    return ("cur", lead_card) if s == 0 else ("side", s)


def pass_schedule(cards, nb: int, multi: bool = False, windowed=()):
    """The order in which a mesh pass issues its work, as symbolic ops:
    ("record", event, stream), ("wait", stream, event), ("copy", stream,
    dst, src), ("zero", stream, buffer), ("launch", shard, block, readd),
    ("readd", block) and ("gather", block) (across processes: the block's
    all-gather, issued from Python between native calls). cards[s] is
    shard s's card; shard 0 runs on the lead card's current stream
    ("cur", cards[0]), every other shard on a stream of its own ("side",
    s); windowed[s]: the shard returns an r window, zeroed first.

    Start: each side stream waits for its card's current stream. Per block
    b: the fork (the lead stream's event, each side stream waiting on it;
    a shard on another card gets copies of the pass's lead inputs at b = 0,
    else of the lead card's frame of block b - 1), one launch per shard
    (b > 0: from block b - 1's re-add, folded into its prologue), the join
    (such a shard's rows copied into the lead card's frame, its stream's
    event, the lead stream waiting on it). After the last block: the
    re-add launch on the lead stream, and the current stream of each other
    card waits for its shards. The host never waits."""
    S, lead = len(cards), cards[0]
    side = range(1, S)
    remote = [c != lead for c in cards]
    ops = []
    for c in dict.fromkeys(cards[s] for s in side):
        ops.append(("record", ("start", c), ("cur", c)))
        ops += [("wait", ("side", s), ("start", c)) for s in side
                if cards[s] == c]
    ops += [("zero", _stream(s, lead), ("Rw", s)) for s in range(S)
            if s < len(windowed) and windowed[s]]
    for b in range(nb):
        if S > 1:
            ops.append(("record", ("fork",), ("cur", lead)))
        for s in side:
            ops.append(("wait", ("side", s), ("fork",)))
            if remote[s]:
                if b == 0:
                    ops += [("copy", ("side", s), ("r", x, s), ("in", x))
                            for x in INPUTS]
                else:
                    ops.append(("copy", ("side", s), ("fcopy", s),
                                ("frame", (b - 1) & 1)))
        ops += [("launch", s, b, b > 0) for s in range(S)]
        for s in side:
            if remote[s]:
                ops.append(("copy", ("side", s), ("rows", s, b & 1),
                            ("brows", s)))
            ops.append(("record", ("done", s), ("side", s)))
            ops.append(("wait", ("cur", lead), ("done", s)))
        if multi:
            ops.append(("gather", b))
    ops.append(("readd", nb - 1))
    ops += [("wait", ("cur", cards[s]), ("done", s)) for s in side
            if remote[s]]
    return ops


def plan_key(tables, ZP3s, Y, theta, O, fast_ent: bool, J_fix: int,
             windows=None, R3s=None, precision: str = "float32") -> tuple:
    """What shapes a mesh pass: the lead and shard devices, the shards'
    slabs, the mesh's shard count and whether it spans processes, the
    blocks and slots, J_fix, d, K, B, the objective form, the store (K1,
    the r windows' widths, K2's R dtypes) and the precision (the kernels'
    variant). Passes of one key share a plan."""
    S_all = len(tables.granks)
    return (O.device, tuple(z.device for z in ZP3s),
            tuple(tuple(z.shape) for z in ZP3s), S_all,
            spans_processes(S_all), tuple(tables.removal.shape),
            tuple(tables.slots[0].shape), J_fix, tuple(Y.shape),
            theta.shape[0], bool(fast_ent),
            None if windows is None else tuple(
                None if w is None else w[1] for w in windows),
            None if R3s is None else tuple(r.dtype for r in R3s), precision)


class _MeshPlan:
    """Everything a mesh pass of one geometry (`plan_key`) needs that does
    not change from pass to pass, made on its first pass: per shard the
    per-block call record and its scratch (`_BlockLaunch`: unit partials,
    tickets, the block-removed O', E' and block rows by block parity), the
    lead card's frame (or, across processes, the send and gathered
    buffers and their all-gather), the re-add record (`_Readd`), a side
    stream for every shard after the first and the pass's events; for a
    shard on another card its copies of the pass's lead inputs, of a
    block's frame and its own rows; the outputs (per-chunk cache, ybuf,
    kbuf rows per shard and O|E) twice, used by passes in turn, and each
    windowed shard's r window; the pass's order (`pass_schedule`) as the
    native walker's table, and the table P of values it reads.

    `run` checks the pass's inputs, writes their pointers (and the output
    set's, and the cards' current streams) into P and issues the pass in
    one native call (across processes one per block, each followed by the
    block's all-gather, and one for the last re-add): no allocation, no
    new stream, no host wait. Its results are views of the plan's
    buffers: a pass's per-chunk rows and O, E stay valid through the next
    pass of the plan, its r windows until then.

    On CPU shards the plan holds its buffers, order and bindings only (no
    native call: the CPU runs `mesh_round`); `cards` (default: the shards'
    card indices) lets a test lay a CPU mesh out as several cards."""

    def __init__(self, tables, ZP3s, Y, sigma, theta, Pr_b, O, E,
                 fast_ent: bool, J_fix: int, windows, R3s, src, cards=None,
                 precision: str = "float32"):
        global plans_made
        lead = O.device
        S, S_all = len(ZP3s), len(tables.granks)
        K, d, B = Y.shape[1], Y.shape[0], theta.shape[0]
        nb, J = tables.removal.shape[0], tables.slots[0].shape[1]
        if ZP3s[0].device != lead:
            raise ValueError(f"shard 0 lies on {ZP3s[0].device}, the pass's "
                             f"lead device (of O) is {lead}")
        self.cards = list(cards or [z.device.index or 0 for z in ZP3s])
        self.lead, self.nb, self.S, self.J_fix = lead, nb, S, J_fix
        self.K, self.B, self.d = K, B, d
        self.multi = spans_processes(S_all)
        self.write_r = R3s is not None
        self.one = one_pass(precision)
        windowed = [windows is not None and windows[s] is not None
                    for s in range(S)]
        cuda = lead.type == "cuda"
        row, f32 = (J, K, B + 1), dict(dtype=torch.float32)
        fixed = {("null",): 0}
        if self.multi:
            send = torch.zeros((S,) + row, device=lead, **f32)
            gathered = torch.zeros((S_all,) + row, device=lead, **f32)
            frame = _one_copy(gathered)
            lead_rows = [_one_copy(send[s]) for s in range(S)]
            self.gather = gatherer(gathered, send)
        else:
            frame = torch.zeros((2, S) + row, device=lead, **f32)
            lead_rows = [frame[:, s] for s in range(S)]
            self.gather = None
        for q in (0, 1):
            fixed["frame", q] = frame[q]
            for s in range(S):
                fixed["rows", s, q] = lead_rows[s][q]
        # Rows of chunks no slot holds (a shard's padding) are never
        # written: they stay the zeros of these first writes.
        self.ring = [dict(out=[tuple(torch.zeros(shape, device=z.device,
                                                 **f32) for shape in (
            (z.shape[0], K, B + 1), (z.shape[0], K, d), (z.shape[0], 2)))
            for z in ZP3s], OE=torch.zeros((2, K, B), device=lead, **f32))
            for _ in range(2)]
        self.parity = 0
        lead_in = dict(O=O.contiguous(), E=E.contiguous(),
                       removal=tables.removal, Y=Y, sigma=sigma, theta=theta,
                       Pr_b=Pr_b, src=src)
        self.binding, self.Rws, self._side, self.launchers = [], [], {}, []
        for s, ZP3 in enumerate(ZP3s):
            dev = ZP3.device
            Rw = (torch.zeros((windows[s][1], K, ZP3.shape[2]), device=dev,
                              **f32) if windowed[s] else None)
            self.Rws.append(Rw)
            if Rw is not None:
                fixed["Rw", s] = Rw
            bind = dict(ZP3=("ZP3", s), slots=("slots", s),
                        cache=("out", "cache", s), ybuf=("out", "ybuf", s),
                        kbuf=("out", "kbuf", s), lo=("lo", s),
                        rw=(("R3", s) if R3s is not None else ("Rw", s)
                            if Rw is not None else ("null",)),
                        stream=_stream(s, self.cards[0]))
            if self.cards[s] != self.cards[0]:
                ins = {x: torch.empty(t.shape, dtype=t.dtype, device=dev)
                       for x, t in lead_in.items()}
                for x, t in ins.items():
                    fixed["r", x, s] = t
                    bind[x] = ("r", x, s)
                fixed["fcopy", s] = torch.empty(frame.shape[1:], device=dev,
                                                **f32)
                fixed["brows", s] = torch.empty(row, device=dev, **f32)
                fr, br = _one_copy(fixed["fcopy", s]), _one_copy(
                    fixed["brows", s])
            else:
                ins = lead_in
                bind.update({x: ("in", x) for x in INPUTS})
                fr, br = frame, lead_rows[s]
            self.binding.append(bind)
            if not cuda:
                continue
            if s:
                self._side["side", s] = torch.cuda.Stream(device=dev)
            ln = _BlockLaunch(
                tables.slots[s], ins["removal"], ZP3, ins["Y"], ins["sigma"],
                ins["theta"], ins["Pr_b"], ins["O"], ins["E"], fast_ent,
                self.ring[0]["out"][s], J_fix + 1, Rw,
                windows[s][0] if windowed[s] else 0,
                None if R3s is None else R3s[s], self._side.get(("side", s)),
                brows=br, frame=fr, src=ins["src"], J_fix=J_fix,
                precision=precision)
            ln.release_inputs()
            self.launchers.append(ln)
        self.readd_binding = dict(src=("in", "src"), Pr_b=("in", "Pr_b"),
                                  O=("out", "O"), E=("out", "E"),
                                  stream=("cur", self.cards[0]))
        self.schedule = pass_schedule(self.cards, nb, self.multi, windowed)
        self.fixed = fixed
        self._encode()
        plans_made += 1
        if not cuda:
            return
        last = (nb - 1) & 1
        OE = self.ring[0]["OE"]
        self.readd = _Readd(list(frame[last].unbind(0)), tables.granks,
                            *self.launchers[0].removed(last),
                            lead_in["Pr_b"], J_fix, OE[0], OE[1], src=src,
                            one=self.one)
        self.readd.release_inputs()
        self._create()

    def _encode(self) -> None:
        """Index every symbol the schedule and the bindings name into P,
        and the schedule into the walker's table (ops) and its segments."""
        lead = self.cards[0]
        index, events = {}, {}

        def slot(sym):
            return index.setdefault(sym, len(index))

        def dev_of(sym):
            kind = sym[0]
            if kind == "cur":
                return sym[1]
            if kind == "side":
                return self.cards[sym[1]]
            if kind in ("in", "out"):
                return lead if kind == "in" or len(sym) == 2 else \
                    self.cards[sym[2]]
            if kind in ("ZP3", "slots", "R3", "lo", "Rw", "fcopy", "brows"):
                return self.cards[sym[1]]
            if kind == "r":
                return self.cards[sym[2]]
            return lead         # frame, rows, null
        for bind in self.binding:
            for f in BLOCK_FIELDS:
                slot(bind[f])
        for f in READD_FIELDS:
            slot(self.readd_binding[f])
        rows, segments, begin = [], [], 0
        for op in self.schedule:
            kind = op[0]
            code = [0] * _OP_WIDTH
            code[0] = _OP_CODES.get(kind, -1)
            if kind == "record":
                ev = events.setdefault(op[1], (len(events), dev_of(op[2])))
                if ev[1] != dev_of(op[2]):
                    raise ValueError(f"event {op[1]} recorded on two cards")
                code[1:4] = ev[0], slot(op[2]), dev_of(op[2])
            elif kind == "wait":
                code[1:4] = slot(op[1]), events[op[2]][0], dev_of(op[1])
            elif kind == "copy":
                st, dst, src = op[1:]
                code[1:8] = (slot(st), dev_of(st), slot(dst), dev_of(dst),
                             slot(src), dev_of(src), self._nbytes(dst))
            elif kind == "zero":
                code[1:5] = (slot(op[1]), dev_of(op[1]), slot(op[2]),
                             self._nbytes(op[2]))
            elif kind == "launch":
                code[1:4] = op[1], op[2], int(op[3])
            elif kind == "readd":
                code[1] = op[1]
            elif kind == "gather":
                segments.append((begin, len(rows), True))
                begin = len(rows)
                continue
            rows.append(code)
        segments.append((begin, len(rows), False))
        self.index = index
        self.events = [dv for _, dv in sorted(events.values())]
        self.ops = rows
        # Per segment: (begin, end, gather after it, per-block launches,
        # re-add launches).
        self.segments = [
            (b, e, g, sum(r[0] == _OP_CODES["launch"] for r in rows[b:e]),
             sum(r[0] == _OP_CODES["readd"] for r in rows[b:e]))
            for b, e, g in segments]
        self._pass_slots = [(i, sym) for sym, i in index.items()
                            if sym not in self.fixed and sym[0] != "side"]

    def _nbytes(self, sym) -> int:
        t = self.fixed[sym]
        return t.numel() * t.element_size()

    def _create(self) -> None:
        """The native plan: the call records, bindings and events; P with
        the fixed values."""
        lib = _block_lib(self.one)
        n = len(self.index)
        self.P = (ctypes.c_longlong * n)()
        for sym, i in self.index.items():
            if sym in self.fixed:
                self.P[i] = _value(self.fixed[sym])
            elif sym in self._side:
                self.P[i] = self._side[sym].cuda_stream
        self._ops = (ctypes.c_longlong * (len(self.ops) * _OP_WIDTH))(
            *[v for r in self.ops for v in r])
        calls = (ctypes.c_void_p * self.S)(
            *[ctypes.addressof(ln._call) for ln in self.launchers])
        bind = (ctypes.c_int * (self.S * len(BLOCK_FIELDS)))(
            *[self.index[b[f]] for b in self.binding for f in BLOCK_FIELDS])
        rbind = (ctypes.c_int * len(READD_FIELDS))(
            *[self.index[self.readd_binding[f]] for f in READD_FIELDS])
        evdev = (ctypes.c_int * max(1, len(self.events)))(*self.events)
        handle = ctypes.c_void_p()
        err = lib.mesh_plan_create(self.S, calls, bind,
                                   ctypes.addressof(self.readd._call), rbind,
                                   len(self.events), evdev,
                                   ctypes.byref(handle))
        if err != 0:
            raise RuntimeError(f"mesh_plan_create failed: CUDA error {err}")
        self._handle = handle.value
        self._free = weakref.finalize(self, lib.mesh_plan_destroy,
                                      self._handle)
        self._cur = {c: torch.device("cuda", c) for c in set(self.cards)}

    def values(self, tables, ZP3s, Y, sigma, theta, Pr_b, O, E, windows,
               R3s, src) -> dict:
        """The pass's symbols: its inputs, the output set in turn and the
        cards' current streams (zero on the CPU)."""
        out = self.ring[self.parity]
        v = {("in", "O"): O, ("in", "E"): E, ("in", "removal"):
             tables.removal, ("in", "Y"): Y, ("in", "sigma"): sigma,
             ("in", "theta"): theta, ("in", "Pr_b"): Pr_b, ("in", "src"): src,
             ("out", "O"): out["OE"][0], ("out", "E"): out["OE"][1]}
        for s, ZP3 in enumerate(ZP3s):
            v["ZP3", s], v["slots", s] = ZP3, tables.slots[s]
            v["lo", s] = (0 if windows is None or windows[s] is None
                          else windows[s][0])
            if R3s is not None:
                v["R3", s] = R3s[s]
            for name, t in zip(("cache", "ybuf", "kbuf"), out["out"][s]):
                v["out", name, s] = t
        for c in set(self.cards):
            v["cur", c] = (torch.cuda.current_stream(self._cur[c]).cuda_stream
                           if self.lead.type == "cuda" else 0)
        return v

    def tensor(self, sym, values: dict):
        """What a symbol names in a pass with these values."""
        return self.fixed[sym] if sym in self.fixed else values[sym]

    def _check(self, tables, ZP3s, Y, sigma, theta, Pr_b, O, E, R3s, src):
        """The pass's inputs against the plan's first: the native pass reads
        them through the shapes and layouts the plan was made for."""
        lead, f32 = self.lead, torch.float32
        K, B, d = self.K, self.B, self.d
        for name, t, shape, dtype in (
                ("O", O, (K, B), f32), ("E", E, (K, B), f32),
                ("removal", tables.removal, (self.nb, K, B + 1), f32),
                ("Y", Y, (d, K), f32), ("sigma", sigma, (K,), f32),
                ("theta", theta, (B,), f32), ("Pr_b", Pr_b, (B,), f32),
                ("src", src, (self.nb, self.J_fix + 1), torch.int32)):
            _check(name, t, shape, dtype, lead)
        for s, ln in enumerate(self.launchers):
            dev = ln.device
            _check(f"ZP3s[{s}]", ZP3s[s], ln.zp3_shape, f32, dev)
            if ZP3s[s].data_ptr() % 16:
                raise ValueError("fused_estep copies the slab in 16-byte "
                                 "pieces: ZP3 must be 16-byte aligned")
            _check(f"slots[{s}]", tables.slots[s], ln.slots_shape,
                   torch.int32, dev)
            if R3s is not None:
                _check(f"R3s[{s}]", R3s[s], ln.r3_shape, ln.r3_dtype, dev)

    def run(self, tables, ZP3s, Y, sigma, theta, Pr_b, O, E, windows, R3s,
            src):
        """One pass (the results of `fused_estep_mesh`)."""
        global launches_block, launches_block_write_r, launches_readd
        global native_calls, launches_block_one_pass
        global launches_block_write_r_one_pass
        O, E = O.contiguous(), E.contiguous()
        self._check(tables, ZP3s, Y, sigma, theta, Pr_b, O, E, R3s, src)
        v = self.values(tables, ZP3s, Y, sigma, theta, Pr_b, O, E, windows,
                        R3s, src)
        for i, sym in self._pass_slots:
            self.P[i] = _value(v[sym])
        fn = _block_lib(self.one).mesh_plan_run
        for begin, end, gather, n_block, n_readd in self.segments:
            err = fn(self._handle, self.P, len(self.index), self._ops,
                     begin, end)
            native_calls += 1
            if err != 0:
                raise RuntimeError(f"mesh pass failed: CUDA error {err}")
            if self.write_r:
                launches_block_write_r += n_block
                launches_block_write_r_one_pass += n_block * self.one
            else:
                launches_block += n_block
                launches_block_one_pass += n_block * self.one
            launches_readd += n_readd
            if gather:
                self.gather()
        out = self.ring[self.parity]
        self.parity ^= 1
        return (out["OE"][0], out["OE"][1], [o[0] for o in out["out"]],
                [o[1] for o in out["out"]], [o[2] for o in out["out"]],
                list(self.Rws))


def _value(x) -> int:
    return x.data_ptr() if isinstance(x, torch.Tensor) else int(x)


_scope = threading.local()


@contextlib.contextmanager
def mesh_plans():
    """Keep the mesh passes' plans (`_MeshPlan`, one per `plan_key`) while
    the block runs, and drop them at its end: engine.fit holds one around
    a fit, so a fit's passes after its first of each geometry reuse their
    plan, and no plan outlives its fit. Nested, the outermost block owns
    them. Outside any, each pass makes a plan of its own (fresh outputs,
    the same bits)."""
    if getattr(_scope, "plans", None) is not None:
        yield _scope.plans
        return
    _scope.plans = {}
    try:
        yield _scope.plans
    finally:
        _scope.plans = None


def plan_for(key, make):
    """The active `mesh_plans` block's plan of `key`, made by make() on its
    first use; outside a block a new one each call."""
    plans = getattr(_scope, "plans", None)
    plan = None if plans is None else plans.get(key)
    if plan is None:
        plan = make()
        if plans is not None:
            plans[key] = plan
    return plan


def active_plans() -> dict:
    """The plans of the active `mesh_plans` block, by key ({} outside)."""
    return dict(getattr(_scope, "plans", None) or {})


def fused_estep_mesh(tables, ZP3s, Y, sigma, theta, Pr_b, O, E,
                     fast_ent: bool, J_fix: int, windows=None, R3s=None,
                     precision: str = "float32"):
    """One E-step round on a mesh of several shards (K1, its r windows or
    K2), with the signature and results of `ops.update_r_fused.mesh_round`,
    its plain version, which CPU shards run (in fp32 under either
    precision; on CUDA shards `precision` picks the kernels' variant).

    On CUDA shards the pass runs from its plan (`_MeshPlan`, by
    `plan_key`: the active `mesh_plans` block's, made on its first pass of
    that geometry; outside one, a plan of its own) in one native call
    (csrc/fused_estep_block.cu `mesh_plan_run`) that walks `pass_schedule`:
    block 0 of every shard starts from O, E; block b > 0 starts from block
    b - 1's re-add, which each launch's prologue forms from its own
    block-removed O', E' of block b - 1 and the lead card's frame of block
    b - 1 (every shard's rows, written there by the launches, by block
    parity: shard t's launch b may write its rows while shard s's launch
    b still reads t's rows of block b - 1). After the last block one
    re-add launch writes the pass's O, E. The host never waits.

    Across processes (parallel.mesh.spans_processes) the process's shards
    write their block rows into one send buffer on the lead card, and per
    block, after the join, one all-gather moves every rank's rows into the
    gathered buffer, which is the frame the next block's launches read:
    it is overwritten only by the next all-gather, after those launches
    are joined, so it needs one copy. The pass is then one native call per
    block, each followed by the block's all-gather, and one for the last
    re-add, which every rank launches from the gathered rows, so no rank
    broadcasts O, E. Under NCCL the all-gather orders itself on the lead
    card's current stream and the host does not wait; under gloo the rows
    are staged through the host (parallel.mesh.gatherer).

    Each pass is one `harmony::mesh_pass` range."""
    with span("harmony::mesh_pass"):
        lead = O.device
        one_pass(precision)
        if lead.type == "cpu":
            for s, ZP3 in enumerate(ZP3s):
                _check_round(tables.slots[s], tables.removal, ZP3, Y, sigma,
                             theta, Pr_b, O, E)
            return mesh_round(tables, ZP3s, Y, sigma, theta, Pr_b, O, E,
                              fast_ent, J_fix, windows, R3s)
        src = tables.src
        if src is None or src.device != lead:
            src = rank_table(tables.granks, J_fix, tables.slots[0].shape[1],
                             lead)
        plan = plan_for(
            plan_key(tables, ZP3s, Y, theta, O, fast_ent, J_fix, windows,
                     R3s, precision),
            lambda: _MeshPlan(tables, ZP3s, Y, sigma, theta, Pr_b, O, E,
                              fast_ent, J_fix, windows, R3s, src,
                              precision=precision))
        return plan.run(tables, ZP3s, Y, sigma, theta, Pr_b, O, E, windows,
                        R3s, src)


def fused_estep(slots, removal, ZP3, Y, sigma, theta, Pr_b, O, E,
                fast_ent: bool, lo: int = 0, width: int = 0,
                precision: str = "float32", codes=None):
    """One fused E-step round (K1); see `ops.update_r_fused.fused_update_nor`
    for the arguments and results. precision: the products' variant on a
    card (CPU tensors: fp32 under either). codes: a one-covariate design's
    (nc1, CH) int32 batch levels (-1: padding), which a wide round on a
    card takes the codes plan with (the plain version reads the design
    rows)."""
    _, K, _, _, CH = _check_round(slots, removal, ZP3, Y, sigma, theta,
                                  Pr_b, O, E, precision)
    _check_codes(codes, ZP3)
    if width < 0 or lo < 0:
        raise ValueError(f"bad r window lo={lo} width={width}")
    if ZP3.device.type == "cpu":
        return fused_update_nor(slots, removal, ZP3, Y, sigma, theta, Pr_b,
                                O, E, fast_ent, lo, width)

    global launches, launches_one_pass
    one = one_pass(precision)
    if width > 0:
        Rw = torch.zeros((width, K, CH), dtype=torch.float32,
                         device=ZP3.device)
        out = _launch("fused_estep_r_window", [Rw.data_ptr(), lo, width],
                      slots, removal, ZP3, Y, sigma, theta, Pr_b, O, E,
                      fast_ent, one, codes=codes)
    else:
        Rw = None
        out = _launch("fused_estep_round", [], slots, removal, ZP3, Y,
                      sigma, theta, Pr_b, O, E, fast_ent, one, codes=codes)
    launches += 1
    launches_one_pass += one
    return (*out, Rw)


def fused_estep_r(slots, removal, ZP3, R3, Y, sigma, theta, Pr_b, O, E,
                  fast_ent: bool, precision: str = "float32", codes=None):
    """One stored-R E-step round (K2), writing r into the caller's
    chunk-major R3 (nc1, K, CH), whose dtype (float32 or bfloat16) picks
    the store; see `ops.update_r_fused.fused_update_r`. precision, codes:
    as fused_estep's. Returns (R3, O, E, cache, ybuf, kbuf)."""
    nc1, K, _, _, CH = _check_round(slots, removal, ZP3, Y, sigma, theta,
                                    Pr_b, O, E, precision)
    _check_codes(codes, ZP3)
    _check("R3", R3, (nc1, K, CH), (torch.float32, torch.bfloat16),
           ZP3.device)
    if ZP3.device.type == "cpu":
        return fused_update_r(slots, removal, ZP3, R3, Y, sigma, theta, Pr_b,
                              O, E, fast_ent)

    global launches_write_r, launches_write_r_one_pass
    one = one_pass(precision)
    out = _launch("fused_estep_write_r",
                  [R3.data_ptr(), int(R3.dtype == torch.bfloat16)],
                  slots, removal, ZP3, Y, sigma, theta, Pr_b, O, E, fast_ent,
                  one, codes=codes)
    launches_write_r += 1
    launches_write_r_one_pass += one
    return (R3, *out)
