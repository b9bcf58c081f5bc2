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
of K1, of its r window or of K2, an ordinary launch of one CTA per unit,
csrc/fused_estep_block.cu), whose prologue re-adds block b - 1 across the
shards from every shard's rows of it; after the last block, the re-add
kernel (csrc/frame_readd.cu, `_Readd`) on the lead device, once per pass.
The inputs are checked and the scratch allocated once per pass; the block
loop issues the launches and events and nothing else on one card (and the
copies of the block rows between cards on several). Across processes each
block's rows of the process's shards cross in one all-gather, and every
rank's launches read the gathered rows. Its plain version is
`ops.update_r_fused.mesh_round` (per block `fused_update_block`, then
`frame_readd`; one folded launch is `fused_update_block_folded`);
`launches_block` (K1 and its r window), `launches_block_write_r` (K2) and
`launches_readd` count the launches.

The kernel's static work split is `kernel_geometry`: the padded sizes, the
units (runs of 64-cell tiles of one slot) and the shapes of the partials.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ...parallel.mesh import gatherer, spans_processes
from ..update_r_fused import fused_update_nor, fused_update_r, mesh_round
from . import build

launches = 0
launches_write_r = 0
launches_block = 0
launches_block_write_r = 0
launches_readd = 0

TILE = 64            # cells per tile (csrc/fused_estep.cu TILE)
UNITS_PER_SM = 2     # units per block aimed at for each SM

_P, _I = ctypes.c_void_p, ctypes.c_int
_lib = None
_block = None
_readd_lib = None


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


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


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = build.load("fused_estep")
        common = [_P] * 17
        tail = [_I] * 9 + [_P]
        lib.fused_estep_round.argtypes = common + tail
        lib.fused_estep_r_window.argtypes = common + [_P, _I, _I] + tail
        lib.fused_estep_write_r.argtypes = common + [_P, _I] + tail
        for fn in (lib.fused_estep_round, lib.fused_estep_r_window,
                   lib.fused_estep_write_r):
            fn.restype = _I
        lib.fused_estep_smem.argtypes = [_I, _I, _I]
        lib.fused_estep_grid.argtypes = [_I, _I, _I, _I]
        for fn in (lib.fused_estep_smem, lib.fused_estep_smem_limit,
                   lib.fused_estep_tile, lib.fused_estep_grid):
            fn.restype = _I
        if lib.fused_estep_tile() != TILE:
            raise RuntimeError(f"fused_estep.cu tiles {lib.fused_estep_tile()}"
                               f" cells, the wrapper {TILE}")
        _lib = lib
    return _lib


def _block_lib():
    global _block
    if _block is None:
        lib = build.load("fused_estep_block")
        lib.fused_estep_block_prepare.argtypes = (
            [_P] * 17 + [_P, _P, _I, _P, _I, _P, _I, _P] + [_I] * 3
            + [_I] * 9 + [_P, _I, _P])
        lib.fused_estep_block_launch.argtypes = [_P, _I, _I]
        lib.fused_estep_block_setup.argtypes = [_I, _I, _I]
        for fn in (lib.fused_estep_block_prepare, lib.fused_estep_block_launch,
                   lib.fused_estep_block_call_size,
                   lib.fused_estep_block_setup):
            fn.restype = _I
        _block = lib
    return _block


def _frame_readd_lib():
    global _readd_lib
    if _readd_lib is None:
        lib = build.load("frame_readd")
        lib.frame_readd_prepare.argtypes = [_P, _I, _P, _I, _I, _P, _P, _P,
                                            _P, _P, _I, _I, _I, _P, _P]
        lib.frame_readd_launch.argtypes = [_P, _I]
        for fn in (lib.frame_readd_prepare, lib.frame_readd_launch,
                   lib.frame_readd_max_shards, lib.frame_readd_call_size):
            fn.restype = _I
        _readd_lib = lib
    return _readd_lib


def launch_grid(K: int, B: int, d: int, r_bf16: bool = False) -> int:
    """CTAs of one round's launch on the current card (K2 in bf16 with
    r_bf16)."""
    grid = _kernel_lib().fused_estep_grid(K, B, d, int(r_bf16))
    if grid < 0:
        raise RuntimeError(f"fused_estep occupancy query failed: CUDA error "
                           f"{-grid}")
    return grid


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


def _check_round(slots, removal, ZP3, Y, sigma, theta, Pr_b, O, E):
    """Check the inputs every round takes; returns (nc1, K, B, d, CH). The
    slot range is checked here on the CPU and by the kernel on the card."""
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
        lib = _kernel_lib()
        smem = lib.fused_estep_smem(K, B, d)
        if smem > lib.fused_estep_smem_limit():
            raise ValueError(
                f"fused_estep: K={K}, B={B}, d={d} needs {smem} bytes of "
                f"shared memory per CTA, above the card's "
                f"{lib.fused_estep_smem_limit()}")
        if CH % 4 or ZP3.data_ptr() % 16:
            raise ValueError(f"fused_estep copies the slab in 16-byte pieces:"
                             f" chunk size {CH} must be a multiple of 4 and "
                             f"ZP3 16-byte aligned")
    return nc1, K, B, d, CH


def _launch(entry, extra, slots, removal, ZP3, Y, sigma, theta, Pr_b, O, E,
            fast_ent, J_glob=None, out=None):
    """Allocate the outputs and scratch and run one round through the
    library function `entry` (extra: its arguments between the common
    pointers and the dimensions). out: the caller's (cache, ybuf, kbuf)
    to write into, else new ones. Returns (O, E, cache, ybuf, kbuf)."""
    nc1, _, CH = ZP3.shape
    d, K = Y.shape
    B = theta.shape[0]
    nb, J = slots.shape
    dev, f32 = ZP3.device, torch.float32
    geo = kernel_geometry(K, B, d, CH, J, _sm_count(dev.index or 0), J_glob)
    # Partials of S by block parity: a block's ybuf rows are summed while
    # the next block runs.
    part = torch.empty((2, *geo.part_shape), dtype=f32, device=dev)
    kpart = torch.empty(geo.kpart_shape, dtype=f32, device=dev)
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
                                   ybuf, kbuf, O1, E1)]
    with torch.cuda.device(dev):
        err = getattr(_kernel_lib(), entry)(
            *ptrs, *extra, K, B, d, CH, nb, J, geo.ng, nc1,
            int(bool(fast_ent)), stream)
    if err != 0:
        raise RuntimeError(f"{entry} cooperative launch failed: CUDA error "
                           f"{err}")
    return O1, E1, cache, ybuf, kbuf


def rank_table(granks, J_fix: int, jmax: int, device) -> torch.Tensor:
    """The rank table of a pass's re-adds, (nb, J_fix + 1) int32 on
    `device`: entry [b, r] codes the row that holds rank r of block b,
    s * jmax + j for slot j of shard s (granks[s] (nb, J_s), J_s <= jmax,
    the ranks of shard s's slots; J_fix: no rank), or -1 where no shard
    holds rank r (a zero row). Column J_fix takes every slot without a
    rank: scratch, never read. The per-block prologue (`_BlockLaunch`) and
    the re-add kernel (`_Readd`) read it."""
    nb = granks[0].shape[0]
    src = torch.full((nb, J_fix + 1), -1, dtype=torch.int32, device=device)
    for s, g in enumerate(granks):
        code = (s * jmax + torch.arange(g.shape[1], dtype=torch.int32,
                                        device=device))
        src.scatter_(1, g.to(device, torch.int64).clamp_(0, J_fix),
                     code.expand(nb, -1).contiguous())
    return src


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
    launch starts from a re-add."""

    def __init__(self, slots, removal, ZP3, Y, sigma, theta, Pr_b, O, E,
                 fast_ent: bool, out, J_glob: int, Rw=None, lo: int = 0,
                 R3=None, stream=None, brows=None, frame=None, src=None,
                 J_fix: int = 0):
        nc1, K, B, d, CH = _check_round(slots, removal, ZP3, Y, sigma,
                                        theta, Pr_b, O, E)
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
        self.folds = frame is not None
        if self.folds:
            _check_pair("frame", frame, (frame.shape[1], J, K, B + 1), dev)
            _check("src", src, (nb, J_fix + 1), torch.int32, dev)
        if dev.type == "cpu":
            return
        lib = _block_lib()
        geo = kernel_geometry(K, B, d, CH, J, _sm_count(dev.index or 0),
                              J_glob)
        with torch.cuda.device(dev):
            err = lib.fused_estep_block_setup(K, B, d)
        if err != 0:
            raise RuntimeError(f"fused_estep_block: shared memory of K={K},"
                               f" B={B}, d={d} refused: CUDA error {err}")
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
            *[t.data_ptr() for t in (
                ZP3, Y, sigma, theta, Pr_b, removal, slots, self.O0, self.E0,
                self.part, self.kpart)], None, *[t.data_ptr() for t in (
                    out[0], out[1], out[2], self.O1, self.E1, self.tickets,
                    brows)], brows.stride(0), *fold, *store, K, B, d, CH, nb,
            J, geo.ng, nc1, int(bool(fast_ent)), stream.cuda_stream,
            dev.index or 0, self._call)
        if err != 0:
            raise RuntimeError(f"fused_estep_block_prepare failed: CUDA "
                               f"error {err}")
        self._fn = lib.fused_estep_block_launch
        self.device = dev

    def launch(self, b: int, readd_prev: bool = False) -> None:
        global launches_block, launches_block_write_r
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
        else:
            launches_block += 1

    def removed(self, b: int):
        """Block b's block-removed O, E (after launch(b))."""
        return self.O1[b & 1], self.E1[b & 1]


class _Readd:
    """The re-add launches of a round on the lead device: rows[s] (J_s, K,
    B+1) hold shard s's block rows (on the lead device), granks[s] (nb,
    J_s) their ranks, from which the pass's `rank_table` is built once (or
    src, that table, given); `launch(b)` forms O, E of block b from Or,
    Er."""

    def __init__(self, rows, granks, Or, Er, Pr_b, J_fix: int, O, E,
                 src=None):
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
        if len(rows) > _frame_readd_lib().frame_readd_max_shards():
            raise ValueError(f"the re-add kernel takes at most "
                             f"{_frame_readd_lib().frame_readd_max_shards()}"
                             f" shards, got {len(rows)}")
        jmax = max(r.shape[0] for r in rows)
        if src is None:
            src = rank_table(granks, J_fix, jmax, lead)
        _check("src", src, (nb, J_fix + 1), torch.int32, lead)
        lib = _frame_readd_lib()
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

    def launch(self, b: int) -> None:
        global launches_readd
        err = self._fn(self._call, b)
        if err != 0:
            raise RuntimeError(f"frame_readd launch failed: CUDA error "
                               f"{err}")
        launches_readd += 1


class _Exchange:
    """The streams of a mesh pass and what crosses between cards at each
    block. Shard 0 runs on the lead card's current stream (the lead
    stream), which also runs the pass's last re-add; every other shard runs
    on a stream of its own on its card, so the shards of one card run at
    once. `start()` lets each side stream wait for its card's current
    stream (the pass's inputs and scratch); `fork(b)` lets it wait for the
    lead stream's work so far (every shard's block b - 1, joined) and
    copies to a shard on another card the pass's O|E (b = 0) or the lead
    card's frame of block b - 1; `join(b)` copies such a shard's block rows
    into the lead card's frame and lets the lead stream wait for every
    side stream; `end()` lets each card's current stream wait for its side
    streams (the pass's outputs, and the reuse of its scratch). torch's
    events and copies set each stream's device: the host never waits."""

    def __init__(self, lead, shards, oe, frame, remote):
        """shards: the `_BlockLaunch`es of shards 1..; oe: the lead card's
        (2, K, B) O|E; frame: the lead card's (2, S, J, K, B+1) frame by
        parity; remote: per shard None on the lead card, else (its O|E, its
        copy of a block's frame, the lead card's (2, J, K, B+1) rows by
        parity its own are copied into)."""
        self.lead, self.oe, self.frame = (torch.cuda.current_stream(lead),
                                          oe, frame)
        self._fork_ev = torch.cuda.Event()
        self._side = [(ln.stream, torch.cuda.Event(), ln.brows, r)
                      for ln, r in zip(shards, remote)]

    def start(self) -> None:
        for st, *_ in self._side:
            st.wait_stream(torch.cuda.current_stream(st.device))

    def fork(self, b: int) -> None:
        self._fork_ev.record(self.lead)
        for st, _, _, r in self._side:
            st.wait_event(self._fork_ev)
            if r is not None:
                with torch.cuda.stream(st):
                    if b == 0:
                        r[0].copy_(self.oe, non_blocking=True)
                    else:
                        r[1].copy_(self.frame[(b - 1) & 1],
                                   non_blocking=True)

    def join(self, b: int) -> None:
        for st, ev, brows, r in self._side:
            if r is not None:
                with torch.cuda.stream(st):
                    r[2][b & 1].copy_(brows[b & 1], non_blocking=True)
            ev.record(st)
            self.lead.wait_event(ev)

    def end(self) -> None:
        for st, *_ in self._side:
            torch.cuda.current_stream(st.device).wait_stream(st)


def _one_copy(t):
    """t as a parity pair of one buffer (stride 0)."""
    return t.expand(2, *t.shape)


def fused_estep_mesh(tables, ZP3s, Y, sigma, theta, Pr_b, O, E,
                     fast_ent: bool, J_fix: int, windows=None, R3s=None):
    """One E-step round on a mesh of several shards (K1, its r windows or
    K2), with the signature and results of `ops.update_r_fused.mesh_round`,
    its plain version, which CPU shards run.

    On CUDA shards: per shard a `_BlockLaunch` (checks and scratch once per
    pass). Block 0 of every shard starts from O, E; block b > 0 starts from
    block b - 1's re-add, which each launch's prologue forms from its own
    block-removed O', E' of block b - 1 and the lead card's frame of block
    b - 1 (every shard's rows, written there by the launches, by block
    parity: shard t's launch b may write its rows while shard s's launch
    b still reads t's rows of block b - 1). After the last block one
    re-add launch (`_Readd`) writes the pass's O, E. Per block: the
    exchange's fork, one launch per shard and its join (`_Exchange`: a
    stream for each shard after the first, events, and for a shard on
    another card the copies of the frame and of its rows; the host never
    waits).

    Across processes (parallel.mesh.spans_processes) the process's shards
    write their block rows into one send buffer on the lead card, and per
    block, after the join, one all-gather moves every rank's rows into a
    gathered buffer allocated once per pass, which is the frame the next
    block's launches read: it is overwritten only by the next all-gather,
    after those launches are joined, so it needs one copy. Every rank
    launches the last re-add from the gathered rows, so no rank broadcasts
    O, E. Under NCCL the all-gather orders itself on the lead card's
    current stream and the host does not wait; under gloo the rows are
    staged through the host (parallel.mesh.gatherer)."""
    lead = O.device
    if lead.type == "cpu":
        for s, ZP3 in enumerate(ZP3s):
            _check_round(tables.slots[s], tables.removal, ZP3, Y, sigma,
                         theta, Pr_b, O, E)
        return mesh_round(tables, ZP3s, Y, sigma, theta, Pr_b, O, E,
                          fast_ent, J_fix, windows, R3s)
    K, d, B = Y.shape[1], Y.shape[0], theta.shape[0]
    nb, J = tables.removal.shape[0], tables.slots[0].shape[1]
    row, f32 = (J, K, B + 1), dict(dtype=torch.float32)
    multi = spans_processes(len(tables.granks))
    if multi:
        send = torch.empty((len(ZP3s),) + row, device=lead, **f32)
        gathered = torch.empty((len(tables.granks),) + row, device=lead,
                               **f32)
        frame = _one_copy(gathered)
    else:
        frame = torch.empty((2, len(ZP3s)) + row, device=lead, **f32)
    src = rank_table([g.to(lead) for g in tables.granks], J_fix, J, lead)
    # O|E at the pass's start and, after the last re-add, at its end (one
    # buffer, so one copy reaches a shard on another card).
    OE = torch.stack([O, E])
    shards, remote, outs, Rws = [], [], [], []
    for s, ZP3 in enumerate(ZP3s):
        dev, nc1, CH = ZP3.device, ZP3.shape[0], ZP3.shape[2]
        out = (torch.zeros((nc1, K, B + 1), device=dev, **f32),
               torch.zeros((nc1, K, d), device=dev, **f32),
               torch.zeros((nc1, 2), device=dev, **f32))
        win = None if windows is None else windows[s]
        Rw = (None if win is None
              else torch.zeros((win[1], K, CH), device=dev, **f32))
        # The shard's rows on the lead card: in the send buffer across
        # processes, else in the frame.
        lead_rows = _one_copy(send[s]) if multi else frame[:, s]
        if dev == lead:
            r, OEs, brows, fr, srcs = None, OE, lead_rows, frame, src
        else:
            # Its own O|E, rows and frame copy, each one buffer: the join
            # copies its rows out, the fork the frame in, on its stream.
            OEs = torch.empty_like(OE, device=dev)
            fcopy = torch.empty(frame.shape[1:], device=dev, **f32)
            r = (OEs, fcopy, lead_rows)
            brows = _one_copy(torch.empty(row, device=dev, **f32))
            fr, srcs = _one_copy(fcopy), src.to(dev)
        ln = _BlockLaunch(
            tables.slots[s], tables.removal.to(dev), ZP3, Y.to(dev),
            sigma.to(dev), theta.to(dev), Pr_b.to(dev), OEs[0], OEs[1],
            fast_ent, out, J_fix + 1, Rw, 0 if win is None else win[0],
            None if R3s is None else R3s[s],
            torch.cuda.Stream(device=dev) if s else None, brows=brows,
            frame=fr, src=srcs, J_fix=J_fix)
        remote.append(r)
        shards.append(ln)
        outs.append(out)
        Rws.append(Rw)
    exchange = _Exchange(lead, shards[1:], OE, frame, remote[1:])
    gather = gatherer(gathered, send) if multi else None
    last = (nb - 1) & 1
    readd = _Readd(list(frame[last].unbind(0)), tables.granks,
                   *shards[0].removed(last), Pr_b.contiguous(), J_fix,
                   OE[0], OE[1], src=src)
    exchange.start()
    for b in range(nb):
        exchange.fork(b)
        for ln in shards:
            ln.launch(b, b > 0)
        exchange.join(b)
        if multi:
            gather()
    readd.launch(nb - 1)
    exchange.end()
    return (OE[0], OE[1], [o[0] for o in outs], [o[1] for o in outs],
            [o[2] for o in outs], Rws)


def fused_estep(slots, removal, ZP3, Y, sigma, theta, Pr_b, O, E,
                fast_ent: bool, lo: int = 0, width: int = 0):
    """One fused E-step round (K1); see `ops.update_r_fused.fused_update_nor`
    for the arguments and results."""
    _, K, _, _, CH = _check_round(slots, removal, ZP3, Y, sigma, theta,
                                  Pr_b, O, E)
    if width < 0 or lo < 0:
        raise ValueError(f"bad r window lo={lo} width={width}")
    if ZP3.device.type == "cpu":
        return fused_update_nor(slots, removal, ZP3, Y, sigma, theta, Pr_b,
                                O, E, fast_ent, lo, width)

    global launches
    if width > 0:
        Rw = torch.zeros((width, K, CH), dtype=torch.float32,
                         device=ZP3.device)
        out = _launch("fused_estep_r_window", [Rw.data_ptr(), lo, width],
                      slots, removal, ZP3, Y, sigma, theta, Pr_b, O, E,
                      fast_ent)
    else:
        Rw = None
        out = _launch("fused_estep_round", [], slots, removal, ZP3, Y,
                      sigma, theta, Pr_b, O, E, fast_ent)
    launches += 1
    return (*out, Rw)


def fused_estep_r(slots, removal, ZP3, R3, Y, sigma, theta, Pr_b, O, E,
                  fast_ent: bool):
    """One stored-R E-step round (K2), writing r into the caller's
    chunk-major R3 (nc1, K, CH), whose dtype (float32 or bfloat16) picks
    the store; see `ops.update_r_fused.fused_update_r`. Returns (R3, O, E,
    cache, ybuf, kbuf)."""
    nc1, K, _, _, CH = _check_round(slots, removal, ZP3, Y, sigma, theta,
                                    Pr_b, O, E)
    _check("R3", R3, (nc1, K, CH), (torch.float32, torch.bfloat16),
           ZP3.device)
    if ZP3.device.type == "cpu":
        return fused_update_r(slots, removal, ZP3, R3, Y, sigma, theta, Pr_b,
                              O, E, fast_ent)

    global launches_write_r
    out = _launch("fused_estep_write_r",
                  [R3.data_ptr(), int(R3.dtype == torch.bfloat16)],
                  slots, removal, ZP3, Y, sigma, theta, Pr_b, O, E, fast_ent)
    launches_write_r += 1
    return (R3, *out)
