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

The kernel's static work split is `kernel_geometry`: the padded sizes, the
units (runs of 64-cell tiles of one slot) and the shapes of the partials.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..update_r_fused import fused_update_nor, fused_update_r
from . import build

launches = 0
launches_write_r = 0

TILE = 64            # cells per tile (csrc/fused_estep.cu TILE)
UNITS_PER_SM = 2     # units per block aimed at for each SM

_P, _I = ctypes.c_void_p, ctypes.c_int
_lib = None


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
                    n_sm: int) -> KernelGeometry:
    """The work split of one round: a function of the shape and the card's
    SM count only, never of occupancy, so K1, its r window and K2 (whose
    instantiations may fit differently) sum in the same order."""
    tiles = -(-CH // TILE)
    ng = max(1, min(tiles, UNITS_PER_SM * n_sm // J))
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
            fast_ent):
    """Allocate the outputs and scratch and run one round through the
    library function `entry` (extra: its arguments between the common
    pointers and the dimensions). Returns (O, E, cache, ybuf, kbuf)."""
    nc1, _, CH = ZP3.shape
    d, K = Y.shape
    B = theta.shape[0]
    nb, J = slots.shape
    dev, f32 = ZP3.device, torch.float32
    geo = kernel_geometry(K, B, d, CH, J, _sm_count(dev.index or 0))
    # Partials of S by block parity: a block's ybuf rows are summed while
    # the next block runs.
    part = torch.empty((2, *geo.part_shape), dtype=f32, device=dev)
    kpart = torch.empty(geo.kpart_shape, dtype=f32, device=dev)
    bsum = torch.empty((K, B + 1), dtype=f32, device=dev)
    # Only slotted chunks are written; every real chunk is in exactly one
    # slot and the dummy chunk in at least one, so nothing stays unset.
    cache = torch.empty((nc1, K, B + 1), dtype=f32, device=dev)
    ybuf = torch.empty((nc1, K, d), dtype=f32, device=dev)
    kbuf = torch.empty((nc1, 2), dtype=f32, device=dev)
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
