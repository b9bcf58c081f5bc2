"""Wrapper of the hand-written fused E-step kernel (csrc/fused_estep.cu).

`fused_estep` computes one deferred-R E-step round — what the JAX package's
Pallas `_kernel_nor` computes (ops/pallas/update_r_fused.py:117-221) — and,
with width > 0, also returns the r of a window of chunks (the replay
epilogue). On CUDA tensors it launches the kernel (2 launches per block) or
raises; on CPU tensors it runs the plain version
(`ops.update_r_fused.fused_update_nor`). `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..update_r_fused import fused_update_nor
from . import build

launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = build.load("fused_estep")
        common = [_P] * 13
        tail = [_I] * 7 + [_P]
        lib.fused_estep_round.argtypes = common + tail
        lib.fused_estep_round.restype = _I
        lib.fused_estep_r_window.argtypes = common + [_P, _I, _I] + tail
        lib.fused_estep_r_window.restype = _I
        lib.fused_estep_groups.argtypes = [_I]
        lib.fused_estep_groups.restype = _I
        _lib = lib
    return _lib


def _check(name, t, shape, dtype, device, contiguous=True):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_estep(slots, removal, ZP3, Y, sigma, theta, Pr_b, O, E,
                fast_ent: bool, lo: int = 0, width: int = 0):
    """One fused E-step round; see `ops.update_r_fused.fused_update_nor`
    for the arguments and results."""
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
    # O and E are copied into the kernel's ping-pong buffer: any layout.
    _check("O", O, (K, B), f32, dev, contiguous=False)
    _check("E", E, (K, B), f32, dev, contiguous=False)
    lo_s, hi_s = torch.aminmax(slots)
    if int(lo_s) < 0 or int(hi_s) >= nc1:
        raise ValueError(f"slot ids must lie in [0, {nc1}), got "
                         f"[{int(lo_s)}, {int(hi_s)}]")
    if width < 0 or lo < 0:
        raise ValueError(f"bad r window lo={lo} width={width}")
    if dev.type == "cpu":
        return fused_update_nor(slots, removal, ZP3, Y, sigma, theta, Pr_b,
                                O, E, fast_ent, lo, width)

    global launches
    lib = _kernel_lib()
    nt = lib.fused_estep_groups(CH)
    oe = torch.zeros((2, 2, K, B), dtype=f32, device=dev)
    oe[0, 0] = O
    oe[0, 1] = E
    part = torch.empty((J, nt, K, R), dtype=f32, device=dev)
    kpart = torch.empty((J, nt, 2), dtype=f32, device=dev)
    # Only slotted chunks are written; every real chunk is in exactly one
    # slot and the dummy chunk in at least one, so nothing stays unset.
    cache = torch.empty((nc1, K, B + 1), dtype=f32, device=dev)
    ybuf = torch.empty((nc1, K, d), dtype=f32, device=dev)
    kbuf = torch.empty((nc1, 2), dtype=f32, device=dev)
    Rw = (torch.zeros((width, K, CH), dtype=f32, device=dev)
          if width > 0 else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in (ZP3, Y, sigma, theta, Pr_b, removal,
                                   slots, oe, part, kpart, cache, ybuf,
                                   kbuf)]
    dims = [K, B, d, CH, nb, J, int(bool(fast_ent)), stream]
    if Rw is None:
        err = lib.fused_estep_round(*ptrs, *dims)
    else:
        err = lib.fused_estep_r_window(*ptrs, Rw.data_ptr(), lo, width,
                                       *dims)
    if err != 0:
        raise RuntimeError(f"fused_estep kernel launch failed: CUDA error "
                           f"{err}")
    launches += 2 * nb
    O2, E2 = oe[nb % 2, 0], oe[nb % 2, 1]
    return O2, E2, cache, ybuf, kbuf, Rw
