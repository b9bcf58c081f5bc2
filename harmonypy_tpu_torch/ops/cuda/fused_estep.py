"""Wrappers of the hand-written fused E-step kernels (csrc/fused_estep.cu).

`fused_estep` (K1) computes one deferred-R E-step round — what the JAX
package's Pallas `_kernel_nor` computes (ops/pallas/update_r_fused.py:
117-221) — and, with width > 0, also returns the r of a window of chunks
(the replay epilogue). `fused_estep_r` (K2) computes the stored-R round of
the Pallas `_kernel` (:109-114): the same round, writing r of every chunk
into the caller's R3 in its dtype. On CUDA tensors each launches its kernel
(2 launches per block) or raises; on CPU tensors each runs its plain version
(`ops.update_r_fused.fused_update_nor` / `fused_update_r`). `launches` and
`launches_write_r` count the launches of K1 and K2.
"""

from __future__ import annotations

import ctypes

import torch

from ..update_r_fused import fused_update_nor, fused_update_r
from . import build

launches = 0
launches_write_r = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = build.load("fused_estep")
        common = [_P] * 13
        tail = [_I] * 7 + [_P]
        lib.fused_estep_round.argtypes = common + tail
        lib.fused_estep_r_window.argtypes = common + [_P, _I, _I] + tail
        lib.fused_estep_write_r.argtypes = common + [_P, _I, _I] + tail
        for fn in (lib.fused_estep_round, lib.fused_estep_r_window,
                   lib.fused_estep_write_r):
            fn.restype = _I
        lib.fused_estep_groups.argtypes = [_I]
        lib.fused_estep_groups.restype = _I
        _lib = lib
    return _lib


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
    """Check the inputs every round takes; returns (nc1, K, B, d, CH)."""
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
    return nc1, K, B, d, CH


def _launch(entry, extra, slots, removal, ZP3, Y, sigma, theta, Pr_b, O, E,
            fast_ent):
    """Allocate the outputs and scratch and run one round through the
    library function `entry` (extra: its arguments between the common
    pointers and the dimensions). Returns (O, E, cache, ybuf, kbuf)."""
    nc1, R, CH = ZP3.shape
    d, K = Y.shape
    B = theta.shape[0]
    nb, J = slots.shape
    dev, f32 = ZP3.device, torch.float32
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
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in (ZP3, Y, sigma, theta, Pr_b, removal,
                                   slots, oe, part, kpart, cache, ybuf,
                                   kbuf)]
    err = getattr(lib, entry)(*ptrs, *extra, K, B, d, CH, nb, J,
                              int(bool(fast_ent)), stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    return oe[nb % 2, 0], oe[nb % 2, 1], cache, ybuf, kbuf


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
    launches += 2 * slots.shape[0]
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
                  [R3.data_ptr(), nc1, int(R3.dtype == torch.bfloat16)],
                  slots, removal, ZP3, Y, sigma, theta, Pr_b, O, E, fast_ent)
    launches_write_r += 2 * slots.shape[0]
    return (R3, *out)
