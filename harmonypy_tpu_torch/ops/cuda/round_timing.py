"""The stamped one-pass round: where the one-launch round's time goes.

`timed_round` runs the one-pass round (K1's `fused_estep_round`, the
instantiations `matmul_precision="default"` runs) from the library of
csrc/fused_estep_timed.cu, whose estep_round writes a clock64 stamp at the
end of each phase of each block in every CTA (thread 0, after a CTA
barrier), and globaltimer beside clock64 at each CTA's start and end, from
which the clock's rate is read. Its outputs are the round's own: the stamps
only read the clock. `decode` turns the stamps into phase durations: per
block the critical path, the CTA with the most busy time on the block's
chain (its waits for other CTAs and its work after its arrival left out),
split by phase, and the median of each phase over the blocks.

The library is built only when asked for (`build.ON_DEMAND`) and nothing
on `run_harmony`'s path imports this module: `chip_smoke.py --round-ab`
does.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build
from . import fused_estep as fe

NAME = "fused_estep_timed"
N_SPAN = 4           # per CTA: globaltimer, clock64 at start; the same at end
_lib = None


def timed_lib():
    """The library of csrc/fused_estep_timed.cu, built on first use."""
    global _lib
    if _lib is None:
        lib = build.load(NAME)
        lib.fused_estep_round_timed.argtypes = (
            [fe._P] * (fe.N_PTRS + 2) + [fe._I] * 9 + [fe._P])
        lib.fused_estep_stamp_names.restype = ctypes.c_char_p
        lib.fused_estep_grid.argtypes = [fe._I] * 4
        for fn in (lib.fused_estep_round_timed, lib.fused_estep_grid,
                   lib.fused_estep_stamps_per_block):
            fn.restype = fe._I
        if len(stamp_names(lib)) != lib.fused_estep_stamps_per_block():
            raise RuntimeError(f"{NAME}.cu names {len(stamp_names(lib))} "
                               f"stamps of "
                               f"{lib.fused_estep_stamps_per_block()}")
        _lib = lib
    return _lib


def stamp_names(lib=None) -> list[str]:
    """The phase each stamp ends, in stamp order ("-": unused)."""
    return (lib or timed_lib()).fused_estep_stamp_names().decode().split(",")


def stamp_count(nb: int, grid: int, per_block: int) -> int:
    """int64 values of a round's stamp buffer: (nb, grid, per_block) clock64
    stamps, then (grid, N_SPAN) globaltimer and clock64 at each CTA's start
    and end."""
    return nb * grid * per_block + grid * N_SPAN


def timed_round(slots, removal, ZP3, Y, sigma, theta, Pr_b, O, E,
                fast_ent: bool = False, stamps=None):
    """One stamped one-pass round on a card (fused_estep's arguments).
    stamps: a buffer of an earlier call of the same shapes to write into
    (else a new one, zeros: stamps never written stay 0). Returns ((O, E,
    cache, ybuf, kbuf), the stamps (int64, on the card), the grid, the stamp
    names)."""
    nc1, K, B, d, CH = fe._check_round(slots, removal, ZP3, Y, sigma, theta,
                                       Pr_b, O, E, "default")
    if ZP3.device.type != "cuda":
        raise ValueError("timed_round measures the kernel: it needs CUDA "
                         "tensors")
    lib = timed_lib()
    nb, J = slots.shape
    dev = ZP3.device
    geo = fe.kernel_geometry(K, B, d, CH, J, fe._sm_count(dev.index or 0))
    with torch.cuda.device(dev):
        grid = lib.fused_estep_grid(K, B, d, 0)
    if grid < 0:
        raise RuntimeError(f"{NAME} occupancy query failed: CUDA error "
                           f"{-grid}")
    grid = min(grid, geo.n_units)
    names = stamp_names(lib)
    n = stamp_count(nb, grid, len(names))
    if stamps is None:
        stamps = torch.zeros(n, dtype=torch.int64, device=dev)
    elif (stamps.shape != (n,) or stamps.dtype != torch.int64
          or stamps.device != dev):
        raise ValueError(f"stamps must be ({n},) int64 on {dev}")
    out = fe._launch("fused_estep_round_timed", [stamps.data_ptr()], slots,
                     removal, ZP3, Y, sigma, theta, Pr_b, O, E, fast_ent,
                     True, lib=lib)
    return out, stamps, grid, names


def decode(stamps, nb: int, grid: int, names) -> dict:
    """Phase durations of a stamped round, in microseconds.

    A phase lasts from the CTA's previous stamp that was written (non-zero)
    to its own; stamps never written (tiles a unit does not have) are
    skipped. Per block, the critical CTA is the one with the most busy
    time: the sum of its phases that are neither waits for other CTAs
    (names wait_*) nor off the block's chain (off_*: after its arrival).
    Returns: ns_per_cycle (the median over CTAs of globaltimer over clock64
    between their start and end), block_us (the median over blocks and
    CTAs of one block's span, start to next start), critical_us ({phase:
    the median over blocks of the critical CTA's duration}; 0 where it has
    none), critical_busy_us, critical_wait_us and critical_off_us (the
    medians of its busy, waiting and off-chain sums), by_kind_us
    (critical_us summed by kind: ready, pass1, pass2, S over the tiles;
    other phases as they are), mean_us ({phase: the mean over every block
    and CTA that has it}) and tiles (the critical CTA's stamped tiles,
    median)."""
    st = np.asarray(stamps, dtype=np.int64)
    ns = len(names)
    body = st[:nb * grid * ns].reshape(nb, grid, ns)
    span = st[nb * grid * ns:].reshape(grid, N_SPAN)
    cyc = span[:, 3] - span[:, 1]
    ok = cyc > 0
    if not ok.any():
        raise ValueError("no CTA wrote its start and end stamps")
    ns_per_cycle = float(np.median((span[ok, 2] - span[ok, 0]) / cyc[ok]))
    us = ns_per_cycle / 1e3
    used = [i for i, n in enumerate(names) if n != "-"]
    phases = [names[i] for i in used[1:]]
    dur = np.zeros((nb, grid, len(phases)))
    has = np.zeros((nb, grid, len(phases)), dtype=bool)
    for b in range(nb):
        for c in range(grid):
            prev = body[b, c, used[0]]
            for p, i in enumerate(used[1:]):
                v = body[b, c, i]
                if v != 0:
                    dur[b, c, p] = (v - prev) * us
                    has[b, c, p] = True
                    prev = v
    wait = np.array([n.startswith("wait") for n in phases])
    off = np.array([n.startswith("off_") for n in phases])
    busy = (dur * ~(wait | off)).sum(axis=2)
    crit = busy.argmax(axis=1)
    cdur = dur[np.arange(nb), crit]                       # (nb, phases)
    critical = {n: float(np.median(cdur[:, p])) for p, n in enumerate(phases)}
    kinds = {}
    for n, v in critical.items():
        k = n.split("_", 1)[1] if n[:1] == "t" and n[1:2].isdigit() else n
        kinds[k] = kinds.get(k, 0.0) + v
    ctiles = has[np.arange(nb), crit][:, [n.endswith("_S") for n in phases]]
    starts = body[:, :, used[0]]
    period = (starts[1:] - starts[:-1]) * us if nb > 1 else np.zeros(1)
    mean = {n: float(dur[:, :, p][has[:, :, p]].mean())
            for p, n in enumerate(phases) if has[:, :, p].any()}
    return dict(ns_per_cycle=ns_per_cycle,
                block_us=float(np.median(period)),
                critical_us=critical,
                critical_busy_us=float(np.median(busy[np.arange(nb), crit])),
                critical_wait_us=float(np.median(
                    (cdur * wait).sum(axis=1))),
                critical_off_us=float(np.median((cdur * off).sum(axis=1))),
                by_kind_us=kinds, mean_us=mean,
                tiles=float(np.median(ctiles.sum(axis=1))))
