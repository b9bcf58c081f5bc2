"""The stamped one-pass per-block entry: where a mesh's per-block launch
spends its time.

`launcher` makes a `fused_estep._BlockLaunch` over the library of
csrc/fused_estep_block_timed.cu, whose FOLD instantiations of estep_round
write a clock64 stamp at the end of each phase of their one block in
every CTA (thread 0, after a CTA barrier), and globaltimer beside clock64
at each CTA's start and end. `launch` issues one block into a stamp
buffer. The outputs are the entry's own: the stamps only read the clock.
`decode` turns the stamps of one or several launches run together into
phase durations: each CTA's start after the set's first CTA (the launch
skew), its phases from its own start, and the CTA that ends last, which
sets the launch's time.

The library is built only when asked for (`build.ON_DEMAND`) and nothing
on `run_harmony`'s path imports this module: `chip_smoke.py
--block-timing` does.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build
from . import fused_estep as fe

NAME = "fused_estep_block_timed"
N_SPAN = 4           # per CTA: globaltimer, clock64 at start; the same at end
_lib = None


def timed_lib():
    """The library of csrc/fused_estep_block_timed.cu, built on first use."""
    global _lib
    if _lib is None:
        lib = fe.block_signatures(build.load(NAME), NAME, True)
        lib.fused_estep_block_set_stamps.argtypes = [fe._P, fe._P]
        lib.fused_estep_block_stamp_names.restype = ctypes.c_char_p
        for fn in (lib.fused_estep_block_set_stamps,
                   lib.fused_estep_block_stamps_per_block):
            fn.restype = fe._I
        if len(stamp_names(lib)) != lib.fused_estep_block_stamps_per_block():
            raise RuntimeError(
                f"{NAME}.cu names {len(stamp_names(lib))} stamps of "
                f"{lib.fused_estep_block_stamps_per_block()}")
        _lib = lib
    return _lib


def stamp_names(lib=None) -> list[str]:
    """The phase each stamp ends, in stamp order."""
    return (lib or timed_lib()).fused_estep_block_stamp_names().decode() \
        .split(",")


def stamp_count(grid: int, per_cta: int) -> int:
    """int64 values of one launch's stamp buffer: (grid, per_cta) clock64
    stamps, then (grid, N_SPAN) globaltimer and clock64 at each CTA's start
    and end."""
    return grid * per_cta + grid * N_SPAN


def launcher(*args, **kw):
    """A one-pass `_BlockLaunch(*args, **kw)` whose launches stamp (on a
    card only)."""
    if args[2].device.type != "cuda":
        raise ValueError("the stamped per-block entry measures the kernel: "
                         "it needs CUDA tensors")
    return fe._BlockLaunch(*args, precision="default", lib=timed_lib(), **kw)


def stamp_buffer(ln) -> torch.Tensor:
    """A zeroed stamp buffer for launches of `ln` (one CTA per unit)."""
    return torch.zeros(stamp_count(ln.n_units, len(stamp_names())),
                       dtype=torch.int64, device=ln.device)


def launch(ln, b: int, readd: bool, stamps: torch.Tensor) -> None:
    """Launch block b of `ln` (from `launcher`) writing into `stamps`
    (`stamp_buffer`; stamps a launch does not write stay as they were)."""
    err = timed_lib().fused_estep_block_set_stamps(ln._call,
                                                   stamps.data_ptr())
    if err != 0:
        raise RuntimeError(f"fused_estep_block_set_stamps: CUDA error {err}")
    ln.launch(b, readd)


def decode(stamps, grid: int, names) -> dict:
    """Phase durations of launches run together, in microseconds.

    stamps: one buffer per launch (each of `grid` CTAs). A CTA's phase lasts
    from its previous stamp that was written (non-zero; its start for the
    first) to its own, and `exit` from its last stamp to its end; stamps
    never written (tiles a unit does not have, the slot's sums on a CTA
    that does none) are skipped. Times on globaltimer count from the
    earliest CTA start of all the launches.

    Returns ns_per_cycle (the median over CTAs of globaltimer over clock64
    between their start and end), span_us (the first CTA's start to the
    last CTA's end, over all launches), and per launch: span_us (its own
    first start to last end), start_us (its first CTA's start), skew_us
    (median and max of its CTAs' starts after its first), last ({cta,
    start_us, end_us, tiles, phases: {phase: us}} of the CTA that ends
    last), median_us ({phase: the median over the CTAs that have it}) and
    summing_ctas (CTAs that wrote a slot's sums)."""
    bufs = [np.asarray(s, dtype=np.int64) for s in stamps]
    ns = len(names)
    bodies = [b[:grid * ns].reshape(grid, ns) for b in bufs]
    spans = [b[grid * ns:].reshape(grid, N_SPAN) for b in bufs]
    g0 = np.concatenate([s[:, 0] for s in spans])
    g1 = np.concatenate([s[:, 2] for s in spans])
    c0 = np.concatenate([s[:, 1] for s in spans])
    c1 = np.concatenate([s[:, 3] for s in spans])
    ok = (c1 > c0) & (g1 > g0)
    if not ok.all():
        raise ValueError("a CTA did not write its start and end stamps")
    ns_per_cycle = float(np.median((g1 - g0) / (c1 - c0)))
    us = ns_per_cycle / 1e3
    t0 = int(g0.min())
    phases = list(names) + ["exit"]
    tile = np.array([n.endswith("_S") for n in phases])
    out = []
    for body, span in zip(bodies, spans):
        dur = np.zeros((grid, len(phases)))
        has = np.zeros((grid, len(phases)), dtype=bool)
        for c in range(grid):
            prev = span[c, 1]
            for i in range(ns):
                v = body[c, i]
                if v != 0:
                    dur[c, i] = (v - prev) * us
                    has[c, i] = True
                    prev = v
            dur[c, ns] = (span[c, 3] - prev) * us
            has[c, ns] = True
        last = int(np.argmax(span[:, 2]))
        start = (span[:, 0] - t0) / 1e3
        skew = start - start.min()
        out.append(dict(
            span_us=float((span[:, 2].max() - span[:, 0].min()) / 1e3),
            start_us=float(start.min()),
            skew_us=dict(median=float(np.median(skew)),
                         max=float(skew.max())),
            last=dict(cta=last, start_us=float(start[last]),
                      end_us=float((span[last, 2] - t0) / 1e3),
                      tiles=int((has[last] & tile).sum()),
                      phases={n: float(dur[last, p]) for p, n in
                              enumerate(phases) if has[last, p]}),
            median_us={n: float(np.median(dur[has[:, p], p]))
                       for p, n in enumerate(phases) if has[:, p].any()},
            summing_ctas=int(has[:, names.index("sum_ybuf")].sum())))
    return dict(ns_per_cycle=ns_per_cycle,
                span_us=float((g1.max() - t0) / 1e3), launches=out)
