"""Device memory envelope of a fit and the capacity preflight (JAX package
utils/memory.py).

The reference holds everything in host RAM; a card has a hard ceiling, and
an out-of-memory error midway through a fit comes long after the user could
have chosen another configuration. `memory_envelope` models the peak device
bytes of a fit under this port's layouts, and `check_capacity` (called by
Harmony before the first upload) raises CapacityError with remedies when
the model exceeds what the card has free.

The peak is the arrays that live through the fit plus the largest working
set of one phase (k-means init, the init pass, one harmony iteration),
times a slack factor for allocator rounding and temporaries the model does
not name. The working sets of the init phases are counted in K x N arrays
(or r windows) as measured on a card: `chip_smoke.py`'s phase capacity
holds the model above the measured peak of the 858k deferred, stored and
low_memory fits. It errs high: a preflight that refuses a fit that would
have run is a nuisance, one that lets an impossible fit start is the
failure it exists to prevent.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from ..config import EngineConfig, fused_geometry_ok
from ..ops.cuda.fused_estep import kernel_geometry
from ..ops.partition import partition_geometry
from ..ops.replay import window_width

# Fraction of the free device memory the plan may use (allocator
# fragmentation, the CUDA context's own growth, library workspaces).
_HEADROOM = 0.92
# Multiplier on the modeled bytes for temporaries the model does not name.
_SLACK = 1.12
# SMs of an H100 SXM, which set the persistent E-step kernel's work units
# and so its per-unit O/E partials (ops/cuda/fused_estep.kernel_geometry).
_SMS = 132
_F = 4  # float32


def _kmeans_init_bytes(cfg: EngineConfig) -> int:
    """k-means init working set on its sample of S cells: the sample, the
    greedy k-means++ candidate slabs (T, S), Lloyd's (K, S) one-hot and
    scores, and under k-means|| the (n_cand, S) nearest-candidate scores
    and their product."""
    S = min(cfg.kmeanspp_sample, cfg.N)
    T = max(cfg.kmeanspp_trials, 2)
    n_cand = 0
    if S < cfg.N and S >= cfg.kmeansbb_oversample * cfg.K:
        n_cand = 1 + cfg.kmeansbb_rounds * cfg.kmeansbb_oversample * cfg.K
    return S * (cfg.d + 2 * T + 3 * cfg.K + 2 * n_cand) * _F


def memory_envelope(cfg: EngineConfig) -> dict:
    """Modeled peak device bytes of a fit under `cfg`, by component.

    Returns {"persistent": {...}, "phases": {...}, "peak_phase": name,
    "total": bytes with slack}."""
    Np, K, d, B = cfg.N_pad, cfg.K, cfg.d, cfg.B
    r_bytes = 2 if cfg.r_dtype == "bfloat16" else 4
    persistent = {"inputs (Z_orig, Phi, mask)": (d + B + 1) * Np * _F}
    phases = {"kmeans init": _kmeans_init_bytes(cfg)}
    KN = K * Np * _F                      # one float32 K x N array
    if cfg.fused_estep:
        geom = partition_geometry(cfg)
        nc1, CH, J = geom.nc_cap + 1, geom.CH, geom.J_shard
        units = kernel_geometry(K, B, d, CH, J, _SMS).n_units
        persistent["chunk caches"] = nc1 * K * (
            2 * (B + 1) + 2 * d + 2 + (B + 1) * (B + 1 + d)) * _F
        slab = 2 * (1 + B + d) * Np * _F  # ZP3 and the copy that builds it
        partials = 2 * units * K * (1 + B + d) * _F
    if cfg.defer_r:
        win = window_width(cfg) * K * CH * _F
        persistent["Z_corr, Z_cos, rep_Zcos, ZO3"] = 4 * d * Np * _F
        # The init pass holds dist, exp, r and their products per window.
        phases["init chunk pass"] = 6 * win
        phases["harmony iteration"] = (
            slab + partials + 2 * win + 2 * d * Np * _F
            + window_width(cfg) * CH * (3 * d + (B + 1) ** 2) * _F)
    elif cfg.fused_estep:
        persistent["Z_corr, Z_cos"] = 2 * d * Np * _F
        persistent["R (chunk-major)"] = K * Np * r_bytes
        phases["init (K x N temporaries)"] = 5 * KN
        # fp32 views of R for the centroid product and the ridge.
        phases["harmony iteration"] = slab + partials + 2 * KN
    else:
        persistent["Z_corr, Z_cos"] = 2 * d * Np * _F
        persistent["R"] = K * Np * r_bytes
        phases["init (K x N temporaries)"] = 5 * KN
        # dist, scale_dist, an fp32 R and the block scatter's copy of R.
        phases["harmony iteration"] = 3 * KN + K * Np * r_bytes
    peak = max(phases, key=phases.get)
    total = sum(persistent.values()) + phases[peak]
    return {"persistent": persistent, "phases": phases, "peak_phase": peak,
            "total": int(total * _SLACK)}


def device_capacity_bytes(device) -> int | None:
    """Bytes this process can still allocate on `device`: the card's free
    memory plus what the caching allocator holds unused; None on the CPU.
    $HARMONYPY_DEVICE_MEM_BYTES overrides it on any device."""
    override = os.environ.get("HARMONYPY_DEVICE_MEM_BYTES")
    if override:
        return int(override)
    device = torch.device(device)
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return (free + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))


class CapacityError(RuntimeError):
    """The configured fit cannot fit in device memory; the message names
    the remedies (defer_r, low_memory, more devices, a smaller problem)."""


def _fmt(b: float) -> str:
    return f"{b / 1e9:.2f} GB"


def check_capacity(cfg: EngineConfig, device) -> None:
    """Raise CapacityError when the modeled envelope exceeds the usable
    capacity of `device`. No-op when the capacity is unknown (the CPU
    without $HARMONYPY_DEVICE_MEM_BYTES)."""
    cap = device_capacity_bytes(device)
    if cap is None:
        return
    budget = int(cap * _HEADROOM)
    env = memory_envelope(cfg)
    if env["total"] <= budget:
        return

    def remedy(flag, **change):
        total = memory_envelope(dataclasses.replace(cfg, **change))["total"]
        if total <= budget:
            return f"pass {flag}: modeled {_fmt(total)} fits"
        return f"{flag} shrinks the model to {_fmt(total)} (still over budget)"

    remedies = []
    if not cfg.defer_r and fused_geometry_ok(cfg.N, 1, cfg.block_size,
                                             cfg.chunk_size):
        remedies.append(remedy("defer_r=True (R never stored)", defer_r=True,
                               use_pallas=False, use_fused_xla=True))
    if not cfg.defer_r and cfg.r_dtype != "bfloat16":
        remedies.append(remedy("low_memory=True (bfloat16 R)",
                               r_dtype="bfloat16"))
    remedies.append("spread the cells over more devices (ROADMAP.md §1 "
                    "item 11, not ported to harmonypy_tpu_torch yet)")
    parts = ", ".join(f"{k} {_fmt(v)}"
                      for k, v in env["persistent"].items())
    raise CapacityError(
        f"Modeled device memory for N={cfg.N}, K={cfg.K}, d={cfg.d}, "
        f"B={cfg.B} is {_fmt(env['total'])} ({parts}; peak phase "
        f"{env['peak_phase']} {_fmt(env['phases'][env['peak_phase']])}), "
        f"exceeding the usable capacity {_fmt(budget)} (of {_fmt(cap)} "
        f"free). Remedies: " + "; ".join(remedies)
        + ". Set HARMONYPY_SKIP_CAPACITY_CHECK=1 to attempt the run anyway.")
