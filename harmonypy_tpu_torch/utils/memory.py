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
not name. On a mesh the model is per card: the persistent arrays of every
shard the card holds (several when a mesh repeats a device), and the
phases' working sets, which on a mesh shard are one-device shaped (the
N-axis work outside the kernel runs in the one-device layout,
parallel/sharding.py) and run one shard at a time, apart from the r
windows of a replayed round, which every shard holds at once. The working sets of the init phases are counted in K x N arrays
(or r windows) as measured on a card: `chip_smoke.py`'s phase capacity
holds the model above the measured peak of the 858k deferred, stored and
low_memory fits. It errs high: a preflight that refuses a fit that would
have run is a nuisance, one that lets an impossible fit start is the
failure it exists to prevent.
"""

from __future__ import annotations

import collections
import dataclasses
import os

import torch

from ..config import EngineConfig, fused_geometry_ok
from ..ops.cuda.fused_estep import kernel_geometry
from ..ops.partition import partition_geometry
from ..ops.replay import INIT_ELEMS, window_width
from ..parallel.mesh import Mesh
from ..parallel.sharding import one_device

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


def memory_envelope(cfg: EngineConfig, shards: int = 1) -> dict:
    """Modeled peak device bytes of a fit under `cfg` on a card that holds
    `shards` of its shards (one device: 1), by component.

    Returns {"persistent": {...}, "phases": {...}, "peak_phase": name,
    "total": bytes with slack}."""
    c, Nl, K, d, B = shards, cfg.N_local, cfg.K, cfg.d, cfg.B
    mesh = cfg.n_devices > 1
    one = one_device(cfg)
    r_bytes = 2 if cfg.r_dtype == "bfloat16" else 4
    persistent = {"inputs (Z_orig, Phi, mask)": c * (d + B + 1) * Nl * _F}
    # On a mesh: k-means init gathers the real cells to the lead card, and
    # a shard's init and stored-ridge phases hold its cell inputs in the
    # one-device layout (parallel/sharding.py).
    phases = {"kmeans init": _kmeans_init_bytes(cfg)
              + (d * cfg.N * _F if mesh else 0)}
    emb = (d + B + 1) * one.N_pad * _F if mesh else 0
    if cfg.fused_estep:
        geom = partition_geometry(cfg)
        nc1, CH, J = geom.nc_cap + 1, geom.CH, geom.J_shard
        units = kernel_geometry(K, B, d, CH, J, _SMS, geom.J_fix + 1).n_units
        persistent["chunk caches"] = c * nc1 * K * (
            2 * (B + 1) + 2 * d + 2 + (B + 1) * (B + 1 + d)) * _F
        slab = c * 2 * (1 + B + d) * Nl * _F  # ZP3 and the copy that builds it
        partials = 2 * units * K * (1 + B + d) * _F
        # One window of r (ops/replay.windows), as float32. The init pass
        # holds dist, exp, r and their products per window of its own
        # (a quarter of the size), and a stored fit one more for the store.
        wcells = window_width(one) * CH
        win = wcells * K * _F
        phases["init chunk pass"] = emb + (6 + (not cfg.defer_r)) * (
            window_width(one, INIT_ELEMS) * CH * K * _F)
    if cfg.defer_r:
        persistent["Z_corr, Z_cos, rep_Zcos, ZO3"] = c * 4 * d * Nl * _F
        # A replayed round's r windows live on every shard at once.
        phases["harmony iteration"] = (
            slab + partials + (c + 1) * win + 2 * c * d * Nl * _F
            + wcells * (3 * d + (B + 1) ** 2) * _F)
    elif cfg.fused_estep:
        persistent["Z_corr, Z_cos"] = c * 2 * d * Nl * _F
        persistent["R (chunk-major)"] = c * K * Nl * r_bytes
        # fp32 windows of R for the first centroid product and the ridge;
        # on a mesh also a window of the shard's R and slab in the
        # one-device layout, and the ridge's cell inputs and Z_corr.
        phases["harmony iteration"] = (
            slab + partials + 2 * win
            + (win + wcells * (1 + B + d) * _F + emb + d * one.N_pad * _F
               if mesh else 0))
    else:
        KNl = K * Nl * _F
        persistent["Z_corr, Z_cos"] = c * 2 * d * Nl * _F
        persistent["R"] = c * K * Nl * r_bytes
        phases["init (K x N temporaries)"] = 5 * c * KNl
        # dist, scale_dist, an fp32 R and the block scatter's copy of R.
        phases["harmony iteration"] = c * (3 * KNl + K * Nl * r_bytes)
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
    the remedies (defer_r, low_memory, a device mesh, a smaller problem)."""


def _fmt(b: float) -> str:
    return f"{b / 1e9:.2f} GB"


def check_capacity(cfg: EngineConfig, mesh) -> None:
    """Raise CapacityError when the modeled envelope exceeds the usable
    capacity of a card of `mesh` (a Mesh, or one device): the shards that
    share a card are summed against that card. No-op where the capacity is
    unknown (the CPU without $HARMONYPY_DEVICE_MEM_BYTES)."""
    devices = (mesh.devices if isinstance(mesh, Mesh)
               else (torch.device(mesh),))
    for device, shards in collections.Counter(devices).items():
        cap = device_capacity_bytes(device)
        if cap is not None:
            _check_card(cfg, shards, cap, device)


def _check_card(cfg: EngineConfig, shards: int, cap: int, device) -> None:
    budget = int(cap * _HEADROOM)
    env = memory_envelope(cfg, shards)
    if env["total"] <= budget:
        return

    def remedy(flag, **change):
        total = memory_envelope(dataclasses.replace(cfg, **change),
                                shards)["total"]
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
    n = max(2 * cfg.n_devices, 2)
    while True:
        total = memory_envelope(dataclasses.replace(cfg, n_devices=n))["total"]
        if total <= budget or n >= 256:
            break
        n *= 2
    remedies.append(
        f"spread the cells over an {n}-device mesh (one shard per card, "
        f"parallel.mesh.make_mesh): modeled {_fmt(total)} per card "
        + ("fits" if total <= budget else
           "(still over budget: k-means init gathers every cell to the "
           "lead card, and each shard holds its cell inputs one-device "
           "sized)"))
    parts = ", ".join(f"{k} {_fmt(v)}"
                      for k, v in env["persistent"].items())
    on = (f" on {device} ({shards} shards of a {cfg.n_devices}-device mesh)"
          if cfg.n_devices > 1 else "")
    raise CapacityError(
        f"Modeled device memory for N={cfg.N}, K={cfg.K}, d={cfg.d}, "
        f"B={cfg.B}{on} is {_fmt(env['total'])} ({parts}; peak phase "
        f"{env['peak_phase']} {_fmt(env['phases'][env['peak_phase']])}), "
        f"exceeding the usable capacity {_fmt(budget)} (of {_fmt(cap)} "
        f"free). Remedies: " + "; ".join(remedies)
        + ". Set HARMONYPY_SKIP_CAPACITY_CHECK=1 to attempt the run anyway.")
