"""Checkpoint / resume of a fit's state (JAX package utils/checkpoint.py).

The state is snapshot between harmony iterations as one .npz: every field
of HarmonyState by name, plus what the next draws depend on. The JAX state
carries its RNG key; this port draws each round's blocks from a stateful
torch.Generator, so a checkpoint also holds the generator's state, its
device type, and the number of block draws made so far (which an injected
`blocks_fn` is indexed by). A resumed fit then draws the partitions the
uninterrupted fit would have drawn, and continues bitwise.

bfloat16 fields (low_memory R) are stored as their int16 bit patterns and
named in a `bf16` sidecar: NumPy has no bfloat16.

A mesh state is written in the JAX package's global layout: each
cell-axis field's shards concatenated (Z (d, N_pad); caches and the
chunk-major R n_devices * (nc_cap + 1) rows), with `n_devices` beside. A
resume on another mesh size is refused with the mismatch listed. Across
processes (JAX package utils/checkpoint.py:8-41) every rank gathers the
sharded fields, rank 0 alone writes, and the ranks meet at a barrier
before the fit goes on; a resume reads the global file on every rank and
keeps each rank's own shards (state_to).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import EngineConfig
from ..ops.partition import partition_geometry
from ..parallel.mesh import process_index, spans_processes
from ..parallel.sharding import gather_cells, split_cells
from ..state import HarmonyState, sharded_fields

_SCALARS = ("n_kmeans", "n_harmony", "n_rounds", "converged", "n_passes",
            "n_devices")


@dataclasses.dataclass
class RngState:
    """What the block draws after a checkpoint depend on."""
    gen_state: torch.Tensor   # uint8, torch.Generator.get_state()
    device_type: str          # the generator's device type ("cpu", "cuda")
    n_drawn: int              # block draws made so far


def save_state(path: str, state: HarmonyState, rng: RngState,
               cfg: EngineConfig) -> None:
    """Write `state` and `rng` to `path` (.npz). kmeans_rounds is stored
    padded to cfg.rounds_hist_len, as the JAX state holds it. Across
    processes a collective: every rank calls it, rank 0 writes."""
    arrays, bf16 = {}, []
    axes = sharded_fields(cfg)
    for f in dataclasses.fields(HarmonyState):
        x = getattr(state, f.name)
        if f.name in axes:
            x = gather_cells(x, cfg, axes[f.name])
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu()
            if x.dtype == torch.bfloat16:
                bf16.append(f.name)
                x = x.view(torch.int16)
            x = x.numpy()
        elif f.name == "kmeans_rounds":
            x = np.zeros((cfg.rounds_hist_len,), np.int32)
            x[: len(state.kmeans_rounds)] = state.kmeans_rounds
        arrays[f.name] = np.asarray(x)
    arrays["bf16"] = np.asarray(bf16, dtype=str)
    arrays["gen_state"] = rng.gen_state.cpu().numpy()
    arrays["gen_device"] = np.asarray(rng.device_type)
    arrays["n_drawn"] = np.asarray(rng.n_drawn)
    if process_index() == 0:
        with open(path, "wb") as fh:
            np.savez(fh, **arrays)
    if spans_processes(cfg.n_devices):
        torch.distributed.barrier()


def load_state(path: str) -> tuple[HarmonyState, RngState]:
    """Read a checkpoint into a state of CPU tensors and its RngState."""
    with np.load(path) as z:
        bf16 = set(z["bf16"].tolist())
        fields = {}
        for f in dataclasses.fields(HarmonyState):
            if f.name == "n_devices" and f.name not in z.files:
                fields[f.name] = 1        # written before meshes existed
                continue
            x = z[f.name]
            if f.name in _SCALARS:
                fields[f.name] = (bool(x) if f.name == "converged"
                                  else int(x))
            elif f.name == "kmeans_rounds":
                fields[f.name] = x  # trimmed to n_rounds below
            else:
                t = torch.from_numpy(np.array(x))
                fields[f.name] = (t.view(torch.bfloat16) if f.name in bf16
                                  else t)
        rng = RngState(torch.from_numpy(np.array(z["gen_state"])),
                       str(z["gen_device"]), int(z["n_drawn"]))
    fields["kmeans_rounds"] = [
        int(r) for r in fields["kmeans_rounds"][: fields["n_rounds"]]]
    return HarmonyState(**fields), rng


def expected_leaf_shapes(cfg: EngineConfig) -> dict:
    """Global shape of every tensor field of HarmonyState under `cfg`:
    they encode the geometry a checkpoint was written under (N_pad and
    chunk layout on the mesh, history lengths from max_iter_*, the
    stored-R layout)."""
    K, d, B = cfg.K, cfg.d, cfg.B
    if cfg.fused_estep:
        geom = partition_geometry(cfg)
        nc1, CH = cfg.n_devices * (geom.nc_cap + 1), geom.CH
        cache = (nc1, K, B + 1)
    else:
        cache = (1, 1, 1)
    if cfg.defer_r:
        R = (1, 1)
        defer = {"Ysum0": (d, K), "rep_Y": (d, K), "rep_O": (K, B),
                 "rep_E": (K, B), "rep_blocks": (geom.L,),
                 "rep_cache": cache, "rep_Zcos": (d, cfg.N_pad)}
    else:
        R = (nc1, K, CH) if cfg.fused_estep else (K, cfg.N_pad)
        defer = {"Ysum0": (1, 1), "rep_Y": (1, 1), "rep_O": (1, 1),
                 "rep_E": (1, 1), "rep_blocks": (1,),
                 "rep_cache": (1, 1, 1), "rep_Zcos": (1, 1)}
    return {
        "Z_corr": (d, cfg.N_pad), "Z_cos": (d, cfg.N_pad), "R": R,
        "Y": (d, K), "O": (K, B), "E": (K, B), "cache": cache,
        "obj_kmeans": (cfg.kmeans_hist_len,),
        "obj_dist": (cfg.kmeans_hist_len,),
        "obj_entropy": (cfg.kmeans_hist_len,),
        "obj_cross": (cfg.kmeans_hist_len,),
        "obj_harmony": (cfg.harmony_hist_len,),
        **defer,
    }


def validate_state(state: HarmonyState, cfg: EngineConfig,
                   path: str = "<checkpoint>", rng: RngState | None = None,
                   device: torch.device | None = None) -> None:
    """Raise ValueError, listing every mismatch, when a loaded checkpoint
    does not fit the current configuration (or, given `rng` and `device`,
    its generator state cannot be restored on that device)."""
    problems = []
    if state.n_devices != cfg.n_devices:
        problems.append(f"mesh: written on {state.n_devices} device(s), "
                        f"resuming on {cfg.n_devices}")
    for name, want in expected_leaf_shapes(cfg).items():
        got = tuple(getattr(state, name).shape)
        if got != want:
            problems.append(f"{name}: shape {got}, expected {want}")
    if state.R.dtype != cfg.r_torch_dtype and not cfg.defer_r:
        problems.append(
            f"R: dtype {str(state.R.dtype).replace('torch.', '')}, expected "
            f"{cfg.r_dtype} (low_memory={cfg.r_dtype == 'bfloat16'})")
    if rng is not None and device is not None \
            and rng.device_type != device.type:
        problems.append(f"generator: a {rng.device_type} generator's state, "
                        f"resuming on {device.type}")
    if problems:
        raise ValueError(
            f"Checkpoint {path} is incompatible with the current "
            f"configuration — it was written under different engine "
            f"geometry (max_iter_harmony/max_iter_kmeans, chunk_size, "
            f"defer_r, low_memory, device or mesh size). Mismatches: "
            + "; ".join(problems)
            + ". Resume with the settings the checkpoint was written "
            "under, or re-run from scratch.")


def state_to(state: HarmonyState, mesh, cfg: EngineConfig) -> HarmonyState:
    """A loaded (global, host) state on `mesh`: its cell-axis fields split
    into this process's shards, each on its device, the rest on the lead
    device."""
    axes = sharded_fields(cfg)
    out = {}
    for f in dataclasses.fields(HarmonyState):
        x = getattr(state, f.name)
        if not isinstance(x, torch.Tensor):
            continue
        out[f.name] = (split_cells(x, cfg, mesh, axes[f.name])
                       if f.name in axes else x.to(mesh.lead))
    return dataclasses.replace(state, **out)
