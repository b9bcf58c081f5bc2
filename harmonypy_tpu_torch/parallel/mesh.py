"""Device mesh for the cell-parallel engine (JAX package parallel/mesh.py).

Cells are the only scaling dimension of Harmony, so the mesh is one axis,
"cells", over an ordered tuple of torch devices. As in the JAX package, one
process drives every device of the mesh: shard s holds the s-th contiguous
range of cells, and the engine launches each shard's work on its device and
gathers the per-chunk rows of every reduction onto the lead device
(`devices[0]`). A device may appear more than once: `make_mesh(["cuda:0"] *
4)` is four logical shards on one card, which runs (and checks) the mesh
path with one card, as the JAX package's tests run it on virtual CPU
devices.

A mesh is all CPU or all CUDA, and its CUDA devices are one card model:
the fused E-step kernel splits its work by the SM count of the lead device
(ops/cuda/fused_estep.kernel_geometry), and every shard must split the
same way for the one-device bits.
"""

from __future__ import annotations

import dataclasses

import torch

AXIS = "cells"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered tuple of torch devices along the "cells" axis."""

    devices: tuple

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a Mesh needs at least one device")
        kinds = {d.type for d in devs}
        if not kinds <= {"cpu", "cuda"}:
            raise ValueError(f"mesh devices must be cpu or cuda: {devs}")
        if len(kinds) > 1:
            raise ValueError(f"a mesh is all CPU or all CUDA, got {devs}: a "
                             f"CUDA shard never runs the plain round")
        if "cuda" in kinds:
            names = {torch.cuda.get_device_name(d) for d in devs}
            if len(names) > 1:
                raise ValueError(f"a mesh of different card models {names}: "
                                 f"the kernel's work split follows the lead "
                                 f"card's SM count")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        """The device that holds the replicated state and the frames."""
        return self.devices[0]


def resolve_device(device) -> torch.device:
    """torch.device for one `device` argument: None -> CUDA (raises when
    there is none); "cuda", "cuda:N" and "cpu" as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "harmonypy_tpu_torch runs on CUDA by default and no CUDA "
                "device is available; pass device='cpu' to run on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"device must be 'cuda', 'cuda:N' or 'cpu', "
                         f"got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but no CUDA device "
                           f"is available")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise ValueError(f"device {device!r}: only "
                         f"{torch.cuda.device_count()} CUDA device(s)")
    return torch.device("cuda", index)


def make_mesh(devices=None, n_devices: int | None = None) -> Mesh:
    """Mesh over `devices` (torch devices or strings; repeats allowed),
    default every visible CUDA card. n_devices: keep the first n."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() without devices takes every CUDA card and there "
                "is none; pass devices=['cpu'] * n for a CPU mesh")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if n_devices is not None:
        if not 1 <= n_devices <= len(devices):
            raise ValueError(f"n_devices={n_devices} of {len(devices)} "
                             f"devices")
        devices = devices[:n_devices]
    return Mesh(tuple(devices))


def default_mesh(device=None) -> Mesh:
    """The mesh a `device` argument means (JAX package default_mesh): None
    and "cuda" are every visible card (raising without one), "cuda:N" that
    card alone, "cpu" one CPU device."""
    if device is None or str(device) == "cuda":
        resolve_device(device)          # raises when there is no card
        return make_mesh()
    return make_mesh([device])


def resolve_mesh(mesh, device=None) -> Mesh:
    """The mesh of a fit or a LISI call: `mesh` if given (a Mesh), else
    default_mesh(device)."""
    if mesh is None:
        return default_mesh(device)
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a harmonypy_tpu_torch Mesh "
                        f"(parallel.mesh.make_mesh), got "
                        f"{type(mesh).__name__}")
    return mesh


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """Multi-process runs (one process per host over torch.distributed) are
    ROADMAP.md §1 item 11b; a mesh here is driven by one process."""
    raise NotImplementedError(
        "multi-process runs over torch.distributed are not ported to "
        "harmonypy_tpu_torch yet (ROADMAP.md §1 item 11b); one process "
        "drives a mesh of every visible card (parallel.mesh.make_mesh)")
