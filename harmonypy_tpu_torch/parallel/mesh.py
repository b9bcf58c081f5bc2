"""Device mesh for the cell-parallel engine (JAX package parallel/mesh.py).

Cells are the only scaling dimension of Harmony, so the mesh is one axis,
"cells", over an ordered tuple of torch devices. Shard s holds the s-th
contiguous range of cells; the engine launches each shard's work on its
device and gathers the per-chunk rows of every reduction onto the lead
device (`devices[0]`). A device may appear more than once: `make_mesh(
["cuda:0"] * 4)` is four logical shards on one card, which runs (and
checks) the mesh path with one card, as the JAX package's tests run it on
virtual CPU devices.

Multi-process runs (JAX package parallel/mesh.py:25-38). After
`initialize_distributed` (torch.distributed over the default process
group), `make_mesh` builds the global mesh: every process passes its own
devices (the same number on each), the shards are ordered by rank, then
by local device (the JAX process-major order), and `Mesh.devices` holds
this process's shards, `Mesh.shard_ids` their global indices. Every
reduction over shards then goes through a collective that every rank
issues in the same order (`all_gather_rows`, `all_gather_packed`): the
engine's per-chunk frames, the re-add of each block, the per-cell fit's
shard partials, k-means' sample, LISI's rows and the readback; what one
rank alone computes (LISI's kNN index) goes to the others by `broadcast`.
Which shards a process holds follows from the configuration alone
(`local_shards`), so the engine takes no extra argument.

A mesh is all CPU or all CUDA, and its CUDA devices are one card model:
the fused E-step kernel splits its work by the SM count of the lead device
(ops/cuda/fused_estep.kernel_geometry), and every shard must split the
same way for the one-device bits.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import math
import os

import torch
import torch.distributed as dist

AXIS = "cells"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered tuple of torch devices along the "cells" axis: this
    process's shards, process `process` of `n_processes` (each holding as
    many shards)."""

    devices: tuple
    n_processes: int = 1
    process: int = 0

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
        """Shards of the whole mesh, across processes."""
        return len(self.devices) * self.n_processes

    @property
    def shard_ids(self) -> range:
        """Global indices of this process's shards."""
        n = len(self.devices)
        return range(self.process * n, (self.process + 1) * n)

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
    default every visible CUDA card. n_devices: keep the first n.

    In a process group (initialize_distributed) the mesh spans every
    process: `devices` are this process's shards (default the process's
    device), every rank must pass as many, and the card model and SM count
    must agree across ranks (checked by a collective: every rank calls
    make_mesh)."""
    if devices is None:
        if spans_processes():
            devices = [_process_device]
        elif not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() without devices takes every CUDA card and there "
                "is none; pass devices=['cpu'] * n for a CPU mesh")
        else:
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if n_devices is not None:
        if not 1 <= n_devices <= len(devices):
            raise ValueError(f"n_devices={n_devices} of {len(devices)} "
                             f"devices")
        devices = devices[:n_devices]
    if not spans_processes():
        return Mesh(tuple(devices))
    mesh = Mesh(tuple(devices), process_count(), process_index())
    mine = (len(devices), devices[0].type,
            sorted({(torch.cuda.get_device_name(d),
                     torch.cuda.get_device_properties(d).multi_processor_count)
                    for d in devices if d.type == "cuda"}))
    every = [None] * mesh.n_processes
    dist.all_gather_object(every, mine)
    if len({e[0] for e in every}) > 1:
        raise ValueError(f"every process of a mesh holds as many shards: "
                         f"{[e[0] for e in every]} by rank")
    if len({e[1] for e in every}) > 1:
        raise ValueError(f"a mesh is all CPU or all CUDA, across processes: "
                         f"{[e[1] for e in every]} by rank")
    if len({tuple(e[2]) for e in every}) > 1:
        raise ValueError(f"a mesh of different card models or SM counts "
                         f"{[e[2] for e in every]} by rank: the kernel's work "
                         f"split follows the lead card's SM count")
    return mesh


def default_mesh(device=None) -> Mesh:
    """The mesh a `device` argument means (JAX package default_mesh): None
    and "cuda" are every visible card (raising without one), "cuda:N" that
    card alone, "cpu" one CPU device. In a process group, the global mesh
    of one shard per process: the process's device for None and "cuda".

    Every card from one process is the JAX package's meaning, not the
    fastest way to run there: on four H100s at 2.4M cells x 50 PCs over 49
    batches (the benchmark's hlca-2400k-4card.fit) a default fit takes
    4.98-5.31 s against 2.32-2.52 s on one card (a mesh pass 4.06 ms
    traced), and the host waits 28.8 times a k-means round against 7.8;
    one process per card (initialize_distributed) took 0.83-1.06 ms a pass
    at 858k cells against 0.61 ms for one card's round (PERF.md §6)."""
    if device is None or str(device) == "cuda":
        if not spans_processes():
            resolve_device(device)      # raises when there is no card
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
    if mesh.n_processes != process_count():
        raise ValueError(f"a mesh of {mesh.n_processes} process(es) in a run "
                         f"of {process_count()}: make the mesh with "
                         f"make_mesh after initialize_distributed")
    return mesh


# ---- multi-process runs -------------------------------------------------

_process_device: torch.device | None = None


def _init_method(coordinator_address: str | None) -> str:
    """torch.distributed's init method for a coordinator: "host:port" ->
    tcp://host:port; a URL (tcp://, file://, env://) as given; None -> the
    torchrun environment (MASTER_ADDR, MASTER_PORT)."""
    if coordinator_address is None:
        if "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
            return "env://"
        raise ValueError("initialize_distributed needs a coordinator address "
                         "(host:port) or MASTER_ADDR / MASTER_PORT")
    addr = str(coordinator_address)
    if addr.startswith(("tcp://", "file://", "env://")):
        return addr
    host, sep, port = addr.rpartition(":")
    if not sep or not host or not port.isdigit() or not 0 < int(port) < 65536:
        raise ValueError(f"coordinator address {addr!r} is not host:port "
                         f"(or a tcp://, file:// or env:// URL)")
    return f"tcp://{host}:{int(port)}"


def _env_int(value, name: str, what: str) -> int:
    if value is not None:
        return int(value)
    if name not in os.environ:
        raise ValueError(f"initialize_distributed needs {what} (or ${name})")
    return int(os.environ[name])


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, *,
                           backend: str | None = None, device=None,
                           timeout_s: float | None = None) -> torch.device:
    """Join this process to a multi-process run (JAX package
    parallel/mesh.py:25-38, jax.distributed.initialize): torch.distributed's
    default process group over `coordinator_address` ("host:port", or an
    init-method URL such as file:///path), of `num_processes` ranks, this
    one `process_id` (defaults: $WORLD_SIZE, $RANK, and $MASTER_ADDR /
    $MASTER_PORT as torchrun sets them).

    device: this process's device, default (None or "cuda")
    cuda:$LOCAL_RANK, else process_id modulo the visible cards; it raises
    without a card and
    never falls back to the CPU; "cpu" explicitly. backend: None means
    "nccl" for a CUDA device and "gloo" for the CPU; another may be asked
    for (for example "gloo" for several ranks on one card, which NCCL
    refuses). A backend that fails is not replaced by another.
    timeout_s bounds every collective (torch's default otherwise).
    Returns the process's device."""
    global _process_device
    if dist.is_initialized():
        raise RuntimeError("initialize_distributed: this process is already "
                           "in a process group")
    init_method = _init_method(coordinator_address)
    n = _env_int(num_processes, "WORLD_SIZE", "num_processes")
    rank = _env_int(process_id, "RANK", "process_id")
    if not 0 <= rank < n:
        raise ValueError(f"process_id {rank} outside [0, {n})")
    if device is None or str(device) == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "initialize_distributed: each process runs on a CUDA card by "
                "default and none is available; pass device='cpu' (backend "
                "gloo) to run on the CPU")
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        device = f"cuda:{local}"
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # torch's flight recorder captures a Python stack for every collective,
    # ~75 us of host time each (NVIDIA H100 80GB HBM3, 700 W, torch
    # 2.11): a mesh pass issues one per block. Off unless asked for.
    if not any(v in os.environ for v in ("TORCH_FR_BUFFER_SIZE",
                                         "TORCH_NCCL_TRACE_BUFFER_SIZE")):
        os.environ["TORCH_FR_BUFFER_SIZE"] = "0"
    kw = {} if timeout_s is None else dict(
        timeout=datetime.timedelta(seconds=float(timeout_s)))
    dist.init_process_group(backend, init_method=init_method, world_size=n,
                            rank=rank, **kw)
    _process_device = dev
    return dev


def shutdown_distributed() -> None:
    """Leave the process group (every rank calls it)."""
    global _process_device
    if dist.is_initialized():
        dist.destroy_process_group()
    _process_device = None


def spans_processes(n_devices: int | None = None) -> bool:
    """Whether meshes span the processes of a process group (and, given a
    mesh's shard count, whether that mesh's reductions are collectives:
    always but for one shard)."""
    inited = dist.is_available() and dist.is_initialized()
    return inited and (n_devices is None or n_devices > 1)


def process_index() -> int:
    """This process's rank (0 outside a process group)."""
    return dist.get_rank() if spans_processes() else 0


def process_count() -> int:
    """Processes of the run (1 outside a process group)."""
    return dist.get_world_size() if spans_processes() else 1


def local_shards(n_devices: int) -> range:
    """Global indices of this process's shards of a mesh of n_devices
    shards: every shard in one process, the rank's contiguous part in a
    process group (as make_mesh orders them)."""
    if not spans_processes(n_devices):
        return range(n_devices)
    P = process_count()
    if n_devices % P:
        raise ValueError(f"a mesh of {n_devices} shards over {P} processes")
    n = n_devices // P
    return range(process_index() * n, (process_index() + 1) * n)


def _stage_device(t: torch.Tensor):
    """Where a collective of the process group must see `t`: None when
    the backend takes it where it lies, else the CPU (a CUDA tensor under
    gloo, which takes CPU tensors only) or the process's card (a CPU
    tensor under NCCL, which takes CUDA tensors only)."""
    backend = str(dist.get_backend())
    if t.is_cuda and backend == "gloo":
        return torch.device("cpu")
    if not t.is_cuda and backend == "nccl":
        return _process_device or torch.device(
            "cuda", torch.cuda.current_device())
    return None


def gatherer(out: torch.Tensor, t: torch.Tensor):
    """A call that all-gathers every rank's `t` (contiguous, equal shapes)
    into `out` (process_count() * t.shape[0] rows), concatenated along dim
    0 in rank order: one all-gather, copies only, the backend's form and
    any staging buffer decided once (a mesh pass issues it once per
    block, reading whatever `t` holds then). NCCL orders it on the current
    stream (the host does not wait). torch's gloo backend gathers CPU
    tensors only, so a CUDA tensor under gloo is staged through the host
    (the host waits for the stream); NCCL gathers CUDA tensors only, so a
    CPU tensor under NCCL is staged through the process's card."""
    if not t.is_contiguous():
        raise ValueError("gatherer: the gathered tensor must be contiguous")
    if t.dtype == torch.bfloat16:       # moved as its bits
        return gatherer(out.view(torch.int16), t.view(torch.int16))
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    stage = _stage_device(t)
    if stage is None:
        return functools.partial(gather, out, t)
    buf = torch.empty(out.shape, dtype=out.dtype, device=stage)

    def staged():
        gather(buf, t.to(stage))
        out.copy_(buf)
    return staged


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's `t` (equal shapes) concatenated along dim 0 in rank
    order, on t's device (gatherer)."""
    out = t.new_empty((process_count() * t.shape[0],) + tuple(t.shape[1:]))
    gatherer(out, t.contiguous())()
    return out


def all_gather_cat(t: torch.Tensor, axis: int) -> torch.Tensor:
    """Every rank's `t` concatenated along `axis` in rank order."""
    g = all_gather_rows(t.unsqueeze(0))
    return torch.cat(g.unbind(0), dim=axis)


def all_gather_packed(ts) -> list:
    """all_gather_rows of several tensors with equal leading dims (any
    dtypes, e.g. distances, ids and flags of the same rows) in ONE
    collective: each viewed as its bytes, side by side per row, gathered,
    and cut apart again. Copies only; returns each gathered tensor, every
    rank's rows in rank order."""
    ts = [t.contiguous() for t in ts]
    n = ts[0].shape[0]
    raw = [t.reshape(n, math.prod(t.shape[1:])).view(torch.uint8)
           for t in ts]
    every = all_gather_rows(torch.cat(raw, dim=1) if len(raw) > 1
                            else raw[0])
    out, lo = [], 0
    for t, r in zip(ts, raw):
        w = r.shape[1]
        out.append(every[:, lo: lo + w].contiguous().view(t.dtype)
                   .reshape((every.shape[0],) + tuple(t.shape[1:])))
        lo += w
    return out


def broadcast(t: torch.Tensor | None, device=None) -> torch.Tensor:
    """Rank 0's tensor `t` on every rank (rank 0 gets `t` itself; the
    others pass None and get it on `device`): its dtype and shape go first
    (one object broadcast), then its bytes. A collective every rank
    calls."""
    meta = [None if t is None else (t.dtype, tuple(t.shape))]
    dist.broadcast_object_list(meta, src=0)
    dtype, shape = meta[0]
    if process_index() == 0:
        buf = t.contiguous()
    else:
        buf = torch.empty(shape, dtype=dtype, device=device)
    raw = buf.reshape(-1).view(torch.uint8) if buf.numel() else \
        buf.new_empty((0,), dtype=torch.uint8)
    stage = _stage_device(raw)
    if stage is None:
        dist.broadcast(raw, src=0)
    else:
        tmp = raw.to(stage)
        dist.broadcast(tmp, src=0)
        raw.copy_(tmp)
    return buf
