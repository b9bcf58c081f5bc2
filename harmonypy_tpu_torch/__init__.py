"""harmonypy_tpu_torch — Harmony batch-effect correction in PyTorch with
hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package `harmonypy_tpu`, with the same `run_harmony` /
`Harmony` / `compute_lisi` surface, on a device mesh (`make_mesh`): every
visible CUDA card by default, the CPU when asked (`device="cpu"`), driven
by one process or, after `initialize_distributed`, by one process per card
over torch.distributed.
"""

from .api import Harmony, run_harmony
from .lisi import compute_lisi
from .parallel.mesh import (Mesh, default_mesh, initialize_distributed,
                            make_mesh)

__version__ = "0.1.0"

__all__ = ["Harmony", "run_harmony", "compute_lisi", "Mesh", "make_mesh",
           "default_mesh", "initialize_distributed", "__version__"]
