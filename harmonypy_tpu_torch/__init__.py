"""harmonypy_tpu_torch — Harmony batch-effect correction in PyTorch with
hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package `harmonypy_tpu`, with the same `run_harmony` /
`Harmony` / `compute_lisi` surface, on one device: CUDA by default, the CPU
when asked (`device="cpu"`).
"""

from .api import Harmony, run_harmony
from .lisi import compute_lisi

__version__ = "0.1.0"

__all__ = ["Harmony", "run_harmony", "compute_lisi", "__version__"]
