"""harmonypy_tpu_torch — Harmony batch-effect correction in PyTorch with
hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package `harmonypy_tpu`, with the same `run_harmony` /
`Harmony` surface. This release runs the deferred-R fused fit on one
device: CUDA by default, the CPU when asked (`device="cpu"`).
"""

from .api import Harmony, run_harmony

__version__ = "0.1.0"

__all__ = ["Harmony", "run_harmony", "__version__"]
