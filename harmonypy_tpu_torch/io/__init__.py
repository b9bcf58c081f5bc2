"""Matrix loading for harmonypy_tpu_torch (JAX package io/): the
pandas/NumPy path of load_matrix_tsv and the extension dispatch of
load_matrix."""

from .loader import load_matrix, load_matrix_tsv

__all__ = ["load_matrix", "load_matrix_tsv"]
