"""Matrix loading for harmonypy_tpu_torch (JAX package io/): the
pandas/NumPy path of load_matrix_tsv, the extension dispatch of
load_matrix, and the single-process sharded ingest load_sharded_data."""

from .loader import load_matrix, load_matrix_tsv, load_sharded_data

__all__ = ["load_matrix", "load_matrix_tsv", "load_sharded_data"]
