"""Matrix loading for harmonypy_tpu_torch (JAX package io/): load_matrix_tsv
through the native fasttsv parser (io/native/, built at first use) or
pandas, the extension dispatch of load_matrix, and the single-process
sharded ingest load_sharded_data."""

from .loader import (load_matrix, load_matrix_tsv, load_sharded_data,
                     native_available)

__all__ = ["load_matrix", "load_matrix_tsv", "load_sharded_data",
           "native_available"]
