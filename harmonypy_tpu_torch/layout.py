"""Host-side cell-axis padding: the names parallel/sharding.py defines,
kept here for the callers that import them from this module."""

from .parallel.sharding import pad_cells, shard_mask, unpad_cells

__all__ = ["pad_cells", "shard_mask", "unpad_cells"]
