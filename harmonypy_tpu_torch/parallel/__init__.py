"""The device mesh: a list of torch devices along the cells axis, driven by
one process or, after initialize_distributed, by every process of a
torch.distributed run (JAX package parallel/)."""

from .mesh import (AXIS, Mesh, default_mesh, initialize_distributed,
                   make_mesh, process_count, process_index,
                   shutdown_distributed)

__all__ = ["AXIS", "Mesh", "default_mesh", "initialize_distributed",
           "make_mesh", "process_count", "process_index",
           "shutdown_distributed"]
