"""The device mesh: one process driving a list of torch devices along the
cells axis (JAX package parallel/)."""

from .mesh import AXIS, Mesh, default_mesh, make_mesh

__all__ = ["AXIS", "Mesh", "default_mesh", "make_mesh"]
