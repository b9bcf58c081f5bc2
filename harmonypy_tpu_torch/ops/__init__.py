"""Tensor operations of the Harmony engine (PyTorch)."""
