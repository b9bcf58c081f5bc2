"""The benchmark harness of harmonypy_tpu_torch (see run.py)."""
