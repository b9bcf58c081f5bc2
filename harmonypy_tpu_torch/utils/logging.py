"""Module logger, mirroring the reference's setup (harmony.py:24-32):
DEBUG-level stream handler with a timestamped format."""

import logging

logger = logging.getLogger("harmonypy_tpu_torch")
logger.setLevel(logging.DEBUG)
if not logger.handlers:
    _ch = logging.StreamHandler()
    _ch.setLevel(logging.DEBUG)
    _ch.setFormatter(logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s"))
    logger.addHandler(_ch)
