"""Matrix loading (JAX package io/loader.py).

  load_matrix_tsv(path)   (gzip-)delimited floats -> float32 ndarray, through
                          the native fasttsv parser (io/native/) for
                          tab-separated files when it builds, else pandas.
                          Handles a header row and a leading row-name
                          column (the layout of the reference's bundled
                          data, e.g. data/pbmc_3500_pcs.tsv.gz).
  load_matrix(path)       dispatch on extension: .npy / .npz / .parquet /
                          .tsv[.gz] / .csv[.gz].
  load_sharded_data(...)  read this process's cells, upload each of its
                          shards of a mesh to its device (JAX package
                          io/loader.py:163-253).

The native parser is built with `make` at first use into
harmonypy_tpu_torch/build/libfasttsv-<hash>.so, the hash of its sources
naming the library (an edited source is rebuilt). When the build fails
the compiler's message is logged once and pandas parses every file.
"""

from __future__ import annotations

import ctypes
import dataclasses
import gzip
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

from ..ops.cuda.build import BUILD
from ..utils.logging import logger

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "native")
_SOURCES = ("fasttsv.cpp", "Makefile")
_lock = threading.Lock()
_lib = None
_lib_tried = False
_build_error: str | None = None   # why the native parser is unavailable


def _so_path() -> str:
    """The library's path, named by a hash of its sources."""
    digest = hashlib.sha256()
    for f in _SOURCES:
        with open(os.path.join(_NATIVE_DIR, f), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD, f"libfasttsv-{digest.hexdigest()[:12]}.so")


def _build(so_path: str) -> None:
    """make in a private temp dir, then an atomic rename into place: several
    processes (pytest-xdist workers) may race here, and a dlopen of a
    half-written library would crash."""
    os.makedirs(BUILD, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as td:
        for f in _SOURCES:
            shutil.copy(os.path.join(_NATIVE_DIR, f), td)
        subprocess.run(["make", "-C", td, "-s"], check=True,
                       capture_output=True, text=True, timeout=120)
        os.replace(os.path.join(td, "_fasttsv.so"), so_path)


def _load_native():
    """The fasttsv library, built first if needed; None when it cannot be
    built or loaded (the reason in _build_error, logged once)."""
    global _lib, _lib_tried, _build_error
    with _lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        so_path = _so_path()
        try:
            if not os.path.exists(so_path):
                _build(so_path)
            lib = ctypes.CDLL(so_path)
        except subprocess.CalledProcessError as e:
            _build_error = f"make exit {e.returncode}: {e.stderr or e.stdout}"
        except (OSError, subprocess.SubprocessError) as e:
            _build_error = f"{type(e).__name__}: {e}"
        if _build_error is not None:
            logger.warning(f"native TSV parser unavailable, parsing with "
                           f"pandas: {_build_error}")
            return None
        lib.fasttsv_load.restype = ctypes.c_void_p
        lib.fasttsv_load.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_char_p, ctypes.c_int]
        lib.fasttsv_rows.restype = ctypes.c_long
        lib.fasttsv_rows.argtypes = [ctypes.c_void_p]
        lib.fasttsv_cols.restype = ctypes.c_long
        lib.fasttsv_cols.argtypes = [ctypes.c_void_p]
        lib.fasttsv_copy.restype = None
        lib.fasttsv_copy.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_float),
                                     ctypes.c_long, ctypes.c_long]
        lib.fasttsv_free.restype = None
        lib.fasttsv_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the native parser built and loaded."""
    return _load_native() is not None


def _load_native_tsv(lib, path: str, rows, n_threads: int):
    """The native parse of path, or None when the parser refuses the file
    (an exotic layout; pandas then parses it)."""
    err = ctypes.create_string_buffer(256)
    h = lib.fasttsv_load(path.encode(), n_threads, err, len(err))
    if not h:
        return None
    try:
        n_rows, n_cols = lib.fasttsv_rows(h), lib.fasttsv_cols(h)
        lo, hi = rows if rows is not None else (0, n_rows)
        lo, hi = max(lo, 0), min(hi, n_rows)
        out = np.empty((max(hi - lo, 0), n_cols), dtype=np.float32)
        if hi > lo:
            lib.fasttsv_copy(
                h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), lo, hi)
        return out
    finally:
        lib.fasttsv_free(h)


def load_matrix_tsv(path: str, rows: tuple[int, int] | None = None,
                    n_threads: int = 0, sep: str = "\t") -> np.ndarray:
    """Parse a (gzip-)delimited float matrix to float32, rows [start, end)
    if given. Tab-separated files go through the native parser (n_threads
    0: one per core) when it is available; other separators, and files it
    refuses, through pandas."""
    lib = _load_native() if sep == "\t" else None
    if lib is not None:
        out = _load_native_tsv(lib, path, rows, n_threads)
        if out is not None:
            return out
    import pandas as pd

    # Header detection (pd.read_csv defaults to header=0, which would eat
    # the first data row of a headerless file): a header is a first line
    # whose first field does not parse as a float.
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        first = f.readline()
    try:
        float(first.split(sep, 1)[0])
        header = None
    except ValueError:
        header = 0
    df = pd.read_csv(path, sep=sep, header=header)
    # Drop a leading row-name (string) column if present.
    if df.shape[1] and not pd.api.types.is_numeric_dtype(df.dtypes.iloc[0]):
        df = df.iloc[:, 1:]
    arr = df.to_numpy(dtype=np.float32)
    if rows is not None:
        arr = arr[rows[0]: rows[1]]
    return np.ascontiguousarray(arr)


def load_matrix(path: str, rows: tuple[int, int] | None = None) -> np.ndarray:
    """Extension-dispatched matrix load -> float32 (cells, d)."""
    base = path[:-3] if path.endswith(".gz") else path
    ext = os.path.splitext(base)[1].lower()
    if ext == ".npy":
        arr = np.load(path, mmap_mode="r")
        arr = arr[rows[0]: rows[1]] if rows is not None else arr[:]
        return np.asarray(arr, dtype=np.float32)
    if ext == ".npz":
        with np.load(path) as z:
            arr = z[z.files[0]]
        if rows is not None:
            arr = arr[rows[0]: rows[1]]
        return np.asarray(arr, dtype=np.float32)
    if ext == ".parquet":
        import pandas as pd
        arr = pd.read_parquet(path).to_numpy(dtype=np.float32)
        if rows is not None:
            arr = arr[rows[0]: rows[1]]
        return np.ascontiguousarray(arr)
    if ext in (".tsv", ".txt", ""):
        return load_matrix_tsv(path, rows=rows)
    if ext == ".csv":
        return load_matrix_tsv(path, rows=rows, sep=",")
    raise ValueError(f"unsupported matrix format: {path}")


def load_sharded_data(pcs_path: str, meta_data, vars_use, mesh, cfg=None):
    """Sharded ingest on a mesh: read this process's cell range of the
    embedding file and upload each of its shards (padded per shard) to its
    device (JAX package io/loader.py:218-247). Formats that seek rows
    (.npy, and the native TSV parser's `rows=`, which parses the file and
    copies the range out) read the range alone; the others parse once per
    process. In one process the range is every cell. Returns (data, cfg, N,
    (Pr_b, phi_n)): data a HarmonyData of this process's per-shard tensors
    (a tensor per field for one shard), cfg the JAX package's default for
    this mesh when none is given (fused with the default chunk size where
    the geometry allows it), its n_covariates set from the design either
    way, Pr_b and phi_n for the hyper-parameter broadcasting."""
    import pandas as pd

    from ..config import EngineConfig, default_nclust, fused_geometry_ok
    from ..parallel.sharding import cell_range, shard_local_inputs

    N = len(meta_data)
    if isinstance(vars_use, str):
        vars_use = [vars_use]
    cats = meta_data[vars_use].astype("category")
    phi = pd.get_dummies(cats).to_numpy().T.astype(np.float32)   # (B, N)
    phi_n = np.asarray([len(cats[c].cat.categories) for c in cats.columns],
                       dtype=int)
    # As Harmony.__init__: one covariate only where every cell has exactly
    # one level (no second covariate, no missing value).
    n_cov = 1 if (phi.size and np.all(phi.sum(axis=0) == 1.0)) else 2
    if cfg is None:
        d = load_matrix(pcs_path, rows=(0, 1)).shape[1]
        cfg = EngineConfig(N=N, d=d, K=default_nclust(N),
                           B=phi.shape[0], n_devices=mesh.size,
                           use_fused_xla=fused_geometry_ok(N, mesh.size),
                           n_covariates=n_cov)
    else:
        cfg = dataclasses.replace(cfg, n_covariates=n_cov)
    lo, hi = cell_range(cfg, mesh)
    X = load_matrix(pcs_path, rows=(lo, hi))
    n = (np.load(pcs_path, mmap_mode="r").shape[0]
         if pcs_path.endswith(".npy") else N)     # a range read counts less
    if X.shape[0] != hi - lo or n != N:
        raise ValueError(f"{pcs_path}: too few or too many cells for the "
                         f"metadata's {N}")
    data = shard_local_inputs(X.T, phi[:, lo:hi], cfg, mesh)
    Pr_b = (phi.sum(axis=1) / N).astype(np.float32)
    return data, cfg, N, (Pr_b, phi_n)
