"""Matrix loading (JAX package io/loader.py:89-160, its pandas/NumPy path).

  load_matrix_tsv(path)   (gzip-)delimited floats -> float32 ndarray.
                          Handles a header row and a leading row-name
                          column (the layout of the reference's bundled
                          data, e.g. data/pbmc_3500_pcs.tsv.gz).
  load_matrix(path)       dispatch on extension: .npy / .npz / .parquet /
                          .tsv[.gz] / .csv[.gz].
  load_sharded_data(...)  parse once, upload each shard of a mesh to its
                          device (JAX package io/loader.py:163-253, its
                          single-process form).
"""

from __future__ import annotations

import gzip
import os

import numpy as np


def load_matrix_tsv(path: str, rows: tuple[int, int] | None = None,
                    sep: str = "\t") -> np.ndarray:
    """Parse a (gzip-)delimited float matrix to float32, rows [start, end)
    if given."""
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
    """Sharded ingest on a mesh: parse the embedding file once, then upload
    each shard's cell range (padded per shard) to its device. Returns
    (data, cfg, N, (Pr_b, phi_n)): data a HarmonyData of per-shard tensors
    (a tensor per field on a one-device mesh), cfg the JAX package's
    default for this mesh when none is given (fused with the default
    chunk size where the geometry allows it), Pr_b and phi_n
    for the hyper-parameter broadcasting. One process drives the mesh;
    the per-process ingest of a multi-process run is ROADMAP.md §1 item
    11b."""
    import pandas as pd

    from ..config import EngineConfig, default_nclust, fused_geometry_ok
    from ..parallel.sharding import shard_inputs

    N = len(meta_data)
    if isinstance(vars_use, str):
        vars_use = [vars_use]
    cats = meta_data[vars_use].astype("category")
    phi = pd.get_dummies(cats).to_numpy().T.astype(np.float32)   # (B, N)
    phi_n = np.asarray([len(cats[c].cat.categories) for c in cats.columns],
                       dtype=int)
    X = load_matrix(pcs_path)
    if X.shape[0] != N:
        raise ValueError(f"{pcs_path}: {X.shape[0]} cells, the metadata "
                         f"{N}")
    if cfg is None:
        cfg = EngineConfig(N=N, d=X.shape[1], K=default_nclust(N),
                           B=phi.shape[0], n_devices=mesh.size,
                           use_fused_xla=fused_geometry_ok(N, mesh.size))
    data = shard_inputs(X.T, phi, cfg, mesh)
    Pr_b = (phi.sum(axis=1) / N).astype(np.float32)
    return data, cfg, N, (Pr_b, phi_n)
