"""LISI — Local Inverse Simpson Index (JAX package lisi.py).

Same semantics as the reference (harmonypy lisi.py:24-133): exact kNN with
3*perplexity neighbors (self dropped), Gaussian-kernel perplexity calibration
per cell by a 50-step bisection on beta (tol 1e-5), then the Simpson index
over label categories; LISI = 1/Simpson.

The per-cell loop of the reference becomes one bisection vectorised over
cells; its kd-tree becomes either a tiled brute force (one product per
(query chunk, reference tile), a top-k per tile, an exact merge over tiles)
or, above _PRUNED_MIN_N cells, the cluster-pruned exact search of
ops/knn_pruned.py with a brute-force fallback for the queries its
certificate cannot prove.

compute_lisi computes in float64 on every device, as the reference does;
the kNN functions work in the dtype of their input, float32 products in
full float32. Profiler ranges: lisi::build_index, lisi::scan,
lisi::fallback, lisi::brute, lisi::simpson.

On a device mesh (JAX package lisi.py:207-270, ops/knn_pruned.py:337-480)
the brute force splits the queries over the shards, each against the whole
reference set on its device, and the pruned scan deals the cluster batches
out to the shards, each writing its clusters' rows: no reduction, and every
row is computed as on one device, so the values are the one-device values
bit for bit.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import pandas as pd
import torch
from torch.profiler import record_function

from .ops.knn_pruned import (_DEFAULT_VISIT, build_index, default_n_clusters,
                             full_precision_matmul, pruned_knn)

_KNN_TILE = 131_072  # reference-set tile (memory cap ~ chunk x tile values)
_KNN_BATCH = 65_536  # queries per host batch
_KNN_CHUNK = 1024    # queries per product; every chunk is padded to it

# knn="exact" picks the pruned sub-quadratic search above this N when
# querying every cell; below it the tiled brute force is already fast and
# avoids the index build.
_PRUNED_MIN_N = 100_000

# The pruned search bows out when one cluster's (P, V*P) slab would exceed
# this many bytes at 4 bytes per entry (a pathologically unbalanced index).
_SLAB_CAP_BYTES = 600e6


def _drop_self_by_id(dist, idx, qid):
    """Id-based self-neighbor drop for (M, k) results: remove the entry
    whose index equals the query's own row id, or the worst candidate if
    self is absent. The single rule shared by the brute and pruned paths."""
    k = dist.shape[1]
    match = idx == qid[:, None]
    pos = torch.where(torch.any(match, dim=1),
                      torch.argmax(match.to(torch.int8), dim=1), k - 1)
    keep = torch.arange(k - 1, device=dist.device)[None, :]
    keep = keep + (keep >= pos[:, None]).to(keep.dtype)
    return torch.gather(dist, 1, keep), torch.gather(idx, 1, keep)


def _reference_set(X):
    """(mu, Xp, sqp, T): X centered on its column means, zero-padded to
    whole tiles of T rows, and its squared row norms with +inf on the pad so
    pad distances sort last.

    Centering: distances are translation-invariant, but the rounding error
    of ||q||^2 + ||x||^2 - 2 q.x scales with the squared row norms; on an
    uncentered embedding neighbor ranks would be rounding noise."""
    N, d = X.shape
    mu = torch.mean(X, dim=0, keepdim=True)
    X = X - mu
    sq = torch.sum(X * X, dim=1)
    n_tiles = -(-N // _KNN_TILE)
    T = _KNN_TILE if n_tiles > 1 else N
    pad = n_tiles * T - N
    if pad:
        X = torch.cat([X, X.new_zeros((pad, d))])
        sq = torch.cat([sq, sq.new_full((pad,), float("inf"))])
    return mu, X, sq, T


def _knn_chunks(Q, ref, n_neighbors: int, chunk: int, qid):
    """Brute-force kNN of queries Q (M, d) against a _reference_set, one
    chunk of `chunk` queries at a time (the last one zero-padded, so every
    product has one shape and each query's values do not depend on its
    neighbors in the batch)."""
    mu, Xp, sqp, T = ref
    M, d = Q.shape
    k = n_neighbors + 1  # top-k includes the point itself
    Q = Q - mu
    n_tiles = Xp.shape[0] // T
    dists, idxs = [], []
    for lo in range(0, M, chunk):
        Qc = Q[lo: lo + chunk]
        m = Qc.shape[0]
        if m < chunk:
            Qc = torch.cat([Qc, Qc.new_zeros((chunk - m, d))])
        qsq = torch.sum(Qc * Qc, dim=1)
        vals, ids = [], []
        for t0 in range(0, n_tiles * T, T):
            d2 = qsq[:, None] + sqp[None, t0: t0 + T]          # (chunk, T)
            d2.addmm_(Qc, Xp[t0: t0 + T].T, alpha=-2.0)
            v, i = torch.topk(d2, k, dim=1, largest=False)
            vals.append(v)
            ids.append(i + t0)
        if n_tiles == 1:
            v, i = vals[0], ids[0]
        else:
            # Exact merge: a global top-k winner is a winner in its tile.
            v, which = torch.topk(torch.cat(vals, dim=1), k, dim=1,
                                  largest=False)
            i = torch.gather(torch.cat(ids, dim=1), 1, which)
        dist = torch.sqrt(torch.clamp_min(v, 0.0))
        if qid is None:                                # drop self positionally
            dist, i = dist[:, 1:], i[:, 1:]
        else:
            qc = qid[lo: lo + chunk]
            if m < chunk:
                qc = torch.cat([qc, qc.new_full((chunk - m,), -1)])
            dist, i = _drop_self_by_id(dist, i, qc)
        dists.append(dist[:m])
        idxs.append(i[:m])
    return torch.cat(dists), torch.cat(idxs)


def _knn_impl(Q, X, n_neighbors: int, chunk: int = _KNN_CHUNK, qid=None):
    """Brute-force kNN of queries Q (M, d) against reference set X (N, d):
    (distances, indices), each (M, n_neighbors), the self-neighbor dropped
    (reference lisi.py:53-57). Q must be a subset of X's rows.

    qid: optional (M,) row id of each query in X; the self-neighbor is then
    dropped by id, else positionally (column 0).

    Above _KNN_TILE reference rows, X is scanned in tiles: a top-k per
    (chunk, tile) slab, then a top-k over the per-tile candidates, so the
    slab stays chunk x tile values."""
    with full_precision_matmul():
        return _knn_chunks(Q, _reference_set(X), n_neighbors, chunk, qid)


def _knn_batched(Q, X, n_neighbors: int, chunk: int = _KNN_CHUNK, qid=None,
                 mesh=None):
    """_knn_impl in host batches of _KNN_BATCH queries; each query row is
    independent, so the values equal the one-shot computation. On a mesh
    of several devices the queries are split into one contiguous part per
    shard, each answered on its device against the whole of X; the results
    come back to X's device."""
    devices = [X.device] if mesh is None else list(mesh.devices)
    n = -(-Q.shape[0] // len(devices))
    dists, idxs = [], []
    with full_precision_matmul(), record_function("lisi::brute"):
        refs = {}
        for s, dev in enumerate(devices):
            Qs = Q[s * n: (s + 1) * n].to(dev)
            if Qs.shape[0] == 0:
                continue
            if dev not in refs:
                refs[dev] = _reference_set(X.to(dev))
            qs = None if qid is None else qid[s * n: (s + 1) * n].to(dev)
            for lo in range(0, Qs.shape[0], _KNN_BATCH):
                d, i = _knn_chunks(
                    Qs[lo: lo + _KNN_BATCH], refs[dev], n_neighbors, chunk,
                    None if qs is None else qs[lo: lo + _KNN_BATCH])
                dists.append(d.to(X.device))
                idxs.append(i.to(X.device))
    return torch.cat(dists), torch.cat(idxs)


def _knn_pruned(X, n_neighbors: int, qid, visit: int | None = None,
                stats: dict | None = None, mesh=None):
    """Exact full-N kNN via the pruned search (ops/knn_pruned.py) with a
    brute-force fallback for uncertified queries. Returns (dist, idx) after
    the self-drop, or None when pruning cannot pay on this input: an
    unbalanced index (per-cluster slab over _SLAB_CAP_BYTES), k beyond the
    candidate capacity, or a low certification rate on the probe batch. The
    caller then uses the brute force.

    stats: a dict to fill with the index numbers (pruned_knn's), the
    certification rate and the fallback rows. mesh: the scan and the
    fallback run on its shards."""
    visit = _DEFAULT_VISIT if visit is None else visit
    with record_function("lisi::build_index"):
        index = build_index(X, default_n_clusters(X.shape[0],
                                                  n_neighbors + 1))
    V = min(visit, index.starts.shape[0])
    if (V * index.p_max * index.p_max * 4 > _SLAB_CAP_BYTES
            or n_neighbors + 1 > V * index.p_max):
        return None
    with record_function("lisi::scan"):
        res = pruned_knn(X, n_neighbors, visit=visit, index=index,
                         stats=stats, mesh=mesh)
    if res is None:                                   # probe bail
        return None
    dist, idx, cert = res
    dist, idx = _drop_self_by_id(dist, idx, qid)
    return _fallback(X, dist, idx, cert, n_neighbors, stats, mesh)


def _fallback(X, dist, idx, cert, n_neighbors: int, stats=None, mesh=None):
    """Re-answer the uncertified rows of a pruned result by brute force, the
    query count padded to a power-of-two bucket (at least 256)."""
    with record_function("lisi::fallback"):
        fail = torch.nonzero(~cert).flatten()
        n = int(fail.numel())
        if stats is not None:
            stats.update(cert_rate=1.0 - n / X.shape[0], n_fallback=n)
        if n:
            B = max(256, 1 << (n - 1).bit_length())
            sel = torch.cat([fail, fail.new_zeros(B - n)])
            fqid = torch.cat([fail, fail.new_full((B - n,), -1)])
            fb_d, fb_i = _knn_batched(X[sel], X, n_neighbors, qid=fqid,
                                      mesh=mesh)
            dist[fail] = fb_d[:n]
            idx[fail] = fb_i[:n]
    return dist, idx


def _simpson(dist, labels, n_categories: int, logU: float, tol: float):
    """Perplexity bisection and Simpson index for every cell at once.

    dist: (M, k) neighbor distances; labels: (M, k) neighbor label codes.
    Mirrors the reference compute_simpson (lisi.py:81-132): the beta=1
    start, the double/halve rule before a bracket exists, 50 steps, and
    simpson - 1 when H == 0."""
    def H_of(beta):
        P = torch.exp(-dist * beta[:, None])
        s = torch.sum(P, dim=1)
        good = s > 0.0
        s1 = torch.where(good, s, 1.0)
        H = torch.where(good, torch.log(s1)
                        + beta * torch.sum(dist * P, dim=1) / s1, 0.0)
        return H, torch.where(good[:, None], P / s1[:, None], 0.0)

    beta = torch.ones(dist.shape[0], dtype=dist.dtype, device=dist.device)
    H, _ = H_of(beta)
    bmin = torch.full_like(beta, -float("inf"))
    bmax = torch.full_like(beta, float("inf"))
    Hdiff = H - logU
    for _ in range(50):
        active = torch.abs(Hdiff) >= tol
        up = Hdiff > 0.0
        new_bmin = torch.where(up, beta, bmin)
        new_bmax = torch.where(up, bmax, beta)
        beta_up = torch.where(torch.isfinite(bmax), (beta + bmax) / 2.0,
                              beta * 2.0)
        beta_dn = torch.where(torch.isfinite(bmin), (beta + bmin) / 2.0,
                              beta / 2.0)
        new_beta = torch.where(up, beta_up, beta_dn)
        H_new, _ = H_of(new_beta)
        beta = torch.where(active, new_beta, beta)
        bmin = torch.where(active, new_bmin, bmin)
        bmax = torch.where(active, new_bmax, bmax)
        H = torch.where(active, H_new, H)
        Hdiff = torch.where(active, H_new - logU, Hdiff)
    _, P = H_of(beta)

    # Per-category neighbor mass, one category at a time (no float atomics).
    simpson = torch.zeros_like(beta)
    for c in range(n_categories):
        cs = torch.sum(torch.where(labels == c, P, 0.0), dim=1)
        simpson = simpson + cs * cs
    return torch.where(H == 0.0, simpson - 1.0, simpson)


def _simpson_label(dist, idx, codes, n_categories: int, perplexity: float,
                   tol: float = 1e-5):
    """Simpson index of every query for one label column: codes (N,) label
    code of every cell, on the device of dist."""
    with record_function("lisi::simpson"):
        return _simpson(dist, codes[idx], n_categories,
                        float(np.log(perplexity)), tol)


def compute_simpson(distances, indices, labels, n_categories, perplexity,
                    tol: float = 1e-5, device=None):
    """Reference-compatible entry (lisi.py:68-75): distances/indices are
    (k, N) column-per-cell; labels is a pd.Categorical (or its codes).
    Returns the (N,) Simpson index as NumPy. device as in run_harmony."""
    from .parallel.mesh import resolve_device
    dev = resolve_device(device)
    codes = torch.as_tensor(np.asarray(
        labels.codes if hasattr(labels, "codes") else labels, np.int64),
        device=dev)
    dist = torch.as_tensor(np.ascontiguousarray(np.asarray(distances).T),
                           device=dev)
    idx = torch.as_tensor(np.asarray(indices, np.int64).T, device=dev)
    return _simpson_label(dist, idx, codes, int(n_categories), perplexity,
                          tol).cpu().numpy()


def compute_lisi(
    X,
    metadata: pd.DataFrame,
    label_colnames: Iterable[str],
    perplexity: float = 30,
    sample: int | None = None,
    random_state: int = 0,
    mesh=None,
    knn: str = "exact",
    knn_recall_target: float = 0.95,
    device=None,
):
    """Compute LISI for each label column (reference lisi.py:24-65).

    LISI ~= the effective number of distinct categories among each cell's
    neighbors: 1 = unmixed, n_categories = fully mixed. Computed in float64.

    sample: evaluate LISI only at `sample` uniformly drawn query cells
    (neighbors still come from ALL cells, so each value is exact). Whenever
    `sample` is given the return is a (values, query_indices) pair, even if
    sample >= N (indices are then arange(N)).

    knn: "exact" (default; the reference's neighbor sets) picks the tiled
    brute force or, when querying every cell of a problem of at least
    _PRUNED_MIN_N cells, the cluster-pruned search, whose certificate and
    brute-force fallback keep it exact for every row. "brute" and "pruned"
    force one algorithm (pruned still falls back to brute where the index
    cannot pay). "approx" is the JAX package's TPU hardware approximate
    top-k; here it is answered by the exact top-k, whose recall of 1 meets
    every knn_recall_target in (0, 1] (still validated).

    mesh, device: as in run_harmony; the kNN runs on the mesh (default
    default_mesh(device): None = every visible card, raising without one).
    A torch tensor X without a mesh stays on its own device alone.
    """
    if knn not in ("exact", "brute", "pruned", "approx"):
        raise ValueError(f"knn must be 'exact', 'brute', 'pruned' or "
                         f"'approx', got {knn!r}")
    knn_recall_target = float(knn_recall_target)
    if not 0.0 < knn_recall_target <= 1.0:
        raise ValueError(f"knn_recall_target must be in (0, 1], "
                         f"got {knn_recall_target}")
    from .parallel.mesh import Mesh, resolve_mesh
    if isinstance(X, torch.Tensor) and mesh is None:
        Xd = X.detach().to(torch.float64)
        mesh = Mesh((Xd.device,))
    else:
        mesh = resolve_mesh(mesh, device)
        X = np.asarray(X.values if hasattr(X, "values") else X)
        Xd = torch.tensor(X, dtype=torch.float64, device=mesh.lead)
    dev = Xd.device
    n_cells = metadata.shape[0]
    label_colnames = list(label_colnames)

    if sample is not None and sample < n_cells:
        rng = np.random.default_rng(random_state)
        query_idx = np.sort(rng.choice(n_cells, size=sample, replace=False))
        subset = True
    else:
        query_idx = np.arange(n_cells) if sample is not None else None
        subset = False

    n_neighbors = int(perplexity * 3) - 1
    all_ids = torch.arange(n_cells, device=dev)
    res = None
    if knn == "pruned" or (knn == "exact" and not subset
                           and n_cells >= _PRUNED_MIN_N):
        res = _knn_pruned(Xd, n_neighbors, all_ids, mesh=mesh)
        if res is not None and subset:  # forced pruned: keep sampled rows
            q = torch.as_tensor(query_idx, device=dev)
            res = (res[0][q], res[1][q])
    if res is None:
        if subset:
            q = torch.as_tensor(query_idx, device=dev)
            res = _knn_batched(Xd[q], Xd, n_neighbors, qid=q, mesh=mesh)
        else:
            res = _knn_batched(Xd, Xd, n_neighbors, qid=all_ids, mesh=mesh)
    dist, idx = res

    lisi_df = np.zeros((dist.shape[0], len(label_colnames)))
    for i, label in enumerate(label_colnames):
        labels = pd.Categorical(metadata[label])
        codes = torch.as_tensor(np.asarray(labels.codes, np.int64),
                                device=dev)
        simpson = _simpson_label(dist, idx, codes, len(labels.categories),
                                 perplexity)
        lisi_df[:, i] = 1 / simpson.cpu().numpy()
    if query_idx is not None:
        return lisi_df, query_idx
    return lisi_df
