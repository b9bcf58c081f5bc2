"""Sub-quadratic EXACT kNN: cluster pruning with a per-query certificate
(JAX package ops/knn_pruned.py).

  1. BUILD: coarse k-means over the points (C ~ sqrt(N) centroids, a few
     Lloyd rounds; quality only affects speed, never correctness), points
     laid out contiguously by cluster, per-cluster radius r_c = max member
     distance to the centroid.
  2. QUERY: each cluster's members are queried together against the V
     nearest clusters' members (one (P_max, V*P_max) distance product per
     cluster) and the top-k is taken over those candidates.
  3. CERTIFICATE: by the triangle inequality every point x in an unvisited
     cluster c satisfies d(q, x) >= d(q, mu_c) - r_c. If that lower bound
     exceeds the candidate kth distance for every unvisited cluster, the
     candidate top-k IS the global top-k and the query is *certified*
     exact. The uncertified remainder is re-answered by the brute force
     (lisi._knn_batched), so the result is exact for every query.

Every reduction is deterministic, so one seed gives one index bitwise:
Lloyd's sums are a one-hot product, counts a `bincount`, radii a
scatter-max. Clusters are scanned in batches of a fixed shape (the last
batch padded with sentinel clusters); every cluster writes only its own
rows, so values do not depend on how the scan is batched.

Works in the dtype of its input. A float32 input runs its products in full
float32 (TF32 off for the call): the certificate's margin assumes
fp32-faithful products.

On a mesh (JAX package ops/knn_pruned.py:337-372, 413-480) the index is
built once on the lead device and copied to each shard's; the scan's
cluster batches are dealt out to the shards in turn, and each writes its
clusters' rows of the lead's result buffers. The rows are disjoint and
every batch has the one-device shape, so the values are the one-device
values bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

# Certificate slack: distances enter via two different products (query x
# candidate vs query x centroid), and the absolute error of a squared
# distance computed as ||q||^2 + ||x||^2 - 2 q.x scales with the squared
# DATA RADIUS, not with the distance. The margin is scale-aware:
# _CERT_TOL * (R + d_k) with R the max row norm of the centered points.
_CERT_TOL = 1e-4

_LLOYD_ITERS = 12       # tighter cells -> smaller radii -> more certificates
_ASSIGN_TILE = 16_384   # rows per assignment tile (bounds the (tile, C) d2)
_CLUSTER_BATCH = 128    # clusters of the certification probe
_DEFAULT_VISIT = 32     # candidate clusters per query cluster
_PROBE_MIN_CERT = 0.5   # below this probe certification rate, bail to brute
# Device bytes one scan batch may take (scan_batch_size). Sets the clusters
# per batch; the values do not depend on it.
_SLAB_BYTES = 4 << 30

# p_max cap as a multiple of the mean cluster size (the floor keeps the
# per-cluster windows product-shaped for tiny problems).
_BALANCE_FACTOR = 1.3
_BALANCE_MIN_CAP = 128


@contextlib.contextmanager
def full_precision_matmul():
    """Run float32 products in full float32 (no TF32) inside the block,
    restoring the caller's setting on exit. Float64 is unaffected."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


@dataclasses.dataclass
class PrunedIndex:
    """Cluster index over the (padded) sorted point set, on the points'
    device. Points are stored CENTERED: distances are translation-invariant,
    and centering minimizes the row norms that set the cancellation error
    of every distance product (see _CERT_TOL)."""
    Xs: torch.Tensor         # (N + P_max, d) centered points sorted by cluster
    sqs: torch.Tensor        # (N + P_max,) squared norms, +inf on the pad
    ids: torch.Tensor        # (N + P_max,) int64 original row id (-1 pad)
    starts: torch.Tensor     # (C,) int64 first sorted row of each cluster
    counts: torch.Tensor     # (C,) int64 cluster sizes
    centroids: torch.Tensor  # (C, d)
    radii: torch.Tensor      # (C,) max member distance to centroid (inflated)
    p_max: int               # max cluster size
    scale: torch.Tensor      # () max centered row norm (certificate margin)


def default_n_clusters(n: int, k: int = 1) -> int:
    """Power-of-two C ~ min(sqrt(8N), N / 4k): sqrt(8N) balances the
    certificate product (N x C) against the candidate product
    (N x V*P_max with P_max ~ N/C); the N / 4k cap keeps the average
    cluster well above the neighbor count."""
    c = 1
    while c * c < 8 * n:
        c *= 2
    while c > 1 and c * 4 * k > n:
        c //= 2
    return min(c, max(1, n // 2))


def _assign(X, sq, cent):
    """(N,) nearest-centroid id and (N,) squared distance, in row tiles of
    _ASSIGN_TILE so the (tile, C) distance slab stays small."""
    csq = torch.sum(cent * cent, dim=1)
    a, d2 = [], []
    for lo in range(0, X.shape[0], _ASSIGN_TILE):
        t = (sq[lo: lo + _ASSIGN_TILE, None] + csq[None, :]
             - 2.0 * (X[lo: lo + _ASSIGN_TILE] @ cent.T))
        m = torch.min(t, dim=1)
        a.append(m.indices)
        d2.append(m.values)
    return torch.cat(a), torch.cat(d2)


def _cluster_sums(X, a, C: int):
    """(C, d) per-cluster sums of the rows of X by assignment a: a one-hot
    product per row tile, the tiles added in order (no float atomics)."""
    tot = torch.zeros((C, X.shape[1]), dtype=X.dtype, device=X.device)
    ar = torch.arange(C, device=X.device)
    for lo in range(0, X.shape[0], _ASSIGN_TILE):
        onehot = (ar[:, None] == a[None, lo: lo + _ASSIGN_TILE]).to(X.dtype)
        tot = tot + onehot @ X[lo: lo + _ASSIGN_TILE]
    return tot


def _build(X, C: int, seed: int, iters: int):
    N, d = X.shape
    X = X - torch.mean(X, dim=0, keepdim=True)
    sq = torch.sum(X * X, dim=1)
    scale = torch.sqrt(torch.max(sq))

    # Init from an iid draw; duplicate picks leave some clusters empty,
    # which is harmless.
    gen = torch.Generator(device=X.device)
    gen.manual_seed(int(seed))
    cent = X[torch.randint(0, N, (C,), generator=gen, device=X.device)]
    for _ in range(iters):
        a, _ = _assign(X, sq, cent)
        cnt = torch.bincount(a, minlength=C).to(X.dtype)
        tot = _cluster_sums(X, a, C)
        cent = torch.where(cnt[:, None] > 0,
                           tot / torch.clamp_min(cnt[:, None], 1), cent)
    a, d2 = _assign(X, sq, cent)
    dist = torch.sqrt(torch.clamp_min(d2, 0.0))
    radii = torch.zeros((C,), dtype=X.dtype, device=X.device).scatter_reduce(
        0, a, dist, reduce="amax")
    radii = radii * (1.0 + 1e-6) + 1e-6          # absorb assignment rounding
    counts = torch.bincount(a, minlength=C)
    starts = torch.cumsum(counts, 0) - counts
    perm = torch.sort(a, stable=True).indices    # stable cluster-major layout
    return X[perm], sq[perm], perm, starts, counts, cent, radii, scale


def _balance_split_host(Xs, sqs, perm, counts, cent, radii, cap: int):
    """Split every cluster larger than `cap` by recursive median cut along
    its max-variance axis (host NumPy; only oversized clusters' members are
    touched).

    Every per-cluster query step is shaped by p_max, so a few size outliers
    set the cost of the whole scan. Median cuts keep the halves spatially
    coherent, so sub-cluster radii shrink and the certificate keeps firing;
    ANY partition is correct, balance only buys speed. Split clusters get
    host-f64 centroids/radii with the build's validity inflation; untouched
    clusters keep their values bit for bit."""
    segs, cents, radiis = [], [], []
    pos = 0
    for c, cnt in enumerate(counts):
        rows = np.arange(pos, pos + int(cnt)); pos += int(cnt)
        if cnt <= cap:
            segs.append(rows)
            cents.append(cent[c]); radiis.append(radii[c])
            continue
        stack = [rows]
        while stack:
            rs = stack.pop()
            if len(rs) > cap:
                P = Xs[rs]
                ax = int(np.argmax(P.var(axis=0)))
                med = np.median(P[:, ax])
                left = P[:, ax] <= med
                if left.all() or not left.any():   # degenerate ties
                    order = np.argsort(P[:, ax], kind="stable")
                    half = len(rs) // 2
                    stack.append(rs[order[:half]])
                    stack.append(rs[order[half:]])
                else:
                    stack.append(rs[left])
                    stack.append(rs[~left])
            else:
                segs.append(rs)
                P = Xs[rs].astype(np.float64)
                mu = P.mean(axis=0)
                r = float(np.sqrt(((P - mu) ** 2).sum(axis=1)).max())
                cents.append(mu.astype(Xs.dtype))
                radiis.append(np.asarray(r * (1.0 + 1e-6) + 1e-6, Xs.dtype))
    order = np.concatenate(segs)
    new_counts = np.asarray([len(s) for s in segs], np.int64)
    new_starts = np.cumsum(new_counts) - new_counts
    return (Xs[order], sqs[order], perm[order], new_starts, new_counts,
            np.stack(cents).astype(Xs.dtype),
            np.asarray(radiis, Xs.dtype))


def _padded_index(Xs, sqs, perm, starts, counts, cent, radii, scale):
    """PrunedIndex with P_max pad rows, so every window [start, start +
    P_max) is in bounds."""
    p_max = int(torch.max(counts))
    d = Xs.shape[1]
    Xs = torch.cat([Xs, torch.zeros((p_max, d), dtype=Xs.dtype,
                                    device=Xs.device)])
    sqs = torch.cat([sqs, torch.full((p_max,), float("inf"), dtype=sqs.dtype,
                                     device=sqs.device)])
    ids = torch.cat([perm, torch.full((p_max,), -1, dtype=perm.dtype,
                                      device=perm.device)])
    return PrunedIndex(Xs, sqs, ids, starts, counts, cent, radii, p_max,
                       scale)


def build_index(X: torch.Tensor, n_clusters: int | None = None,
                seed: int = 0, balance: bool = True) -> PrunedIndex:
    """Cluster X (N, d) and lay it out (centered) for pruned search, on X's
    device and in X's dtype. One host readback (the (C,) counts) fixes
    P_max. balance=True splits oversized clusters so p_max stays within
    ~1.3x the mean size (see _balance_split_host)."""
    N, d = X.shape
    C = n_clusters or default_n_clusters(N)
    with full_precision_matmul():
        parts = _build(X, C, seed, _LLOYD_ITERS)
    Xs, sqs, perm, starts, counts, cent, radii, scale = parts
    counts_h = counts.cpu().numpy()
    cap = max(_BALANCE_MIN_CAP, int(np.ceil(_BALANCE_FACTOR * N / C)))
    if balance and int(counts_h.max()) > cap:
        host = [t.cpu().numpy() for t in (Xs, sqs, perm)]
        split = _balance_split_host(*host, counts_h, cent.cpu().numpy(),
                                    radii.cpu().numpy(), cap)
        Xs, sqs, perm, starts, counts, cent, radii = (
            torch.as_tensor(a, device=X.device) for a in split)
    return _padded_index(Xs, sqs, perm, starts, counts, cent, radii, scale)


def index_from_numpy(Xs, sqs, ids, starts, counts, centroids, radii, p_max,
                     scale, device="cpu") -> PrunedIndex:
    """The port's PrunedIndex from a JAX package ``PrunedIndex`` given as
    numpy arrays (its fields in order): the padded layout is the same, ids
    and offsets become int64."""
    def f(a):
        return torch.tensor(np.asarray(a), device=device)

    def i(a):
        return torch.tensor(np.asarray(a, np.int64), device=device)

    return PrunedIndex(f(Xs), f(sqs), i(ids), i(starts), i(counts),
                       f(centroids), f(radii), int(p_max), f(scale))


def _cluster_neighbors(cent, V: int):
    """(C, V) ids of the V nearest clusters of each cluster, by centroid
    distance (self first)."""
    csq = torch.sum(cent * cent, dim=1)
    cc = csq[:, None] + csq[None, :] - 2.0 * (cent @ cent.T)
    return torch.topk(cc, V, dim=1, largest=False).indices


def scan_batch_size(index: PrunedIndex, V: int) -> int:
    """Clusters per scan batch: as many as fit _SLAB_BYTES (two (P, V*P)
    slabs live while the distances are formed and selected, the gathered
    candidates, the (P, C) certificate bounds)."""
    P, C = index.p_max, index.starts.shape[0]
    d, item = index.Xs.shape[1], index.Xs.element_size()
    per = item * (2 * P * V * P + V * P * (d + 3) + 2 * P * C)
    return max(1, min(C, _SLAB_BYTES // per))


def _scan_clusters(index: PrunedIndex, cids, nbrs, k: int, out):
    """Answer all queries owned by the clusters in `cids` (b,) in one batch,
    writing their rows of out = (dist, idx, cert), each (N + P_max, ...).
    Sentinel ids (< 0) pad a batch to its fixed shape and write nothing."""
    Xs, sqs, ids = index.Xs, index.sqs, index.ids
    starts, counts, cent, radii = (index.starts, index.counts,
                                   index.centroids, index.radii)
    P, C, d = index.p_max, cent.shape[0], Xs.shape[1]
    V = nbrs.shape[1]
    b = cids.shape[0]
    slot = torch.arange(P, device=Xs.device)

    live = cids >= 0
    ci = torch.clamp_min(cids, 0)
    rows = starts[ci][:, None] + slot[None, :]                  # (b, P)
    row_valid = (slot[None, :] < counts[ci][:, None]) & live[:, None]
    Q = Xs[rows]                                                # (b, P, d)
    qsq = sqs[rows]

    nb = nbrs[ci]                                               # (b, V)
    crow = (starts[nb][:, :, None] + slot).reshape(b, V * P)    # (b, W)
    cvalid = (slot < counts[nb][:, :, None]).reshape(b, V * P)
    cand = Xs[crow]                                             # (b, W, d)
    candsq = torch.where(cvalid, sqs[crow], float("inf"))
    candid = ids[crow]

    # (qsq + candsq) - 2 Q.cand, the product added in place: -2x is exact,
    # so this rounds as the three-step form does, in one pass over the slab.
    d2 = qsq[:, :, None] + candsq[:, None, :]                   # (b, P, W)
    d2.baddbmm_(Q, cand.transpose(1, 2), alpha=-2.0)
    kd2, pos = torch.topk(d2, k, dim=2, largest=False)
    del d2
    kdist = torch.sqrt(torch.clamp_min(kd2, 0.0))
    kidx = torch.gather(candid, 1, pos.reshape(b, P * k)).reshape(b, P, k)
    d_k = kdist[:, :, -1]

    # Certificate: lower bound to every unvisited cluster vs d_k.
    csq = torch.sum(cent * cent, dim=1)
    qc = qsq[:, :, None] + csq - 2.0 * (Q @ cent.T)             # (b, P, C)
    lb = torch.sqrt(torch.clamp_min(qc, 0.0)) - radii
    visited = torch.zeros((b, C), dtype=torch.bool, device=Xs.device)
    visited.scatter_(1, nb, True)
    lb_min = torch.min(torch.where(visited[:, None, :], float("inf"), lb),
                       dim=2).values
    enough = torch.sum(cvalid, dim=1) >= k
    cert = row_valid & enough[:, None] & (
        lb_min > d_k + _CERT_TOL * (index.scale + d_k))

    at = rows[row_valid]          # each row belongs to one cluster: unique
    dist_o, idx_o, cert_o = out
    dev_o = dist_o.device
    at = at.to(dev_o)
    dist_o[at] = kdist[row_valid].to(dev_o)
    idx_o[at] = kidx[row_valid].to(dev_o)
    cert_o[at] = cert[row_valid].to(dev_o)


def index_to(index: PrunedIndex, device) -> PrunedIndex:
    """The index with every tensor on `device` (itself when already
    there)."""
    if index.Xs.device == torch.device(device):
        return index
    return dataclasses.replace(index, **{
        f.name: getattr(index, f.name).to(device)
        for f in dataclasses.fields(PrunedIndex)
        if isinstance(getattr(index, f.name), torch.Tensor)})


def pruned_knn(X: torch.Tensor, n_neighbors: int,
               visit: int = _DEFAULT_VISIT, n_clusters: int | None = None,
               seed: int = 0, index: PrunedIndex | None = None,
               probe_min_cert: float | None = _PROBE_MIN_CERT,
               stats: dict | None = None, mesh=None):
    """kNN of every row of X against X, via the pruned index.

    Returns (dist (N, k), idx (N, k), cert (N,) bool) with k = n_neighbors
    + 1 (the self point included). `cert[i]` True means row i's top-k is
    PROVEN equal to the global top-k; callers re-answer uncertified rows
    with the brute force.

    probe_min_cert: the first _CLUSTER_BATCH clusters (a random spatial
    sample: ids come from the iid init) are answered first and their
    certification rate measured; below this threshold the search retries
    once with 4x the visit count, and returns None if that fails too
    (pruning cannot pay on this geometry; the caller uses the brute force).
    None disables probing and escalation.

    stats: a dict to fill with the index's C, p_max, the visit count used
    and the clusters per scan batch.

    mesh: deal the scan's cluster batches out to its devices in turn (the
    index built on X's device, copied to the others); the result is on X's
    device and equal to the one-device result.
    """
    N, d = X.shape
    k = n_neighbors + 1
    if index is None:
        index = build_index(X, n_clusters or default_n_clusters(N, k), seed)
    C = index.starts.shape[0]
    V = min(visit, C)
    if k > V * index.p_max:  # cannot even hold k candidates
        raise ValueError(f"k={k} exceeds candidate capacity "
                         f"{V}*{index.p_max}")
    Np = N + index.p_max
    cb = min(_CLUSTER_BATCH, C)
    dev = X.device
    devices = [dev] if mesh is None else list(mesh.devices)
    indexes = {d: index_to(index, d) for d in devices}

    def scan_all(V_try: int):
        """Full pass at one visit count; None if the probe batch fails."""
        nbrs = _cluster_neighbors(index.centroids, V_try)
        nbrs = {d: nbrs.to(d) for d in devices}
        b = scan_batch_size(index, V_try)
        out = (torch.zeros((Np, k), dtype=X.dtype, device=dev),
               torch.full((Np, k), -1, dtype=torch.int64, device=dev),
               torch.zeros((Np,), dtype=torch.bool, device=dev))
        probe = probe_min_cert is not None and C > cb
        n_batch = 0
        for seg_lo, seg_hi in ((0, cb), (cb, C)) if probe else ((0, C),):
            for lo in range(seg_lo, seg_hi, b):
                d = devices[n_batch % len(devices)]
                n_batch += 1
                cids = torch.arange(lo, lo + b, device=d)
                cids = torch.where(cids < seg_hi, cids, -1)
                _scan_clusters(indexes[d], cids, nbrs[d], k, out)
            if probe and seg_lo == 0:
                n_cert = float(torch.sum(out[2]))
                n_probe = float(torch.sum(index.counts[:cb]))
                if n_probe > 0 and n_cert / n_probe < probe_min_cert:
                    return None
        return out, b

    with full_precision_matmul():
        res = scan_all(V)
        if res is None and 4 * V < C:
            # Escalate once, only while 4V still prunes meaningfully.
            V = 4 * V
            res = scan_all(V)
    if stats is not None:
        stats.update(n_clusters=C, p_max=index.p_max, visit=V,
                     probe_ok=res is not None,
                     scan_batch=None if res is None else res[1])
    if res is None:
        return None
    dist_s, idx_s, cert_s = res[0]
    # Back to original row order: sorted row j holds query ids[j].
    inv = torch.empty((N,), dtype=torch.int64, device=dev)
    inv[index.ids[:N]] = torch.arange(N, device=dev)
    return dist_s[inv], idx_s[inv], cert_s[inv]
