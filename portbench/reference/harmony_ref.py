"""A plain PyTorch Harmony fit: the yardstick for `run_harmony`.

It computes what Harmony (Korsunsky et al., Nat Methods 2019; harmonypy
harmony.py) computes, as the measured package lays the work out, so that
both sides draw the same random numbers from the same seed and follow one
trajectory:

  init     cells L2-normalised; k-means on a uniform sample of at most
           131,072 cells (greedy k-means++ with 2 + floor(log K) trials,
           or k-means|| with 5 rounds of 2K candidates when sampling),
           Lloyd with sklearn's tolerance; the soft assignments
           softmax(-dist / sigma); O, E and the centroid numerator.
  cluster  per k-means round: Y = l2norm(Z_cos R^T); the chunks of
           `chunk` cells dealt to ceil(1/block_size) blocks by one random
           permutation of the block ids per stripe of n_blocks chunks; per
           block, in block order: remove the block's previous statistics
           from O and E, weights (E / (O + E))^theta, r = softmax(-dist /
           sigma) * weights, normalised, add the block's new statistics.
  ridge    W_k = (Phi_moe diag(R_k) Phi_moe^T + diag(lamb))^-1 Phi_moe
           diag(R_k) Z^T with the intercept row zeroed; Z_corr = Z - sum_k
           W_k^T (Phi_moe * R_k); Z_cos = l2norm(Z_corr).

Every product takes its operands through `op`, the product precision:
"fp32" (operands as they are), "bf16" (each operand rounded to bfloat16,
as matmul_precision="default" states: one bf16 pass, fp32 accumulation)
or "fp8" (e4m3, the control one step below). Sums and the products
themselves run in float32 with TF32 off. Nothing here imports the
measured package; convergence checks are left out, since the benchmark's
fits run every round (epsilon_cluster 0, epsilon_harmony -inf).
"""

from __future__ import annotations

import math

import numpy as np
import torch

CLAMP = 1e-8
SAMPLE = 131072          # k-means init sample
BB_ROUNDS, BB_OVERSAMPLE = 5, 2
LLOYD_ITERS, LLOYD_TOL = 25, 1e-4
PER_CELL_MAX_N = 20480

_DTYPES = {"fp32": None, "bf16": torch.bfloat16,
           "fp8": torch.float8_e4m3fn}


def make_op(precision: str):
    """The operand rounding of a product in `precision`."""
    dt = _DTYPES[precision]
    if dt is None:
        return lambda x: x
    return lambda x: x.to(dt).to(torch.float32)


def chunk_size(n: int, block_size: float) -> int:
    """Cells per chunk: 2048 while every block gets a chunk, else the
    largest power of two (>= 128) that still gives one."""
    nb = math.ceil(1.0 / block_size)
    if -(-n // 2048) >= nb:
        return 2048
    if n < PER_CELL_MAX_N:
        raise ValueError("the per-cell fit below 20,480 cells is not "
                         "covered by this reference")
    c = min(2048, 1 << int(math.floor(math.log2(max(n // nb, 1)))))
    if c < 128 or -(-n // c) < nb:
        raise ValueError(f"no chunk geometry for {n} cells")
    return c


def normalize_cells(X):
    """Each column to unit L2 norm (zero columns stay zero), the sum of
    squares taken one row after the other."""
    ss = X[0] * X[0]
    for x in X[1:]:
        ss = ss + x * x
    n = torch.sqrt(ss)
    return X / torch.where(n > 0, n, torch.ones_like(n))[None, :]


def normalize_cols(X):
    n = torch.sqrt(torch.sum(X * X, dim=0, keepdim=True))
    return X / torch.where(n > 0, n, torch.ones_like(n))


def _gumbel(gen, shape):
    u = torch.rand(shape, generator=gen, device=gen.device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny, max=1.0 - 2 ** -24)
    return -torch.log(-torch.log(u))


def _log_pos(x):
    return torch.where(x > 0, torch.log(torch.where(x > 0, x,
                                                    torch.ones_like(x))),
                       torch.full_like(x, -math.inf))


def _sq(X):
    return torch.sum(X * X, dim=0)


class _KMeans:
    """k-means init of the unit-normalised cells (d, N)."""

    def __init__(self, K, op, gen):
        self.K, self.op, self.gen = K, op, gen
        self.trials = 2 + int(math.log(K)) if K > 1 else 1

    def mm(self, a, b):
        return self.op(a) @ self.op(b)

    def first(self, X, w):
        score = _gumbel(self.gen, (X.shape[1],))
        if w is not None:
            score = _log_pos(w) + score
        c0 = X[:, torch.argmax(score)]
        C = torch.zeros((X.shape[0], self.K), dtype=X.dtype,
                        device=X.device)
        C[:, 0] = c0
        d2 = torch.clamp_min(_sq(X) + torch.sum(c0 ** 2)
                             - 2.0 * self.mm(c0[None], X)[0], 0.0)
        return C, d2

    def greedy(self, X, w, C, d2):
        xsq = _sq(X)
        for t in range(1, self.K):
            logp = _log_pos(d2 if w is None else d2 * w)
            picks = torch.argmax(logp[None, :] + _gumbel(
                self.gen, (self.trials, X.shape[1])), dim=1)
            cand_c = X[:, picks]
            cand = xsq[None, :] + _sq(cand_c)[:, None] - 2.0 * self.mm(
                cand_c.T, X)
            nd2 = torch.minimum(d2[None, :], torch.clamp_min(cand, 0.0))
            pots = torch.sum(nd2 if w is None else nd2 * w[None, :], dim=1)
            best = torch.argmin(pots)
            C[:, t] = cand_c[:, best]
            d2 = nd2[best]
        return C

    def parallel_seed(self, X):
        S, M = X.shape[1], BB_OVERSAMPLE * self.K
        xsq = _sq(X)

        def d2_to(C):
            return torch.clamp_min(_sq(C)[:, None] + xsq[None, :]
                                   - 2.0 * self.mm(C.T, X), 0.0)
        c0 = X[:, torch.argmax(_gumbel(self.gen, (S,)))][:, None]
        cands = [c0]
        d2 = d2_to(c0)[0]
        for _ in range(BB_ROUNDS):
            _, sel = torch.topk(_log_pos(d2) + _gumbel(self.gen, (S,)), M)
            cands.append(X[:, sel])
            d2 = torch.minimum(d2, torch.min(d2_to(X[:, sel]), dim=0).values)
        C = torch.cat(cands, dim=1)
        near = torch.argmin(_sq(C)[:, None] - 2.0 * self.mm(C.T, X), dim=0)
        w = torch.bincount(near, minlength=C.shape[1]).to(X.dtype)
        centers, cd2 = self.first(C, w)
        return self.greedy(C, w, centers, cd2)

    def lloyd(self, C, X):
        S = X.shape[1]
        mean = torch.sum(X, dim=1) / S
        tol = LLOYD_TOL * torch.mean(torch.sum((X - mean[:, None]) ** 2,
                                               dim=1) / S)
        ks = torch.arange(self.K, device=X.device)[:, None]
        for _ in range(LLOYD_ITERS):
            lab = torch.argmin(_sq(C)[:, None] - 2.0 * self.mm(C.T, X), dim=0)
            w = (lab[None, :] == ks).to(X.dtype)
            sums = self.mm(X, w.T)
            cnt = torch.sum(w, dim=1)
            new = torch.where(cnt[None, :] > 0,
                              sums / torch.clamp_min(cnt, 1.0)[None, :], C)
            shift = torch.sum((new - C) ** 2)
            C = new
            if bool(shift <= tol):
                break
        return C

    def __call__(self, Z_cos):
        N = Z_cos.shape[1]
        S = min(SAMPLE, N)
        if S < N:
            ids = torch.randint(0, N, (S,), generator=self.gen,
                                device=self.gen.device)
            X = Z_cos[:, ids.to(Z_cos.device)]
        else:
            X = Z_cos
        if S < N and S >= BB_OVERSAMPLE * self.K:
            C = self.parallel_seed(X)
        else:
            C, d2 = self.first(X, None)
            C = self.greedy(X, None, C, d2)
        return self.lloyd(C, X)


def harmony(Z, batch, B: int, K: int, seed: int, precision: str = "bf16",
            theta: float = 2.0, sigma: float = 0.1, lamb: float = 1.0,
            block_size: float = 0.05, max_iter_harmony: int = 10,
            max_iter_kmeans: int = 20, chunk: int | None = None,
            watch=None):
    """Z_corr (N, d) float32 of Z (N, d) with one covariate of B batches
    (batch: (N,) codes in [0, B)), K clusters, random_state `seed`, on
    Z's device; chunk: cells per chunk (default chunk_size(N)); watch(Y,
    O, E), when given, sees each round's centroids and its O and E after
    the round. Returns (Z_corr, R): R (K, N) the last round's soft
    assignments as the ridge took them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    op = make_op(precision)
    dev = Z.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    f32 = dict(dtype=torch.float32, device=dev)
    N, d = Z.shape
    CH = chunk or chunk_size(N, block_size)
    nb = math.ceil(1.0 / block_size)
    NC = -(-N // CH)
    NCf = -(-NC // nb) * nb
    J = NCf // nb

    # Chunk-major cells: (NCf, rows, CH), padding cells all zero.
    def chunks(X):
        out = torch.zeros((X.shape[0], NCf * CH), **f32)
        out[:, :N] = X
        return out.reshape(X.shape[0], NCf, CH).permute(1, 0, 2).contiguous()

    batch = torch.as_tensor(batch, device=dev).long()
    Phi = (batch[None, :] == torch.arange(B, device=dev)[:, None]).to(
        torch.float32)
    Pr_b = (torch.as_tensor(np.bincount(batch.cpu().numpy(), minlength=B)
                            / N, **f32))
    thetas = torch.full((B,), theta, **f32)
    sig = torch.full((K,), sigma, **f32)
    lam = torch.full((B + 1,), lamb, **f32)
    lam[0] = 0.0
    A3 = chunks(torch.cat([torch.ones((1, N), **f32), Phi]))  # (NCf, B1, CH)
    Zo = Z.T.contiguous()
    Zo3 = chunks(Zo)
    Z_cos = normalize_cells(Zo)
    Zc3 = chunks(Z_cos)

    Y = normalize_cols(_KMeans(K, op, gen)(Z_cos))
    dist = 2.0 * (1.0 - torch.einsum("kd,jdc->jkc", op(Y.T), op(Zc3)))
    e = torch.exp(-dist / sig[None, :, None])
    R3 = e / torch.sum(e, dim=1, keepdim=True) * A3[:, None, 0]  # (NCf,K,CH)
    Ysum = torch.einsum("jdc,jkc->dk", op(Zc3), op(R3))
    O = torch.einsum("jkc,jbc->kb", R3, A3[:, 1:])
    E = torch.sum(R3, dim=(0, 2))[:, None] * Pr_b[None, :]
    for _ in range(max_iter_harmony):
        for _ in range(max_iter_kmeans):
            Y = normalize_cols(Ysum)
            keys = torch.rand((J, nb), generator=gen, device=gen.device)
            blocks = torch.argsort(keys, dim=1, stable=True).reshape(-1)
            table = torch.argsort(blocks, stable=True).reshape(nb, J).to(dev)
            Ysum = torch.zeros((d, K), **f32)
            opYT = op(Y.T)
            for b in range(nb):
                sl = table[b]
                a, z, r_old = A3[sl], Zc3[sl], R3[sl]
                E = E - torch.sum(r_old, dim=(0, 2))[:, None] * Pr_b[None, :]
                O = O - torch.einsum("jkc,jbc->kb", r_old, a[:, 1:])
                lr = torch.log(torch.clamp(E / torch.clamp_min(O + E, CLAMP),
                                           CLAMP, 1.0))
                wdiv = torch.exp(thetas[None, :] * lr)           # (K, B)
                dist = 2.0 * (1.0 - torch.einsum("kd,jdc->jkc", opYT, op(z)))
                s = torch.exp(-dist / sig[None, :, None])
                r = s / torch.sum(s, dim=1, keepdim=True) * torch.einsum(
                    "kb,jbc->jkc", op(wdiv), a[:, 1:])
                r = r / torch.clamp_min(torch.sum(r, dim=1, keepdim=True),
                                        CLAMP)
                r = op(r)
                R3[sl] = r
                O = O + torch.einsum("jkc,jbc->kb", r, a[:, 1:])
                E = E + torch.sum(r * a[:, None, 0], dim=(0, 2))[:, None] \
                    * Pr_b[None, :]
                Ysum = Ysum + torch.einsum("jdc,jkc->dk", op(z), r)
            if watch is not None:
                watch(Y, O, E)
        # Ridge on the last round's assignments, over flat (rows, cells)
        # views. Phi is one-hot, so cov[k] holds the design rows' sums of
        # R_k on its diagonal and in the intercept's row and column; rhs
        # and the correction go one design row at a time (no (B1, B1, N)
        # or (B1, d, N) intermediate).
        B1 = B + 1
        Rf = R3.permute(1, 0, 2).reshape(K, -1)
        Af = A3.permute(1, 0, 2).reshape(B1, -1)
        Zf = op(Zo3).permute(1, 0, 2).reshape(d, -1)
        rows = Rf @ Af.T                                          # (K, B1)
        cov = torch.diag_embed(rows + lam[None, :])
        cov[:, 0, 1:] = rows[:, 1:]
        cov[:, 1:, 0] = rows[:, 1:]
        rhs = torch.stack([Rf @ (Zf * Af[b]).T for b in range(B1)], 1)
        W = torch.cholesky_solve(rhs, torch.linalg.cholesky(cov))
        W[:, 0, :] = 0.0
        opW = op(W)
        corr = torch.zeros_like(Zf)
        for b in range(1, B1):
            corr += Af[b] * (opW[:, b].T @ Rf)
        Zcorr3 = Zo3 - corr.reshape(d, NCf, CH).permute(1, 0, 2)
        Zc3 = normalize_cells(Zcorr3.permute(1, 0, 2)).permute(1, 0, 2) \
            .contiguous()
        Ysum = torch.einsum("jdc,jkc->dk", op(Zc3), R3)
    Z_corr = Zcorr3.permute(1, 0, 2).reshape(d, NCf * CH)[:, :N].T
    R = R3.permute(1, 0, 2).reshape(K, NCf * CH)[:, :N]
    return Z_corr.contiguous(), R
