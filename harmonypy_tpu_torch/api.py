"""Public API: the run_harmony() entry point and the Harmony result object.

The JAX package's surface (harmonypy_tpu/api.py:34-606, itself the
reference harmony.py:49-355): same signature, hyper-parameter broadcasting,
validation errors, defaults, NumPy-returning properties and objective
histories. A fit runs on a device mesh (parallel/mesh.py): `mesh` if
given, else default_mesh(device), where None and "cuda" mean every visible
card (raising without one), "cuda:N" that card and "cpu" the CPU.

It runs the fits the JAX package runs, on one device or a mesh: the
deferred-R fused fit, the stored-R fused fit (defer_r=False or
use_pallas=True), low_memory (bf16 R), the per-cell fit (the default below
20,480 cells) and the zero-iteration fit, each with checkpoint_dir /
resume_from and the capacity preflight (utils/memory.py). The fused fits
are bitwise the same on every mesh; the per-cell fit to reduction-order
tolerance.
"""

from __future__ import annotations

import os

import numpy as np
import pandas as pd
import torch

from . import engine
from .config import (EngineConfig, auto_chunk_size, cell_tile_geom,
                     default_nclust, expected_skip_fraction,
                     fused_geometry_ok)
from .ops.partition import mesh_round_tables, partition_geometry
from .ops.replay import round_r_windows, windows
from .ops.update_r_fused import make_zp3
from .parallel.mesh import resolve_mesh
from .parallel.sharding import (cat_cells, one_device, parts, shard_inputs,
                                unpad_cells, window_rows)
from .state import HarmonyData, HarmonyParams, HarmonyState
from .utils.checkpoint import load_state, state_to, validate_state
from .utils.logging import logger
from .utils.memory import check_capacity

# Above this N a per-cell fit warns that the fused path would be faster.
_SLOW_PATH_WARN_N = 65536


def run_harmony(
    data_mat,
    meta_data: pd.DataFrame,
    vars_use,
    theta=None,
    lamb=None,
    sigma=0.1,
    nclust=None,
    tau=0,
    block_size=0.05,
    max_iter_harmony=10,
    max_iter_kmeans=20,
    epsilon_cluster=1e-5,
    epsilon_harmony=1e-4,
    alpha=0.2,
    verbose=True,
    random_state=0,
    device=None,
    mesh=None,
    checkpoint_dir=None,
    resume_from=None,
    use_pallas=None,
    chunk_size=None,
    matmul_precision="default",
    low_memory=False,
    defer_r=None,
    fast_objective=False,
    *,
    _init_Y=None,
    _blocks_fn=None,
):
    """Run Harmony batch-effect correction (reference harmony.py:49-215).

    Parameters beyond the reference's follow the JAX package and resolve as
    it resolves them: defer_r=None picks the deferred-R fused fit where the
    fused geometry applies; use_pallas=True or defer_r=False the stored-R
    fused fit; low_memory=True stores R in bfloat16; below the fused
    geometry the per-cell fit runs. mesh: a parallel.mesh.Mesh to spread
    the cells over (default default_mesh(device)). chunk_size=None picks
    the chunk size
    from (N, block_size); fast_objective selects the log-free entropy
    partials for single-covariate designs;
    matmul_precision is accepted for signature compatibility ("default" or
    "float32"; the port computes in float32 either way). checkpoint_dir
    writes harmony_iter_{i}.npz after every harmony iteration; resume_from
    continues from such a file bitwise as the uninterrupted fit would, under
    the settings it was written with (a mismatch raises ValueError listing
    each difference). `_init_Y` and `_blocks_fn` are test hooks (see
    engine.py).
    """
    N = meta_data.shape[0]
    data_mat = np.asarray(data_mat.values if hasattr(data_mat, "values")
                          else data_mat)
    if data_mat.shape[1] != N:
        data_mat = data_mat.T
    assert data_mat.shape[1] == N, \
        "data_mat and meta_data do not have the same number of cells"

    if nclust is None:
        nclust = default_nclust(N)

    sigma = np.asarray(sigma, dtype=np.float32).reshape(-1)
    if sigma.size == 1 and nclust > 1:
        sigma = np.repeat(sigma, nclust)
    if sigma.size != nclust:
        raise ValueError(f"sigma must be a scalar or have nclust={nclust} "
                         f"entries, got {sigma.size}")

    if isinstance(vars_use, str):
        vars_use = [vars_use]

    # One-hot design (reference harmony.py:133-134); phi_n counts declared
    # categories, as pd.get_dummies emits a column for each.
    cats = meta_data[vars_use].astype("category")
    phi = pd.get_dummies(cats).to_numpy().T.astype(np.float32)
    phi_n = np.asarray([len(cats[c].cat.categories) for c in cats.columns],
                       dtype=int)

    # Theta broadcasting (reference harmony.py:136-147).
    if theta is None:
        theta = np.repeat([2] * len(phi_n), phi_n).astype(np.float32)
    elif isinstance(theta, (float, int)):
        theta = np.repeat([theta] * len(phi_n), phi_n).astype(np.float32)
    elif len(theta) == len(phi_n):
        theta = np.repeat([theta], phi_n).astype(np.float32)
    else:
        theta = np.asarray(theta, dtype=np.float32)
    assert len(theta) == np.sum(phi_n), "each batch variable must have a theta"

    # Lambda broadcasting (reference harmony.py:149-166).
    lambda_estimation = False
    if lamb is None:
        lamb = np.repeat([1] * len(phi_n), phi_n).astype(np.float32)
        lamb = np.insert(lamb, 0, 0).astype(np.float32)
    elif np.isscalar(lamb) and lamb == -1:
        lambda_estimation = True
        lamb = np.zeros(1, dtype=np.float32)
    elif isinstance(lamb, (float, int)):
        lamb = np.repeat([lamb] * len(phi_n), phi_n).astype(np.float32)
        lamb = np.insert(lamb, 0, 0).astype(np.float32)
    elif len(lamb) == len(phi_n):
        lamb = np.repeat([lamb], phi_n).astype(np.float32)
        lamb = np.insert(lamb, 0, 0).astype(np.float32)
    else:
        lamb = np.asarray(lamb, dtype=np.float32)
        if len(lamb) == np.sum(phi_n):
            lamb = np.insert(lamb, 0, 0).astype(np.float32)
        else:
            raise ValueError(
                f"lamb has length {len(lamb)}; expected one entry per batch "
                f"variable ({len(phi_n)}) or per batch level "
                f"({int(np.sum(phi_n))})")
    if not lambda_estimation and np.any(np.asarray(lamb)[1:] <= 0):
        # A zero ridge makes the per-cluster system exactly singular.
        raise ValueError(
            "lamb entries must be positive (use lamb=-1 for dynamic "
            "estimation); a zero ridge penalty makes the per-cluster "
            "system singular")

    # Batch proportions + tau discount (reference harmony.py:169-173).
    N_b = phi.sum(axis=1)
    Pr_b = (N_b / N).astype(np.float32)
    if tau > 0:
        theta = theta * (1 - np.exp(-(N_b / (nclust * tau)) ** 2))
        theta = theta.astype(np.float32)

    mesh = resolve_mesh(mesh, device)
    if verbose:
        logger.info(f"Running Harmony (PyTorch on {mesh.size} "
                    f"{mesh.lead.type} device(s))")
        logger.info("  Parameters:")
        logger.info(f"    max_iter_harmony: {max_iter_harmony}")
        logger.info(f"    max_iter_kmeans: {max_iter_kmeans}")
        logger.info(f"    epsilon_cluster: {epsilon_cluster}")
        logger.info(f"    epsilon_harmony: {epsilon_harmony}")
        logger.info(f"    nclust: {nclust}")
        logger.info(f"    block_size: {block_size}")
        if lambda_estimation:
            logger.info(f"    lamb: dynamic (alpha={alpha})")
        else:
            logger.info(f"    lamb: {lamb[1:]}")
        logger.info(f"    theta: {theta}")
        logger.info(f"    sigma: {sigma[:5]}..." if len(sigma) > 5
                    else f"    sigma: {sigma}")
        logger.info(f"    random_state: {random_state}")
        logger.info(f"  Data: {data_mat.shape[0]} PCs × {N} cells")
        logger.info(f"  Batch variables: {vars_use}")

    return Harmony(
        np.asarray(data_mat, dtype=np.float32), phi, Pr_b,
        sigma.astype(np.float32), theta, lamb, alpha, lambda_estimation,
        max_iter_harmony, max_iter_kmeans, epsilon_cluster, epsilon_harmony,
        nclust, block_size, verbose, random_state, device, mesh=mesh,
        checkpoint_dir=checkpoint_dir, resume_from=resume_from,
        use_pallas=use_pallas, chunk_size=chunk_size,
        matmul_precision=matmul_precision, low_memory=low_memory,
        defer_r=defer_r, fast_objective=fast_objective,
        _init_Y=_init_Y, _blocks_fn=_blocks_fn,
    )


class Harmony:
    """Eagerly fitted Harmony result (reference class Harmony,
    harmony.py:218-355): the constructor runs the fit; results are read
    through NumPy-returning, cells-first properties."""

    def __init__(self, Z, Phi, Pr_b, sigma, theta, lamb, alpha,
                 lambda_estimation, max_iter_harmony, max_iter_kmeans,
                 epsilon_kmeans, epsilon_harmony, K, block_size, verbose,
                 random_state, device=None, *, mesh=None, checkpoint_dir=None,
                 resume_from=None, use_pallas=None, chunk_size=None,
                 matmul_precision="default", low_memory=False, defer_r=None,
                 fast_objective=False, _init_Y=None, _blocks_fn=None):
        Z = np.asarray(Z, dtype=np.float32)
        Phi = np.asarray(Phi, dtype=np.float32)
        self.N, self.d, self.B = Z.shape[1], Z.shape[0], Phi.shape[0]
        # Exactly-one-hot columns (one covariate) allow the log-free
        # entropy partials under fast_objective.
        single_onehot = bool(
            Phi.size and np.all(Phi.sum(axis=0) == 1.0)
            and np.all((Phi != 0).sum(axis=0) == 1))
        self.n_covariates = 1 if single_onehot else 2
        self.K = K
        self.window_size = 3
        self.epsilon_kmeans = epsilon_kmeans
        self.epsilon_harmony = epsilon_harmony
        self.block_size = block_size
        self.alpha = alpha
        self.lambda_estimation = lambda_estimation
        self.max_iter_harmony = max_iter_harmony
        self.max_iter_kmeans = max_iter_kmeans
        self.verbose = verbose

        mesh = resolve_mesh(mesh, device)
        n_devices = mesh.size
        chunk_size = auto_chunk_size(self.N, float(block_size), chunk_size)
        fused_ok = fused_geometry_ok(self.N, n_devices, float(block_size),
                                     int(chunk_size))
        if defer_r and not fused_ok:
            raise ValueError(
                f"defer_r requires the fused chunk geometry "
                f"(>= {int(np.ceil(1 / block_size))} chunks of "
                f"{chunk_size} cells; N={self.N} has too few). Use a "
                f"smaller chunk_size.")
        zero_iters = min(int(max_iter_harmony), int(max_iter_kmeans)) < 1
        if defer_r and zero_iters:
            raise ValueError(
                "defer_r requires max_iter_harmony >= 1 and "
                "max_iter_kmeans >= 1: the deferred .R/ridge replay "
                "reproduces the last completed k-means round, which a "
                "zero-iteration fit never runs. Pass defer_r=False to keep "
                "the initial assignments materialized.")
        if matmul_precision not in ("default", "float32"):
            raise ValueError(f"matmul_precision must be 'default' or "
                             f"'float32', got {matmul_precision!r}")
        # As the JAX package resolves them (api.py:290-309): deferred-R is
        # the fused default; use_pallas=True keeps R stored. Both fused
        # flags run the hand-written kernels here: the one-launch round on
        # one device, its per-block entry on a mesh.
        if defer_r is None:
            defer_r = fused_ok and use_pallas is not True and not zero_iters
        use_pallas = bool(use_pallas)
        use_fused_xla = (not use_pallas) and fused_ok

        self.mesh = mesh
        self.device = mesh.lead
        cfg = EngineConfig(
            N=self.N, d=self.d, K=K, B=self.B, n_devices=n_devices,
            use_pallas=use_pallas, use_fused_xla=use_fused_xla,
            defer_r=bool(defer_r), chunk_size=int(chunk_size),
            max_iter_harmony=max_iter_harmony,
            max_iter_kmeans=max_iter_kmeans,
            epsilon_kmeans=float(epsilon_kmeans),
            epsilon_harmony=float(epsilon_harmony),
            window_size=self.window_size, block_size=float(block_size),
            alpha=float(alpha), lambda_estimation=bool(lambda_estimation),
            matmul_precision=str(matmul_precision),
            r_dtype="bfloat16" if low_memory else "float32",
            n_covariates=self.n_covariates,
            fast_objective=bool(fast_objective))
        if not cfg.fused_estep:
            G, cap = cell_tile_geom(cfg.n_blocks)
            frac = expected_skip_fraction(cfg.n_blocks)
            emit = logger.warning if frac > 1e-4 else logger.debug
            emit(f"per-cell E-step: the iid block partition's tile-capacity "
                 f"rule (tile={G} cells, cap={cap} per block) skips an "
                 f"expected {frac:.2e} of cells per round; those cells keep "
                 f"their previous assignment for one round.")
            logger.info(
                "per-cell E-step: results are mesh-invariant to reduction-"
                "order tolerance, not bitwise; a smaller chunk_size (e.g. "
                "chunk_size=128) selects the fused path, which is bitwise "
                "the same on every mesh.")
            if self.N > _SLOW_PATH_WARN_N:
                logger.warning(
                    f"N={self.N}: chunk geometry (chunk_size={chunk_size}) "
                    f"disables the fused E-step; falling back to the "
                    f"per-cell update, which is several times slower at "
                    f"this scale. A smaller chunk_size usually restores the "
                    f"fused path.")
        self.cfg = cfg
        # Capacity preflight (JAX package api.py:362-370): fail before the
        # first upload, with remedies, rather than out of memory midway.
        if not os.environ.get("HARMONYPY_SKIP_CAPACITY_CHECK"):
            check_capacity(cfg, mesh)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(random_state))
        resume = None
        if resume_from is not None:
            state, rng = load_state(resume_from)
            validate_state(state, cfg, resume_from, rng, self.device)
            gen.set_state(rng.gen_state)
            resume = (state_to(state, mesh, cfg), rng)

        lamb_arr = np.atleast_1d(np.asarray(lamb, dtype=np.float32))
        if not lambda_estimation and len(lamb_arr) != self.B + 1:
            raise ValueError(
                f"lamb must have {self.B + 1} entries (intercept + one per "
                f"batch level), got {len(lamb_arr)}")

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32),
                                   device=self.device)

        self._params = HarmonyParams(
            theta=t(theta), sigma=t(sigma),
            lamb=t(np.zeros(self.B + 1) if lambda_estimation else lamb_arr),
            Pr_b=t(Pr_b))
        self._data = shard_inputs(Z, Phi, cfg, mesh)
        self._lamb_raw = np.asarray(lamb, dtype=np.float32)
        init_Y = None if _init_Y is None else t(_init_Y)
        if checkpoint_dir is not None:
            os.makedirs(checkpoint_dir, exist_ok=True)
        self.state: HarmonyState = engine.fit(
            self._data, self._params, cfg, gen, verbose=verbose,
            init_Y=init_Y, blocks_fn=_blocks_fn,
            checkpoint_dir=checkpoint_dir, resume=resume)

    # ---- observability histories (reference harmony.py:273-278) ---------
    def _hist(self, buf, n):
        return list(buf[:n].cpu().numpy().astype(np.float64))

    @property
    def objective_harmony(self):
        return self._hist(self.state.obj_harmony, self.state.n_harmony)

    @property
    def objective_kmeans(self):
        return self._hist(self.state.obj_kmeans, self.state.n_kmeans)

    @property
    def objective_kmeans_dist(self):
        return self._hist(self.state.obj_dist, self.state.n_kmeans)

    @property
    def objective_kmeans_entropy(self):
        return self._hist(self.state.obj_entropy, self.state.n_kmeans)

    @property
    def objective_kmeans_cross(self):
        return self._hist(self.state.obj_cross, self.state.n_kmeans)

    @property
    def kmeans_rounds(self):
        return list(self.state.kmeans_rounds)

    # ---- NumPy-view properties (reference harmony.py:288-355) -----------
    def _cells(self, t) -> np.ndarray:
        return unpad_cells(cat_cells(t).numpy(), self.cfg).T

    @property
    def Z_corr(self):
        """Corrected embedding (N x d)."""
        return self._cells(self.state.Z_corr)

    @property
    def Z_orig(self):
        """Original embedding (N x d)."""
        return self._cells(self._data.Z_orig)

    @property
    def Z_cos(self):
        """L2-normalized embedding (N x d)."""
        return self._cells(self.state.Z_cos)

    @property
    def R(self):
        """Soft cluster assignments (N x K), float32 whatever the storage
        dtype. A deferred-R fit replays its final E-step round in bounded
        chunk windows; a stored-R fit copies its stored R."""
        if self.cfg.defer_r:
            return materialize_r(self.cfg, self.state, self._data,
                                 self._params)
        return stored_r(self.cfg, self.state)

    @property
    def Y(self):
        """Cluster centroids (d x K)."""
        return self.state.Y.cpu().numpy()

    @property
    def O(self):
        """Observed batch-cluster counts (K x B)."""
        return self.state.O.cpu().numpy()

    @property
    def E(self):
        """Expected batch-cluster counts (K x B)."""
        return self.state.E.cpu().numpy()

    @property
    def Phi(self):
        """Batch indicator matrix (N x B)."""
        return self._cells(self._data.Phi)

    @property
    def Phi_moe(self):
        """Batch indicator with intercept column (N x (B+1))."""
        return np.concatenate(
            [np.ones((self.N, 1), np.float32), self.Phi], axis=1)

    @property
    def Pr_b(self):
        return self._params.Pr_b.cpu().numpy()

    @property
    def theta(self):
        return self._params.theta.cpu().numpy()

    @property
    def sigma(self):
        return self._params.sigma.cpu().numpy()

    @property
    def lamb(self):
        return self._lamb_raw

    def result(self):
        """Corrected data as a NumPy array (N x d)."""
        return self.Z_corr


def stored_r(cfg: EngineConfig, state: HarmonyState) -> np.ndarray:
    """A stored-R fit's soft assignments as float32 cells-first (N x K),
    from the chunk-major (fused) or (K, N_local) (per-cell) stored R of
    every shard."""
    Rs = [R.to(torch.float32) for R in parts(state.R)]
    if cfg.fused_estep:
        Rs = [R.permute(1, 0, 2).reshape(cfg.K, cfg.N_local) for R in Rs]
    return unpad_cells(cat_cells(Rs).numpy(), cfg).T


def materialize_r(cfg: EngineConfig, state: HarmonyState, data: HarmonyData,
                  params: HarmonyParams) -> np.ndarray:
    """Page a deferred-R fit's soft assignments to the host (N x K):
    replay the final round once per window of chunks (device peak about
    width * chunk_size * K floats per shard) and copy each shard's chunks
    of the window out, rounded to cfg.r_dtype as the JAX package's replay
    stores it. Shard s's local chunk c is global column s * N_local + c *
    chunk_size of the padded layout (JAX package api.py:578-606)."""
    geom = partition_geometry(cfg)
    CH, K = geom.CH, cfg.K
    ZP3s = [make_zp3(z, p, m, cfg) for z, p, m in zip(
        parts(state.rep_Zcos), parts(data.Phi), parts(data.mask))]
    tables = mesh_round_tables(state.rep_blocks, parts(state.rep_cache), geom,
                               [z.device for z in ZP3s])
    rep = (state.rep_Y, params.sigma, params.theta, params.Pr_b, state.rep_O,
           state.rep_E)
    fast = engine.fast_ent(cfg)
    out = np.zeros((K, cfg.N_pad), np.float32)
    for lo, w in windows(one_device(cfg), budget=64 * 1024 * 1024):
        Rws = round_r_windows(tables, ZP3s, rep, fast, geom, lo, w)
        for s, Rw in enumerate(Rws):
            if Rw is None:
                continue
            l0, p0, n = ((lo, 0, w) if cfg.n_devices == 1
                         else window_rows(geom, s, lo, w))
            Rw = Rw[p0: p0 + n].to(cfg.r_torch_dtype).to(torch.float32)
            c0 = s * cfg.N_local + l0 * CH
            out[:, c0: c0 + n * CH] = (
                Rw.permute(1, 0, 2).reshape(K, n * CH).cpu().numpy())
        state.n_passes += 1
    return unpad_cells(out, cfg).T
