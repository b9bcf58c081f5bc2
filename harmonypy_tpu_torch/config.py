"""Static configuration for the PyTorch/CUDA Harmony engine.

A copy of the JAX package's ``EngineConfig`` and its derived geometry, so
that both packages lay out cells, chunks and blocks identically: shapes,
loop bounds, convergence thresholds and padding. The hyper-parameter
*tensors* (theta, sigma, lamb, Pr_b) live in
:class:`harmonypy_tpu_torch.state.HarmonyParams`.

Reference behaviour mirrored (harmonypy harmony.py):
  - ``n_blocks = ceil(1/block_size)`` (harmony.py:474-484);
  - defaults sigma=0.1, block_size=0.05, max_iter_harmony=10,
    max_iter_kmeans=20, epsilon_cluster=1e-5, epsilon_harmony=1e-4,
    alpha=0.2, window_size=3 (harmony.py:49-67, 258).
"""

from __future__ import annotations

import dataclasses
import math

import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def default_nclust(N: int) -> int:
    """Reference default cluster count (harmony.py:123-124):
    min(round(N / 30), 100)."""
    return int(min(round(N / 30.0), 100))


CELL_TILE_M = 64  # mean cells per (capacity tile, block) in the iid partition


def cell_tile_geom(nb: int) -> tuple[int, int]:
    """(tile size G, per-(tile, block) capacity cap) of the per-cell iid
    block partition (ops/partition.py iid_blocks): mean occupancy of a
    (tile, block) group is m = G/nb = CELL_TILE_M, and cap = m +
    ceil(4 sqrt(m)) is a >= 4-sigma bound on it."""
    m = CELL_TILE_M
    return nb * m, m + int(math.ceil(4.0 * math.sqrt(m)))


def expected_skip_fraction(nb: int) -> float:
    """Exact expected fraction of cells the per-cell capacity rule skips per
    round: E[(X - cap)^+] / m with X ~ Binomial(G, 1/nb) the occupancy of
    one (tile, block) group."""
    G, cap = cell_tile_geom(nb)
    if cap >= G:
        return 0.0
    p = 1.0 / nb
    lp, l1p = math.log(p), math.log1p(-p)
    lgG = math.lgamma(G + 1)
    acc = 0.0
    for x in range(cap + 1, G + 1):
        lpmf = (lgG - math.lgamma(x + 1) - math.lgamma(G - x + 1)
                + x * lp + (G - x) * l1p)
        acc += (x - cap) * math.exp(lpmf)
    return acc / CELL_TILE_M


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static geometry + loop bounds for one Harmony problem."""

    # Problem shape.
    N: int            # true number of cells
    d: int            # number of PCs
    K: int            # number of clusters
    B: int            # number of batch levels (rows of Phi, without intercept)
    n_devices: int    # shards of the mesh the cells are spread over

    # Algorithm loop bounds / thresholds.
    max_iter_harmony: int = 10
    max_iter_kmeans: int = 20
    epsilon_kmeans: float = 1e-5
    epsilon_harmony: float = 1e-4
    window_size: int = 3
    block_size: float = 0.05
    alpha: float = 0.2
    lambda_estimation: bool = False

    # k-means init (sklearn KMeans(init='k-means++', n_init=1, max_iter=25)
    # at reference harmony.py:370-372). Seeding and Lloyd run on a uniform
    # sample of at most `kmeanspp_sample` cells; above it, seeding is
    # k-means|| with `kmeansbb_rounds` rounds of `kmeansbb_oversample * K`
    # candidates.
    kmeans_max_iter: int = 25
    kmeans_tol: float = 1e-4
    kmeanspp_sample: int = 131072
    kmeansbb_rounds: int = 5
    kmeansbb_oversample: int = 2

    # Storage dtype of a stored soft-assignment matrix R.
    r_dtype: str = "float32"
    # The fused E-step kernels' products on a CUDA card: "default" one bf16
    # tensor-core pass with fp32 accumulation, "float32" 3xTF32; on the CPU
    # both run in fp32 (ops/cuda/fused_estep.py).
    matmul_precision: str = "default"

    # Fused chunk-granular E-step selection and geometry.
    use_pallas: bool = False
    use_fused_xla: bool = False
    chunk_size: int = 2048

    # Number of covariates whose one-hot blocks Phi concatenates: 1 when
    # every real cell is in exactly one batch level, else 2 (Harmony and
    # io/loader.load_sharded_data set it from the design; a configuration
    # made by hand for another design has to). With 1, `fast_objective`
    # may use the log-free entropy partials and the ridge takes its
    # one-hot forms (ops/replay.py); other values keep the dense forms,
    # which hold for any Phi.
    n_covariates: int = 1
    fast_objective: bool = False

    # Deferred-R mode: R is never materialized; the final k-means round is
    # replayed by the ridge correction and the .R property.
    defer_r: bool = False

    @property
    def fused_estep(self) -> bool:
        return self.use_pallas or self.use_fused_xla

    @property
    def r_torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.r_dtype == "bfloat16" else torch.float32

    # ---- derived geometry ------------------------------------------------
    @property
    def N_pad(self) -> int:
        """Cells padded so every device holds the same count; the fused
        E-step additionally pads each shard to a chunk multiple + 1 dummy
        chunk."""
        if self.fused_estep:
            per_dev = round_up(cdiv(self.N, self.n_devices),
                               self.chunk_size) + self.chunk_size
            return per_dev * self.n_devices
        return round_up(self.N, self.n_devices)

    @property
    def N_local(self) -> int:
        return self.N_pad // self.n_devices

    @property
    def N_shard_real(self) -> int:
        """Per-shard real-cell capacity (each shard's final chunk is the
        all-zero dummy on the fused paths)."""
        if self.fused_estep:
            return self.N_local - self.chunk_size
        return self.N_local

    @property
    def B1(self) -> int:
        """Rows of Phi_moe (intercept + batch levels)."""
        return self.B + 1

    @property
    def n_blocks(self) -> int:
        return int(math.ceil(1.0 / self.block_size))

    @property
    def cell_block_width(self) -> int:
        """Static width of the per-cell E-step's per-block work arrays: the
        cells intersect at most cdiv(N_local, G) + 1 capacity tiles, each
        holding at most `cap` cells of one block."""
        G, cap = cell_tile_geom(self.n_blocks)
        return min(self.N_local, (cdiv(self.N_local, G) + 1) * cap)

    @property
    def kmeans_hist_len(self) -> int:
        return max(1 + self.max_iter_harmony * self.max_iter_kmeans,
                   self.window_size + 2)

    @property
    def harmony_hist_len(self) -> int:
        return 1 + self.max_iter_harmony

    @property
    def rounds_hist_len(self) -> int:
        return max(1, self.max_iter_harmony)

    @property
    def kmeanspp_trials(self) -> int:
        """Greedy k-means++ candidate count (sklearn: 2 + floor(log(K)))."""
        return 2 + int(math.log(self.K)) if self.K > 1 else 1

    def validate(self) -> None:
        """The deferred-R fused path, the stored-R fused path (use_fused_xla
        or use_pallas, both on the hand-written kernels) and the per-cell
        path (neither), on one device or a mesh of n_devices shards."""
        if not (self.N >= 1 and self.d >= 1 and self.K >= 1 and self.B >= 1):
            raise ValueError(f"empty problem: {self}")
        if not 0.0 < self.block_size <= 1.0:
            raise ValueError(f"block_size must be in (0, 1]: {self}")
        if self.n_devices < 1:
            raise ValueError(f"n_devices must be >= 1: {self}")
        if self.use_pallas and self.use_fused_xla:
            raise ValueError(f"use_pallas and use_fused_xla both set: {self}")
        if self.defer_r and not self.fused_estep:
            raise ValueError(f"defer_r requires a fused E-step: {self}")
        if self.r_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"r_dtype must be 'float32' or 'bfloat16': "
                             f"{self}")
        if self.fused_estep and not fused_geometry_ok(
                self.N, 1, self.block_size, self.chunk_size):
            raise ValueError(f"too few chunks for the fused geometry: {self}")


# Below this N the JAX package keeps the per-cell E-step (auto_chunk_size
# returns 2048, which selects it).
_PER_CELL_MAX_N = 20_480


def auto_chunk_size(N: int, block_size: float = 0.05,
                    requested: int | None = None) -> int:
    """Default chunk size: a function of (N, block_size) only. 2048 whenever
    the fused geometry allows it or N is below _PER_CELL_MAX_N; otherwise
    the largest power of two (>= 128) that still gives one real chunk per
    block."""
    if requested is not None:
        return int(requested)
    if fused_geometry_ok(N, 1, block_size, 2048) or N < _PER_CELL_MAX_N:
        return 2048
    nb = int(math.ceil(1.0 / block_size))
    c = min(2048, 1 << int(math.floor(math.log2(max(N // nb, 1)))))
    if c < 128 or not fused_geometry_ok(N, 1, block_size, c):
        return 2048
    return c


def fused_geometry_ok(N: int, n_devices: int = 1, block_size: float = 0.05,
                      chunk_size: int = 2048) -> bool:
    """Whether there is at least one real chunk per update block, globally
    (independent of the device count by design)."""
    del n_devices
    n_blocks = int(math.ceil(1.0 / block_size))
    return cdiv(N, chunk_size) >= n_blocks


def pallas_supported(N: int, n_devices: int, block_size: float = 0.05,
                     chunk_size: int = 2048) -> bool:
    """Whether the JAX package's Pallas E-step applies (one device and the
    fused chunk geometry: its in-kernel block re-add cannot cross devices).
    The port runs every fused fit on its hand-written kernel: the one-launch
    round on one device, the per-block entry on a mesh."""
    if n_devices != 1:
        return False
    return fused_geometry_ok(N, n_devices, block_size, chunk_size)
