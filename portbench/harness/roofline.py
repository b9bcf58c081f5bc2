"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit) and the least work of a k-means round, counted from shapes.

A round of the deferred-R fit updates every real cell once: it reads each
cell's [mask; Phi; Z] (1 + B + d floats) once, writes each chunk's cache,
centroid numerator and two objective partials (K (1 + B + d) + 2 floats,
one row per chunk plus the dummy chunk), and computes dist = Y^T Z (2 d K
per cell), the statistics [mask; Phi; Z] r^T (2 K (1 + B + d)) and the
weights wdiv Phi (2 K B). The least time is the larger of the operations
as one bf16 pass and the bytes at full bandwidth: at 858,000 x 29, K =
100, B = 3, 11.15 GFLOP and 118.8 MB, bound by bytes (35.5 us).
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12


def round_work(N: int, d: int, K: int, B: int, CH: int) -> tuple:
    """(flop, bytes) of one round over N cells in chunks of CH."""
    R = 1 + B + d
    rows = -(-N // CH) + 1
    flop = N * (2 * d * K + 2 * K * R) + N * 2 * K * B
    nbytes = 4 * (N * R + rows * (K * R + 2))
    return flop, nbytes


def round_least_s(N: int, d: int, K: int, B: int, CH: int) -> float:
    flop, nbytes = round_work(N, d, K, B, CH)
    return max(flop / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S)
