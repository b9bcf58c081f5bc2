// Re-add of one block of a mesh E-step round (sm_90a): the last block of
// a pass.
//
// The JAX package re-adds a block across its mesh with `_block_readd`
// (harmonypy_tpu/ops/update_r_fused_xla.py:104-114), in rank order from
// zero (frame_sum.cuh) — the order the Pallas kernel's in-grid accumulator
// (K1 / K2, ops/pallas/update_r_fused.py:117-125, :215-221) takes, which
// makes 1 and N devices bitwise equal. On a mesh the port folds the re-add
// of block b into the prologue of block b + 1's per-block launch
// (fused_estep.cuh, FOLD): every CTA of every shard forms the block's start
// from the previous block's rows with frame_sum. Only the last block of a
// pass has no next launch: this kernel re-adds it, once per pass, and
// writes the pass's O, E. The plain version is
// harmonypy_tpu_torch/ops/update_r_fused.frame_readd. Its C entries and
// the mesh pass that launches it are in fused_estep_block.cu.
//
// Thread (k, b) reads rank r's stats where the rank table says a shard
// holds it (src = shard * Jmax + slot in that shard's block rows; -1: no
// chunk, a zero row), adds rank 0, 1, ... in order and forms O and E. The
// product and each sum are rounded on their own (__fmul_rn / __fadd_rn: no
// contraction into an FMA), as the plain version's separate torch ops
// round them, so the result is its bits.
// Bound at 858k (K = 100, B = 3, J_fix = 22): ~37 KB read and written,
// 11 ns at 3.35 TB/s; the launch's latency is the real cost, which is why
// the mesh pass launches it once per pass and not once per block.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "frame_sum.cuh"

namespace readd {

constexpr int THREADS = 128;
constexpr int MAX_SHARDS = 64;

// The shards' block rows, passed by value: no table in device memory to
// upload before a pass.
struct Rows {
  const float* p[MAX_SHARDS];
};

__global__ void __launch_bounds__(THREADS)
    frame_readd_kernel(Rows rows, const int* src, int J_fix, int Jmax,
                       const float* Or, const float* Er, const float* prb,
                       float* O, float* E, int K, int B) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= K * B) return;
  const int k = i / B, b = i % B, B1 = B + 1;
  // Column 0 and column 1 + b of cluster k's frame row, 8 ranks in flight.
  const int off[2] = {k * B1, k * B1 + 1 + b};
  float acc[2] = {0.0f, 0.0f};
  frame_sum<8>(
      [&](int code) {
        return rows.p[code / Jmax] + (size_t)(code % Jmax) * K * B1;
      },
      src, 0, J_fix, off, acc);
  O[i] = __fadd_rn(Or[i], acc[1]);
  E[i] = __fadd_rn(Er[i], __fmul_rn(acc[0], prb[b]));
}

// A re-add launch prepared once: rows (S shards' (J_s, K, B+1) block rows
// in slot order, J_s <= Jmax), src (nb, J_fix + 1) int32 (rank r of block
// b held by shard s's slot j: s * Jmax + j, or -1; column J_fix is
// scratch), Or, Er, O, E (K, B), prb (B), the stream and its device.
struct ReaddCall {
  Rows rows;
  const int* src;
  int J_fix, Jmax;
  const float *Or, *Er, *prb;
  float *O, *E;
  int K, B;
  int device;  // the stream's device, current during the launch
  cudaStream_t stream;
};

// Launch the re-add of block blk of c on the current device (c.device).
// Returns 0 or the CUDA error of the launch.
inline int launch(const ReaddCall& c, int blk) {
  const int n = c.K * c.B;
  frame_readd_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, c.stream>>>(
      c.rows, c.src + (size_t)blk * (c.J_fix + 1), c.J_fix, c.Jmax, c.Or,
      c.Er, c.prb, c.O, c.E, c.K, c.B);
  return (int)cudaGetLastError();
}

}  // namespace readd
