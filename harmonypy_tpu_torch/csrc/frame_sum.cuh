// The rank-ordered frame sum of a mesh block's re-add (sm_90a), shared by
// the re-add kernel (frame_readd.cuh) and the per-block entry's prologue
// (fused_estep.cuh, FOLD), so both form O, E of a block start with the
// same operations in the same order.
//
// The JAX package re-adds a block across its mesh with `_block_readd`
// (harmonypy_tpu/ops/update_r_fused_xla.py:104-114): the block's per-chunk
// stats of every shard placed in the (J_fix, K, B+1) frame of within-block
// ranks, the frame summed row by row in ascending rank from zero, then
// O = O' + sum[:, 1:], E = E' + sum[:, 0] Pr_b. The plain version is
// harmonypy_tpu_torch/ops/update_r_fused.frame_readd.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

// RQ consecutive ranks' loads of NC columns (offsets off[c] within a
// (K, B+1) row), and their adds in rank order: the loads of a batch go out
// at once, and a caller may issue them early and add them later. src[r]
// codes the row that holds rank r (shard * Jmax + slot; -1: no chunk, a
// zero row, which adds +0.0) and row(code) points at that row; ranks from
// J_fix on load nothing and add nothing.
template <int RQ, int NC>
struct FrameBatch {
  float v[RQ][NC];

  template <typename RowOf>
  __device__ __forceinline__ void load(RowOf row, const int* src, int r0,
                                       int J_fix, const int (&off)[NC]) {
#pragma unroll
    for (int q = 0; q < RQ; ++q) {
      const int code = r0 + q < J_fix ? src[r0 + q] : -1;
#pragma unroll
      for (int c = 0; c < NC; ++c) v[q][c] = 0.0f;
      if (code >= 0) {
        const float* p = row(code);
#pragma unroll
        for (int c = 0; c < NC; ++c) v[q][c] = p[off[c]];
      }
    }
  }

  // acc += ranks r0, r0 + 1, ... in order, each sum rounded on its own
  // (__fadd_rn: no contraction).
  __device__ __forceinline__ void add(int r0, int J_fix,
                                      float (&acc)[NC]) const {
#pragma unroll
    for (int q = 0; q < RQ; ++q) {
      if (r0 + q < J_fix) {
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[c] = __fadd_rn(acc[c], v[q][c]);
      }
    }
  }
};

// acc += ranks r_begin, ..., J_fix - 1 of NC columns, in rank order, RQ
// ranks' loads in flight at a time: from acc = 0 and r_begin = 0, the
// block's frame sums.
template <int RQ, int NC, typename RowOf>
__device__ __forceinline__ void frame_sum(RowOf row, const int* src,
                                          int r_begin, int J_fix,
                                          const int (&off)[NC],
                                          float (&acc)[NC]) {
  for (int r0 = r_begin; r0 < J_fix; r0 += RQ) {
    FrameBatch<RQ, NC> batch;
    batch.load(row, src, r0, J_fix, off);
    batch.add(r0, J_fix, acc);
  }
}
