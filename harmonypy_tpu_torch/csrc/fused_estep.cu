// Fused E-step round for Hopper (sm_90a): one persistent cooperative launch
// per round, both products on tensor cores in 3xTF32.
//
// Replaces the JAX package's Pallas TPU kernels `_kernel_nor` (K1, the
// deferred-R round, harmonypy_tpu/ops/pallas/update_r_fused.py:117-125) and
// `_kernel` (K2, the stored-R round, :109-114), both bodies of
// `_kernel_impl` (:128-221). One round visits the nb update blocks in order.
// For block b:
//   O', E' = O, E minus the block's cached stats; wdiv = (E'/(O'+E'))^theta
//   per chunk of the block and per cell: dist = 2(1 - Y^T z),
//     r = softmax_k(-dist/sigma) * (wdiv Phi), column-normalised;
//     S = r [mask; Phi; Z]^T -> cache (K, B+1), ybuf (K, d);
//     kbuf = [sum r dist, sum sigma r log r] (or the log-free form)
//   O, E = O', E' + the block's new stats, summed in ascending slot order.
//
// Bound on an H100 SXM at 858k cells, d=29, K=100, B=3, CH=2048 (20 blocks
// of 22 slots): one round reads the 33-row slab once (~119 MB with the
// per-chunk outputs, 0.036 ms at 3.35 TB/s) and does ~11.2 GFLOP (dist 5.0,
// S 5.7, wdiv Phi 0.5): 0.17 ms at the 67 TFLOP/s fp32 CUDA-core rate, or
// ~0.072 ms with both products as 3xTF32 at 495 TFLOP/s. Bound by
// operations. K2 adds the store of R, 4*K*N_pad bytes in fp32 (~0.34 GB,
// 0.10 ms) or half that in bf16.
//
// Design, and what each choice is for:
//  * One launch per round. `estep_round` is a cooperative kernel whose grid
//    is every CTA that fits on the card at once (occupancy x SMs, at most
//    one per unit). It walks the blocks in order, with a grid barrier after
//    each block's tile phase and after its reduce phase: no launch gaps
//    between blocks.
//  * Static work split. A slot's chunk is cut into 64-cell tiles; unit
//    u = (slot u / ng, run u % ng), run i covering tiles
//    [i T / ng, (i+1) T / ng). `ng` comes from the shape and the SM count
//    only (ops/cuda/fused_estep.py, `kernel_geometry`), so K1, its r window
//    and K2 sum in the same order whatever each instantiation's occupancy.
//    CTA c runs units c, c + grid, ... and writes one partial of S and of
//    (kerr, ent) per unit.
//  * The slab arrives through a two-stage ring: the next tile's
//    (1+B+d, 64) slab is copied with 16-byte cp.async (zero-filled past CH)
//    while the CTA computes on the current one; a CTA's first tile of the
//    next block is fetched before the barriers.
//  * Tensor cores, fp32-faithful. dist = Y^T z (K x cells over d), the
//    diversity weights w = wdiv Phi (K x cells over the B+1 design rows)
//    and S = r slab^T (K x (1+B+d) over cells) run as mma.m16n8k8 TF32
//    with the 3xTF32 split (x = hi + lo, TF32-rounded; hi*hi and
//    lo*hi + hi*lo in two accumulators, fp32): error near fp32 rounding,
//    where one TF32 pass would put ~1e-3 into dist and 1/sigma = 10x that
//    into r. Y^T and wdiv are stored in A-fragment order, split once per
//    round (per block) where shared memory allows, else split at each load
//    (the compact layout that keeps the shapes the CUDA-core version took).
//  * Each warp owns 8 whole cell columns of a tile (all K rows), so the
//    per-cell sums of the softmax (den, den_r, sum r dist, sum sigma r) run
//    in the thread over its m-tiles, then as a 3-step __shfl_xor tree over
//    the 8 lanes of a column: no __syncthreads and a fixed order.
//  * Elementwise: s = expf(-dist * (1/sigma_k)) and the unnormalised
//    q = s * w are formed in the registers of the accumulators; one
//    reciprocal pair per column then gives r = q * (1/den) * (1/den_r) (the
//    plain version divides three times per element: these differ from it by
//    rounding only, inside the kernel-vs-plain tolerances). r goes through
//    a (K, 64) shared stage into the A operand of the S product; S
//    accumulates in a shared (K, 1+B+d) tile per unit, each 16-row band of
//    it owned by one warp.
//  * Loop bounds inside the unrolled mma loops are compile-time (template
//    parameters, zero padding): a runtime guard there becomes a branch, and
//    the loads, splits and mma of one fragment stop overlapping the next.
//  * The reduce phase: the design columns of each cache row and bsum (the
//    block's stats over its slots, ascending slot order) between the two
//    barriers; kbuf on other CTAs in parallel. The ybuf rows are summed
//    during the next block's tile phase from a second partial buffer. The
//    next block's prologue adds bsum into O/E in every CTA, which keeps its
//    own identical copy of O/E in shared memory.
//  * K2's store is packed: two adjacent cells of one cluster per float2,
//    or per __nv_bfloat162 rounded to nearest even (__floats2bfloat162_rn,
//    as torch's .to(bfloat16) rounds).
// The per-block entries (fused_estep_block, _block_r_window,
// _block_write_r) launch the same kernel on one block of the tables, from
// the O, E they are given, and return the block-removed O, E: a mesh runs
// one launch per shard per block and re-adds each block across the shards
// in the host (ops/update_r_fused.mesh_round), in the order the one-launch
// round's bsum takes. `ng` comes from the one-device slots per block
// (kernel_geometry's J_glob), so a shard's chunks are split into units, and
// summed, as the one-device round splits them.
// No float atomics: every sum has a fixed order, so the same inputs give the
// same bits. `r_window` and `write_r` run the identical arithmetic and only
// add the store, so a replay reproduces its round bitwise (the deferred-R
// contract) and K2's statistics equal K1's. Each block's slot list ends in
// the dummy chunk, whose r is exactly zero, so K2 writes the dummy chunk of
// R with zeros. A slot id outside [0, nc1) traps, which fails the next
// synchronise.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int TILE = 8 * WARPS;   // cells per tile: 8 per warp
constexpr int PT = TILE + 4;      // row pitch of the slab ring and r stage
constexpr int KSC = 4;            // dist k-steps unrolled, B kept in registers
constexpr int NRG_MAX = 8;        // S n-tiles per A fragment, at most
constexpr float CLAMP = 1e-8f;
constexpr size_t MAX_SMEM = 232448;

template <int N>
struct IC {
  static constexpr int value = N;
};

struct Args {
  const float* zp3;      // (nc1, R, CH) [mask; Phi; Z] per chunk
  const float* Y;        // (d, K)
  const float* sigma;    // (K)
  const float* theta;    // (B)
  const float* prb;      // (B)
  const float* removal;  // (nb, K, B+1)
  const int* slots;      // (nb, J)
  const float* O0;       // (K, B) O, E at the start of the round
  const float* E0;
  float* part;           // (2, J*ng, K, R) per-unit partials of S, by
                         // block parity
  float* kpart;          // (J*ng, 2)    per-unit partials of (kerr, ent)
  float* bsum;           // (K, B+1)     a block's stats over its slots
  float* cache;          // (nc1, K, B+1)
  float* ybuf;           // (nc1, K, d)
  float* kbuf;           // (nc1, 2)
  float* O1;             // (K, B) O, E at the end of the round
  float* E1;
  void* rw;              // (width, K, CH) float or bf16 (RT), or null
  int lo, width;
  int K, B, d, CH, nb, J, ng, nc1, fast_ent;
  int readd;             // 1: O1, E1 = O, E at the end of the round;
                         // 0 (one block alone): the block-removed O, E
};

// Padded sizes and the shared-memory plan (offsets in floats). Padding
// rows and columns hold zeros, so every fragment loop runs its full
// compile-time length without guards.
struct Lay {
  int B1, R, Kp, KS, KSR, KB, NR, NRG, NRp, RR, PSA, MT;
  bool PRE;  // Y and wdiv stored split (else split at each load)
  int oYh, oYl, oWh, oWl, oSig, oRsig, oOr, oEr, oQ, oRing, oSacc, oCs, oRed,
      total;
};

__host__ __device__ inline int up4(int x) { return (x + 3) & ~3; }
__host__ __device__ inline int up8(int x) { return (x + 7) & ~7; }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

__host__ __device__ inline Lay layout(int K, int B, int d) {
  Lay L;
  L.B1 = B + 1;
  L.R = 1 + B + d;
  L.Kp = (K + 15) & ~15;           // rows of dist, the r stage and S
  L.MT = L.Kp / 16;
  L.KS = up8(d) / 8;               // dist k-steps over d
  L.KSR = L.KS > KSC ? L.KS : KSC;  // ... at least the KSC unrolled ones
  L.KB = cdiv(L.B1, 8);            // w k-steps over the design rows
  L.NR = up8(L.R) / 8;             // S n-tiles over [mask; Phi; Z]
  L.NRG = L.NR < NRG_MAX ? L.NR : NRG_MAX;
  L.NRp = cdiv(L.NR, L.NRG) * L.NRG;
  const int dist_rows = L.B1 + 8 * L.KSR, s_rows = 8 * L.NRp;
  L.RR = up8(dist_rows > s_rows ? dist_rows : s_rows);  // ring rows
  // Pitch = 8 or 24 mod 32 words: conflict-free float2 accumulator access.
  L.PSA = 8 * L.NRp + ((L.NRp & 1) ? 0 : 8);
  const int kb = K * B;
  // Y and wdiv are kept split (hi and lo) where that fits, else whole.
  for (int pre = 1; pre >= 0; --pre) {
    L.PRE = pre;
    int o = 0;
    L.oYh = o; o += L.MT * L.KSR * 128;
    L.oYl = o; o += pre * L.MT * L.KSR * 128;
    L.oWh = o; o += L.MT * L.KB * 128;
    L.oWl = o; o += pre * L.MT * L.KB * 128;
  L.oSig = o; o += up4(L.Kp);
  L.oRsig = o; o += up4(L.Kp);
  L.oOr = o; o += up4(kb);
  L.oEr = o; o += up4(kb);
  L.oQ = o; o += L.Kp * PT;
  L.oRing = o; o += 2 * L.RR * PT;
  L.oSacc = o; o += up4(L.Kp * L.PSA);
    L.oCs = o; o += TILE;
    L.oRed = o; o += THREADS;
    L.total = o;
    if (sizeof(float) * (size_t)o <= MAX_SMEM) break;
  }
  return L;
}

// x = hi + lo for 3xTF32. hi is x rounded to the 10 explicit mantissa bits
// TF32 keeps, to nearest with ties away from zero (what cvt.rna.tf32.f32
// gives for finite x, in two integer ops instead of its guarded sequence);
// the mma reads only those bits of lo, so lo gets the same rounding add.
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
  lo = __uint_as_float(__float_as_uint(__fsub_rn(x, hi)) + 0x1000u);
}

__device__ __forceinline__ void mma(float (&d)[4], const float (&a)[4],
                                    const float (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
        "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
        "r"(__float_as_uint(b[0])), "r"(__float_as_uint(b[1])));
}

// 3xTF32 into two accumulators, hi*hi and the cross terms lo*hi + hi*lo,
// so the three products are not one chain of dependent mma.
__device__ __forceinline__ void mma3(float (&hh)[4], float (&x)[4],
                                     const float (&ah)[4], const float (&al)[4],
                                     const float (&bh)[2],
                                     const float (&bl)[2]) {
  mma(x, al, bh);
  mma(hh, ah, bh);
  mma(x, ah, bl);
}

// The 3xTF32 result of an accumulator pair.
__device__ __forceinline__ float fin(float hh, float x) {
  return __fadd_rn(hh, x);
}

// B fragment (8 slab rows x 8 cells): p points at row `row0` of a ring
// stage, column = the warp's first cell.
__device__ __forceinline__ void load_b_slab(const float* p, int t, int g,
                                            float (&bh)[2], float (&bl)[2]) {
  split(p[t * PT + g], bh[0], bl[0]);
  split(p[(t + 4) * PT + g], bh[1], bl[1]);
}

// A fragment f (16 clusters x 8 rows) of an operand stored in fragment
// order: 4 consecutive floats per lane, one 16-byte load for hi and one for
// lo (PRE), or one load split here.
template <bool PRE>
__device__ __forceinline__ void load_a_frag(const float* H, const float* Lo,
                                            int f, int lane, float (&ah)[4],
                                            float (&al)[4]) {
  const float4 h = reinterpret_cast<const float4*>(H)[f * 32 + lane];
  if (PRE) {
    const float4 l = reinterpret_cast<const float4*>(Lo)[f * 32 + lane];
    ah[0] = h.x; ah[1] = h.y; ah[2] = h.z; ah[3] = h.w;
    al[0] = l.x; al[1] = l.y; al[2] = l.z; al[3] = l.w;
  } else {
    split(h.x, ah[0], al[0]);
    split(h.y, ah[1], al[1]);
    split(h.z, ah[2], al[2]);
    split(h.w, ah[3], al[3]);
  }
}

// Store entry o of a fragment-ordered operand: split (PRE) or whole.
__device__ __forceinline__ void put_frag(const Lay& L, float* H, float* Lo,
                                         int o, float v) {
  if (L.PRE)
    split(v, H[o], Lo[o]);
  else
    H[o] = v;
}

// Offset in fragment order of entry (row, col) of a 16 x 8 A tile.
__device__ __forceinline__ int frag_pos(int row, int col) {
  const int lane = (row & 7) * 4 + (col & 3);
  return lane * 4 + (row >> 3) + 2 * (col >> 2);
}

// Sum over the 8 lanes that share a column (lane bits 2-4): every lane
// gets the same bits.
__device__ __forceinline__ float col_sum(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 4));
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 8));
  return __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 16));
}

// Fixed-order sum over the CTA: tree over THREADS values in shared memory.
__device__ float block_sum(float v, float* red) {
  const int tid = threadIdx.x;
  __syncthreads();
  red[tid] = v;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] = __fadd_rn(red[tid], red[tid + s]);
    __syncthreads();
  }
  return red[0];
}

// log clip(E/max(O+E, 1e-8), 1e-8, 1).
__device__ __forceinline__ float log_ratio(float O, float E) {
  const float oe = fmaxf(__fadd_rn(O, E), CLAMP);
  return logf(fminf(fmaxf(__fdiv_rn(E, oe), CLAMP), 1.0f));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy the (R, 64) slab tile of `slot` at cells c0.. into a ring stage;
// cells past CH are zero-filled (CH is a multiple of 4).
__device__ __forceinline__ void issue_tile(const Args& a, const Lay& L,
                                           float* stage, int slot, int c0) {
  const float* src = a.zp3 + (size_t)slot * L.R * a.CH;
  for (int i = threadIdx.x; i < L.R * (TILE / 4); i += THREADS) {
    const int x = i / (TILE / 4), q = i % (TILE / 4);
    const int c = c0 + 4 * q;
    const bool in = c < a.CH;
    cp16(stage + x * PT + 4 * q, src + (size_t)x * a.CH + (in ? c : 0),
         in ? 16 : 0);
  }
}

// Data written by other CTAs in this launch (partials, block sums) is read
// with __ldcg, from L2, after the grid barrier.

// Sum of slot j's unit partials at offset i of a (K, R) partial, in
// ascending unit order: the value the reduce phase writes to cache/ybuf.
// The loads go out in batches of 16, then are added in order.
__device__ __forceinline__ float slot_sum(const Args& a, size_t KR, int blk,
                                          int j, size_t i) {
  const float* P =
      a.part + ((size_t)(blk & 1) * a.J * a.ng + (size_t)j * a.ng) * KR + i;
  float s = 0.0f;
  for (int q0 = 0; q0 < a.ng; q0 += 16) {
    float v[16];
#pragma unroll
    for (int q = 0; q < 16; ++q)
      v[q] = q0 + q < a.ng ? __ldcg(P + (q0 + q) * KR) : 0.0f;
#pragma unroll
    for (int q = 0; q < 16; ++q)
      if (q0 + q < a.ng) s = __fadd_rn(s, v[q]);
  }
  return s;
}

// Ordered sum over n values held one per lane (lanes >= n hold anything):
// lane 0's result is v_0 + v_1 + ... in ascending order.
__device__ __forceinline__ float lane_sum(float acc, float v, int n) {
  for (int l = 0; l < n; ++l)
    acc = __fadd_rn(acc, __shfl_sync(0xffffffffu, v, l));
  return acc;
}

// This CTA's share of block blk's ybuf rows: the unit partials of S in
// ascending unit order, spread over the grid. It runs while the next block
// computes (block blk + 2 overwrites these partials, after a barrier).
__device__ void ybuf_share(const Args& a, const Lay& L, int blk) {
  const int K = a.K, B1 = L.B1, R = L.R, d = a.d;
  const size_t KR = (size_t)K * R, Kd = (size_t)K * d;
  for (size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x;
       e < (size_t)a.J * Kd; e += (size_t)gridDim.x * THREADS) {
    const int j = (int)(e / Kd), i = (int)(e % Kd);
    const int slot = a.slots[(size_t)blk * a.J + j];
    a.ybuf[(size_t)slot * Kd + i] =
        slot_sum(a, KR, blk, j, (size_t)(i / d) * R + B1 + i % d);
  }
}

// The reduce phase of block blk, after its tile phase:
//  * kbuf of slot j, by CTA grid - 1 - j (mod grid): the kerr and entropy
//    partials in ascending unit order, and under the fast objective the
//    O-term sum_kb sigma_k theta_b logratio_kb O_chunk[k, b] from the
//    block-removed O/E and the slot's stats;
//  * the design columns of each slot's cache row (its unit partials in
//    ascending unit order; the ybuf columns: ybuf_share, next block), and
//    bsum (K, B+1), those summed over the slots in ascending slot order.
//    The next block's prologue adds bsum back into O/E.
__device__ void reduce_block(const Args& a, const Lay& L, int blk,
                             const float* sm) {
  const int K = a.K, B = a.B, B1 = L.B1, R = L.R, J = a.J;
  const int tid = threadIdx.x, lane = tid & 31;
  const size_t KR = (size_t)K * R;
  const int* slots = a.slots + (size_t)blk * J;
  const float* sig = sm + L.oSig;
  const float* Or = sm + L.oOr;
  const float* Er = sm + L.oEr;
  float* red = const_cast<float*>(sm) + L.oRed;
  for (int j = gridDim.x - 1 - blockIdx.x; j < J; j += gridDim.x) {
    // kerr and the entropy partial of slot j: its units in ascending order,
    // one unit per lane; thread 0 holds the sums. (From the last CTA down,
    // apart from the CTAs that take the block sums.)
    float kerr = 0.0f, second = 0.0f;
    if (tid < 32) {
      for (int q0 = 0; q0 < a.ng; q0 += 32) {
        const int q = q0 + lane;
        const float* kp = a.kpart + ((size_t)j * a.ng + q) * 2;
        const float v0 = q < a.ng ? __ldcg(kp) : 0.0f;
        const float v1 = q < a.ng ? __ldcg(kp + 1) : 0.0f;
        kerr = lane_sum(kerr, v0, min(32, a.ng - q0));
        second = lane_sum(second, v1, min(32, a.ng - q0));
      }
    }
    float ent = second;
    if (a.fast_ent) {
      float v = 0.0f;
      for (int i = tid; i < K * B; i += THREADS) {
        const int k = i / B, b = i % B;
        const float coef = __fmul_rn(__fmul_rn(sig[k], a.theta[b]),
                                     log_ratio(Or[i], Er[i]));
        v = fmaf(coef, slot_sum(a, KR, blk, j, (size_t)k * R + 1 + b), v);
      }
      const float stv = block_sum(v, red);
      ent = __fsub_rn(__fadd_rn(-kerr, stv), second);
    }
    if (tid == 0) {
      a.kbuf[(size_t)slots[j] * 2] = kerr;
      a.kbuf[(size_t)slots[j] * 2 + 1] = ent;
    }
  }
  // The design columns of the cache rows and bsum: this CTA's entries, in
  // rounds that fit the idle r stage: the slot sums of each (entry, slot)
  // in parallel (each a cache value), then one thread per entry adds its
  // slots in ascending order.
  const int nkb = K * B1;
  const int per = (nkb + gridDim.x - 1) / gridDim.x;
  const int ib = blockIdx.x * per, ie = min(nkb, ib + per);
  float* ss = const_cast<float*>(sm) + L.oQ;
  const int cap = min(per, (L.Kp * PT) / J);
  if (cap > 0) {
    for (int r0 = ib; r0 < ie; r0 += cap) {
      const int n = min(cap, ie - r0);
      __syncthreads();
      for (int x = tid; x < n * J; x += THREADS) {
        const int item = r0 + x / J, j = x % J;
        ss[x] = slot_sum(a, KR, blk, j, (size_t)(item / B1) * R + item % B1);
        a.cache[(size_t)slots[j] * nkb + item] = ss[x];
      }
      __syncthreads();
      for (int it = tid; it < n; it += THREADS) {
        float acc = 0.0f;
        for (int j = 0; j < J; ++j) acc = __fadd_rn(acc, ss[it * J + j]);
        a.bsum[r0 + it] = acc;
      }
    }
  } else {
    for (int item = ib + tid; item < ie; item += THREADS) {
      float acc = 0.0f;
      for (int j = 0; j < J; ++j) {
        const float v =
            slot_sum(a, KR, blk, j, (size_t)(item / B1) * R + item % B1);
        a.cache[(size_t)slots[j] * nkb + item] = v;
        acc = __fadd_rn(acc, v);
      }
      a.bsum[item] = acc;
    }
  }
}

// Prefetch the first tile of this CTA's first unit of block blk into ring
// stage 0 (the slab is read-only, so this runs ahead of the prologue).
__device__ __forceinline__ void prefetch_first(const Args& a, const Lay& L,
                                               int blk, int T, float* ring) {
  if ((int)blockIdx.x >= a.J * a.ng) return;
  const int j = blockIdx.x / a.ng, run = blockIdx.x % a.ng;
  const int slot = a.slots[(size_t)blk * a.J + j];
  if (slot < 0 || slot >= a.nc1) __trap();
  issue_tile(a, L, ring, slot, run * T / a.ng * TILE);
  cp_commit();
}

// Pass 2 of a tile, over the CTA: r = q * scale in the stage, with LOG the
// entropy sum sigma r log r, with STORE the packed store of r (two adjacent
// cells per thread and row: a float2, or a bf16 pair rounded to nearest
// even). Returns the thread's entropy sum.
template <bool LOG, bool STORE, typename RT>
__device__ __forceinline__ float pass2(float* Q, const float* cs,
                                       const float* sig, int K, RT* rwp,
                                       int CH, int c0, float ent) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int cp = 2 * lane;
  const float s0 = cs[cp], s1 = cs[cp + 1];
  const bool col_ok = c0 + cp < CH;
#pragma unroll 4
  for (int k = w; k < K; k += WARPS) {
    float2* qp = reinterpret_cast<float2*>(Q + k * PT + cp);
    float2 v = *qp;
    v.x = __fmul_rn(v.x, s0);
    v.y = __fmul_rn(v.y, s1);
    *qp = v;
    if (LOG) {
      const float sk = sig[k];
      const float ex = fmaf(__fmul_rn(v.x, logf(v.x)), sk, ent);
      ent = v.x > 0.0f ? ex : ent;
      const float ey = fmaf(__fmul_rn(v.y, logf(v.y)), sk, ent);
      ent = v.y > 0.0f ? ey : ent;
    }
    if (STORE && col_ok) store2(rwp + (size_t)k * CH + c0 + cp, v.x, v.y);
  }
  return ent;
}

template <typename RT, int NRG, bool PRE>
__global__ void __launch_bounds__(THREADS, 2) estep_round(Args a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  const Lay L = layout(a.K, a.B, a.d);
  const int K = a.K, B = a.B, B1 = L.B1, R = L.R, J = a.J, CH = a.CH;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3, cw = 8 * w;
  float* Yh = sm + L.oYh;  // Y^T and wdiv, split, in A-fragment order
  float* Yl = sm + L.oYl;
  float* Wh = sm + L.oWh;
  float* Wl = sm + L.oWl;
  float* sig = sm + L.oSig;
  float* rsig = sm + L.oRsig;
  float* Or = sm + L.oOr;
  float* Er = sm + L.oEr;
  float* Q = sm + L.oQ;
  float* ring = sm + L.oRing;
  float* Sacc = sm + L.oSacc;
  float* cs = sm + L.oCs;
  float* red = sm + L.oRed;
  const int T = (CH + TILE - 1) / TILE;  // tiles per slot
  const int U = J * a.ng;                // units per block
  const size_t KR = (size_t)K * R;

  // Zero padding everywhere (ring rows >= R, W rows, pad rows and columns),
  // then the round's constants: Y^T split once, sigma and 1/sigma.
  for (int i = tid; i < L.total; i += THREADS) sm[i] = 0.0f;
  __syncthreads();
  prefetch_first(a, L, 0, T, ring);
  for (int i = tid; i < L.Kp * 8 * L.KSR; i += THREADS) {
    const int k = i / (8 * L.KSR), x = i % (8 * L.KSR);
    const float v = (x < a.d && k < K) ? a.Y[x * K + k] : 0.0f;
    const int o = ((k >> 4) * L.KSR + (x >> 3)) * 128 + frag_pos(k & 15, x & 7);
    put_frag(L, Yh, Yl, o, v);
  }
  for (int k = tid; k < K; k += THREADS) {
    sig[k] = a.sigma[k];
    rsig[k] = __frcp_rn(a.sigma[k]);
  }

  for (int blk = 0; blk < a.nb; ++blk) {
    // Prologue: O, E = the previous block's O', E' plus its block sums (the
    // round's input for block 0); remove this block's cached stats; the
    // diversity weights, split, as the A operand of w = wdiv Phi.
    for (int i = tid; i < K * B; i += THREADS) {
      const int k = i / B, b = i % B;
      float O, E;
      if (blk == 0) {
        O = a.O0[i];
        E = a.E0[i];
      } else {
        const float* bs = a.bsum + (size_t)k * B1;
        E = __fadd_rn(Er[i], __fmul_rn(__ldcg(bs), a.prb[b]));
        O = __fadd_rn(Or[i], __ldcg(bs + 1 + b));
      }
      const float* rem = a.removal + ((size_t)blk * K + k) * B1;
      E = __fsub_rn(E, __fmul_rn(rem[0], a.prb[b]));
      O = __fsub_rn(O, rem[1 + b]);
      Er[i] = E;
      Or[i] = O;
      const float wd = expf(__fmul_rn(a.theta[b], log_ratio(O, E)));
      const int o = ((k >> 4) * L.KB + ((1 + b) >> 3)) * 128 +
                    frag_pos(k & 15, (1 + b) & 7);
      put_frag(L, Wh, Wl, o, wd);
    }
    __syncthreads();

    // Tile phase.
    for (int u = blockIdx.x; u < U; u += gridDim.x) {
      const int j = u / a.ng, run = u % a.ng;
      const int t0 = run * T / a.ng, t1 = (run + 1) * T / a.ng;
      const int slot = a.slots[(size_t)blk * J + j];
      if (slot < 0 || slot >= a.nc1) __trap();
      RT* rwp = nullptr;
      if (a.rw != nullptr && slot >= a.lo && slot < a.lo + a.width)
        rwp = static_cast<RT*>(a.rw) + (size_t)(slot - a.lo) * K * CH;
      for (int i = tid; i < L.Kp * L.PSA; i += THREADS) Sacc[i] = 0.0f;
      float kerr_t = 0.0f, ent_t = 0.0f;

      if (u != (int)blockIdx.x) {
        issue_tile(a, L, ring, slot, t0 * TILE);
        cp_commit();
      }
      for (int tt = t0; tt < t1; ++tt) {
        const int c0 = tt * TILE;
        const float* rg = ring + ((tt - t0) & 1) * L.RR * PT;
        if (tt + 1 < t1) {
          issue_tile(a, L, ring + ((tt + 1 - t0) & 1) * L.RR * PT, slot,
                     c0 + TILE);
          cp_commit();
          cp_wait<1>();
        } else {
          cp_wait<0>();
        }
        __syncthreads();

        // Pass 1, per warp: dist = Y^T z and w = wdiv Phi on the tensor
        // cores for the warp's 8 cells (one n-tile) and all K rows, two
        // m-tiles at a time; s and q = s w in registers; per-cell sums over
        // the 8 lanes that share a column.
        auto pass1 = [&](auto fast_c) {
          constexpr bool FAST = decltype(fast_c)::value;
          float bh[KSC][2], bl[KSC][2], wbh[2], wbl[2];
#pragma unroll
          for (int ks = 0; ks < KSC; ++ks)
            load_b_slab(rg + (B1 + ks * 8) * PT + cw, t, g, bh[ks], bl[ks]);
          load_b_slab(rg + cw, t, g, wbh, wbl);
          float den[2] = {0.0f, 0.0f}, qs[2] = {0.0f, 0.0f};
          float qd[2] = {0.0f, 0.0f}, qg[2] = {0.0f, 0.0f};
          auto mtiles = [&](auto np_c, int mt0) {
            constexpr int NP = decltype(np_c)::value;
            float acc[NP][4] = {}, acx[NP][4] = {};
            float wac[NP][4] = {}, wax[NP][4] = {};
            float ah[4], al[4];
#pragma unroll
            for (int ks = 0; ks < KSC; ++ks) {
#pragma unroll
              for (int p = 0; p < NP; ++p) {
                load_a_frag<PRE>(Yh, Yl, (mt0 + p) * L.KSR + ks, lane, ah, al);
                mma3(acc[p], acx[p], ah, al, bh[ks], bl[ks]);
              }
            }
            for (int ks = KSC; ks < L.KSR; ++ks) {
              float xh[2], xl[2];
              load_b_slab(rg + (B1 + ks * 8) * PT + cw, t, g, xh, xl);
#pragma unroll
              for (int p = 0; p < NP; ++p) {
                load_a_frag<PRE>(Yh, Yl, (mt0 + p) * L.KSR + ks, lane, ah, al);
                mma3(acc[p], acx[p], ah, al, xh, xl);
              }
            }
#pragma unroll
            for (int p = 0; p < NP; ++p) {
              load_a_frag<PRE>(Wh, Wl, (mt0 + p) * L.KB, lane, ah, al);
              mma3(wac[p], wax[p], ah, al, wbh, wbl);
            }
            for (int ks = 1; ks < L.KB; ++ks) {
              float xh[2], xl[2];
              load_b_slab(rg + ks * 8 * PT + cw, t, g, xh, xl);
#pragma unroll
              for (int p = 0; p < NP; ++p) {
                load_a_frag<PRE>(Wh, Wl, (mt0 + p) * L.KB + ks, lane, ah, al);
                mma3(wac[p], wax[p], ah, al, xh, xl);
              }
            }
            // Accumulator e of m-tile mt: cluster mt*16 + g + 8 (e >> 1),
            // cell 2t + (e & 1) of the warp's 8. Rows >= K get s = 0.
#pragma unroll
            for (int p = 0; p < NP; ++p) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int k = (mt0 + p) * 16 + g + 8 * (e >> 1), h = e & 1;
                const float dist = __fmul_rn(
                    2.0f, __fsub_rn(1.0f, fin(acc[p][e], acx[p][e])));
                const float ex = expf(__fmul_rn(-dist, rsig[k]));
                const float s = k < K ? ex : 0.0f;
                const float q = __fmul_rn(s, fin(wac[p][e], wax[p][e]));
                den[h] = __fadd_rn(den[h], s);
                qs[h] = __fadd_rn(qs[h], q);
                qd[h] = fmaf(q, dist, qd[h]);
                if (FAST) qg[h] = fmaf(q, sig[k], qg[h]);
                Q[k * PT + cw + 2 * t + h] = q;
              }
            }
          };
          int mt0 = 0;
          for (; mt0 + 2 <= L.MT; mt0 += 2) mtiles(IC<2>{}, mt0);
          if (mt0 < L.MT) mtiles(IC<1>{}, mt0);
          // r = q / den / den_r = q * scale, one reciprocal pair per cell.
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float dn = col_sum(den[h]);
            const float rden = __frcp_rn(dn);
            const float denr = fmaxf(__fmul_rn(col_sum(qs[h]), rden), CLAMP);
            const float scale = __fmul_rn(rden, __frcp_rn(denr));
            const float kd = col_sum(qd[h]);
            const float kg = FAST ? col_sum(qg[h]) : 0.0f;
            if (g == 0) {
              cs[cw + 2 * t + h] = scale;
              kerr_t = __fadd_rn(kerr_t, __fmul_rn(kd, scale));
              // sum_c (sigma^T r)_c (log den_c + log den_r_c); the per-
              // cluster O-term is added from the chunk's stats in the
              // reduce phase.
              if (FAST)
                ent_t = fmaf(__fmul_rn(kg, scale),
                             __fadd_rn(logf(dn), logf(denr)), ent_t);
            }
          }
        };
        if (a.fast_ent)
          pass1(IC<1>{});
        else
          pass1(IC<0>{});
        __syncthreads();

        if (rwp != nullptr)
          ent_t = a.fast_ent
                      ? pass2<false, true>(Q, cs, sig, K, rwp, CH, c0, ent_t)
                      : pass2<true, true>(Q, cs, sig, K, rwp, CH, c0, ent_t);
        else
          ent_t = a.fast_ent
                      ? pass2<false, false>(Q, cs, sig, K, rwp, CH, c0, ent_t)
                      : pass2<true, false>(Q, cs, sig, K, rwp, CH, c0, ent_t);
        __syncthreads();

        // S += r slab^T over the tile's 64 cells: warp w owns m-tiles w,
        // w + WARPS, ... and runs NRG n-tiles per A fragment.
        for (int mt = w; mt < L.MT; mt += WARPS) {
          const float* q0 = Q + (mt * 16 + g) * PT + t;
          float* s0 = Sacc + (mt * 16 + g) * L.PSA + 2 * t;
          for (int n0 = 0; n0 < L.NRp; n0 += NRG) {
            float acc[NRG][4], acx[NRG][4];
#pragma unroll
            for (int n = 0; n < NRG; ++n) {
              const float2 lo2 = *reinterpret_cast<const float2*>(
                  s0 + (n0 + n) * 8);
              const float2 hi2 = *reinterpret_cast<const float2*>(
                  s0 + 8 * L.PSA + (n0 + n) * 8);
              acc[n][0] = lo2.x; acc[n][1] = lo2.y;
              acc[n][2] = hi2.x; acc[n][3] = hi2.y;
              acx[n][0] = acx[n][1] = acx[n][2] = acx[n][3] = 0.0f;
            }
#pragma unroll 2
            for (int ks = 0; ks < TILE / 8; ++ks) {
              float ah[4], al[4];
              const int c = ks * 8;
              split(q0[c], ah[0], al[0]);
              split(q0[8 * PT + c], ah[1], al[1]);
              split(q0[c + 4], ah[2], al[2]);
              split(q0[8 * PT + c + 4], ah[3], al[3]);
#pragma unroll
              for (int n = 0; n < NRG; ++n) {
                const float* bp = rg + ((n0 + n) * 8 + g) * PT + c + t;
                float bh[2], bl[2];
                split(bp[0], bh[0], bl[0]);
                split(bp[4], bh[1], bl[1]);
                mma3(acc[n], acx[n], ah, al, bh, bl);
              }
            }
#pragma unroll
            for (int n = 0; n < NRG; ++n) {
              *reinterpret_cast<float2*>(s0 + (n0 + n) * 8) =
                  make_float2(fin(acc[n][0], acx[n][0]),
                              fin(acc[n][1], acx[n][1]));
              *reinterpret_cast<float2*>(s0 + 8 * L.PSA + (n0 + n) * 8) =
                  make_float2(fin(acc[n][2], acx[n][2]),
                              fin(acc[n][3], acx[n][3]));
            }
          }
        }
        __syncthreads();
      }

      float* P = a.part + ((size_t)(blk & 1) * U + u) * KR;
      for (int i = tid; i < (int)KR; i += THREADS)
        P[i] = Sacc[(i / R) * L.PSA + i % R];
      const float ke = block_sum(kerr_t, red);
      const float en = block_sum(ent_t, red);
      if (tid == 0) {
        a.kpart[(size_t)u * 2] = ke;
        a.kpart[(size_t)u * 2 + 1] = en;
      }
    }
    if (blk > 0) ybuf_share(a, L, blk - 1);
    if (blk + 1 < a.nb) prefetch_first(a, L, blk + 1, T, ring);
    grid.sync();
    reduce_block(a, L, blk, sm);
    grid.sync();
  }
  ybuf_share(a, L, a.nb - 1);
  if (blockIdx.x == 0) {
    for (int i = tid; i < K * B; i += THREADS) {
      const int k = i / B, b = i % B;
      const float* bs = a.bsum + (size_t)k * B1;
      a.E1[i] = a.readd ? __fadd_rn(Er[i], __fmul_rn(__ldcg(bs), a.prb[b]))
                        : Er[i];
      a.O1[i] = a.readd ? __fadd_rn(Or[i], __ldcg(bs + 1 + b)) : Or[i];
    }
  }
}

size_t smem_bytes(int K, int B, int d) {
  return sizeof(float) * (size_t)layout(K, B, d).total;
}

// CTAs of estep_round<RT, NRG, PRE> that fit on the current device at
// once, or a negative CUDA error.
template <typename RT, int NRG, bool PRE>
int grid_size(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      estep_round<RT, NRG, PRE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int dev = 0, nsm = 0, per = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return -(int)err;
  err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per, estep_round<RT, NRG, PRE>, THREADS, smem);
  if (err != cudaSuccess) return -(int)err;
  if (per < 1) return -(int)cudaErrorInvalidConfiguration;
  return per * nsm;
}

// The S n-tile group and the operand storage are template parameters (no
// guards in the hot loops): f(IC<NRG>, IC<PRE>) for the layout's pair.
template <typename F>
int with_variant(const Lay& L, F f) {
#define ESTEP_NRG(PRE)                      \
  switch (L.NRG) {                          \
    case 1: return f(IC<1>{}, IC<PRE>{});   \
    case 2: return f(IC<2>{}, IC<PRE>{});   \
    case 3: return f(IC<3>{}, IC<PRE>{});   \
    case 4: return f(IC<4>{}, IC<PRE>{});   \
    case 5: return f(IC<5>{}, IC<PRE>{});   \
    case 6: return f(IC<6>{}, IC<PRE>{});   \
    case 7: return f(IC<7>{}, IC<PRE>{});   \
    default: return f(IC<8>{}, IC<PRE>{});  \
  }
  if (L.PRE) ESTEP_NRG(1)
  ESTEP_NRG(0)
#undef ESTEP_NRG
}

template <typename RT>
int run(const Args& a, cudaStream_t stream) {
  const Lay L = layout(a.K, a.B, a.d);
  const size_t smem = sizeof(float) * (size_t)L.total;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  return with_variant(L, [&](auto nrg, auto pre) {
    constexpr int NRG = decltype(nrg)::value;
    constexpr bool PRE = decltype(pre)::value;
    int grid = grid_size<RT, NRG, PRE>(smem);
    if (grid < 0) return -grid;
    // No CTA without a unit: each takes part in every block.
    if (grid > a.J * a.ng) grid = a.J * a.ng;
    Args arg = a;
    void* params[] = {&arg};
    return (int)cudaLaunchCooperativeKernel(
        (const void*)estep_round<RT, NRG, PRE>, dim3(grid), dim3(THREADS),
        params, smem, stream);
  });
}

template <typename RT>
int grid_of(int K, int B, int d) {
  const Lay L = layout(K, B, d);
  const size_t smem = sizeof(float) * (size_t)L.total;
  if (smem > MAX_SMEM) return -(int)cudaErrorInvalidValue;
  return with_variant(L, [&](auto nrg, auto pre) {
    return grid_size<RT, decltype(nrg)::value, decltype(pre)::value>(smem);
  });
}

Args make_args(const float* zp3, const float* Y, const float* sigma,
               const float* theta, const float* prb, const float* removal,
               const int* slots, const float* O0, const float* E0,
               float* part, float* kpart, float* bsum, float* cache,
               float* ybuf, float* kbuf, float* O1, float* E1, void* rw,
               int lo, int width, int K, int B, int d, int CH, int nb, int J,
               int ng, int nc1, int fast_ent) {
  Args a;
  a.zp3 = zp3; a.Y = Y; a.sigma = sigma; a.theta = theta; a.prb = prb;
  a.removal = removal; a.slots = slots; a.O0 = O0; a.E0 = E0;
  a.part = part; a.kpart = kpart; a.bsum = bsum; a.cache = cache;
  a.ybuf = ybuf; a.kbuf = kbuf; a.O1 = O1; a.E1 = E1; a.rw = rw;
  a.lo = lo; a.width = width; a.K = K; a.B = B; a.d = d; a.CH = CH;
  a.nb = nb; a.J = J; a.ng = ng; a.nc1 = nc1; a.fast_ent = fast_ent;
  a.readd = 1;
  return a;
}

// Block blk of the round alone: the tables' row blk, a one-block walk from
// the O, E given (the block's start), and O1, E1 = the block-removed O, E.
// The caller re-adds the block's stats (ops/update_r_fused.mesh_round sums
// its slots' cache rows over every shard in the global rank frame, in the
// order the round's bsum takes them).
int block_args(Args& a, int blk) {
  if (blk < 0 || blk >= a.nb) return (int)cudaErrorInvalidValue;
  a.slots += (size_t)blk * a.J;
  a.removal += (size_t)blk * a.K * (a.B + 1);
  a.nb = 1;
  a.readd = 0;
  return 0;
}

}  // namespace

#define ESTEP_PTRS                                                          \
  const float *zp3, const float *Y, const float *sigma, const float *theta, \
      const float *prb, const float *removal, const int *slots,             \
      const float *O0, const float *E0, float *part, float *kpart,          \
      float *bsum, float *cache, float *ybuf, float *kbuf, float *O1,        \
      float *E1
#define ESTEP_DIMS                                                    \
  int K, int B, int d, int CH, int nb, int J, int ng, int nc1,        \
      int fast_ent, void *stream
#define ESTEP_ARGS(rw, lo, width)                                           \
  make_args(zp3, Y, sigma, theta, prb, removal, slots, O0, E0, part, kpart, \
            bsum, cache, ybuf, kbuf, O1, E1, rw, lo, width, K, B, d, CH, nb, \
            J, ng, nc1, fast_ent)

extern "C" {

// Dynamic shared memory one CTA needs for (K, B, d), in bytes.
int fused_estep_smem(int K, int B, int d) { return (int)smem_bytes(K, B, d); }

// Largest shared memory a CTA may take.
int fused_estep_smem_limit() { return (int)MAX_SMEM; }

// Cells per tile (the unit of the static work split).
int fused_estep_tile() { return TILE; }

// The grid of one round's launch (K1's and K2's instantiation: r_bf16
// picks), or a negative CUDA error.
int fused_estep_grid(int K, int B, int d, int r_bf16) {
  return r_bf16 ? grid_of<__nv_bfloat16>(K, B, d) : grid_of<float>(K, B, d);
}

// One round over nb blocks: one cooperative launch on `stream`. Returns 0
// or the CUDA error of the launch.
int fused_estep_round(ESTEP_PTRS, ESTEP_DIMS) {
  return run<float>(ESTEP_ARGS(nullptr, 0, 0), (cudaStream_t)stream);
}

// The same round, also writing r of chunks lo..lo+width-1 into rw
// (width, K, CH).
int fused_estep_r_window(ESTEP_PTRS, float* rw, int lo, int width,
                         ESTEP_DIMS) {
  return run<float>(ESTEP_ARGS(rw, lo, width), (cudaStream_t)stream);
}

// K2: the same round, also writing r of every slotted chunk into the
// chunk-major r3 (nc1, K, CH), as float (r_bf16 == 0) or bf16.
int fused_estep_write_r(ESTEP_PTRS, void* r3, int r_bf16, ESTEP_DIMS) {
  const Args a = ESTEP_ARGS(r3, 0, nc1);
  return r_bf16 ? run<__nv_bfloat16>(a, (cudaStream_t)stream)
                : run<float>(a, (cudaStream_t)stream);
}

// The per-block entries (one launch per shard per block on a mesh): block
// blk of fused_estep_round, of fused_estep_r_window (lo may be negative:
// rw holds the window's chunks lo..lo+width-1 in the shard's chunk ids) and
// of fused_estep_write_r. The same kernel and arithmetic; O1, E1 get the
// block-removed O, E (see block_args).
int fused_estep_block(ESTEP_PTRS, int blk, ESTEP_DIMS) {
  Args a = ESTEP_ARGS(nullptr, 0, 0);
  const int err = block_args(a, blk);
  return err ? err : run<float>(a, (cudaStream_t)stream);
}

int fused_estep_block_r_window(ESTEP_PTRS, float* rw, int lo, int width,
                               int blk, ESTEP_DIMS) {
  Args a = ESTEP_ARGS(rw, lo, width);
  const int err = block_args(a, blk);
  return err ? err : run<float>(a, (cudaStream_t)stream);
}

int fused_estep_block_write_r(ESTEP_PTRS, void* r3, int r_bf16, int blk,
                              ESTEP_DIMS) {
  Args a = ESTEP_ARGS(r3, 0, nc1);
  const int err = block_args(a, blk);
  if (err) return err;
  return r_bf16 ? run<__nv_bfloat16>(a, (cudaStream_t)stream)
                : run<float>(a, (cudaStream_t)stream);
}

}  // extern "C"
