// Fused E-step round for Hopper (sm_90a), fp32 on CUDA cores.
//
// Replaces the JAX package's Pallas TPU kernels `_kernel_nor` (K1, the
// deferred-R round) and `_kernel` (K2, the stored-R round), both bodies of
// `_kernel_impl`, harmonypy_tpu/ops/pallas/update_r_fused.py:109-221. One
// round visits the nb update blocks in order. For block b:
//   O', E' = O, E minus the block's cached stats; wdiv = (E'/(O'+E'))^theta
//   per chunk of the block and per cell: dist = 2(1 - Y^T z),
//     r = softmax_k(-dist/sigma) * (wdiv Phi), column-normalised;
//     S = r [mask; Phi; Z]^T -> cache (K, B+1), ybuf (K, d);
//     kbuf = [sum r dist, sum sigma r log r] (or the log-free form)
//   O, E = O', E' + the block's new stats, summed in ascending slot order.
//
// Design. The TPU runs the (block, slot) grid in order on one core and
// carries O/E and the block accumulator in VMEM. Here the host loops over
// the blocks with two launches each:
//   estep_main   grid (nt column groups, J slots). Every CTA recomputes
//                O', E' and wdiv (K x B, tiny), stages Y and its slab tile
//                in shared memory, computes r for 64 cells at a time and
//                writes per-CTA partials of S and of (kerr, ent).
//   estep_reduce grid (J + K). CTA j < J sums its slot's partials over the
//                column groups in ascending order into cache/ybuf/kbuf;
//                CTA J + k sums the same partials for cluster k in the same
//                order, then over slots in ascending order, and writes the
//                block-added O, E for row k into the other half of a
//                ping-pong buffer (the next block reads it).
// No atomics and no reduction in an unspecified order: the same inputs give
// the same bits. Arithmetic is written with explicit fmaf / __f*_rn so the
// compiler contracts nothing differently between launches. `r_window` runs
// the identical code and also stores r for chunks lo..lo+width-1, so a
// replay reproduces its round's r bitwise (the deferred-R contract).
// `write_r` (K2) runs it again with the window over every chunk and the
// store type a template parameter: float, or bf16 rounded to nearest even
// (`__float2bfloat16_rn`, as torch's .to(bfloat16) and JAX's astype round).
// Every statistic still uses the fp32 r. Each block's slot list ends in the
// dummy chunk, whose r is exactly zero, so the kernel itself writes the
// dummy chunk of R with zeros. The store is coalesced along the cells.
//
// Bound on an H100 SXM at 858k cells, d=29, K=100, B=3, CH=2048: one round
// reads the 33-row slab once (~113 MB, ~34 us at 3.35 TB/s) and does
// ~11.2 GFLOP (dist ~5.0, stats ~5.7, wdiv Phi ~0.5), ~0.17 ms at the
// 67 TFLOP/s fp32 rate: bound by operations. K2 adds the write of R,
// 4*K*N_pad bytes in fp32 (~0.34 GB, ~0.10 ms) or half that in bf16, still
// below the operations bound. This first version keeps every product on CUDA
// cores in shared memory; wgmma/TMA tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 64;           // cells per sub-tile
constexpr int PITCH = TILE + 1;    // shared row pitch: conflict-free reads
constexpr int SUB = 4;             // sub-tiles per CTA
constexpr int CPC = TILE * SUB;    // cells per CTA (column group)
constexpr float CLAMP = 1e-8f;
constexpr size_t MAX_SMEM = 232448;

struct Args {
  const float* zp3;      // (nc1, R, CH) [mask; Phi; Z] per chunk
  const float* Y;        // (d, K)
  const float* sigma;    // (K)
  const float* theta;    // (B)
  const float* prb;      // (B)
  const float* removal;  // (nb, K, B+1)
  const int* slots;      // (nb, J)
  float* oe;             // (2, 2, K, B): [ping-pong][O, E]
  float* part;           // (J, nt, K, R) per-CTA partials of S
  float* kpart;          // (J, nt, 2)   per-CTA partials of (kerr, ent)
  float* cache;          // (nc1, K, B+1)
  float* ybuf;           // (nc1, K, d)
  float* kbuf;           // (nc1, 2)
  void* rw;              // (width, K, CH) float or bf16 (RT), or null
  int lo, width;
  int K, B, d, CH, J, nt, fast_ent;
};

__device__ __forceinline__ const float* oe_half(const Args& a, int blk) {
  return a.oe + (size_t)(blk & 1) * 2 * a.K * a.B;
}

// Block-removed O', E' of entry (k, b) and its log ratio
// log clip(E'/max(O'+E', 1e-8), 1e-8, 1).
__device__ __forceinline__ void removed_oe(const Args& a, int blk, int k,
                                           int b, float& O, float& E) {
  const float* in = oe_half(a, blk);
  const float* rem = a.removal + ((size_t)blk * a.K + k) * (a.B + 1);
  E = __fsub_rn(in[a.K * a.B + k * a.B + b], __fmul_rn(rem[0], a.prb[b]));
  O = __fsub_rn(in[k * a.B + b], rem[1 + b]);
}

__device__ __forceinline__ float log_ratio(float O, float E) {
  const float oe = fmaxf(__fadd_rn(O, E), CLAMP);
  return logf(fminf(fmaxf(__fdiv_rn(E, oe), CLAMP), 1.0f));
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

__device__ __forceinline__ void store_r(float* p, float r) { *p = r; }
__device__ __forceinline__ void store_r(__nv_bfloat16* p, float r) {
  *p = __float2bfloat16_rn(r);
}

template <typename RT>
__global__ void __launch_bounds__(THREADS) estep_main(Args a, int blk) {
  extern __shared__ float sm[];
  const int K = a.K, B = a.B, d = a.d, B1 = B + 1, R = 1 + B + d;
  float* Ys = sm;                  // d*K
  float* sig = Ys + d * K;         // K
  float* wdiv = sig + K;           // K*B
  float* sl = wdiv + K * B;        // R*PITCH  slab tile
  float* rs = sl + R * PITCH;      // K*PITCH  s, then r
  float* ds = rs + K * PITCH;      // K*PITCH  dist
  float* den = ds + K * PITCH;     // TILE
  float* denr = den + TILE;        // TILE
  float* red = denr + TILE;        // THREADS
  float* acc = red + THREADS;      // K*R      this CTA's S partial

  const int t = blockIdx.x, j = blockIdx.y, tid = threadIdx.x;
  const int slot = a.slots[blk * a.J + j];

  for (int i = tid; i < K * B; i += THREADS) {
    const int k = i / B, b = i % B;
    float O, E;
    removed_oe(a, blk, k, b, O, E);
    wdiv[i] = expf(__fmul_rn(a.theta[b], log_ratio(O, E)));
  }
  for (int i = tid; i < d * K; i += THREADS) Ys[i] = a.Y[i];
  for (int i = tid; i < K; i += THREADS) sig[i] = a.sigma[i];
  for (int i = tid; i < K * R; i += THREADS) acc[i] = 0.0f;

  const bool in_window = a.rw != nullptr && slot >= a.lo &&
                         slot < a.lo + a.width;
  const float* src = a.zp3 + (size_t)slot * R * a.CH;
  float kerr = 0.0f, ent = 0.0f;

  for (int st = 0; st < SUB; ++st) {
    const int c0 = t * CPC + st * TILE;
    if (c0 >= a.CH) break;
    // Columns past the chunk load as zeros: their r is exactly zero.
    for (int i = tid; i < R * TILE; i += THREADS) {
      const int x = i / TILE, c = i % TILE;
      sl[x * PITCH + c] = (c0 + c < a.CH) ? src[(size_t)x * a.CH + c0 + c]
                                          : 0.0f;
    }
    __syncthreads();
    for (int i = tid; i < K * TILE; i += THREADS) {
      const int k = i / TILE, c = i % TILE;
      float dot = 0.0f;
      for (int x = 0; x < d; ++x)
        dot = fmaf(Ys[x * K + k], sl[(B1 + x) * PITCH + c], dot);
      const float dist = __fmul_rn(2.0f, __fsub_rn(1.0f, dot));
      ds[k * PITCH + c] = dist;
      rs[k * PITCH + c] = expf(__fdiv_rn(-dist, sig[k]));
    }
    __syncthreads();
    if (tid < TILE) {
      float s = 0.0f;
      for (int k = 0; k < K; ++k) s = __fadd_rn(s, rs[k * PITCH + tid]);
      den[tid] = s;
    }
    __syncthreads();
    for (int i = tid; i < K * TILE; i += THREADS) {
      const int k = i / TILE, c = i % TILE;
      float w = 0.0f;
      for (int b = 0; b < B; ++b)
        w = fmaf(wdiv[k * B + b], sl[(1 + b) * PITCH + c], w);
      rs[k * PITCH + c] = __fmul_rn(__fdiv_rn(rs[k * PITCH + c], den[c]), w);
    }
    __syncthreads();
    if (tid < TILE) {
      float s = 0.0f;
      for (int k = 0; k < K; ++k) s = __fadd_rn(s, rs[k * PITCH + tid]);
      denr[tid] = fmaxf(s, CLAMP);
    }
    __syncthreads();
    for (int i = tid; i < K * TILE; i += THREADS) {
      const int k = i / TILE, c = i % TILE;
      const float r = __fdiv_rn(rs[k * PITCH + c], denr[c]);
      rs[k * PITCH + c] = r;
      kerr = fmaf(r, ds[k * PITCH + c], kerr);
      if (!a.fast_ent && r > 0.0f)
        ent = fmaf(__fmul_rn(r, logf(r)), sig[k], ent);
      if (in_window && c0 + c < a.CH)
        store_r(static_cast<RT*>(a.rw) +
                    ((size_t)(slot - a.lo) * K + k) * a.CH + c0 + c, r);
    }
    __syncthreads();
    if (a.fast_ent && tid < TILE) {
      // sum_c (sigma^T r)_c (log den_c + log den_r_c); the per-cluster
      // O-term is added from the chunk's stats in estep_reduce.
      float sr = 0.0f;
      for (int k = 0; k < K; ++k) sr = fmaf(rs[k * PITCH + tid], sig[k], sr);
      ent = fmaf(sr, __fadd_rn(logf(den[tid]), logf(denr[tid])), ent);
    }
    for (int i = tid; i < K * R; i += THREADS) {
      const int k = i / R, x = i % R;
      float s = acc[i];
      for (int c = 0; c < TILE; ++c)
        s = fmaf(rs[k * PITCH + c], sl[x * PITCH + c], s);
      acc[i] = s;
    }
    __syncthreads();
  }

  float* P = a.part + ((size_t)j * a.nt + t) * K * R;
  for (int i = tid; i < K * R; i += THREADS) P[i] = acc[i];
  kerr = block_sum(kerr, red);
  ent = block_sum(ent, red);
  if (tid == 0) {
    a.kpart[((size_t)j * a.nt + t) * 2] = kerr;
    a.kpart[((size_t)j * a.nt + t) * 2 + 1] = ent;
  }
}

__global__ void __launch_bounds__(THREADS) estep_reduce(Args a, int blk) {
  extern __shared__ float sm[];
  const int K = a.K, B = a.B, d = a.d, B1 = B + 1, R = 1 + B + d;
  const int tid = threadIdx.x;
  const size_t tstride = (size_t)K * R;   // partial stride between groups

  if ((int)blockIdx.x < a.J) {
    // Per-chunk outputs of slot j.
    const int j = blockIdx.x;
    const int slot = a.slots[blk * a.J + j];
    float* stats = sm;                     // K*B1
    float* red = stats + K * B1;           // THREADS
    const float* P = a.part + (size_t)j * a.nt * tstride;
    for (int i = tid; i < K * R; i += THREADS) {
      float s = 0.0f;
      for (int t = 0; t < a.nt; ++t) s = __fadd_rn(s, P[t * tstride + i]);
      const int k = i / R, x = i % R;
      if (x < B1) {
        a.cache[((size_t)slot * K + k) * B1 + x] = s;
        stats[k * B1 + x] = s;
      } else {
        a.ybuf[((size_t)slot * K + k) * d + x - B1] = s;
      }
    }
    float kerr = 0.0f, second = 0.0f;
    for (int t = 0; t < a.nt; ++t) {
      kerr = __fadd_rn(kerr, a.kpart[((size_t)j * a.nt + t) * 2]);
      second = __fadd_rn(second, a.kpart[((size_t)j * a.nt + t) * 2 + 1]);
    }
    float ent = second;
    if (a.fast_ent) {
      // + sum_kb sigma_k theta_b logratio_kb O_chunk[k, b]
      __syncthreads();
      float v = 0.0f;
      for (int i = tid; i < K * B; i += THREADS) {
        const int k = i / B, b = i % B;
        float O, E;
        removed_oe(a, blk, k, b, O, E);
        const float coef = __fmul_rn(__fmul_rn(a.sigma[k], a.theta[b]),
                                     log_ratio(O, E));
        v = fmaf(coef, stats[k * B1 + 1 + b], v);
      }
      const float stv = block_sum(v, red);
      ent = __fsub_rn(__fadd_rn(-kerr, stv), second);
    }
    if (tid == 0) {
      a.kbuf[(size_t)slot * 2] = kerr;
      a.kbuf[(size_t)slot * 2 + 1] = ent;
    }
  } else {
    // Add the block back for cluster k: per-slot sums in the same order as
    // above (so they equal the cache rows bit for bit), then over slots in
    // ascending order.
    const int k = blockIdx.x - a.J;
    float* ss = sm;                        // B1*J
    for (int i = tid; i < B1 * a.J; i += THREADS) {
      const int c = i / a.J, j = i % a.J;
      const float* P = a.part + (size_t)j * a.nt * tstride + k * R + c;
      float s = 0.0f;
      for (int t = 0; t < a.nt; ++t) s = __fadd_rn(s, P[t * tstride]);
      ss[c * a.J + j] = s;
    }
    __syncthreads();
    float* out = a.oe + (size_t)((blk + 1) & 1) * 2 * K * B;
    for (int b = tid; b < B; b += THREADS) {
      float acc0 = 0.0f, accb = 0.0f;
      for (int j = 0; j < a.J; ++j) {
        acc0 = __fadd_rn(acc0, ss[j]);
        accb = __fadd_rn(accb, ss[(1 + b) * a.J + j]);
      }
      float O, E;
      removed_oe(a, blk, k, b, O, E);
      out[K * B + k * B + b] = __fadd_rn(E, __fmul_rn(acc0, a.prb[b]));
      out[k * B + b] = __fadd_rn(O, accb);
    }
  }
}

size_t main_smem(int K, int B, int d) {
  const int R = 1 + B + d;
  return sizeof(float) * ((size_t)d * K + K + K * B + R * PITCH +
                          2 * K * PITCH + 2 * TILE + THREADS + (size_t)K * R);
}

size_t reduce_smem(int K, int B, int J) {
  const size_t slot = (size_t)K * (B + 1) + THREADS;
  const size_t add = (size_t)(B + 1) * J;
  return sizeof(float) * (slot > add ? slot : add);
}

template <typename RT>
int run(const Args& a, int nb, cudaStream_t stream) {
  const size_t sm_main = main_smem(a.K, a.B, a.d);
  const size_t sm_red = reduce_smem(a.K, a.B, a.J);
  if (sm_main > MAX_SMEM || sm_red > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      estep_main<RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sm_main);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      estep_reduce, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm_red);
  if (err != cudaSuccess) return (int)err;
  for (int blk = 0; blk < nb; ++blk) {
    estep_main<RT><<<dim3(a.nt, a.J), THREADS, sm_main, stream>>>(a, blk);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    estep_reduce<<<a.J + a.K, THREADS, sm_red, stream>>>(a, blk);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

Args make_args(const float* zp3, const float* Y, const float* sigma,
               const float* theta, const float* prb, const float* removal,
               const int* slots, float* oe, float* part, float* kpart,
               float* cache, float* ybuf, float* kbuf, void* rw, int lo,
               int width, int K, int B, int d, int CH, int J, int fast_ent) {
  Args a;
  a.zp3 = zp3; a.Y = Y; a.sigma = sigma; a.theta = theta; a.prb = prb;
  a.removal = removal; a.slots = slots; a.oe = oe; a.part = part;
  a.kpart = kpart; a.cache = cache; a.ybuf = ybuf; a.kbuf = kbuf; a.rw = rw;
  a.lo = lo; a.width = width; a.K = K; a.B = B; a.d = d; a.CH = CH; a.J = J;
  a.nt = (CH + CPC - 1) / CPC; a.fast_ent = fast_ent;
  return a;
}

}  // namespace

extern "C" {

// Column groups per chunk (the `nt` of the partial buffers).
int fused_estep_groups(int CH) { return (CH + CPC - 1) / CPC; }

// One round over nb blocks: 2*nb launches on `stream`. Returns 0 or the
// CUDA error of the first launch that failed.
int fused_estep_round(const float* zp3, const float* Y, const float* sigma,
                      const float* theta, const float* prb,
                      const float* removal, const int* slots, float* oe,
                      float* part, float* kpart, float* cache, float* ybuf,
                      float* kbuf, int K, int B, int d, int CH, int nb, int J,
                      int fast_ent, void* stream) {
  const Args a = make_args(zp3, Y, sigma, theta, prb, removal, slots, oe,
                           part, kpart, cache, ybuf, kbuf, nullptr, 0, 0, K,
                           B, d, CH, J, fast_ent);
  return run<float>(a, nb, (cudaStream_t)stream);
}

// The same round, also writing r of chunks lo..lo+width-1 into rw
// (width, K, CH).
int fused_estep_r_window(const float* zp3, const float* Y, const float* sigma,
                         const float* theta, const float* prb,
                         const float* removal, const int* slots, float* oe,
                         float* part, float* kpart, float* cache, float* ybuf,
                         float* kbuf, float* rw, int lo, int width, int K,
                         int B, int d, int CH, int nb, int J, int fast_ent,
                         void* stream) {
  const Args a = make_args(zp3, Y, sigma, theta, prb, removal, slots, oe,
                           part, kpart, cache, ybuf, kbuf, rw, lo, width, K,
                           B, d, CH, J, fast_ent);
  return run<float>(a, nb, (cudaStream_t)stream);
}

// K2: the same round, also writing r of every slotted chunk into the
// chunk-major r3 (nc1, K, CH), as float (r_bf16 == 0) or bf16.
int fused_estep_write_r(const float* zp3, const float* Y, const float* sigma,
                        const float* theta, const float* prb,
                        const float* removal, const int* slots, float* oe,
                        float* part, float* kpart, float* cache, float* ybuf,
                        float* kbuf, void* r3, int nc1, int r_bf16, int K,
                        int B, int d, int CH, int nb, int J, int fast_ent,
                        void* stream) {
  const Args a = make_args(zp3, Y, sigma, theta, prb, removal, slots, oe,
                           part, kpart, cache, ybuf, kbuf, r3, 0, nc1, K, B,
                           d, CH, J, fast_ent);
  return r_bf16 ? run<__nv_bfloat16>(a, nb, (cudaStream_t)stream)
                : run<float>(a, nb, (cudaStream_t)stream);
}

}  // extern "C"
