// The one-launch fused E-step round (K1, its r window, K2) for Hopper
// (sm_90a): the C entries of the round's instantiations of estep_round
// (fused_estep.cuh, which holds the kernel and its design notes).
//
// ESTEP_ONE picks the variant of the products this library holds: this
// file builds the 3xTF32 one (matmul_precision "float32"), and
// fused_estep_one.cu, which includes it with ESTEP_ONE true, the one-pass
// bf16 one ("default"): two libraries with the same entries, two nvcc
// processes in parallel.

#include "fused_estep.cuh"

#ifndef ESTEP_ONE
#define ESTEP_ONE false
#endif
// ESTEP_TIMED: the stamped instantiations (fused_estep_timed.cu), whose
// library holds only fused_estep_round_timed and the layout queries.
#ifndef ESTEP_TIMED
#define ESTEP_TIMED false
#endif

namespace {

// CTAs of estep_round<RT, NRG, PRE> (of this library's variant; WIDE: in
// the wide plan, CODES: the codes plan) that fit on the current device at
// once, or a negative CUDA error.
template <typename RT, int NRG, bool PRE, bool WIDE = false,
          bool CODES = false>
int grid_size(size_t smem) {
  auto* kernel =
      estep_round<RT, NRG, PRE, false, ESTEP_ONE, ESTEP_TIMED, WIDE, CODES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int dev = 0, nsm = 0, per = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return -(int)err;
  err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, THREADS,
                                                      smem);
  if (err != cudaSuccess) return -(int)err;
  if (per < 1) return -(int)cudaErrorInvalidConfiguration;
  return per * nsm;
}

// The round in the wide plan (layout_wide), for shapes whose plan exceeds
// shared memory: at most a.wide_ctas CTAs, each with its slab of a.wide.
// The stamped library has no wide instantiation.
template <typename RT>
int run_wide(const Args& a, cudaStream_t stream) {
#if ESTEP_TIMED
  return (int)cudaErrorInvalidValue;
#else
  const Lay L = layout_wide<ESTEP_ONE>(a.K, a.B, a.d);
  const size_t smem = sizeof(float) * (size_t)L.total;
  if (smem > MAX_SMEM || a.wide == nullptr || a.wide_ctas < 1)
    return (int)cudaErrorInvalidValue;
  int grid = grid_size<RT, NRG_MAX, false, true>(smem);
  if (grid < 0) return -grid;
  if (grid > a.J * a.ng) grid = a.J * a.ng;
  if (grid > a.wide_ctas) grid = a.wide_ctas;
  Args arg = a;
  void* params[] = {&arg};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)estep_round<RT, NRG_MAX, false, false, ESTEP_ONE, false,
                               true>,
      dim3(grid), dim3(THREADS), params, smem, stream);
#endif
}

// The round in the codes plan (layout_codes), for a one-covariate design
// (a.codes) whose narrow plan exceeds shared memory: as run_wide, with the
// codes plan's scratch.
template <typename RT>
int run_codes(const Args& a, cudaStream_t stream) {
#if ESTEP_TIMED
  return (int)cudaErrorInvalidValue;
#else
  const Lay L = layout_codes<ESTEP_ONE>(a.K, a.B, a.d);
  const size_t smem = sizeof(float) * (size_t)L.total;
  if (smem > MAX_SMEM || a.wide == nullptr || a.wide_ctas < 1)
    return (int)cudaErrorInvalidValue;
  int grid = grid_size<RT, CG, false, true, true>(smem);
  if (grid < 0) return -grid;
  if (grid > a.J * a.ng) grid = a.J * a.ng;
  if (grid > a.wide_ctas) grid = a.wide_ctas;
  Args arg = a;
  void* params[] = {&arg};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)estep_round<RT, CG, false, false, ESTEP_ONE, false, true,
                               true>,
      dim3(grid), dim3(THREADS), params, smem, stream);
#endif
}

template <typename RT>
int run(const Args& a, cudaStream_t stream) {
  const Lay L = layout<ESTEP_ONE>(a.K, a.B, a.d);
  const size_t smem = sizeof(float) * (size_t)L.total;
  if (a.sync == nullptr) return (int)cudaErrorInvalidValue;
  if (smem > MAX_SMEM)
    return a.codes != nullptr ? run_codes<RT>(a, stream)
                              : run_wide<RT>(a, stream);
  return with_variant<ESTEP_ONE>(L, [&](auto nrg, auto pre) {
    constexpr int NRG = decltype(nrg)::value;
    constexpr bool PRE = decltype(pre)::value;
    int grid = grid_size<RT, NRG, PRE>(smem);
    if (grid < 0) return -grid;
    // No CTA without a unit: each arrives in every block (and every CTA is
    // resident, as the cooperative launch guarantees: CTAs wait for each
    // other's counts).
    if (grid > a.J * a.ng) grid = a.J * a.ng;
    Args arg = a;
    void* params[] = {&arg};
    return (int)cudaLaunchCooperativeKernel(
        (const void*)estep_round<RT, NRG, PRE, false, ESTEP_ONE, ESTEP_TIMED>,
        dim3(grid), dim3(THREADS), params, smem, stream);
  });
}

template <typename RT>
int grid_of(int K, int B, int d, bool codes = false) {
  const Lay L = layout<ESTEP_ONE>(K, B, d);
  const size_t smem = sizeof(float) * (size_t)L.total;
  if (smem > MAX_SMEM) {
#if ESTEP_TIMED
    return -(int)cudaErrorInvalidValue;
#else
    if (codes) {
      const size_t c =
          sizeof(float) * (size_t)layout_codes<ESTEP_ONE>(K, B, d).total;
      if (c > MAX_SMEM) return -(int)cudaErrorInvalidValue;
      return grid_size<RT, CG, false, true, true>(c);
    }
    const size_t wide =
        sizeof(float) * (size_t)layout_wide<ESTEP_ONE>(K, B, d).total;
    if (wide > MAX_SMEM) return -(int)cudaErrorInvalidValue;
    return grid_size<RT, NRG_MAX, false, true>(wide);
#endif
  }
  return with_variant<ESTEP_ONE>(L, [&](auto nrg, auto pre) {
    return grid_size<RT, decltype(nrg)::value, decltype(pre)::value>(smem);
  });
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs for (K, B, d), in bytes: of the
// plan that keeps O, E, wdiv and S in it; where that exceeds
// fused_estep_smem_limit, the round takes the wide plan, which needs
// fused_estep_smem_wide and fused_estep_wide_floats of global memory per
// CTA.
int fused_estep_smem(int K, int B, int d) {
  return (int)smem_bytes<ESTEP_ONE>(K, B, d);
}
int fused_estep_smem_wide(int K, int B, int d) {
  return (int)(sizeof(float) * (size_t)layout_wide<ESTEP_ONE>(K, B, d).total);
}
int fused_estep_wide_floats(int K, int B, int d) {
  return layout_wide<ESTEP_ONE>(K, B, d).gtotal;
}

// The codes plan (a one-covariate design past the shared memory): its
// shared memory per CTA, its scratch floats per CTA and those its CTAs
// share (after wide_ctas per-CTA scratches).
int fused_estep_smem_codes(int K, int B, int d) {
  return (int)(sizeof(float) *
               (size_t)layout_codes<ESTEP_ONE>(K, B, d).total);
}
int fused_estep_codes_floats(int K, int B, int d) {
  return layout_codes<ESTEP_ONE>(K, B, d).gtotal;
}
int fused_estep_codes_shared_floats(int K, int B, int d) {
  return layout_codes<ESTEP_ONE>(K, B, d).gshared;
}

// Whether this library holds the one-pass variant (1) or 3xTF32 (0).
int fused_estep_one_pass() { return ESTEP_ONE ? 1 : 0; }

// Largest shared memory a CTA may take.
int fused_estep_smem_limit() { return (int)MAX_SMEM; }

// Cells per tile (the unit of the static work split).
int fused_estep_tile() { return TILE; }

#if ESTEP_TIMED
// The grid of the stamped round's launch, or a negative CUDA error.
int fused_estep_grid(int K, int B, int d, int r_bf16) {
  return r_bf16 ? -(int)cudaErrorInvalidValue : grid_of<float>(K, B, d);
}

// Stamps per block and CTA, and the phase each ends (STAMP_NAMES).
int fused_estep_stamps_per_block() { return NST; }
const char* fused_estep_stamp_names() { return STAMP_NAMES; }

// fused_estep_round with stamps: (nb, grid, NST) clock64 values, then (grid,
// 4) globaltimer and clock64 at each CTA's start and end.
int fused_estep_round_timed(ESTEP_PTRS, unsigned* sync,
                            unsigned long long* stamps, ESTEP_DIMS) {
  Args a = ESTEP_ARGS(nullptr, 0, 0);
  a.sync = sync;
  a.stamps = stamps;
  return run<float>(a, (cudaStream_t)stream);
}
#else
// The grid of one round's launch (K1's and K2's instantiation: r_bf16
// picks; of the wide plan where the shape takes it), or a negative CUDA
// error.
int fused_estep_grid(int K, int B, int d, int r_bf16) {
  return r_bf16 ? grid_of<__nv_bfloat16>(K, B, d) : grid_of<float>(K, B, d);
}

// The same in the codes plan (for a shape past the shared memory).
int fused_estep_grid_codes(int K, int B, int d, int r_bf16) {
  return r_bf16 ? grid_of<__nv_bfloat16>(K, B, d, true)
                : grid_of<float>(K, B, d, true);
}

// One round over nb blocks: one cooperative launch on `stream`. sync: the
// stream's sync buffer (SY_WORDS words, Args::sync), zero before its first
// launch; each launch leaves it fit for the next. wide: where the shape
// takes the wide plan, wide_ctas x fused_estep_wide_floats floats of
// scratch (the launch takes at most wide_ctas CTAs); else null. codes: a
// one-covariate design's (nc1, CH) batch levels (-1: padding), or null;
// where the shape takes the wide plan, with codes the round takes the
// codes plan and wide holds wide_ctas x fused_estep_codes_floats floats,
// then fused_estep_codes_shared_floats.
// Returns 0 or the CUDA error of the launch.
int fused_estep_round(ESTEP_PTRS, unsigned* sync, float* wide, int wide_ctas,
                      const int* codes, ESTEP_DIMS) {
  Args a = ESTEP_ARGS(nullptr, 0, 0);
  a.sync = sync;
  a.wide = wide;
  a.wide_ctas = wide_ctas;
  a.codes = codes;
  return run<float>(a, (cudaStream_t)stream);
}

// The same round, also writing r of chunks lo..lo+width-1 into rw
// (width, K, CH).
int fused_estep_r_window(ESTEP_PTRS, unsigned* sync, float* rw, int lo,
                         int width, float* wide, int wide_ctas,
                         const int* codes, ESTEP_DIMS) {
  Args a = ESTEP_ARGS(rw, lo, width);
  a.sync = sync;
  a.wide = wide;
  a.wide_ctas = wide_ctas;
  a.codes = codes;
  return run<float>(a, (cudaStream_t)stream);
}

// K2: the same round, also writing r of every slotted chunk into the
// chunk-major r3 (nc1, K, CH), as float (r_bf16 == 0) or bf16.
int fused_estep_write_r(ESTEP_PTRS, unsigned* sync, void* r3, int r_bf16,
                        float* wide, int wide_ctas, const int* codes,
                        ESTEP_DIMS) {
  Args a = ESTEP_ARGS(r3, 0, nc1);
  a.sync = sync;
  a.wide = wide;
  a.wide_ctas = wide_ctas;
  a.codes = codes;
  return r_bf16 ? run<__nv_bfloat16>(a, (cudaStream_t)stream)
                : run<float>(a, (cudaStream_t)stream);
}
#endif

}  // extern "C"
