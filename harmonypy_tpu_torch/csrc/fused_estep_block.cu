// The per-block entry of the fused E-step for Hopper (sm_90a): block b of
// the round alone, one ordinary launch of one CTA per unit, as a mesh runs
// it on every shard (fused_estep.cuh, which holds the kernel and its design
// notes; these are its FOLD instantiations). Its prologue may re-add the
// previous block across shards (frame_sum.cuh): the mesh pass then launches
// the re-add kernel (frame_readd.cu) once per pass, not once per block.
// The prologue's cost: each CTA reads the previous block's frame rows, at
// 858k on 4 shards 22 ranks x K (B+1) floats (~35 KB, from L2), against
// the ~5 us of device time and the launch it saves. Each thread issues the
// loads of its first two column sums at the kernel's start, so that their
// two dependent trips to L2 overlap the kernel's setup.

#include "fused_estep.cuh"

namespace {

// One block alone in per-block mode: an ordinary launch of J * ng CTAs, one
// per unit (Args from block_args).
template <typename RT>
int run_block(const Args& a, cudaStream_t stream) {
  const Lay L = layout(a.K, a.B, a.d);
  const size_t smem = sizeof(float) * (size_t)L.total;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  return with_variant(L, [&](auto nrg, auto pre) {
    estep_round<RT, decltype(nrg)::value, decltype(pre)::value, true>
        <<<a.J * a.ng, THREADS, smem, stream>>>(a);
    return (int)cudaGetLastError();
  });
}

// Allow the dynamic shared memory of (K, B, d) for the per-block
// instantiations of estep_round<RT> on the current device.
template <typename RT>
int allow_smem(int K, int B, int d) {
  const Lay L = layout(K, B, d);
  const size_t smem = sizeof(float) * (size_t)L.total;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  return with_variant(L, [&](auto nrg, auto pre) {
    return (int)cudaFuncSetAttribute(
        estep_round<RT, decltype(nrg)::value, decltype(pre)::value, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  });
}

// A per-block launch prepared once per pass: the Args of the whole tables
// (block_args picks a block at each launch), the parity strides of the
// double-buffered rows, the store type, the stream.
struct BlockCall {
  Args a;
  size_t brows_pstride, frame_pstride;  // floats between parity copies
  int r_bf16;
  int device;  // the stream's device, current during the launch
  cudaStream_t stream;
};

// Block blk of the round alone (per-block mode): the tables' row blk, a
// one-block walk. It writes O1, E1 and brows of parity blk & 1. It starts
// from the O0, E0 given, or with readd (blk > 0) from the previous block's
// block-removed O1, E1 (parity (blk - 1) & 1) plus that block's frame: the
// rows of parity (blk - 1) & 1 and the rank codes of row blk - 1.
int block_args(Args& a, const BlockCall& c, int blk, int readd) {
  if (blk < 0 || blk >= a.nb || (readd && (blk == 0 || a.frame == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t kb = (size_t)a.K * a.B, p = blk & 1, q = (blk - 1) & 1;
  a.slots += (size_t)blk * a.J;
  a.removal += (size_t)blk * a.K * (a.B + 1);
  a.O1 += p * kb;
  a.E1 += p * kb;
  a.brows += p * c.brows_pstride;
  a.readd = readd;
  if (readd) {
    a.O0 = c.a.O1 + q * kb;
    a.E0 = c.a.E1 + q * kb;
    a.frame += q * c.frame_pstride;
    a.src += (size_t)(blk - 1) * (a.J_fix + 1);
  }
  a.nb = 1;
  return 0;
}

}  // namespace

extern "C" {

// Lets the per-block launches of (K, B, d) take their dynamic shared memory
// on the current device: once per device and shape before them. Returns 0
// or the CUDA error.
int fused_estep_block_setup(int K, int B, int d) {
  const int err = allow_smem<float>(K, B, d);
  return err ? err : allow_smem<__nv_bfloat16>(K, B, d);
}

// Bytes of the call record fused_estep_block_prepare writes.
int fused_estep_block_call_size() { return (int)sizeof(BlockCall); }

// The per-block entry (one launch per shard per block on a mesh): block blk
// of fused_estep_round (rw null), of fused_estep_r_window (lo may be
// negative: rw holds the window's chunks lo..lo+width-1 in the shard's
// chunk ids) or of fused_estep_write_r (rw = r3, lo 0, width nc1, r_bf16
// its type), as one ordinary launch of J * ng CTAs. The same arithmetic as
// the round: the slots' cache, ybuf and kbuf rows equal the round's
// bitwise. Block 0 of a pass starts from O0, E0 (K, B). Each launch writes
// the slots' cache rows into brows (J, K, B+1) in slot order, and
// O1, E1 = the block-removed O, E, both of the block's parity: O1, E1 are
// (2, K, B), brows' second copy lies brows_pstride floats on (0: one copy,
// where no other launch reads it while the next one writes). With frame
// (every shard's (J, K, B+1) rows stacked shard-major, parity copies
// frame_pstride floats apart), src (nb, J_fix + 1) int32 (rank r of block
// b held by shard s's slot j: s * J + j, or -1; column J_fix is scratch)
// and J_fix, a launch may start block blk from block blk - 1's re-add
// (fused_estep_block_launch's readd). tickets (J ints) must be zero before
// the first launch and stay zero after each. part holds J * ng unit
// partials (one block's).
// prepare writes the call record once per pass into `call` (host memory
// of fused_estep_block_call_size() bytes; bsum unused); launch issues
// block blk of it, so the host converts three arguments per launch.
int fused_estep_block_prepare(ESTEP_PTRS, int* tickets, float* brows,
                              int brows_pstride, const float* frame,
                              int frame_pstride, const int* src, int J_fix,
                              void* rw, int r_bf16, int lo, int width,
                              ESTEP_DIMS, int device, void* call) {
  if (tickets == nullptr || brows == nullptr || call == nullptr ||
      brows_pstride < 0 || frame_pstride < 0 ||
      (frame != nullptr && (src == nullptr || J_fix < 1)))
    return (int)cudaErrorInvalidValue;
  BlockCall* c = static_cast<BlockCall*>(call);
  c->a = ESTEP_ARGS(rw, lo, width);
  c->a.tickets = tickets;
  c->a.brows = brows;
  c->a.frame = frame;
  c->a.src = src;
  c->a.J_fix = J_fix;
  c->brows_pstride = (size_t)brows_pstride;
  c->frame_pstride = (size_t)frame_pstride;
  c->r_bf16 = r_bf16;
  c->device = device;
  c->stream = (cudaStream_t)stream;
  return 0;
}

// Launch block blk of a prepared call, on its device (the current device
// is restored after); readd: start from block blk - 1's re-add (blk > 0,
// a frame prepared). Returns 0 or the CUDA error of the launch.
int fused_estep_block_launch(const void* call, int blk, int readd) {
  const BlockCall* c = static_cast<const BlockCall*>(call);
  Args a = c->a;
  int err = block_args(a, *c, blk, readd), prev = c->device;
  if (err) return err;
  if ((err = (int)cudaGetDevice(&prev)) != 0) return err;
  if (prev != c->device && (err = (int)cudaSetDevice(c->device)) != 0)
    return err;
  err = c->r_bf16 ? run_block<__nv_bfloat16>(a, c->stream)
                  : run_block<float>(a, c->stream);
  if (prev != c->device) {
    const int e2 = (int)cudaSetDevice(prev);
    if (!err) err = e2;
  }
  return err;
}

}  // extern "C"
