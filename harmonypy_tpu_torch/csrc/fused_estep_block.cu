// The per-block entry of the fused E-step for Hopper (sm_90a): block b of
// the round alone, one launch of one CTA per unit, each slot's units one
// thread-block cluster (or, above CLUSTER_MAX units, an ordinary launch
// with tickets), as a mesh runs it on every shard (fused_estep.cuh, which
// holds the kernel and its design notes; these are its FOLD
// instantiations). Its prologue may re-add the
// previous block across shards (frame_sum.cuh): the mesh pass then launches
// the re-add kernel (frame_readd.cuh) once per pass, not once per block.
// The whole pass is issued from here (mesh_plan_run, at the end): the host
// walks a table of the pass's launches, copies and events made once per
// fit, so a pass costs one call from Python and no allocation.
// The prologue's cost: each CTA reads the previous block's frame rows, at
// 858k on 4 shards 22 ranks x K (B+1) floats (~35 KB, from L2), against
// the ~5 us of device time and the launch it saves. Each thread issues the
// loads of its first two column sums at the kernel's start, so that their
// two dependent trips to L2 overlap the kernel's setup.
//
// ESTEP_ONE picks the variant of the products this library holds, as in
// fused_estep.cu: this file the 3xTF32 one, fused_estep_block_one.cu (which
// includes it with ESTEP_ONE true) the one-pass bf16 one. A mesh pass's
// plan, its call records and its walker all come from one library.

#include <new>
#include <vector>

#include "frame_readd.cuh"
#include "fused_estep.cuh"

#ifndef ESTEP_ONE
#define ESTEP_ONE false
#endif
// ESTEP_TIMED: the stamped instantiations (fused_estep_block_timed.cu),
// whose launches write the stamps of the call record (its a.stamps, set by
// fused_estep_block_set_stamps; a launch without them is refused).
#ifndef ESTEP_TIMED
#define ESTEP_TIMED false
#endif

namespace {

// The launch of J * ng CTAs, one per unit, of a block whose slots' ng
// units form a thread-block cluster each (ng > 0), or no clusters (ng 0).
cudaLaunchConfig_t block_config(int J, int ng, size_t smem,
                                cudaStream_t stream,
                                cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(J * (ng > 0 ? ng : 1));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  if (ng > 0) {
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = ng;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return cfg;
}

// One block alone in per-block mode (Args from block_args): J * ng CTAs,
// one per unit; without tickets each slot's ng units are one cluster
// (cluster_tail), with them an ordinary launch (block_tail).
template <typename RT>
int run_block(const Args& a, cudaStream_t stream) {
  const Lay L = layout<ESTEP_ONE>(a.K, a.B, a.d);
  const size_t smem = sizeof(float) * (size_t)L.total;
  if (smem > MAX_SMEM || (ESTEP_TIMED && a.stamps == nullptr) ||
      (a.tickets == nullptr && a.ng > CLUSTER_MAX))
    return (int)cudaErrorInvalidValue;
  return with_variant<ESTEP_ONE>(L, [&](auto nrg, auto pre) {
    auto* kernel = estep_round<RT, decltype(nrg)::value, decltype(pre)::value,
                               true, ESTEP_ONE, ESTEP_TIMED>;
    if (a.tickets != nullptr) {
      kernel<<<a.J * a.ng, THREADS, smem, stream>>>(a);
      return (int)cudaGetLastError();
    }
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = block_config(a.J, a.ng, smem, stream,
                                                &attr);
    return (int)cudaLaunchKernelEx(&cfg, kernel, a);
  });
}

// Allow the dynamic shared memory of (K, B, d) for the per-block
// instantiations of estep_round<RT> on the current device, and with
// cluster = ng > 0 clusters of ng CTAs (above 8 a non-portable size);
// then the number of such clusters the device holds at once into
// *clusters (0 with cluster 0).
template <typename RT>
int allow_smem(int K, int B, int d, int cluster, int* clusters) {
  const Lay L = layout<ESTEP_ONE>(K, B, d);
  const size_t smem = sizeof(float) * (size_t)L.total;
  *clusters = 0;
  if (smem > MAX_SMEM || cluster < 0 || cluster > CLUSTER_MAX)
    return (int)cudaErrorInvalidValue;
  return with_variant<ESTEP_ONE>(L, [&](auto nrg, auto pre) {
    auto* kernel = estep_round<RT, decltype(nrg)::value, decltype(pre)::value,
                               true, ESTEP_ONE, ESTEP_TIMED>;
    int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err || cluster == 0) return err;
    if (cluster > 8 &&
        (err = (int)cudaFuncSetAttribute(
             kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)))
      return err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = block_config(1, cluster, smem, nullptr,
                                                &attr);
    return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
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

// Launch block blk of a prepared call on the current device (c.device).
int launch_block(const BlockCall& c, int blk, int readd) {
  Args a = c.a;
  const int err = block_args(a, c, blk, readd);
  if (err) return err;
  return c.r_bf16 ? run_block<__nv_bfloat16>(a, c.stream)
                  : run_block<float>(a, c.stream);
}

}  // namespace

extern "C" {

// Lets the per-block launches of (K, B, d) take their dynamic shared memory
// on the current device, and with cluster = ng > 0 run each slot's ng
// units as one cluster: once per device and shape before them. Returns 0,
// the CUDA error, or cudaErrorLaunchOutOfResources where the device cannot
// hold one such cluster at once.
int fused_estep_block_setup(int K, int B, int d, int cluster) {
  int n[2] = {0, 0};
  int err = allow_smem<float>(K, B, d, cluster, n);
  if (!err) err = allow_smem<__nv_bfloat16>(K, B, d, cluster, n + 1);
  if (!err && cluster > 0 && (n[0] < 1 || n[1] < 1))
    err = (int)cudaErrorLaunchOutOfResources;
  return err;
}

// Clusters of `cluster` CTAs of the per-block entry of (K, B, d) (K1's
// instantiation) the current device holds at once, or a negative CUDA
// error.
int fused_estep_block_clusters(int K, int B, int d, int cluster) {
  int n = 0;
  const int err = allow_smem<float>(K, B, d, cluster, &n);
  return err ? -err : n;
}

// Largest number of units per slot whose launches run as clusters.
int fused_estep_block_cluster_max() { return CLUSTER_MAX; }

// Bytes of the call record fused_estep_block_prepare writes.
int fused_estep_block_call_size() { return (int)sizeof(BlockCall); }

// Whether this library holds the one-pass variant (1) or 3xTF32 (0).
int fused_estep_block_one_pass() { return ESTEP_ONE ? 1 : 0; }

// The per-block entry (one launch per shard per block on a mesh): block blk
// of fused_estep_round (rw null), of fused_estep_r_window (lo may be
// negative: rw holds the window's chunks lo..lo+width-1 in the shard's
// chunk ids) or of fused_estep_write_r (rw = r3, lo 0, width nc1, r_bf16
// its type), as one launch of J * ng CTAs. The same arithmetic as
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
// the first launch and stay zero after each; tickets null: each slot's ng
// units run as one cluster (ng <= CLUSTER_MAX; fused_estep_block_setup
// with cluster ng first) and part and kpart are not used. part holds
// J * ng unit partials (one block's).
// prepare writes the call record once per pass into `call` (host memory
// of fused_estep_block_call_size() bytes; bsum unused); launch issues
// block blk of it, so the host converts three arguments per launch.
int fused_estep_block_prepare(ESTEP_PTRS, int* tickets, float* brows,
                              int brows_pstride, const float* frame,
                              int frame_pstride, const int* src, int J_fix,
                              void* rw, int r_bf16, int lo, int width,
                              ESTEP_DIMS, int device, void* call) {
  if ((tickets == nullptr && ng > CLUSTER_MAX) || brows == nullptr ||
      call == nullptr || brows_pstride < 0 || frame_pstride < 0 ||
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
  int prev = c->device, err = (int)cudaGetDevice(&prev);
  if (err) return err;
  if (prev != c->device && (err = (int)cudaSetDevice(c->device)) != 0)
    return err;
  err = launch_block(*c, blk, readd);
  if (prev != c->device) {
    const int e2 = (int)cudaSetDevice(prev);
    if (!err) err = e2;
  }
  return err;
}

#if ESTEP_TIMED
// Stamps per CTA and the phase each ends (BLOCK_STAMP_NAMES).
int fused_estep_block_stamps_per_block() { return NST; }
const char* fused_estep_block_stamp_names() { return BLOCK_STAMP_NAMES; }

// Point a prepared call record's launches at a stamp buffer: (grid, NST)
// clock64 values, then (grid, 4) globaltimer and clock64 at each CTA's
// start and end. Returns 0 or cudaErrorInvalidValue.
int fused_estep_block_set_stamps(void* call, unsigned long long* stamps) {
  if (call == nullptr || stamps == nullptr)
    return (int)cudaErrorInvalidValue;
  static_cast<BlockCall*>(call)->a.stamps = stamps;
  return 0;
}
#endif

// Largest number of shards a re-add launch takes.
int frame_readd_max_shards() { return readd::MAX_SHARDS; }

// Bytes of the call record frame_readd_prepare writes.
int frame_readd_call_size() { return (int)sizeof(readd::ReaddCall); }

// Prepare the re-adds of a pass into `call` (host memory of
// frame_readd_call_size() bytes): rows (host array of S device pointers)
// to each shard's (J_s, K, B+1) block rows in slot order (J_s <= Jmax);
// src (nb, J_fix + 1) int32 (rank r of block b held by shard s's slot j:
// s * Jmax + j, or -1; column J_fix is scratch); Or, Er, O, E (K, B); prb
// (B); the launches go to `stream`. Returns 0 or a CUDA error.
int frame_readd_prepare(const void* const* rows, int S, const int* src,
                        int J_fix, int Jmax, const float* Or, const float* Er,
                        const float* prb, float* O, float* E, int K, int B,
                        int device, void* stream, void* call) {
  if (S < 1 || S > readd::MAX_SHARDS || call == nullptr)
    return (int)cudaErrorInvalidValue;
  readd::ReaddCall* c = static_cast<readd::ReaddCall*>(call);
  for (int s = 0; s < S; ++s)
    c->rows.p[s] = static_cast<const float*>(rows[s]);
  c->src = src;
  c->J_fix = J_fix;
  c->Jmax = Jmax;
  c->Or = Or;
  c->Er = Er;
  c->prb = prb;
  c->O = O;
  c->E = E;
  c->K = K;
  c->B = B;
  c->device = device;
  c->stream = (cudaStream_t)stream;
  return 0;
}

// Launch the re-add of block blk of a prepared call, on its device (the
// current device is restored after). Returns 0 or the CUDA error of the
// launch.
int frame_readd_launch(const void* call, int blk) {
  const readd::ReaddCall* c = static_cast<const readd::ReaddCall*>(call);
  int prev = c->device, err = (int)cudaGetDevice(&prev);
  if (err) return err;
  if (prev != c->device && (err = (int)cudaSetDevice(c->device)) != 0)
    return err;
  err = readd::launch(*c, blk);
  if (prev != c->device) {
    const int e2 = (int)cudaSetDevice(prev);
    if (!err) err = e2;
  }
  return err;
}

}  // extern "C"

// ---- The mesh pass ----
//
// A pass of the round on a mesh of S shards issues, per block, a fork (the
// lead stream's event, each other shard's stream waiting on it, copies to
// shards on other cards), one per-block launch per shard and a join (rows
// copied to the lead card, events), then one re-add launch. Python builds
// that order once per fit as a table (ops/cuda/fused_estep.pass_schedule)
// and this walker issues it: no host wait, the first CUDA error returned.
// Pointers, ints and stream handles come from P, a table of values the
// caller refills each pass with the pass's inputs (plan buffers stay put);
// each shard's call record binds its per-pass fields from P at the start
// of every walk.

namespace {

// An op: OP_WIDTH int64 words, the code first.
//   RECORD event, P stream, device
//   WAIT   P stream, event, device
//   COPY   P stream, device, P dst, dst device, P src, src device, bytes
//   ZERO   P stream, device, P dst, bytes
//   LAUNCH shard, block, readd
//   READD  block
enum : long long { OP_RECORD, OP_WAIT, OP_COPY, OP_ZERO, OP_LAUNCH, OP_READD };
constexpr int OP_WIDTH = 8;

// A shard's call-record fields bound from P at each walk, in this order.
enum {
  F_ZP3, F_Y, F_SIGMA, F_THETA, F_PRB, F_REMOVAL, F_SLOTS, F_O0, F_E0,
  F_CACHE, F_YBUF, F_KBUF, F_RW, F_LO, F_SRC, F_STREAM, N_FIELDS
};
// The re-add record's, in this order.
enum { R_SRC, R_PRB, R_O, R_E, R_STREAM, N_RFIELDS };

struct MeshPlan {
  std::vector<BlockCall> calls;  // per shard
  std::vector<int> bind;         // per shard N_FIELDS indices into P
  readd::ReaddCall readd;
  int rbind[N_RFIELDS];
  std::vector<cudaEvent_t> events;
};

template <typename T>
T* at(const long long* P, int i) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(P[i]));
}

int bind_calls(MeshPlan& m, const long long* P, int nP) {
  for (int i : m.bind)
    if (i < 0 || i >= nP) return (int)cudaErrorInvalidValue;
  for (int i : m.rbind)
    if (i < 0 || i >= nP) return (int)cudaErrorInvalidValue;
  for (size_t s = 0; s < m.calls.size(); ++s) {
    const int* ix = &m.bind[s * N_FIELDS];
    Args& a = m.calls[s].a;
    a.zp3 = at<const float>(P, ix[F_ZP3]);
    a.Y = at<const float>(P, ix[F_Y]);
    a.sigma = at<const float>(P, ix[F_SIGMA]);
    a.theta = at<const float>(P, ix[F_THETA]);
    a.prb = at<const float>(P, ix[F_PRB]);
    a.removal = at<const float>(P, ix[F_REMOVAL]);
    a.slots = at<const int>(P, ix[F_SLOTS]);
    a.O0 = at<const float>(P, ix[F_O0]);
    a.E0 = at<const float>(P, ix[F_E0]);
    a.cache = at<float>(P, ix[F_CACHE]);
    a.ybuf = at<float>(P, ix[F_YBUF]);
    a.kbuf = at<float>(P, ix[F_KBUF]);
    a.rw = at<void>(P, ix[F_RW]);
    a.lo = (int)P[ix[F_LO]];
    a.src = at<const int>(P, ix[F_SRC]);
    m.calls[s].stream = at<CUstream_st>(P, ix[F_STREAM]);
  }
  readd::ReaddCall& r = m.readd;
  r.src = at<const int>(P, m.rbind[R_SRC]);
  r.prb = at<const float>(P, m.rbind[R_PRB]);
  r.O = at<float>(P, m.rbind[R_O]);
  r.E = at<float>(P, m.rbind[R_E]);
  r.stream = at<CUstream_st>(P, m.rbind[R_STREAM]);
  return 0;
}

// Issue ops [begin, end). Each op sets its device first (a null stream is
// that device's default stream).
int walk(MeshPlan& m, const long long* P, int nP, const long long* ops,
         int begin, int end) {
  int prev = 0, err = (int)cudaGetDevice(&prev), cur = prev;
  if (!err) err = bind_calls(m, P, nP);
  const int n_ev = (int)m.events.size(), S = (int)m.calls.size();
  auto ok_p = [&](long long i) { return i >= 0 && i < nP; };
  auto device = [&](long long d) {
    if (!err && d != cur) {
      err = (int)cudaSetDevice((int)d);
      cur = (int)d;
    }
  };
  for (int i = begin; !err && i < end; ++i) {
    const long long* o = ops + (size_t)i * OP_WIDTH;
    switch (o[0]) {
      case OP_RECORD:
        if (o[1] < 0 || o[1] >= n_ev || !ok_p(o[2])) {
          err = (int)cudaErrorInvalidValue;
          break;
        }
        device(o[3]);
        if (!err)
          err = (int)cudaEventRecord(m.events[o[1]],
                                     at<CUstream_st>(P, (int)o[2]));
        break;
      case OP_WAIT:
        if (!ok_p(o[1]) || o[2] < 0 || o[2] >= n_ev) {
          err = (int)cudaErrorInvalidValue;
          break;
        }
        device(o[3]);
        if (!err)
          err = (int)cudaStreamWaitEvent(at<CUstream_st>(P, (int)o[1]),
                                         m.events[o[2]], 0);
        break;
      case OP_COPY: {
        if (!ok_p(o[1]) || !ok_p(o[3]) || !ok_p(o[5]) || o[7] < 0) {
          err = (int)cudaErrorInvalidValue;
          break;
        }
        device(o[2]);
        if (err) break;
        cudaStream_t st = at<CUstream_st>(P, (int)o[1]);
        void* dst = at<void>(P, (int)o[3]);
        const void* src = at<const void>(P, (int)o[5]);
        err = o[4] == o[6]
                  ? (int)cudaMemcpyAsync(dst, src, (size_t)o[7],
                                         cudaMemcpyDeviceToDevice, st)
                  : (int)cudaMemcpyPeerAsync(dst, (int)o[4], src, (int)o[6],
                                             (size_t)o[7], st);
        break;
      }
      case OP_ZERO:
        if (!ok_p(o[1]) || !ok_p(o[3]) || o[4] < 0) {
          err = (int)cudaErrorInvalidValue;
          break;
        }
        device(o[2]);
        if (!err)
          err = (int)cudaMemsetAsync(at<void>(P, (int)o[3]), 0, (size_t)o[4],
                                     at<CUstream_st>(P, (int)o[1]));
        break;
      case OP_LAUNCH:
        if (o[1] < 0 || o[1] >= S) {
          err = (int)cudaErrorInvalidValue;
          break;
        }
        device(m.calls[o[1]].device);
        if (!err) err = launch_block(m.calls[o[1]], (int)o[2], (int)o[3]);
        break;
      case OP_READD:
        device(m.readd.device);
        if (!err) err = readd::launch(m.readd, (int)o[1]);
        break;
      default:
        err = (int)cudaErrorInvalidValue;
    }
  }
  if (cur != prev) {
    const int e2 = (int)cudaSetDevice(prev);
    if (!err) err = e2;
  }
  return err;
}

}  // namespace

extern "C" {

// The table layout the caller builds: {OP_WIDTH, N_FIELDS, N_RFIELDS}.
void mesh_plan_layout(int* out) {
  out[0] = OP_WIDTH;
  out[1] = N_FIELDS;
  out[2] = N_RFIELDS;
}

// A mesh pass's plan: S per-block call records prepared by
// fused_estep_block_prepare (calls: host array of S pointers, copied),
// bind (S x N_FIELDS indices into P), the re-add record from
// frame_readd_prepare and rbind (N_RFIELDS indices), and n_events events
// without timing, event i on device event_device[i]. Writes the plan's
// handle into *plan; returns 0 or a CUDA error (then nothing to free).
int mesh_plan_create(int S, const void* const* calls, const int* bind,
                     const void* readd_call, const int* rbind, int n_events,
                     const int* event_device, void** plan) {
  if (S < 1 || calls == nullptr || bind == nullptr || readd_call == nullptr ||
      rbind == nullptr || n_events < 0 || plan == nullptr)
    return (int)cudaErrorInvalidValue;
  MeshPlan* m = new (std::nothrow) MeshPlan();
  if (m == nullptr) return (int)cudaErrorMemoryAllocation;
  for (int s = 0; s < S; ++s)
    m->calls.push_back(*static_cast<const BlockCall*>(calls[s]));
  m->bind.assign(bind, bind + (size_t)S * N_FIELDS);
  m->readd = *static_cast<const readd::ReaddCall*>(readd_call);
  for (int f = 0; f < N_RFIELDS; ++f) m->rbind[f] = rbind[f];
  int prev = 0, err = (int)cudaGetDevice(&prev);
  for (int i = 0; !err && i < n_events; ++i) {
    cudaEvent_t ev = nullptr;
    err = (int)cudaSetDevice(event_device[i]);
    if (!err)
      err = (int)cudaEventCreateWithFlags(&ev, cudaEventDisableTiming);
    if (!err) m->events.push_back(ev);
  }
  const int e2 = (int)cudaSetDevice(prev);
  if (!err) err = e2;
  if (err) {
    for (cudaEvent_t ev : m->events) cudaEventDestroy(ev);
    delete m;
    return err;
  }
  *plan = m;
  return 0;
}

// Issue ops [begin, end) of the table `ops` (OP_WIDTH int64 words each)
// with values P (nP int64): the calls' bound fields first, then each op on
// its device; the caller's device is restored. The host never waits.
// Returns 0 or the first CUDA error (the rest not issued).
int mesh_plan_run(void* plan, const long long* P, int nP,
                  const long long* ops, int begin, int end) {
  if (plan == nullptr || P == nullptr || ops == nullptr || begin < 0 ||
      end < begin)
    return (int)cudaErrorInvalidValue;
  return walk(*static_cast<MeshPlan*>(plan), P, nP, ops, begin, end);
}

// Free a plan: its events are released once the work recorded on them is
// done. Returns 0 or the first CUDA error.
int mesh_plan_destroy(void* plan) {
  MeshPlan* m = static_cast<MeshPlan*>(plan);
  if (m == nullptr) return 0;
  int err = 0;
  for (cudaEvent_t ev : m->events) {
    const int e = (int)cudaEventDestroy(ev);
    if (!err) err = e;
  }
  delete m;
  return err;
}

}  // extern "C"
