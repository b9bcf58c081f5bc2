#pragma once

// Fused E-step round for Hopper (sm_90a): one persistent cooperative launch
// per round, its products on tensor cores in 3xTF32 (matmul_precision
// "float32") or in one bf16 pass ("default"). The kernel and its
// helpers; fused_estep.cu instantiates the one-launch round (K1, its r
// window, K2) and fused_estep_block.cu the per-block entry of a mesh, in
// 3xTF32, and fused_estep_one.cu / fused_estep_block_one.cu the same in one
// pass: four libraries, each file built by its own nvcc, in parallel.
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
// What bounds the one-pass round (measured by the stamped instantiation,
// TIMED, ops/cuda/round_timing.py; 858k on an H100 at 700 W, 264 CTAs of
// one unit each, two per SM): its blocks' chain, ~32 us a block on the
// earlier schedule of two grid barriers per block, of which the tile phase
// took 23 us (pass 1 alone 12.4 for a unit's 3 tiles: issue and latency of
// 16 warps per SM, not bytes nor tensor-core operations) and the barriers,
// the reduce phase and the ybuf sums ~6.5. The blocks depend on each other
// only through O, E: the diversity weights of block b need block b - 1's
// sums, nothing else does. The schedule below takes the ybuf sums, the
// reduce and one barrier off the CTAs that set the pace (~30 us a block).
//
// Design, and what each choice is for:
//  * One launch per round. `estep_round` is a cooperative kernel whose grid
//    is every CTA that fits on the card at once (occupancy x SMs, at most
//    one per unit: every CTA has a unit in every block, and is resident, so
//    CTAs may wait for each other). It walks the blocks in order with no
//    launch gaps between them.
//  * One wait per block on the chain, split into arrive and wait (arrive,
//    wait_count; Args::sync). After writing a unit's partials a CTA
//    arrives on a counter and goes on without waiting. The CTAs whose units
//    have the fewest tiles (yrank: at 858k 88 of 264, two tiles against
//    three), which arrive ~7 us early, reduce the block: they wait for
//    every unit, each writes its share of the slots' cache design columns
//    and of bsum (in ascending unit, then slot order, as one reduce phase
//    between two grid barriers would), and arrives on a second counter;
//    every CTA waits on that one before the next block's prologue. The
//    CTAs that are the chain wait once, and the reduce runs where there
//    was slack. (Measured against the last unit of a slot and the last slot
//    reducing, each behind an integer ticket: 4.2 + 6.6 us a block on the
//    chain's own CTA, against 4.1 for two grid barriers and the reduce.)
//    Counters only grow: each launch counts from the values the previous
//    one recorded at its end (its last CTA to end writes them), so no
//    launch clears the buffer and none needs a value from the host.
//  * Between its arrival and its wait a CTA does what does not depend on
//    the block's sums: the next block's first two tiles in flight
//    (cp.async) and its S tile cleared; the reducing CTAs also the
//    previous block's ybuf rows and, after their share of the reduce, their
//    slots' kbuf. Partials of S are kept by block mod 3 and of (kerr, ent)
//    by block parity, so that a block's late readers never meet the next
//    blocks' writers. (Also measured, and not kept: computing dist and s
//    of the next block's first tile in that window, s kept in 28 KB of
//    shared memory. It took 0.9 us off pass 1 but the chain's CTAs wait
//    only ~3.5 us after arriving, and the round ran 0.632 ms against 0.616
//    without it, with a 4-byte spill, in one call.)
//  * Static work split. A slot's chunk is cut into 64-cell tiles; unit
//    u = (slot u / ng, run u % ng), run i covering tiles
//    [i T / ng, (i+1) T / ng). `ng` comes from the shape and the SM count
//    only (ops/cuda/fused_estep.py, `kernel_geometry`), so K1, its r window
//    and K2 sum in the same order whatever each instantiation's occupancy.
//    CTA c runs units c, c + grid, ... and writes one partial of S and of
//    (kerr, ent) per unit.
//  * The slab arrives through a two-stage ring: the next tile's
//    (1+B+d, 64) slab is copied with 16-byte cp.async (zero-filled past CH)
//    while the CTA computes on the current one; a CTA's first two tiles of
//    the next block are fetched before it waits (the tile wait measured
//    1.5 us a block before, so no TMA).
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
//  * K2's store is packed: two adjacent cells of one cluster per float2,
//    or per __nv_bfloat162 rounded to nearest even (__floats2bfloat162_rn,
//    as torch's .to(bfloat16) rounds).
//  * One pass (ONE, matmul_precision="default", as the JAX package runs its
//    products on the TPU: single-pass bf16 inputs, fp32 accumulation): the
//    three products run as mma.m16n8k16 bf16 with fp32 accumulators, each
//    operand rounded to nearest even once (Y^T and wdiv when they are
//    staged, in bf16 A-fragment order: no lo halves, one 16-byte load per
//    fragment; the slab and r as their fragments are packed, two k-adjacent
//    values per register: two slab rows of one cell for dist and w, two
//    cells of one r row for S). Everything else is the 3xTF32 variant's:
//    r, dist, the softmax and every statistic stay fp32, and r is rounded
//    only as the A operand of S, as the TPU rounds r for its single-pass
//    dot. The k16 steps pad d to 16 (29 -> 32) and the B+1 design rows to
//    16. One pass does a third of the 3xTF32 tensor-core work: the round's
//    bound at 858k is then its bytes (~0.036 ms), not its operations; what
//    holds it is its chain (above).
// The per-block entry (fused_estep_block_launch: K1, its r window or K2 on
// one block of the tables; the FOLD instantiations) is what a mesh runs,
// one launch per shard per block, returning the block-removed O, E and the
// slots' cache rows. The re-add of block b - 1 across shards is folded into
// block b's prologue: every CTA of every shard forms the block's start from
// the previous block's block-removed O', E' and every shard's rows of it
// (frame_sum.cuh, the order and roundings of csrc/frame_readd.cuh), as the
// one-launch round re-adds a block in the next block's prologue and the TPU
// kernel in-grid (:215-221); the re-add kernel runs once per pass, after
// the last block. Rows, O' and E' are double-buffered by block parity: a
// launch writes its block's while other shards' launches, and its own
// CTAs, may still read the previous block's. A shard's block is small (7
// slots x 12 units at 858k on 4 shards: ~12k cells, 0.16 GFLOP, a 2.4 us
// bound), so the launch has one CTA per unit and no grid barrier: each CTA
// runs its unit's tiles as above, then the slot's unit partials are summed
// in ascending unit order, as the round sums them. Each slot's ng units
// are one thread-block cluster (up to CLUSTER_MAX): every CTA keeps its
// partial in shared memory and, after a cluster barrier, sums a share of
// the slot's entries over distributed shared memory (cluster_tail). (The
// earlier tail, kept for ng > CLUSTER_MAX: the last unit of a slot to
// finish, found by an integer ticket, summed all of them from L2 on one
// CTA, block_tail; at 858k 20 of the launch's 42 us, measured by the
// stamped entry, ops/cuda/block_timing.py.) `ng` comes from the one-device
// slots per block (kernel_geometry's J_glob), so a shard's chunks are
// split into units, and summed, as the one-device round splits them: the
// rows are the round's bitwise.
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

#include "frame_sum.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int TILE = 8 * WARPS;   // cells per tile: 8 per warp
constexpr int PT = TILE + 4;      // row pitch of the slab ring and r stage
constexpr int KSC = 4;            // dist k-steps unrolled, B kept in registers
constexpr int KSC1 = 2;           // ... of 16 in one pass (the same 32 rows)
constexpr int NRG_MAX = 8;        // S n-tiles per A fragment, at most
constexpr int FOLD_RQ = 24;       // frame ranks loaded ahead for a prologue
constexpr float CLAMP = 1e-8f;
constexpr size_t MAX_SMEM = 232448;
// TIMED instantiations (a library of their own, fused_estep_timed.cu): clock64
// stamps per block and CTA, NST each; tiles of the CTA's first unit of a
// block are stamped up to MAXT (ST_TILE + 4 i + {ready, pass 1, pass 2, S}).
constexpr int NST = 24;
constexpr int MAXT = 4;
enum {
  ST_START = 0, ST_WAIT = 1, ST_PRO = 2, ST_TILE = 3,
  ST_PART = ST_TILE + 4 * MAXT, ST_ARRIVE, ST_WINDOW, ST_UNITS, ST_REDUCE
};
// FOLD (the per-block entry, nb 1): the same NST stamps of its one block,
// named BLOCK_STAMP_NAMES: setup (the shared memory cleared, Y^T's
// fragments, sigma), the fold's frame sums, the prologue, the tiles and
// the partial as above, then the wait for the slot's other units and the
// slot's sums where the CTA does them: kbuf, cache and brows, ybuf on the
// ticket's last unit; in a cluster (cluster_tail) the CTA's share of them
// and rank 0's kbuf (SB_YBUF).
enum { SB_SETUP = ST_START, SB_FOLD = ST_WAIT, SB_SLOT = ST_ARRIVE,
       SB_KBUF, SB_CACHE, SB_YBUF };
// One-launch round: the words of Args::sync.
enum { SY_UNITS, SY_REDUCED, SY_EXITS, SY_GEN, SY_WORDS = SY_GEN + 3 };
// One-launch round: copies of the unit partials of S (by block mod NPART)
// and of (kerr, ent) (by block parity); see the schedule below.
constexpr int NPART = 3;

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
  float* part;           // (NPART, J*ng, K, R) per-unit partials of S, by
                         // block mod NPART (one block alone: one copy)
  float* kpart;          // (2, J*ng, 2) per-unit partials of (kerr, ent),
                         // by block parity (one block alone: one copy)
  float* bsum;           // (K, B+1)     a block's stats over its slots
  float* cache;          // (nc1, K, B+1)
  float* ybuf;           // (nc1, K, d)
  float* kbuf;           // (nc1, 2)
  float* O1;             // (K, B) O, E at the end of the round; one
  float* E1;             // block alone: the block-removed O, E
  void* rw;              // (width, K, CH) float or bf16 (RT), or null
  unsigned long long* stamps;  // TIMED: (nb, grid, NST) clock64, then per
                               // CTA globaltimer and clock64 at its start
                               // and end (grid, 4); else null
  unsigned* sync;        // one-launch round: (SY_WORDS) three counters
                         // that only grow (units that wrote their partials,
                         // reducing CTAs done, CTAs done), then their
                         // values when the last launch ended: the
                         // generation this launch counts from; else null
  float* wide;           // the wide plan (layout_wide, layout_codes):
                         // (wide_ctas, gtotal) per-CTA scratch; else null
  int wide_ctas;
  const int* codes;      // the codes plan: (nc1, CH) each cell's batch
                         // level, -1 for padding; else null
  int* tickets;          // (J) one block alone (per-block mode), else null:
                         // units of each slot done, back to 0 at the end
  float* brows;          // (J, K, B+1) per-block mode: the slots' cache
                         // rows in slot order
  // FOLD with readd: O0, E0 are the previous block's block-removed O', E'
  // and the block starts from them plus its frame: rank r's row at
  // frame + src[r] * K * (B+1) (every shard's rows stacked, shard-major).
  const float* frame;
  const int* src;        // (J_fix) rank codes of the previous block
  int J_fix, readd;
  int lo, width;
  int K, B, d, CH, nb, J, ng, nc1, fast_ent;
};

// Padded sizes and the shared-memory plan (offsets in floats). Padding
// rows and columns hold zeros, so every fragment loop runs its full
// compile-time length without guards.
struct Lay {
  int B1, R, Kp, KS, KSR, KB, NR, NRG, NRp, RR, PSA, MT;
  bool PRE;  // Y and wdiv stored split (else split at each load); in one
             // pass they are stored once, in bf16 (PRE false)
  int oYh, oYl, oWh, oWl, oSig, oRsig, oOr, oEr, oQ, oRing, oSacc, oCs, oRed,
      total;
  // The wide plan (layout_wide): oWh, oWl, oOr, oEr and oSacc are offsets
  // into the CTA's gtotal floats of global memory, not shared memory.
  int gtotal;
  // The codes plan (layout_codes): in shared memory the two ring stages'
  // codes (TILE ints each), the tile's levels (oLev: TILE levels, TILE
  // first-touch flags, their count) and each level's last unit (oSeen);
  // the diversity weights by (level, cluster) at oWd, in shared memory
  // where they fit (WSM), else in the scratch; S's design columns by
  // (level, cluster) at oSd of the scratch, as are oOr and oEr.
  int oCode, oLev, oSeen, oWd, oSd;
  bool WSM;
  // The codes plan's region shared by the launch's CTAs (after the
  // wide_ctas per-CTA scratches): by block parity, pstride floats each,
  // O' and E' at oOr and oEr, the diversity weights' table at oPW.
  int pstride, oPW, gshared;
};

__host__ __device__ inline int up4(int x) { return (x + 3) & ~3; }
__host__ __device__ inline int up8(int x) { return (x + 7) & ~7; }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The padded sizes of (K, B, d) common to both plans, S run in n-tile
// groups of at most nrg_max.
template <bool ONE>
__host__ __device__ inline void lay_dims(Lay& L, int K, int B, int d,
                                     int nrg_max) {
  L.B1 = B + 1;
  L.R = 1 + B + d;
  L.Kp = (K + 15) & ~15;           // rows of dist, the r stage and S
  L.MT = L.Kp / 16;
  if (ONE) {
    L.KS = cdiv(d, 16);
    L.KSR = L.KS > KSC1 ? L.KS : KSC1;
    L.KB = cdiv(L.B1, 16);
  } else {
    L.KS = up8(d) / 8;               // dist k-steps over d
    L.KSR = L.KS > KSC ? L.KS : KSC;  // ... at least the KSC unrolled ones
    L.KB = cdiv(L.B1, 8);            // w k-steps over the design rows
  }
  L.NR = up8(L.R) / 8;             // S n-tiles over [mask; Phi; Z]
  L.NRG = L.NR < nrg_max ? L.NR : nrg_max;
  L.NRp = cdiv(L.NR, L.NRG) * L.NRG;
  const int dist_rows = L.B1 + (ONE ? 16 : 8) * L.KSR, s_rows = 8 * L.NRp;
  L.RR = up8(dist_rows > s_rows ? dist_rows : s_rows);  // ring rows
  // Pitch = 8 or 24 mod 32 words: conflict-free float2 accumulator access.
  L.PSA = 8 * L.NRp + ((L.NRp & 1) ? 0 : 8);
  L.gtotal = 0;
  L.oCode = L.oLev = L.oSeen = L.oWd = L.oSd = 0;
  L.WSM = false;
  L.pstride = L.oPW = L.gshared = 0;
}

// ONE: the one-pass variant's plan, whose k-steps are 16 deep (KS, KSR,
// KB count them) and whose Y^T and wdiv fragments hold bf16: a fragment's
// 256 values take the 128 floats of a TF32 one.
template <bool ONE = false>
__host__ __device__ inline Lay layout(int K, int B, int d) {
  Lay L;
  lay_dims<ONE>(L, K, B, d, NRG_MAX);
  const int kb = K * B;
  // Y and wdiv are kept split (hi and lo) where that fits, else whole.
  for (int pre = ONE ? 0 : 1; pre >= 0; --pre) {
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

// The wide plan, for designs whose plan above exceeds a CTA's shared
// memory (at d = 50, K = 100 from B = 50 on; B = 486 needs 1.1 MB there:
// O and E alone 2 x 194 KB). O', E', the diversity weights' A fragments
// and the S accumulator move to gtotal floats of global memory per CTA
// (Args::wide; ~0.76 MB at B = 486, read back from L2); shared memory
// keeps Y^T, sigma, the r stage and one ring stage of the (1+B+d, 64)
// slab tile, whose next tile is copied after the current one's S product
// (two stages do not fit: one is 157 KB at B = 486). Y^T and wdiv are
// split at each load (PRE false) and S runs NRG_MAX n-tiles per A
// fragment. The arithmetic and every sum's order are the plan above's.
template <bool ONE = false>
__host__ __device__ inline Lay layout_wide(int K, int B, int d) {
  Lay L;
  lay_dims<ONE>(L, K, B, d, NRG_MAX);
  L.PRE = false;
  int o = 0;
  L.oYh = L.oYl = o; o += L.MT * L.KSR * 128;
  L.oSig = o; o += up4(L.Kp);
  L.oRsig = o; o += up4(L.Kp);
  L.oQ = o; o += L.Kp * PT;
  L.oRing = o; o += L.RR * PT;
  L.oCs = o; o += TILE;
  L.oRed = o; o += THREADS;
  L.total = o;
  const int kb = K * B;
  int g = 0;
  L.oOr = g; g += up4(kb);
  L.oEr = g; g += up4(kb);
  L.oWh = L.oWl = g; g += L.MT * L.KB * 128;
  L.oSacc = g; g += up4(L.Kp * L.PSA);
  L.gtotal = g;
  return L;
}

// The codes plan, the wide plan of a one-covariate design: the round reads
// each cell's batch level (Args::codes, -1 for padding) instead of its B
// design rows. A ring stage holds the tile's [mask; Z] rows (1 + d, not 1
// + B + d) and its 64 codes, so two stages fit and the copy overlaps the
// compute again (~20 KB a stage at B = 486, d = 50). w = wdiv Phi is
// wdiv[:, level] as the product's operand holds it (bf16, or the 3xTF32
// split's hi + lo as the mma reads lo), gathered from a (B, Kp) table in
// shared memory where it fits (one pass: 109 KB at B = 486), else in the
// CTA's scratch. S's mask and Z columns are the dense product (shared
// memory, CG n-tiles per A fragment); its design columns are only those
// of the levels the tile holds (at most 64): their columns of the unit's
// (B, Kp) accumulator in the scratch are loaded, run through the same mma
// over the same cells in the same order, with B generated as (code ==
// level), and stored back. A level's first touch in a unit starts from
// zero (oSeen stamps the unit), so the accumulator is never cleared, and
// the unit's partial has zeros for the levels it never held. Each element
// of w and S sees the operands and accumulator it sees in the dense plan
// (a one-hot column adds exact zeros), so the round's bits are the dense
// wide plan's.
// The CTAs share O', E' and the table (by block parity) instead of each
// forming all K x B of them in every prologue: the reducers of block b
// form block b + 1's for their share of the entries (codes_reduce), and a
// CTA's prologue copies the table in from L2; block 0's every CTA forms
// itself. Measured at the donors' round (2.4M cells, B = 486, one pass;
// H100, clock64 per CTA): the prologue 6.0 -> 0.6 Mcycles a launch, the
// launch 13.1 -> 9.3 ms; the reduce's partial reads coalesced (items, not
// slots, along the threads) 9.3 -> 6.5 ms; the dense wide plan 34.2 ms.
constexpr int CG = 4;  // the codes plan's S n-tiles per A fragment

template <bool ONE = false>
__host__ __device__ inline Lay layout_codes(int K, int B, int d) {
  Lay L;
  lay_dims<ONE>(L, K, B, d, CG);
  L.PRE = false;
  L.KB = 0;
  L.NR = up8(1 + d) / 8;           // S's dense n-tiles: [mask; Z]
  L.NRG = CG;
  L.NRp = cdiv(L.NR, CG) * CG;
  const int dist_rows = 1 + (ONE ? 16 : 8) * L.KSR, s_rows = 8 * L.NRp;
  L.RR = up8(dist_rows > s_rows ? dist_rows : s_rows);
  L.PSA = 8 * L.NRp + ((L.NRp & 1) ? 0 : 8);
  int o = 0;
  L.oYh = L.oYl = o; o += L.MT * L.KSR * 128;
  L.oSig = o; o += up4(L.Kp);
  L.oRsig = o; o += up4(L.Kp);
  L.oQ = o; o += L.Kp * PT;
  L.oRing = o; o += 2 * L.RR * PT;
  L.oSacc = o; o += up4(L.Kp * L.PSA);
  L.oCs = o; o += TILE;
  L.oRed = o; o += THREADS;
  L.oCode = o; o += 2 * TILE;
  L.oLev = o; o += 2 * TILE + 4;
  L.oSeen = o; o += up4(B);
  const int wd = up4(ONE ? B * L.Kp / 2 : B * L.Kp);
  L.WSM = sizeof(float) * (size_t)(o + wd) <= MAX_SMEM;
  int g = 0;
  L.oSd = g; g += up4(B * L.Kp);
  // The CTA's table (block 0's its own, later ones copied in): in shared
  // memory, or here.
  if (L.WSM) {
    L.oWd = o; o += wd;
  } else {
    L.oWd = g; g += wd;
  }
  L.oOr = 0;
  L.oEr = up4(K * B);
  L.oPW = 2 * up4(K * B);
  L.pstride = L.oPW + wd;
  L.gshared = 2 * L.pstride;
  L.oWh = L.oWl = 0;
  L.total = o;
  L.gtotal = g;
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

// One pass: d += a b, bf16 operands (two per register, the lower k index in
// the low half), fp32 accumulators in the layout of mma's.
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two values rounded to bf16 (nearest even) in one register, lo first.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack2(float2 v) {
  return pack2(v.x, v.y);
}

// B fragment (8 slab rows x 8 cells): p points at row `row0` of a ring
// stage, column = the warp's first cell.
__device__ __forceinline__ void load_b_slab(const float* p, int t, int g,
                                            float (&bh)[2], float (&bl)[2]) {
  split(p[t * PT + g], bh[0], bl[0]);
  split(p[(t + 4) * PT + g], bh[1], bl[1]);
}

// One pass: B fragment (16 slab rows x 8 cells) from row `row0` of a ring
// stage at p, column = the warp's first cell: rows 2t, 2t+1 and 2t+8, 2t+9
// of cell g.
__device__ __forceinline__ void load_b16_slab(const float* p, int t, int g,
                                              uint32_t (&b)[2]) {
  b[0] = pack2(p[2 * t * PT + g], p[(2 * t + 1) * PT + g]);
  b[1] = pack2(p[(2 * t + 8) * PT + g], p[(2 * t + 9) * PT + g]);
}

// One pass: A fragment f (16 clusters x 16 rows) of a bf16 operand stored
// in fragment order, one 16-byte load per lane.
__device__ __forceinline__ void load_a16(const float* H, int f, int lane,
                                         uint32_t (&a)[4]) {
  const uint4 v = reinterpret_cast<const uint4*>(H)[f * 32 + lane];
  a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
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

// One pass: offset in bf16 values of entry (row, col) of a 16 x 16 A tile
// in fragment order: lane (row & 7) * 4 + (col & 7) / 2 holds 8 values,
// register (row >> 3) + 2 (col >> 3), the even column in its low half.
__device__ __forceinline__ int frag_pos16(int row, int col) {
  const int lane = (row & 7) * 4 + ((col & 7) >> 1);
  return lane * 8 + 2 * ((row >> 3) + 2 * (col >> 3)) + (col & 1);
}

// One pass: store entry (row, col) of tile f of a bf16 fragment-ordered
// operand, rounded to nearest even.
__device__ __forceinline__ void put_frag16(float* H, int f, int row, int col,
                                           float v) {
  reinterpret_cast<__nv_bfloat16*>(H)[f * 256 + frag_pos16(row, col)] =
      __float2bfloat16_rn(v);
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

// block_sum of two values at once (the same tree, so the same bits), over
// a scratch of THREADS float2.
__device__ float2 block_sum2(float x, float y, float2* red) {
  const int tid = threadIdx.x;
  __syncthreads();
  red[tid] = make_float2(x, y);
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) {
      const float2 p = red[tid], q = red[tid + s];
      red[tid] = make_float2(__fadd_rn(p.x, q.x), __fadd_rn(p.y, q.y));
    }
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

// TIMED: stamp i of block blk for this CTA (thread 0; after a barrier, so
// the whole CTA has passed the point).
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
template <bool TIMED>
__device__ __forceinline__ void stamp(const Args& a, int blk, int i) {
  if constexpr (TIMED) {
    if (threadIdx.x == 0)
      a.stamps[((size_t)blk * gridDim.x + blockIdx.x) * NST + i] = clock64();
  }
}
// TIMED: globaltimer and clock64 at the CTA's start (end 0) or end (1), which
// convert its clock64 stamps to time.
template <bool TIMED>
__device__ __forceinline__ void stamp_span(const Args& a, int end) {
  if constexpr (TIMED) {
    if (threadIdx.x == 0) {
      unsigned long long* p = a.stamps + (size_t)a.nb * gridDim.x * NST +
                              4 * blockIdx.x + 2 * end;
      p[0] = global_ns();
      p[1] = clock64();
    }
  }
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

// The codes plan: the tile's [mask; Z] rows (rows 0 and B1.. of the slab)
// into rows 0..d of a ring stage and its TILE codes into cst; past CH the
// rows are zero-filled and the codes read as padding (tile_code).
__device__ __forceinline__ void issue_tile_codes(const Args& a, const Lay& L,
                                                 float* stage, int* cst,
                                                 int slot, int c0) {
  const float* src = a.zp3 + (size_t)slot * L.R * a.CH;
  const int* csrc = a.codes + (size_t)slot * a.CH;
  const int rows = 1 + a.d;
  for (int i = threadIdx.x; i < (rows + 1) * (TILE / 4); i += THREADS) {
    const int x = i / (TILE / 4), q = i % (TILE / 4);
    const int c = c0 + 4 * q;
    const bool in = c < a.CH;
    if (x < rows) {
      const int row = x == 0 ? 0 : L.B1 + x - 1;
      cp16(stage + x * PT + 4 * q, src + (size_t)row * a.CH + (in ? c : 0),
           in ? 16 : 0);
    } else {
      cp16(reinterpret_cast<float*>(cst + 4 * q),
           reinterpret_cast<const float*>(csrc + (in ? c : 0)), in ? 16 : 0);
    }
  }
}

// The codes plan: the level of cell i of the tile at c0 (-1 past CH).
__device__ __forceinline__ int tile_code(const int* cst, int c0, int i,
                                         int CH) {
  return c0 + i < CH ? cst[i] : -1;
}

// The codes plan, warp 0 of a tile: the distinct levels of its 64 cells in
// order of first occurrence into lev[0, n) (lev[TILE + j]: whether the
// unit stamped `us` touches level lev[j] first here), lev[n, TILE) -2 (no
// cell's), lev[2 TILE] = n; each level's stamp set to us.
__device__ __forceinline__ void tile_levels(const int* cst, int c0, int CH,
                                            int* lev, int* seen, int us,
                                            int lane) {
  const unsigned full = 0xffffffffu, lt = (1u << lane) - 1u;
  const int x = tile_code(cst, c0, lane, CH);
  const int y = tile_code(cst, c0, 32 + lane, CH);
  const unsigned mx = __match_any_sync(full, x);
  const unsigned my = __match_any_sync(full, y);
  const bool fx = x >= 0 && !(mx & lt);
  bool fy = y >= 0 && !(my & lt);
  for (int l = 0; l < 32; ++l) {
    const int v = __shfl_sync(full, x, l);
    fy = fy && v != y;
  }
  const unsigned bx = __ballot_sync(full, fx), by = __ballot_sync(full, fy);
  const int nx = __popc(bx), n = nx + __popc(by);
  if (fx) {
    const int j = __popc(bx & lt);
    lev[j] = x;
    lev[TILE + j] = seen[x] != us;
    seen[x] = us;
  }
  if (fy) {
    const int j = nx + __popc(by & lt);
    lev[j] = y;
    lev[TILE + j] = seen[y] != us;
    seen[y] = us;
  }
  for (int j = n + lane; j < TILE; j += 32) lev[j] = -2;
  if (lane == 0) lev[2 * TILE] = n;
}

// Data written by other CTAs in this launch (partials, block sums) is read
// with __ldcg, from L2, after the counter (the round) or ticket (the
// per-block entry) that orders it.

// Sum of slot j's unit partials at offset i of a (K, R) partial, in
// ascending unit order: the value the reduce phase writes to cache/ybuf.
// The loads go out in batches of 16, then are added in order.
__device__ __forceinline__ float slot_sum(const Args& a, size_t KR, int blk,
                                          int j, size_t i) {
  const float* P =
      a.part + ((size_t)(blk % NPART) * a.J * a.ng + (size_t)j * a.ng) * KR +
      i;
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
// ascending unit order, spread over the grid. The round runs it after the
// CTA's arrival in block blk + 1, before it waits for that block's sums
// (block blk + 3 overwrites these partials, and starts only after every CTA
// has arrived in block blk + 2).
// rank: this CTA's place among the n CTAs that share them (negative: none).
__device__ void ybuf_share(const Args& a, const Lay& L, int blk, int rank,
                           int n) {
  const int K = a.K, B1 = L.B1, R = L.R, d = a.d;
  const size_t KR = (size_t)K * R, Kd = (size_t)K * d;
  if (rank < 0) return;
  for (size_t e = (size_t)rank * THREADS + threadIdx.x;
       e < (size_t)a.J * Kd; e += (size_t)n * THREADS) {
    const int j = (int)(e / Kd), i = (int)(e % Kd);
    const int slot = a.slots[(size_t)blk * a.J + j];
    a.ybuf[(size_t)slot * Kd + i] =
        slot_sum(a, KR, blk, j, (size_t)(i / d) * R + B1 + i % d);
  }
}

// kbuf of slot j of block blk: the kerr and entropy partials of its units
// in ascending unit order, and under the fast objective the O-term
// sum_kb sigma_k theta_b logratio_kb O_chunk[k, b] from the block-removed
// O/E (at big: sm, or the wide plan's global scratch; L2: the codes
// plan's region other CTAs wrote, read from L2) and the slot's stats.
// Every thread of the CTA takes part.
template <bool L2 = false>
__device__ void slot_kbuf(const Args& a, const Lay& L, int blk, int j,
                          const float* sm, const float* big) {
  const int K = a.K, B = a.B, R = L.R;
  const int tid = threadIdx.x, lane = tid & 31;
  const size_t KR = (size_t)K * R;
  const float* sig = sm + L.oSig;
  const float* Or = big + L.oOr;
  const float* Er = big + L.oEr;
  float* red = const_cast<float*>(sm) + L.oRed;
  // One unit per lane; thread 0 holds the sums.
  float kerr = 0.0f, second = 0.0f;
  if (tid < 32) {
    for (int q0 = 0; q0 < a.ng; q0 += 32) {
      const int q = q0 + lane;
      const float* kp =
          a.kpart + (((size_t)(blk & 1) * a.J + j) * a.ng + q) * 2;
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
      const float o = L2 ? __ldcg(Or + i) : Or[i];
      const float e = L2 ? __ldcg(Er + i) : Er[i];
      const float coef =
          __fmul_rn(__fmul_rn(sig[k], a.theta[b]), log_ratio(o, e));
      v = fmaf(coef, slot_sum(a, KR, blk, j, (size_t)k * R + 1 + b), v);
    }
    const float stv = block_sum(v, red);
    ent = __fsub_rn(__fadd_rn(-kerr, stv), second);
  }
  if (tid == 0) {
    const int slot = a.slots[(size_t)blk * a.J + j];
    a.kbuf[(size_t)slot * 2] = kerr;
    a.kbuf[(size_t)slot * 2 + 1] = ent;
  }
}

// One-launch round: the counters of a.sync. A CTA arrives with
// red.release.gpu from thread 0 after a CTA barrier (its threads' writes
// are published with it), and waits by polling with ld.acquire.gpu from
// thread 0 before a CTA barrier (then __ldcg for the data the counter
// orders). Counts only grow; they are compared modulo 2^32. (Measured
// against __threadfence around relaxed accesses: the wait for a block's
// sums 2.8 against 3.4 us, the round 0.611 against 0.624 ms, one call.)
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Wait until counter *c reaches `target`; then every thread of the CTA may
// read, from L2, what was written before the arrivals it counts.
__device__ __forceinline__ void wait_count(const unsigned* c,
                                           unsigned target) {
  if (threadIdx.x == 0) {
    while ((int)(ld_acquire(c) - target) < 0) {
    }
  }
  __syncthreads();
}

// Arrive on counter *c once the CTA's writes are done (every thread).
__device__ __forceinline__ void arrive(unsigned* c) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(c)
                 : "memory");
}

// The share of block blk's reduce done by the `rank`-th of the n reducing
// CTAs, once every unit of the block has written its partials: the design
// columns of each slot's cache row (its unit partials in ascending unit
// order) and bsum (K, B+1), those summed over the slots in ascending slot
// order, for the CTA's entries, in rounds that fit the scratch `ss` (the S
// tile, cleared after): the slot sums of each (entry, slot) in parallel,
// then one thread per entry adds its slots in order. The ybuf columns:
// ybuf_share; kbuf: slot_kbuf. The next block's prologue adds bsum back
// into O/E.
__device__ void reduce_share(const Args& a, const Lay& L, int blk, int rank,
                             int n, float* ss) {
  const int K = a.K, B1 = L.B1, R = L.R, J = a.J;
  const int tid = threadIdx.x;
  const size_t KR = (size_t)K * R;
  const int* slots = a.slots + (size_t)blk * J;
  const int nkb = K * B1;
  const int per = (nkb + n - 1) / n;
  const int ib = rank * per, ie = min(nkb, ib + per);
  const int cap = min(per, (L.Kp * L.PSA) / J);
  if (cap > 0) {
    for (int r0 = ib; r0 < ie; r0 += cap) {
      const int m = min(cap, ie - r0);
      __syncthreads();
      for (int x = tid; x < m * J; x += THREADS) {
        const int item = r0 + x / J, j = x % J;
        ss[x] = slot_sum(a, KR, blk, j, (size_t)(item / B1) * R + item % B1);
        a.cache[(size_t)slots[j] * nkb + item] = ss[x];
      }
      __syncthreads();
      for (int it = tid; it < m; it += THREADS) {
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

// The codes plan: entry idx of a diversity weights' table, as the dense
// product's operand holds wd: bf16, or the 3xTF32 split's hi plus lo as
// the mma reads it (lo's TF32 bits).
template <bool ONE>
__device__ __forceinline__ void put_wd(float* tab, int idx, float wd) {
  if constexpr (ONE) {
    reinterpret_cast<__nv_bfloat16*>(tab)[idx] = __float2bfloat16_rn(wd);
  } else {
    float hi, lo;
    split(wd, hi, lo);
    tab[idx] = __fadd_rn(hi, __uint_as_float(__float_as_uint(lo) &
                                             0xffffe000u));
  }
}

// The codes plan's share of block blk's reduce: reduce_share's values (the
// slots' cache design columns and bsum of items [ib, ie) of (K, B+1), each
// sum in reduce_share's order), with RQ slot sums per thread in flight and
// consecutive threads on consecutive items (coalesced partial reads);
// then, for the share's (k, b) entries, what every CTA's prologue computed
// in the dense plans: the next block's O', E' (the block-removed O, E) and
// diversity weights into the shared region's other parity (shb: its
// start), or, after the last block, the round's O, E into O1, E1. The
// mask column bsum[k, 0] of each of the share's rows is summed again by a
// warp, in the same order. ss: the S tile as scratch; Q: the r stage.
constexpr int RQ = 4;  // slot sums in flight per thread
constexpr int UQ = 4;  // ... each over UQ units' loads at a time

template <bool ONE>
__device__ void codes_reduce(const Args& a, const Lay& L, int blk, int rank,
                             int n, float* ss, float* Q, float* shb) {
  const int K = a.K, B = a.B, B1 = L.B1, R = L.R, J = a.J, ng = a.ng;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const size_t KR = (size_t)K * R;
  const int* slots = a.slots + (size_t)blk * J;
  const int nkb = K * B1;
  const int per = (nkb + n - 1) / n;
  const int ib = rank * per, ie = min(nkb, ib + per);
  if (ib >= ie) return;
  const float* part = a.part + (size_t)(blk % NPART) * J * ng * KR;
  const int cap = max(1, min(per, (L.Kp * L.PSA) / J));
  for (int r0 = ib; r0 < ie; r0 += cap) {
    const int m = min(cap, ie - r0);
    __syncthreads();
    for (int x0 = tid; x0 < m * J; x0 += RQ * THREADS) {
      const float* p[RQ];
      float s[RQ];
#pragma unroll
      for (int q = 0; q < RQ; ++q) {
        const int x = min(x0 + q * THREADS, m * J - 1);
        const int item = r0 + x % m, j = x / m;
        p[q] = part + (size_t)j * ng * KR + (size_t)(item / B1) * R +
               item % B1;
        s[q] = 0.0f;
      }
      for (int u0 = 0; u0 < ng; u0 += UQ) {
        float v[RQ][UQ];
#pragma unroll
        for (int q = 0; q < RQ; ++q)
#pragma unroll
          for (int u = 0; u < UQ; ++u)
            v[q][u] = u0 + u < ng ? __ldcg(p[q] + (size_t)(u0 + u) * KR)
                                  : 0.0f;
#pragma unroll
        for (int q = 0; q < RQ; ++q)
#pragma unroll
          for (int u = 0; u < UQ; ++u)
            if (u0 + u < ng) s[q] = __fadd_rn(s[q], v[q][u]);
      }
#pragma unroll
      for (int q = 0; q < RQ; ++q) {
        const int x = x0 + q * THREADS;
        if (x < m * J) {
          const int it = x % m, j = x / m;
          ss[it * J + j] = s[q];
          a.cache[(size_t)slots[j] * nkb + r0 + it] = s[q];
        }
      }
    }
    __syncthreads();
    for (int it = tid; it < m; it += THREADS) {
      float acc = 0.0f;
      for (int j = 0; j < J; ++j) acc = __fadd_rn(acc, ss[it * J + j]);
      a.bsum[r0 + it] = acc;
    }
  }
  // bsum[k, 0] of the share's rows, into Q[k]: a warp per row, its lanes'
  // slot sums added in ascending slot order.
  const int k0 = ib / B1, k1 = (ie - 1) / B1;
  for (int k = k0 + w; k <= k1; k += WARPS) {
    float acc = 0.0f;
    for (int j0 = 0; j0 < J; j0 += 32) {
      const float v = j0 + lane < J
                          ? slot_sum(a, KR, blk, j0 + lane, (size_t)k * R)
                          : 0.0f;
      acc = lane_sum(acc, v, min(32, J - j0));
    }
    if (lane == 0) Q[k] = acc;
  }
  __syncthreads();
  const float* cur = shb + (size_t)(blk & 1) * L.pstride;
  float* nxt = shb + (size_t)((blk + 1) & 1) * L.pstride;
  const bool last = blk + 1 == a.nb;
  const float* rem = a.removal + (size_t)(blk + 1) * K * B1;
  for (int item = ib + tid; item < ie; item += THREADS) {
    const int k = item / B1, col = item % B1;
    if (col == 0) continue;
    const int b = col - 1, i = k * B + b;
    float E = __fadd_rn(__ldcg(cur + L.oEr + i), __fmul_rn(Q[k], a.prb[b]));
    float O = __fadd_rn(__ldcg(cur + L.oOr + i), __ldcg(a.bsum + item));
    if (last) {
      a.E1[i] = E;
      a.O1[i] = O;
    } else {
      const float* rk = rem + (size_t)k * B1;
      E = __fsub_rn(E, __fmul_rn(rk[0], a.prb[b]));
      O = __fsub_rn(O, rk[col]);
      nxt[L.oEr + i] = E;
      nxt[L.oOr + i] = O;
      put_wd<ONE>(nxt + L.oPW, b * L.Kp + k,
                  expf(__fmul_rn(a.theta[b], log_ratio(O, E))));
    }
  }
}

// Per-block mode, after the CTA's one unit (unit blockIdx.x): CTA 0 writes
// the block-removed O, E; the last CTA to finish among slot j's ng units
// (an integer ticket: the partials are fenced before it, read from L2
// after it) writes the slot's kbuf, cache and ybuf rows, each value its
// unit partials in ascending unit order as the round's reduce phase and
// ybuf_share sum them, and the cache row into brows[j] for the next
// block's prologue (or the pass's last re-add). It resets the ticket, so
// the next launch needs no memset. (Loads batched over several values
// here took registers the tile phase needs: inlined, some instantiations
// spilled and the one-launch round slowed by 4%; out of line, by 33%.)
template <bool TIMED>
__device__ void block_tail(const Args& a, const Lay& L, const float* sm) {
  const int K = a.K, B1 = L.B1, R = L.R, d = a.d, tid = threadIdx.x;
  const int j = blockIdx.x / a.ng;
  if (blockIdx.x == 0) {
    for (int i = tid; i < K * a.B; i += THREADS) {
      a.O1[i] = sm[L.oOr + i];
      a.E1[i] = sm[L.oEr + i];
    }
  }
  __threadfence();
  int last = 0;
  if (tid == 0) last = atomicAdd(a.tickets + j, 1) == a.ng - 1;
  const bool tail = __syncthreads_or(last);
  stamp<TIMED>(a, 0, SB_SLOT);
  if (!tail) return;
  __threadfence();
  if (tid == 0) a.tickets[j] = 0;
  slot_kbuf(a, L, 0, j, sm, sm);
  if constexpr (TIMED) __syncthreads();
  stamp<TIMED>(a, 0, SB_KBUF);
  const size_t KR = (size_t)K * R, Kd = (size_t)K * d, nkb = (size_t)K * B1;
  const int slot = a.slots[j];
  for (int item = tid; item < (int)nkb; item += THREADS) {
    const float v =
        slot_sum(a, KR, 0, j, (size_t)(item / B1) * R + item % B1);
    a.cache[(size_t)slot * nkb + item] = v;
    a.brows[(size_t)j * nkb + item] = v;
  }
  if constexpr (TIMED) __syncthreads();
  stamp<TIMED>(a, 0, SB_CACHE);
  for (int i = tid; i < (int)Kd; i += THREADS)
    a.ybuf[(size_t)slot * Kd + i] =
        slot_sum(a, KR, 0, j, (size_t)(i / d) * R + B1 + i % d);
  if constexpr (TIMED) __syncthreads();
  stamp<TIMED>(a, 0, SB_YBUF);
}

// Per-block mode with each slot's ng units as one thread-block cluster (a
// launch without tickets; ng <= CLUSTER_MAX), after the CTA's one unit:
// its unit's partial of S stays in its S tile and (kerr, ent) in cs[0..1];
// CTA 0 writes the block-removed O, E. After a cluster barrier (every
// unit's tiles done) rank q of the slot sums rows [q K / ng, (q + 1) K /
// ng) of the slot's S: each thread takes four adjacent entries of a row,
// reads them from every unit's S tile over distributed shared memory as
// one 16-byte load per unit (UB units' loads in flight at once) and adds
// each entry's values in ascending unit order from zero, as slot_sum adds
// them from L2; it writes the cache (and brows) and ybuf rows. Rank 0's
// last two threads, which have no row entries, sum the units' kerr and
// entropy partials the same way for the slot's kbuf, as slot_kbuf (under
// the fast objective rank 0 also reads every unit's design columns for its
// O-term). A second barrier keeps each S tile until every CTA of the slot
// has read it. The same bits as the last unit's sums (block_tail), by ng
// CTAs. (The stamped entry at 858k, on the CTA that ends last:
// block_tail's sums 20 us, these 2.7; one 4-byte load per entry and unit,
// 1.6-4.0 across builds, a launch no faster; each CTA storing its
// partial's entries into the CTA that sums them, 6.9.)
constexpr int CLUSTER_MAX = 16;  // the non-portable cluster size limit
constexpr int UB = 8;            // units' 16-byte loads in flight at once

template <bool TIMED>
__device__ void cluster_tail(const Args& a, const Lay& L, float* sm) {
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  const int K = a.K, B = a.B, B1 = L.B1, R = L.R, d = a.d, ng = a.ng;
  const int tid = threadIdx.x, q = blockIdx.x % ng, j = blockIdx.x / ng;
  const float* S = sm + L.oSacc;
  const float* cs = sm + L.oCs;
  float* red = sm + L.oRed;
  if (blockIdx.x == 0) {
    for (int i = tid; i < K * B; i += THREADS) {
      a.O1[i] = sm[L.oOr + i];
      a.E1[i] = sm[L.oEr + i];
    }
  }
  cl.sync();
  stamp<TIMED>(a, 0, SB_SLOT);
  const int slot = a.slots[j];
  const int nkb = K * B1, Kd = K * d, P4 = L.PSA / 4;
  // The value at p of every unit's shared memory, added in ascending unit
  // order from zero.
  const auto unit_sum = [&](const float* p) {
    float s = 0.0f;
    for (int r = 0; r < ng; ++r) s = __fadd_rn(s, *cl.map_shared_rank(p, r));
    return s;
  };
  // Rank 0: the units' kerr and entropy partials (its last two threads).
  if (q == 0 && tid >= THREADS - 2)
    red[tid - (THREADS - 2)] = unit_sum(cs + tid - (THREADS - 2));
  // This rank's rows of S, four entries (one float4) per thread at a time.
  const int k0 = q * K / ng, k1 = (q + 1) * K / ng;
  for (int f = k0 * P4 + tid; f < k1 * P4; f += THREADS) {
    const int k = f / P4, c = 4 * (f % P4);
    const float4* p = reinterpret_cast<const float4*>(S) + f;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int r0 = 0; r0 < ng; r0 += UB) {
      float4 v[UB];
#pragma unroll
      for (int r = 0; r < UB; ++r)
        if (r0 + r < ng) v[r] = *cl.map_shared_rank(p, r0 + r);
#pragma unroll
      for (int r = 0; r < UB; ++r) {
        if (r0 + r < ng) {
          acc.x = __fadd_rn(acc.x, v[r].x);
          acc.y = __fadd_rn(acc.y, v[r].y);
          acc.z = __fadd_rn(acc.z, v[r].z);
          acc.w = __fadd_rn(acc.w, v[r].w);
        }
      }
    }
    const float e4[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int col = c + h;
      if (col < B1) {
        a.cache[(size_t)slot * nkb + k * B1 + col] = e4[h];
        a.brows[(size_t)j * nkb + k * B1 + col] = e4[h];
      } else if (col < R) {
        a.ybuf[(size_t)slot * Kd + k * d + col - B1] = e4[h];
      }
    }
  }
  if (q == 0) {
    __syncthreads();
    const float kerr = red[0], second = red[1];
    float ent = second;
    if (a.fast_ent) {
      float o = 0.0f;
      for (int i = tid; i < K * B; i += THREADS) {
        const int k = i / B, b = i % B;
        const float coef =
            __fmul_rn(__fmul_rn(sm[L.oSig + k], a.theta[b]),
                      log_ratio(sm[L.oOr + i], sm[L.oEr + i]));
        o = fmaf(coef, unit_sum(S + k * L.PSA + 1 + b), o);
      }
      const float stv = block_sum(o, red);
      ent = __fsub_rn(__fadd_rn(-kerr, stv), second);
    }
    if (tid == 0) {
      a.kbuf[(size_t)slot * 2] = kerr;
      a.kbuf[(size_t)slot * 2 + 1] = ent;
    }
  }
  if constexpr (TIMED) __syncthreads();
  stamp<TIMED>(a, 0, SB_YBUF);
  cl.sync();
}

// FOLD setup: YB values of the (Kp, nx) padded Y^T (zero past d and K)
// per thread from entry i0 (entry i: cluster i % Kp, row i / Kp, so
// consecutive threads read consecutive clusters of a row of Y, whole lines
// from L2), all loads in flight at once; store(put) calls put(k, x, value)
// for each. The round builds its fragments once for nb blocks, the
// per-block entry at every launch (its setup 3.7 -> 2.5 us at 858k with
// these reads issued before the shared memory is cleared).
constexpr int YB = 16;

struct YRows {
  float v[YB];

  // Entry i0 + q THREADS is (k, x) = (i % Kp, i / Kp), stepped without a
  // division per entry.
  template <typename F>
  static __device__ __forceinline__ void walk(const Lay& L, int nx, int i0,
                                              F f) {
    const int sx = THREADS / L.Kp, sk = THREADS % L.Kp;
    int x = i0 / L.Kp, k = i0 - x * L.Kp;
#pragma unroll
    for (int q = 0; q < YB; ++q) {
      f(q, x < nx, k, x);
      k += sk;
      x += sx;
      if (k >= L.Kp) {
        k -= L.Kp;
        ++x;
      }
    }
  }

  __device__ __forceinline__ void load(const Args& a, const Lay& L, int nx,
                                       int i0) {
    walk(L, nx, i0, [&](int q, bool in, int k, int x) {
      v[q] = (in && x < a.d && k < a.K) ? a.Y[x * a.K + k] : 0.0f;
    });
  }

  template <typename Put>
  __device__ __forceinline__ void store(const Lay& L, int nx, int i0,
                                        Put put) const {
    walk(L, nx, i0, [&](int q, bool in, int k, int x) {
      if (in) put(k, x, v[q]);
    });
  }
};

// Per-block mode: prefetch the first tile of this CTA's unit, of chunk
// `slot`, into ring stage 0 (the slab is read-only, so this runs ahead of
// the prologue).
__device__ __forceinline__ void prefetch_first(const Args& a, const Lay& L,
                                               int T, float* ring, int slot) {
  if (slot < 0 || slot >= a.nc1) __trap();
  issue_tile(a, L, ring, slot, (int)(blockIdx.x % a.ng) * T / a.ng * TILE);
  cp_commit();
}

// One-launch round: the first pf tiles (two; the wide plan's one ring
// stage: one) of this CTA's first unit of block blk into ring stages 0
// and 1, one commit group each (the slab is read-only: this runs before
// the CTA waits for the previous block).
// cring: the codes plan's codes stages (else null).
__device__ __forceinline__ void prefetch_unit(const Args& a, const Lay& L,
                                              int blk, int T, float* ring,
                                              int pf, int* cring = nullptr) {
  const int j = blockIdx.x / a.ng, run = blockIdx.x % a.ng;
  const int t0 = run * T / a.ng, t1 = (run + 1) * T / a.ng;
  const int slot = a.slots[(size_t)blk * a.J + j];
  if (slot < 0 || slot >= a.nc1) __trap();
  for (int tt = t0; tt < t1 && tt < t0 + pf; ++tt) {
    if (cring != nullptr)
      issue_tile_codes(a, L, ring + (tt - t0) * L.RR * PT,
                       cring + (tt - t0) * TILE, slot, tt * TILE);
    else
      issue_tile(a, L, ring + (tt - t0) * L.RR * PT, slot, tt * TILE);
    cp_commit();
  }
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

// The codes plan: S's design columns of the tile's levels lev[j0, j0 + 8
// CG) for m-tile mt, as the dense plan computes them: the columns of the
// unit's (B, Kp) accumulator Sd where the unit touched the level before
// (else zero), the same mma over the tile's cells in the same order, A the
// r stage Q, B (code == level) generated in registers from this lane's
// cells' codes cc (sgroup's cells), stored back. Columns past the tile's
// levels (-2) are neither loaded nor stored.
template <bool ONE>
__device__ __forceinline__ void design_group(const Lay& L, const float* Q,
                                             float* Sd, const int* lev,
                                             const int (&cc)[TILE / 4],
                                             int mt, int j0, int g, int t) {
  const int r0 = mt * 16 + g;
  float acc[CG][4], acx[CG][4];
  int lb[CG], lc[CG][2];
#pragma unroll
  for (int n = 0; n < CG; ++n) {
    lb[n] = lev[j0 + n * 8 + g];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + n * 8 + 2 * t + h, lv = lev[j];
      const bool old = lv >= 0 && !lev[TILE + j];
      const float* sp = Sd + (size_t)(old ? lv : 0) * L.Kp + r0;
      lc[n][h] = lv;
      acc[n][h] = old ? sp[0] : 0.0f;
      acc[n][2 + h] = old ? sp[8] : 0.0f;
      acx[n][h] = acx[n][2 + h] = 0.0f;
    }
  }
  const auto one = [](bool on) { return on ? 1.0f : 0.0f; };
  if constexpr (ONE) {
    const float* qa = Q + r0 * PT + 2 * t;
#pragma unroll
    for (int ks = 0; ks < TILE / 16; ++ks) {
      const int c = ks * 16;
      const uint32_t af[4] = {
          pack2(*reinterpret_cast<const float2*>(qa + c)),
          pack2(*reinterpret_cast<const float2*>(qa + 8 * PT + c)),
          pack2(*reinterpret_cast<const float2*>(qa + c + 8)),
          pack2(*reinterpret_cast<const float2*>(qa + 8 * PT + c + 8))};
#pragma unroll
      for (int n = 0; n < CG; ++n) {
        const uint32_t bf[2] = {pack2(one(cc[4 * ks] == lb[n]),
                                      one(cc[4 * ks + 1] == lb[n])),
                                pack2(one(cc[4 * ks + 2] == lb[n]),
                                      one(cc[4 * ks + 3] == lb[n]))};
        mma16(acc[n], af, bf);
      }
    }
  } else {
    const float* q0 = Q + r0 * PT + t;
#pragma unroll
    for (int ks = 0; ks < TILE / 8; ++ks) {
      float ah[4], al[4];
      const int c = ks * 8;
      split(q0[c], ah[0], al[0]);
      split(q0[8 * PT + c], ah[1], al[1]);
      split(q0[c + 4], ah[2], al[2]);
      split(q0[8 * PT + c + 4], ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < CG; ++n) {
        float bh[2], bl[2];
        split(one(cc[2 * ks] == lb[n]), bh[0], bl[0]);
        split(one(cc[2 * ks + 1] == lb[n]), bh[1], bl[1]);
        mma3(acc[n], acx[n], ah, al, bh, bl);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < CG; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (lc[n][h] >= 0) {
        float* sp = Sd + (size_t)lc[n][h] * L.Kp + r0;
        sp[0] = ONE ? acc[n][h] : fin(acc[n][h], acx[n][h]);
        sp[8] = ONE ? acc[n][2 + h] : fin(acc[n][2 + h], acx[n][2 + h]);
      }
    }
  }
}

// FOLD: the per-block entry, whose prologue may re-add the previous block
// (a.readd); the one-launch round's instantiations (FOLD false) do not
// compile that path, so its registers stay as they were. ONE: the one-pass
// bf16 products (PRE false); the 3xTF32 instantiations (ONE false) do not
// compile them. WIDE: the one-launch round in the wide plan (layout_wide;
// NRG_MAX, PRE false, FOLD and TIMED false): O', E', wdiv and S at the
// CTA's global scratch `big`, one ring stage. CODES (with WIDE): the codes
// plan (layout_codes; NRG = CG): a.codes for the design rows, O', E' and
// S's design columns at `big`, two ring stages.
template <typename RT, int NRG, bool PRE, bool FOLD = false, bool ONE = false,
          bool TIMED = false, bool WIDE = false, bool CODES = false>
__global__ void __launch_bounds__(THREADS, CODES ? 1 : 2)
    estep_round(Args a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const Lay L = CODES  ? layout_codes<ONE>(a.K, a.B, a.d)
                : WIDE ? layout_wide<ONE>(a.K, a.B, a.d)
                       : layout<ONE>(a.K, a.B, a.d);
  float* big = WIDE ? a.wide + (size_t)blockIdx.x * L.gtotal : sm;
  const int K = a.K, B = a.B, B1 = L.B1, R = L.R, J = a.J, CH = a.CH;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3, cw = 8 * w;
  float* Yh = sm + L.oYh;  // Y^T and wdiv, split, in A-fragment order
  float* Yl = sm + L.oYl;
  float* Wh = big + L.oWh;
  float* Wl = big + L.oWl;
  float* sig = sm + L.oSig;
  float* rsig = sm + L.oRsig;
  float* Or = big + L.oOr;
  float* Er = big + L.oEr;
  float* Q = sm + L.oQ;
  float* ring = sm + L.oRing;
  float* Sacc = (WIDE && !CODES ? big : sm) + L.oSacc;
  float* cs = sm + L.oCs;
  // The codes plan: the ring stages' codes, the tile's levels, each
  // level's last unit, the diversity weights' table and S's design
  // columns (both (B, Kp)).
  [[maybe_unused]] int* cring = reinterpret_cast<int*>(sm + L.oCode);
  [[maybe_unused]] int* lev = reinterpret_cast<int*>(sm + L.oLev);
  [[maybe_unused]] int* seen = reinterpret_cast<int*>(sm + L.oSeen);
  [[maybe_unused]] float* const Wd = (L.WSM ? sm : big) + L.oWd;
  [[maybe_unused]] float* Sd = big + L.oSd;
  // ... and the region the CTAs share (O', E' and the table by parity).
  [[maybe_unused]] float* shb =
      CODES ? a.wide + (size_t)a.wide_ctas * L.gtotal : nullptr;
  // The round's B rows of Z in a ring stage.
  const int zr = CODES ? 1 : B1;
  const int T = (CH + TILE - 1) / TILE;  // tiles per slot
  const int U = J * a.ng;                // units per block
  const size_t KR = (size_t)K * R;

  // The round: the CTAs that share a block's ybuf rows (ybuf_share) are
  // those whose unit has the fewest tiles, which arrive first (every CTA
  // when every unit has as many tiles, or a CTA runs several units).
  int yrank = blockIdx.x, yhelp = gridDim.x;
  if (!FOLD && (int)gridDim.x == U && T % a.ng != 0) {
    const int few = T / a.ng;
    int nl = 0, rank = -1;
    for (int r = 0; r < a.ng; ++r) {
      const bool light = (r + 1) * T / a.ng - r * T / a.ng == few;
      if (light && r == (int)blockIdx.x % a.ng) rank = nl;
      nl += light;
    }
    yhelp = J * nl;
    yrank = rank < 0 ? -1 : (int)(blockIdx.x / a.ng) * nl + rank;
  }

  // FOLD with readd: the previous block's frame rows for the prologue's
  // first two column sums of each thread, loaded now so that their latency
  // (two dependent trips to L2: rank codes, then rows) passes behind the
  // setup below instead of stalling the prologue.
  const float* frame = a.frame;
  const size_t nkb = (size_t)K * L.B1;
  [[maybe_unused]] const auto fold_row = [frame, nkb](int code) {
    return frame + code * nkb;
  };
  [[maybe_unused]] const int fold_off[2] = {min(tid, K * L.B1 - 1),
                                            min(tid + THREADS, K * L.B1 - 1)};
  [[maybe_unused]] FrameBatch<FOLD_RQ, 2> fold;
  if constexpr (FOLD) {
    if (a.readd) fold.load(fold_row, a.src, 0, a.J_fix, fold_off);
  }

  stamp_span<TIMED>(a, 0);
  // The round: the generation (the counters' values at the launch's start;
  // thread 0 waits and arrives). The launch's last CTA to end writes the
  // next one's, after every CTA has read these.
  [[maybe_unused]] unsigned gen[3] = {0, 0, 0};
  if constexpr (!FOLD) {
    if (tid == 0)
      for (int c = 0; c < 3; ++c) gen[c] = ld_acquire(a.sync + SY_GEN + c);
  }
  // FOLD: the setup's reads (the first tile's slab, Y^T's first YB values
  // per thread, sigma) go out before the shared memory is cleared, so
  // that their latency passes behind it; the clearing leaves out the rows
  // of ring stage 0 the first tile's copy writes, 16 bytes a store.
  [[maybe_unused]] YRows yrows;
  [[maybe_unused]] float sg[2] = {1.0f, 1.0f};
  [[maybe_unused]] const int ynx = (ONE ? 16 : 8) * L.KSR;
  if constexpr (FOLD) {
    const int slot0 = a.slots[blockIdx.x / a.ng];
    yrows.load(a, L, ynx, tid);
#pragma unroll
    for (int c = 0; c < 2; ++c)
      if (tid + c * THREADS < K) sg[c] = a.sigma[tid + c * THREADS];
    prefetch_first(a, L, T, ring, slot0);
    const int h0 = L.oRing / 4, h1 = (L.oRing + L.R * PT) / 4;
    for (int i = tid; i < L.total / 4; i += THREADS)
      if (i < h0 || i >= h1) smem4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    __syncthreads();
  } else {
    // Zero padding everywhere (ring rows >= R, W rows, pad rows and
    // columns), then the round's constants: Y^T split once, sigma and
    // 1/sigma.
    for (int i = tid; i < L.total; i += THREADS) sm[i] = 0.0f;
    if constexpr (CODES) {
      // The tables' padding rows (clusters K..Kp) stay zero: this CTA's
      // own and its share of the shared ones'. S's design columns are
      // read only after their unit's first write (seen).
      if (!L.WSM)
        for (int i = tid; i < (ONE ? B * L.Kp / 2 : B * L.Kp); i += THREADS)
          Wd[i] = 0.0f;
      for (int b = blockIdx.x; b < B; b += gridDim.x)
        for (int k = K + tid; k < L.Kp; k += THREADS)
          for (int par = 0; par < 2; ++par)
            put_wd<ONE>(shb + par * L.pstride + L.oPW, b * L.Kp + k, 0.0f);
    } else if constexpr (WIDE) {
      for (int i = tid; i < L.gtotal; i += THREADS) big[i] = 0.0f;
    }
    __syncthreads();
    prefetch_unit(a, L, 0, T, ring, WIDE && !CODES ? 1 : 2,
                  CODES ? cring : nullptr);
  }
  if constexpr (FOLD) {
    const auto put = [&](int k, int x, float v) {
      if constexpr (ONE)
        put_frag16(Yh, (k >> 4) * L.KSR + (x >> 4), k & 15, x & 15, v);
      else
        put_frag(L, Yh, Yl,
                 ((k >> 4) * L.KSR + (x >> 3)) * 128 + frag_pos(k & 15, x & 7),
                 v);
    };
    yrows.store(L, ynx, tid, put);
    for (int i0 = tid + YB * THREADS; i0 < L.Kp * ynx; i0 += YB * THREADS) {
      YRows more;
      more.load(a, L, ynx, i0);
      more.store(L, ynx, i0, put);
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int k = tid + c * THREADS;
      if (k < K) {
        sig[k] = sg[c];
        rsig[k] = __frcp_rn(sg[c]);
      }
    }
  } else if constexpr (ONE) {
    for (int i = tid; i < L.Kp * 16 * L.KSR; i += THREADS) {
      const int k = i / (16 * L.KSR), x = i % (16 * L.KSR);
      const float v = (x < a.d && k < K) ? a.Y[x * K + k] : 0.0f;
      put_frag16(Yh, (k >> 4) * L.KSR + (x >> 4), k & 15, x & 15, v);
    }
  } else {
    for (int i = tid; i < L.Kp * 8 * L.KSR; i += THREADS) {
      const int k = i / (8 * L.KSR), x = i % (8 * L.KSR);
      const float v = (x < a.d && k < K) ? a.Y[x * K + k] : 0.0f;
      const int o =
          ((k >> 4) * L.KSR + (x >> 3)) * 128 + frag_pos(k & 15, x & 7);
      put_frag(L, Yh, Yl, o, v);
    }
  }
  for (int k = FOLD ? tid + 2 * THREADS : tid; k < K; k += THREADS) {
    sig[k] = a.sigma[k];
    rsig[k] = __frcp_rn(a.sigma[k]);
  }

  for (int blk = 0; blk < a.nb; ++blk) {
    if constexpr (TIMED && FOLD) __syncthreads();
    stamp<TIMED>(a, blk, ST_START);
    // The round: wait for the previous block's sums (every reducing CTA
    // done), having done in the meantime what does not need them.
    if constexpr (!FOLD) {
      if (blk > 0) {
        wait_count(a.sync + SY_REDUCED, gen[1] + (unsigned)(blk * yhelp));
        stamp<TIMED>(a, blk, ST_WAIT);
      }
    }
    // Prologue: O, E = the previous block's O', E' plus its block sums (the
    // round's input for block 0; FOLD with readd: O0, E0 plus the previous
    // block's frame, each rounded as csrc/frame_readd.cuh rounds them);
    // remove this block's cached stats; the diversity weights, split, as
    // the A operand of w = wdiv Phi.
    if constexpr (FOLD) {
      // The frame's column sums (K, B+1) into the r stage, free until the
      // tile phase: entries tid and tid + THREADS from the batch loaded at
      // the kernel's start (then any ranks past FOLD_RQ), further entries
      // each on its own.
      if (a.readd) {
        float acc[2] = {0.0f, 0.0f};
        fold.add(0, a.J_fix, acc);
        frame_sum<FOLD_RQ>(fold_row, a.src, FOLD_RQ, a.J_fix, fold_off, acc);
        if (tid < K * B1) Q[tid] = acc[0];
        if (tid + THREADS < K * B1) Q[tid + THREADS] = acc[1];
        for (int e = tid + 2 * THREADS; e < K * B1; e += THREADS) {
          const int off[1] = {e};
          float one[1] = {0.0f};
          frame_sum<FOLD_RQ>(fold_row, a.src, 0, a.J_fix, off, one);
          Q[e] = one[0];
        }
        __syncthreads();
      }
      stamp<TIMED>(a, blk, SB_FOLD);
    }
    if constexpr (CODES) {
      // The codes plan: block 0's every CTA forms itself (its share of O',
      // E' into the shared region); a later block's the previous block's
      // reducers formed (codes_reduce): its table is copied from L2 into
      // the CTA's own (in shared memory, or its scratch).
      const float* cur = shb + (size_t)(blk & 1) * L.pstride;
      if (blk == 0) {
#pragma unroll 4
        for (int i = tid; i < K * B; i += THREADS) {
          const int k = i / B, b = i % B;
          const float* rem = a.removal + (size_t)k * B1;
          const float E = __fsub_rn(a.E0[i], __fmul_rn(rem[0], a.prb[b]));
          const float O = __fsub_rn(a.O0[i], rem[1 + b]);
          if (i % (int)gridDim.x == (int)blockIdx.x) {
            shb[L.oEr + i] = E;
            shb[L.oOr + i] = O;
          }
          put_wd<ONE>(Wd, b * L.Kp + k,
                      expf(__fmul_rn(a.theta[b], log_ratio(O, E))));
        }
      } else {
        const uint4* src = reinterpret_cast<const uint4*>(cur + L.oPW);
        uint4* dst = reinterpret_cast<uint4*>(Wd);
        const int n4 = (ONE ? B * L.Kp / 2 : B * L.Kp) / 4;
#pragma unroll 8
        for (int i = tid; i < n4; i += THREADS) dst[i] = __ldcg(src + i);
      }
    } else {
      for (int i = tid; i < K * B; i += THREADS) {
        const int k = i / B, b = i % B;
        float O, E;
        if (blk == 0) {
          O = a.O0[i];
          E = a.E0[i];
          if constexpr (FOLD) {
            if (a.readd) {
              const float* fs = sm + L.oQ + k * B1;
              O = __fadd_rn(O, fs[1 + b]);
              E = __fadd_rn(E, __fmul_rn(fs[0], a.prb[b]));
            }
          }
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
        if constexpr (ONE) {
          put_frag16(Wh, (k >> 4) * L.KB + ((1 + b) >> 4), k & 15,
                     (1 + b) & 15, wd);
        } else {
          const int o = ((k >> 4) * L.KB + ((1 + b) >> 3)) * 128 +
                        frag_pos(k & 15, (1 + b) & 7);
          put_frag(L, Wh, Wl, o, wd);
        }
      }
    }
    __syncthreads();
    stamp<TIMED>(a, blk, ST_PRO);

    // Tile phase.
    for (int u = blockIdx.x; u < U; u += gridDim.x) {
      const int j = u / a.ng, run = u % a.ng;
      const int t0 = run * T / a.ng, t1 = (run + 1) * T / a.ng;
      const int slot = a.slots[(size_t)blk * J + j];
      if (slot < 0 || slot >= a.nc1) __trap();
      RT* rwp = nullptr;
      if (a.rw != nullptr && slot >= a.lo && slot < a.lo + a.width)
        rwp = static_cast<RT*>(a.rw) + (size_t)(slot - a.lo) * K * CH;
      // (The round clears the first unit's Sacc before its wait.)
      if (FOLD || u != (int)blockIdx.x)
        for (int i = tid; i < L.Kp * L.PSA; i += THREADS) Sacc[i] = 0.0f;
      float kerr_t = 0.0f, ent_t = 0.0f;
      // The tile at cells c0 into ring stage st.
      const auto issue = [&](int st, int c0) {
        if constexpr (CODES)
          issue_tile_codes(a, L, ring + st * L.RR * PT, cring + st * TILE,
                           slot, c0);
        else
          issue_tile(a, L, ring + st * L.RR * PT, slot, c0);
      };
      // The codes plan: this unit's stamp of the levels it touches.
      [[maybe_unused]] const int us = blk * U + u + 1;

      if (u != (int)blockIdx.x) {
        issue(0, t0 * TILE);
        cp_commit();
      }
      // TIMED: stamp k of this tile (the CTA's first unit, first MAXT).
      [[maybe_unused]] const auto tstamp = [&](int tt, int k) {
        if (u == (int)blockIdx.x && tt - t0 < MAXT)
          stamp<TIMED>(a, blk, ST_TILE + 4 * (tt - t0) + k);
      };
      // Tiles of the CTA's first unit already in flight: the round
      // prefetches two (prefetch_unit), the per-block entry one. The wide
      // plan's one stage takes the next tile once this one's S is done.
      constexpr int PF = FOLD ? 1 : 2;
      for (int tt = t0; tt < t1; ++tt) {
        const int c0 = tt * TILE;
        constexpr bool ONE_STAGE = WIDE && !CODES;
        const float* rg =
            ring + (ONE_STAGE ? 0 : ((tt - t0) & 1) * L.RR * PT);
        [[maybe_unused]] const int* cst = cring + ((tt - t0) & 1) * TILE;
        if constexpr (ONE_STAGE) {
          cp_wait<0>();
        } else if (tt + 1 < t1) {
          if (u != (int)blockIdx.x || tt + 1 - t0 >= PF) {
            issue((tt + 1 - t0) & 1, c0 + TILE);
            cp_commit();
          }
          cp_wait<1>();
        } else {
          cp_wait<0>();
        }
        __syncthreads();
        if constexpr (TIMED) tstamp(tt, 0);
        // The codes plan: warp 0 lists the tile's levels for S (read after
        // pass 1's barrier).
        if constexpr (CODES) {
          if (w == 0) tile_levels(cst, c0, CH, lev, seen, us, lane);
        }

        // Pass 1, per warp: dist = Y^T z and w = wdiv Phi on the tensor
        // cores for the warp's 8 cells (one n-tile) and all K rows, two
        // m-tiles at a time; s and q = s w in registers; per-cell sums over
        // the 8 lanes that share a column.
        auto pass1 = [&](auto fast_c) {
          constexpr bool FAST = decltype(fast_c)::value;
          float bh[KSC][2], bl[KSC][2], wbh[2], wbl[2];
          uint32_t yb[KSC1][2], wb[2];  // one pass
          if constexpr (ONE) {
#pragma unroll
            for (int ks = 0; ks < KSC1; ++ks)
              load_b16_slab(rg + (zr + ks * 16) * PT + cw, t, g, yb[ks]);
            if constexpr (!CODES) load_b16_slab(rg + cw, t, g, wb);
          } else {
#pragma unroll
            for (int ks = 0; ks < KSC; ++ks)
              load_b_slab(rg + (zr + ks * 8) * PT + cw, t, g, bh[ks],
                          bl[ks]);
            if constexpr (!CODES) load_b_slab(rg + cw, t, g, wbh, wbl);
          }
          // The codes plan: the levels of this thread's cells 2t, 2t + 1.
          [[maybe_unused]] int cc1[2] = {0, 0};
          if constexpr (CODES) {
            cc1[0] = tile_code(cst, c0, cw + 2 * t, CH);
            cc1[1] = tile_code(cst, c0, cw + 2 * t + 1, CH);
          }
          // w[k, cell] of the codes plan: wdiv[k, level] as the dense
          // product's operand holds it, 0 for padding.
          [[maybe_unused]] const auto wgather = [&](int k, int code) {
            if (code < 0) return 0.0f;
            if constexpr (ONE)
              return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(
                  Wd)[code * L.Kp + k]);
            else
              return Wd[code * L.Kp + k];
          };
          float den[2] = {0.0f, 0.0f}, qs[2] = {0.0f, 0.0f};
          float qd[2] = {0.0f, 0.0f}, qg[2] = {0.0f, 0.0f};
          auto mtiles = [&](auto np_c, int mt0) {
            constexpr int NP = decltype(np_c)::value;
            float acc[NP][4] = {}, acx[NP][4] = {};
            float wac[NP][4] = {}, wax[NP][4] = {};
            if constexpr (ONE) {
              uint32_t af[4];
#pragma unroll
              for (int ks = 0; ks < KSC1; ++ks) {
#pragma unroll
                for (int p = 0; p < NP; ++p) {
                  load_a16(Yh, (mt0 + p) * L.KSR + ks, lane, af);
                  mma16(acc[p], af, yb[ks]);
                }
              }
              for (int ks = KSC1; ks < L.KSR; ++ks) {
                uint32_t xb[2];
                load_b16_slab(rg + (zr + ks * 16) * PT + cw, t, g, xb);
#pragma unroll
                for (int p = 0; p < NP; ++p) {
                  load_a16(Yh, (mt0 + p) * L.KSR + ks, lane, af);
                  mma16(acc[p], af, xb);
                }
              }
              if constexpr (!CODES) {
#pragma unroll
              for (int p = 0; p < NP; ++p) {
                load_a16(Wh, (mt0 + p) * L.KB, lane, af);
                mma16(wac[p], af, wb);
              }
              for (int ks = 1; ks < L.KB; ++ks) {
                uint32_t xb[2];
                load_b16_slab(rg + ks * 16 * PT + cw, t, g, xb);
#pragma unroll
                for (int p = 0; p < NP; ++p) {
                  load_a16(Wh, (mt0 + p) * L.KB + ks, lane, af);
                  mma16(wac[p], af, xb);
                }
              }
              }
            } else {
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
              load_b_slab(rg + (zr + ks * 8) * PT + cw, t, g, xh, xl);
#pragma unroll
              for (int p = 0; p < NP; ++p) {
                load_a_frag<PRE>(Yh, Yl, (mt0 + p) * L.KSR + ks, lane, ah, al);
                mma3(acc[p], acx[p], ah, al, xh, xl);
              }
            }
            if constexpr (!CODES) {
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
            }
            }
            // Accumulator e of m-tile mt: cluster mt*16 + g + 8 (e >> 1),
            // cell 2t + (e & 1) of the warp's 8. Rows >= K get s = 0.
#pragma unroll
            for (int p = 0; p < NP; ++p) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int k = (mt0 + p) * 16 + g + 8 * (e >> 1), h = e & 1;
                const float yz = ONE ? acc[p][e] : fin(acc[p][e], acx[p][e]);
                const float wq = CODES ? wgather(k, cc1[h])
                                 : ONE ? wac[p][e]
                                       : fin(wac[p][e], wax[p][e]);
                const float dist = __fmul_rn(2.0f, __fsub_rn(1.0f, yz));
                const float ex = expf(__fmul_rn(-dist, rsig[k]));
                const float s = k < K ? ex : 0.0f;
                const float q = __fmul_rn(s, wq);
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
        if constexpr (TIMED) tstamp(tt, 1);

        if (rwp != nullptr)
          ent_t = a.fast_ent
                      ? pass2<false, true>(Q, cs, sig, K, rwp, CH, c0, ent_t)
                      : pass2<true, true>(Q, cs, sig, K, rwp, CH, c0, ent_t);
        else
          ent_t = a.fast_ent
                      ? pass2<false, false>(Q, cs, sig, K, rwp, CH, c0, ent_t)
                      : pass2<true, false>(Q, cs, sig, K, rwp, CH, c0, ent_t);
        __syncthreads();
        if constexpr (TIMED) tstamp(tt, 2);

        // S += r slab^T over the tile's 64 cells: NRG n-tiles n0.. of
        // m-tile mt (the rows of the ring stage's slab rows) per A fragment.
        const auto sgroup = [&](int mt, int n0) {
          const float* q0 = Q + (mt * 16 + g) * PT + t;
          float* s0 = Sacc + (mt * 16 + g) * L.PSA + 2 * t;
          {
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
            if constexpr (ONE) {
              // A: r rows g, g + 8, cells 2t, 2t+1 (+8) of each 16; B: the
              // slab rows' same cells, two per register.
              const float* qa = Q + (mt * 16 + g) * PT + 2 * t;
#pragma unroll 2
              for (int ks = 0; ks < TILE / 16; ++ks) {
                const int c = ks * 16;
                const uint32_t af[4] = {
                    pack2(*reinterpret_cast<const float2*>(qa + c)),
                    pack2(*reinterpret_cast<const float2*>(qa + 8 * PT + c)),
                    pack2(*reinterpret_cast<const float2*>(qa + c + 8)),
                    pack2(*reinterpret_cast<const float2*>(qa + 8 * PT + c +
                                                           8))};
#pragma unroll
                for (int n = 0; n < NRG; ++n) {
                  const float* bp = rg + ((n0 + n) * 8 + g) * PT + c + 2 * t;
                  const uint32_t bf[2] = {
                      pack2(*reinterpret_cast<const float2*>(bp)),
                      pack2(*reinterpret_cast<const float2*>(bp + 8))};
                  mma16(acc[n], af, bf);
                }
              }
#pragma unroll
              for (int n = 0; n < NRG; ++n) {
                *reinterpret_cast<float2*>(s0 + (n0 + n) * 8) =
                    make_float2(acc[n][0], acc[n][1]);
                *reinterpret_cast<float2*>(s0 + 8 * L.PSA + (n0 + n) * 8) =
                    make_float2(acc[n][2], acc[n][3]);
              }
            } else {
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
        };
        if constexpr (CODES) {
          // The codes plan: per m-tile the dense groups, then the design
          // groups of the tile's levels (CG n-tiles, 8 CG levels each),
          // dealt to the warps in turn.
          const int nl = lev[2 * TILE];
          const int ndg = L.NRp / CG, per = ndg + cdiv(nl, 8 * CG);
          int cc[TILE / 4];
#pragma unroll
          for (int i = 0; i < TILE / 4; ++i)
            cc[i] = tile_code(cst, c0,
                              ONE ? (i >> 2) * 16 + 2 * t + (i & 1) +
                                        8 * ((i >> 1) & 1)
                                  : (i >> 1) * 8 + t + 4 * (i & 1),
                              CH);
          for (int it = w; it < L.MT * per; it += WARPS) {
            const int mt = it / per, grp = it % per;
            if (grp < ndg)
              sgroup(mt, grp * CG);
            else
              design_group<ONE>(L, Q, Sd, lev, cc, mt, (grp - ndg) * 8 * CG,
                                g, t);
          }
        } else {
          // Warp w owns m-tiles w, w + WARPS, ...
          for (int mt = w; mt < L.MT; mt += WARPS)
            for (int n0 = 0; n0 < L.NRp; n0 += NRG) sgroup(mt, n0);
        }
        __syncthreads();
        if constexpr (TIMED) tstamp(tt, 3);
        if constexpr (WIDE && !CODES) {
          if (tt + 1 < t1) {
            issue_tile(a, L, ring, slot, c0 + TILE);
            cp_commit();
          }
        }
      }

      const size_t pc = FOLD ? 0 : (size_t)(blk % NPART);
      const size_t kc = FOLD ? 0 : (size_t)(blk & 1);
      // FOLD in a cluster (no tickets): the partial stays in Sacc.
      if constexpr (CODES) {
        // The dense columns (mask, Z) from the S tile; the design columns
        // of the levels this unit touched from Sd (zero elsewhere), TILE
        // levels at a time through the r stage, so that both the reads
        // and the writes run along rows.
        float* P = a.part + (pc * U + u) * KR;
        const int d1 = 1 + a.d;
        for (int i = tid; i < K * d1; i += THREADS) {
          const int k = i / d1, x = i % d1;
          P[(size_t)k * R + (x == 0 ? 0 : B1 + x - 1)] =
              Sacc[k * L.PSA + x];
        }
        constexpr int TP = TILE + 1;  // the transposition's pitch
        constexpr int TQ = 16;        // loads in flight per thread
        for (int b0 = 0; b0 < B; b0 += TILE) {
          __syncthreads();
          for (int e0 = tid; e0 < TILE * K; e0 += TQ * THREADS) {
            float v[TQ];
            int at[TQ];
#pragma unroll
            for (int q = 0; q < TQ; ++q) {
              const int e = e0 + q * THREADS, bi = e / K, k = e - bi * K;
              const int b = b0 + bi;
              v[q] = e < TILE * K && b < B && seen[b] == us
                         ? Sd[(size_t)b * L.Kp + k]
                         : 0.0f;
              at[q] = k * TP + bi;
            }
#pragma unroll
            for (int q = 0; q < TQ; ++q)
              if (e0 + q * THREADS < TILE * K) Q[at[q]] = v[q];
          }
          __syncthreads();
          for (int i = tid; i < K * TILE; i += THREADS) {
            const int k = i / TILE, bi = i % TILE;
            if (b0 + bi < B) P[(size_t)k * R + 1 + b0 + bi] = Q[k * TP + bi];
          }
        }
      } else if (!FOLD || a.tickets != nullptr) {
        float* P = a.part + (pc * U + u) * KR;
        for (int i = tid; i < (int)KR; i += THREADS)
          P[i] = Sacc[(i / R) * L.PSA + i % R];
      }
      float ke, en;
      if constexpr (FOLD) {
        // The r stage is free: one tree for both, block_sum's.
        const float2 v =
            block_sum2(kerr_t, ent_t, reinterpret_cast<float2*>(Q));
        ke = v.x;
        en = v.y;
        if (a.tickets == nullptr) {
          if (tid == 0) {
            cs[0] = ke;
            cs[1] = en;
          }
          stamp<TIMED>(a, blk, ST_PART);
          cluster_tail<TIMED>(a, L, sm);
          stamp_span<TIMED>(a, 1);
          return;
        }
      } else {
        // The r stage is free until the next tile: one tree for both.
        const float2 v =
            block_sum2(kerr_t, ent_t, reinterpret_cast<float2*>(Q));
        ke = v.x;
        en = v.y;
      }
      if (tid == 0) {
        a.kpart[(kc * U + u) * 2] = ke;
        a.kpart[(kc * U + u) * 2 + 1] = en;
      }
      if constexpr (FOLD) stamp<TIMED>(a, blk, ST_PART);
      if constexpr (!FOLD) {
        const bool first = u == (int)blockIdx.x;
        if (first) stamp<TIMED>(a, blk, ST_PART);
        arrive(a.sync + SY_UNITS);
        if (first) stamp<TIMED>(a, blk, ST_ARRIVE);
      }
    }
    // Per-block mode (one unit per CTA, nb 1): every FOLD launch.
    if constexpr (FOLD) {
      block_tail<TIMED>(a, L, sm);
      stamp_span<TIMED>(a, 1);
      return;
    } else {
      // The round, before it waits for this block's sums: the next
      // block's first tiles in flight and the previous block's ybuf rows;
      // then the reducing CTAs (yrank's, whose units have the fewest
      // tiles) wait for every unit of the block, reduce their share (the S
      // tile as scratch) and arrive, then write their slots' kbuf. The
      // first unit's S tile is cleared.
      if (blk + 1 < a.nb)
        prefetch_unit(a, L, blk + 1, T, ring, WIDE && !CODES ? 1 : 2,
                      CODES ? cring : nullptr);
      if (blk > 0) ybuf_share(a, L, blk - 1, yrank, yhelp);
      if constexpr (TIMED) __syncthreads();
      stamp<TIMED>(a, blk, ST_WINDOW);
      if (yrank >= 0) {
        wait_count(a.sync + SY_UNITS, gen[0] + (unsigned)((blk + 1) * U));
        stamp<TIMED>(a, blk, ST_UNITS);
        if constexpr (CODES)
          codes_reduce<ONE>(a, L, blk, yrank, yhelp, Sacc, Q, shb);
        else
          reduce_share(a, L, blk, yrank, yhelp, Sacc);
        arrive(a.sync + SY_REDUCED);
        for (int j = yhelp - 1 - yrank; j < J; j += yhelp)
          slot_kbuf<CODES>(a, L, blk, j, sm,
                           CODES ? shb + (size_t)(blk & 1) * L.pstride : big);
      }
      __syncthreads();
      for (int i = tid; i < L.Kp * L.PSA; i += THREADS) Sacc[i] = 0.0f;
      if constexpr (TIMED) __syncthreads();
      if (yrank >= 0) stamp<TIMED>(a, blk, ST_REDUCE);
    }
  }
  if constexpr (!FOLD) {
    wait_count(a.sync + SY_REDUCED, gen[1] + (unsigned)(a.nb * yhelp));
    ybuf_share(a, L, a.nb - 1, blockIdx.x, gridDim.x);
  }
  // (The codes plan's last reducers wrote O1, E1.)
  if (!CODES && blockIdx.x == 0) {
    for (int i = tid; i < K * B; i += THREADS) {
      const int k = i / B, b = i % B;
      const float* bs = a.bsum + (size_t)k * B1;
      a.E1[i] = __fadd_rn(Er[i], __fmul_rn(__ldcg(bs), a.prb[b]));
      a.O1[i] = __fadd_rn(Or[i], __ldcg(bs + 1 + b));
    }
  }
  if constexpr (!FOLD) {
    // The last CTA to end records the counters' values for the next
    // launch: every CTA has read this launch's generation by then.
    if (tid == 0 && atomicAdd(a.sync + SY_EXITS, 1u) ==
                        gen[2] + gridDim.x - 1) {
      a.sync[SY_GEN] = gen[0] + (unsigned)(a.nb * U);
      a.sync[SY_GEN + 1] = gen[1] + (unsigned)(a.nb * yhelp);
      a.sync[SY_GEN + 2] = gen[2] + gridDim.x;
    }
  }
  stamp_span<TIMED>(a, 1);
}

// TIMED: the phase each stamp ends, in stamp order ("-": unused), for
// ops/cuda/round_timing.py. Phases named wait_* are waits for other CTAs;
// off_* are off the block's chain (after the CTA's arrival).
constexpr const char* STAMP_NAMES =
    "start,wait_sums,prologue,"
    "t0_ready,t0_pass1,t0_pass2,t0_S,t1_ready,t1_pass1,t1_pass2,t1_S,"
    "t2_ready,t2_pass1,t2_pass2,t2_S,t3_ready,t3_pass1,t3_pass2,t3_S,"
    "partial,arrive,off_window,wait_units,off_reduce";

// TIMED FOLD: the phase each stamp of the per-block entry ends; wait_slot
// is its wait for the slot's other units, sum_* the slot's sums.
constexpr const char* BLOCK_STAMP_NAMES =
    "setup,fold,prologue,"
    "t0_ready,t0_pass1,t0_pass2,t0_S,t1_ready,t1_pass1,t1_pass2,t1_S,"
    "t2_ready,t2_pass1,t2_pass2,t2_S,t3_ready,t3_pass1,t3_pass2,t3_S,"
    "partial,wait_slot,sum_kbuf,sum_cache,sum_ybuf";

// Dynamic shared memory of one CTA for (K, B, d), in bytes (ONE: the
// one-pass variant's).
template <bool ONE = false>
inline size_t smem_bytes(int K, int B, int d) {
  return sizeof(float) * (size_t)layout<ONE>(K, B, d).total;
}

// The S n-tile group and the operand storage are template parameters (no
// guards in the hot loops): f(IC<NRG>, IC<PRE>) for the layout's pair; in
// one pass only PRE false is built.
template <bool ONE = false, typename F>
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
  if constexpr (!ONE) {
    if (L.PRE) ESTEP_NRG(1)
  }
  ESTEP_NRG(0)
#undef ESTEP_NRG
}

inline Args make_args(const float* zp3, const float* Y, const float* sigma,
                      const float* theta, const float* prb,
                      const float* removal, const int* slots, const float* O0,
                      const float* E0, float* part, float* kpart, float* bsum,
                      float* cache, float* ybuf, float* kbuf, float* O1,
                      float* E1, void* rw, int lo, int width, int K, int B,
                      int d, int CH, int nb, int J, int ng, int nc1,
                      int fast_ent) {
  Args a;
  a.zp3 = zp3; a.Y = Y; a.sigma = sigma; a.theta = theta; a.prb = prb;
  a.removal = removal; a.slots = slots; a.O0 = O0; a.E0 = E0;
  a.part = part; a.kpart = kpart; a.bsum = bsum; a.cache = cache;
  a.ybuf = ybuf; a.kbuf = kbuf; a.O1 = O1; a.E1 = E1; a.rw = rw;
  a.lo = lo; a.width = width; a.K = K; a.B = B; a.d = d; a.CH = CH;
  a.nb = nb; a.J = J; a.ng = ng; a.nc1 = nc1; a.fast_ent = fast_ent;
  a.tickets = nullptr; a.brows = nullptr; a.stamps = nullptr;
  a.sync = nullptr;
  a.wide = nullptr; a.wide_ctas = 0; a.codes = nullptr;
  a.frame = nullptr; a.src = nullptr; a.J_fix = 0; a.readd = 0;
  return a;
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

