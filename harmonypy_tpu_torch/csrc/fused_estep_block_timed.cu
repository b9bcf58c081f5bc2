// The stamped one-pass per-block entry (ops/cuda/block_timing.py):
// fused_estep_block.cu's entries over FOLD instantiations of estep_round
// that write clock64 stamps at each phase of their one block (TIMED).
// Built only on demand (build.py ON_DEMAND), for `chip_smoke.py
// --block-timing`; no fit reaches it.

#define ESTEP_ONE true
#define ESTEP_TIMED true
#include "fused_estep_block.cu"
