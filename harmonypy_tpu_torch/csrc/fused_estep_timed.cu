// The stamped one-pass round (ops/cuda/round_timing.py): fused_estep.cu's
// one-launch round over instantiations of estep_round that write clock64
// stamps at each phase of each block (TIMED). Built only on demand (build.py
// ON_DEMAND), for `chip_smoke.py --round-ab`; no fit reaches it.

#define ESTEP_ONE true
#define ESTEP_TIMED true
#include "fused_estep.cu"
