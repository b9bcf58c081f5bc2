// The one-pass variant's library of the one-launch round (K1, its r window,
// K2): fused_estep.cu's entries over the instantiations of estep_round whose
// three products run as one bf16 tensor-core pass (ONE; matmul_precision
// "default"), built by an nvcc of its own beside fused_estep.cu's.

#define ESTEP_ONE true
#include "fused_estep.cu"
