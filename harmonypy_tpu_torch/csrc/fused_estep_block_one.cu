// The one-pass variant's library of the per-block entry, the re-add kernel
// and the native mesh pass: fused_estep_block.cu's entries over the FOLD
// instantiations of estep_round whose three products run as one bf16
// tensor-core pass (ONE; matmul_precision "default"), built by an nvcc of
// its own beside fused_estep_block.cu's.

#define ESTEP_ONE true
#include "fused_estep_block.cu"
