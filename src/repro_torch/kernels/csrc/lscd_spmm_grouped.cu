// Grouped LSCD SpMM: G = 2 or 3 same-shape weights against one B.
//
// Replaces the TPU kernel repro/kernels/spmm.py:lscd_spmm_grouped (body
// _lscd_spmm_grouped_kernel, pallas_call at :417). Bound on an H100: the G
// word streams over 3.35 TB/s at decode N. Design: see lscd_common.cuh —
// the block stages each B tile in shared memory once and runs all G weights
// against it, keeping G accumulators per output; unary epilogues flush
// C[G, M, N] per group (bias [G, M]), binary ones (silu_mul, gelu_mul, G=2)
// combine the pair into one C[M, N] at the flush.
#include "lscd_common.cuh"

LSCD_DEFINE_ENTRY(lscd_spmm_grouped_launch, false, true)
