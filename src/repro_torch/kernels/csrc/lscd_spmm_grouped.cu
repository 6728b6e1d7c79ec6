// Grouped LSCD SpMM: G = 2 or 3 same-shape weights against one B.
//
// Replaces the TPU kernel repro/kernels/spmm.py:lscd_spmm_grouped (body
// _lscd_spmm_grouped_kernel, pallas_call at :417). Bound on an H100: the G
// word streams over 3.35 TB/s at decode N, the tensor cores at prefill N.
// Design: see lscd_common.cuh — in the bf16 bodies a block holds one
// weight, with the weight in the grid, or the pair of a binary epilogue
// (silu_mul, gelu_mul, G=2), which it combines into one C[M, N] at the
// flush; unary epilogues flush C[G, M, N] per weight (bias [G, M]). f32
// blocks hold all G weights against one staged B tile.
#include "lscd_common.cuh"

LSCD_DEFINE_ENTRY(lscd_spmm_grouped_launch, false, true)
