// Grouped split-K LSCD SpMM: partials [S, G, M, N], then a reduce.
//
// Replaces the TPU kernel repro/kernels/spmm.py:lscd_spmm_splitk_grouped
// (partials body _lscd_spmm_splitk_grouped_kernel, reduce
// _splitk_reduce_grouped_kernel; pallas_calls at :678 and :723). Bound on an
// H100: the G word streams over 3.35 TB/s plus the partials bytes. Design:
// see lscd_common.cuh — as the split-K kernel; in the bf16 bodies the
// weight is a grid axis (z = slice * G + weight), or a block holds the G=2
// pair of a binary epilogue; the reduce applies unary epilogues per group
// or combines the pair for binary ones.
#include "lscd_common.cuh"

LSCD_DEFINE_ENTRY(lscd_spmm_splitk_grouped_launch, true, true)
