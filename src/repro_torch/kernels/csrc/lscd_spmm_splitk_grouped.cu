// Grouped split-K LSCD SpMM: partials [S, G, M, N], then a reduce.
//
// Replaces the TPU kernel repro/kernels/spmm.py:lscd_spmm_splitk_grouped
// (partials body _lscd_spmm_splitk_grouped_kernel, reduce
// _splitk_reduce_grouped_kernel; pallas_calls at :678 and :723). Bound on an
// H100: the G word streams over 3.35 TB/s plus the partials bytes. Design:
// see lscd_common.cuh — as the split-K kernel, with the B tile staged once
// per block and K tile for all G weights; the reduce applies unary
// epilogues per group or combines the G=2 pair for binary ones.
#include "lscd_common.cuh"

LSCD_DEFINE_ENTRY(lscd_spmm_splitk_grouped_launch, true, true)
