// LSCD SpMM, single pass: C[M, N] = epilogue(decode(A) @ B + bias).
//
// Replaces the TPU kernel repro/kernels/spmm.py:lscd_spmm (body
// _lscd_spmm_kernel, pallas_call at :247): grid (Mt, Nt, Kt) with the K walk
// as a loop inside each block, since blocks on the card run in no order.
// Bound on an H100: the weight words, 4 bytes per kept weight, over
// 3.35 TB/s at decode N; the dense FLOPs at prefill N. Design: see
// lscd_common.cuh (decode N: lscd_decode.cuh; prefill N: hopper_pipe.cuh)
// — one block per (m tile, n tile), empty tiles skipped, f32 accumulators
// in registers, bias + unary epilogue + one cast at the flush, so MLP up +
// GELU writes the activated C once.
#include "lscd_common.cuh"

LSCD_DEFINE_ENTRY(lscd_spmm_launch, false, false)
