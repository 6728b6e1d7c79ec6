// Split-K LSCD SpMM: f32 partials over S K slices, then a reduce.
//
// Replaces the TPU kernel repro/kernels/spmm.py:lscd_spmm_splitk (partials
// body _lscd_spmm_splitk_kernel, reduce _splitk_reduce_kernel; pallas_calls
// at :535 and :570). Bound on an H100: the weight words over 3.35 TB/s plus
// the 8*S*M*N partials bytes. Design: see lscd_common.cuh (at decode N the
// body of lscd_decode.cuh) — the grid gains a K-slice axis so a decode
// launch (one N tile) puts Mt*S blocks in flight;
// the ragged last slice simply walks fewer tiles; the reduce sums slices in
// a fixed order without atomics and applies bias + epilogue + one cast,
// bit-identical to the single-pass kernel at S=1.
#include "lscd_common.cuh"

LSCD_DEFINE_ENTRY(lscd_spmm_splitk_launch, true, false)
