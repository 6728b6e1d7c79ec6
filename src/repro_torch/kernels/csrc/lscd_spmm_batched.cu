// Expert-batched single-pass LSCD SpMM: C[e] = decode(A[e]) @ B[e] for the
// E experts of a stacked Tiled-CSL weight, in one launch.
//
// Replaces jax.vmap over the TPU kernel repro/kernels/spmm.py:lscd_spmm
// (repro/models/moe.py:_expert_ffn), which Pallas's batching rule turns
// into one pallas_call (:247) with the expert axis in its grid. Bound on
// an H100 as lscd_spmm: the E experts' words over 3.35 TB/s at decode N,
// the tensor cores at prefill N. Design: lscd_common.cuh — the bodies of
// lscd_spmm with the expert as one more grid index, each block reading
// its expert's words, counts and B rows and writing its expert's C.
#include "lscd_common.cuh"

LSCD_DEFINE_BATCHED_ENTRY(lscd_spmm_batched_launch, false)
