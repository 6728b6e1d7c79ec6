// Expert-batched split-K LSCD SpMM: f32 partials [S, E, M, N] of the E
// experts of a stacked Tiled-CSL weight in one launch, then one reduce.
//
// Replaces jax.vmap over the TPU kernel
// repro/kernels/spmm.py:lscd_spmm_splitk (partials :535, reduce :570) in
// repro/models/moe.py:_expert_ffn. Bound on an H100: the experts' words
// over 3.35 TB/s plus the 8 * S * E * M * N partials bytes, so
// schedule.select folds the expert count into its grid-fill term and
// splits K only while the E * Mt blocks leave SMs idle. Design:
// lscd_common.cuh — the decode body's grid gains the expert index (z =
// slice * E + e); the reduce sums the slices of all E experts' outputs,
// as E * M rows, in slice order.
#include "lscd_common.cuh"

LSCD_DEFINE_BATCHED_ENTRY(lscd_spmm_splitk_batched_launch, true)
