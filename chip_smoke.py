#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the numbers it prints). In order it

1. prints the card's name and power limit and builds the seven CUDA
   kernels (six LSCD SpMM kernels, two of them expert-batched for the
   MoE stacks, and the dense GEMM baseline) from
   ``src/repro_torch/kernels/csrc`` with ``nvcc`` (one process per
   source, all at once), and fails if ``ptxas`` reports a spill, a
   serialized ``wgmma`` (C7518) or an ignored ``setmaxnreg`` (C7508) in
   a body that runs ``wgmma``; it prints each body's counts;
2. kernel phase: holds each kernel against its plain PyTorch version on
   the card — small shapes over the three tile geometries, empty tiles,
   ragged N, bias, every epilogue, S=1 and a ragged S, the split-K S=1
   bit-match at every N tile, ``dense_gemm`` over f32/bf16 inputs and
   outputs and against ``lscd_spmm`` on the same matrix — then at the
   OPT-30B projection shapes (sparsity 0.8, bf16) at decode N=8 and
   prefill N=1024 (and N=16, 32 for down and wqkv, the decode body's
   range), where it times each kernel, its plain version,
   ``dense_gemm`` on the decoded weight (at N = 1024 twice: at n_tb =
   128, the LSCD kernels' tile, and at 256, its own widest, each with its
   share of the bound) and ``torch.matmul`` on it with CUDA events, and
   prints one comparison row per shape and N (the
   paper's kernel-level comparison) and the body each launch runs; at
   N=8 it sweeps the split S over 1, 2, 4, 8, 16 with ``select``'s pick
   marked, and, for down and wqkv, the decode body's ring depth;
3. slice phase: serves 8 requests (128-token prompts from the seed, 32
   greedy new tokens) through ``repro_torch.launch.serve`` at OPT-30B
   width with the layer count cut to 4, reads the kernels' launch counts
   (all four LSCD kernels must have launched), holds the first decode step's logits
   against the same model run through the plain versions, and profiles
   one prefill and a few decode steps for the device's busy share;
4. serving phase: continuous batching through
   ``repro_torch.serving.api.StreamingServer`` on the same model (16
   slots, max_len 512, 32 requests of 32-384 prompt tokens from the
   seed, 64 greedy new tokens each): the closed loop with the dense cache
   and the decode step as a CUDA graph, again with the graph off, and with
   the paged cache (streams must be identical across the three, and all
   four LSCD kernels must launch, graph replays counted); an open-loop
   Poisson replay (``serving.loadgen``, 0.125 requests per step) on the
   paged server; the first decode step's logits of 4 requests against
   the same server on the plain versions; one profiled graphed and
   eager decode step; and every launch configuration the serving runs
   made (kernel, weight, N, N tile, split S, epilogue: the split-K pair
   at decode and wherever ``select`` splits a prefill) held against its
   plain version on the same weight. It prints tokens/s, decode ms/step
   with the graph on and off, TTFT/TPOT p50/p99, the prefill shapes, the
   launches of prefill and of decode, peak blocks and the device's busy
   share. Last it admits a request of 32 tokens and then one that shares
   its two prompt blocks from the 512-token bucket: the shared blocks'
   bytes must not change and the first request's stream must equal its
   run alone (it prints the same pair written as the reference writes
   it, the whole block map, for comparison), and reports the same pair
   on the chunked server (chunk 16, budget 32), where B's chunks write
   A's blocks again from position 0;
5. window phase: speculative verify and chunked prefill on the serving
   phase's model, server (paged) and trace, against its paged graphed
   run: (a) spec_k = 3 with ``NgramDrafter`` and (b) chunked prefill
   (chunk 16, budget 32), each with the graph on and off (identical
   streams), each against the plain streams by the near-tie rule (where
   a stream first differs, the plain top-2 margin must be below
   ``NEAR_TIE``), and (c) a self-draft (``DraftModelDrafter`` on the
   target's own params, 8 requests of 32-128 tokens), where every
   rejected draft must sit at a near tie; the first verify step's logits
   against plain decode's at the same positions (``LOGITS_TOL``); clean
   pools after every drain, one capture a graph, and every launch
   configuration of the verify and mixed steps (N = 64 and 256) and of
   the self-draft's rollout against its plain version. It prints the
   graphed verify and mixed ms/step against graphed decode, the accept
   rates, tok/s and TTFT/TPOT against the plain run, and one profiled
   verify and mixed step by kernel;
6. analysis phase: the port's static checkers
   (``repro_torch.analysis``, ``tools/torch_check.py``) on the same
   model, after the serving and window phases: the kernel pass (the
   selector's six canonical cells, KC-ACC over the CUDA sources, KC-OUT
   over the model files) and the live schedule cache held against the
   launch contract at each weight's ``max_nnz``; the lint; the trace
   audit on a paged stepper at the serving phase's 16 slots and max_len
   512 with verify (spec_k 3) and mixed (chunk 16) enabled, sampled at
   T = 0.7: a dispatch census of one eager step of each op (TA-UPCAST
   copies and bytes, host syncs), every bucket twice against the capture
   budgets, the eager bodies and graph replays under
   ``set_sync_debug_mode("error")``, each replay's launches against the
   layers' Tiled-CSL weights; and the observability replay at the smoke
   config on the card. Any live finding or stale entry of
   ``tools/torch_check_allowlist.json`` fails the run; it prints the
   findings per pass, live and suppressed, and each figure beside the
   card's name and power limit;
7. full-depth phase: prints the planner's sparse and dense plans for
   OPT-30B, OPT-66B and OPT-175B at 80 GB (``serving.budget``), builds
   OPT-30B at all 48 layers layer by layer (``serve.build``), prints its
   built against its planned weight bytes, holds the first decode step
   against the plain path at 4 and 48 layers
   (``depth_logits_tol``), then serves 32 requests (128-768 prompt
   tokens, 64 greedy new tokens) through ``StreamingServer`` over 32
   slots at max_len 1024 from the pool ``budget.plan`` sizes (paged,
   graph on): all four LSCD kernels must launch, every launch
   configuration must pass its plain version, and peak allocated bytes
   must stay within the 80 GB budget. It prints decode ms/step, the first
   call, tok/s, TTFT/TPOT p50/p99 and peak blocks, then runs
   ``schedule.autotune`` on the four projections at N = 16 and 32 into a
   cache file of its own beside ``select``'s analytic pick (serving never
   reads a cache);
8. tinyllama phase: tinyllama_1_1b at full size served through the same
   server (16 slots, max_len 512, 16 requests, 32 new tokens): GQA and
   the grouped ``gate_up`` ``silu_mul`` launch on a served path, every
   launch configuration against its plain version, and the first decode
   step against the plain path;
9. examples phase: the port's four examples (``examples/torch_*.py``):
   (a) the quickstart at its own shape (1024 x 1024, N = 16, 0.8): its
   kernel's output against ``kernels.ref.spmm_dense_oracle`` within the
   bf16 rounding of the encoded values and against the plain version;
   (b) the lifecycle's functions at tinyllama-1.1b's published widths,
   4 layers: 30 f32 AdamW steps (peak lr 3e-4) at batch 4 x 128 on
   ``SyntheticLM`` (a held-out batch's loss lower than at the start),
   masks by ``pruning.opt_style_plan`` on the MLP (layers 0 and 3 kept
   dense) and 0.8 on attention, 10 steps with the masks (losses finite,
   the kept weights moved, no masked weight nonzero after any step),
   the attention reformatted
   to Tiled-CSL, 8 requests of 8 tokens (12 new) through
   ``ContinuousBatcher`` (4 slots, max_len 64) through the kernels and
   through the plain versions (streams equal, or parted at a near tie),
   every launch configuration against its plain version; (c)
   ``torch_serve_batched.py --arch tinyllama_1_1b`` and
   ``torch_serve_chaos.py`` at their defaults on smoke weights, drained
   clean, the chaos survivors bitwise the fault-free replay's (their
   output in ``chiprun_out/examples.log``);
10. MLA phase: minicpm3_4b (Multi-head Latent Attention). First one
   layer at full width with every factor (w_dq 768x2560, w_uq 3840x768,
   w_dkv 288 rows padded to 384 x 2560, w_ukv 5120x256, wo and the MLP)
   in Tiled-CSL against the same layer on the plain versions: prefill
   (N = 1024), decode at a 0-d and a per-slot position, paged decode
   (N = 32) and a verify window of 4 (N = 128), and w_ukv (which the
   absorbed steps decode rather than launch) at N = 32 directly, then
   every launch configuration held against its plain version and timed.
   Then
   the full 62 layers built layer by layer (``serve.build``: wo and the
   MLP in Tiled-CSL, the latent factors dense), built against planned
   bytes and the planner's blocks at 80 GB, first-step logits against
   the plain path at 4 and 62 layers (``depth_logits_tol``), and 32
   requests (128-768 prompt tokens, 64 greedy new tokens) over 32 slots
   at max_len 1024: dense graph on, paged graph on and paged graph off
   (identical streams), and spec_k 3 with n-gram drafts on the paged
   server (the verify graph over the latent pool, the near-tie rule at
   ``NEAR_TIE`` against the paged streams, clean pools); all four LSCD kernels must launch, every launch
   configuration must pass its plain version; it prints decode and
   verify ms/step, tok/s, TTFT/TPOT p50/p99, peak allocated bytes, the
   accept rate and a profiled graphed decode and verify step by kernel;
11. MoE phase: first one qwen2-moe-a2.7b layer at full width (60
   experts at d_expert 1408, the fused 5632-wide shared expert, wqkv with
   the q/k/v bias) with every weight but the router in Tiled-CSL: the
   attention and the MoE block (on the same normalised input, so both
   sides route alike) against their plain versions in prefill (2 x 512),
   decode and paged decode (32 slots), every launch configuration held
   against its plain version and timed. Then qwen3-moe-30b-a3b at all 48
   layers (128 experts top-8 at d_expert 768) built layer by layer with
   its expert stacks in Tiled-CSL, the planner's plans and built against
   planned bytes, first-step logits against the plain path at 4 and 48
   layers with the kernels' routes pinned to the plain run's
   (``depth_logits_tol``, ``LOGITS_TOL`` at 4; where a route differed
   before the pin, the first one that did must sit at a router near tie,
   both sides' top-k margins below ``NEAR_TIE``), 32 requests (128-768 prompt tokens, 64
   greedy new tokens) over 32 slots at max_len 1024 from the planner's
   pool, dense graph on, paged graph on and paged graph off (identical
   streams, clean pools), every launch configuration against its plain
   version, ``select``'s pick per expert shape, a profiled graphed
   decode step, and the two batched kernels at the decode cell timed
   beside their plain versions and ``torch.bmm``;
12. hybrid phase: first one RG-LRU block and one local-attention block
   of recurrentgemma-9b at full width (the MLP and the attention in
   Tiled-CSL, the RG-LRU projections dense) against their plain versions
   in prefill (2100 positions: past the 2048-position window, the roll
   into the ring, the q-chunked branch) and decode (32 slots, positions
   up to 4096, a random carried state and a full ring), every launch
   configuration held against its plain version and timed. Then
   recurrentgemma-9b at all 38 layers built layer by layer (every leaf
   its own ``max_nnz``, as the reference's unrolled stack), built against
   dense bf16 bytes, first-step logits against the plain path
   (``depth_logits_tol``) at 4 layers, at 4 layers past the wrap
   (2100-token prompts), and at 38 layers in f32 (with the engine's
   bf16 K/V cache, and again with an f32 one through
   ``transformer.forward``, printed beside it) and teacher-forced in
   bf16 (each layer's kernels on the plain path's input of that layer),
   with each layer's share of the free-running bf16 gap printed, 32
   requests (24 of 128-1983 prompt tokens, 4 of 1990-2040
   whose decode crosses the wrap, 4 of 2049-2300 longer than the window;
   64 greedy new tokens) over 32 slots at max_len 4096 on the dense cache
   with exact-length admission, graph on and off (identical streams,
   clean slots), all four LSCD kernels launched, the projection each
   launch served, every launch configuration against its plain version,
   ``select``'s pick per shape, a profiled graphed decode step, and
   ``gate_up`` and ``down`` at decode N = 32 beside their bound and
   ``torch.matmul``. Last the ring on the paged path: tinyllama at full
   width cut to 4 layers with a 64-position window, 16 requests past the
   wrap, the paged ring (block 16) graph on and off equal to the dense
   ring's streams, spec_k 3 graph on and off equal to each other and to
   the dense ring's by the near-tie rule, clean pools;
13. SSM phase: one mamba2-130m SSD block at full width in f32, its
   chunked prefill's final state and conv cache against the same input
   fed token by token through ``ssm_decode`` at 1, 255, 256, 257 and
   2047 positions (within 1e-4 relative); mamba2-130m built at its 24
   layers (no weight encoded: the launcher's list names no SSM weight,
   so no LSCD kernel runs on this path), the bf16 first-step logits
   against the same stack in f32 (teacher-forced within
   ``depth_logits_tol``, free-running printed, first tokens equal but at
   near ties); 32 requests of 128-3000 prompt tokens (64 greedy new
   tokens) over 32 slots at max_len 4096 on the dense cache with
   exact-length admission, graph on and off (identical streams, clean
   slots), and a profiled graphed decode step;
14. vlm phase: qwen2-vl-2b at its 28 layers (M-RoPE, GQA with the q/k/v
   bias, every projection Tiled-CSL), first-step logits against the
   plain path at 4 and 28 layers, an ``engine.prefill`` with an
   ``embeds`` prefix (a 16 x 16 patch grid at t = 0 with distinct h and
   w ids, then text) against the plain path, 32 requests (128-768 prompt
   tokens, 64 new) over 32 slots at max_len 1024: dense graph on, paged
   graph on and paged graph off (identical streams, clean pools), all
   four LSCD kernels launched, every launch configuration against its
   plain version, ``select``'s picks and a profiled graphed step;
15. audio phase: musicgen-large at its 48 layers (MHA, LayerNorm, GELU
   with biases, 4 codebooks), first-step logits against the plain path
   at 4 and 48 layers (one row a request and codebook), the batcher's
   refusal of a codebook config, and ``engine.generate`` on 8 prompts
   of [4, 256] for 64 greedy frames (all four LSCD kernels launched,
   every launch configuration against its plain version, frames/s);
16. train phase: tinyllama_1_1b at full width, its first 8 of 22 layers
   (``TRAIN_LAYERS``, ``launch.train --layers``), trained through ``launch/train.py``'s functions: f32 params, AdamW at
   the launcher's defaults, 0.8 masks by the reference launcher's rule,
   ``SyntheticLM`` batches of 8 x 512, 30 steps (every loss finite, the
   mean of the last 5 below step 1's, no masked weight nonzero after any
   step), ms/step and tokens/s over steps 6-30 and the peak allocated
   bytes, step 1's loss and gradient norm with bf16 compute beside f32
   compute; an asynchronous checkpoint at step 15, ``--resume`` from it
   through step 20 bit for bit against the straight run (deterministic
   algorithms; an op without a deterministic kernel is named and the
   gate falls back to the losses within 1e-3); one 4-layer f32 step on
   the card against the CPU (loss within 1e-4, each gradient leaf within
   1e-3 of its largest value); then the step-30 checkpoint read through
   ``convert.params_from_checkpoint`` and built at 0.8 with its trained
   masks (each encoded ``nnz`` equal to its mask's count), served over
   16 slots (16 requests of 32-384 tokens, 32 new) graph on and off
   (identical streams) with the kernel profiler on, its drift table of
   CUDA-event times (beside the kernel table's time where a shape is
   shared), first-step logits within ``depth_logits_tol(8)``, every
   launch configuration against its plain version, and a
   ``StreamingServer`` snapshot after step 8 restored into a new server:
   each (session, index) delivered once, every token streamed before the
   snapshot the uninterrupted run's, and after it equal to it or parted
   at a near tie (the restored sessions re-prefill their tokens);
17. mesh phase: four ranks share the card over gloo
   (``launch.mesh.run_world``; NCCL refuses two ranks on one device).
   (a) OPT-30B at full width, sparsity 0.8, tensor-parallel over a 1x4
   mesh: first the unsharded model in this process (first decode step
   and ``engine.generate``'s greedy streams of 8 prompts of 128 tokens,
   32 new, at the 2 layers built, each step's top-2 margins
   recorded; max_len 160 in every run, so the K/V lies sequence over
   ``model``), then four ranks, each building its shard layer by layer
   (``serve.build(mesh=)``): the ranks' encoded non-zeros summing to the
   unsharded build's, first-step logits (teacher-forced with the
   unsharded first tokens) within ``LOGITS_TOL``, every rank's streams
   equal and equal
   to the unsharded ones or parted at a near tie (``NEAR_TIE``), all four
   LSCD kernels launched on every rank, each rank's launch
   configurations held against the plain versions, per-rank bytes,
   peaks, prefill and decode times and a profiled sharded decode step.
   The same four ranks then serve the families, each built at 3 layers
   (``MESH_FAMILY_BUILD_LAYERS``): qwen3-moe-30b-a3b (expert
   parallelism, 32 experts a rank), minicpm3_4b (MLA, 10 heads a rank,
   the latents whole), recurrentgemma-9b (RG-LRU and MLP widths split,
   the window ring's slots over model), mamba2-130m (``in_proj`` split
   and gathered whole, the scan whole on every rank), qwen2-vl-2b
   (M-RoPE with distinct t/h/w ids) and musicgen-large (a codebook a
   rank of the head), each built with the ranks in
   turn and their 3 layers served the same way against the
   unsharded models (run in this process before the world: built whole,
   non-zeros, first step, streams, each MoE call's routes): the ranks'
   non-zeros, each leaf the rules leave whole counted once, the whole
   build's; each rank's every leaf the slice of the whole build (by
   digest); first-step logits within ``LOGITS_TOL`` with qwen3-moe's
   routes pinned to the unsharded run's (``RouteTrace``), its first
   flip before the pin at a router near tie; recurrentgemma's and
   mamba2's first step, and recurrentgemma's one 2100-token request
   whose ring wraps, with f32 activations free-running through every
   layer within ``MESH_F32_TOL`` (their bf16 figure printed); streams
   equal or parted at a near tie of the logits or after a route flip at
   a router near tie; the decode pair (and, for MoE, a batched kernel)
   launched on every rank; every launch configuration against its plain
   version; and, for qwen3-moe and minicpm3, the dry run of each rank's
   decode cell against what ran: every leaf's per-rank elements and the
   LSCD launch list, but for the struct's known differences from the
   build (lm_head, the norm scales, MoE's routed stacks, MLA's latent
   factors), each held to be exactly that.
   (b) tinyllama-1.1b at its published widths, its first 2 layers
   (``MESH_TRAIN_LAYERS``, ``launch.train --layers``), on a 2x2 mesh,
   0.8 masks, global batch 4 x 512: the unsharded step 1 in this process,
   then four ranks (the launcher's ``setup`` under the mesh): the
   compressed all-reduce of each step-1 gradient leaf over ``data``
   within world x max|g| / 127, step 1's loss and gradient norm within
   5e-3 relative and every param within 5e-3 of the unsharded step,
   masked weights at zero after every step, five steps, a save from 2x2,
   its restores onto 1x4 (a mesh over the same ranks) and onto one rank
   with every leaf's position-weighted checksums equal to the saved
   state's, and step 6 on the 1x4 restore within 5e-3 of step 6 on 2x2.
   The same world then trains each family one masked f32 step (f32
   params and compute, donated) at its published widths, recurrentgemma
   ZeRO-3, the depth cut to fit four ranks on the card
   (``MESH_TRAIN_FAMILIES``: qwen3-moe-30b-a3b 1 layer of 128 experts,
   minicpm3_4b 4, recurrentgemma-9b 3, mamba2-130m 24, qwen2-vl-2b 4 with
   distinct t/h/w ids, musicgen-large 4), global batch 4 x 256, each
   against its unsharded step run in this process before the world (its
   new params on the host): loss and grad norm within 5e-3 relative,
   every param within 5e-3, update misses within 0.25, masked weights
   zero, no raw collective reached with gradients on; each rank's
   ms/step and peak allocated bytes printed, each family freed before
   the next;
18. cells phase: the dry run (``launch.dryrun``) of every arch x cell
   on the 16x16 and 2x16x16 meshes in both weight modes, in worker
   processes that see no card, run beside the kernels' build and ended
   before the first timed phase: every cell of every family ok (138 of
   164), the train x sparse_xla cells errors naming ROADMAP.md queue 3
   item 13; the dry run of this phase's cells leaves the card's allocated
   memory as it was. Then tinyllama-1.1b at 0.8, its first 8 of 22
   layers (``CELLS_LAYERS``), on 2x2, four ranks
   sharing the card over gloo: decode with the sequence over ``model``
   (8 prompts of 1000-3000 tokens, max_len 4096, 32 greedy steps) and at
   batch 1 with the sequence over ``data`` (3000 tokens), each against
   the unsharded model (first-step logits within
   ``depth_logits_tol(8)``, streams by the near-tie rule, every launch
   configuration against its plain version), one ZeRO-3 step against
   the mesh phase's unsharded step 1 (loss, grad norm and params within
   5e-3, masks held), and the dry run of the three cells against what
   ran (every leaf's elements, each rank's decode-step LSCD launches);
19. prints the kernels' JSON line (launches of the slice, the serving
   runs, the window runs, the analysis phase's steps, the full-depth
   run, the tinyllama run, the examples, the MLA runs, the MoE runs,
   the hybrid runs, the ring runs and the ssm, vlm, audio, train, mesh
   and cells runs (the mesh's summed over its ranks, the families'
   included, beside the families' alone and one rank's OPT-30B
   launches), the serving ones also by prefill and decode, the window
   ones also by verify and mixed), the card line, and last ``{"ok": true, "device": {...}}``;
   the full summary goes to ``chiprun_out/chip_smoke.json``.

Any failure raises and exits non-zero. The plain versions run with
``torch.backends.cuda.matmul.allow_tf32 = False`` (full f32 matmuls).
The script sets ``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True``
unless the environment sets it (``ALLOC_CONF``), and
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` likewise (``CUBLAS_WORKSPACE``: the
train phase's deterministic resume needs it).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
SPARSITY = 0.8
F32_TOL = dict(rtol=1e-5, atol=1e-5)   # f32 sums in another order
# bf16: one bf16 ulp (2^-7 relative), plus 1e-3 of the largest output for
# the f32 sum itself. The tensor cores add each mma's products into the
# f32 accumulator with truncation, so a sum over K drifts by up to about
# (K / 16) * 2^-23 of its magnitude (2e-4 at K = 28672), and the plain
# version's sum drifts on its own; an output near zero carries that drift.
BF16_TOL = dict(rtol=8e-3, atol=1e-5, atol_of_max=1e-3)
LOGITS_TOL = 3e-2                      # bf16 model logits
SOURCES = {
    "lscd_spmm": "src/repro/kernels/spmm.py:204",
    "lscd_spmm_grouped": "src/repro/kernels/spmm.py:348",
    "lscd_spmm_splitk": "src/repro/kernels/spmm.py:497",
    "lscd_spmm_splitk_grouped": "src/repro/kernels/spmm.py:641",
    "dense_gemm": "src/repro/kernels/gemm.py:46",
    # jax.vmap over lscd_spmm / lscd_spmm_splitk (repro/models/moe.py:52-60)
    "lscd_spmm_batched": "src/repro/kernels/spmm.py:204",
    "lscd_spmm_splitk_batched": "src/repro/kernels/spmm.py:497",
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

BODIES = {"lscd_decode_kernel": "decode", "lscd_pipe_kernel": "pipelined",
          "lscd_kernel": "first", "gemm": "dense_gemm"}


# ptxas warnings that cost the wgmma bodies their speed: wgmma serialized
# (C7518), setmaxnreg ignored (C7508).
PTXAS_WARNINGS = ("C7518", "C7508")
# Bodies that run wgmma: a spill or a warning in one of them (or in a
# kernel of no known body) fails the build phase.
WGMMA_BODIES = ("pipelined", "dense_gemm", "other")


def ptxas_report(log: str) -> dict:
    """Per body, from a build log's ``ptxas -v`` report: the kernels whose
    spill stores or loads are not zero, and the count of each warning in
    ``PTXAS_WARNINGS``, given to the body its line names (else to the kernel
    being compiled, else to "other")."""
    def body_of(line, default):
        return next((b for key, b in BODIES.items() if key in line), default)

    counts, kernel = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            kernel = body_of(ln, "other")
            counts.setdefault(kernel, dict.fromkeys(
                ("spills",) + PTXAS_WARNINGS, 0))
        code = next((c for c in PTXAS_WARNINGS if c in ln), None)
        if code is not None:
            body = body_of(ln, kernel or "other")
            c = counts.setdefault(body, dict.fromkeys(
                ("spills",) + PTXAS_WARNINGS, 0))
            c[code] += 1
        elif "spill stores" in ln and kernel is not None:
            found = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", ln)
            counts[kernel]["spills"] += int(
                bool(found) and found.groups() != ("0", "0"))
    return counts


def sparse_weight(torch, pruning, tiled_csl, gen, m, k, *, m_tb=128,
                  k_tb=128, empty_tile=False):
    w = torch.randn((m, k), generator=gen, device="cuda")
    if empty_tile:
        w[:m_tb, :k_tb] = 0.0
    return tiled_csl.encode(pruning.prune(w, SPARSITY), m_tb=m_tb, k_tb=k_tb)


def close(torch, got, want, tol, what):
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} "
          f"!= {tuple(want.shape)}")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{what}: non-finite output")
    err = (g - w).abs()
    atol = tol["atol"] + tol.get("atol_of_max", 0.0) * float(w.abs().max())
    over = err - (atol + tol["rtol"] * w.abs())
    if bool((over > 0).any()):
        i = int(over.argmax())
        raise SmokeFailure(
            f"{what}: {int((over > 0).sum())} elements off, max abs err "
            f"{float(err.max()):.3e}; worst: got {float(g.flatten()[i])!r} "
            f"want {float(w.flatten()[i])!r} (atol {atol:.3e})")
    return float(err.max())


def release(torch) -> None:
    """Free what a finished run held: a stepper whose methods the serving
    phases wrap sits in a reference cycle, so its cache and graph pool go
    only at a collection."""
    gc.collect()
    torch.cuda.empty_cache()


def cuda_ms(torch, fn, reps: int, flush) -> float:
    """Mean device time of one call of ``fn``: each of ``reps`` calls is
    timed alone with CUDA events after ``flush`` (1 GiB) is rewritten. The
    decode loop streams every layer's weights, so a launch finds its words
    cold in the 50 MB L2; the write also keeps the card busy while the host
    enqueues the call, so host time stays out of the reading."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def small_checks(torch, mods) -> int:
    """Every kernel against its plain version at small shapes."""
    tiled_csl, pruning, ops, ref, spmm, contracts, gemm = (mods[n] for n in (
        "tiled_csl", "pruning", "ops", "ref", "spmm", "contracts", "gemm"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    m, k = 256, 384                              # Kt = 3 (k_tb 128)
    n_checks = 0
    for m_tb, k_tb in ((128, 128), (64, 128), (128, 64)):
        ts = [sparse_weight(torch, pruning, tiled_csl, gen, m, k, m_tb=m_tb,
                            k_tb=k_tb, empty_tile=True) for _ in range(3)]
        g2, g3 = tiled_csl.group_stack(ts[:2]), tiled_csl.group_stack(ts)
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            for n in (1, 7, 16, 130):
                b = (0.1 * torch.randn((k, n), generator=gen,
                                       device="cuda")).to(dtype)
                bias = torch.randn((m,), generator=gen, device="cuda")
                bias3 = torch.randn((3, m), generator=gen, device="cuda")
                for epi in ("none", "silu", "gelu", "relu"):
                    for bs in (None, bias):
                        for s in (1, 2):
                            got = ops.spmm(ts[0], b, backend="cuda",
                                           split_k=s, epilogue=epi, bias=bs)
                            want = ref.spmm_splitk_ref(
                                ts[0], b, s, out_dtype=dtype, epilogue=epi,
                                bias=bs)
                            close(torch, got, want, tol,
                                  f"spmm S={s} {epi} {m_tb}x{k_tb} n={n}")
                            n_checks += 1
                    for s in (1, 3):
                        got = ops.spmm_grouped(g3, b, backend="cuda",
                                               split_k=s, epilogue=epi,
                                               bias=bias3)
                        want = ref.spmm_splitk_grouped_ref(
                            g3, b, s, out_dtype=dtype, epilogue=epi,
                            bias=bias3)
                        close(torch, got, want, tol,
                              f"grouped G=3 S={s} {epi} n={n}")
                        n_checks += 1
                for epi in ("silu_mul", "gelu_mul"):
                    for s in (1, 2):
                        got = ops.spmm_grouped(g2, b, backend="cuda",
                                               split_k=s, epilogue=epi,
                                               bias=bias3[:2])
                        want = ref.spmm_splitk_grouped_ref(
                            g2, b, s, out_dtype=dtype, epilogue=epi,
                            bias=bias3[:2])
                        close(torch, got, want, tol,
                              f"grouped G=2 S={s} {epi} n={n}")
                        n_checks += 1
            # every N tile the kernels are built for, pinned
            for n_tb in (8, 16, 32, 64, 128):
                b = (0.1 * torch.randn((k, 2 * n_tb), generator=gen,
                                       device="cuda")).to(dtype)
                got = spmm.lscd_spmm(ts[1], b, n_tb=n_tb, epilogue="gelu",
                                     bias=bias)
                close(torch, got, ref.spmm_ref(ts[1], b, out_dtype=dtype,
                                               epilogue="gelu", bias=bias),
                      tol, f"lscd_spmm n_tb={n_tb}")
                n_checks += 1
                for g, epi in ((g2, "silu_mul"), (g3, "gelu")):
                    if contracts.check_launch(
                            m, k, 2 * n_tb, m_tb=m_tb, k_tb=k_tb, n_tb=n_tb,
                            split_k=1, group=g.group,
                            binary=epi.endswith("_mul"),
                            b_dtype_bytes=b.element_size()):
                        continue                # too many accumulators
                    gb = bias3[:g.group]
                    got = spmm.lscd_spmm_grouped(g, b, n_tb=n_tb,
                                                 epilogue=epi, bias=gb)
                    close(torch, got, ref.spmm_grouped_ref(
                        g, b, out_dtype=dtype, epilogue=epi, bias=gb),
                        tol, f"lscd_spmm_grouped G={g.group} n_tb={n_tb}")
                    n_checks += 1
            # split_k == 1 is bit-identical to the single-pass kernels, on
            # both bodies (n_tb <= 32: first body; >= 64 bf16: pipelined)
            for n_tb in (8, 64, 128):
                b = (0.1 * torch.randn((k, n_tb), generator=gen,
                                       device="cuda")).to(dtype)
                one = spmm.lscd_spmm(ts[2], b, n_tb=n_tb, epilogue="gelu",
                                     bias=bias)
                s1 = spmm.lscd_spmm_splitk(ts[2], b, n_tb=n_tb, split_k=1,
                                           epilogue="gelu", bias=bias)
                check(torch.equal(one, s1),
                      f"split-K S=1 != single pass, n_tb={n_tb}")
                n_checks += 1
                for g, epi in ((g3, "silu"), (g2, "silu_mul")):
                    if contracts.check_launch(
                            m, k, n_tb, m_tb=m_tb, k_tb=k_tb, n_tb=n_tb,
                            split_k=1, group=g.group,
                            binary=epi.endswith("_mul"),
                            b_dtype_bytes=b.element_size()):
                        continue                # too many accumulators
                    gb = bias3[:g.group]
                    one = spmm.lscd_spmm_grouped(g, b, n_tb=n_tb,
                                                 epilogue=epi, bias=gb)
                    s1 = spmm.lscd_spmm_splitk_grouped(g, b, n_tb=n_tb,
                                                       split_k=1,
                                                       epilogue=epi, bias=gb)
                    check(torch.equal(one, s1), f"grouped G={g.group} "
                          f"split-K S=1 != single pass, n_tb={n_tb}")
                    n_checks += 1
    # an all-empty weight gives exactly the bias
    z = tiled_csl.encode(torch.zeros((128, 256), device="cuda"))
    b = torch.randn((256, 8), generator=gen, device="cuda")
    bias = torch.randn((128,), generator=gen, device="cuda")
    got = ops.spmm(z, b, backend="cuda", epilogue="none", bias=bias)
    check(torch.equal(got, bias[:, None].expand(128, 8)), "empty weight")
    bb = torch.randn((256, 128), generator=gen, device="cuda").to(
        torch.bfloat16)
    got = spmm.lscd_spmm(z, bb, n_tb=128, bias=bias)
    check(torch.equal(got, bias.to(torch.bfloat16)[:, None].expand(128, 128)),
          "empty weight, pipelined body")
    torch.cuda.synchronize()
    return n_checks + 2 + gemm_checks(torch, mods, gen)


def gemm_checks(torch, mods, gen) -> int:
    """``dense_gemm`` against its plain version over three geometries,
    f32 and bf16 inputs, f32 and bf16 outputs; and on ``decode(t)``
    against ``lscd_spmm`` on ``t`` (the same pruned matrix)."""
    tiled_csl, pruning, spmm, gemm = (mods[n] for n in (
        "tiled_csl", "pruning", "spmm", "gemm"))
    n_checks = 0
    for m_tb, k_tb, n_tb in ((128, 128, 128), (64, 128, 64), (128, 64, 128)):
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.randn((256, 384), generator=gen, device="cuda").to(dtype)
            b = torch.randn((384, 256), generator=gen, device="cuda").to(dtype)
            for out_dtype in (torch.float32, torch.bfloat16):
                got = gemm.dense_gemm(a, b, m_tb=m_tb, k_tb=k_tb, n_tb=n_tb,
                                      out_dtype=out_dtype)
                want = gemm.dense_gemm_ref(a, b, out_dtype=out_dtype)
                exact = dtype == out_dtype == torch.float32
                close(torch, got, want,
                      dict(rtol=1e-5, atol=1e-4) if exact else BF16_TOL,
                      f"dense_gemm {m_tb}x{k_tb}x{n_tb} {dtype} -> "
                      f"{out_dtype}")
                n_checks += 1
    for dtype, tol in ((torch.float32, dict(rtol=1e-5, atol=1e-4)),
                       (torch.bfloat16, BF16_TOL)):
        t = sparse_weight(torch, pruning, tiled_csl, gen, 256, 384,
                          empty_tile=True)
        b = (0.1 * torch.randn((384, 128), generator=gen,
                               device="cuda")).to(dtype)
        dense = gemm.dense_gemm(tiled_csl.decode(t).to(dtype), b,
                                out_dtype=dtype)
        close(torch, spmm.lscd_spmm(t, b, n_tb=128), dense, tol,
              f"lscd_spmm vs dense_gemm on the same matrix, {dtype}")
        n_checks += 1
    torch.cuda.synchronize()
    return n_checks


# Where the main path launches each kernel: the single-pass kernels at
# prefill (N = 8 requests x 128 prompt tokens), the split-K pair at decode
# (N = 8). These cells fill the kernels' JSON line.
# dense_gemm's path is the kernel-level comparison itself (no serving path
# calls it), at up, N = 1024. The decode body's range (n_tb up to 32) is
# timed also at N = 16 and 32 on these shapes.
DECODE_WIDE_SHAPES = ("down", "wqkv")
MAIN_PATH_CELLS = {"lscd_spmm": ("up", 1024),
                   "lscd_spmm_grouped": ("wqkv", 1024),
                   "lscd_spmm_splitk": ("down", 8),
                   "lscd_spmm_splitk_grouped": ("wqkv", 8),
                   "dense_gemm": ("up", 1024)}


def opt_shapes(torch, mods, flush):
    """Every kernel at the OPT-30B projection shapes (sparsity 0.8, bf16),
    on the schedule ``select`` picks: at decode N = 8 the single-pass
    kernels (S = 1) and the split-K pair (the selected S, at least 2); at
    prefill N = 1024 the single-pass kernels. Each is held against its
    plain version and timed beside it and beside ``torch.matmul`` on the
    decoded dense bf16 weight. ``dense_gemm`` runs on the same decoded
    weight (B padded to its 64-column tile at N = 8), held against its
    plain version; its launch count covers its timed runs, the
    comparison that is its path. Returns the rows, the main-path cells
    and the comparison rows (one per shape and N)."""
    tiled_csl, pruning, ref, spmm, schedule, roofline, gemm, contracts = (
        mods[x] for x in ("tiled_csl", "pruning", "ref", "spmm",
                          "schedule", "roofline", "gemm", "contracts"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    d, f = 7168, 28672
    shapes = {
        "wqkv": dict(m=d, k=d, g=3, epi="none", bias=True),
        "wo": dict(m=d, k=d, g=1, epi="none", bias=False),
        "up": dict(m=f, k=d, g=1, epi="gelu", bias=True),
        "down": dict(m=d, k=f, g=1, epi="none", bias=True),
    }
    rows, compare, sweep, rings = [], [], [], []
    gemm_launches = 0
    for name, s in shapes.items():
        ws = [sparse_weight(torch, pruning, tiled_csl, gen, s["m"], s["k"])
              for _ in range(s["g"])]
        grouped = s["g"] > 1
        t = tiled_csl.group_stack(ws) if grouped else ws[0]
        bias = None
        if s["bias"]:
            shape = (s["g"], s["m"]) if grouped else (s["m"],)
            bias = 0.1 * torch.randn(shape, generator=gen, device="cuda")
        plain_fn = ref.spmm_grouped_ref if grouped else ref.spmm_ref
        single = spmm.lscd_spmm_grouped if grouped else spmm.lscd_spmm
        split = (spmm.lscd_spmm_splitk_grouped if grouped
                 else spmm.lscd_spmm_splitk)
        nnz_real = int(t.nnz.sum())
        for n in (8, 16, 32, 1024):
            if n in (16, 32) and name not in DECODE_WIDE_SHAPES:
                continue
            b = (0.1 * torch.randn((s["k"], n), generator=gen,
                                   device="cuda")).to(torch.bfloat16)
            sel = schedule.select(s["m"], s["k"], n, m_tb=128, k_tb=128,
                                  max_nnz=t.max_nnz, group=s["g"])

            def plain():
                return plain_fn(t, b, out_dtype=b.dtype, epilogue=s["epi"],
                                bias=bias)
            want = plain()
            dense = tiled_csl.decode(t).to(torch.bfloat16)
            bound_s, bound_by = roofline.lscd_bound_s(
                4.0 * nnz_real, 4.0 * t.nnz.numel(), 2.0 * b.numel(),
                2.0 * want.numel() + (4.0 * bias.numel() if bias is not None
                                      else 0.0), 2.0 * nnz_real * n)
            plain_ms = cuda_ms(torch, plain, 3, flush)
            library_ms = cuda_ms(torch, lambda: torch.matmul(dense, b), 20,
                                 flush)
            # dense_gemm at the LSCD kernels' N tile (the Load-as-Sparse
            # comparison) and, at prefill N, at its own widest tile
            gemm_rows = []
            for n_tb in ((128, 256) if n % 256 == 0 else (64,)):
                r = dense_gemm_row(torch, gemm, roofline, dense, b, flush,
                                   n_tb, library_ms)
                gemm_launches += r.pop("launches")
                r.update(shape=name, m=s["m"], k=s["k"], n=n, group=s["g"],
                         kernel="dense_gemm", library_ms=library_ms)
                gemm_rows.append(r)
            rows.extend(gemm_rows)
            gemm_row = gemm_rows[0]
            gemm_best = min(gemm_rows, key=lambda r: r["ms"])
            del dense
            runs = [(single, 1)]
            if n <= 32:
                runs.append((split, max(sel.split_k, 2)))
            body = contracts.body(sel.n_tb)

            def timed(kern, sk):
                kw = dict(n_tb=sel.n_tb, epilogue=s["epi"], bias=bias)
                if kern is split:
                    kw["split_k"] = sk

                def fn():
                    return kern(t, b, **kw)
                err = close(torch, fn(), want, BF16_TOL,
                            f"{kern.__name__} at {name} {s['m']}x{s['k']} "
                            f"N={n} S={sk}")
                return err, cuda_ms(torch, fn, 20, flush)

            for kern, sk in runs:
                err, ms = timed(kern, sk)
                rows.append(dict(
                    shape=name, m=s["m"], k=s["k"], n=n, group=s["g"],
                    kernel=kern.__name__, n_tb=sel.n_tb, split_k=sk, ms=ms,
                    plain_ms=plain_ms, library_ms=library_ms,
                    bound_ms=bound_s * 1e3, bound_by=bound_by,
                    max_abs_err=err, selected=dataclasses.asdict(sel),
                    body=body, words_mib=t.words.numel() * 4 / 2 ** 20))
                print(f"  {name:5s} N={n:<5d}{kern.__name__:25s} "
                      f"n_tb={sel.n_tb:<3d} S={sk:<2d} {ms:8.3f} ms (bound "
                      f"{bound_s * 1e3:.3f} ms by {bound_by}, plain "
                      f"{plain_ms:.3f} ms, torch.matmul {library_ms:.3f} ms, "
                      f"max err {err:.2e}; select -> S={sel.split_k}; "
                      f"{body} body)", flush=True)
            if n == 8:                   # the S sweep: S = 1 is single pass
                for sk in schedule.SPLIT_LADDER:
                    err, ms = timed(single if sk == 1 else split, sk)
                    sweep.append(dict(shape=name, n=n, n_tb=sel.n_tb,
                                      split_k=sk, ms=ms, max_abs_err=err,
                                      bound_ms=bound_s * 1e3,
                                      selected=sk == sel.split_k))
                best_ms = min(r["ms"] for r in sweep if r["shape"] == name)
                for r in (r for r in sweep if r["shape"] == name):
                    r["vs_best"] = r["ms"] / best_ms
                    print(f"  sweep {name:5s} N=8 n_tb={r['n_tb']:<3d} "
                          f"S={r['split_k']:<2d} {r['ms']:8.3f} ms "
                          f"({100 * r['bound_ms'] / r['ms']:.1f}% of bound, "
                          f"{r['ms'] / best_ms:.3f}x best)"
                          f"{'  <- select' if r['selected'] else ''}",
                          flush=True)
                pick = next(r for r in sweep if r["shape"] == name
                            and r["selected"])
                print(f"  sweep {name:5s} N=8 select's S={pick['split_k']} "
                      f"is {'within' if pick['vs_best'] <= 1.05 else 'over'}"
                      f" 5% of the best S", flush=True)
            if n == 8 and name in DECODE_WIDE_SHAPES:
                rings.extend(ring_sweep(contracts, t, sel, name,
                                        lambda: timed(split, sel.split_k)))
            lscd_ms = min(r["ms"] for r in rows if r["shape"] == name
                          and r["n"] == n and r["kernel"] != "dense_gemm")
            dense_flops = 2.0 * s["g"] * s["m"] * s["k"] * n
            compare.append(dict(
                shape=name, n=n, lscd_ms=lscd_ms, dense_gemm_ms=gemm_row["ms"],
                dense_gemm_n_tb=gemm_row["n_tb"],
                dense_gemm_best_ms=gemm_best["ms"],
                dense_gemm_best_n_tb=gemm_best["n_tb"],
                matmul_ms=library_ms, bound_ms=bound_s * 1e3,
                dense_floor_ms=dense_flops / roofline.PEAK_FLOPS_BF16 * 1e3))
            c = compare[-1]
            print(f"  compare {name:5s} N={n:<5d} LSCD {c['lscd_ms']:.3f} ms, "
                  f"dense_gemm {c['dense_gemm_ms']:.3f} ms at n_tb="
                  f"{gemm_row['n_tb']} (LSCD - dense "
                  f"{c['lscd_ms'] - c['dense_gemm_ms']:+.3f}), best "
                  f"{gemm_best['ms']:.3f} ms at n_tb={gemm_best['n_tb']} "
                  f"({gemm_best['ms'] / library_ms:.2f}x torch.matmul), "
                  f"torch.matmul {library_ms:.3f} ms, bound "
                  f"{c['bound_ms']:.3f} ms, dense floor "
                  f"{c['dense_floor_ms']:.3f} ms", flush=True)
            del want
        del t, ws
        torch.cuda.empty_cache()
    best = {k: min((r for r in rows if r["kernel"] == k and r["shape"] == sh
                    and r["n"] == n), key=lambda r: r["ms"])
            for k, (sh, n) in MAIN_PATH_CELLS.items()}
    return rows, best, compare, sweep, rings, gemm_launches


def ring_sweep(contracts, t, sel, name, timed) -> list:
    """The split-K kernel at ``sel`` with the decode body's ring forced to
    each depth a block fits (the wrapper reads the depth from
    ``contracts.decode_ring_depth``): deeper rings keep more copies in
    flight but fewer blocks on an SM. Returns one row per depth."""
    kt = t.grid[1]
    steps = -(-kt // sel.split_k)
    rule = contracts.decode_ring_depth
    chosen = rule(t.m_tb, t.k_tb, sel.n_tb, t.max_nnz, steps)
    rows = []
    try:
        for depth in range(1, contracts.DECODE_MAX_RING + 1):
            smem = contracts.decode_smem_bytes(t.m_tb, t.k_tb, sel.n_tb,
                                               t.max_nnz, depth, steps)
            if smem > contracts.SMEM_BYTES_PER_BLOCK:
                break
            contracts.decode_ring_depth = lambda *a, _d=depth: _d
            err, ms = timed()
            rows.append(dict(shape=name, n=8, split_k=sel.split_k,
                             depth=depth, smem=smem, ms=ms, max_abs_err=err,
                             resident=contracts.decode_resident(
                                 t.m_tb, t.k_tb, sel.n_tb, t.max_nnz, depth,
                                 steps), chosen=depth == chosen))
            r = rows[-1]
            print(f"  ring {name:5s} N=8 S={sel.split_k:<2d} depth {depth}: "
                  f"{ms:8.3f} ms, {smem} B of shared memory, "
                  f"{r['resident']} blocks per SM"
                  f"{'  <- rule' if r['chosen'] else ''}", flush=True)
    finally:
        contracts.decode_ring_depth = rule
    return rows


def dense_gemm_row(torch, gemm, roofline, dense, b, flush, n_tb,
                   library_ms) -> dict:
    """``dense_gemm`` (bf16 in and out, 128-row tiles of ``n_tb`` columns,
    B padded to them) on the decoded weight, held against its plain version
    and timed, with its share of the bound and its ratio to
    ``torch.matmul`` (``library_ms``). The launch count is reset just
    before the timed runs and read after."""
    a = dense.reshape(-1, dense.shape[-1])            # [G*M, K]
    n = b.shape[1]
    bp = torch.nn.functional.pad(b, (0, -n % n_tb)).contiguous()

    def fn():
        return gemm.dense_gemm(a, bp, n_tb=n_tb, out_dtype=torch.bfloat16)

    def plain():
        return gemm.dense_gemm_ref(a, bp, out_dtype=torch.bfloat16)
    err = close(torch, fn(), plain(), BF16_TOL,
                f"dense_gemm {tuple(a.shape)} x {tuple(bp.shape)}")
    plain_ms = cuda_ms(torch, plain, 3, flush)
    gemm.reset_launch_counts()
    ms = cuda_ms(torch, fn, 20, flush)
    launches = gemm.launch_counts()["dense_gemm"]
    m, k = a.shape
    bound_s, bound_by = roofline.lscd_bound_s(
        2.0 * m * k, 0.0, 2.0 * bp.numel(), 2.0 * m * bp.shape[1],
        2.0 * m * k * bp.shape[1])
    share = bound_s * 1e3 / ms
    print(f"  dense_gemm {m}x{k} N={bp.shape[1]:<5d} n_tb={n_tb:<3d} "
          f"{ms:8.3f} ms ({100 * share:.1f}% of the bound {bound_s * 1e3:.3f}"
          f" ms by {bound_by}; {ms / library_ms:.2f}x torch.matmul; plain "
          f"{plain_ms:.3f} ms, max err {err:.2e})", flush=True)
    return dict(n_tb=n_tb, split_k=1, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_s * 1e3, bound_by=bound_by, share_of_bound=share,
                max_abs_err=err, launches=launches)


# ---------------------------------------------------------------------------
# slice phase
# ---------------------------------------------------------------------------

def slice_phase(torch, mods):
    configs, serve, spmm, engine, ops = (mods[x] for x in (
        "configs", "serve", "spmm", "engine", "ops"))
    full = configs.get("opt_30b")
    cfg = dataclasses.replace(full, n_layers=4)
    print(f"slice: {cfg.name} at full width (d_model {cfg.d_model}, d_ff "
          f"{cfg.d_ff}, {cfg.n_heads} heads, vocab {cfg.vocab}); n_layers cut "
          f"{full.n_layers} -> {cfg.n_layers}; sparsity {SPARSITY}, 8 "
          f"requests x 128-token prompts, 32 greedy new tokens", flush=True)
    params, built = serve.build(cfg, seed=SEED, sparsity=SPARSITY,
                                device="cuda")
    print(f"slice: encode {built['encode_s']:.3f} s, {built['n_tiled_csl']} "
          f"Tiled-CSL weights, {built['sparse_bytes'] / 2 ** 20:.1f} MiB "
          f"sparse vs {built['dense_bytes'] / 2 ** 20:.1f} MiB dense bf16 "
          f"({built['sparse_bytes'] / built['dense_bytes']:.4f}x)", flush=True)
    ops.SCHEDULES.clear()
    spmm.reset_launch_counts()
    rep = serve.run(cfg, requests=8, prompt_len=128, max_new=32, seed=SEED,
                    params=params)
    counts = spmm.launch_counts()
    tokens = rep["tokens"]
    check(tuple(tokens.shape) == (8, 160), f"tokens shape {tokens.shape}")
    check(int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab,
          "token ids outside the vocab")
    print(f"slice: prefill {rep['prefill_s'] * 1e3:.3f} ms, decode "
          f"{rep['decode_ms_per_step']:.3f} ms/step over "
          f"{rep['decode_steps']} steps, {rep['tokens_per_s']:.2f} tok/s",
          flush=True)
    for key, sched in sorted(rep["schedules"].items()):
        print(f"slice: schedule {key} -> {dataclasses.asdict(sched)}, "
              f"{mods['contracts'].body(sched.n_tb)} body")
    print(f"slice: launches {json.dumps(counts)}", flush=True)
    missing = [k for k in spmm.WEIGHT_KERNELS if counts[k] == 0]
    check(not missing, f"kernels never launched on the main path: {missing}")

    # First decode step against the same model through the plain versions.
    prompts = serve.make_prompts(cfg, 8, 128, SEED, "cuda")
    steps = {}
    with torch.inference_mode():
        for backend in ("cuda", "torch"):
            last, cache = engine.prefill(params, prompts, cfg, 160,
                                         backend=backend)
            tok = torch.argmax(last, dim=-1)[:, None]
            logits, _ = engine.serve_step(params, cache, tok, 128, cfg,
                                          backend=backend)
            steps[backend] = (tok, logits.float())
            del cache
    check(torch.equal(steps["cuda"][0], steps["torch"][0]),
          "first token differs between kernels and plain versions")
    err = close(torch, steps["cuda"][1], steps["torch"][1],
                dict(rtol=LOGITS_TOL, atol=LOGITS_TOL),
                "first decode-step logits vs plain")
    print(f"slice: first decode-step logits vs plain max abs err {err:.3e}",
          flush=True)
    return rep, counts, built, profile_steps(torch, engine, params, cfg,
                                             prompts), params, cfg


# ---------------------------------------------------------------------------
# serving phase
# ---------------------------------------------------------------------------

SERVE_SLOTS, SERVE_MAX_LEN, SERVE_REQUESTS, SERVE_NEW = 16, 512, 32, 64
SERVE_PROMPT = (32, 385)                # uniform prompt lengths, half-open
SERVE_RATE = 0.125                      # requests per engine step (open loop)


def _serve_config(mods, *, paged: bool, backend: str = "auto"):
    cfgmod = mods["serve_config"]
    return cfgmod.ServeConfig(
        scheduler=cfgmod.SchedulerConfig(
            n_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN, min_bucket=8,
            admit_k=4),
        cache_kind="paged" if paged else "dense", block_size=16,
        backend=backend)


class LaunchProbe:
    """While entered, records every distinct launch configuration of the
    four LSCD wrappers: kernel, weight shape and group, N (padded to the
    N tile), N tile, split S, epilogue, bias, dtypes, and the stepper call
    that made it (``phase``, set by :func:`_instrument`). It keeps the
    first weight and bias seen for each, so ``_check_served_launches``
    can hold the kernel against its plain version at exactly the
    configurations the serving path ran. The wrappers are wrapped, not
    changed (``ops`` looks them up at each call); a graph replay launches
    what its capture recorded, and the capture goes through the wrapper."""

    def __init__(self, spmm):
        self.spmm, self.phase, self.seen, self._orig = spmm, None, {}, {}

    def __enter__(self):
        for name in self.spmm.KERNELS:
            self._orig[name] = getattr(self.spmm, name)
            setattr(self.spmm, name, self._wrap(name, self._orig[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self.spmm, name, fn)

    def _wrap(self, name, fn):
        def probed(t, b, **kw):
            bias = kw.get("bias")
            # an expert stack's experts stand where a group's weights do
            key = (name, tuple(t.shape), t.experts or t.group or 1,
                   int(b.shape[-1]),
                   kw["n_tb"], kw.get("split_k", 1),
                   kw.get("epilogue", "none"), bias is not None,
                   b.dtype, kw.get("out_dtype") or b.dtype,
                   self.phase)
            self.seen.setdefault(key, (t, bias))
            return fn(t, b, **kw)
        return probed


STEP_OPS = ("prefill", "decode", "verify", "mixed")


def _instrument(stepper, spmm, probe=None) -> dict:
    """Wrap the stepper's four entry points (prefill, decode, verify,
    mixed): record each step call's host time (it ends in a device
    synchronise: the tokens come back to the host), add each call's LSCD
    launches (graph replays counted) to its call's tally, and tell
    ``probe`` which call is launching."""
    out = dict(step_s={op: [] for op in STEP_OPS[1:]},
               launches={op: dict.fromkeys(spmm.KERNELS, 0)
                         for op in STEP_OPS})
    out["decode_s"] = out["step_s"]["decode"]

    def wrap(phase, inner):
        def call(*args):
            if probe is not None:
                probe.phase = phase
            before = spmm.launch_counts()
            t0 = time.perf_counter()
            res = inner(*args)
            if phase != "prefill":
                out["step_s"][phase].append(time.perf_counter() - t0)
            after = spmm.launch_counts()
            for k in after:
                out["launches"][phase][k] += after[k] - before[k]
            return res
        return call
    for op in STEP_OPS:
        setattr(stepper, op, wrap(op, getattr(stepper, op)))
    return out


def _step_stats(times: list) -> dict:
    """Host ms of one kind of step call: the first (it captures the
    graph), and the mean and median of the rest."""
    steady = sorted(times[1:])
    nan = float("nan")
    return dict(n=len(times), first_ms=times[0] * 1e3 if times else nan,
                ms_per_step=sum(steady) / len(steady) * 1e3 if steady
                else nan,
                median_ms=steady[len(steady) // 2] * 1e3 if steady else nan)


def _launch_names(cfg) -> dict:
    """((M, K), group, or experts of an expert stack) -> the projection's
    name, for the reports."""
    d, f = cfg.d_model, cfg.d_ff
    names = {((f, d), 1): "up", ((d, f), 1): "down", ((f, d), 2): "gate_up"}
    if cfg.n_routed_experts:
        e, fe = cfg.n_routed_experts, cfg.d_expert
        fs = cfg.d_shared_expert * cfg.n_shared_experts
        h = cfg.n_heads * cfg.head_dim
        names = {((fe, d), e): "e.gate", ((d, fe), e): "e.down",
                 ((fs, d), 2): "s.gate_up", ((d, fs), 1): "s.down",
                 ((d, h), 1): "wo", ((h, d), 3): "wqkv"}
        kvd = cfg.n_kv * cfg.head_dim
        names.setdefault(((h, d), 1), "wq")
        names.setdefault(((kvd, d), 1), "wk")
        names.setdefault(((kvd, d), 2), "wk+wv")
        return names
    if cfg.attn_kind == "mla":
        h, kvr, qr = cfg.n_heads, cfg.kv_lora_rank, cfg.q_lora_rank
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        pad = -(-(kvr + dr) // 128) * 128       # Tiled-CSL pads M to 128
        names.update({((d, h * dv), 1): "wo", ((qr, d), 1): "w_dq",
                      ((h * (dn + dr), qr), 1): "w_uq",
                      ((pad, d), 1): "w_dkv",
                      ((h * (dn + dv), kvr), 1): "w_ukv"})
        return names
    kvd = cfg.n_kv * cfg.head_dim
    # with GQA or MQA, wq launches alone, at wo's shape
    names.update({((d, d), 3): "wqkv",
                  ((d, d), 1): "wo" if cfg.n_kv == cfg.n_heads else "wq/wo",
                  ((kvd, d), 2): "wk+wv"})
    names.setdefault(((kvd, d), 1), "wk")
    return names


def _check_served_launches(torch, mods, seen, cfg, label: str = "serving",
                           flush=None) -> list:
    """Each launch configuration the probe saw on the serving path, held
    against the kernel's plain version (the split-K pair against the
    split-K reference, which sums the same slices; an expert-batched
    launch against the loop of plain versions over its experts) on the
    same weight and bias and a fresh B on the card of the recorded shape
    and dtype. With ``flush`` each kernel and its plain version are also
    timed (``cuda_ms``, cold L2)."""
    ref, spmm = mods["ref"], mods["spmm"]
    names = _launch_names(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)
    rows = []
    for key in sorted(seen, key=lambda k: (str(k[-1]), k[3], k[:3])):
        name, (m, k), g, n, n_tb, sk, epi, _, b_dtype, out_dtype, phase = key
        t, bias = seen[key]
        batched = name.endswith("batched")
        b = (0.1 * torch.randn(((g,) if batched else ()) + (k, n),
                               generator=gen, device="cuda")).to(b_dtype)
        kw = dict(out_dtype=out_dtype, epilogue=epi, bias=bias)
        grouped = name.endswith("grouped")
        if batched:
            def kern():
                extra = dict(split_k=sk) if "splitk" in name else {}
                return getattr(spmm, name)(t, b, n_tb=n_tb,
                                           out_dtype=out_dtype, **extra)

            def plain():
                return ref.spmm_splitk_batched_ref(t, b, sk,
                                                   out_dtype=out_dtype)
        elif "splitk" in name:
            def kern():
                return getattr(spmm, name)(t, b, n_tb=n_tb, split_k=sk, **kw)

            def plain():
                return (ref.spmm_splitk_grouped_ref if grouped
                        else ref.spmm_splitk_ref)(t, b, sk, **kw)
        else:
            def kern():
                return getattr(spmm, name)(t, b, n_tb=n_tb, **kw)

            def plain():
                return (ref.spmm_grouped_ref if grouped
                        else ref.spmm_ref)(t, b, **kw)
        got, want = kern(), plain()
        shape = names.get(((m, k), g), f"{m}x{k} G={g}")
        tol = BF16_TOL if b_dtype == torch.bfloat16 else F32_TOL
        err = close(torch, got, want, tol, f"{label} path: {name} at "
                    f"{shape} N={n} n_tb={n_tb} S={sk} {epi} ({phase})")
        row = dict(kernel=name, shape=shape, m=m, k=k, group=g, n=n,
                   n_tb=n_tb, split_k=sk, epilogue=epi, phase=phase,
                   max_abs_err=err)
        timed = ""
        if flush is not None:
            row.update(ms=cuda_ms(torch, kern, 5, flush),
                       plain_ms=cuda_ms(torch, plain, 5, flush))
            timed = f", {row['ms']:.4f} ms (plain {row['plain_ms']:.4f})"
        rows.append(row)
        print(f"{label}: checked {phase:7s} {name:25s} {shape:7s} N={n:<5d}"
              f" n_tb={n_tb:<3d} S={sk:<2d} {epi:8s} max err {err:.2e}"
              f"{timed}", flush=True)
        del b, got, want
    torch.cuda.synchronize()
    return rows


def _closed_loop(torch, mods, params, cfg, prompts, probe, *, paged, graph,
                 config=None, new=SERVE_NEW, label="serving", drafter=None,
                 on_server=None):
    """Drain ``prompts`` (``new`` greedy new tokens each) through one
    ``StreamingServer`` (``config``, default the serving phase's;
    ``drafter`` for a speculative config). ``on_server`` is called with
    the instrumented server before the requests are submitted. Returns
    the server and its measurements."""
    api, scheduler = mods["api"], mods["scheduler"]
    if config is None:
        config = _serve_config(mods, paged=paged)
    server = api.StreamingServer(params, cfg, config=config, graph=graph,
                                 drafter=drafter)
    inst = _instrument(server.batcher.stepper, mods["spmm"], probe)
    if on_server is not None:
        on_server(server)
    times = inst["decode_s"]
    for i, p in enumerate(prompts):
        server.submit(api.GenerationRequest(p, new, session_id=f"r{i}"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    responses = server.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = server.metrics
    streams = {r.session_id: r.tokens for r in responses}
    # the first call of each step captures its graph
    stats = {op: _step_stats(t) for op, t in inst["step_s"].items()}
    steady_s = sum(sum(inst["step_s"][op][1:]) for op in ("decode",
                                                           "verify"))
    out = dict(
        paged=paged, graph=graph, wall_s=wall, completed=len(responses),
        tokens=sum(len(t) for t in streams.values()),
        tokens_per_s=sum(len(t) for t in streams.values()) / wall,
        decode_steps=len(times), first_decode_ms=stats["decode"]["first_ms"],
        decode_ms_per_step=stats["decode"]["ms_per_step"],
        decode_ms_median=stats["decode"]["median_ms"], steps=stats,
        # decode and verify emissions over those steps' host time, each
        # kind's first call (its capture) left out
        step_tokens_per_s=m.decode_tokens / steady_s if steady_s else None,
        prefill_shapes=sorted(server.batcher.stepper.prefill_shapes),
        bucket_admits=dict(m.bucket_admits),
        prefill_admissions=m.prefill_calls,
        launches_by_phase={p: dict(c) for p, c in inst["launches"].items()},
        peak_blocks_in_use=m.peak_blocks_in_use,
        n_blocks=server.batcher.pool.n_blocks if paged else None,
        admit_time_s=m.admit_time_s, decode_time_s=m.decode_time_s,
        ttft=scheduler.latency_summary([r.ttft_s for r in responses]),
        tpot=scheduler.latency_summary([r.tpot_s for r in responses
                                        if r.tpot_s is not None]),
        graph_launches=server.batcher.stepper.graph_launches)
    check(out["completed"] == len(prompts), f"{label}: closed loop {paged=} "
          f"{graph=}: {out['completed']} of {len(prompts)} requests finished")
    check(all(len(t) == new for t in streams.values()),
          f"{label}: a request finished short of its {new} tokens")
    check(all(0 <= x < cfg.vocab for t in streams.values() for x in t),
          f"{label}: token ids outside the vocab")
    print(f"{label}: {'paged' if paged else 'dense'} cache, graph "
          f"{'on ' if graph else 'off'}: {out['tokens']} tokens in "
          f"{wall:.3f} s ({out['tokens_per_s']:.1f} tok/s), decode "
          f"{out['decode_ms_per_step']:.3f} ms/step (median "
          f"{out['decode_ms_median']:.3f}, first {out['first_decode_ms']:.1f}"
          f" ms) over {len(times)} steps; TTFT p50/p99 "
          f"{out['ttft']['p50'] * 1e3:.1f}/{out['ttft']['p99'] * 1e3:.1f} ms,"
          f" TPOT p50/p99 {out['tpot']['p50'] * 1e3:.2f}/"
          f"{out['tpot']['p99'] * 1e3:.2f} ms; admit {m.admit_time_s:.3f} s,"
          f" decode {m.decode_time_s:.3f} s"
          + "".join(f"; {op} {stats[op]['ms_per_step']:.3f} ms/step (median "
                    f"{stats[op]['median_ms']:.3f}, first "
                    f"{stats[op]['first_ms']:.1f} ms) over {stats[op]['n']} "
                    f"steps" for op in ("verify", "mixed") if stats[op]["n"])
          + (f"; peak blocks {m.peak_blocks_in_use}/{out['n_blocks']}"
             if paged else "")
          + f"; prefill shapes (rows, bucket) {out['prefill_shapes']}",
          flush=True)
    return server, streams, out


def _first_step_logits(torch, mods, params, cfg, prompts, tol=LOGITS_TOL):
    """The first decode step's logits of 4 requests through the kernels
    against the same server on the plain versions (``backend="torch"``,
    eager): the admitted first tokens equal, the logits within ``tol``
    (``LOGITS_TOL``, or ``depth_logits_tol`` past 4 layers)."""
    api = mods["api"]
    got = {}
    for backend in ("auto", "torch"):
        server = api.StreamingServer(
            params, cfg, config=_serve_config(mods, paged=False,
                                              backend=backend),
            graph=backend == "auto")
        for i, p in enumerate(prompts[:4]):
            server.submit(api.GenerationRequest(p, SERVE_NEW,
                                                session_id=f"r{i}"))
        server.step()                   # admits all four, decodes once
        b = server.batcher
        slots = b.sched.active_slot_ids()
        check(len(slots) == 4, f"{len(slots)} of 4 requests active")
        first = [b.slots[s].generated[0] for s in slots]
        got[backend] = (first, b.stepper.last_logits[slots].float())
        del server
    check(got["auto"][0] == got["torch"][0],
          "first tokens differ between the kernels and the plain versions")
    return close(torch, got["auto"][1], got["torch"][1],
                 dict(rtol=tol, atol=tol),
                 f"{cfg.name}: server's first decode-step logits vs plain")


def _profile_decode(torch, stepper, steps: int = 4) -> dict:
    """``torch.profiler`` over ``steps`` decode calls of a drained
    server's stepper (every slot idle at position 0: the same fixed-shape
    step)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    n = stepper.n_slots
    zeros = np.zeros(n, np.int64)
    tables = (np.zeros((n, stepper.max_blocks), np.int64) if stepper.paged
              else None)
    stepper.decode(zeros, zeros, tables, None, None)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            stepper.decode(zeros, zeros, tables, None, None)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    return _device_summary(torch, prof, wall_s, steps)


def serving_phase(torch, mods, params, cfg):
    """Continuous batching through ``StreamingServer`` at OPT-30B width:
    the closed loop three times (dense graph on, dense graph off, paged
    graph on), an open-loop Poisson replay on the paged server, the first
    decode step against the plain versions, and one profiled graphed and
    eager decode step. Returns the phase's summary, the kernels'
    launches on the serving path (the dense graphed run), and the paged
    graphed run's prompts, streams and measurements (the plain side of
    the window phase)."""
    import numpy as np
    spmm, loadgen, scheduler = (mods[x] for x in ("spmm", "loadgen",
                                                  "scheduler"))
    rng = np.random.default_rng(SEED)
    lengths = rng.integers(*SERVE_PROMPT, SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int64)
               for n in lengths]
    print(f"serving: {cfg.name}, {cfg.n_layers} layers, {SERVE_SLOTS} slots,"
          f" max_len {SERVE_MAX_LEN}, admit_k 4, block 16; {SERVE_REQUESTS} "
          f"requests, prompts {int(lengths.min())}-{int(lengths.max())} "
          f"tokens, {SERVE_NEW} greedy new tokens each", flush=True)
    probe = LaunchProbe(spmm)
    with probe:
        spmm.reset_launch_counts()
        dense_g, streams_g, run_g = _closed_loop(
            torch, mods, params, cfg, prompts, probe, paged=False, graph=True)
        counts = spmm.launch_counts()
        by_phase = run_g["launches_by_phase"]
        print(f"serving: launches {json.dumps(counts)} (graph replays "
              f"counted; one replay launches "
              f"{json.dumps(run_g['graph_launches'])}); "
              f"{run_g['prefill_admissions']} prefill admissions "
              f"{json.dumps(run_g['bucket_admits'])} (bucket: admissions) "
              f"launch {json.dumps(by_phase['prefill'])}, "
              f"{run_g['decode_steps']} decode steps launch "
              f"{json.dumps(by_phase['decode'])}", flush=True)
        missing = [k for k in spmm.WEIGHT_KERNELS if counts[k] == 0]
        check(not missing, f"kernels never launched on the serving path: "
              f"{missing}")
        check(all(by_phase["prefill"][k] + by_phase["decode"][k] == counts[k]
                  for k in counts), "serving launches outside prefill and "
              "decode calls")
        dense_e, streams_e, run_e = _closed_loop(
            torch, mods, params, cfg, prompts, probe, paged=False,
            graph=False)
        check(streams_g == streams_e, "graph-on and graph-off streams differ")
        paged_g, streams_p, run_p = _closed_loop(
            torch, mods, params, cfg, prompts, probe, paged=True, graph=True)
        check(streams_p == streams_g, "dense and paged streams differ")
    print("serving: streams identical graph on vs off and dense vs paged",
          flush=True)
    profile = {"graph": _profile_decode(torch, dense_g.batcher.stepper),
               "eager": _profile_decode(torch, dense_e.batcher.stepper)}
    for kind, r in profile.items():
        if r["busy_share"] is None:
            print(f"serving: profile {kind}: no device activity seen; the "
                  "busy share is not measured", flush=True)
            continue
        print(f"serving: profile {kind} decode step: "
              f"{r['wall_ms_per_step']:.3f} ms/step wall under "
              f"torch.profiler, device busy {r['busy_ms_per_step']:.3f} "
              f"ms/step ({100 * r['busy_share']:.1f}%), LSCD kernels "
              f"{r['lscd_ms_per_step']:.3f} ms/step", flush=True)
    del dense_g, dense_e
    release(torch)

    # open loop: Poisson arrivals on the paged server
    trace = loadgen.make_trace(
        seed=SEED, n_requests=SERVE_REQUESTS, rate=SERVE_RATE,
        vocab=cfg.vocab, tenants=[loadgen.TenantSpec(
            "serve", prefix_len=0, suffix_len=SERVE_PROMPT,
            max_new=(SERVE_NEW, SERVE_NEW + 1))])
    server = mods["api"].StreamingServer(
        params, cfg, config=_serve_config(mods, paged=True))
    _instrument(server.batcher.stepper, spmm, probe)
    with probe:
        res = loadgen.replay(server, trace, loadgen.StepClock(dt=1.0))
    torch.cuda.synchronize()
    check(len(res.responses) == SERVE_REQUESTS and not res.shed
          and not res.rejected, f"open loop: {len(res.responses)} finished, "
          f"{len(res.shed)} shed, {len(res.rejected)} rejected")
    check(all(len(r.tokens) == SERVE_NEW for r in res.responses),
          "open loop: a request finished short of its 64 tokens")
    ttft = scheduler.latency_summary(res.wall_ttft_s)
    tpot = scheduler.latency_summary(res.wall_tpot_s)
    n_tok = sum(len(r.tokens) for r in res.responses)
    open_loop = dict(
        rate=SERVE_RATE, steps=res.steps, wall_s=res.wall_s,
        tokens_per_s=n_tok / res.wall_s, ttft=ttft, tpot=tpot,
        peak_blocks_in_use=server.metrics.peak_blocks_in_use,
        fingerprint=loadgen.trace_fingerprint(trace))
    print(f"serving: open loop, {SERVE_RATE} requests/step on the paged "
          f"server: {res.steps} steps in {res.wall_s:.3f} s "
          f"({open_loop['tokens_per_s']:.1f} tok/s), TTFT p50/p99 "
          f"{ttft['p50'] * 1e3:.1f}/{ttft['p99'] * 1e3:.1f} ms, TPOT "
          f"p50/p99 {tpot['p50'] * 1e3:.2f}/{tpot['p99'] * 1e3:.2f} ms, peak "
          f"blocks {open_loop['peak_blocks_in_use']}", flush=True)
    del server, paged_g
    release(torch)

    err = _first_step_logits(torch, mods, params, cfg, prompts)
    print(f"serving: first decode-step logits vs plain max abs err "
          f"{err:.3e}", flush=True)
    prefix = _shared_prefix(torch, mods, params, cfg)
    check(prefix["elements_changed"] == 0 and prefix["stream_same"],
          "shared prefix: a later admission rewrote blocks a request in "
          "flight shares")
    # Chunked: B's mixed steps also carry A's decode (N = 256 where A
    # alone decodes at N = 16), so A's stream may differ at a near tie;
    # the blocks' bits may not.
    prefix["chunked"] = _shared_prefix(torch, mods, params, cfg,
                                       chunked=True)
    check(prefix["chunked"]["elements_changed"] == 0,
          "shared prefix: a chunked admission rewrote blocks a request in "
          "flight shares with other bits")
    checked = _check_served_launches(torch, mods, probe.seen, cfg)
    print(f"serving: {len(checked)} launch configurations of the serving "
          f"path held against the plain versions", flush=True)
    summary = dict(closed_loop={"dense_graph": run_g, "dense_eager": run_e,
                                "paged_graph": run_p},
                   open_loop=open_loop, logits_max_abs_err=err,
                   shared_prefix=prefix, profile=profile, launches=counts,
                   launches_by_phase=by_phase, checked_launches=checked)
    plain = dict(prompts={f"r{i}": p for i, p in enumerate(prompts)},
                 streams=streams_p, run=run_p)
    return summary, by_phase, plain


def _shared_prefix(torch, mods, params, cfg, chunked: bool = False) -> dict:
    """Whether a later admission rewrites prompt blocks that a request in
    flight shares. Request A (32 tokens: two full blocks) is admitted
    alone and decodes once; then B, A's 32 tokens and 400 more, is
    admitted on the same paged server and maps A's two blocks as prefix
    hits. Bucketed (``chunked`` False): A takes the 32-token bucket
    (prefill N = 4 x 32 = 128, where ``select`` splits K), B the 512-token
    one (N = 2048, single pass). Chunked (the window phase's server:
    chunks of 16, a budget of 32): both stream their prompts through the
    mixed step (N = 16 x 16 = 256) from position 0, so B's first two
    chunks write A's two blocks again. Compares those blocks' bits in
    every cache leaf before and after B's prefill, and A's greedy stream
    against a run without B: as the port writes (``AdmissionPlan.
    write_targets``) and, bucketed, for comparison, as the reference
    writes (the plan's whole block map, ``targets``)."""
    import numpy as np
    api, plan_cls = mods["api"], mods["scheduler"].AdmissionPlan
    rng = np.random.default_rng(SEED + 3)
    a = rng.integers(0, cfg.vocab, 32).astype(np.int64)
    b = np.concatenate([a, rng.integers(0, cfg.vocab, 400).astype(np.int64)])
    config = (_window_config(mods, chunked=True) if chunked
              else _serve_config(mods, paged=True))

    def step_until_first_token(server, prompt) -> int:
        bt = server.batcher
        for _ in range(64):             # a chunked prompt takes 27 steps
            server.step()
            slot = next((s for s in bt.sched.active_slot_ids()
                         if len(bt.slots[s].prompt) == len(prompt)), None)
            if slot is not None and bt.slots[slot].generated:
                return slot
        raise SmokeFailure(f"shared prefix: the {len(prompt)}-token request "
                           "never finished its prefill")

    def run(with_b: bool) -> dict:
        server = api.StreamingServer(params, cfg, config=config)
        server.submit(api.GenerationRequest(a, SERVE_NEW, session_id="a"))
        bt = server.batcher
        slot = step_until_first_token(server, a)    # A admitted, decodes
        shared = list(bt.sched.tables[slot].blocks[:2])
        idx = torch.tensor(shared, device="cuda")
        leaves = [layer[n] for layer in bt.stepper.cache for n in ("k", "v")]
        before = [leaf[idx].clone() for leaf in leaves]
        res = {}
        if with_b:
            server.submit(api.GenerationRequest(b, SERVE_NEW,
                                                session_id="b"))
            other = step_until_first_token(server, b)
            check(list(bt.sched.tables[other].blocks[:2]) == shared,
                  "shared prefix: B does not map A's two prompt blocks")
            torch.cuda.synchronize()
            after = [leaf[idx] for leaf in leaves]
            res = dict(
                blocks=shared, prefix_hit_tokens=int(
                    bt.metrics.prefix_hit_tokens),
                buckets=sorted(bt.metrics.bucket_admits),
                mixed_steps=int(bt.metrics.mixed_steps),
                elements=sum(x.numel() for x in before),
                elements_changed=sum(
                    int((x.view(torch.int16) != y.view(torch.int16)).sum())
                    for x, y in zip(before, after)),
                max_abs_change=max(float((x.float() - y.float()).abs().max())
                                   for x, y in zip(before, after)))
        res["stream"] = {r.session_id: r.tokens
                         for r in server.run_until_drained()}["a"]
        return res

    alone = run(False)["stream"]
    out = run(True)
    out["stream_same"] = out.pop("stream") == alone
    runs = [("as the port writes", out)]
    if not chunked:
        saved = plan_cls.write_targets
        plan_cls.write_targets = lambda plan: plan.targets
        try:
            ref = run(True)
        finally:
            plan_cls.write_targets = saved
        out["reference"] = dict(elements_changed=ref["elements_changed"],
                                max_abs_change=ref["max_abs_change"],
                                stream_same=ref["stream"] == alone)
        runs.append(("as the reference writes", out["reference"]))
    release(torch)
    how = (f"chunked ({out['mixed_steps']} mixed steps)" if chunked
           else f"bucket {out['buckets'][-1]}")
    for label, r in runs:
        print(f"serving: shared prefix, {label}: B ({how}) mapped A's blocks"
              f" {out['blocks']} ({out['prefix_hit_tokens']} hit tokens); "
              f"{r['elements_changed']} of {out['elements']} cache elements "
              f"of those blocks changed at B's admission (max abs change "
              f"{r['max_abs_change']:.3e}); A's stream "
              f"{'equals' if r['stream_same'] else 'differs from'} its run "
              f"without B", flush=True)
    return out


# ---------------------------------------------------------------------------
# window phase: speculative verify and chunked prefill
# ---------------------------------------------------------------------------

SPEC_K, CHUNK_SIZE, CHUNK_BUDGET = 3, 16, 32
SELF_REQUESTS, SELF_PROMPT, SELF_NEW = 8, (32, 129), 32
# Verify runs the LSCD products at N = 16 x 4 = 64 and the mixed step at
# N = 16 x 16 = 256 where decode runs them at N = 16, so their sums run in
# another order and bf16 logits drift by up to about LOGITS_TOL on each
# side. Where a stream first differs from the plain one, the plain side's
# top-2 margin must be below this.
NEAR_TIE = 2 * LOGITS_TOL


def _window_config(mods, *, spec_k=0, chunked=False):
    cfgmod = mods["serve_config"]
    return cfgmod.ServeConfig(
        scheduler=cfgmod.SchedulerConfig(
            n_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN, min_bucket=8,
            admit_k=4, chunked_prefill=chunked, chunk_size=CHUNK_SIZE,
            chunk_budget=CHUNK_BUDGET),
        cache_kind="paged", block_size=16, spec_k=spec_k)


def _top2_margin(torch, logits) -> float:
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def _drained_clean(server, label: str) -> None:
    pool = server.batcher.pool
    pool.check_invariants()
    check(pool.blocks_in_use == 0, f"{label}: {pool.blocks_in_use} blocks "
          f"still in use after the drain")


def _near_tie_streams(torch, mods, params, cfg, prompts, got, want,
                      label: str) -> list:
    """``got`` against the plain ``want`` by the near-tie rule of
    ``tests/torch_serving_parity.py``: equal, or, at the first token where
    they differ, the plain side's next-token logits (a prefill of the
    prompt and the plain tokens before it) have a top-2 margin below
    ``NEAR_TIE``, and the request is compared no further. Returns the cut
    requests as (key, token index, margin)."""
    import numpy as np
    engine = mods["engine"]
    check(set(got) == set(want), f"{label}: the requests differ")
    cut = []
    for key in sorted(want):
        g, w = list(got[key]), list(want[key])
        i = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if i is None:
            check(len(g) == len(w), f"{label}: {key}: lengths differ")
            continue
        ctx = np.concatenate([prompts[key], np.asarray(w[:i], np.int64)])
        with torch.inference_mode():
            last, _ = engine.prefill(
                params, torch.from_numpy(ctx[None]).cuda(), cfg, len(ctx))
        margin = _top2_margin(torch, last[0])
        check(margin < NEAR_TIE, f"{label}: {key} differs from the plain "
              f"stream at token {i}, where the plain top-2 margin is "
              f"{margin:.3e} (a near tie is below {NEAR_TIE:.1e})")
        cut.append((key, i, margin))
    print(f"{label}: {len(want) - len(cut)} of {len(want)} streams equal the"
          f" plain ones; {len(cut)} cut at a near tie (request, token, "
          f"margin) {json.dumps([[k, i, round(m, 5)] for k, i, m in cut])}",
          flush=True)
    return cut


class _ScriptedDrafter:
    """Proposes each request's known plain continuation."""

    def __init__(self, known):
        self.known = known              # [(prompt, generated tokens)]

    def propose(self, tokens, k):
        import numpy as np
        for prompt, gen in self.known:
            n = len(prompt)
            if len(tokens) >= n and np.array_equal(tokens[:n], prompt):
                return np.asarray(gen[len(tokens) - n:][:k], np.int64)
        return np.empty(0, np.int64)


def _first_verify_logits(torch, mods, params, cfg, prompts) -> dict:
    """The first verify step's logits, column by column, against plain
    decode's at the same positions: 4 requests decode SPEC_K + 1 steps on
    a plain paged server (logits at positions len .. len + SPEC_K), then
    a speculative server, drafting exactly those tokens, admits the same
    requests and verifies them in one window."""
    api = mods["api"]
    keys = [f"r{i}" for i in range(4)]
    server = api.StreamingServer(params, cfg, config=_window_config(mods))
    for key in keys:
        server.submit(api.GenerationRequest(prompts[key], SERVE_NEW,
                                            session_id=key))
    want = {}
    b = server.batcher
    for _ in range(SPEC_K + 1):
        server.step()
        for s in b.sched.active_slot_ids():
            want.setdefault(b.slots[s].uid, []).append(
                b.stepper.last_logits[s].float().clone())
    known = [(prompts[key], list(b.requests[uid].generated))
             for uid, key in enumerate(keys)]
    del server, b
    drafter = _ScriptedDrafter(known)
    server = api.StreamingServer(params, cfg, config=_window_config(
        mods, spec_k=SPEC_K), drafter=drafter)
    for key in keys:
        server.submit(api.GenerationRequest(prompts[key], SERVE_NEW,
                                            session_id=key))
    b = server.batcher
    server.step()                       # admits all four, verifies once
    check(b.stepper.window_shapes == {("verify", (SERVE_SLOTS,
                                                  SPEC_K + 1))},
          "the first step after admission was not one verify window")
    got, wanted = [], []
    for s in b.sched.active_slot_ids():
        uid = b.slots[s].uid
        check(len(want[uid]) == SPEC_K + 1, "plain decode steps missing")
        got.append(b.stepper.last_logits[s].float())
        wanted.append(torch.stack(want[uid]))
    check(len(got) == 4, f"{len(got)} of 4 requests active")
    accepted = b.metrics.accepted
    err = close(torch, torch.stack(got), torch.stack(wanted),
                dict(rtol=LOGITS_TOL, atol=LOGITS_TOL),
                f"{cfg.name}: first verify-step logits vs plain decode")
    del server
    release(torch)
    return dict(max_abs_err=err, accepted=int(accepted),
                drafted=4 * SPEC_K)


def _profile_window(torch, stepper, op: str, steps: int = 4) -> dict:
    """``torch.profiler`` over ``steps`` calls of a drained server's
    verify or mixed step (every slot idle at position 0, its table all
    trash: the same fixed-shape step)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    n = stepper.n_slots
    zeros = np.zeros(n, np.int64)
    tables = np.zeros((n, stepper.max_blocks), np.int64)
    width = stepper.spec_k + 1 if op == "verify" else stepper.chunk_size
    tokens = np.zeros((n, width), np.int64)
    fn = getattr(stepper, op)
    fn(tokens, zeros, tables, zeros, zeros, zeros)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn(tokens, zeros, tables, zeros, zeros, zeros)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    return _device_summary(torch, prof, wall_s, steps)


def window_phase(torch, mods, params, cfg, plain):
    """Speculative verify and chunked prefill through ``StreamingServer``
    on the serving phase's model, server and trace, against its paged
    graphed run (``plain``): (a) spec_k = 3 with ``NgramDrafter``, graph
    on and off; (b) chunked prefill (chunk 16, budget 32), graph on and
    off; (c) a self-draft (``DraftModelDrafter`` on the target's own
    params, 8 requests of 32-128 tokens). Checks identical streams graph
    on and off, the near-tie rule against plain, the first verify step's
    logits against plain decode, every rejected self-draft at a near tie,
    clean pools, one capture a graph, and every launch configuration of
    the verify and mixed steps and of the self-draft's rollout against
    its plain version. Returns the phase's summary and the graph-on runs'
    launches by stepper call."""
    import numpy as np
    spmm, speculative = mods["spmm"], mods["speculative"]
    card = card_line()
    prompts, want, base = plain["prompts"], plain["streams"], plain["run"]
    plist = [prompts[f"r{i}"] for i in range(len(prompts))]
    print(f"window: {cfg.name}, {cfg.n_layers} layers, {SERVE_SLOTS} slots, "
          f"paged, block 16; the serving trace; spec_k {SPEC_K}, chunk "
          f"{CHUNK_SIZE}, budget {CHUNK_BUDGET}; near tie below "
          f"{NEAR_TIE:.1e}", flush=True)
    probe = LaunchProbe(spmm)
    launches = {op: dict.fromkeys(spmm.KERNELS, 0) for op in STEP_OPS}
    runs, profile = {}, {}

    def add(run):
        for op, c in run["launches_by_phase"].items():
            for k, n in c.items():
                launches[op][k] += n

    with probe:
        logits = _first_verify_logits(torch, mods, params, cfg, prompts)
        print(f"window: first verify step vs plain decode, {SPEC_K + 1} "
              f"columns x 4 requests: logits max abs err "
              f"{logits['max_abs_err']:.3e} (tol {LOGITS_TOL}); accepted "
              f"{logits['accepted']} of {logits['drafted']} scripted drafts",
              flush=True)
        for kind, conf in (("spec", dict(spec_k=SPEC_K)),
                           ("chunked", dict(chunked=True))):
            op = "verify" if kind == "spec" else "mixed"
            streams = {}
            # graph off first: its run warms the allocator, emptied by
            # release(), for the timed graphed run
            for graph in (False, True):
                label = f"window: {kind}, graph {'on' if graph else 'off'}"
                server, streams[graph], run = _closed_loop(
                    torch, mods, params, cfg, plist, probe, paged=True,
                    graph=graph, config=_window_config(mods, **conf),
                    label=label)
                b = server.batcher
                _drained_clean(server, label)
                m = b.metrics
                run.update(drafted=m.drafted, accepted=m.accepted,
                           accept_rate=m.accept_rate,
                           tokens_per_step=m.tokens_per_step,
                           mixed_steps=m.mixed_steps,
                           chunk_tokens=m.chunk_tokens,
                           captures=dict(b.stepper.captures),
                           window_shapes=sorted(b.stepper.window_shapes))
                check(run["steps"][op]["n"] > 0, f"{label}: no {op} step ran")
                if graph:
                    check(b.stepper.captures[op] == 1 and
                          b.stepper.captures["decode"] <= 1,
                          f"{label}: captures {b.stepper.captures}")
                    add(run)
                    profile[op] = _profile_window(torch, b.stepper, op)
                else:
                    check(not any(b.stepper.captures.values()),
                          f"{label}: a graph was captured")
                runs[f"{kind}_{'graph' if graph else 'eager'}"] = run
                del server, b
                release(torch)
            check(streams[True] == streams[False],
                  f"window: {kind}: graph-on and graph-off streams differ")
            probe.phase = None          # the plain side's prefills
            runs[f"{kind}_cut"] = _near_tie_streams(
                torch, mods, params, cfg, prompts, streams[True], want,
                f"window: {kind} vs plain")

        # (c) self-draft: the target drafts for itself
        rng = np.random.default_rng(SEED + 5)
        lengths = rng.integers(*SELF_PROMPT, SELF_REQUESTS)
        sprompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int64)
                    for n in lengths]
        margins = []

        def hook(server):
            st = server.batcher.stepper
            inner = st.verify

            def verify(tokens, pos, tables, draft_lens, uids, counts):
                tgt, n_acc = inner(tokens, pos, tables, draft_lens, uids,
                                   counts)
                for s in np.flatnonzero(draft_lens > n_acc):
                    margins.append(_top2_margin(
                        torch, st.last_logits[s, int(n_acc[s])]))
                return tgt, n_acc
            st.verify = verify

        drafter = speculative.DraftModelDrafter(params, cfg, vocab=cfg.vocab)
        propose = drafter.propose

        def drafting(tokens, k):        # the rollout's own launches
            probe.phase = "draft"
            return propose(tokens, k)
        drafter.propose = drafting
        label = "window: self-draft"
        server, _, run = _closed_loop(
            torch, mods, params, cfg, sprompts, probe, paged=True, graph=True,
            config=_window_config(mods, spec_k=SPEC_K), new=SELF_NEW,
            label=label, drafter=drafter, on_server=hook)
        _drained_clean(server, label)
        m = server.metrics
        run.update(drafted=m.drafted, accepted=m.accepted,
                   accept_rate=m.accept_rate,
                   tokens_per_step=m.tokens_per_step, rejected=len(margins),
                   max_rejected_margin=max(margins, default=None))
        largest = max(margins, default=float("nan"))
        add(run)
        runs["self_draft"] = run
        del server, drafter
        release(torch)
        check(all(x < NEAR_TIE for x in margins), f"{label}: a draft was "
              f"rejected at a top-2 margin of {largest:.3e}")
        print(f"{label}: accept rate {m.accept_rate:.4f} ({m.accepted} of "
              f"{m.drafted} drafts), {m.tokens_per_step:.4f} tokens per "
              f"active slot-step; {len(margins)} rejected, every one at a "
              f"top-2 margin below {NEAR_TIE:.1e} (largest {largest:.3e}); "
              f"{card}",
              flush=True)
    seen = {k: v for k, v in probe.seen.items()
            if k[-1] in ("verify", "mixed", "draft")}
    ns = {op: sorted({k[3] for k in seen if k[-1] == op})
          for op in ("verify", "mixed")}
    check(SERVE_SLOTS * (SPEC_K + 1) in ns["verify"]
          and SERVE_SLOTS * CHUNK_SIZE in ns["mixed"],
          f"window: verify and mixed launches at N {ns}")
    checked = _check_served_launches(torch, mods, seen, cfg, label="window")
    print(f"window: {len(checked)} launch configurations of the verify and "
          f"mixed steps and the self-draft rollout held against the plain "
          f"versions", flush=True)

    a, c, dec = runs["spec_graph"], runs["chunked_graph"], base
    ratio = a["steps"]["verify"]["ms_per_step"] / dec["decode_ms_per_step"]
    print(f"window: (a) spec_k {SPEC_K}, graphed: verify "
          f"{a['steps']['verify']['ms_per_step']:.3f} ms/step (median "
          f"{a['steps']['verify']['median_ms']:.3f}) against graphed decode "
          f"{dec['decode_ms_per_step']:.3f} ms/step at {SERVE_SLOTS} slots "
          f"({ratio:.3f}x);"
          f" accept rate {a['accept_rate']:.4f}, "
          f"{a['tokens_per_step']:.4f} tokens per active slot-step; "
          f"{a['tokens_per_s']:.1f} tok/s spec on against "
          f"{dec['tokens_per_s']:.1f} off (the step loop alone, captures "
          f"left out: {a['step_tokens_per_s']:.1f} against "
          f"{dec['step_tokens_per_s']:.1f}); {card}", flush=True)
    print(f"window: (b) chunked {CHUNK_SIZE}/{CHUNK_BUDGET}, graphed: mixed "
          f"{c['steps']['mixed']['ms_per_step']:.3f} ms/step (median "
          f"{c['steps']['mixed']['median_ms']:.3f}) over "
          f"{c['steps']['mixed']['n']} steps; TTFT p50/p99 "
          f"{c['ttft']['p50'] * 1e3:.1f}/{c['ttft']['p99'] * 1e3:.1f} ms "
          f"against bucketed {dec['ttft']['p50'] * 1e3:.1f}/"
          f"{dec['ttft']['p99'] * 1e3:.1f}, TPOT p50/p99 "
          f"{c['tpot']['p50'] * 1e3:.2f}/{c['tpot']['p99'] * 1e3:.2f} ms "
          f"against {dec['tpot']['p50'] * 1e3:.2f}/"
          f"{dec['tpot']['p99'] * 1e3:.2f}; {c['tokens_per_s']:.1f} tok/s; "
          f"{card}", flush=True)
    for op, r in profile.items():
        if r["busy_share"] is None:
            print(f"window: profile {op}: no device activity seen; the busy "
                  "share is not measured", flush=True)
            continue
        print(f"window: profile graphed {op} step: "
              f"{r['wall_ms_per_step']:.3f} ms/step wall under "
              f"torch.profiler, device busy {r['busy_ms_per_step']:.3f} "
              f"ms/step ({100 * r['busy_share']:.1f}%), LSCD kernels "
              f"{r['lscd_ms_per_step']:.3f} ms/step; {card}", flush=True)
        for ms, n, name in r["top"]:
            print(f"window:   {op} {ms:8.3f} ms/step {n:4d}/step  {name}")
    print(f"window: launches by call (graph replays counted) "
          f"{json.dumps(launches)}", flush=True)
    summary = dict(card=card, near_tie=NEAR_TIE, spec_k=SPEC_K,
                   chunk_size=CHUNK_SIZE, chunk_budget=CHUNK_BUDGET,
                   first_verify_logits=logits, runs=runs, profile=profile,
                   verify_over_decode=ratio,
                   launches_by_phase=launches, checked_launches=checked)
    return summary, launches


# The analysis phase: the port's static checkers on the served OPT-30B.
ANALYSIS_TEMPERATURE = 0.7              # the sampled path, as the reference
ANALYSIS_ROWS = 4                       # admission rows (admit_k)
ALLOWLIST = os.path.join("tools", "torch_check_allowlist.json")


def analysis_phase(torch, mods) -> dict:
    """The port's analysis passes (``repro_torch.analysis``) on the slice
    phase's OPT-30B build (full width, 4 layers, 0.8), after the serving
    and window phases: the kernel pass with the live schedule cache
    (``ops.SCHEDULES``) at each weight's own ``max_nnz``; the lint; the
    trace audit on a paged stepper at the serving phase's slots and
    max_len with verify (spec_k 3) and mixed (chunk 16) enabled, sampled
    at T = 0.7: a dispatch census of one eager step of each op, two passes
    of every bucket against the capture budgets, the eager bodies and
    graph replays under ``set_sync_debug_mode("error")`` and each replay's
    launches against the layers'; and the observability replay at the
    smoke config on the card. Fails on a live finding or a stale allowlist
    entry."""
    ka, li, ta, ob, fi = (mods[x] for x in (
        "kernel_pass", "lint", "trace_audit", "obs_pass", "findings"))
    params, cfg = mods.pop("slice_model")
    spmm, ops = mods["spmm"], mods["ops"]
    card = card_line()
    found, audited, seconds = {}, [], {}

    t0 = time.perf_counter()
    kf, kstats = ka.run_kernel_pass(ROOT)
    lf, lstats = ka.audit_schedules(dict(ops.SCHEDULES), params)
    found["kernels"] = kf + lf
    audited += kstats["targets"] + lstats["targets"]
    seconds["kernels"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    files = li.tree_files(ROOT)
    found["lint"] = li.lint_tree(ROOT)
    audited += [os.path.relpath(p, ROOT) for p, _ in files]
    seconds["lint"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    before = spmm.launch_counts()
    mb = -(-SERVE_MAX_LEN // 16)
    stepper = mods["step"].DeviceStepper(
        params, cfg, n_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
        physical_blocks=SERVE_SLOTS * mb + 1, block_size=16,
        spec_k=SPEC_K, chunk_size=CHUNK_SIZE,
        temperature=ANALYSIS_TEMPERATURE)
    up = params["layers"][0]["mlp"]["up"]["w"]
    dev = up.words.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 9)
    b = (0.1 * torch.randn(up.shape[1], SERVE_SLOTS, generator=gen,
                           device=dev)).to(torch.bfloat16)
    prefix = f"{ta.prefix_of(dev)}:{cfg.name}"     # trace:cuda:opt-30b
    entries = (ta.stepper_entries(stepper, prefix=prefix, rows=ANALYSIS_ROWS)
               + [ta.spmm_entry(up, b, prefix=prefix)])
    tf, tstats = ta.run_trace_audit(entries)
    found["trace"] = tf
    audited += tstats["targets"]
    launches = {k: n - before[k] for k, n in spmm.launch_counts().items()}
    seconds["trace"] = time.perf_counter() - t0
    del entries, stepper, params, up, b
    release(torch)

    t0 = time.perf_counter()
    of, ostats = ob.run_obs_pass(device=dev)
    found["obs"] = of
    audited += ostats["targets"]
    seconds["obs"] = time.perf_counter() - t0
    release(torch)

    allow = fi.Allowlist.load(os.path.join(ROOT, ALLOWLIST))
    for fs in found.values():
        allow.suppress(fs)
    problems = allow.problems(audited)
    by_pass = {name: dict(live=sum(not f.suppressed for f in fs),
                          suppressed=sum(f.suppressed for f in fs))
               for name, fs in found.items()}
    for name, fs in found.items():
        print(f"analysis: [{name}] {by_pass[name]['live']} live, "
              f"{by_pass[name]['suppressed']} suppressed finding(s) "
              f"({seconds[name]:.2f} s); {card}", flush=True)
        for f in fs:
            print(f"analysis:   {'suppressed' if f.suppressed else 'LIVE'}: "
                  f"{f.anchor()}: {f.rule}: {f.message}")
    print(f"analysis: kernels: {kstats['cells']} selector cells, "
          f"{kstats['filtered']}/{kstats['candidates']} ladder candidates "
          f"filtered, largest pick {kstats['max_smem']} B of "
          f"{kstats['smem_budget']} B shared memory; {lstats['schedules']} "
          f"live schedules held at {lstats['weights_checked']} "
          f"(schedule, max_nnz) pairs; KC-ACC over {kstats['ptx']} PTX "
          f"strings, {kstats['asm']} asm statements, {kstats['acc']} "
          f"accumulator declarations", flush=True)
    for r in tstats["entries"]:
        line = (f"analysis: {r['path']}: {r['ops']} aten ops in one eager "
                f"call, TA-UPCAST {r['upcasts']} copies "
                f"{r['upcast_bytes']} B of f32 written a call, "
                f"{r['syncs']} host syncs; captures {r['captures']} of "
                f"budget {r['budget']}")
        if "launches_per_replay" in r:
            line += (f"; a replay launches "
                     f"{json.dumps(r['launches_per_replay'])} "
                     f"({r['implied_launches']} implied by the layers)")
        print(f"{line}; {card}", flush=True)
        check(r["captures"] <= r["budget"], f"analysis: {r['path']} "
              f"captured {r['captures']} over its budget {r['budget']}")
    print(f"analysis: obs on {dev.type}: {ostats['records']} trace records, "
          f"counters {json.dumps(ostats['counters'])}, {ostats['fired']} "
          f"faults fired; {card}", flush=True)
    for p in problems:
        print(f"analysis: ALLOWLIST: {p}")
    live = [f for fs in found.values() for f in fs if not f.suppressed]
    check(not live and not problems, f"analysis: {len(live)} live "
          f"finding(s), {len(problems)} allowlist problem(s)")
    check(any(r.get("launches_per_replay") for r in tstats["entries"]),
          "analysis: no graphed step launched an LSCD kernel")
    return dict(card=card, by_pass=by_pass, seconds=seconds,
                kernels={k: v for k, v in kstats.items() if k != "targets"},
                schedules={k: v for k, v in lstats.items() if k != "targets"},
                trace=tstats["entries"],
                obs={k: v for k, v in ostats.items() if k != "targets"},
                findings=[dict(rule=f.rule, anchor=f.anchor(),
                               message=f.message, suppressed=f.suppressed)
                          for fs in found.values() for f in fs],
                launches=launches)


# The full-depth phase: OPT-30B at all 48 layers from a pool the planner
# sizes for one 80 GB card, and tinyllama at full size.
FULL_BUDGET = 80e9
FULL_SLOTS, FULL_MAX_LEN, FULL_REQUESTS, FULL_NEW = 32, 1024, 32, 64
FULL_PROMPT = (128, 769)                # uniform prompt lengths, half-open
# One admission a step: the prefill's scratch cache is [admit_k, bucket]
# for all 48 layers (1.41 GB a row at the 1024 bucket), and the planner
# leaves 3% of the budget (2.4 GB) for the workspace.
FULL_ADMIT_K = 1
TINY_REQUESTS, TINY_NEW = 16, 32        # on the serving phase's server
PLAN_ARCHS = ("opt_30b", "opt_66b", "opt_175b")
AUTOTUNE_NS = (16, 32)


def plans_report(mods) -> dict:
    """The planner's sparse and dense plans for the paper's three models
    at ``FULL_BUDGET``, block 16: blocks and dense-slot baseline at
    max_len 1024, or the reason the card cannot hold them."""
    budget, configs = mods["budget"], mods["configs"]
    rows = {}
    for arch in PLAN_ARCHS:
        for mode in ("sparse_pallas", "dense"):
            try:
                p = budget.plan(configs.get(arch), hbm_budget=FULL_BUDGET,
                                weight_mode=mode, sparsity=SPARSITY,
                                block=16)
            except ValueError as e:
                rows[f"{arch}/{mode}"] = dict(error=str(e))
                print(f"plan: {arch:8s} {mode:13s} {e}", flush=True)
                continue
            rows[f"{arch}/{mode}"] = dict(
                p.as_dict(), n_dense_slots_1024=p.n_dense_slots(1024))
            print(f"plan: {arch:8s} {mode:13s} weights {p.weight_bytes} B, "
                  f"workspace {p.workspace_bytes} B, {p.n_blocks} usable "
                  f"KV blocks of {p.block_bytes} B ({p.kv_positions} "
                  f"positions, {p.kv_bytes} B KV), n_dense_slots(1024) = "
                  f"{p.n_dense_slots(1024)}", flush=True)
    return rows


def _logits_vs_plain(torch, engine, params, cfg, prompts):
    """First decode step's logits through the kernels and through the
    plain versions (``backend="torch"``) on the same params; the first
    tokens must agree, or differ only in rows where the plain prefill's
    top-2 margin is below ``NEAR_TIE`` (a random 256 000-word head has
    near ties). Both decode steps take the plain run's first tokens.
    A codebook model's rows are its (request, codebook) pairs.
    Returns (kernels' logits, plain logits, f32, the rows cut at a near
    tie as (row, plain margin), and how many rows have a plain margin
    below ``NEAR_TIE``)."""
    S = prompts.shape[-1]
    first, caches = {}, {}
    with torch.inference_mode():
        for backend in ("cuda", "torch"):
            last, caches[backend] = engine.prefill(params, prompts, cfg,
                                                   S + 1, backend=backend)
            # a codebook model's [B, n_cb, V]: one row a (request, codebook)
            lead = last.shape[:-1]
            first[backend] = (torch.argmax(last, dim=-1).reshape(-1),
                              last.float().reshape(-1, last.shape[-1]))
            del last
        ties, n_under = _first_token_ties(torch, first["cuda"][0],
                                          *first["torch"])
        check(all(m < NEAR_TIE for _, m in ties),
              f"{cfg.n_layers} layers: first token differs between kernels "
              f"and plain versions (rows and plain top-2 margins {ties}; "
              f"a near tie is below {NEAR_TIE:.3f})")
        tok = first["torch"][0].reshape(lead)[..., None]
        steps = {b: engine.serve_step(params, caches[b], tok, S, cfg,
                                      backend=b)[0].float()
                 for b in ("cuda", "torch")}
        del caches
    return steps["cuda"], steps["torch"], ties, n_under


def _first_token_ties(torch, got_tok, want_tok, want_logits):
    """The rows whose first tokens differ, each with the plain logits'
    top-2 margin, and how many rows have a plain margin below
    ``NEAR_TIE``."""
    margins = [_top2_margin(torch, row) for row in want_logits]
    rows = (got_tok != want_tok).nonzero()[:, 0].tolist()
    return ([(r, margins[r]) for r in rows],
            sum(m < NEAR_TIE for m in margins))


# First-step logits against the plain path at depth: the kernels and the
# plain versions round each layer's bf16 outputs apart, and the residual
# stream carries every layer's difference on, so the error grows with
# depth. Measured (NVIDIA H100 80GB HBM3, 700 W, OPT-30B at sparsity 0.8,
# 4 prompts of 128 tokens): the worst element's share of LOGITS_TOL
# (3e-2 + 3e-2 relative) was 0.70, 0.94, 1.24 and 1.80 at 4, 12, 24 and
# 48 layers (max abs err 0.023, 0.039, 0.047, 0.062). A sum of
# independent per-layer roundings grows as the square root of the depth,
# so the tolerance is LOGITS_TOL at the slice's 4 layers, scaled by
# sqrt(n_layers / 4) past them: 0.104 at 48 layers, 0.070 at
# tinyllama's 22. The 4-layer checks keep LOGITS_TOL. The phase holds
# 4 and 48 layers: the 12- and 24-layer checks went when the whole script
# ran past its 1200 s limit on a slow host.
DEPTH_SWEEP = (4, 48)


def depth_logits_tol(n_layers: int) -> float:
    return LOGITS_TOL * max(1.0, (n_layers / 4) ** 0.5)


def full_depth_phase(torch, mods) -> dict:
    """OPT-30B at all 48 layers and full width, built layer by layer from
    ``SEED`` at sparsity 0.8, its paged pool sized by ``budget.plan`` for
    80 GB: the planner's three models, planned against built weight bytes,
    the first decode step against the plain path, a closed loop of 32
    requests (128-768 prompt tokens, 64 greedy new tokens) over 32 slots
    at max_len 1024 with the decode step as a CUDA graph, every launch
    configuration it made held against its plain version, peak allocated
    bytes against the budget, and ``autotune`` at the decode widths."""
    import numpy as np
    configs, serve, budget, spmm, engine, cfgmod = (mods[x] for x in (
        "configs", "serve", "budget", "spmm", "engine", "serve_config"))
    check(not os.environ.get("REPRO_SCHEDULE_CACHE"),
          "REPRO_SCHEDULE_CACHE is set: serving must keep the analytic pick")
    cfg = configs.get("opt_30b")
    out = dict(plans=plans_report(mods))
    plan = budget.plan(cfg, hbm_budget=FULL_BUDGET,
                       weight_mode="sparse_pallas", sparsity=SPARSITY,
                       block=16)
    print(f"full depth: {cfg.name}, {cfg.n_layers} layers at full width, "
          f"sparsity {SPARSITY}; pool {plan.n_blocks} blocks of 16 from "
          f"the {FULL_BUDGET:.0f} B plan; {FULL_SLOTS} slots, max_len "
          f"{FULL_MAX_LEN}, admit_k {FULL_ADMIT_K}", flush=True)
    release(torch)
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    params, built = serve.build(cfg, seed=SEED, sparsity=SPARSITY,
                                device="cuda")
    lm_dense = cfg.vocab * cfg.d_model * 2
    lm_planned = budget.csl_bytes(cfg.vocab, cfg.d_model, SPARSITY)
    free_b, total_b = torch.cuda.mem_get_info()
    out.update(build=dict(
        encode_s=built["encode_s"], build_s=built["build_s"],
        n_tiled_csl=built["n_tiled_csl"], sparse_bytes=built["sparse_bytes"],
        built_weight_bytes=built["weight_bytes"],
        planned_weight_bytes=plan.weight_bytes,
        lm_head_dense_bytes=lm_dense, lm_head_planned_bytes=lm_planned,
        build_peak_allocated=built["max_memory_allocated"],
        allocated_before=before, mem_free=free_b, mem_total=total_b))
    print(f"full depth: built in {built['build_s']:.1f} s (prune, encode, "
          f"re-pad and group {built['encode_s']:.1f} s), "
          f"{built['n_tiled_csl']} Tiled-CSL weights of "
          f"{built['sparse_bytes']} B; weights as built "
          f"{built['weight_bytes']} B against {plan.weight_bytes} B planned "
          f"({built['weight_bytes'] - plan.weight_bytes:+d} B; the plan "
          f"counts lm_head as Tiled-CSL, {lm_planned} B, where it is built "
          f"dense, {lm_dense} B); build peak allocated "
          f"{built['max_memory_allocated']} B ({before} B allocated before "
          f"it); mem_get_info free {free_b} of {total_b} B", flush=True)
    check(built["max_memory_allocated"] <= FULL_BUDGET,
          f"build peak {built['max_memory_allocated']} B over the budget")

    prompts = serve.make_prompts(cfg, 4, 128, SEED, "cuda")
    out["logits_by_depth"] = {}
    for depth in sorted({d for d in DEPTH_SWEEP if d < cfg.n_layers}
                        | {cfg.n_layers}):
        tol = depth_logits_tol(depth)
        got, want, _, _ = _logits_vs_plain(
            torch, engine, dict(params, layers=params["layers"][:depth]),
            dataclasses.replace(cfg, n_layers=depth), prompts)
        share = float(((got - want).abs() / (
            LOGITS_TOL + LOGITS_TOL * want.abs())).max())
        err = close(torch, got, want, dict(rtol=tol, atol=tol),
                    f"full depth: first decode-step logits vs plain at "
                    f"{depth} layers")
        out["logits_by_depth"][depth] = dict(max_abs_err=err, tol=tol,
                                             share_of_logits_tol=share)
        print(f"full depth: first decode-step logits vs plain at {depth} "
              f"layers: max abs err {err:.3e}, worst element at {share:.3f}"
              f" of LOGITS_TOL; tolerance {tol:.4f} + {tol:.4f} relative",
              flush=True)
        del got, want
    out["logits_max_abs_err"] = out["logits_by_depth"][cfg.n_layers][
        "max_abs_err"]
    release(torch)

    rng = np.random.default_rng(SEED)
    lengths = rng.integers(*FULL_PROMPT, FULL_REQUESTS)
    reqs = [rng.integers(0, cfg.vocab, int(n)).astype(np.int64)
            for n in lengths]
    config = cfgmod.ServeConfig(
        scheduler=cfgmod.SchedulerConfig(
            n_slots=FULL_SLOTS, max_len=FULL_MAX_LEN, min_bucket=8,
            admit_k=FULL_ADMIT_K),
        cache_kind="paged", block_size=16, n_blocks=plan.n_blocks)
    print(f"full depth: {FULL_REQUESTS} requests, prompts "
          f"{int(lengths.min())}-{int(lengths.max())} tokens, {FULL_NEW} "
          f"greedy new tokens each", flush=True)
    torch.cuda.reset_peak_memory_stats()
    probe = LaunchProbe(spmm)
    with probe:
        spmm.reset_launch_counts()
        server, _, run = _closed_loop(
            torch, mods, params, cfg, reqs, probe, paged=True, graph=True,
            config=config, new=FULL_NEW, label="full depth")
        counts = spmm.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    run.update(launches=counts, peak_allocated=peak,
               pool_bytes=(plan.n_blocks + 1) * plan.block_bytes)
    print(f"full depth: launches {json.dumps(counts)} (graph replays "
          f"counted; one replay launches {json.dumps(run['graph_launches'])})"
          f"; by call {json.dumps(run['launches_by_phase'])}; peak "
          f"allocated {peak} B against the {FULL_BUDGET:.0f} B budget "
          f"(weights {built['weight_bytes']} B, pool {run['pool_bytes']} B)",
          flush=True)
    missing = [k for k in spmm.WEIGHT_KERNELS if counts[k] == 0]
    check(not missing, f"full depth: kernels never launched: {missing}")
    check(peak <= FULL_BUDGET, f"full depth: peak allocated {peak} B over "
          f"the {FULL_BUDGET:.0f} B budget")
    out["serve"] = run
    out["profile"] = _profile_decode(torch, server.batcher.stepper)
    r = out["profile"]
    if r["busy_share"] is None:
        print("full depth: profile: no device activity seen; the busy "
              "share is not measured", flush=True)
    else:
        print(f"full depth: profile graphed decode step: "
              f"{r['wall_ms_per_step']:.3f} ms/step wall under "
              f"torch.profiler, device busy {r['busy_ms_per_step']:.3f} "
              f"ms/step ({100 * r['busy_share']:.1f}%), LSCD kernels "
              f"{r['lscd_ms_per_step']:.3f} ms/step", flush=True)
        for ms, n, name in r["top"]:
            print(f"full depth:   {ms:8.3f} ms/step {n:4d}/step  {name}")
    del server
    release(torch)
    out["checked_launches"] = _check_served_launches(
        torch, mods, probe.seen, cfg, label="full depth")
    print(f"full depth: {len(out['checked_launches'])} launch configurations "
          f"held against the plain versions", flush=True)
    out["autotune"] = autotune_phase(torch, mods, params["layers"][0])
    del params, probe
    release(torch)
    return out


def autotune_phase(torch, mods, layer) -> list:
    """``schedule.autotune`` (CUDA events, cold L2) on one layer's four
    projections at the decode widths, into a cache file of its own in the
    kernels' build directory; each winner and its µs beside ``select``'s
    analytic pick and that pick's µs from the same sweep."""
    schedule = mods["schedule"]
    path = str(mods["build"].build_dir() / "autotune_cache.json")
    if os.path.exists(path):
        os.remove(path)
    cache = schedule.ScheduleCache(path)
    flush = torch.empty(2 ** 28, dtype=torch.int32, device="cuda")
    weights = {"wqkv": (layer["attn"]["wqkv"]["w"], "none"),
               "wo": (layer["attn"]["wo"]["w"], "none"),
               "up": (layer["mlp"]["up"]["w"], "gelu"),
               "down": (layer["mlp"]["down"]["w"], "none")}
    rows = []
    for name, (t, epi) in weights.items():
        for n in AUTOTUNE_NS:
            best, timings = schedule.autotune(t, n, backend="cuda",
                                              cache=cache, epilogue=epi,
                                              flush=flush)
            m, k = t.shape
            pick = schedule.select_analytic(
                m, k, n, m_tb=t.m_tb, k_tb=t.k_tb, max_nnz=t.max_nnz,
                group=t.group or 1)
            row = dict(shape=name, n=n, winner=dataclasses.asdict(best),
                       winner_us=timings[best],
                       analytic=dataclasses.asdict(pick),
                       analytic_us=timings[pick], candidates=len(timings))
            rows.append(row)
            print(f"autotune: {name:5s} N={n:<3d} winner n_tb={best.n_tb:<3d}"
                  f" S={best.split_k:<2d} {timings[best]:8.2f} us; select's "
                  f"pick n_tb={pick.n_tb:<3d} S={pick.split_k:<2d} "
                  f"{timings[pick]:8.2f} us ({timings[pick] / timings[best]:.3f}"
                  f"x); {len(timings)} candidates timed", flush=True)
    check(len(schedule.ScheduleCache(path)) == len(rows),
          "autotune: the cache does not hold one winner per shape")
    del flush
    return rows


def tinyllama_phase(torch, mods) -> dict:
    """tinyllama_1_1b at full size (22 layers, GQA with 4 K/V heads,
    SwiGLU), built layer by layer at sparsity 0.8, served in a short
    closed loop (16 slots, max_len 512, 16 requests of 32-384 prompt
    tokens, 32 greedy new tokens; the paged pool at the dense
    byte-equivalent): the grouped ``gate_up`` ``silu_mul`` launches and
    the GQA q/k/v launches on a served path, each configuration held
    against its plain version, and the first decode step against the
    plain path through the server."""
    import numpy as np
    configs, serve, spmm = (mods[x] for x in ("configs", "serve", "spmm"))
    cfg = configs.get("tinyllama_1_1b")
    params, built = serve.build(cfg, seed=SEED, sparsity=SPARSITY,
                                device="cuda")
    print(f"tinyllama: {cfg.name}, {cfg.n_layers} layers (d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads, {cfg.n_kv} K/V heads, d_ff "
          f"{cfg.d_ff}); built in {built['build_s']:.1f} s, "
          f"{built['n_tiled_csl']} Tiled-CSL weights", flush=True)
    rng = np.random.default_rng(SEED)
    lengths = rng.integers(*SERVE_PROMPT, TINY_REQUESTS)
    reqs = [rng.integers(0, cfg.vocab, int(n)).astype(np.int64)
            for n in lengths]
    probe = LaunchProbe(spmm)
    with probe:
        spmm.reset_launch_counts()
        server, _, run = _closed_loop(
            torch, mods, params, cfg, reqs, probe, paged=True, graph=True,
            new=TINY_NEW, label="tinyllama")
        counts = spmm.launch_counts()
    run["launches"] = counts
    print(f"tinyllama: launches {json.dumps(counts)}; by call "
          f"{json.dumps(run['launches_by_phase'])}", flush=True)
    check(counts["lscd_spmm_grouped"] + counts["lscd_spmm_splitk_grouped"]
          > 0, "tinyllama: no grouped launch")
    check(any(key[6] == "silu_mul" for key in probe.seen),
          "tinyllama: the gate_up silu_mul epilogue never launched")
    del server
    release(torch)
    tol = depth_logits_tol(cfg.n_layers)
    err = _first_step_logits(torch, mods, params, cfg, reqs, tol=tol)
    print(f"tinyllama: first decode-step logits vs plain max abs err "
          f"{err:.3e} (tolerance {tol:.4f} + {tol:.4f} relative)",
          flush=True)
    checked = _check_served_launches(torch, mods, probe.seen, cfg,
                                     label="tinyllama")
    print(f"tinyllama: {len(checked)} launch configurations held against "
          f"the plain versions", flush=True)
    del params, probe
    release(torch)
    return dict(serve=run, logits_max_abs_err=err, checked_launches=checked,
                build_s=built["build_s"], encode_s=built["encode_s"])


# ---------------------------------------------------------------------------
# examples phase: the port's four example entry points on the card
# ---------------------------------------------------------------------------

EXAMPLES = ("torch_quickstart", "torch_train_prune_serve",
            "torch_serve_batched", "torch_serve_chaos")
LIFE_ARCH = "tinyllama_1_1b"
LIFE_LAYERS = 4               # published widths, the depth cut
LIFE_STEPS = 30               # dense AdamW steps, then 10 with the masks
# The dense run's peak learning rate: at the reference example's 1e-3
# (for its 320-wide model) a held-out batch's loss rose over the 30
# steps at these widths, at 3e-4 it fell (tools/torch_lifecycle_lr.py;
# PERF.md, PR 29).
LIFE_LR = 3e-4
LIFE_FINETUNE = 10
LIFE_BATCH, LIFE_SEQ = 4, 128
EXAMPLES_LOG = os.path.join("chiprun_out", "examples.log")


def _example(stem: str):
    """``examples/<stem>.py`` as a module (its ``main`` and functions)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        stem, os.path.join(ROOT, "examples", f"{stem}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quiet(log, fn, *args, **kw):
    """``fn(*args, **kw)`` with its printing sent to ``log``."""
    import contextlib
    with contextlib.redirect_stdout(log):
        return fn(*args, **kw)


def _quickstart(torch, mods, ex, probe) -> dict:
    """(a) ``torch_quickstart.py`` at its own shape (1024 x 1024, N = 16,
    0.8): the kernel's output against ``spmm_dense_oracle`` (within the
    bf16 rounding of the encoded values) and against the plain version."""
    ref, spmm = mods["ref"], mods["spmm"]
    probe.phase = "quickstart"
    spmm.reset_launch_counts()
    q = ex.main([], device="cuda")
    torch.cuda.synchronize()
    counts = spmm.launch_counts()
    check(sum(counts.values()) == 1, f"quickstart: launches {counts}")
    # bf16 rounds each value by at most 2^-8 of itself (its unit roundoff),
    # so each output moves by at most 2^-8 of sum |w| |x|
    rounding = 2.0 ** -8 * float((q["w_pruned"].abs() @ q["x"].abs()).max())
    check(q["err"] <= rounding, f"quickstart: {q['err']:.3e} from the dense "
          f"oracle, past the bf16 rounding bound {rounding:.3e}")
    plain = close(torch, q["y"], ref.spmm_ref(q["encoded"], q["x"]),
                  F32_TOL, "quickstart: kernel vs plain")
    print(f"examples: quickstart on {q['device']}: launches "
          f"{json.dumps({k: n for k, n in counts.items() if n})}; vs the "
          f"dense oracle {q['err']:.4e} (bound {rounding:.4e}), vs plain "
          f"{plain:.3e}; roofline on H100 peaks: dense "
          f"{q['dense'].step_time_s * 1e6:.3f} us, LSCD "
          f"{q['lscd'].step_time_s * 1e6:.3f} us", flush=True)
    return dict(launches=counts, oracle_err=q["err"], oracle_bound=rounding,
                plain_err=plain)


def _lifecycle(torch, mods, ex, probe, cfg) -> dict:
    """(b) ``torch_train_prune_serve.py``'s functions at tinyllama-1.1b's
    published widths (``cfg``, cut to ``LIFE_LAYERS`` layers):
    ``LIFE_STEPS`` f32 AdamW steps, masks by ``opt_style_plan`` on the
    MLP and 0.8 on attention, ``LIFE_FINETUNE`` steps with the masks
    (losses finite, a held-out batch's loss lowered by the training, the
    kept weights moved by the retraining and no masked weight nonzero
    after any step), the attention reformatted, and 8 requests served
    through the kernels and through the plain versions: the streams equal
    (or parted at a near tie). The caller holds every launch configuration against its plain
    version."""
    import math
    spmm, opt_mod = mods["spmm"], mods["optimizer"]
    t0 = time.perf_counter()
    trained = ex.train(cfg, LIFE_STEPS, batch=LIFE_BATCH, seq=LIFE_SEQ,
                       lr=LIFE_LR, seed=SEED, device="cuda",
                       log_every=LIFE_STEPS + 1)
    train_s = time.perf_counter() - t0
    losses = trained["losses"]
    check(all(math.isfinite(x) for x in losses), f"lifecycle: a training "
          f"loss is not finite: {losses}")
    params = trained["state"].params
    plan = mods["pruning"].opt_style_plan(cfg.n_layers, SPARSITY)
    masks = ex.make_masks(params, cfg)
    kept = {i: float(masks["layers"][i]["mlp"]["up"]["w"].float().mean())
            for i in range(cfg.n_layers)}
    check(all((kept[i] == 1.0) == (plan[i] == 0.0) for i in kept),
          f"lifecycle: the MLP masks {kept} do not follow the plan {plan}")
    pruned = opt_mod.apply_masks(params, masks)
    eval_batch = mods["train_loop"].batch_to(trained["stream"].next_batch(),
                                             "cuda")
    # the training lowered the loss: the same held-out batch through the
    # params the run started from (one batch's loss against another's
    # moves by about as much as 30 steps lower it)
    start = mods["transformer"].init_model(cfg, seed=SEED, device="cuda",
                                           dtype=torch.float32)
    loss_start = ex.loss_of(start, eval_batch, cfg)
    del start
    loss_dense = ex.loss_of(params, eval_batch, cfg)
    check(loss_dense < loss_start, f"lifecycle: the training did not lower "
          f"the loss of a held-out batch: {loss_start:.4f} at the start, "
          f"{loss_dense:.4f} after {LIFE_STEPS} steps")
    loss_pruned = ex.loss_of(pruned, eval_batch, cfg)
    t0 = time.perf_counter()
    ft = ex.finetune(pruned, masks, cfg, trained["stream"], LIFE_FINETUNE)
    ft_s = time.perf_counter() - t0
    check(all(math.isfinite(x) for x in ft["losses"]),
          f"lifecycle: a retraining loss is not finite: {ft['losses']}")
    check(not any(ft["masked_nonzero"]), f"lifecycle: masked weights "
          f"nonzero after the steps: {ft['masked_nonzero']}")
    # the retraining moved what the masks keep (a step that did nothing
    # would pass the gate above as well)
    before = dict(mods["ft"].flatten_with_paths(pruned))
    after = dict(mods["ft"].flatten_with_paths(ft["state"].params))
    moved = math.sqrt(sum(
        float(((after[path] - before[path]).square() * m).sum())
        for path, m in mods["ft"].flatten_with_paths(masks)))
    check(moved > 0.0, "lifecycle: the retraining left the kept weights "
          "as they were")
    loss_ft = ex.loss_of(ft["state"].params, eval_batch, cfg)
    del params, pruned, trained
    sparse, nbytes = ex.reformat(ft["state"].params)
    del ft["state"]
    release(torch)
    probe.phase = "lifecycle"
    spmm.reset_launch_counts()
    served = ex.serve(sparse, cfg)
    torch.cuda.synchronize()
    counts = spmm.launch_counts()
    # 8-token prompts are skinny too: select splits prefill's K as well
    check(sum(counts.values()) > 0, f"lifecycle: no kernel launched: "
          f"{counts}")
    plain = ex.serve(sparse, cfg, backend="torch", graph=False)
    check(all(len(t) == 12 for t in served["done"].values()),
          "lifecycle: a request finished short of its 12 tokens")
    cut = _near_tie_streams(torch, mods, sparse, cfg, served["prompts"],
                            served["done"], plain["done"], "lifecycle")
    print(f"examples: lifecycle at {LIFE_ARCH}'s widths, {cfg.n_layers} "
          f"layers: losses dense {losses[0]:.4f} -> {losses[-1]:.4f} over "
          f"{LIFE_STEPS} steps (peak lr {LIFE_LR}; a held-out batch "
          f"{loss_start:.4f} at the start, {loss_dense:.4f} after; "
          f"{train_s / LIFE_STEPS * 1e3:.1f} ms/step with "
          f"the first), pruned {loss_pruned:.4f}, retrained {loss_ft:.4f} "
          f"({ft_s / LIFE_FINETUNE * 1e3:.1f} ms/step, the kept weights "
          f"moved by {moved:.4e} in L2); MLP kept by layer "
          f"{json.dumps(kept)}; Tiled-CSL {nbytes['dense_bytes']} B dense -> "
          f"{nbytes['sparse_bytes']} B in {nbytes['n_tiled_csl']} weights; "
          f"served 8 x 12 tokens in {served['seconds']:.3f} s (plain "
          f"{plain['seconds']:.3f} s); launches {json.dumps(counts)}",
          flush=True)
    return dict(losses=losses, loss_pruned=loss_pruned, loss_retrained=loss_ft,
                loss_heldout_start=loss_start, loss_heldout_dense=loss_dense,
                retrain_kept_moved=moved,
                retrain_losses=ft["losses"], train_ms_per_step=train_s
                / LIFE_STEPS * 1e3, retrain_ms_per_step=ft_s / LIFE_FINETUNE
                * 1e3, mlp_kept=kept, bytes=nbytes,
                serve_s=served["seconds"], plain_serve_s=plain["seconds"],
                near_tie_cuts=len(cut), launches=counts)


def examples_phase(torch, mods) -> dict:
    """The port's four examples on the card: (a) the quickstart, (b) the
    lifecycle at tinyllama-1.1b's published widths, (c)
    ``torch_serve_batched.py --arch tinyllama_1_1b`` and
    ``torch_serve_chaos.py`` at their defaults on smoke weights, each
    drained clean, the chaos survivors bitwise the fault-free replay's.
    Every launch configuration of (a) and (b) is held against its plain
    version. The examples' own printing goes to ``EXAMPLES_LOG``."""
    spmm = mods["spmm"]
    ex = {stem: _example(stem) for stem in EXAMPLES}
    cfg = dataclasses.replace(mods["configs"].get(LIFE_ARCH),
                              n_layers=LIFE_LAYERS)
    probe = LaunchProbe(spmm)
    with probe:
        quick = _quickstart(torch, mods, ex["torch_quickstart"], probe)
        life = _lifecycle(torch, mods, ex["torch_train_prune_serve"], probe,
                          cfg)
    checked = _check_served_launches(torch, mods, probe.seen, cfg,
                                     label="examples")
    del probe
    release(torch)
    with open(os.path.join(ROOT, EXAMPLES_LOG), "w") as log:
        spmm.reset_launch_counts()
        batched = _quiet(log, ex["torch_serve_batched"].main,
                         ["--arch", "tinyllama_1_1b"], device="cuda")
        chaos = _quiet(log, ex["torch_serve_chaos"].main, [], device="cuda")
        served_counts = spmm.launch_counts()
    b = batched["server"].batcher
    check(len(batched["responses"]) == 10 and all(
        r.finish_reason for r in batched["responses"]),
        "serve_batched: a session did not finish")
    check(not b.busy and not b.sched.active_slot_ids(),
          "serve_batched: slots still held after the drain")
    check(chaos["quarantined"] == 1 and chaos["report"]["fired"] == 3
          and chaos["survivors"] == len(chaos["chaos"]) - 1,
          f"serve_chaos: {chaos['survivors']} survivors, "
          f"{chaos['quarantined']} quarantined, {chaos['report']}")
    print(f"examples: serve_batched {len(batched['responses'])} sessions in "
          f"{batched['steps']} steps, slots clean; serve_chaos "
          f"{chaos['survivors']} of {len(chaos['chaos'])} streams bitwise the "
          f"fault-free replay's, 1 quarantined, {chaos['report']['fired']} "
          f"faults fired, pools clean; their output in {EXAMPLES_LOG}",
          flush=True)
    del batched, chaos, ex
    release(torch)
    launches = {k: quick["launches"][k] + life["launches"][k]
                + served_counts[k] for k in spmm.KERNELS}
    return dict(quickstart=quick, lifecycle=life, launches=launches,
                checked_launches=checked)


# ---------------------------------------------------------------------------
# MLA phase: minicpm3_4b at full size
# ---------------------------------------------------------------------------

MLA_ARCH = "minicpm3_4b"
MLA_SLOTS, MLA_MAX_LEN, MLA_REQUESTS, MLA_NEW = 32, 1024, 32, 64
MLA_PROMPT = (128, 769)                 # uniform prompt lengths, half-open
MLA_DEPTHS = (4, 62)
# The layer check: prefill of 2 x 512 positions (N = 1024), decode and
# paged decode at 32 slots (N = 32), a verify window of 4 (N = 128).
LAYER_B, LAYER_S, LAYER_SLOTS, LAYER_T, LAYER_W = 2, 512, 32, 1024, 4
# Every MLA factor in Tiled-CSL as well as wo and the MLP: the
# reference's default_should_sparsify, lm_head aside.
MLA_ALL_FACTORS = ("'wo'", "'gate'", "'up'", "'down'", "'w_dq'", "'w_uq'",
                   "'w_dkv'", "'w_ukv'")
MLA_FACTORS = ("w_dq", "w_uq", "w_dkv", "w_ukv")


def mla_layer_check(torch, mods) -> dict:
    """One minicpm3 layer at full width with every factor (and the MLP) in
    Tiled-CSL, through the kernels against the same layer on the plain
    versions (``backend="torch"``), on the same inputs: prefill, decode
    at a 0-d and at a per-slot position against the dense latent cache,
    paged decode, and a verify window of ``LAYER_W`` over the latent
    pool; outputs and written latents within ``LOGITS_TOL``. The
    absorbed steps decode a Tiled-CSL ``w_ukv`` instead of launching it,
    so its shape is launched once at decode N directly. Every launch
    configuration (the four latent factors among them, at decode and
    prefill N) is then held against its plain version and timed."""
    configs, pruning, spmm = mods["configs"], mods["pruning"], mods["spmm"]
    transformer = mods["transformer"]
    cfg = dataclasses.replace(configs.get(MLA_ARCH), n_layers=1)
    params = transformer.init_model(cfg, seed=SEED, device="cuda")
    layer = pruning.group_projections(pruning.sparsify_params(
        params["layers"][0], SPARSITY, should_sparsify=lambda n: n.endswith(
            "['w']") and any(k in n for k in MLA_ALL_FACTORS)))
    del params
    for name in MLA_FACTORS + ("wo",):
        check(hasattr(layer["attn"][name]["w"], "words"),
              f"mla layer: {name} is not Tiled-CSL")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 7)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    kvr, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
    cache = {"ckv": randn(LAYER_SLOTS, LAYER_T, kvr),
             "krope": randn(LAYER_SLOTS, LAYER_T, dr)}
    nblk = LAYER_T // 16
    pool = {n: torch.cat([torch.zeros_like(t[:1, :16]),
                          t.reshape(LAYER_SLOTS * nblk, 16, t.shape[-1])])
            for n, t in cache.items()}
    tables = 1 + torch.arange(LAYER_SLOTS * nblk,
                              device="cuda").reshape(LAYER_SLOTS, nblk)
    per_slot = torch.randint(LAYER_W, LAYER_T - LAYER_W, (LAYER_SLOTS,),
                             generator=gen, device="cuda")
    positions = torch.arange(LAYER_S, device="cuda")[None].expand(
        LAYER_B, LAYER_S)
    cases = (
        ("prefill", "prefill", randn(LAYER_B, LAYER_S, cfg.d_model),
         dict(positions=positions, cache={
             "ckv": torch.zeros_like(cache["ckv"][:LAYER_B]),
             "krope": torch.zeros_like(cache["krope"][:LAYER_B])})),
        ("decode 0-d pos", "decode", randn(LAYER_SLOTS, 1, cfg.d_model),
         dict(cache=cache, pos=torch.tensor(LAYER_T // 2, device="cuda"))),
        ("decode per-slot pos", "decode", randn(LAYER_SLOTS, 1, cfg.d_model),
         dict(cache=cache, pos=per_slot)),
        ("paged decode", "decode", randn(LAYER_SLOTS, 1, cfg.d_model),
         dict(cache=pool, pos=per_slot, block_tables=tables)),
        ("verify", "verify", randn(LAYER_SLOTS, LAYER_W, cfg.d_model),
         dict(cache=pool, pos=per_slot, block_tables=tables)))
    probe = LaunchProbe(spmm)
    out = dict(modes={})
    tol = dict(rtol=LOGITS_TOL, atol=LOGITS_TOL)
    with probe, torch.inference_mode():
        for label, mode, x, kw in cases:
            probe.phase = mode
            res = {}
            for backend in ("cuda", "torch"):
                args = dict(kw, cache={n: t.clone()
                                       for n, t in kw["cache"].items()})
                y, new = transformer.block_apply(layer, x, cfg, mode=mode,
                                                 backend=backend, **args)
                res[backend] = (y, new)
            probe.phase = None
            err = close(torch, res["cuda"][0], res["torch"][0], tol,
                        f"mla layer: {label}: output vs plain")
            lat = max(close(torch, res["cuda"][1][n], res["torch"][1][n],
                            tol, f"mla layer: {label}: {n} vs plain")
                      for n in ("ckv", "krope"))
            out["modes"][label] = dict(max_abs_err=err,
                                       latent_max_abs_err=lat,
                                       n=int(x.shape[0] * x.shape[1]))
            print(f"mla layer: {label:20s} N={x.shape[0] * x.shape[1]:<5d}"
                  f" output vs plain max abs err {err:.3e}, latents "
                  f"{lat:.3e} (tol {LOGITS_TOL} + {LOGITS_TOL} relative)",
                  flush=True)
            del res
        # The absorbed decode and verify decode a Tiled-CSL w_ukv in place
        # of a launch, so its shape is launched at decode N directly.
        probe.phase = "direct"
        w = layer["attn"]["w_ukv"]["w"]
        mods["ops"].spmm(w, randn(w.shape[1], LAYER_SLOTS))
        probe.phase = None
    names = _launch_names(cfg)
    ran = {(names.get((key[1], key[2])), key[-1]) for key in probe.seen}
    for name in MLA_FACTORS:
        modes = (("prefill", "direct") if name == "w_ukv"
                 else ("prefill", "decode", "verify"))
        for mode in modes:
            check((name, mode) in ran, f"mla layer: {name} never launched "
                  f"in {mode}")
    flush = torch.empty(2 ** 28, dtype=torch.int32, device="cuda")
    out["checked_launches"] = _check_served_launches(
        torch, mods, probe.seen, cfg, label="mla layer", flush=flush)
    del flush, layer, cache, pool, probe
    release(torch)
    return out


def mla_phase(torch, mods) -> dict:
    """minicpm3_4b at full size (62 layers, MLA, SwiGLU), built layer by
    layer at sparsity 0.8 (``serve.build``: wo and the MLP in Tiled-CSL,
    the latent factors dense), after ``mla_layer_check``: built against
    planned weight bytes and the planner's blocks at 80 GB, first-step
    logits against the plain path at ``MLA_DEPTHS``, then 32 requests
    (128-768 prompt tokens, 64 greedy new tokens) over 32 slots at
    max_len 1024 through ``StreamingServer``: dense graph on, paged graph
    on and paged graph off (identical streams), and the paged server with
    spec_k 3 and n-gram drafts (the verify graph over the latent pool;
    the near-tie rule against the paged streams, clean pools). All four
    LSCD kernels must launch and every launch configuration must pass its
    plain version. Returns the summary and the served runs' launches."""
    import numpy as np
    configs, serve, budget, spmm, engine, cfgmod = (mods[x] for x in (
        "configs", "serve", "budget", "spmm", "engine", "serve_config"))
    card = card_line()
    out = dict(card=card, layer_check=mla_layer_check(torch, mods))
    cfg = configs.get(MLA_ARCH)
    plans = {}
    for mode in ("sparse_pallas", "dense"):
        p = budget.plan(cfg, hbm_budget=FULL_BUDGET, weight_mode=mode,
                        sparsity=SPARSITY, block=16)
        plans[mode] = dict(p.as_dict(),
                           n_dense_slots_1024=p.n_dense_slots(1024))
        print(f"mla: plan {mode:13s} weights {p.weight_bytes} B, "
              f"workspace {p.workspace_bytes} B, {p.n_blocks} usable blocks "
              f"of {p.block_bytes} B ({budget.block_bytes(cfg, 1)} B a "
              f"token), n_dense_slots(1024) = {p.n_dense_slots(1024)}",
              flush=True)
    out["plans"] = plans
    release(torch)
    torch.cuda.reset_peak_memory_stats()
    params, built = serve.build(cfg, seed=SEED, sparsity=SPARSITY,
                                device="cuda")
    latent = sum(serve.params_bytes(layer["attn"][n])
                 for layer in params["layers"] for n in MLA_FACTORS)
    embed_head = serve.params_bytes(params["embed"]) + serve.params_bytes(
        params.get("lm_head", {}))
    planned = plans["sparse_pallas"]["weight_bytes"]
    dense_bf16 = budget.weight_bytes(cfg, "dense")
    out["build"] = dict(
        build_s=built["build_s"], encode_s=built["encode_s"],
        n_tiled_csl=built["n_tiled_csl"], sparse_bytes=built["sparse_bytes"],
        latent_factor_bytes=latent, embed_lm_head_bytes=embed_head,
        built_weight_bytes=built["weight_bytes"],
        planned_weight_bytes=planned, dense_bf16_bytes=dense_bf16,
        build_peak_allocated=built["max_memory_allocated"])
    print(f"mla: {cfg.name}, {cfg.n_layers} layers at full width (d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads, q_lora {cfg.q_lora_rank}, "
          f"kv_lora {cfg.kv_lora_rank}, d_ff {cfg.d_ff}, vocab {cfg.vocab})"
          f" built in {built['build_s']:.1f} s (prune, encode, re-pad and "
          f"group {built['encode_s']:.1f} s): {built['weight_bytes']} B as "
          f"built ({built['sparse_bytes']} B of Tiled-CSL in "
          f"{built['n_tiled_csl']} weights, {latent} B of dense latent "
          f"factors, {embed_head} B of embed and lm_head) against "
          f"{planned} B planned ({built['weight_bytes'] - planned:+d} B; the "
          f"plan counts lm_head and the latent factors as Tiled-CSL) and "
          f"{dense_bf16} B dense in bf16; build peak allocated "
          f"{built['max_memory_allocated']} B", flush=True)

    prompts = serve.make_prompts(cfg, 4, 128, SEED, "cuda")
    out["logits_by_depth"] = {}
    for depth in MLA_DEPTHS:
        tol = depth_logits_tol(depth)
        got, want, _, _ = _logits_vs_plain(
            torch, engine, dict(params, layers=params["layers"][:depth]),
            dataclasses.replace(cfg, n_layers=depth), prompts)
        err = close(torch, got, want, dict(rtol=tol, atol=tol),
                    f"mla: first decode-step logits vs plain at {depth} "
                    f"layers")
        out["logits_by_depth"][depth] = dict(max_abs_err=err, tol=tol)
        print(f"mla: first decode-step logits vs plain at {depth} layers: "
              f"max abs err {err:.3e} (tolerance {tol:.4f} + {tol:.4f} "
              f"relative)", flush=True)
        del got, want
    del prompts
    release(torch)

    rng = np.random.default_rng(SEED)
    lengths = rng.integers(*MLA_PROMPT, MLA_REQUESTS)
    reqs = [rng.integers(0, cfg.vocab, int(n)).astype(np.int64)
            for n in lengths]

    def config(paged, spec_k=0):
        return cfgmod.ServeConfig(
            scheduler=cfgmod.SchedulerConfig(
                n_slots=MLA_SLOTS, max_len=MLA_MAX_LEN, min_bucket=8,
                admit_k=4),
            cache_kind="paged" if paged else "dense", block_size=16,
            spec_k=spec_k)
    print(f"mla: {MLA_REQUESTS} requests, prompts {int(lengths.min())}-"
          f"{int(lengths.max())} tokens, {MLA_NEW} greedy new tokens each, "
          f"{MLA_SLOTS} slots, max_len {MLA_MAX_LEN}; the paged pool at the "
          f"dense byte-equivalent", flush=True)
    probe = LaunchProbe(spmm)
    runs, streams, launches = {}, {}, {}
    torch.cuda.reset_peak_memory_stats()
    with probe:
        spmm.reset_launch_counts()
        for key, paged, graph, spec_k in (
                ("dense_graph", False, True, 0),
                ("paged_graph", True, True, 0),
                ("paged_eager", True, False, 0),
                ("spec_graph", True, True, SPEC_K)):
            label = f"mla: {key}"
            server, streams[key], run = _closed_loop(
                torch, mods, params, cfg, reqs, probe, paged=paged,
                graph=graph, config=config(paged, spec_k), new=MLA_NEW,
                label=label)
            b = server.batcher
            if paged:
                _drained_clean(server, label)
            m = b.metrics
            run.update(captures=dict(b.stepper.captures),
                       drafted=m.drafted, accepted=m.accepted,
                       accept_rate=m.accept_rate,
                       tokens_per_step=m.tokens_per_step)
            if key == "paged_graph":
                out["profile"] = _profile_decode(torch, b.stepper)
            if spec_k:
                check(run["steps"]["verify"]["n"] > 0 and
                      b.stepper.captures["verify"] == 1,
                      f"{label}: verify steps {run['steps']['verify']['n']}"
                      f", captures {b.stepper.captures}")
                out["profile_verify"] = _profile_window(torch, b.stepper,
                                                        "verify")
            runs[key] = run
            del server, b
            release(torch)
        counts = spmm.launch_counts()
    out["peak_allocated"] = torch.cuda.max_memory_allocated()
    for key, run in runs.items():
        for op, c in run["launches_by_phase"].items():
            for k, n in c.items():
                launches.setdefault(op, dict.fromkeys(spmm.KERNELS, 0))[k] \
                    += n
    check(streams["dense_graph"] == streams["paged_graph"]
          == streams["paged_eager"],
          "mla: dense graph-on, paged graph-on and paged graph-off streams "
          "differ")
    missing = [k for k in spmm.WEIGHT_KERNELS if counts[k] == 0]
    check(not missing, f"mla: kernels never launched: {missing}")
    out["spec_cut"] = _near_tie_streams(
        torch, mods, params, cfg, dict(enumerate(reqs)),
        {i: streams["spec_graph"][f"r{i}"] for i in range(len(reqs))},
        {i: streams["paged_graph"][f"r{i}"] for i in range(len(reqs))},
        "mla: spec vs paged")
    release(torch)
    out["checked_launches"] = _check_served_launches(
        torch, mods, probe.seen, cfg, label="mla")
    d, p, e, sp = (runs[k] for k in ("dense_graph", "paged_graph",
                                     "paged_eager", "spec_graph"))
    print(f"mla: launches {json.dumps(counts)} (graph replays counted); by "
          f"call {json.dumps(launches)}; peak allocated "
          f"{out['peak_allocated']} B; {len(out['checked_launches'])} launch "
          f"configurations held against the plain versions", flush=True)
    print(f"mla: decode {d['decode_ms_per_step']:.3f} ms/step dense graph "
          f"on, {p['decode_ms_per_step']:.3f} paged graph on, "
          f"{e['decode_ms_per_step']:.3f} paged graph off; "
          f"{d['tokens_per_s']:.1f}/{p['tokens_per_s']:.1f}/"
          f"{e['tokens_per_s']:.1f} tok/s; TTFT p50/p99 "
          f"{p['ttft']['p50'] * 1e3:.1f}/{p['ttft']['p99'] * 1e3:.1f} ms, "
          f"TPOT p50/p99 {p['tpot']['p50'] * 1e3:.2f}/"
          f"{p['tpot']['p99'] * 1e3:.2f} ms (paged graph on); spec_k "
          f"{SPEC_K}: verify {sp['steps']['verify']['ms_per_step']:.3f} "
          f"ms/step (median {sp['steps']['verify']['median_ms']:.3f}), "
          f"accept rate {sp['accept_rate']:.4f}, "
          f"{sp['tokens_per_step']:.4f} tokens per active slot-step, "
          f"{sp['tokens_per_s']:.1f} tok/s, {len(out['spec_cut'])} streams "
          f"cut at a near tie (below {NEAR_TIE:.3f}); {card}", flush=True)
    for key, r in (("decode", out["profile"]),
                   ("verify", out["profile_verify"])):
        if r["busy_share"] is None:
            print(f"mla: profile {key}: no device activity seen; the busy "
                  "share is not measured", flush=True)
            continue
        print(f"mla: profile graphed {key} step: {r['wall_ms_per_step']:.3f}"
              f" ms/step wall under torch.profiler, device busy "
              f"{r['busy_ms_per_step']:.3f} ms/step "
              f"({100 * r['busy_share']:.1f}%), LSCD kernels "
              f"{r['lscd_ms_per_step']:.3f} ms/step; {card}", flush=True)
        for ms, n, name in r["top"]:
            print(f"mla:   {key} {ms:8.3f} ms/step {n:4d}/step  {name}")
    out.update(runs=runs, launches=counts, launches_by_phase=launches,
               near_tie=NEAR_TIE)
    del params, probe
    release(torch)
    return out


# ---------------------------------------------------------------------------
# MoE phase: qwen3_moe_30b_a3b at full size
# ---------------------------------------------------------------------------

MOE_ARCH, MOE_LAYER_ARCH = "qwen3_moe_30b_a3b", "qwen2_moe_a2_7b"
MOE_SLOTS, MOE_MAX_LEN, MOE_REQUESTS, MOE_NEW = 32, 1024, 32, 64
MOE_PROMPT = (128, 769)                 # uniform prompt lengths, half-open
MOE_DEPTHS = (4, 48)
# The prefill buckets are powers of two and admit_k is 4, so every
# admission's 4 x bucket tokens split into whole 256-token subgroups.
MOE_ADMIT_K = 4
# The layer check: prefill of 2 x 512 positions (N = 1024 for the dense
# products, 4 subgroups x C = 22 per expert), decode and paged decode at
# 32 slots (C = 3 per expert).
MOE_LAYER_B, MOE_LAYER_S, MOE_LAYER_SLOTS, MOE_LAYER_T = 2, 512, 32, 1024
MOE_STACKS = ("gate", "up", "down")


class RouteTrace:
    """While entered, wraps ``moe._router_logits`` (each MoE block's
    whole router logits; on a mesh rank the gathered ones) and records
    per call, as host arrays (so a trace can go to another process), the
    logits (``keep``), and per token its routes (the top-k of the f32
    softmax, sorted) and its top-k margin: the k-th largest router logit
    less the (k+1)-th (softmax keeps the order, so that is the margin a
    route flip must cross). Given ``pin``, an earlier trace's calls (its
    logits kept), a token whose routes differ from that trace's takes
    that trace's logits row, so every token routes as in the earlier run;
    ``calls`` keeps the routes from before the pin and ``pinned`` counts
    the tokens pinned."""

    def __init__(self, torch, moe, k: int, pin=None, keep: bool = True):
        self.torch, self.moe, self.k, self.pin = torch, moe, k, pin
        self.keep, self.calls, self.pinned = keep, [], 0

    def __enter__(self):
        self._orig = self.moe._router_logits
        self.moe._router_logits = self._traced
        return self

    def __exit__(self, *exc):
        self.moe._router_logits = self._orig

    def _routes(self, logits):
        torch = self.torch
        return torch.topk(torch.softmax(logits, dim=-1), self.k,
                          dim=-1).indices.sort(dim=-1).values

    def _traced(self, w, xt, E, tp, backend):
        torch, k = self.torch, self.k
        out = self._orig(w, xt, E, tp, backend)
        idx = self._routes(out)
        top = torch.topk(out, k + 1, dim=-1).values
        self.calls.append(dict(
            logits=out.cpu().numpy() if self.keep else None,
            idx=idx.reshape(-1, k).cpu().numpy(),
            margin=(top[..., k - 1] - top[..., k]).reshape(-1).cpu().numpy()))
        if self.pin is None:
            return out
        want = self.pin[len(self.calls) - 1]
        want_idx = torch.from_numpy(want["idx"]).to(out.device)
        flip = (idx.reshape(-1, k) != want_idx).any(dim=-1)
        self.pinned += int(flip.sum())
        out = torch.where(flip.reshape(out.shape[:-1])[..., None],
                          torch.from_numpy(want["logits"]).to(out.device),
                          out)
        check(torch.equal(self._routes(out).reshape(-1, k), want_idx),
              f"moe: MoE call {len(self.calls) - 1}: the pinned routes "
              "differ from the earlier run's")
        return out


def _moe_logits_vs_plain(torch, mods, params, cfg, prompts):
    """``_logits_vs_plain`` with every MoE call traced: the plain pass
    first, then the kernels' pass with its routes pinned to the plain
    pass's (``RouteTrace``). Returns (kernels' tokens, logits, plain
    tokens, logits, the first route that differed before the pin as
    (call, token, plain margin, kernels' margin) or None, the tokens
    pinned); calls run prefill's layers, then decode's."""
    engine, moe = mods["engine"], mods["moe"]
    S = prompts.shape[1]
    res, pin = {}, None
    with torch.inference_mode():
        for backend in ("torch", "cuda"):
            with RouteTrace(torch, moe, cfg.top_k, pin=pin) as rt:
                last, cache = engine.prefill(params, prompts, cfg, S + 1,
                                             backend=backend)
                tok = torch.argmax(last, dim=-1)[:, None]
                logits, _ = engine.serve_step(params, cache, tok, S, cfg,
                                              backend=backend)
            res[backend] = (tok, logits.float(), rt)
            pin = rt.calls
            del cache, last
    plain, kern = res["torch"][2], res["cuda"][2]
    check(len(plain.calls) == len(kern.calls), "moe: the kernels' pass made "
          f"{len(kern.calls)} MoE calls, the plain pass {len(plain.calls)}")
    first = _first_route_flip(kern.calls, plain.calls)
    return res["cuda"][0], res["cuda"][1], res["torch"][0], res["torch"][1], \
        first, kern.pinned


def moe_layer_check(torch, mods) -> dict:
    """One qwen2-moe-a2.7b layer at full width (d_model 2048, 16 heads with
    the q/k/v bias, 60 routed experts at d_expert 1408 top-4, the four
    shared experts fused to one 5632-wide SwiGLU) with every weight but
    the router in Tiled-CSL: wqkv grouped with its bias, wo, the shared
    expert's gate_up (``silu_mul``) and down, and the three routed
    expert stacks (the batched kernels). Through the kernels against the
    plain versions (``backend="torch"``) on the same inputs: the
    attention in prefill, decode and paged decode, then the MoE block
    on the plain side's normalised attention output, so both sides
    route the same tokens (the router is dense); outputs within
    ``LOGITS_TOL``. Every launch configuration is then held against its
    plain version and timed."""
    configs, pruning, spmm, serve = (mods[x] for x in (
        "configs", "pruning", "spmm", "serve"))
    transformer, attention, moe = (mods[x] for x in (
        "transformer", "attention", "moe"))
    cfg = dataclasses.replace(configs.get(MOE_LAYER_ARCH), n_layers=1)
    params = transformer.init_model(cfg, seed=SEED, device="cuda")
    layer = pruning.group_projections(pruning.sparsify_params(
        params["layers"][0], SPARSITY,
        should_sparsify=lambda n: any(k in n for k in serve.SPARSE_NAMES)
        and not n.endswith("['b']")))
    del params
    dt = torch.bfloat16
    for name in MOE_STACKS:
        check(getattr(layer["moe"][name], "stack", False),
              f"moe layer: {name} is not an expert stack")
    check("wqkv" in layer["attn"] and "gate_up" in layer["moe"]["shared"],
          "moe layer: wqkv or the shared gate_up is not grouped")
    layer["moe"]["router"]["w"] = layer["moe"]["router"]["w"].to(dt)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 9)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    kv = (cfg.n_kv, cfg.head_dim)
    cache = {n: randn(MOE_LAYER_SLOTS, MOE_LAYER_T, *kv) for n in ("k", "v")}
    nblk = MOE_LAYER_T // 16
    pool = {n: torch.cat([torch.zeros_like(t[:1, :16]),
                          t.reshape(MOE_LAYER_SLOTS * nblk, 16, *kv)])
            for n, t in cache.items()}
    tables = 1 + torch.arange(MOE_LAYER_SLOTS * nblk,
                              device="cuda").reshape(MOE_LAYER_SLOTS, nblk)
    per_slot = torch.randint(1, MOE_LAYER_T - 1, (MOE_LAYER_SLOTS,),
                             generator=gen, device="cuda")
    positions = torch.arange(MOE_LAYER_S, device="cuda")[None].expand(
        MOE_LAYER_B, MOE_LAYER_S)
    B, S = MOE_LAYER_B, MOE_LAYER_S
    cases = (
        ("prefill", randn(B, S, cfg.d_model),
         lambda p, h, c, be: attention.attention(
             p, h, positions, cfg, cache=c, backend=be),
         {n: torch.zeros_like(t[:B]) for n, t in cache.items()}),
        ("decode", randn(MOE_LAYER_SLOTS, 1, cfg.d_model),
         lambda p, h, c, be: attention.attention_decode(
             p, h, c, per_slot, cfg, backend=be), cache),
        ("paged decode", randn(MOE_LAYER_SLOTS, 1, cfg.d_model),
         lambda p, h, c, be: attention.attention_decode_paged(
             p, h, c, tables, per_slot, cfg, backend=be), pool))
    probe = LaunchProbe(spmm)
    out = dict(modes={})
    tol = dict(rtol=LOGITS_TOL, atol=LOGITS_TOL)
    with probe, torch.inference_mode():
        for label, x, attend, c in cases:
            probe.phase = "prefill" if label == "prefill" else "decode"
            h = transformer._norm(cfg, layer["pre_norm"], x)
            att = {}
            for backend in ("cuda", "torch"):
                a, _ = attend(layer["attn"], h, {n: t.clone()
                                                 for n, t in c.items()},
                              backend)
                att[backend] = a
            err_a = close(torch, att["cuda"], att["torch"], tol,
                          f"moe layer: {label}: attention vs plain")
            h2 = transformer._norm(cfg, layer["mlp_norm"], x + att["torch"])
            ys = {be: moe.moe_block(layer["moe"], h2, cfg, backend=be)[0]
                  for be in ("cuda", "torch")}
            err_m = close(torch, ys["cuda"], ys["torch"], tol,
                          f"moe layer: {label}: moe block vs plain")
            T = x.shape[0] * x.shape[1]
            sg = min(cfg.moe_subgroup, T)
            C = int(-(-sg * cfg.top_k // cfg.n_routed_experts)
                    * cfg.capacity_factor)
            out["modes"][label] = dict(attention_max_abs_err=err_a,
                                       moe_max_abs_err=err_m, tokens=T,
                                       expert_n=T // sg * C)
            print(f"moe layer: {label:12s} T={T:<5d} expert N={T // sg * C:<4d}"
                  f" attention vs plain max abs err {err_a:.3e}, MoE block "
                  f"{err_m:.3e} (tol {LOGITS_TOL} + {LOGITS_TOL} relative)",
                  flush=True)
            del att, ys, h, h2
        probe.phase = None
    names = _launch_names(cfg)
    ran = {(names.get((key[1], key[2])), key[-1]) for key in probe.seen}
    for name in ("e.gate", "e.down", "s.gate_up", "s.down", "wqkv", "wo"):
        for mode in ("prefill", "decode"):
            check((name, mode) in ran, f"moe layer: {name} never launched in "
                  f"{mode}")
    flush = torch.empty(2 ** 28, dtype=torch.int32, device="cuda")
    out["checked_launches"] = _check_served_launches(
        torch, mods, probe.seen, cfg, label="moe layer", flush=flush)
    del flush, layer, cache, pool, probe
    release(torch)
    return out


def moe_kernel_rows(torch, mods, layer, cfg, flush) -> dict:
    """The two batched kernels at their main-path cells, on the built
    model's first layer: ``lscd_spmm_splitk_batched`` on the routed gate
    stack and ``lscd_spmm_batched`` on the down stack, at the decode
    step's per-expert N (32 slots: C = 2), on the schedule ``select``
    picks there. Each is held against its plain version and timed beside
    it and beside ``torch.bmm`` on the decoded bf16 stack (the library
    call computing the same function); the bound counts this stack's
    real words, its counters, B and C once, and 2 * nnz * N operations."""
    ops, ref, schedule, roofline, tiled_csl = (mods[x] for x in (
        "ops", "ref", "schedule", "roofline", "tiled_csl"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 11)
    C = int(-(-MOE_SLOTS * cfg.top_k // cfg.n_routed_experts)
            * cfg.capacity_factor)
    rows = {}
    for kernel, stack in (("lscd_spmm_splitk_batched", "gate"),
                          ("lscd_spmm_batched", "down")):
        t = layer["moe"][stack]
        (m, k), e = t.shape, t.experts
        sel = schedule.select(m, k, C, m_tb=t.m_tb, k_tb=t.k_tb,
                              max_nnz=t.max_nnz, experts=e)
        split = max(sel.split_k, 2) if "splitk" in kernel else 1
        b = (0.1 * torch.randn((e, k, C), generator=gen,
                               device="cuda")).to(torch.bfloat16)

        def kern():
            return ops.spmm_batched(t, b, backend="cuda", n_tb=sel.n_tb,
                                    split_k=split)

        def plain():
            return ref.spmm_splitk_batched_ref(t, b, split,
                                               out_dtype=b.dtype)
        want = plain()
        err = close(torch, kern(), want, BF16_TOL,
                    f"{kernel} at {stack} {e}x{m}x{k} N={C} S={split}")
        dense = tiled_csl.decode(t).to(torch.bfloat16)
        nnz = int(t.nnz.sum())
        bound_s, bound_by = roofline.lscd_bound_s(
            4.0 * nnz, 4.0 * t.nnz.numel(), 2.0 * b.numel(),
            2.0 * want.numel(), 2.0 * nnz * C)
        rows[kernel] = dict(
            shape=f"e.{stack}", experts=e, m=m, k=k, n=C, n_tb=sel.n_tb,
            split_k=split, selected=dataclasses.asdict(sel),
            max_abs_err=err, ms=cuda_ms(torch, kern, 20, flush),
            plain_ms=cuda_ms(torch, plain, 3, flush),
            library_ms=cuda_ms(torch, lambda: torch.bmm(dense, b), 20,
                               flush),
            bound_ms=bound_s * 1e3, bound_by=bound_by,
            words_mib=t.words.numel() * 4 / 2 ** 20)
        r = rows[kernel]
        print(f"moe: {kernel:25s} e.{stack:4s} {e}x{m}x{k} N={C} "
              f"n_tb={sel.n_tb} S={split}: {r['ms']:.3f} ms (bound "
              f"{r['bound_ms']:.3f} ms by {bound_by}, plain "
              f"{r['plain_ms']:.3f} ms, torch.bmm {r['library_ms']:.3f} ms, "
              f"max err {err:.2e}; select -> n_tb {sel.n_tb}, S "
              f"{sel.split_k})", flush=True)
        del dense, want, b
    return rows


def moe_phase(torch, mods) -> dict:
    """qwen3-moe-30b-a3b at full size (48 layers, 128 routed experts top-8
    at d_expert 768, GQA with 4 K/V heads), built layer by layer at
    sparsity 0.8 (``serve.build``: the attention and the routed expert
    stacks in Tiled-CSL, the router, embed and ``lm_head`` dense), after
    ``moe_layer_check``: the planner's plans and built against planned
    weight bytes at 80 GB, first-step logits against the plain path at 4
    and 48 layers with the kernels' routes pinned to the plain run's
    (``depth_logits_tol``; where a route differed before the pin, the
    first that did must sit at a router near tie, both margins below
    ``NEAR_TIE``), then 32 requests
    (128-768 prompt tokens, 64 greedy new tokens) over 32 slots at
    max_len 1024 from the planner's pool: dense graph on, paged graph on
    and paged graph off (identical streams, clean pools). Every launch
    configuration must pass its plain version and the batched kernels
    must launch. Returns the summary and the served runs' launches."""
    import numpy as np
    configs, serve, budget, spmm, cfgmod, ops = (mods[x] for x in (
        "configs", "serve", "budget", "spmm", "serve_config", "ops"))
    card = card_line()
    out = dict(card=card, layer_check=moe_layer_check(torch, mods))
    cfg = configs.get(MOE_ARCH)
    plans = {}
    for mode in ("sparse_pallas", "dense"):
        p = budget.plan(cfg, hbm_budget=FULL_BUDGET, weight_mode=mode,
                        sparsity=SPARSITY, block=16)
        plans[mode] = dict(p.as_dict(),
                           n_dense_slots_1024=p.n_dense_slots(1024))
        print(f"moe: plan {mode:13s} weights {p.weight_bytes} B, "
              f"workspace {p.workspace_bytes} B, {p.n_blocks} usable blocks "
              f"of {p.block_bytes} B ({budget.block_bytes(cfg, 1)} B a "
              f"token), n_dense_slots(1024) = {p.n_dense_slots(1024)}",
              flush=True)
    out["plans"] = plans
    plan = plans["sparse_pallas"]
    release(torch)
    torch.cuda.reset_peak_memory_stats()
    ops.SCHEDULES.clear()
    params, built = serve.build(cfg, seed=SEED, sparsity=SPARSITY,
                                device="cuda")
    routed = sum(serve.params_bytes(layer["moe"][n])
                 for layer in params["layers"] for n in MOE_STACKS)
    embed_head = serve.params_bytes(params["embed"]) + serve.params_bytes(
        params.get("lm_head", {}))
    routed_dense = (3 * cfg.n_layers * cfg.n_routed_experts * cfg.d_expert
                    * cfg.d_model * 2)
    out["build"] = dict(
        build_s=built["build_s"], encode_s=built["encode_s"],
        n_tiled_csl=built["n_tiled_csl"], sparse_bytes=built["sparse_bytes"],
        routed_stack_bytes=routed, routed_stack_dense_bf16_bytes=routed_dense,
        embed_lm_head_bytes=embed_head,
        built_weight_bytes=built["weight_bytes"],
        planned_weight_bytes=plan["weight_bytes"],
        dense_bf16_bytes=budget.weight_bytes(cfg, "dense"),
        build_peak_allocated=built["max_memory_allocated"])
    print(f"moe: {cfg.name}, {cfg.n_layers} layers at full width (d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads, {cfg.n_kv} K/V heads, "
          f"{cfg.n_routed_experts} experts top-{cfg.top_k} at d_expert "
          f"{cfg.d_expert}, vocab {cfg.vocab}) built in "
          f"{built['build_s']:.1f} s (prune, encode, re-pad and group "
          f"{built['encode_s']:.1f} s): {built['weight_bytes']} B as built "
          f"({built['sparse_bytes']} B of Tiled-CSL in "
          f"{built['n_tiled_csl']} weights, of which {routed} B the routed "
          f"stacks ({routed_dense} B dense in bf16); {embed_head} B of "
          f"embed and lm_head) against {plan['weight_bytes']} B planned "
          f"({built['weight_bytes'] - plan['weight_bytes']:+d} B; the plan "
          f"counts the routed stacks dense, as the reference's does); build "
          f"peak allocated {built['max_memory_allocated']} B", flush=True)

    prompts = serve.make_prompts(cfg, 4, 128, SEED, "cuda")
    out["logits_by_depth"] = {}
    for depth in MOE_DEPTHS:
        tol = depth_logits_tol(depth)
        gtok, got, ptok, want, first, pinned = _moe_logits_vs_plain(
            torch, mods, dict(params, layers=params["layers"][:depth]),
            dataclasses.replace(cfg, n_layers=depth), prompts)
        err = float((got - want).abs().max())
        row = dict(max_abs_err=err, tol=tol, first_route_diff=first,
                   tokens_pinned=pinned)
        how = f"routes pinned, tolerance {tol:.4f} + {tol:.4f} relative; "
        if first is None:
            how += "every route agreed before the pin"
        else:
            call, tok, margin, kmargin = first
            how += (f"{pinned} token-routes pinned; unpinned, the routes "
                    f"first differ at MoE call {call} (layer {call % depth} "
                    f"of {'prefill' if call < depth else 'decode'}), token "
                    f"{tok}, at a router top-k margin of {margin:.3e} plain /"
                    f" {kmargin:.3e} kernels (near tie below {NEAR_TIE:.1e})")
        out["logits_by_depth"][depth] = row
        print(f"moe: first decode-step logits vs plain at {depth} layers: "
              f"max abs err {err:.3e}; {how}", flush=True)
        if first is not None:
            check(max(margin, kmargin) < NEAR_TIE, f"moe: {depth} layers: the"
                  f" routes first differ at MoE call {call} (layer "
                  f"{call % depth}), token {tok}, where the routers' top-k "
                  f"margins are {margin:.3e} plain and {kmargin:.3e} kernels "
                  f"(a near tie is below {NEAR_TIE:.1e})")
        check(torch.equal(gtok, ptok), f"moe: {depth} layers: first token "
              "differs between the kernels and the plain versions")
        close(torch, got, want, dict(rtol=tol, atol=tol),
              f"moe: first decode-step logits vs plain at {depth} layers, "
              "routes pinned to the plain run's")
        del got, want
    del prompts
    release(torch)

    rng = np.random.default_rng(SEED)
    lengths = rng.integers(*MOE_PROMPT, MOE_REQUESTS)
    reqs = [rng.integers(0, cfg.vocab, int(n)).astype(np.int64)
            for n in lengths]

    def config(paged):
        return cfgmod.ServeConfig(
            scheduler=cfgmod.SchedulerConfig(
                n_slots=MOE_SLOTS, max_len=MOE_MAX_LEN, min_bucket=8,
                admit_k=MOE_ADMIT_K),
            cache_kind="paged" if paged else "dense", block_size=16,
            n_blocks=plan["n_blocks"] if paged else None)
    print(f"moe: {MOE_REQUESTS} requests, prompts {int(lengths.min())}-"
          f"{int(lengths.max())} tokens, {MOE_NEW} greedy new tokens each, "
          f"{MOE_SLOTS} slots, max_len {MOE_MAX_LEN}, admit_k {MOE_ADMIT_K};"
          f" the paged pool at the planner's {plan['n_blocks']} blocks",
          flush=True)
    probe = LaunchProbe(spmm)
    runs, streams, launches = {}, {}, {}
    torch.cuda.reset_peak_memory_stats()
    with probe:
        spmm.reset_launch_counts()
        for key, paged, graph in (("dense_graph", False, True),
                                  ("paged_graph", True, True),
                                  ("paged_eager", True, False)):
            label = f"moe: {key}"
            server, streams[key], run = _closed_loop(
                torch, mods, params, cfg, reqs, probe, paged=paged,
                graph=graph, config=config(paged), new=MOE_NEW, label=label)
            if paged:
                _drained_clean(server, label)
            run["captures"] = dict(server.batcher.stepper.captures)
            if key == "paged_graph":
                out["profile"] = _profile_decode(torch,
                                                 server.batcher.stepper)
            runs[key] = run
            del server
            release(torch)
        counts = spmm.launch_counts()
    out["peak_allocated"] = torch.cuda.max_memory_allocated()
    for key, run in runs.items():
        for op, c in run["launches_by_phase"].items():
            for k, n in c.items():
                launches.setdefault(op, dict.fromkeys(spmm.KERNELS, 0))[k] \
                    += n
    check(streams["dense_graph"] == streams["paged_graph"]
          == streams["paged_eager"],
          "moe: dense graph-on, paged graph-on and paged graph-off streams "
          "differ")
    missing = [k for k in spmm.BATCHED_KERNELS if counts[k] == 0]
    check(not missing, f"moe: batched kernels never launched: {missing}")
    out["schedules"] = {
        f"{m}x{k} N={n} E={e}": dataclasses.asdict(sched)
        for (kind, m, k, n, e), sched in sorted(ops.SCHEDULES.items())
        if kind == "spmm_batched"}
    for key, sched in out["schedules"].items():
        print(f"moe: select's pick for the expert stacks at {key}: "
              f"n_tb {sched['n_tb']}, S {sched['split_k']}", flush=True)
    out["checked_launches"] = _check_served_launches(
        torch, mods, probe.seen, cfg, label="moe")
    flush = torch.empty(2 ** 28, dtype=torch.int32, device="cuda")
    out["kernel_rows"] = moe_kernel_rows(torch, mods, params["layers"][0],
                                         cfg, flush)
    del flush
    d, p, e = (runs[k] for k in ("dense_graph", "paged_graph",
                                 "paged_eager"))
    print(f"moe: launches {json.dumps(counts)} (graph replays counted); by "
          f"call {json.dumps(launches)}; peak allocated "
          f"{out['peak_allocated']} B; {len(out['checked_launches'])} launch "
          f"configurations held against the plain versions", flush=True)
    print(f"moe: decode {d['decode_ms_per_step']:.3f} ms/step dense graph "
          f"on, {p['decode_ms_per_step']:.3f} paged graph on, "
          f"{e['decode_ms_per_step']:.3f} paged graph off; "
          f"{d['tokens_per_s']:.1f}/{p['tokens_per_s']:.1f}/"
          f"{e['tokens_per_s']:.1f} tok/s; TTFT p50/p99 "
          f"{p['ttft']['p50'] * 1e3:.1f}/{p['ttft']['p99'] * 1e3:.1f} ms, "
          f"TPOT p50/p99 {p['tpot']['p50'] * 1e3:.2f}/"
          f"{p['tpot']['p99'] * 1e3:.2f} ms (paged graph on); {card}",
          flush=True)
    r = out["profile"]
    if r["busy_share"] is None:
        print("moe: profile: no device activity seen; the busy share is not "
              "measured", flush=True)
    else:
        print(f"moe: profile graphed decode step: {r['wall_ms_per_step']:.3f}"
              f" ms/step wall under torch.profiler, device busy "
              f"{r['busy_ms_per_step']:.3f} ms/step "
              f"({100 * r['busy_share']:.1f}%), LSCD kernels "
              f"{r['lscd_ms_per_step']:.3f} ms/step; {card}", flush=True)
        for ms, n, name in r["top"]:
            print(f"moe:   decode {ms:8.3f} ms/step {n:4d}/step  {name}")
    out.update(runs=runs, launches=counts, launches_by_phase=launches)
    del params, probe
    release(torch)
    return out


# ---------------------------------------------------------------------------
# hybrid phase: recurrentgemma_9b at full size, and the ring on the paged path
# ---------------------------------------------------------------------------

HYBRID_ARCH = "recurrentgemma_9b"
HYBRID_SLOTS, HYBRID_MAX_LEN, HYBRID_NEW = 32, 4096, 64
# 24 prompts inside the 2048-position window, 4 whose decode crosses the
# ring's wrap at position 2048 and 4 longer than the window, whose prefill
# rolls the trailing window into the ring (half-open ranges, counts).
HYBRID_PROMPTS = (((128, 1984), 24), ((1990, 2041), 4), ((2049, 2301), 4))
# Exact-length admission: a recurrent stack cannot absorb pad tokens, so
# requests of one length share a prefill; with distinct lengths one
# admission a step, and no admission group padded with copies of a row.
HYBRID_ADMIT_K = 1
# The layer check and the past-the-wrap logits: 2100 positions, longer
# than the window, through both branches of the attention (q-chunked past
# 512); decode at 32 slots with positions up to max_len.
HYBRID_LAYER_S = 2100
# The ring on the paged path: tinyllama at full width, 4 layers, window
# 64 (max_len 256, so ring_len 64); prompts of 16-64 tokens (their length
# bucket never exceeds the window) whose 64 new tokens run past the wrap.
RING_ARCH, RING_LAYERS, RING_WINDOW = "tinyllama_1_1b", 4, 64
RING_SLOTS, RING_MAX_LEN, RING_REQUESTS, RING_NEW = 16, 256, 16, 64
RING_PROMPT = (16, 65)


def hybrid_layer_check(torch, mods) -> dict:
    """One RG-LRU block and one local-attention block of recurrentgemma at
    full width, their projections in Tiled-CSL as the launchers encode
    them (the MLP, and the attention's wq, wk, wv and wo; the RG-LRU's
    w_x, w_gate, w_out and wa stay dense), through the kernels against
    the same blocks on the plain versions (``backend="torch"``), on the
    same inputs: prefill of ``HYBRID_LAYER_S`` positions (the window mask
    in the q-chunked branch and the roll into the ring), and decode at 32
    slots from a random carried state and a full ring, at positions up to
    ``HYBRID_MAX_LEN``. Outputs and written state within ``LOGITS_TOL``;
    every launch configuration then held against its plain version and
    timed."""
    configs, pruning, spmm, transformer, serve = (mods[x] for x in (
        "configs", "pruning", "spmm", "transformer", "serve"))
    cfg = configs.get(HYBRID_ARCH)
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    blocks = {}
    for kind in ("rglru", "attn"):
        blocks[kind] = pruning.group_projections(pruning.sparsify_params(
            transformer.init_block(gen, cfg, dev, kind=kind), SPARSITY,
            should_sparsify=lambda n: n.endswith("['w']") and any(
                k in n for k in serve.SPARSE_NAMES)))
    check(hasattr(blocks["rglru"]["mlp"]["gate_up"]["w"], "words")
          and hasattr(blocks["attn"]["attn"]["wq"]["w"], "words"),
          "hybrid layer: the projections are not Tiled-CSL")
    gen.manual_seed(SEED + 13)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    S, B, W = HYBRID_LAYER_S, HYBRID_SLOTS, cfg.local_window
    r, cv = cfg.rnn_dim, cfg.rglru_conv
    positions = torch.arange(S, device="cuda")[None]
    pos = torch.randint(0, HYBRID_MAX_LEN, (B,), generator=gen,
                        device="cuda")
    state = {"h": randn(B, r, dtype=torch.float32),
             "conv": randn(B, cv - 1, r, dtype=torch.float32)}
    ring = {n: randn(B, W, cfg.n_kv, cfg.head_dim) for n in ("k", "v")}
    cases = (
        ("rglru prefill", "rglru", "prefill", randn(1, S, cfg.d_model),
         dict(cache={"h": torch.zeros_like(state["h"][:1]),
                     "conv": torch.zeros_like(state["conv"][:1])})),
        ("attn prefill", "attn", "prefill", randn(1, S, cfg.d_model),
         dict(positions=positions,
              cache={n: torch.zeros_like(t[:1]) for n, t in ring.items()})),
        ("rglru decode", "rglru", "decode", randn(B, 1, cfg.d_model),
         dict(cache=state, pos=pos)),
        ("attn decode", "attn", "decode", randn(B, 1, cfg.d_model),
         dict(cache=ring, pos=pos)))
    probe = LaunchProbe(spmm)
    out = dict(modes={})
    tol = dict(rtol=LOGITS_TOL, atol=LOGITS_TOL)
    with probe, torch.inference_mode():
        for label, kind, mode, x, kw in cases:
            probe.phase = mode
            res = {}
            for backend in ("cuda", "torch"):
                args = dict(kw, cache={n: t.clone()
                                       for n, t in kw["cache"].items()})
                res[backend] = transformer.block_apply(
                    blocks[kind], x, cfg, mode=mode, kind=kind,
                    backend=backend, **args)
            probe.phase = None
            err = close(torch, res["cuda"][0], res["torch"][0], tol,
                        f"hybrid layer: {label}: output vs plain")
            st = max(close(torch, res["cuda"][1][n], res["torch"][1][n], tol,
                           f"hybrid layer: {label}: {n} vs plain")
                     for n in res["cuda"][1])
            out["modes"][label] = dict(max_abs_err=err, state_max_abs_err=st,
                                       n=int(x.shape[0] * x.shape[1]))
            print(f"hybrid layer: {label:14s} N={x.shape[0] * x.shape[1]:<5d}"
                  f" output vs plain max abs err {err:.3e}, written state "
                  f"{st:.3e} (tol {LOGITS_TOL} + {LOGITS_TOL} relative)",
                  flush=True)
            del res
    flush = torch.empty(2 ** 28, dtype=torch.int32, device="cuda")
    out["checked_launches"] = _check_served_launches(
        torch, mods, probe.seen, cfg, label="hybrid layer", flush=flush)
    del flush, blocks, state, ring, probe
    release(torch)
    return out


def hybrid_kernel_rows(torch, mods, layer, cfg, flush) -> list:
    """``gate_up`` (G = 2 with the ``silu_mul`` epilogue) and ``down`` of
    the built model's first layer at decode N = 32, on the schedule
    ``select`` picks there: the LSCD kernel held against its plain
    version and timed beside it and beside ``torch.matmul`` on the
    decoded bf16 weight (for gate_up the two products, without the
    epilogue); the bound counts the weight's real words, its counters, B
    and C once, and 2 * nnz * N operations."""
    ops, ref, schedule, roofline, tiled_csl = (mods[x] for x in (
        "ops", "ref", "schedule", "roofline", "tiled_csl"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 17)
    n = HYBRID_SLOTS
    rows = []
    for name, t, epi in (("gate_up", layer["mlp"]["gate_up"]["w"],
                          "silu_mul"),
                         ("down", layer["mlp"]["down"]["w"], "none")):
        (m, k), g = t.shape, t.group or 1
        sel = schedule.select(m, k, n, m_tb=t.m_tb, k_tb=t.k_tb,
                              max_nnz=t.max_nnz, group=g,
                              binary=epi == "silu_mul")
        b = (0.1 * torch.randn((k, n), generator=gen,
                               device="cuda")).to(torch.bfloat16)
        fn = ops.spmm_grouped if g > 1 else ops.spmm
        plain_fn = ref.spmm_grouped_ref if g > 1 else ref.spmm_ref

        def kern():
            return fn(t, b, backend="cuda", epilogue=epi)

        def plain():
            return plain_fn(t, b, out_dtype=b.dtype, epilogue=epi)
        want = plain()
        err = close(torch, kern(), want, BF16_TOL,
                    f"hybrid: {name} {g}x{m}x{k} N={n}")
        kernel = ("lscd_spmm" + ("_splitk" if sel.split_k > 1 else "")
                  + ("_grouped" if g > 1 else ""))
        dense = tiled_csl.decode(t).to(torch.bfloat16)
        nnz = int(t.nnz.sum())
        bound_s, bound_by = roofline.lscd_bound_s(
            4.0 * nnz, 4.0 * t.nnz.numel(), 2.0 * b.numel(),
            2.0 * want.numel(), 2.0 * nnz * n)
        row = dict(shape=name, kernel=kernel, group=g, m=m, k=k, n=n,
                   n_tb=sel.n_tb, split_k=sel.split_k, epilogue=epi,
                   max_abs_err=err, ms=cuda_ms(torch, kern, 20, flush),
                   plain_ms=cuda_ms(torch, plain, 3, flush),
                   library_ms=cuda_ms(torch, lambda: torch.matmul(dense, b),
                                      20, flush),
                   bound_ms=bound_s * 1e3, bound_by=bound_by)
        rows.append(row)
        print(f"hybrid: compare {name:7s} {g}x{m}x{k} N={n} {kernel} n_tb="
              f"{sel.n_tb} S={sel.split_k}: {row['ms']:.4f} ms (bound "
              f"{row['bound_ms']:.4f} ms by {bound_by}, plain "
              f"{row['plain_ms']:.4f} ms, torch.matmul "
              f"{row['library_ms']:.4f} ms, max err {err:.2e})", flush=True)
        del dense, want, b
    return rows


def ring_paged_check(torch, mods) -> dict:
    """The sliding-window ring on the paged path: tinyllama at full width
    cut to ``RING_LAYERS`` layers with ``local_window`` ``RING_WINDOW``,
    ``RING_REQUESTS`` requests whose streams run past the wrap, served
    with the dense ring (graph on, the plain side), the paged ring (block
    16) graph on and off, and the paged ring with spec_k 3 graph on and
    off. The paged streams must equal the dense ring's with the graph on
    and off; the speculative streams equal each other across the graph
    and the dense ring's by the near-tie rule; clean pools."""
    import numpy as np
    configs, serve, spmm, cfgmod = (mods[x] for x in (
        "configs", "serve", "spmm", "serve_config"))
    cfg = dataclasses.replace(configs.get(RING_ARCH), n_layers=RING_LAYERS,
                              local_window=RING_WINDOW)
    params, _ = serve.build(cfg, seed=SEED, sparsity=SPARSITY, device="cuda")
    rng = np.random.default_rng(SEED + 19)
    lengths = rng.integers(*RING_PROMPT, RING_REQUESTS)
    reqs = [rng.integers(0, cfg.vocab, int(n)).astype(np.int64)
            for n in lengths]

    def config(paged, spec_k=0):
        return cfgmod.ServeConfig(
            scheduler=cfgmod.SchedulerConfig(
                n_slots=RING_SLOTS, max_len=RING_MAX_LEN, min_bucket=8,
                admit_k=4),
            cache_kind="paged" if paged else "dense", block_size=16,
            spec_k=spec_k)
    print(f"ring: {cfg.name} at full width, {cfg.n_layers} layers, window "
          f"{RING_WINDOW} (ring_len {min(RING_MAX_LEN, RING_WINDOW)}); "
          f"{RING_REQUESTS} requests of {int(lengths.min())}-"
          f"{int(lengths.max())} prompt tokens, {RING_NEW} greedy new tokens"
          f" each, {RING_SLOTS} slots", flush=True)
    streams, runs = {}, {}
    probe = LaunchProbe(spmm)
    with probe:
        spmm.reset_launch_counts()
        for key, paged, graph, spec_k in (
                ("dense_graph", False, True, 0),
                ("paged_graph", True, True, 0), ("paged_eager", True, False, 0),
                ("spec_graph", True, True, SPEC_K),
                ("spec_eager", True, False, SPEC_K)):
            label = f"ring: {key}"
            server, streams[key], run = _closed_loop(
                torch, mods, params, cfg, reqs, probe, paged=paged,
                graph=graph, config=config(paged, spec_k), new=RING_NEW,
                label=label)
            b = server.batcher
            check(b.ring_len == RING_WINDOW, f"{label}: ring_len {b.ring_len}")
            if paged:
                _drained_clean(server, label)
            run.update(drafted=b.metrics.drafted, accepted=b.metrics.accepted)
            runs[key] = run
            del server, b
            release(torch)
        counts = spmm.launch_counts()
    check(streams["paged_graph"] == streams["dense_graph"]
          == streams["paged_eager"],
          "ring: paged streams (graph on, off) differ from the dense ring's")
    check(streams["spec_graph"] == streams["spec_eager"],
          "ring: speculative streams differ with the graph on and off")
    check(runs["spec_graph"]["drafted"] > 0, "ring: nothing was drafted")
    check(max(len(p) for p in reqs) + RING_NEW > RING_WINDOW,
          "ring: no stream runs past the wrap")
    probe.phase = None
    cut = _near_tie_streams(
        torch, mods, params, cfg, {f"r{i}": p for i, p in enumerate(reqs)},
        streams["spec_graph"], streams["dense_graph"], "ring: spec vs dense")
    checked = _check_served_launches(torch, mods, probe.seen, cfg,
                                     label="ring")
    print(f"ring: launches {json.dumps(counts)}; paged streams equal the "
          f"dense ring's graph on and off; spec_k {SPEC_K} accepted "
          f"{runs['spec_graph']['accepted']} of "
          f"{runs['spec_graph']['drafted']} drafts; {len(checked)} launch "
          f"configurations held against the plain versions", flush=True)
    del params, probe
    release(torch)
    return dict(runs=runs, launches=counts, spec_cut=cut,
                checked_launches=checked)


# First-step logits at full depth: free-running, the bf16 kernels and
# the bf16 plain path part by 1.13-1.40x depth_logits_tol at 8-38 layers
# (NVIDIA H100 80GB HBM3, 700 W, 4 prompts of 128 tokens), where OPT-30B,
# which set that tolerance, sits at 0.5-0.7x. So at 38 layers the phase
# holds depth_logits_tol on what the kernels themselves decide: the same
# stack with f32 activations (the kernels' f32 body against the plain
# versions in f32, with the engine's bf16 K/V cache and with an f32 one:
# 2.461e-03 against 2.767e-03, same card), and the bf16 stack
# teacher-forced (every layer's kernels on the plain path's
# input of that layer, ``_depth_drift``). The free-running bf16 gap is
# printed beside them, with each layer's share of it.
def _depth_drift(torch, mods, params, cfg, prompts) -> dict:
    """The first decode step layer by layer, three ways: the plain
    versions; the kernels free-running (each layer on the kernels' own
    output of the layer before, as served); and the kernels
    teacher-forced (each layer's kernels, prefill and decode, on the
    plain path's input of that layer, so only that layer's own
    difference reaches its output). The decode steps take the plain
    prefill's first tokens. Per layer: in prefill, the free-running gap,
    the teacher-forced (local) difference and the free-running cache's
    gap (the RG-LRU state, or K/V), as shares of the plain norms; on the
    decode rows, the free-running gap and the local difference, in norm
    and as shares of the plain output's norm, and the gain: the kernels'
    layer's outputs on the free-running and on the plain input apart,
    over those inputs apart. Returns the three logits (f32), the
    first-token ties and the rows."""
    transformer, layers = mods["transformer"], mods["layers"]
    B, S = prompts.shape
    dt = getattr(torch, cfg.dtype)
    positions = torch.arange(S, device="cuda")[None].expand(B, S)

    def layer(i, x, mode, cache, backend):
        return transformer.block_apply(
            params["layers"][i], x, cfg, mode=mode, kind=cfg.layer_kind(i),
            positions=positions, cache=cache, pos=S, backend=backend)

    def head(x, backend):
        x = transformer._norm(cfg, params["final_norm"], x[:, -1:])
        tied = cfg.tie_embeddings
        return layers.logits_head(
            None if tied else params["lm_head"],
            params["embed"] if tied else None, x, vocab=cfg.vocab,
            backend=backend)[:, -1].float()

    def norm(a, b=None):
        return float((a.float() - (0 if b is None else b.float())).norm())

    caches = {k: transformer.init_cache(cfg, B, S + 1, device="cuda")
              for k in ("plain", "free", "forced")}
    rows = []
    with torch.inference_mode():
        xp = xk = layers.embed(params["embed"], prompts, dt)
        for i in range(cfg.n_layers):
            nxt, caches["plain"][i] = layer(i, xp, "prefill",
                                            caches["plain"][i], "torch")
            xk, caches["free"][i] = layer(i, xk, "prefill",
                                          caches["free"][i], "cuda")
            xt, caches["forced"][i] = layer(i, xp, "prefill",
                                            caches["forced"][i], "cuda")
            state = [(caches["free"][i][n], t)
                     for n, t in caches["plain"][i].items()]
            rows.append(dict(
                layer=i, kind=cfg.layer_kind(i),
                prefill_gap_share=norm(xk, nxt) / norm(nxt),
                prefill_local_share=norm(xt, nxt) / norm(nxt),
                state_gap_share=sum(norm(a, b) ** 2 for a, b in state) ** 0.5
                / sum(norm(b) ** 2 for _, b in state) ** 0.5))
            xp = nxt
            del xt, state
        plain_first = head(xp, "torch")
        ties, n_under = _first_token_ties(
            torch, torch.argmax(head(xk, "cuda"), dim=-1),
            torch.argmax(plain_first, dim=-1), plain_first)
        del xp, xk
        yp = yk = layers.embed(
            params["embed"], torch.argmax(plain_first, dim=-1)[:, None], dt)
        for i, row in enumerate(rows):
            nxt, caches["plain"][i] = layer(i, yp, "decode",
                                            caches["plain"][i], "torch")
            free, caches["free"][i] = layer(i, yk, "decode",
                                            caches["free"][i], "cuda")
            yt, caches["forced"][i] = layer(i, yp, "decode",
                                            caches["forced"][i], "cuda")
            gap_in = norm(yk, yp)
            row.update(gap=norm(free, nxt), local=norm(yt, nxt),
                       out_norm=norm(nxt),
                       gap_share=norm(free, nxt) / norm(nxt),
                       local_share=norm(yt, nxt) / norm(nxt),
                       gain=norm(free, yt) / gap_in if gap_in else None)
            yp, yk = nxt, free
        logits = dict(plain=head(yp, "torch"), free=head(yk, "cuda"),
                      forced=head(yt, "cuda"))
    del caches
    return dict(logits=logits, ties=ties, rows_under_near_tie=n_under,
                rows=rows)


def _depth_drift_report(torch, mods, params, cfg, prompts) -> dict:
    """``_depth_drift`` at full depth, printed layer by layer: the
    teacher-forced logits must sit within ``depth_logits_tol`` of the
    plain path's, and the first tokens agree but at near ties; the
    free-running logits' distance is printed beside them, with the gap
    against the root sum of squares of the layers' own differences (1
    where the layers' differences only add up) and each kind's median
    gain."""
    import statistics
    drift = _depth_drift(torch, mods, params, cfg, prompts)
    depth, tol = cfg.n_layers, depth_logits_tol(cfg.n_layers)
    ties = drift["ties"]
    check(all(m < NEAR_TIE for _, m in ties),
          f"hybrid: {depth} layers layer by layer: first token differs "
          f"between kernels and plain versions (rows and plain top-2 "
          f"margins {ties}; a near tie is below {NEAR_TIE:.3f})")
    want = drift["logits"]["plain"]
    out = dict(rows=drift["rows"], ties=ties,
               rows_under_near_tie=drift["rows_under_near_tie"], tol=tol)
    for key in ("forced", "free"):
        got = drift["logits"][key]
        out[key] = dict(
            max_abs_err=float((got - want).abs().max()),
            share_of_tol=float(((got - want).abs()
                                / (tol + tol * want.abs())).max()))
    close(torch, drift["logits"]["forced"], want, dict(rtol=tol, atol=tol),
          f"hybrid: first decode-step logits vs plain at {depth} layers, "
          f"every layer's kernels on the plain path's input")
    rows = drift["rows"]
    for r in rows:
        gain = "-" if r["gain"] is None else f"{r['gain']:.3f}"
        print(f"hybrid: drift layer {r['layer']:2d} {r['kind']:5s} as "
              f"shares of the plain norms: decode gap {r['gap_share']:.3e},"
              f" its own {r['local_share']:.3e}, gain {gain}, output norm "
              f"{r['out_norm']:.4g}; prefill gap "
              f"{r['prefill_gap_share']:.3e}, its own "
              f"{r['prefill_local_share']:.3e}, cache "
              f"{r['state_gap_share']:.3e}", flush=True)
    out["accumulation"] = rows[-1]["gap"] / sum(
        r["local"] ** 2 for r in rows) ** 0.5
    gains = {}
    for r in rows:
        if r["gain"] is not None:
            gains.setdefault(r["kind"], []).append(r["gain"])
    out["median_gain"] = {k: statistics.median(g) for k, g in gains.items()}
    print(f"hybrid: first decode-step logits vs plain at {depth} layers: "
          f"teacher-forced max abs err {out['forced']['max_abs_err']:.3e} "
          f"({out['forced']['share_of_tol']:.3f} of {tol:.4f} + {tol:.4f} "
          f"relative; gate), free-running {out['free']['max_abs_err']:.3e} "
          f"({out['free']['share_of_tol']:.3f}; printed); the free-running "
          f"gap at the last layer {out['accumulation']:.3f} x the root sum "
          f"of squares of the layers' own differences; median gain "
          f"{json.dumps(out['median_gain'])}; {out['rows_under_near_tie']} "
          f"of {prompts.shape[0]} rows with a plain top-2 margin below "
          f"{NEAR_TIE:.2f}, first tokens differing there {ties}", flush=True)
    return out


def _f32_kv_cache_logits(torch, mods, params, cfg, prompts) -> tuple:
    """The first decode step of ``cfg`` (the f32 stack) through the
    kernels and the plain versions with an f32 K/V cache
    (``transformer.init_cache(..., dtype=torch.float32)``), through
    ``transformer.forward`` directly (the engine keeps the reference's
    bf16 cache). Prefill still rounds its K/V to bf16 before the write, as
    the reference does; the decode step's own K/V and the attention over
    the cache stay f32. Both decode steps take the plain run's first
    tokens. Returns the two logits (f32) and the near-tie rows."""
    transformer = mods["transformer"]
    B, S = prompts.shape
    caches, first = {}, {}
    with torch.inference_mode():
        for backend in ("cuda", "torch"):
            cache = transformer.init_cache(cfg, B, S + 1, device="cuda",
                                           dtype=torch.float32)
            logits, caches[backend] = transformer.forward(
                params, {"tokens": prompts}, cfg, mode="prefill", cache=cache,
                backend=backend)
            first[backend] = (torch.argmax(logits[:, -1], dim=-1),
                              logits[:, -1].float())
            del logits
        ties, n_under = _first_token_ties(torch, first["cuda"][0],
                                          *first["torch"])
        tok = first["torch"][0][:, None]
        steps = {b: transformer.forward(
            params, {"tokens": tok}, cfg, mode="decode", cache=caches[b],
            pos=S, backend=b)[0][:, -1].float() for b in ("cuda", "torch")}
    return steps["cuda"], steps["torch"], ties, n_under


def hybrid_phase(torch, mods) -> dict:
    """recurrentgemma_9b at full size (38 layers cycling rglru, rglru,
    attn; d_model 4096, MQA with head_dim 256 over a 2048-position
    window, a 12288-wide SwiGLU MLP, vocab 256 000), after
    ``hybrid_layer_check``: built layer by layer at sparsity 0.8
    (``serve.build``: the MLP and the attention in Tiled-CSL, every leaf
    its own ``max_nnz``; the RG-LRU projections, ``wa`` in f32, embed and
    ``lm_head`` dense), built against dense bf16 bytes; first-step logits
    against the plain path (``depth_logits_tol``) at 4 layers, at 4
    layers past the wrap, and at 38 layers with f32 activations and
    teacher-forced in bf16 (``_depth_drift_report``); then ``HYBRID_PROMPTS`` requests (64
    greedy new tokens) over 32 slots at max_len 4096 on the dense cache
    (the paged cache is refused for a recurrent stack) with exact-length
    admission, the decode step as a CUDA graph and eager (identical
    streams, clean slots); all four LSCD kernels must launch and every
    launch configuration pass its plain version. Last the ring on the
    paged path (``ring_paged_check``). Returns the summary and the
    served runs' launches."""
    import numpy as np
    configs, serve, budget, spmm, engine, cfgmod, ops = (mods[x] for x in (
        "configs", "serve", "budget", "spmm", "engine", "serve_config",
        "ops"))
    card = card_line()
    out = dict(card=card, layer_check=hybrid_layer_check(torch, mods))
    cfg = configs.get(HYBRID_ARCH)
    release(torch)
    torch.cuda.reset_peak_memory_stats()
    params, built = serve.build(cfg, seed=SEED, sparsity=SPARSITY,
                                device="cuda")
    by_part = dict(
        rglru_dense=sum(serve.params_bytes(layer["rglru"][n])
                        for layer in params["layers"] if "rglru" in layer
                        for n in ("w_x", "w_gate", "w_out")),
        rglru_wa_f32=sum(serve.params_bytes(layer["rglru"]["wa"])
                         for layer in params["layers"] if "rglru" in layer),
        embed_lm_head=serve.params_bytes(params["embed"])
        + serve.params_bytes(params["lm_head"]))
    dense_bf16 = budget.weight_bytes(cfg, "dense")
    out["build"] = dict(
        build_s=built["build_s"], encode_s=built["encode_s"],
        n_tiled_csl=built["n_tiled_csl"], sparse_bytes=built["sparse_bytes"],
        built_weight_bytes=built["weight_bytes"],
        dense_bf16_bytes=dense_bf16, by_part=by_part,
        build_peak_allocated=built["max_memory_allocated"])
    print(f"hybrid: {cfg.name}, {cfg.n_layers} layers at full width (d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads, {cfg.n_kv} K/V head of "
          f"{cfg.head_dim}, window {cfg.local_window}, d_ff {cfg.d_ff}, rnn "
          f"{cfg.rnn_dim}, vocab {cfg.vocab}) built in {built['build_s']:.1f}"
          f" s (prune, encode and group {built['encode_s']:.1f} s): "
          f"{built['weight_bytes']} B as built against {dense_bf16} B dense "
          f"bf16 ({built['weight_bytes'] / dense_bf16:.3f}x): "
          f"{built['sparse_bytes']} B of Tiled-CSL in {built['n_tiled_csl']} "
          f"weights, {by_part['rglru_dense']} B of bf16 w_x/w_gate/w_out, "
          f"{by_part['rglru_wa_f32']} B of f32 wa, {by_part['embed_lm_head']}"
          f" B of embed and lm_head; build peak allocated "
          f"{built['max_memory_allocated']} B", flush=True)

    out["logits"] = {}
    prompts = serve.make_prompts(cfg, 4, 128, SEED, "cuda")
    wrap = serve.make_prompts(cfg, 4, HYBRID_LAYER_S, SEED + 1, "cuda")
    for key, c, ps in (
            ("4 layers", dataclasses.replace(cfg, n_layers=4), prompts),
            ("4 layers past the wrap", dataclasses.replace(cfg, n_layers=4),
             wrap),
            (f"{cfg.n_layers} layers f32",
             dataclasses.replace(cfg, dtype="float32"), prompts)):
        tol = depth_logits_tol(c.n_layers)
        got, want, ties, n_under = _logits_vs_plain(
            torch, engine, dict(params, layers=params["layers"][:c.n_layers]),
            c, ps)
        what = f"hybrid: first decode-step logits vs plain at {key}"
        err = close(torch, got, want, dict(rtol=tol, atol=tol), what)
        share = float(((got - want).abs() / (tol + tol * want.abs())).max())
        out["logits"][key] = dict(max_abs_err=err, tol=tol, share_of_tol=share,
                                  prompt=int(ps.shape[1]), near_ties=ties,
                                  rows_under_near_tie=n_under)
        print(f"{what} ({ps.shape[1]}-token prompts, decode at position "
              f"{ps.shape[1]}): max abs err {err:.3e}, worst element at "
              f"{share:.3f} of {tol:.4f} + {tol:.4f} relative; {n_under} of "
              f"{ps.shape[0]} rows with a plain top-2 margin below "
              f"{NEAR_TIE:.2f}, first tokens differing there {ties}",
              flush=True)
        del got, want
    # The f32 stack with an f32 K/V cache: how much of the f32 gap above
    # comes from the bf16 cache; gated at the f32 run's tolerance.
    c32 = dataclasses.replace(cfg, dtype="float32")
    tol = depth_logits_tol(cfg.n_layers)
    got, want, ties, n_under = _f32_kv_cache_logits(torch, mods, params, c32,
                                                    prompts)
    check(all(m < NEAR_TIE for _, m in ties),
          f"hybrid: f32 K/V cache: first token differs between kernels and "
          f"plain versions (rows and plain top-2 margins {ties})")
    what = (f"hybrid: first decode-step logits vs plain at {cfg.n_layers} "
            f"layers f32 with an f32 K/V cache")
    err = close(torch, got, want, dict(rtol=tol, atol=tol), what)
    bf16_cache = out["logits"][f"{cfg.n_layers} layers f32"]["max_abs_err"]
    out["logits"][f"{cfg.n_layers} layers f32, f32 K/V cache"] = dict(
        max_abs_err=err, tol=tol, bf16_cache_max_abs_err=bf16_cache,
        share_of_tol=float(((got - want).abs()
                            / (tol + tol * want.abs())).max()),
        near_ties=ties, rows_under_near_tie=n_under)
    print(f"{what}: max abs err {err:.3e}, beside {bf16_cache:.3e} with the "
          f"bf16 cache ({err / bf16_cache:.3f}x; tolerance {tol:.4f} + "
          f"{tol:.4f} relative); first tokens differing at near ties {ties}",
          flush=True)
    del got, want
    out["drift"] = _depth_drift_report(torch, mods, params, cfg, prompts)
    del prompts, wrap
    release(torch)

    rng = np.random.default_rng(SEED)
    lengths = np.concatenate([rng.integers(lo, hi, n)
                              for (lo, hi), n in HYBRID_PROMPTS])
    reqs = [rng.integers(0, cfg.vocab, int(n)).astype(np.int64)
            for n in lengths]
    config = cfgmod.ServeConfig(
        scheduler=cfgmod.SchedulerConfig(
            n_slots=HYBRID_SLOTS, max_len=HYBRID_MAX_LEN, min_bucket=8,
            admit_k=HYBRID_ADMIT_K),
        cache_kind="dense")
    n_long = sum(int(n) > cfg.local_window for n in lengths)
    print(f"hybrid: {len(reqs)} requests, prompts {int(lengths.min())}-"
          f"{int(lengths.max())} tokens ({n_long} longer than the window), "
          f"{HYBRID_NEW} greedy new tokens each, "
          f"{HYBRID_SLOTS} slots, max_len {HYBRID_MAX_LEN} (ring_len "
          f"{min(HYBRID_MAX_LEN, cfg.local_window)}), exact-length "
          f"admission", flush=True)
    probe = LaunchProbe(spmm)
    runs, streams = {}, {}
    torch.cuda.reset_peak_memory_stats()
    ops.SCHEDULES.clear()
    with probe:
        spmm.reset_launch_counts()
        for key, graph in (("dense_graph", True), ("dense_eager", False)):
            label = f"hybrid: {key}"
            server, streams[key], run = _closed_loop(
                torch, mods, params, cfg, reqs, probe, paged=False,
                graph=graph, config=config, new=HYBRID_NEW, label=label)
            b = server.batcher
            check(b.buckets is None and {
                s[1] for s in b.stepper.prefill_shapes} == {
                    int(n) for n in lengths},
                f"{label}: the prefill shapes are not the prompts' lengths")
            check(b.slots == [None] * HYBRID_SLOTS,
                  f"{label}: slots not clean after the drain")
            run["captures"] = dict(b.stepper.captures)
            if graph:
                out["profile"] = _profile_decode(torch, b.stepper)
            runs[key] = run
            del server, b
            release(torch)
        counts = spmm.launch_counts()
    out["peak_allocated"] = torch.cuda.max_memory_allocated()
    check(streams["dense_graph"] == streams["dense_eager"],
          "hybrid: graph-on and graph-off streams differ")
    names = _launch_names(cfg)
    served = sorted({(names.get((key[1], key[2]), f"{key[1]} G={key[2]}"),
                      key[0], key[-1]) for key in probe.seen})
    out["served_launches"] = served
    for name, kernel, phase in served:
        print(f"hybrid: {phase:7s} {name:7s} served by {kernel}", flush=True)
    out["schedules"] = {
        f"{kind} {m}x{k} G={g} N={n}": dataclasses.asdict(sched)
        for (kind, m, k, n, g), sched in sorted(ops.SCHEDULES.items())}
    out.update(_served_summary(torch, mods, runs, counts, probe, cfg,
                               "hybrid", HYBRID_SLOTS))
    flush = torch.empty(2 ** 28, dtype=torch.int32, device="cuda")
    out["kernel_rows"] = hybrid_kernel_rows(torch, mods, params["layers"][0],
                                            cfg, flush)
    del flush
    d, e = runs["dense_graph"], runs["dense_eager"]
    print(f"hybrid: decode {d['decode_ms_per_step']:.3f} ms/step graph on, "
          f"{e['decode_ms_per_step']:.3f} graph off; "
          f"{d['tokens_per_s']:.1f}/{e['tokens_per_s']:.1f} tok/s; TTFT "
          f"p50/p99 {d['ttft']['p50'] * 1e3:.1f}/{d['ttft']['p99'] * 1e3:.1f}"
          f" ms, TPOT p50/p99 {d['tpot']['p50'] * 1e3:.2f}/"
          f"{d['tpot']['p99'] * 1e3:.2f} ms (graph on); peak allocated "
          f"{out['peak_allocated']} B; {card}", flush=True)
    _print_profile("hybrid", out["profile"], card)
    out.update(runs=runs, launches=counts)
    del params, probe
    release(torch)
    out["ring"] = ring_paged_check(torch, mods)
    return out


# ---------------------------------------------------------------------------
# SSM, vlm and audio phases: mamba2_130m, qwen2_vl_2b and musicgen_large at
# full size
# ---------------------------------------------------------------------------

SSM_ARCH = "mamba2_130m"
SSM_SLOTS, SSM_MAX_LEN, SSM_REQUESTS, SSM_NEW = 32, 4096, 32, 64
SSM_PROMPT = (128, 3001)                # uniform prompt lengths, half-open
# Below, at and past the 256-position chunk, and past seven chunks.
SSM_STATE_LENGTHS = (1, 255, 256, 257, 2047)
# The chunked prefill against the token-by-token recurrence in f32: two
# association orders of f32 sums over a state whose decay forgets within
# a few hundred steps. Elementwise within 1e-4 relative, plus 1e-4 of the
# leaf's largest magnitude for the elements near zero.
SSM_STATE_TOL = 1e-4
SSM_DEPTH = 24


def ssm_state_check(torch, mods) -> dict:
    """One mamba2-130m SSD block at full width (d_inner 1536, 24 heads of
    64, state 128, chunk 256) in f32 on the card: for each length of
    ``SSM_STATE_LENGTHS``, the chunked prefill's final state and conv
    cache against the same input (2 rows, from the seed) fed token by
    token through ``ssm_decode``."""
    ssm = mods["ssm"]
    cfg = dataclasses.replace(mods["configs"].get(SSM_ARCH), dtype="float32")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 3)
    p = ssm.init_ssm(gen, cfg, "cuda")
    rows = {}
    t0 = time.perf_counter()
    with torch.inference_mode():
        for L in SSM_STATE_LENGTHS:
            x = torch.randn((2, L, cfg.d_model), generator=gen, device="cuda")
            _, whole = ssm.ssm_block(p, x, cfg,
                                     cache=ssm.init_ssm_cache(cfg, 2, "cuda"))
            steps = ssm.init_ssm_cache(cfg, 2, "cuda")
            for t in range(L):
                _, steps = ssm.ssm_decode(p, x[:, t:t + 1], steps, cfg)
            row = {}
            for name in ("state", "conv"):
                scale = float(steps[name].abs().max())
                row[name] = close(
                    torch, whole[name], steps[name],
                    dict(rtol=SSM_STATE_TOL, atol=SSM_STATE_TOL * scale),
                    f"ssm: chunked prefill vs token by token at L={L}: "
                    f"{name}")
                row[f"{name}_scale"] = scale
            rows[L] = row
            print(f"ssm: chunked prefill vs token by token at L={L:4d} (f32):"
                  f" state max abs err {row['state']:.3e} (largest "
                  f"{row['state_scale']:.3e}), conv {row['conv']:.3e} "
                  f"(largest {row['conv_scale']:.3e})", flush=True)
    torch.cuda.synchronize()
    return dict(rows=rows, tol=SSM_STATE_TOL, s=time.perf_counter() - t0)


def _ssm_dtype_drift(torch, mods, params, cfg, prompts) -> dict:
    """The first decode step of the stack three ways, as
    ``_depth_drift`` does for the hybrid, with f32 in the place of the
    plain versions (no LSCD kernel runs on this path): the stack in f32;
    free-running in bf16 (each layer on the bf16 stack's own output, as
    served); and teacher-forced in bf16 (each layer, prefill and decode,
    in bf16 on the f32 stack's input of that layer, so only that layer's
    own rounding reaches its output). Both decode steps take the f32
    run's first tokens. Returns the three logits (f32), the first-token
    ties of the free-running prefill and how many rows have an f32 top-2
    margin below ``NEAR_TIE``."""
    transformer, layers = mods["transformer"], mods["layers"]
    B, S = prompts.shape
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    cfgs = {k: dataclasses.replace(cfg, dtype="float32" if k == "f32"
                                   else "bfloat16") for k in dts}

    def layer(i, x, mode, cache, k):
        return transformer.block_apply(
            params["layers"][i], x, cfgs[k], mode=mode,
            kind=cfg.layer_kind(i), cache=cache, pos=S)

    def head(x):
        x = transformer._norm(cfg, params["final_norm"], x[:, -1:])
        return layers.logits_head(None, params["embed"], x,
                                  vocab=cfg.vocab)[:, -1].float()

    caches = {k: transformer.init_cache(cfg, B, S + 1, device="cuda")
              for k in ("f32", "free", "forced")}
    bf16 = dts["bf16"]
    with torch.inference_mode():
        xp = layers.embed(params["embed"], prompts, dts["f32"])
        xk = layers.embed(params["embed"], prompts, bf16)
        for i in range(cfg.n_layers):
            nxt, caches["f32"][i] = layer(i, xp, "prefill", caches["f32"][i],
                                          "f32")
            xk, caches["free"][i] = layer(i, xk, "prefill",
                                          caches["free"][i], "bf16")
            _, caches["forced"][i] = layer(i, xp.to(bf16), "prefill",
                                           caches["forced"][i], "bf16")
            xp = nxt
        first = head(xp)
        ties, n_under = _first_token_ties(
            torch, torch.argmax(head(xk), dim=-1),
            torch.argmax(first, dim=-1), first)
        tok = torch.argmax(first, dim=-1)[:, None]
        yp = layers.embed(params["embed"], tok, dts["f32"])
        yk = layers.embed(params["embed"], tok, bf16)
        for i in range(cfg.n_layers):
            nxt, caches["f32"][i] = layer(i, yp, "decode", caches["f32"][i],
                                          "f32")
            yk, caches["free"][i] = layer(i, yk, "decode", caches["free"][i],
                                          "bf16")
            yt, caches["forced"][i] = layer(i, yp.to(bf16), "decode",
                                            caches["forced"][i], "bf16")
            yp = nxt
        logits = dict(f32=head(yp), free=head(yk), forced=head(yt))
    del caches
    return dict(logits=logits, ties=ties, rows_under_near_tie=n_under)


def _build_report(torch, mods, cfg, label: str, extra: str = "") -> tuple:
    """``serve.build`` at ``SPARSITY`` from ``SEED`` on the card, printed
    against the planner's dense bf16 bytes and its sparse plan."""
    serve, budget = mods["serve"], mods["budget"]
    release(torch)
    torch.cuda.reset_peak_memory_stats()
    params, built = serve.build(cfg, seed=SEED, sparsity=SPARSITY,
                                device="cuda")
    dense_bf16 = budget.weight_bytes(cfg, "dense")
    planned = budget.weight_bytes(cfg, "sparse_pallas", SPARSITY)
    rep = dict(build_s=built["build_s"], encode_s=built["encode_s"],
               n_tiled_csl=built["n_tiled_csl"],
               sparse_bytes=built["sparse_bytes"],
               built_weight_bytes=built["weight_bytes"],
               dense_bf16_bytes=dense_bf16, planned_weight_bytes=planned,
               build_peak_allocated=built["max_memory_allocated"])
    print(f"{label}: {cfg.name}, {cfg.n_layers} layers at full width{extra} "
          f"built in {built['build_s']:.1f} s (prune, encode and group "
          f"{built['encode_s']:.1f} s): {built['weight_bytes']} B as built "
          f"against {dense_bf16} B dense bf16 "
          f"({built['weight_bytes'] / dense_bf16:.3f}x) and {planned} B "
          f"planned at sparsity {SPARSITY}; {built['sparse_bytes']} B of "
          f"Tiled-CSL in {built['n_tiled_csl']} weights; build peak "
          f"allocated {built['max_memory_allocated']} B", flush=True)
    return params, rep


def _served_summary(torch, mods, runs, counts, probe, cfg, label: str,
                    n_slots: int) -> dict:
    """Launch sums by stepper call, ``select``'s pick per projection and
    every launch configuration held against its plain version."""
    spmm, ops = mods["spmm"], mods["ops"]
    launches = {}
    for run in runs.values():
        for op, c in run["launches_by_phase"].items():
            for k, n in c.items():
                launches.setdefault(op, dict.fromkeys(spmm.KERNELS, 0))[k] \
                    += n
    missing = [k for k in spmm.WEIGHT_KERNELS if counts[k] == 0]
    check(not missing, f"{label}: kernels never launched: {missing}")
    names = _launch_names(cfg)
    picks = {}
    for (kind, m, k, n, g), sched in sorted(ops.SCHEDULES.items()):
        where = f"decode N={n}" if n <= n_slots else "prefill"
        picks.setdefault(f"{names.get(((m, k), g), f'{m}x{k} G={g}')} at "
                         f"{where}", set()).add((sched.n_tb, sched.split_k))
    for key, s in sorted(picks.items()):
        print(f"{label}: select's pick for {key}: (n_tb, S) {sorted(s)}",
              flush=True)
    checked = _check_served_launches(torch, mods, probe.seen, cfg,
                                     label=label)
    print(f"{label}: launches {json.dumps(counts)} (graph replays counted); "
          f"by call {json.dumps(launches)}; {len(checked)} launch "
          f"configurations held against the plain versions", flush=True)
    return dict(launches_by_phase=launches,
                picks={k: sorted(v) for k, v in picks.items()},
                checked_launches=checked)


def _print_profile(label: str, r: dict, card: str) -> None:
    if r["busy_share"] is None:
        print(f"{label}: profile: no device activity seen; the busy share is "
              "not measured", flush=True)
        return
    print(f"{label}: profile graphed decode step: {r['wall_ms_per_step']:.3f}"
          f" ms/step wall under torch.profiler, device busy "
          f"{r['busy_ms_per_step']:.3f} ms/step "
          f"({100 * r['busy_share']:.1f}%), LSCD kernels "
          f"{r['lscd_ms_per_step']:.3f} ms/step; {card}", flush=True)
    for ms, n, name in r["top"]:
        print(f"{label}:   decode {ms:8.3f} ms/step {n:4d}/step  {name}")


def ssm_phase(torch, mods) -> dict:
    """mamba2_130m at full size (24 layers, d_model 768, d_inner 1536, 24
    SSD heads of 64, state 128, conv 4, chunk 256, vocab 50 280, tied
    head), after ``ssm_state_check``: built from ``SEED`` at sparsity 0.8
    through ``serve.build`` (the launcher's list names no SSM weight, so
    ``in_proj``/``out_proj`` stay dense bf16 and no LSCD kernel runs on
    this path), built against dense bf16 bytes; the 24-layer first-step
    logits in bf16 against the same stack in f32 (``_ssm_dtype_drift``:
    teacher-forced within ``depth_logits_tol``, free-running printed, its
    first tokens equal but at near ties); then ``SSM_REQUESTS`` requests of 128-3000
    prompt tokens (64 greedy new tokens) over 32 slots at max_len 4096
    through ``StreamingServer`` on the dense cache with exact-length
    admission, the decode step as a CUDA graph and eager (identical
    streams, clean slots), and a profiled graphed decode step."""
    import numpy as np
    configs, serve, spmm, cfgmod = (mods[x] for x in (
        "configs", "serve", "spmm", "serve_config"))
    card = card_line()
    out = dict(card=card, state_check=ssm_state_check(torch, mods))
    cfg = configs.get(SSM_ARCH)
    params, out["build"] = _build_report(
        torch, mods, cfg, "ssm",
        f" (d_model {cfg.d_model}, d_inner {cfg.ssm_inner}, {cfg.ssm_heads} "
        f"heads of {cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk "
        f"{cfg.ssm_chunk}, vocab {cfg.vocab})")
    check(out["build"]["n_tiled_csl"] == 0,
          "ssm: the launcher's list encoded an SSM weight")
    prompts = serve.make_prompts(cfg, 4, 128, SEED, "cuda")
    got = _ssm_dtype_drift(torch, mods, params, cfg, prompts)
    tol = depth_logits_tol(SSM_DEPTH)
    ties = got["ties"]
    check(all(m < NEAR_TIE for _, m in ties),
          f"ssm: {SSM_DEPTH} layers: first token differs between bf16 and "
          f"f32 (rows and f32 top-2 margins {ties}; a near tie is below "
          f"{NEAR_TIE:.3f})")
    want = got["logits"]["f32"]
    out["dtype_logits"] = dict(tol=tol, ties=ties,
                               rows_under_near_tie=got["rows_under_near_tie"])
    for key in ("forced", "free"):
        d = (got["logits"][key] - want).abs()
        over = d - (tol + tol * want.abs())
        out["dtype_logits"][key] = dict(
            max_abs_err=float(d.max()),
            share_of_tol=float((d / (tol + tol * want.abs())).max()),
            elements_over_tol=int((over > 0).sum()), elements=d.numel())
    close(torch, got["logits"]["forced"], want, dict(rtol=tol, atol=tol),
          f"ssm: first decode-step logits bf16 teacher-forced vs f32 at "
          f"{SSM_DEPTH} layers")
    r = out["dtype_logits"]
    print(f"ssm: first decode-step logits vs the f32 stack at {SSM_DEPTH} "
          f"layers (128-token prompts): bf16 teacher-forced max abs err "
          f"{r['forced']['max_abs_err']:.3e} ({r['forced']['share_of_tol']:.3f}"
          f" of {tol:.4f} + {tol:.4f} relative; gate), bf16 free-running "
          f"{r['free']['max_abs_err']:.3e} ({r['free']['share_of_tol']:.3f}; "
          f"{r['free']['elements_over_tol']} of {r['free']['elements']} "
          f"elements past the tolerance; printed); "
          f"{r['rows_under_near_tie']} of {prompts.shape[0]} rows with an f32"
          f" top-2 margin below {NEAR_TIE:.2f}, first tokens differing there "
          f"{ties}", flush=True)
    del prompts, got
    release(torch)

    rng = np.random.default_rng(SEED)
    lengths = rng.integers(*SSM_PROMPT, SSM_REQUESTS)
    reqs = [rng.integers(0, cfg.vocab, int(n)).astype(np.int64)
            for n in lengths]
    config = cfgmod.ServeConfig(
        scheduler=cfgmod.SchedulerConfig(
            n_slots=SSM_SLOTS, max_len=SSM_MAX_LEN, min_bucket=8, admit_k=1),
        cache_kind="dense")
    print(f"ssm: {len(reqs)} requests, prompts {int(lengths.min())}-"
          f"{int(lengths.max())} tokens, {SSM_NEW} greedy new tokens each, "
          f"{SSM_SLOTS} slots, max_len {SSM_MAX_LEN}, exact-length admission",
          flush=True)
    probe = LaunchProbe(spmm)
    runs, streams = {}, {}
    torch.cuda.reset_peak_memory_stats()
    with probe:
        spmm.reset_launch_counts()
        for key, graph in (("dense_graph", True), ("dense_eager", False)):
            label = f"ssm: {key}"
            server, streams[key], run = _closed_loop(
                torch, mods, params, cfg, reqs, probe, paged=False,
                graph=graph, config=config, new=SSM_NEW, label=label)
            b = server.batcher
            check(b.buckets is None and {
                s[1] for s in b.stepper.prefill_shapes} == {
                    int(n) for n in lengths},
                f"{label}: the prefill shapes are not the prompts' lengths")
            check(b.slots == [None] * SSM_SLOTS,
                  f"{label}: slots not clean after the drain")
            run["captures"] = dict(b.stepper.captures)
            if graph:
                check(b.stepper.captures["decode"] == 1,
                      f"{label}: captures {b.stepper.captures}")
                out["profile"] = _profile_decode(torch, b.stepper)
            runs[key] = run
            del server, b
            release(torch)
        counts = spmm.launch_counts()
    out["peak_allocated"] = torch.cuda.max_memory_allocated()
    check(streams["dense_graph"] == streams["dense_eager"],
          "ssm: graph-on and graph-off streams differ")
    d, e = runs["dense_graph"], runs["dense_eager"]
    print(f"ssm: launches {json.dumps(counts)} (no LSCD kernel on this "
          f"path); peak allocated {out['peak_allocated']} B", flush=True)
    print(f"ssm: decode {d['decode_ms_per_step']:.3f} ms/step graph on, "
          f"{e['decode_ms_per_step']:.3f} graph off; "
          f"{d['tokens_per_s']:.1f}/{e['tokens_per_s']:.1f} tok/s; TTFT "
          f"p50/p99 {d['ttft']['p50'] * 1e3:.1f}/{d['ttft']['p99'] * 1e3:.1f}"
          f" ms, TPOT p50/p99 {d['tpot']['p50'] * 1e3:.2f}/"
          f"{d['tpot']['p99'] * 1e3:.2f} ms (graph on); {card}", flush=True)
    _print_profile("ssm", out["profile"], card)
    out.update(runs=runs, launches=counts)
    del params, probe
    release(torch)
    return out


VLM_ARCH = "qwen2_vl_2b"
VLM_SLOTS, VLM_MAX_LEN, VLM_REQUESTS, VLM_NEW = 32, 1024, 32, 64
VLM_PROMPT = (128, 769)                 # uniform prompt lengths, half-open
VLM_DEPTHS = (4, 28)
# The stub vision prefix: a 16 x 16 patch grid at t = 0 with its rows and
# columns as h and w ids, then 64 text tokens at 16 on (all three ids).
VLM_GRID, VLM_TEXT = 16, 64


def _vlm_embeds_check(torch, mods, params, cfg) -> dict:
    """``engine.prefill`` with an ``embeds`` prefix and explicit [3, B, S]
    M-RoPE positions (a stub ``VLM_GRID``-square patch grid, then text)
    through the kernels against the plain versions: the prefill's last
    logits and the first decode step (all three ids at the scalar
    position, as the reference decodes) within ``depth_logits_tol``; and
    the same prefix at the default positions must give other logits (the
    h/w ids reach the attention)."""
    engine = mods["engine"]
    B, G = 4, VLM_GRID * VLM_GRID
    S = G + VLM_TEXT
    dev = "cuda"
    r = torch.arange(G, device=dev) // VLM_GRID
    c = torch.arange(G, device=dev) % VLM_GRID
    text = VLM_GRID + torch.arange(VLM_TEXT, device=dev)
    thw = torch.stack([torch.cat([torch.zeros_like(r), text]),
                       torch.cat([r, text]), torch.cat([c, text])])
    positions = thw[:, None].expand(3, B, S)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 4)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
    table = params["embed"]["table"]
    patches = (0.02 * torch.randn((B, G, cfg.d_model), generator=gen,
                                  device=dev)).to(table.dtype)
    embeds = torch.cat([patches, table[tokens[:, G:]]], dim=1)
    tol = depth_logits_tol(cfg.n_layers)
    res, first = {}, {}
    with torch.inference_mode():
        for backend in ("cuda", "torch"):
            last, cache = engine.prefill(params, tokens, cfg, S + 1,
                                         embeds=embeds, positions=positions,
                                         backend=backend)
            first[backend] = torch.argmax(last, dim=-1)
            res[backend] = [last.float(), cache]
        tok = first["torch"][:, None]
        for backend in ("cuda", "torch"):
            res[backend][1] = engine.serve_step(
                params, res[backend][1], tok, S, cfg,
                backend=backend)[0].float()
        flat, _ = engine.prefill(params, tokens, cfg, S + 1, embeds=embeds)
    errs = {}
    for i, what in enumerate(("prefill", "decode")):
        errs[what] = close(torch, res["cuda"][i], res["torch"][i],
                           dict(rtol=tol, atol=tol),
                           f"vlm: embeds prefix {what} logits vs plain")
    moved = float((flat.float() - res["cuda"][0]).abs().max())
    check(moved > tol, f"vlm: the vision prefix's h/w ids moved the logits "
          f"by only {moved:.3e}")
    print(f"vlm: embeds prefix ({VLM_GRID}x{VLM_GRID} patches at t = 0 with "
          f"h, w ids, then {VLM_TEXT} text tokens; {B} rows): logits vs "
          f"plain at {cfg.n_layers} layers max abs err prefill "
          f"{errs['prefill']:.3e}, decode {errs['decode']:.3e} (tolerance "
          f"{tol:.4f} + {tol:.4f} relative); the same prefix at 1-D "
          f"positions moves the logits by {moved:.3e}", flush=True)
    return dict(errs, tol=tol, moved_by_hw_ids=moved,
                same_first=int((first["cuda"] == first["torch"]).sum()))


def vlm_phase(torch, mods) -> dict:
    """qwen2_vl_2b at full size (28 layers, d_model 1536, 12 heads and 2
    K/V heads of 128, q/k/v bias, d_ff 8960, vocab 151 936, M-RoPE
    sections (16, 24, 24), theta 1e6, tied head): built from ``SEED`` at
    sparsity 0.8 (q/k/v grouped with their bias, wo and the SwiGLU MLP in
    Tiled-CSL), built against dense and planned bytes; first-step logits
    against the plain path at ``VLM_DEPTHS``; the ``embeds`` prefix
    (``_vlm_embeds_check``); then ``VLM_REQUESTS`` requests (128-768
    prompt tokens, 64 greedy new tokens) over 32 slots at max_len 1024
    through ``StreamingServer``: dense graph on, paged graph on and paged
    graph off (identical streams, clean pools). All four LSCD kernels must
    launch and every launch configuration pass its plain version."""
    import numpy as np
    configs, serve, spmm, engine, cfgmod, ops = (mods[x] for x in (
        "configs", "serve", "spmm", "engine", "serve_config", "ops"))
    card = card_line()
    cfg = configs.get(VLM_ARCH)
    out = dict(card=card)
    params, out["build"] = _build_report(
        torch, mods, cfg, "vlm",
        f" (d_model {cfg.d_model}, {cfg.n_heads} heads, {cfg.n_kv} K/V heads"
        f" of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, M-RoPE "
        f"sections {cfg.mrope_sections})")
    prompts = serve.make_prompts(cfg, 4, 128, SEED, "cuda")
    out["logits_by_depth"] = {}
    for depth in VLM_DEPTHS:
        tol = depth_logits_tol(depth)
        got, want, ties, n_under = _logits_vs_plain(
            torch, engine, dict(params, layers=params["layers"][:depth]),
            dataclasses.replace(cfg, n_layers=depth), prompts)
        err = close(torch, got, want, dict(rtol=tol, atol=tol),
                    f"vlm: first decode-step logits vs plain at {depth} "
                    f"layers")
        out["logits_by_depth"][depth] = dict(max_abs_err=err, tol=tol,
                                             near_ties=ties)
        print(f"vlm: first decode-step logits vs plain at {depth} layers: "
              f"max abs err {err:.3e} (tolerance {tol:.4f} + {tol:.4f} "
              f"relative); first tokens differing at near ties {ties}",
              flush=True)
        del got, want
    del prompts
    out["embeds"] = _vlm_embeds_check(torch, mods, params, cfg)
    release(torch)

    rng = np.random.default_rng(SEED)
    lengths = rng.integers(*VLM_PROMPT, VLM_REQUESTS)
    reqs = [rng.integers(0, cfg.vocab, int(n)).astype(np.int64)
            for n in lengths]

    def config(paged):
        return cfgmod.ServeConfig(
            scheduler=cfgmod.SchedulerConfig(
                n_slots=VLM_SLOTS, max_len=VLM_MAX_LEN, min_bucket=8,
                admit_k=4),
            cache_kind="paged" if paged else "dense", block_size=16)
    print(f"vlm: {VLM_REQUESTS} requests, prompts {int(lengths.min())}-"
          f"{int(lengths.max())} tokens, {VLM_NEW} greedy new tokens each, "
          f"{VLM_SLOTS} slots, max_len {VLM_MAX_LEN}; the paged pool at the "
          f"dense byte-equivalent", flush=True)
    probe = LaunchProbe(spmm)
    runs, streams = {}, {}
    torch.cuda.reset_peak_memory_stats()
    ops.SCHEDULES.clear()
    with probe:
        spmm.reset_launch_counts()
        for key, paged, graph in (("dense_graph", False, True),
                                  ("paged_graph", True, True),
                                  ("paged_eager", True, False)):
            label = f"vlm: {key}"
            server, streams[key], run = _closed_loop(
                torch, mods, params, cfg, reqs, probe, paged=paged,
                graph=graph, config=config(paged), new=VLM_NEW, label=label)
            b = server.batcher
            if paged:
                _drained_clean(server, label)
            run["captures"] = dict(b.stepper.captures)
            if key == "paged_graph":
                out["profile"] = _profile_decode(torch, b.stepper)
            runs[key] = run
            del server, b
            release(torch)
        counts = spmm.launch_counts()
    out["peak_allocated"] = torch.cuda.max_memory_allocated()
    check(streams["dense_graph"] == streams["paged_graph"]
          == streams["paged_eager"],
          "vlm: dense graph-on, paged graph-on and paged graph-off streams "
          "differ")
    out.update(_served_summary(torch, mods, runs, counts, probe, cfg, "vlm",
                               VLM_SLOTS))
    d, p, e = (runs[k] for k in ("dense_graph", "paged_graph", "paged_eager"))
    print(f"vlm: decode {d['decode_ms_per_step']:.3f} ms/step dense graph "
          f"on, {p['decode_ms_per_step']:.3f} paged graph on, "
          f"{e['decode_ms_per_step']:.3f} paged graph off; "
          f"{d['tokens_per_s']:.1f}/{p['tokens_per_s']:.1f}/"
          f"{e['tokens_per_s']:.1f} tok/s; TTFT p50/p99 "
          f"{p['ttft']['p50'] * 1e3:.1f}/{p['ttft']['p99'] * 1e3:.1f} ms, "
          f"TPOT p50/p99 {p['tpot']['p50'] * 1e3:.2f}/"
          f"{p['tpot']['p99'] * 1e3:.2f} ms (paged graph on); peak allocated "
          f"{out['peak_allocated']} B; {card}", flush=True)
    _print_profile("vlm", out["profile"], card)
    out.update(runs=runs, launches=counts)
    del params, probe
    release(torch)
    return out


AUDIO_ARCH = "musicgen_large"
AUDIO_DEPTHS = (4, 48)
AUDIO_REQUESTS, AUDIO_PROMPT, AUDIO_NEW = 8, 256, 64


def audio_phase(torch, mods) -> dict:
    """musicgen_large at full size (48 layers, d_model 2048, MHA of 32
    heads, LayerNorm, a GELU MLP of 8192 with biases, 4 codebooks of 2048,
    untied head of 8192 rows): built from ``SEED`` at sparsity 0.8 (wqkv,
    wo, up and down in Tiled-CSL, the [4, 2048, 2048] embedding and the
    head dense), built against dense and planned bytes; first-step logits
    against the plain path at ``AUDIO_DEPTHS`` (one row a request and
    codebook); the batcher's refusal, as the reference's; then
    ``engine.generate`` on ``AUDIO_REQUESTS`` prompts of [4, 256] for 64
    greedy frames, the reference's entry point for codebook models: all
    four LSCD kernels must launch and every launch configuration pass its
    plain version."""
    configs, serve, spmm, engine, batching, cfgmod, ops = (mods[x] for x in (
        "configs", "serve", "spmm", "engine", "batching", "serve_config",
        "ops"))
    card = card_line()
    cfg = configs.get(AUDIO_ARCH)
    out = dict(card=card)
    params, out["build"] = _build_report(
        torch, mods, cfg, "audio",
        f" (d_model {cfg.d_model}, {cfg.n_heads} heads, d_ff {cfg.d_ff}, "
        f"{cfg.n_codebooks} codebooks of {cfg.vocab})")
    prompts = serve.make_prompts(cfg, 4, 128, SEED, "cuda")
    out["logits_by_depth"] = {}
    for depth in AUDIO_DEPTHS:
        tol = depth_logits_tol(depth)
        got, want, ties, n_under = _logits_vs_plain(
            torch, engine, dict(params, layers=params["layers"][:depth]),
            dataclasses.replace(cfg, n_layers=depth), prompts)
        err = close(torch, got, want, dict(rtol=tol, atol=tol),
                    f"audio: first decode-step logits vs plain at {depth} "
                    f"layers")
        out["logits_by_depth"][depth] = dict(max_abs_err=err, tol=tol,
                                             near_ties=ties)
        print(f"audio: first decode-step logits [B, {cfg.n_codebooks}, "
              f"{cfg.vocab}] vs plain at {depth} layers: max abs err "
              f"{err:.3e} (tolerance {tol:.4f} + {tol:.4f} relative); first "
              f"tokens differing at near ties (request x codebook row, "
              f"margin) {ties}", flush=True)
        del got, want
    del prompts
    release(torch)
    refused = None
    try:
        batching.ContinuousBatcher(params, cfg, config=cfgmod.ServeConfig(
            scheduler=cfgmod.SchedulerConfig(n_slots=4, max_len=512)))
    except ValueError as e:
        refused = str(e)
    check(refused is not None and "codebook" in refused,
          f"audio: the batcher took a codebook config ({refused!r})")
    out["batcher_refusal"] = refused
    print(f"audio: the batcher refuses the config: {refused}", flush=True)

    prompts = serve.make_prompts(cfg, AUDIO_REQUESTS, AUDIO_PROMPT, SEED + 5,
                                 "cuda")
    probe = LaunchProbe(spmm)
    times = {}
    torch.cuda.reset_peak_memory_stats()
    ops.SCHEDULES.clear()
    with probe:
        probe.phase = "generate"
        spmm.reset_launch_counts()
        frames = engine.generate(params, prompts, cfg,
                                 max_new_tokens=AUDIO_NEW, timings=times)
        counts = spmm.launch_counts()
    out["peak_allocated"] = torch.cuda.max_memory_allocated()
    shape = (AUDIO_REQUESTS, cfg.n_codebooks, AUDIO_PROMPT + AUDIO_NEW)
    check(tuple(frames.shape) == shape,
          f"audio: generate gave {tuple(frames.shape)}, not {shape}")
    check(torch.equal(frames[..., :AUDIO_PROMPT], prompts),
          "audio: generate changed the prompts")
    new = frames[..., AUDIO_PROMPT:]
    check(bool(((new >= 0) & (new < cfg.vocab)).all()),
          "audio: codes outside the codebook")
    n_frames = AUDIO_REQUESTS * AUDIO_NEW
    out["generate"] = dict(
        prefill_s=times["prefill_s"], decode_s=times["decode_s"],
        decode_ms_per_step=times["decode_s"] / (AUDIO_NEW - 1) * 1e3,
        frames_per_s=n_frames / (times["prefill_s"] + times["decode_s"]),
        distinct_codes=int(new.unique().numel()))
    runs = {"generate": dict(launches_by_phase={"generate": dict(counts)})}
    out.update(_served_summary(torch, mods, runs, counts, probe, cfg,
                               "audio", AUDIO_REQUESTS))
    g = out["generate"]
    print(f"audio: engine.generate {AUDIO_REQUESTS} x [{cfg.n_codebooks}, "
          f"{AUDIO_PROMPT}] prompts, {AUDIO_NEW} greedy frames: prefill "
          f"{g['prefill_s'] * 1e3:.1f} ms, decode {g['decode_ms_per_step']:.3f}"
          f" ms/step, {g['frames_per_s']:.1f} frames/s "
          f"({g['frames_per_s'] * cfg.n_codebooks:.1f} codes/s), "
          f"{g['distinct_codes']} distinct codes; peak allocated "
          f"{out['peak_allocated']} B; {card}", flush=True)
    out.update(launches=counts)
    del params, probe, frames
    release(torch)
    return out


# ---------------------------------------------------------------------------
# train phase: masked training of tinyllama-1.1b, checkpoints, resume, and
# the trained checkpoint served through the LSCD kernels
# ---------------------------------------------------------------------------

TRAIN_ARCH = "tinyllama_1_1b"
# The train phase takes tinyllama's first 8 of its 22 layers at its
# published widths (``launch.train --layers``): at 22 the phase took
# 124.7 s, about half of it writing and reading the 13e9 B checkpoints,
# and the whole script ran past its 1200 s limit on a slow host (NVIDIA
# H100 80GB HBM3, 700 W).
TRAIN_LAYERS = 8
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 30, 8, 512
TRAIN_SAVE_AT, TRAIN_RESUME_TO = 15, 20
TRAIN_TIMED_FROM = 6                     # steps 6-30 timed
TRAIN_PROFILED = 5                       # under torch.profiler, untimed
TRAIN_LATE = 5                           # the mean of the last 5 losses
# The card-against-CPU step: 4 layers at full width, f32, TF32 off. Both
# sides round attention's K/V to bf16 as the reference does, and the
# backward rounds their cotangents to bf16 too: a last-bit difference
# moves such an element by one bf16 ulp (a flip), which moved a gradient
# leaf by 3.2e-3 of its largest value (measured on one H100). So the card
# is held to the CPU with each rounding's result taken from the CPU run,
# forward and backward (``_KVForcing``), after checking that the card's
# own roundings differ from it only by rounding noise: no element by more
# than one bf16 ulp of the tensor's largest element (a small element is
# an f32 sum that cancelled, whose last bits differ more; 2.7% of a
# cotangent's elements differed so, measured on one H100).
TRAIN_GATE_LAYERS, TRAIN_GATE_BATCH, TRAIN_GATE_SEQ = 4, 2, 128
TRAIN_GATE_LOSS_RTOL, TRAIN_GATE_GRAD_TOL = 1e-4, 1e-3
TRAIN_SNAPSHOT_AT = 8                    # server steps before the snapshot


def _train_args(mods, ckpt_dir, *extra):
    return mods["train"].parse_args(
        ["--arch", TRAIN_ARCH, "--layers", str(TRAIN_LAYERS),
         "--steps", str(TRAIN_STEPS),
         "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
         "--sparsity", str(SPARSITY), "--seed", str(SEED),
         "--ckpt-dir", ckpt_dir, *extra])


def _masked_nonzeros(torch, ft, params, masks) -> int:
    """Masked positions that hold a nonzero, over every masked leaf (one
    read back)."""
    by_path = dict(ft.flatten_with_paths(params))
    total = torch.zeros((), dtype=torch.int64,
                        device=next(iter(by_path.values())).device)
    for path, m in ft.flatten_with_paths(masks):
        total += ((by_path[path] != 0) & ~m).sum()
    return int(total)


class _KVForcing:
    """Wraps ``attention._attend`` (one call a layer here: no q-chunks).
    Recording (the CPU run) keeps each call's bf16 K and V and, by hooks,
    their bf16 cotangents. Forcing (the card run) checks the card's K/V
    and, in the backward, its cotangents against the recorded ones (no
    element off by more than one bf16 ulp of the largest) and carries on
    with the recorded values: its own gradient path, the CPU's
    rounding."""

    def __init__(self, torch, attention):
        self.attention = attention
        self.values, self.grads, self.flips = [], {}, []
        self.mode, self.i = None, 0
        owner = self

        class Force(torch.autograd.Function):
            """Forward the recorded value; backward the recorded
            cotangent, once the card's own is checked against it."""

            @staticmethod
            def forward(ctx, x, value, grad, tag):
                ctx.grad, ctx.tag = grad, tag
                return value.clone()

            @staticmethod
            def backward(ctx, g):
                owner._check(f"{ctx.tag} cotangent", g, ctx.grad)
                return ctx.grad, None, None, None
        self.force = Force

    def __call__(self, mode):
        self.mode, self.i = mode, 0
        return self

    def __enter__(self):
        self.orig = self.attention._attend
        self.attention._attend = self._attend
        return self

    def __exit__(self, *exc):
        self.attention._attend = self.orig

    def _check(self, what, got, want):
        g, w = got.float(), want.float()
        n = int((g != w).sum())
        gap = float((g - w).abs().max())
        ulp = float(w.abs().max()) * 2.0 ** -7
        check(gap <= ulp,
              f"train: 4-layer step: {what}: {n} of {w.numel()} elements "
              f"differ from the CPU's, at most by {gap:.3e} (one bf16 ulp "
              f"of the largest: {ulp:.3e})")
        self.flips.append((what, n, w.numel(), gap / ulp if ulp else 0.0))

    def _attend(self, q, k, v, valid):
        i = self.i
        self.i += 1
        if self.mode == "record":
            self.values.append((k.detach().clone(), v.detach().clone()))
            for name, t in (("k", k), ("v", v)):
                t.register_hook(lambda g, key=(i, name): self.grads.
                                __setitem__(key, g.detach().clone()))
            return self.orig(q, k, v, valid)
        forced = []
        for name, t, want in zip("kv", (k, v), self.values[i]):
            want = want.to(t.device)
            self._check(f"layer {i} {name}", t.detach(), want)
            forced.append(self.force.apply(
                t, want, self.grads[(i, name)].to(t.device),
                f"layer {i} {name}"))
        return self.orig(q, forced[0], forced[1], valid)


def _worst_leaf(ft, got, want):
    worst, worst_path = 0.0, None
    for (path, g), (_, w) in zip(ft.flatten_with_paths(got),
                                 ft.flatten_with_paths(want)):
        scale = float(w.abs().max())
        rel = float((g.cpu() - w).abs().max()) / scale if scale else 0.0
        if rel > worst:
            worst, worst_path = rel, path
    return worst, worst_path


def _train_numerics_gate(torch, mods, cfg) -> dict:
    """One f32 train step of ``cfg`` cut to 4 layers (TF32 off) on the card
    against the same step of the port on the CPU, from the same masked
    params and batch: loss within ``TRAIN_GATE_LOSS_RTOL``, each gradient
    leaf within ``TRAIN_GATE_GRAD_TOL`` of its largest absolute value,
    with the bf16 K/V roundings taken from the CPU run once the card's
    own are shown to differ only by flips (``_KVForcing``); the same
    step without that is printed."""
    transformer, train, train_loop, optimizer, data, ft = (
        mods[x] for x in ("transformer", "train", "train_loop", "optimizer",
                          "data", "ft"))
    cfg4 = dataclasses.replace(cfg, n_layers=TRAIN_GATE_LAYERS,
                               dtype="float32")
    cpu = transformer.init_model(cfg4, seed=SEED, device="cpu")
    cpu = optimizer.apply_masks(cpu, train.reference_masks(cpu, cfg4,
                                                           SPARSITY))
    card = optimizer.tree_map(lambda t: t.to("cuda"), cpu)
    batch = data.SyntheticLM(cfg.vocab, TRAIN_GATE_SEQ + 1, TRAIN_GATE_BATCH,
                             seed=SEED).next_batch()
    forcing = _KVForcing(torch, mods["attention"])
    t0 = time.perf_counter()
    with forcing("record"):
        want = train_loop.value_and_grad(
            cpu, train_loop.batch_to(batch, "cpu"), cfg4)
    cpu_s = time.perf_counter() - t0
    free = train_loop.value_and_grad(
        card, train_loop.batch_to(batch, "cuda"), cfg4)
    free_worst = _worst_leaf(ft, free[2], want[2])
    del free
    with forcing("force"):
        got = train_loop.value_and_grad(
            card, train_loop.batch_to(batch, "cuda"), cfg4)
    check(len(forcing.flips) == 4 * TRAIN_GATE_LAYERS,
          f"train: 4-layer step: {len(forcing.flips)} roundings checked")
    loss_rel = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
    check(loss_rel <= TRAIN_GATE_LOSS_RTOL,
          f"train: 4-layer f32 loss on the card {float(got[0])} vs CPU "
          f"{float(want[0])}: {loss_rel:.3e} relative")
    worst, worst_path = _worst_leaf(ft, got[2], want[2])
    check(worst <= TRAIN_GATE_GRAD_TOL,
          f"train: 4-layer f32 gradient {worst_path} on the card is "
          f"{worst:.3e} of its largest value from the CPU's")
    flipped = sum(f[1] for f in forcing.flips)
    total = sum(f[2] for f in forcing.flips)
    widest = max(f[3] for f in forcing.flips)
    print(f"train: 4-layer f32 step (TF32 off, batch {TRAIN_GATE_BATCH} x "
          f"{TRAIN_GATE_SEQ}) card vs CPU: loss {float(got[0]):.6f} vs "
          f"{float(want[0]):.6f} ({loss_rel:.2e} relative, tolerance "
          f"{TRAIN_GATE_LOSS_RTOL}), worst gradient leaf {worst_path} "
          f"{worst:.2e} of its largest value (tolerance "
          f"{TRAIN_GATE_GRAD_TOL}) with the CPU's bf16 K/V roundings; the "
          f"card's own differed in {flipped} of {total} elements, at most "
          f"by {widest:.2f} bf16 ulp of the tensor's largest element; "
          f"without the CPU's roundings the worst leaf is "
          f"{free_worst[1]} at {free_worst[0]:.2e}; CPU step {cpu_s:.1f} s",
          flush=True)
    del cpu, card, got, want
    release(torch)
    return dict(loss_rel=loss_rel, worst_grad_rel=worst,
                worst_grad_leaf=worst_path, flips=forcing.flips,
                unforced_worst_grad_rel=free_worst[0],
                unforced_worst_grad_leaf=free_worst[1], cpu_s=cpu_s)


def _host_state(torch, ft, state) -> dict:
    """Every leaf of a train state, copied to page-locked host memory, by
    path: a copy on
    the card would crowd the steps after it, and the resume check could
    not hold both states beside its own (on one H100 it ran out of the
    card's 80 GB)."""
    return {p: torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
            for p, t in ft.flatten_with_paths(state)}


def _profile_train_step(torch, step_fn, state, batch) -> tuple:
    """One train step under ``torch.profiler``, device activity only (the
    host side's ten thousand ops would take seconds to collect): (the
    new state and metrics, the device summary)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = step_fn(state, batch)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    return out, _device_summary(torch, prof, wall_s, 1)


def _resume_check(torch, mods, ck_train, straight, straight_losses):
    """(d): ``--resume`` through the launcher's ``setup`` from the step-15
    checkpoint, five steps, and each leaf of the result against the
    straight run's step-20 state (``straight``: path -> host copy).
    Returns the report."""
    train, train_loop, ft = (mods[x] for x in ("train", "train_loop", "ft"))
    t0 = time.perf_counter()
    again = train.setup(_train_args(mods, ck_train, "--resume"), "cuda")
    restore_s = time.perf_counter() - t0
    check(again["start"] == TRAIN_SAVE_AT,
          f"train: resumed at {again['start']}, not {TRAIN_SAVE_AT}")
    step_fn = train_loop.make_train_step(again["cfg"], again["opt"],
                                         masks=again["masks"])
    state, losses = again["state"], []
    for _ in range(TRAIN_SAVE_AT, TRAIN_RESUME_TO):
        batch = train_loop.batch_to(again["stream"].next_batch(), "cuda")
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
    got = ft.flatten_with_paths(state)
    differ = [p for p, t in got if not torch.equal(t, straight[p].to(t))]
    del again, state, step_fn, metrics, batch, got
    release(torch)
    return dict(restore_s=restore_s, losses=losses, leaves=len(straight),
                differ=differ, straight_losses=straight_losses)


def _train_run(torch, mods, ck_train, ck_serve):
    """(a)-(d): the f32-compute step beside the bf16 one at
    ``TRAIN_LAYERS`` layers, 30
    masked steps (gates: finite, falling loss, no masked weight nonzero
    after any step; step 5, untimed, under the profiler for where its
    time goes), the asynchronous save at step 15, the step-30
    checkpoint for serving (written while the resume runs), and
    ``--resume`` from step 15 through step 20 against the straight run,
    bit for bit under deterministic algorithms. Returns the report and
    the serving checkpoint's manager (``wait`` before reading)."""
    import warnings

    import numpy as np
    train, train_loop, optimizer, data, ft = (
        mods[x] for x in ("train", "train_loop", "optimizer", "data", "ft"))
    args = _train_args(mods, ck_train)
    torch.cuda.reset_peak_memory_stats()
    run = train.setup(args, "cuda")
    cfg, state, masks, stream, mgr = (run[k] for k in (
        "cfg", "state", "masks", "stream", "mgr"))
    counts = train.mask_counts(masks)
    kept = sum(counts.values())
    total = sum(m.numel() for _, m in ft.flatten_with_paths(masks))
    print(f"train: {cfg.name}, {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab}; f32 params and AdamW ({args.lr} peak, warmup "
          f"{args.warmup}, cosine over {args.steps}); {len(counts)} masked "
          f"weights, {kept} of {total} kept ({kept / total:.4f}) by the "
          f"reference launcher's rule; batch {args.batch} x seq {args.seq}",
          flush=True)
    first = train_loop.batch_to(data.SyntheticLM(
        cfg.vocab, args.seq, args.batch, seed=SEED).next_batch(), "cuda")
    f32 = train_loop.value_and_grad(state.params, first,
                                    dataclasses.replace(cfg, dtype="float32"))
    f32_loss = float(f32[0])
    f32_gnorm = float(optimizer.global_norm(f32[2]))
    del f32, first
    release(torch)
    step_fn = train_loop.make_train_step(cfg, run["opt"], masks=masks)
    log = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for s in range(TRAIN_STEPS):
                batch = train_loop.batch_to(stream.next_batch(), "cuda")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if s + 1 == TRAIN_PROFILED:
                    (state, metrics), prof = _profile_train_step(
                        torch, step_fn, state, batch)
                else:
                    state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])          # waits for the step
                gnorm = float(metrics["grad_norm"])
                dt = time.perf_counter() - t0
                leaks = _masked_nonzeros(torch, ft, state.params, masks)
                check(leaks == 0, f"train: {leaks} masked weights are "
                      f"nonzero after step {s + 1}")
                log.append(dict(step=s + 1, loss=loss, grad_norm=gnorm,
                                ms=dt * 1e3))
                print(f"train: step {s + 1:3d} loss {loss:.4f} gnorm "
                      f"{gnorm:.3f} {dt * 1e3:.1f} ms; masked weights all "
                      f"zero", flush=True)
                if s + 1 == TRAIN_SAVE_AT:
                    t_save = time.perf_counter()
                    mgr.save(s + 1, (state, stream.state_dict()),
                             extra=train.checkpoint_extra(args))
                    save_call_s = time.perf_counter() - t_save
                if s + 1 == TRAIN_RESUME_TO:
                    t_copy = time.perf_counter()
                    at20 = _host_state(torch, ft, state)
                    at20_s = time.perf_counter() - t_copy
            peak = torch.cuda.max_memory_allocated()
            t_wait = time.perf_counter()
            mgr.wait()
            wait_s = time.perf_counter() - t_wait
            t_final = time.perf_counter()
            serve_mgr = ft.CheckpointManager(ck_serve, async_save=True)
            serve_mgr.save(TRAIN_STEPS, (state, stream.state_dict()),
                           extra=train.checkpoint_extra(args))
            final_copy_s = time.perf_counter() - t_final
            del state, metrics, batch, step_fn, run, stream, mgr
            release(torch)
            resume = _resume_check(
                torch, mods, ck_train, at20,
                [r["loss"] for r in log[TRAIN_SAVE_AT:TRAIN_RESUME_TO]])
            del at20
        finally:
            torch.use_deterministic_algorithms(False)
        det_warnings = sorted({str(w.message).split("\n")[0]
                               for w in caught
                               if "deterministic" in str(w.message)})
    differ = resume["differ"]
    if det_warnings:
        print(f"train: ops without a deterministic kernel: {det_warnings}",
              flush=True)
    check(not differ or det_warnings,
          f"train: the resumed run's step {TRAIN_RESUME_TO} differs from "
          f"the straight run's in {len(differ)} leaves (first {differ[:3]}),"
          f" and no op reported a nondeterministic kernel")
    check(not differ or max(abs(a - b) / abs(b) for a, b in zip(
              resume["losses"], resume["straight_losses"])) < 1e-3,
          f"train: resumed losses {resume['losses']} vs "
          f"{resume['straight_losses']}")
    print(f"train: resumed from the step-{TRAIN_SAVE_AT} checkpoint "
          f"(restore {resume['restore_s']:.1f} s; the step-{TRAIN_RESUME_TO} "
          f"copy {at20_s:.1f} s) through step {TRAIN_RESUME_TO}: "
          + ("bit for bit equal to the straight run in all "
             f"{resume['leaves']} leaves (params, mu, nu, steps)"
             if not differ else
             f"{len(differ)} leaves differ, within the stated tolerance")
          + f"; losses {resume['losses']} vs {resume['straight_losses']}",
          flush=True)
    losses = [r["loss"] for r in log]
    check(all(np.isfinite(losses)), f"train: a loss is not finite: {losses}")
    late = float(np.mean(losses[-TRAIN_LATE:]))
    check(late < losses[0], f"train: the mean loss of steps "
          f"{TRAIN_STEPS - TRAIN_LATE + 1}-{TRAIN_STEPS} ({late:.4f}) is not "
          f"below step 1's ({losses[0]:.4f})")
    timed = [r["ms"] for r in log[TRAIN_TIMED_FROM - 1:]]
    ms_step = float(np.mean(timed))
    tokens = TRAIN_BATCH * (TRAIN_SEQ - 1)
    out = dict(losses=losses, grad_norms=[r["grad_norm"] for r in log],
               step_ms=[r["ms"] for r in log], ms_per_step=ms_step,
               ms_per_step_median=float(np.median(timed)),
               tokens_per_step=tokens, tokens_per_s=tokens / ms_step * 1e3,
               peak_allocated=peak, late_mean_loss=late,
               f32_compute=dict(loss=f32_loss, grad_norm=f32_gnorm),
               bf16_compute=dict(loss=losses[0],
                                 grad_norm=log[0]["grad_norm"]),
               mask_counts=counts, resume_bit_exact=not differ,
               resume_differ=len(differ), nondeterministic_ops=det_warnings,
               resume_restore_s=resume["restore_s"], at20_copy_s=at20_s,
               save_call_s=save_call_s, async_wait_s=wait_s,
               final_copy_s=final_copy_s, profile=prof)
    print(f"train: steps {TRAIN_TIMED_FROM}-{TRAIN_STEPS}: "
          f"{ms_step:.1f} ms/step (median {out['ms_per_step_median']:.1f}), "
          f"{out['tokens_per_s']:.0f} tokens/s ({tokens} tokens a step); "
          f"peak allocated {peak} B; loss {losses[0]:.4f} at step 1, mean "
          f"{late:.4f} over the last {TRAIN_LATE}; step 1 at "
          f"{cfg.n_layers} layers with bf16 compute: loss {losses[0]:.4f}, "
          f"gnorm {log[0]['grad_norm']:.3f}; with f32 compute: loss "
          f"{f32_loss:.4f}, gnorm {f32_gnorm:.3f}; step-{TRAIN_SAVE_AT} save "
          f"{save_call_s:.1f} s to copy, {wait_s:.1f} s more to finish its "
          f"write; step-{TRAIN_STEPS} save {final_copy_s:.1f} s to copy",
          flush=True)
    if prof["busy_share"] is None:
        print("train: the profiler saw no device activity; the busy share "
              "is not measured", flush=True)
    else:
        print(f"train: step {TRAIN_PROFILED} under torch.profiler: "
              f"{prof['wall_ms_per_step']:.1f} ms wall, device busy "
              f"{prof['busy_ms_per_step']:.1f} ms "
              f"({100 * prof['busy_share']:.1f}%)", flush=True)
        for ms, n, name in prof["top"]:
            print(f"train:   step {ms:8.3f} ms {n:5d} calls  {name}")
    return out, serve_mgr


def _drift_beside_table(rows, table) -> list:
    """Each drift row with the kernel table's time where the table has the
    same launch (kernel, M, K, N, group)."""
    def kernel_of(r):
        base = {"spmm": "lscd_spmm", "spmm_grouped": "lscd_spmm_grouped",
                "spmm_batched": "lscd_spmm_batched"}[r["kind"]]
        if r["schedule"]["split_k"] > 1:
            base = base.replace("lscd_spmm", "lscd_spmm_splitk")
        return base
    known = {(t["kernel"], t["m"], t["k"], t["n"], t["group"]): t["ms"]
             for t in table}
    out = []
    for r in rows:
        key = (kernel_of(r), r["m"], r["k"], r["n"],
               r["experts"] if r["kind"] == "spmm_batched" else r["group"])
        out.append(dict(r, kernel=key[0], table_ms=known.get(key)))
    return out


def _serve_trained(torch, mods, ck_serve, counts_by_path) -> dict:
    """(e)-(f): the step-30 checkpoint built at sparsity 0.8 with its
    trained masks, served graph on and off (identical streams), profiled,
    its first decode step against the plain path, a snapshot after step 8
    restored into a new server, and every launch configuration against
    its plain version."""
    convert, serve, train, spmm, api, tiled_csl, obs_profile, ft = (
        mods[x] for x in ("convert", "serve", "train", "spmm", "api",
                          "tiled_csl", "obs_profile", "ft"))
    import numpy as np
    cfg = dataclasses.replace(mods["configs"].get(TRAIN_ARCH),
                              n_layers=TRAIN_LAYERS)
    mods["ops"].SCHEDULES.clear()
    t0 = time.perf_counter()
    src, meta = convert.params_from_checkpoint(ck_serve, device="cuda")
    check(meta["step"] == TRAIN_STEPS and meta["extra"].get("sparsity")
          == SPARSITY, f"train: served checkpoint manifest {meta['extra']}")
    params, built = serve.build(
        cfg, sparsity=SPARSITY, device="cuda", source=src,
        masked=lambda path: train.masked_leaf(cfg, path, 2))
    del src
    release(torch)
    load_s = time.perf_counter() - t0
    grouped = {"wq": ("wqkv", 0), "wk": ("wqkv", 1), "wv": ("wqkv", 2),
               "gate": ("gate_up", 0), "up": ("gate_up", 1)}
    bad = []
    for path, n in counts_by_path.items():
        _, i, sub, name, _ = ft.split_path(path)
        leaf = params["layers"][i][sub]
        if name in grouped and grouped[name][0] in leaf:
            t = tiled_csl.group_slice(leaf[grouped[name][0]]["w"],
                                      grouped[name][1])
        else:
            t = leaf[name]["w"]
        if int(t.nnz.sum()) != n:
            bad.append((path, int(t.nnz.sum()), n))
    check(not bad, f"train: encoded nnz differs from the trained masks: "
          f"{bad[:4]}")
    print(f"train: step-{TRAIN_STEPS} checkpoint read and built in "
          f"{load_s:.1f} s: {built['n_tiled_csl']} Tiled-CSL weights, "
          f"{built['sparse_bytes']} B; each of the {len(counts_by_path)} "
          f"encoded weights holds exactly its trained mask's "
          f"{sum(counts_by_path.values())} nonzeros in all", flush=True)
    rng = np.random.default_rng(SEED)
    lengths = rng.integers(*SERVE_PROMPT, TINY_REQUESTS)
    reqs = [rng.integers(0, cfg.vocab, int(n)).astype(np.int64)
            for n in lengths]
    probe = LaunchProbe(spmm)
    prof = obs_profile.KernelProfiler()
    runs, events = {}, []
    with probe:
        spmm.reset_launch_counts()
        with obs_profile.profiled(prof):
            server, on, runs["graph"] = _closed_loop(
                torch, mods, params, cfg, reqs, probe, paged=True,
                graph=True, new=TINY_NEW, label="train-serve")
        del server
        release(torch)
        server, off, runs["eager"] = _closed_loop(
            torch, mods, params, cfg, reqs, probe, paged=True, graph=False,
            new=TINY_NEW, label="train-serve")
        del server
        release(torch)
        check(on == off, "train-serve: streams differ with the graph on "
              "and off")
        # (f) a snapshot after step 8, restored into a new server
        probe.phase = "snapshot"
        snap_dir = os.path.join(os.path.dirname(ck_serve), "snapshot")
        config = _serve_config(mods, paged=True)
        first = api.StreamingServer(params, cfg, config=config, graph=True)
        for i, p in enumerate(reqs):
            first.submit(api.GenerationRequest(
                p, TINY_NEW, session_id=f"r{i}", on_token=events.append))
        for _ in range(TRAIN_SNAPSHOT_AT):
            first.step()
        check(first.busy, f"train-snapshot: drained in "
              f"{TRAIN_SNAPSHOT_AT} steps")
        path = first.snapshot(snap_dir)
        n_before, live = len(events), sorted(first.live_sessions())
        del first
        release(torch)
        second = api.StreamingServer.restore(snap_dir, params, cfg,
                                             on_token=events.append,
                                             config=config, graph=True)
        check(sorted(second.live_sessions()) == live,
              "train-snapshot: the restored server's sessions differ")
        second.run_until_drained()
        del second
        release(torch)
        counts = spmm.launch_counts()
    got = {}
    for ev in events:
        got.setdefault(ev.session_id, []).append((ev.index, ev.token))
    dup = [sid for sid, pairs in got.items()
           if [i for i, _ in pairs] != list(range(len(pairs)))]
    check(not dup, f"train-snapshot: duplicated, missing or out-of-order "
          f"token events for {dup[:4]}")
    before = [ev for ev in events[:n_before]
              if ev.token != on[ev.session_id][ev.index]]
    check(not before, f"train-snapshot: {len(before)} tokens streamed "
          f"before the snapshot differ from the uninterrupted run")
    # The restored sessions re-prefill prompt + generated tokens, whose
    # bf16 K/V are not the decode steps' bit for bit: streams may part at
    # a near tie after the snapshot, by the rule of the window phase.
    cut = _near_tie_streams(
        torch, mods, params, cfg, {f"r{i}": p for i, p in enumerate(reqs)},
        {sid: [t for _, t in pairs] for sid, pairs in got.items()}, on,
        "train-snapshot")
    print(f"train-snapshot: {path} after {TRAIN_SNAPSHOT_AT} steps "
          f"({n_before} events, {len(live)} live sessions, each the "
          f"uninterrupted graphed run's), restored and drained: each "
          f"(session, index) once, {len(events)} events", flush=True)
    out = dict(build_s=built["build_s"], load_and_build_s=load_s,
               sparse_bytes=built["sparse_bytes"], runs=runs,
               snapshot_events=len(events), snapshot_before=n_before,
               snapshot_cut=cut)
    out.update(_served_summary(torch, mods, runs, counts, probe, cfg,
                               "train-serve", SERVE_SLOTS))
    tol = depth_logits_tol(cfg.n_layers)
    err = _first_step_logits(torch, mods, params, cfg, reqs, tol=tol)
    print(f"train-serve: first decode-step logits vs plain max abs err "
          f"{err:.3e} (tolerance {tol:.4f} + {tol:.4f} relative)",
          flush=True)
    rep = prof.drift_report(reps=5)
    rows = _drift_beside_table(rep["rows"], mods["kernel_rows"])
    check(rows and all(r["timing"] == "cuda_events" and r["measured_us"] > 0
                       for r in rows),
          "train-serve: a profiled launch has no CUDA-event time")
    print(f"train-serve: kernel drift ({len(rows)} unique launches, CUDA "
          f"events after an L2 flush, 5 calls each):", flush=True)
    print(obs_profile.render_drift_table(rows), flush=True)
    shared = [r for r in rows if r["table_ms"] is not None]
    for r in shared:
        print(f"train-serve: drift {r['kernel']} {r['m']}x{r['k']} N={r['n']}"
              f" measured {r['measured_us']:.1f} us beside the kernel "
              f"table's {r['table_ms'] * 1e3:.1f} us", flush=True)
    if not shared:
        print("train-serve: no profiled launch has a shape of the kernel "
              "table (its cells are OPT-30B's)", flush=True)
    out.update(launches=counts, logits_max_abs_err=err, drift=rows)
    del params, probe
    release(torch)
    return out


def train_phase(torch, mods) -> dict:
    """tinyllama_1_1b at full width, cut to ``TRAIN_LAYERS``, trained with
    0.8 masks by the reference launcher's rule (``launch/train.py``'s
    functions: f32 params, AdamW, ``SyntheticLM``, batch 8 x 512, 30
    steps), checkpointed at step
    15 (asynchronously) and 30, resumed from 15 through 20 against the
    straight run, one 4-layer f32 step held against the CPU, then the
    step-30 checkpoint served through the LSCD kernels with the profiler
    on, and a ``StreamingServer`` snapshot restored exactly once."""
    import shutil
    root = os.path.join(str(mods["build"].build_dir()), "train_phase")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    ck_train, ck_serve = (os.path.join(root, d) for d in ("train", "serve"))
    try:
        free = shutil.disk_usage(root).free
        print(f"train: checkpoints under {root} ({free} B free)", flush=True)
        trained, serve_mgr = _train_run(torch, mods, ck_train, ck_serve)
        out = dict(train=trained)
        cfg = mods["configs"].get(TRAIN_ARCH)
        out["numerics"] = _train_numerics_gate(torch, mods, cfg)
        t0 = time.perf_counter()
        serve_mgr.wait()
        trained["final_wait_s"] = time.perf_counter() - t0
        shutil.rmtree(ck_train, ignore_errors=True)
        print(f"train: the step-{TRAIN_STEPS} checkpoint's write finished "
              f"{trained['final_wait_s']:.1f} s after the resume and the "
              f"4-layer step", flush=True)
        out["serve"] = _serve_trained(torch, mods, ck_serve,
                                      trained.pop("mask_counts"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = out["serve"]["launches"]
    return out


def _device_summary(torch, prof, wall_s: float, steps: int) -> dict:
    """Per-step device busy time from a profiler window: the sum of the
    device activities' durations (one stream, so they do not overlap),
    overall, for the LSCD kernels, and for the ten largest names."""
    per_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.split("(")[0].split("<")[0][:60]
            us, n = per_name.get(name, (0.0, 0))
            per_name[name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_us = sum(us for us, _ in per_name.values())
    return dict(
        steps=steps, wall_ms_per_step=wall_s * 1e3 / steps,
        busy_ms_per_step=busy_us / steps / 1e3,
        lscd_ms_per_step=sum(us for name, (us, _) in per_name.items()
                             if "lscd" in name) / steps / 1e3,
        busy_share=busy_us / (wall_s * 1e6) if per_name else None,
        top=sorted(((us / steps / 1e3, n // steps, name)
                    for name, (us, n) in per_name.items()), reverse=True)[:10])


def profile_steps(torch, engine, params, cfg, prompts, steps: int = 4):
    """Where the time goes: ``torch.profiler`` over one warm prefill and
    over ``steps`` greedy decode steps at batch 8. The profiler adds host
    time to every op, so the busy share it gives is a lower bound for the
    unprofiled loop."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    s = prompts.shape[1]
    out = {}
    with torch.inference_mode():
        engine.prefill(params, prompts, cfg, s + steps + 1)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            last, cache = engine.prefill(params, prompts, cfg, s + steps + 1)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        out["prefill"] = _device_summary(torch, prof, wall_s, 1)
        tok = torch.argmax(last, dim=-1)[:, None]
        logits, cache = engine.serve_step(params, cache, tok, s, cfg)
        tok = torch.argmax(logits, dim=-1)[:, None]
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                logits, cache = engine.serve_step(params, cache, tok,
                                                  s + 1 + i, cfg)
                tok = torch.argmax(logits, dim=-1)[:, None]
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        out["decode"] = _device_summary(torch, prof, wall_s, steps)
    for phase, r in out.items():
        if r["busy_share"] is None:
            print(f"profile: {phase}: the profiler saw no device activity; "
                  "the busy share is not measured", flush=True)
            continue
        print(f"profile: {phase}: {r['wall_ms_per_step']:.3f} ms/step wall "
              f"under torch.profiler, device busy {r['busy_ms_per_step']:.3f}"
              f" ms/step ({100 * r['busy_share']:.1f}%), LSCD kernels "
              f"{r['lscd_ms_per_step']:.3f} ms/step", flush=True)
        for ms, n, name in r["top"]:
            print(f"profile:   {phase} {ms:8.3f} ms/step {n:4d}/step  {name}")
    return out


# ---------------------------------------------------------------------------
# mesh phase: OPT-30B tensor-parallel over four ranks that share the card,
# and tinyllama-1.1b trained on a 2x2 mesh with an elastic restore
# ---------------------------------------------------------------------------

MESH_DEVICE = "cuda"
MESH_SERVE_ARCH, MESH_SERVE_SHAPE = "opt_30b", (1, 4)
# OPT-30B is built at the 2 of its 48 layers it serves: at 48, with the
# families part beside it, the whole script ran 1195 s of its 1200 s
# limit on the card (NVIDIA H100 80GB HBM3, 700 W), and at 24, with the
# SSM, hybrid, vlm and audio families added to that part, 1135 s against
# the 1100 s it is held to (the 24-layer build and its unsharded twin
# took 19 s); at 8 the script ran past its 1200 s limit on a slow host
# once the families' training came; at 4, with the examples phase, 1038
# and 1096 s against the 1000 s it is held to.
MESH_BUILD_LAYERS = 2
# The serving comparison runs at the layers built: at 24 layers with the
# K/V sequence over model a sharded decode step took 1.5 s a rank (gloo
# between four processes that share the card), and the whole script ran
# 1313 s against its 1200 s limit (NVIDIA H100 80GB HBM3, 700 W).
MESH_DEPTHS = (2,)
MESH_REQUESTS, MESH_PROMPT, MESH_NEW = 8, 128, 32
# Every serving run of the phase (the first step, generate, the profiled
# steps) takes this cache length: it divides the model axis, so the K/V
# lies by the reference's decode layout at batch 8, the sequence over
# model (``sharding.cache_shardings``), in all three.
MESH_MAX_LEN = MESH_PROMPT + MESH_NEW
MESH_TRAIN_ARCH, MESH_TRAIN_SHAPE = "tinyllama_1_1b", (2, 2)
# The mesh phase's training (and the cells phase's ZeRO-3 step, held
# against its step 1) takes tinyllama's first 2 layers at its published
# widths (``launch.train --layers``): at all 22, the whole script ran
# about 1212 s against its 1200 s limit on a slow host (NVIDIA H100 80GB
# HBM3, 700 W), of which the 2x2 training world took 205.4 s, 110.3 s of
# it saving the 13.2e9 B state and restoring it onto 1x4 and one rank;
# at 4, 1038 and 1096 s against the 1000 s it is held to.
MESH_TRAIN_LAYERS = 2
# 4 x 512 for both sides: at 8 x 512 the unsharded step alone peaked at
# 54.43e9 B (NVIDIA H100 80GB HBM3, 700 W), and four ranks' shares of it
# beside each other would not fit the card.
MESH_TRAIN_BATCH, MESH_TRAIN_SEQ = 4, 512
MESH_TRAIN_SAVE_AT = 5
MESH_TRAIN_TOL = 5e-3           # tests/test_distributed.py:152-154
# Adam's early steps move nearly every unmasked element by about lr, so a
# param gate alone cannot fail on a skipped or sign-wrong update: its
# largest difference is about lr, and a gradient that rounds across zero
# in one run turns a sound step by 2 lr. The update gate counts the
# elements off by more than lr / 2 over those the other run moved by more
# than lr / 2: near 1 for a skipped, sign-wrong or mis-scaled update, at
# most 0.045 for a sound one in tests/test_torch_sharding.py's f32 steps.
UPDATE_MISS_TOL = 0.25
# Position-weighted checksums of a leaf modulo two primes: a leaf whose
# bits differ in one element changes at least one of them.
FP_PRIMES = (2 ** 31 - 1, 2 ** 31 - 19)
FP_CHUNK = 1 << 26


def _row_margins(logits):
    """Each row's top-2 margin of ``[B, vocab]`` logits; of ``[B, n_cb,
    vocab]`` (codebooks) the smallest of its codebooks'."""
    top = logits.float().topk(2, dim=-1).values
    m = top[..., 0] - top[..., 1]
    return m.min(dim=-1).values if m.dim() > 1 else m


class _MarginTap:
    """While entered, records the top-2 margin of every row of each
    logits tensor ``engine.generate`` samples from (one a step;
    ``_row_margins``)."""

    def __init__(self, engine):
        self.engine, self.margins = engine, []

    def __enter__(self):
        self.orig = self.engine.sample_per_slot

        def tapped(logits, *args, **kw):
            self.margins.append(_row_margins(logits).cpu())
            return self.orig(logits, *args, **kw)
        self.engine.sample_per_slot = tapped
        return self

    def __exit__(self, *exc):
        self.engine.sample_per_slot = self.orig


def _in_turn(torch, fn):
    """``fn()`` on each rank in turn, the rest waiting at a barrier: the
    ranks share one card, and four builds' transients (a layer drawn
    whole in f32, its pruning and encoding) at once ran it out of memory
    (NVIDIA H100 80GB HBM3, 700 W). Each rank frees its cache after."""
    import torch.distributed as dist
    out = None
    for turn in range(dist.get_world_size()):
        if dist.get_rank() == turn:
            out = fn()
            release(torch)
        dist.barrier()
    return out


def _check_mesh_layout(cache, mesh) -> None:
    """Under ``mesh`` the serving comparison's cache is the sequence over
    model, the layout ``MESH_MAX_LEN`` chooses."""
    if mesh is not None:
        check(getattr(cache, "seq", None) == "model", f"mesh: the cache "
              f"lies by {getattr(cache, 'seq', None)!r}, not the sequence "
              f"over model")


def _first_step(torch, engine, params, cfg, prompts, tok=None, mesh=None,
                max_len=None, layout=True, **inputs):
    """(first tokens, the first decode step's f32 logits on the host, the
    prefill's top-2 margins) at ``max_len`` (default ``MESH_MAX_LEN``):
    ``tok`` teacher-forces the first tokens; ``inputs`` (M-RoPE
    ``positions``) go to the prefill; ``layout`` checks the OPT-30B
    serving layout."""
    S = prompts.shape[-1]
    with torch.inference_mode():
        last, cache = engine.prefill(params, prompts, cfg,
                                     max_len or MESH_MAX_LEN, mesh=mesh,
                                     **inputs)
        if layout:
            _check_mesh_layout(cache, mesh)
        own = torch.argmax(last, dim=-1)
        tok = own if tok is None else tok.to(own.device)
        step, _ = engine.serve_step(params, cache, tok[..., None], S, cfg,
                                    mesh=mesh)
    return own.cpu(), step.float().cpu(), _row_margins(last).cpu()


def _mesh_serve_config(mods):
    """OPT-30B cut to ``MESH_BUILD_LAYERS``."""
    return dataclasses.replace(mods["configs"].get(MESH_SERVE_ARCH),
                               n_layers=MESH_BUILD_LAYERS)


def _mesh_serve_reference(torch, mods) -> dict:
    """The unsharded side, in this process: OPT-30B at
    ``MESH_BUILD_LAYERS`` built whole, the first step and the greedy
    streams at ``MESH_DEPTHS``."""
    serve, engine = mods["serve"], mods["engine"]
    cfg = _mesh_serve_config(mods)
    release(torch)
    params, built = serve.build(cfg, seed=SEED, sparsity=SPARSITY,
                                device=MESH_DEVICE)
    prompts = serve.make_prompts(cfg, MESH_REQUESTS, MESH_PROMPT, SEED + 9,
                                 MESH_DEVICE)
    out = dict(nnz=built["nnz"], weight_bytes=built["weight_bytes"],
               build_s=built["build_s"], prompts=prompts.cpu().numpy(),
               depths={})
    for depth in MESH_DEPTHS:
        p = dict(params, layers=params["layers"][:depth])
        c = dataclasses.replace(cfg, n_layers=depth)
        tok, step, _ = _first_step(torch, engine, p, c, prompts)
        times = {}
        with _MarginTap(engine) as tap:
            streams = engine.generate(p, prompts, c, max_new_tokens=MESH_NEW,
                                      max_len=MESH_MAX_LEN, timings=times)
        out["depths"][depth] = dict(
            tok=tok.numpy(), step=step.numpy(),
            streams=streams[:, MESH_PROMPT:].cpu().numpy(),
            margins=torch.stack(tap.margins).numpy(),
            prefill_ms=times["prefill_s"] * 1e3,
            decode_ms_per_step=times["decode_s"] / (MESH_NEW - 1) * 1e3)
    del params, prompts
    release(torch)
    return out


def _profile_mesh_decode(torch, engine, params, cfg, prompts, mesh,
                         steps: int = 4) -> dict:
    """``steps`` sharded decode steps under ``torch.profiler`` (device
    activity only): this rank's device busy time, the LSCD kernels' share
    and the largest names."""
    from torch.profiler import ProfilerActivity, profile
    S = prompts.shape[1]
    with torch.inference_mode():
        last, cache = engine.prefill(params, prompts, cfg, MESH_MAX_LEN,
                                     mesh=mesh)
        _check_mesh_layout(cache, mesh)
        tok = torch.argmax(last, dim=-1)[:, None]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                logits, cache = engine.serve_step(params, cache, tok, S + i,
                                                  cfg, mesh=mesh)
                tok = torch.argmax(logits, dim=-1)[:, None]
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
    return _device_summary(torch, prof, wall_s, steps)


def mesh_serve_rank(mesh, ref_tok: dict, prompts_np, family_refs) -> dict:
    """One rank of the serving mesh: OPT-30B built layer by layer with
    this rank's shard (``serve.build(mesh=)``), the first decode step
    teacher-forced with the unsharded run's first tokens, and
    ``engine.generate``'s greedy streams at ``MESH_DEPTHS``; its LSCD
    launches (counted from 0 over each generate), a profiled sharded
    decode step, and every launch configuration it made held against
    the plain version on the card; then, in the same world, the
    families (``mesh_family_rank``)."""
    import torch
    import torch.distributed as dist
    mods = load_mods()
    torch.backends.cuda.matmul.allow_tf32 = False
    serve, engine, spmm = mods["serve"], mods["engine"], mods["spmm"]
    rank = dist.get_rank()
    dev = mods["mesh"].rank_device(mesh)
    cfg = _mesh_serve_config(mods)
    torch.cuda.reset_peak_memory_stats()
    params, built = _in_turn(torch, lambda: serve.build(
        cfg, seed=SEED, sparsity=SPARSITY, device=dev, mesh=mesh))
    out = dict(rank=rank, nnz=built["nnz"], build_s=built["build_s"],
               weight_bytes=built["weight_bytes"],
               sparse_bytes=built["sparse_bytes"],
               build_peak_allocated=built["max_memory_allocated"],
               depths={})
    prompts = torch.from_numpy(prompts_np).to(dev)
    probe = LaunchProbe(spmm)
    for depth in MESH_DEPTHS:
        p = dict(params, layers=params["layers"][:depth])
        c = dataclasses.replace(cfg, n_layers=depth)
        tok, step, _ = _first_step(torch, engine, p, c, prompts,
                                   torch.from_numpy(ref_tok[depth]), mesh)
        times = {}
        with probe:
            probe.phase = f"generate@{depth}"
            spmm.reset_launch_counts()
            streams = engine.generate(p, prompts, c, max_new_tokens=MESH_NEW,
                                      max_len=MESH_MAX_LEN, timings=times,
                                      mesh=mesh)
            counts = spmm.launch_counts()
        out["depths"][depth] = dict(
            tok=tok.numpy(), step=step.numpy(),
            streams=streams[:, MESH_PROMPT:].cpu().numpy(), launches=counts,
            prefill_ms=times["prefill_s"] * 1e3,
            decode_ms_per_step=times["decode_s"] / (MESH_NEW - 1) * 1e3)
    out["peak_allocated"] = torch.cuda.max_memory_allocated()
    out["profile"] = _profile_mesh_decode(torch, engine, p, c, prompts,
                                          mesh)
    out["checked"] = _check_served_launches(torch, mods, probe.seen, cfg,
                                            label=f"mesh: rank {rank}")
    del params, probe
    release(torch)
    out["families"] = mesh_family_rank(mesh, family_refs, mods)
    return out


def _mesh_serving(torch, mods, card: str, family_refs) -> tuple:
    """OPT-30B on ``MESH_SERVE_SHAPE``: the unsharded run, then four
    ranks (which go on to the families), and the gates; returns (the
    summary, each rank's families results)."""
    mesh_mod = mods["mesh"]
    cfg = _mesh_serve_config(mods)
    want = _mesh_serve_reference(torch, mods)
    print(f"mesh: unsharded {cfg.name} at {cfg.n_layers} layers built in "
          f"{want['build_s']:.1f} s, {want['weight_bytes']} B, "
          f"{want['nnz']} non-zeros encoded; "
          + "; ".join(f"{d} layers: prefill {r['prefill_ms']:.1f} ms, decode "
                      f"{r['decode_ms_per_step']:.3f} ms/step"
                      for d, r in want["depths"].items()), flush=True)
    t0 = time.perf_counter()
    ranks = mesh_mod.run_world(
        mesh_serve_rank, MESH_SERVE_SHAPE, device=MESH_DEVICE,
        args=({d: r["tok"] for d, r in want["depths"].items()},
              want["prompts"], family_refs))
    world_s = time.perf_counter() - t0
    out = dict(card=card, world_s=world_s, shape=list(MESH_SERVE_SHAPE),
               unsharded=dict(nnz=want["nnz"],
                              weight_bytes=want["weight_bytes"]),
               depths={}, ranks=[])
    nnz = sum(r["nnz"] for r in ranks)
    check(nnz == want["nnz"], f"mesh: the ranks encode {nnz} non-zeros, the "
          f"unsharded build {want['nnz']}")
    import numpy as np
    for depth in MESH_DEPTHS:
        w = want["depths"][depth]
        got = [r["depths"][depth] for r in ranks]
        for g in got[1:]:
            check(np.array_equal(g["streams"], got[0]["streams"]),
                  f"mesh: ranks' streams differ at {depth} layers")
        tol = LOGITS_TOL if depth <= 4 else depth_logits_tol(depth)
        err = close(torch, torch.from_numpy(got[0]["step"]),
                    torch.from_numpy(w["step"]), dict(rtol=tol, atol=tol),
                    f"mesh: first decode-step logits at {depth} layers vs "
                    f"unsharded")
        first_ties = [(int(i), float(w["margins"][0][i]))
                      for i in np.nonzero(got[0]["tok"] != w["tok"])[0]]
        check(all(m < NEAR_TIE for _, m in first_ties),
              f"mesh: first tokens differ from unsharded at {first_ties} "
              f"(rows, unsharded margins)")
        cut = []
        for row in range(MESH_REQUESTS):
            diff = np.nonzero(got[0]["streams"][row] != w["streams"][row])[0]
            if not len(diff):
                continue
            i = int(diff[0])
            margin = float(w["margins"][i][row])
            check(margin < NEAR_TIE, f"mesh: request {row} at {depth} layers "
                  f"parts from the unsharded stream at token {i}, where its "
                  f"top-2 margin is {margin:.3e} (a near tie is below "
                  f"{NEAR_TIE:.1e})")
            cut.append((row, i, margin))
        out["depths"][depth] = dict(
            max_abs_err=err, tol=tol, first_token_ties=first_ties, cut=cut,
            prefill_ms=[g["prefill_ms"] for g in got],
            decode_ms_per_step=[g["decode_ms_per_step"] for g in got],
            unsharded_prefill_ms=w["prefill_ms"],
            unsharded_decode_ms_per_step=w["decode_ms_per_step"],
            launches=[g["launches"] for g in got])
        print(f"mesh: {depth} layers on {MESH_SERVE_SHAPE[0]}x"
              f"{MESH_SERVE_SHAPE[1]}, K/V sequence over model (max_len "
              f"{MESH_MAX_LEN}): first decode-step logits vs unsharded "
              f"max abs err {err:.3e} (tolerance {tol:.4f} + {tol:.4f} "
              f"relative); {MESH_REQUESTS - len(cut)} of {MESH_REQUESTS} "
              f"streams of {MESH_NEW} equal, {len(cut)} parted at a near tie "
              f"{json.dumps([[r, i, round(m, 5)] for r, i, m in cut])}; "
              f"rank 0 prefill {got[0]['prefill_ms']:.1f} ms, decode "
              f"{got[0]['decode_ms_per_step']:.3f} ms/step (unsharded "
              f"{w['prefill_ms']:.1f} ms, "
              f"{w['decode_ms_per_step']:.3f} ms/step); {card}", flush=True)
    for r in ranks:
        deep = r["depths"][MESH_DEPTHS[-1]]
        missing = [k for k in mods["spmm"].WEIGHT_KERNELS
                   if not deep["launches"][k]]
        check(not missing, f"mesh: rank {r['rank']} never launched {missing}")
        out["ranks"].append(dict(
            rank=r["rank"], weight_bytes=r["weight_bytes"],
            sparse_bytes=r["sparse_bytes"], nnz=r["nnz"],
            build_s=r["build_s"], peak_allocated=r["peak_allocated"],
            build_peak_allocated=r["build_peak_allocated"],
            launches={d: r["depths"][d]["launches"] for d in MESH_DEPTHS},
            profile=r["profile"], checked=len(r["checked"])))
        print(f"mesh: rank {r['rank']}: built {r['weight_bytes']} B "
              f"({r['sparse_bytes']} B Tiled-CSL, {r['nnz']} non-zeros) in "
              f"{r['build_s']:.1f} s, peak allocated {r['peak_allocated']} B;"
              f" LSCD launches at {MESH_DEPTHS[-1]} layers "
              f"{json.dumps(deep['launches'])}; {len(r['checked'])} launch "
              f"configurations held against the plain versions", flush=True)
    prof = ranks[0]["profile"]
    if prof["busy_share"] is not None:
        print(f"mesh: rank 0 profiled sharded decode step: "
              f"{prof['wall_ms_per_step']:.3f} ms/step wall, device busy "
              f"{prof['busy_ms_per_step']:.3f} ms/step "
              f"({100 * prof['busy_share']:.1f}%, four ranks share the card)"
              f", LSCD {prof['lscd_ms_per_step']:.3f} ms/step; {card}",
              flush=True)
        for ms, n, name in prof["top"]:
            print(f"mesh:   decode {ms:8.3f} ms/step {n:4d}/step  {name}")
    out["launches"] = {k: sum(r["depths"][d]["launches"][k]
                              for r in ranks for d in MESH_DEPTHS)
                       for k in mods["spmm"].KERNELS}
    out["launches_per_rank"] = {k: sum(ranks[0]["depths"][d]["launches"][k]
                                       for d in MESH_DEPTHS)
                                for k in mods["spmm"].KERNELS}
    return out, [r["families"] for r in ranks]


def _mesh_train_args(mods):
    return mods["train"].parse_args(
        ["--arch", MESH_TRAIN_ARCH, "--layers", str(MESH_TRAIN_LAYERS),
         "--steps", str(MESH_TRAIN_SAVE_AT + 1),
         "--batch", str(MESH_TRAIN_BATCH), "--seq", str(MESH_TRAIN_SEQ),
         "--sparsity", str(SPARSITY), "--seed", str(SEED)])


def _mesh_train_reference(torch, mods, path: str) -> dict:
    """The unsharded step 1, in this process; its params go to ``path``
    (host tensors by path) for the ranks to read their blocks of."""
    train, train_loop, ft = mods["train"], mods["train_loop"], mods["ft"]
    release(torch)
    torch.cuda.reset_peak_memory_stats()
    run = train.setup(_mesh_train_args(mods), MESH_DEVICE)
    step_fn = train_loop.make_train_step(run["cfg"], run["opt"],
                                         masks=run["masks"])
    batch = train_loop.batch_to(run["stream"].next_batch(), MESH_DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = step_fn(run["state"], batch)
    loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
    step_s = time.perf_counter() - t0
    torch.save({p: t.cpu() for p, t in ft.flatten_with_paths(state.params)},
               path)
    peak = torch.cuda.max_memory_allocated()
    del run, step_fn, state, metrics, batch
    release(torch)
    return dict(loss=loss, grad_norm=gnorm, step_s=step_s,
                peak_allocated=peak)


# The training world then takes one masked f32 step of each family at its
# published widths, the depth cut so that the four ranks' shares of the
# f32 params, gradients and AdamW moments (16 B a param unsharded, about
# half of that a rank on 2x2) and their activations fit the card beside
# each other: qwen3-moe's one layer holds its 128 experts (64 a model
# rank), recurrentgemma's three one period of its (rglru, rglru, attn)
# pattern, mamba2 all 24 of its layers. Every step is donated (AdamW
# in place, ``make_train_step(donate=True)``): the undonated unsharded
# recurrentgemma step, which holds the old and the new state and a
# 4.2e9 B leaf's temporaries, ran the card out of memory at 74.9 GiB
# (NVIDIA H100 80GB HBM3, 700 W). recurrentgemma also runs ZeRO-3
# (``fsdp``): its 256 000 x 4096 tied embedding leaves a rank 0.85e9
# params on 2x2 without it, and four ranks' states, gradients and
# temporaries would fill the card.
MESH_TRAIN_FAMILIES = (("qwen3_moe_30b_a3b", 1, False),
                       ("minicpm3_4b", 4, False),
                       ("recurrentgemma_9b", 3, True),
                       ("mamba2_130m", 24, False),
                       ("qwen2_vl_2b", 4, False),
                       ("musicgen_large", 4, False))
# 4 x 256 positions (SyntheticLM's seq_len counts the shifted target)
MESH_FAMILY_BATCH, MESH_FAMILY_SEQ = 4, 257
# A K bias's gradient is zero but for rounding (softmax ignores a shift
# shared by every key), so the sign of its update is rounding's: its
# update misses are not counted (its params are held like every leaf's).
K_BIAS = lambda path: path.endswith("['wk']['b']")     # noqa: E731
# qwen2-vl's distinct t/h/w ids: position i at time i, row i // 16 and
# column i % 16 of a 16-wide grid
MESH_TRAIN_GRID = 16


def _family_train_args(mods, arch: str, layers: int):
    return mods["train"].parse_args(
        ["--arch", arch, "--layers", str(layers), "--steps", "1",
         "--batch", str(MESH_FAMILY_BATCH), "--seq", str(MESH_FAMILY_SEQ),
         "--sparsity", str(SPARSITY), "--seed", str(SEED)])


def _family_setup(torch, mods, arch: str, layers: int, dev, mesh=None,
                  fsdp: bool = False) -> dict:
    """The launcher's ``setup`` of the family's run (``launch.train``:
    the whole model drawn from the seed, masked by its rule, this rank's
    shard under ``mesh``, ZeRO-3's with ``fsdp``), its config computing
    in f32: the step of f32 params in f32, as the CPU tests hold the
    families' sharded steps (the bf16 compute of the published config
    moved 0.222 of mamba2's ``dt_bias`` update against the unsharded
    step's, near ``UPDATE_MISS_TOL``)."""
    train, sharding = mods["train"], mods["sharding"]
    opt_mod, train_loop = mods["optimizer"], mods["train_loop"]
    args = _family_train_args(mods, arch, layers)
    cfg = dataclasses.replace(train.run_config(args), dtype="float32")
    opt = opt_mod.AdamW(lr=opt_mod.cosine_schedule(args.lr, args.warmup,
                                                   args.steps))
    params = mods["transformer"].init_model(cfg, seed=args.seed, device=dev)
    masks = train.reference_masks(params, cfg, args.sparsity)
    params = opt_mod.apply_masks(params, masks)
    shardings = None
    if mesh is not None:
        shardings = sharding.params_shardings(params, mesh, fsdp=fsdp)
        params = sharding.shard_params(params, mesh, fsdp=fsdp)
        masks = sharding.shard_params(masks, mesh, fsdp=fsdp)
    state = train_loop.TrainState(params, opt.init(params),
                                  torch.zeros((), dtype=torch.int32,
                                              device=dev))
    stream = mods["data"].SyntheticLM(cfg.vocab, args.seq, args.batch,
                                      seed=args.seed,
                                      n_codebooks=cfg.n_codebooks)
    return dict(cfg=cfg, opt=opt, state=state, masks=masks, stream=stream,
                shardings=shardings)


def _family_train_batch(torch, mods, run, dev, at=None) -> dict:
    """The run's first batch on ``dev`` (``at``: a data rank's (index,
    count) slice), with qwen2-vl's M-RoPE ids."""
    data, train_loop = mods["data"], mods["train_loop"]
    batch = run["stream"].next_batch()
    if at is not None:
        batch = data.batch_slice(batch, *at)
    batch = train_loop.batch_to(batch, dev)
    if run["cfg"].mrope_sections is not None:
        B, S = batch["tokens"].shape
        i = torch.arange(S, device=dev)
        batch["positions"] = torch.stack(
            [i, i // MESH_TRAIN_GRID, i % MESH_TRAIN_GRID])[:, None].expand(
                3, B, S).contiguous()
    return batch


def _param_count(ft, params) -> int:
    return sum(t.numel() for _, t in ft.flatten_with_paths(params))


def _family_train_references(torch, mods, work: str) -> dict:
    """Each family's unsharded masked f32 step 1, in this process, one
    family at a time: its metrics, time and peak on the host, its new
    params to ``work`` (host tensors by path) for the ranks to read their
    blocks of; every tensor freed before the next."""
    train_loop, ft = mods["train_loop"], mods["ft"]
    out = {}
    for arch, layers, _ in MESH_TRAIN_FAMILIES:
        release(torch)
        torch.cuda.reset_peak_memory_stats()
        run = _family_setup(torch, mods, arch, layers, MESH_DEVICE)
        step_fn = train_loop.make_train_step(run["cfg"], run["opt"],
                                             masks=run["masks"], donate=True)
        batch = _family_train_batch(torch, mods, run, MESH_DEVICE)
        n = _param_count(ft, run["state"].params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(run["state"], batch)
        m = {k: float(v) for k, v in metrics.items()}
        step_s = time.perf_counter() - t0
        torch.save({p: t.cpu() for p, t in
                    ft.flatten_with_paths(state.params)},
                   os.path.join(work, f"family_{arch}.pt"))
        out[arch] = dict(layers=layers, params=n, state_bytes=16 * n,
                         step_s=step_s,
                         peak_allocated=torch.cuda.max_memory_allocated(),
                         **m)
        del run, step_fn, state, metrics, batch
        release(torch)
    return out


def _train_families_rank(torch, mods, mesh, work: str) -> dict:
    """This rank of the 2x2 training world: each family's step 1
    (``_family_setup`` under the mesh, the ranks drawing the whole model
    in turn) against the unsharded step's blocks, one family at a time,
    each freed before the next."""
    import torch.distributed as dist
    train_loop, ft = mods["train_loop"], mods["ft"]
    sharding, mesh_mod = mods["sharding"], mods["mesh"]
    tp = mods["tensor_parallel"]
    dev = mesh_mod.rank_device(mesh)
    at = (mesh.get_local_rank("data"), mesh.size(0))
    out = {}
    for arch, layers, fsdp in MESH_TRAIN_FAMILIES:
        release(torch)
        torch.cuda.reset_peak_memory_stats()
        run = _in_turn(torch, lambda: _family_setup(
            torch, mods, arch, layers, dev, mesh, fsdp))
        cfg, masks, shardings = run["cfg"], run["masks"], run["shardings"]
        state = run.pop("state")
        step_fn = train_loop.make_train_step(cfg, run["opt"], masks=masks,
                                             mesh=mesh, shardings=shardings,
                                             fsdp=fsdp, donate=True)
        batch = _family_train_batch(torch, mods, run, dev, at)
        before = _host_params(ft, state.params)
        n = _param_count(ft, state.params)
        tp.raw_under_grad = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        m = {k: float(v) for k, v in metrics.items()}
        step_s = time.perf_counter() - t0
        raw = tp.raw_under_grad
        want = torch.load(os.path.join(work, f"family_{arch}.pt"),
                          mmap=True)
        gap = _update_gap(torch, ft, state.params,
                          lambda path: sharding.shard_leaf(
                              want[path], shardings[path], mesh),
                          before, float(run["opt"].lr(1)), noise=K_BIAS)
        out[arch] = dict(params=n, state_bytes=16 * n, step_s=step_s,
                         raw_under_grad=raw,
                         peak_allocated=torch.cuda.max_memory_allocated(),
                         masked_nonzero=(0 if masks is None else
                                         _masked_nonzeros(torch, ft,
                                                          state.params,
                                                          masks)),
                         masked=bool(masks is not None and
                                     ft.flatten_with_paths(masks)),
                         **m, **gap)
        del run, state, metrics, batch, before, want, step_fn, masks
        release(torch)
        dist.barrier()
    return out


def _train_families_gates(out: dict, refs: dict, ranks: list,
                          card: str) -> None:
    """Each family's step on 2x2 against its unsharded step: loss and
    grad norm within ``MESH_TRAIN_TOL`` relative, every param within it,
    the update's misses within ``UPDATE_MISS_TOL``, masked weights zero,
    every rank's metrics alike, no raw collective reached while
    gradients were on; each rank's peak and ms/step printed."""
    rel = lambda a, b: abs(a - b) / abs(b)
    rows = {}
    for arch, layers, fsdp in MESH_TRAIN_FAMILIES:
        ref = refs[arch]
        got = [r["families"][arch] for r in ranks]
        g0 = got[0]
        label = (f"mesh: train {arch} ({layers} layers"
                 f"{', ZeRO-3' if fsdp else ''})")
        for name in ("loss", "grad_norm"):
            check(rel(g0[name], ref[name]) <= MESH_TRAIN_TOL,
                  f"{label}: {name} {g0[name]} on 2x2 vs {ref[name]} "
                  f"unsharded: {rel(g0[name], ref[name]):.3e} relative")
        for r, g in zip(ranks, got):
            check(g["loss"] == g0["loss"] and g["grad_norm"] == g0["grad_norm"],
                  f"{label}: rank {r['rank']}'s metrics differ from rank 0's")
            check(g["param_err"] <= MESH_TRAIN_TOL,
                  f"{label}: rank {r['rank']}: param {g['param_err_leaf']} "
                  f"off the unsharded step's by {g['param_err']:.3e}")
            check(g["update_miss"] <= UPDATE_MISS_TOL,
                  f"{label}: rank {r['rank']}: update of "
                  f"{g['update_miss_leaf']} misses on {g['update_miss']:.3e}")
            check(not g["masked_nonzero"],
                  f"{label}: rank {r['rank']}: {g['masked_nonzero']} masked "
                  f"weights nonzero")
            check(g["raw_under_grad"] == 0,
                  f"{label}: rank {r['rank']}: {g['raw_under_grad']} raw "
                  f"collectives with gradients on")
        rows[arch] = dict(
            layers=layers, fsdp=fsdp, params=ref["params"],
            state_bytes=ref["state_bytes"],
            rank_params=[g["params"] for g in got],
            rank_state_bytes=[g["state_bytes"] for g in got],
            loss=g0["loss"], loss_rel=rel(g0["loss"], ref["loss"]),
            ce=g0["ce"], aux=g0["aux"],
            grad_norm_rel=rel(g0["grad_norm"], ref["grad_norm"]),
            param_err=max(g["param_err"] for g in got),
            update_miss=max(g["update_miss"] for g in got),
            update_miss_leaf=max(got, key=lambda g: g["update_miss"])[
                "update_miss_leaf"],
            masked=g0["masked"],
            step_ms=[g["step_s"] * 1e3 for g in got],
            peak_allocated=[g["peak_allocated"] for g in got],
            unsharded_step_ms=ref["step_s"] * 1e3,
            unsharded_peak=ref["peak_allocated"])
        row = rows[arch]
        print(f"{label}, global batch "
              f"{MESH_FAMILY_BATCH} x {MESH_FAMILY_SEQ - 1}, "
              f"{'0.8 masks' if row['masked'] else 'no leaf masked'}, "
              f"donated steps, on 2x2: {row['params']} params unsharded ({row['state_bytes']} "
              f"B of f32 params, gradients and moments; "
              f"{row['unsharded_step_ms']:.1f} ms, peak "
              f"{row['unsharded_peak']} B), a rank "
              f"{row['rank_params']} params ({row['rank_state_bytes']} B); "
              f"loss {row['loss']:.6f} ({row['loss_rel']:.2e} relative), "
              f"aux {row['aux']:.6f}, grad norm ({row['grad_norm_rel']:.2e}"
              f"), params within {row['param_err']:.2e}, update misses "
              f"{row['update_miss']:.3e} ({row['update_miss_leaf']}); "
              f"ms/step a rank "
              f"{json.dumps([round(x, 1) for x in row['step_ms']])}, peak "
              f"allocated a rank {row['peak_allocated']} B; {card}",
              flush=True)
    out["families"] = rows


def _fingerprints(torch, mods, tree, shardings, mesh) -> "torch.Tensor":
    """[leaves, 2] int64: each tensor leaf's checksums (``FP_PRIMES``) of
    its bits weighted by their positions in the whole leaf, summed over
    the ``model`` ranks (modulo each prime); a rank's block of a leaf
    split over ``model`` sits at its offset."""
    ft, sharding, tp = mods["ft"], mods["sharding"], mods["tensor_parallel"]
    rows = []
    model = tp.of(mesh)
    for path, t in ft.flatten_with_paths(tree):
        if not isinstance(t, torch.Tensor):
            continue
        dev = t.device
        ppath = ft.params_path(path)
        spec = (shardings[ppath] if mesh is not None and ppath is not None
                else (None,) * t.dim())
        dims = [i for i, e in enumerate(spec) if e is not None]
        shape = list(t.shape)
        d = dims[0] if dims else 0
        parts = model.size if dims and model is not None else 1
        off = model.rank * shape[d] if parts > 1 else 0
        if model is not None and parts == 1 and model.rank:
            # a replicated leaf counts once: model rank 0's
            rows.append(torch.zeros(len(FP_PRIMES), dtype=torch.int64,
                                    device=dev))
            continue
        inner = 1
        for n in shape[d + 1:]:
            inner *= n
        flat = t.detach().reshape(-1)
        bits = (flat.view(torch.int32) if flat.element_size() == 4
                else flat.to(torch.int32)).to(torch.int64) & 0xFFFFFFFF
        acc = [torch.zeros((), dtype=torch.int64, device=dev)
               for _ in FP_PRIMES]
        for lo in range(0, flat.numel(), FP_CHUNK):
            i = torch.arange(lo, min(lo + FP_CHUNK, flat.numel()),
                             device=dev, dtype=torch.int64)
            if shape:
                outer, di = i // (shape[d] * inner), (i // inner) % shape[d]
                g = (outer * (shape[d] * parts) + off + di) * inner \
                    + i % inner
            else:
                g = i
            b = bits[lo:lo + FP_CHUNK]
            for k, prime in enumerate(FP_PRIMES):
                w = (g * 48271 + 1) % prime
                acc[k] = (acc[k] + ((b % prime) * w % prime).sum()) % prime
        rows.append(torch.stack(acc))
    fp = torch.stack(rows)
    if model is not None:
        fp = tp.all_reduce(fp, model.group)
        fp = torch.stack([fp[:, k] % prime
                          for k, prime in enumerate(FP_PRIMES)], dim=1)
    return fp.cpu()


def _template(torch, mods, state, shardings, mesh_from, mesh_to):
    """A train state's structure with leaves on the meta device (no
    memory) of the shapes a rank of ``mesh_to`` holds (the whole ones
    without a mesh), from this rank's ``state`` on ``mesh_from``."""
    ft, sharding = mods["ft"], mods["sharding"]

    def leaf(path, t):
        ppath = ft.params_path(path)
        spec = shardings.get(ppath) if ppath is not None else None
        shape = list(t.shape)
        for i, e in enumerate(spec or ()):
            if e is not None:
                shape[i] *= sharding.axis_sizes(mesh_from)[e]
        if mesh_to is not None:
            for i, e in enumerate(sharding.spec_for(ppath, shape, mesh_to)
                                  if ppath is not None else ()):
                if e is not None:
                    shape[i] //= sharding.axis_sizes(mesh_to)[e]
        return torch.empty(shape, dtype=t.dtype, device="meta")

    def rebuild(x, path=""):
        if isinstance(x, dict):
            return {k: rebuild(v, f"{path}['{k}']") for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(rebuild(getattr(x, f), f"{path}.{f}")
                             for f in x._fields))
        if isinstance(x, (list, tuple)):
            return type(x)(rebuild(v, f"{path}[{i}]")
                           for i, v in enumerate(x))
        return leaf(path, x) if isinstance(x, torch.Tensor) else x
    return rebuild(state)


def _mesh_compression(torch, mods, params, batch, cfg, mesh) -> dict:
    """Each step-1 gradient leaf (this rank's, before the data mean)
    summed over ``data`` by ``compressed_all_reduce`` against the exact
    f32 sum: within world x max|g| / 127, the reference's bound."""
    train_loop, ft = mods["train_loop"], mods["ft"]
    compression, tp = mods["compression"], mods["tensor_parallel"]
    import torch.distributed as dist
    grads = train_loop.value_and_grad(params, batch, cfg, mesh=mesh)[2]
    data = tp.axis(mesh, "data")
    worst, worst_path, n = 0.0, None, 0
    for path, g in ft.flatten_with_paths(grads):
        exact = tp.all_reduce(g.float(), data.group)
        got = compression.compressed_all_reduce(g, data.group)
        gmax = tp.all_reduce(g.abs().max().float().reshape(1), data.group,
                             op=dist.ReduceOp.MAX)
        bound = data.size * float(gmax) / 127.0
        share = float((got - exact).abs().max()) / bound if bound else 0.0
        if share > worst:
            worst, worst_path = share, path
        n += 1
    del grads
    return dict(leaves=n, worst_share_of_bound=worst, worst_leaf=worst_path)


def _host_params(ft, params) -> dict:
    """A host copy of every leaf (a donated step writes over the
    params)."""
    return {path: t.detach().to("cpu", copy=True)
            for path, t in ft.flatten_with_paths(params)}


def _update_gap(torch, ft, params, want_of, before: dict, lr: float,
                noise=lambda path: False) -> dict:
    """This rank's params after a step against ``want_of(path)``, the
    other run's block of the same leaf, both stepped from ``before``
    (host tensors): the largest difference, and the update's misses (see
    ``UPDATE_MISS_TOL``) in the worst leaf but those ``noise`` names,
    whose gradient is rounding's."""
    gap = dict(lr=lr, param_err=0.0, param_err_leaf=None, update_miss=0.0,
               update_miss_leaf=None, moved=0)
    for path, t in ft.flatten_with_paths(params):
        t = t.detach().float()
        w = want_of(path).to(t.device, torch.float32)
        d = (t - w).abs()
        moved = int(((w - before[path].to(t.device, torch.float32)).abs()
                     > lr / 2).sum())
        miss = 0.0 if noise(path) else int((d > lr / 2).sum()) / max(moved,
                                                                     1)
        gap["moved"] += moved
        err = float(d.max())
        if err > gap["param_err"]:
            gap.update(param_err=err, param_err_leaf=path)
        if miss > gap["update_miss"]:
            gap.update(update_miss=miss, update_miss_leaf=path)
        del w, d
    return gap


def mesh_train_rank(mesh, ref: dict, work: str) -> dict:
    """One rank of the training mesh (2x2): the whole model drawn, masked
    and sharded by the launcher's ``setup``; the compressed all-reduce of
    the step-1 gradients; step 1 against the unsharded step (``work``'s
    ``step1_params.pt``); steps 2-5 with the masks checked; the step-5
    save; the live state's checksums against its restores onto 1x4 (a
    mesh over the same ranks) and onto one rank; step 6 on 2x2 and on the
    1x4 restore, element by element."""
    import torch
    import torch.distributed as dist
    mods = load_mods()
    torch.backends.cuda.matmul.allow_tf32 = False
    train, train_loop, ft = mods["train"], mods["train_loop"], mods["ft"]
    data, sharding, mesh_mod = mods["data"], mods["sharding"], mods["mesh"]
    transformer = mods["transformer"]
    rank = dist.get_rank()
    dev = mesh_mod.rank_device(mesh)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = _in_turn(torch, lambda: train.setup(_mesh_train_args(mods), dev,
                                              mesh))
    setup_s = time.perf_counter() - t0
    state = run.pop("state")        # the loop's own: the first state goes
    cfg, masks, stream = (run[k] for k in ("cfg", "masks", "stream"))
    shardings = run["shardings"]
    opt = run["opt"]
    lr_at = lambda s: float(opt.lr(s))     # the launcher's schedule
    ckpt_dir = os.path.join(work, "ckpt")
    step_fn = train_loop.make_train_step(cfg, opt, masks=masks, mesh=mesh,
                                         shardings=shardings)
    at = (mesh.get_local_rank("data"), mesh.size(0))
    out = dict(rank=rank, setup_s=setup_s, steps=[])
    batch = train_loop.batch_to(data.batch_slice(stream.next_batch(), *at),
                                dev)
    out["compression"] = _mesh_compression(torch, mods, state.params, batch,
                                           cfg, mesh)
    before = _host_params(ft, state.params)
    for s in range(1, MESH_TRAIN_SAVE_AT + 1):
        if s > 1:
            batch = train_loop.batch_to(
                data.batch_slice(stream.next_batch(), *at), dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        out["steps"].append(dict(loss=loss, grad_norm=gnorm,
                                 s=time.perf_counter() - t0,
                                 masked_nonzero=_masked_nonzeros(
                                     torch, ft, state.params, masks)))
        if s == 1:           # this rank's blocks of the unsharded step
            want = torch.load(os.path.join(work, "step1_params.pt"),
                              mmap=True)
            out["step1"] = _update_gap(
                torch, ft, state.params,
                lambda path: sharding.shard_leaf(want[path], shardings[path],
                                                 mesh), before, lr_at(1))
            del want, before
    out["peak_allocated"] = torch.cuda.max_memory_allocated()
    mgr = ft.CheckpointManager(ckpt_dir, keep=1)
    t0 = time.perf_counter()
    mgr.save(MESH_TRAIN_SAVE_AT, (state, stream.state_dict()), mesh=mesh,
             shardings=shardings, block=True)
    out["save_s"] = time.perf_counter() - t0
    live = _fingerprints(torch, mods, state, shardings, mesh)
    batch6 = stream.next_batch()
    state6, m6 = step_fn(state, train_loop.batch_to(
        data.batch_slice(batch6, *at), dev))
    out["step6"] = dict(loss=float(m6["loss"]),
                        grad_norm=float(m6["grad_norm"]))
    if at[0] == 0:          # data row 0's model ranks: the step-6 params
        torch.save(_host_params(ft, state6.params), os.path.join(
            work, f"step6_model{mesh.get_local_rank('model')}.pt"))
    del state6, m6
    dist.barrier()
    # the 1x4 restore, a mesh over the same four ranks, and the one-rank
    # restore, onto templates of this state's shapes; then it goes
    mesh4 = mesh_mod.make_host_mesh(4, 4, device_type=dev.type)
    data_state = stream.state_dict()
    template4 = _template(torch, mods, (state, data_state), shardings,
                          mesh, mesh4)
    template1 = _template(torch, mods, (state, data_state), shardings,
                          mesh, None)
    del state, masks, step_fn, run
    release(torch)
    t0 = time.perf_counter()
    (state4, _), meta = mgr.restore(template4, device=dev, mesh=mesh4)
    out["restore_1x4_s"] = time.perf_counter() - t0

    def masks_on_1x4():             # by the launcher's rule, whole, then cut
        whole = transformer.init_model(cfg, seed=SEED, device=dev)
        masks = train.reference_masks(whole, cfg, SPARSITY)
        return (sharding.params_shardings(whole, mesh4),
                sharding.shard_params(masks, mesh4))
    shardings4, masks4 = _in_turn(torch, masks_on_1x4)
    out["restored_1x4"] = _fingerprints(torch, mods, state4, shardings4,
                                        mesh4)
    out["live"] = live
    out["restored_step"] = meta["step"]
    step4 = train_loop.make_train_step(cfg, opt, masks=masks4, mesh=mesh4,
                                       shardings=shardings4)
    before = _host_params(ft, state4.params)
    state4, m4 = step4(state4, train_loop.batch_to(batch6, dev))
    halves = [torch.load(os.path.join(work, f"step6_model{k}.pt"), mmap=True)
              for k in range(MESH_TRAIN_SHAPE[1])]

    def on_2x2(path):           # the whole 2x2 step-6 leaf, cut for 1x4
        dims = [i for i, e in enumerate(shardings[path]) if e is not None]
        whole = (torch.cat([h[path] for h in halves], dim=dims[0]) if dims
                 else halves[0][path])
        return sharding.shard_leaf(whole, shardings4[path], mesh4)
    out["step6_1x4"] = dict(loss=float(m4["loss"]),
                            grad_norm=float(m4["grad_norm"]),
                            masked_nonzero=_masked_nonzeros(
                                torch, ft, state4.params, masks4),
                            **_update_gap(torch, ft, state4.params, on_2x2,
                                          before, lr_at(MESH_TRAIN_SAVE_AT
                                                        + 1)))
    del state4, m4, masks4, step4, halves, before
    release(torch)
    dist.barrier()
    if rank == 0:           # onto one process: the whole state
        t0 = time.perf_counter()
        (state1, _), _ = mgr.restore(template1, device=dev)
        out["restore_one_s"] = time.perf_counter() - t0
        out["restored_one"] = _fingerprints(torch, mods, state1, None, None)
        del state1
        release(torch)
    dist.barrier()
    t0 = time.perf_counter()
    out["families"] = _train_families_rank(torch, mods, mesh, work)
    out["families_s"] = time.perf_counter() - t0
    return out


def _mesh_training(torch, mods, card: str) -> dict:
    """tinyllama-1.1b on ``MESH_TRAIN_SHAPE``: the unsharded step 1, then
    four ranks, and the gates."""
    mesh_mod = mods["mesh"]
    work = os.path.join(str(mods["build"].build_dir()), "mesh_phase")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    done = False
    try:
        t0 = time.perf_counter()
        family_refs = _family_train_references(torch, mods, work)
        family_refs_s = time.perf_counter() - t0
        ref = _mesh_train_reference(torch, mods, os.path.join(
            work, "step1_params.pt"))
        print(f"mesh: unsharded {MESH_TRAIN_ARCH} step 1 ("
              f"{MESH_TRAIN_LAYERS} layers, batch {MESH_TRAIN_BATCH} x "
              f"{MESH_TRAIN_SEQ}, 0.8 masks): loss "
              f"{ref['loss']:.6f}, grad norm {ref['grad_norm']:.6f}, "
              f"{ref['step_s'] * 1e3:.1f} ms, peak allocated "
              f"{ref['peak_allocated']} B; {card}", flush=True)
        t0 = time.perf_counter()
        ranks = mesh_mod.run_world(mesh_train_rank, MESH_TRAIN_SHAPE,
                                   device=MESH_DEVICE,
                                   args=(ref, work))
        world_s = time.perf_counter() - t0
        done = True
    finally:
        if done:        # the unsharded step 1 stays for the cells phase
            for name in os.listdir(work):
                path = os.path.join(work, name)
                if name == "step1_params.pt":
                    continue
                if os.path.isdir(path):
                    shutil.rmtree(path, ignore_errors=True)
                else:
                    os.remove(path)
            mods["mesh_train_work"], mods["mesh_train_ref"] = work, ref
        else:
            shutil.rmtree(work, ignore_errors=True)
    r0 = ranks[0]
    s1 = r0["steps"][0]
    rel = lambda a, b: abs(a - b) / abs(b)
    for name, a, b in (("loss", s1["loss"], ref["loss"]),
                       ("grad norm", s1["grad_norm"], ref["grad_norm"])):
        check(rel(a, b) <= MESH_TRAIN_TOL, f"mesh: step-1 {name} {a} on "
              f"2x2 vs {b} unsharded: {rel(a, b):.3e} relative")
    for r in ranks:
        for name, g, vs in (("step 1", r["step1"], "unsharded"),
                            ("step 6 on 1x4", r["step6_1x4"], "2x2")):
            check(g["param_err"] <= MESH_TRAIN_TOL,
                  f"mesh: rank {r['rank']}: {name} param "
                  f"{g['param_err_leaf']} off the {vs} step's by "
                  f"{g['param_err']:.3e}")
            check(g["update_miss"] <= UPDATE_MISS_TOL,
                  f"mesh: rank {r['rank']}: {name} update of "
                  f"{g['update_miss_leaf']} misses the {vs} step's on "
                  f"{g['update_miss']:.3e} of the elements it moved by "
                  f"more than lr / 2 = {g['lr'] / 2:.3e}")
        bad = [i + 1 for i, s in enumerate(r["steps"]) if s["masked_nonzero"]]
        check(not bad and not r["step6_1x4"]["masked_nonzero"],
              f"mesh: rank {r['rank']}: masked weights nonzero after steps "
              f"{bad}")
        check(r["compression"]["worst_share_of_bound"] <= 1.0,
              f"mesh: rank {r['rank']}: compressed all-reduce of "
              f"{r['compression']['worst_leaf']} at "
              f"{r['compression']['worst_share_of_bound']:.3f} of its bound")
        check(r["restored_step"] == MESH_TRAIN_SAVE_AT,
              f"mesh: restored step {r['restored_step']}")
        check(bool((r["restored_1x4"] == r0["live"]).all())
              and bool((r["live"] == r0["live"]).all()),
              f"mesh: rank {r['rank']}: the 1x4 restore's checksums differ "
              f"from the saved 2x2 state's")
    check(bool((r0["restored_one"] == r0["live"]).all()),
          "mesh: the one-rank restore's checksums differ from the saved "
          "2x2 state's")
    a, b = r0["step6_1x4"], r0["step6"]
    for name, x, y in (("loss", a["loss"], b["loss"]),
                       ("grad norm", a["grad_norm"], b["grad_norm"])):
        check(rel(x, y) <= MESH_TRAIN_TOL, f"mesh: step 6 on the 1x4 restore "
              f"vs 2x2: {name} {rel(x, y):.3e} relative")
    step_s = [s["s"] for s in r0["steps"]]
    out = dict(card=card, world_s=world_s, shape=list(MESH_TRAIN_SHAPE),
               batch=[MESH_TRAIN_BATCH, MESH_TRAIN_SEQ], reference=ref,
               step1_loss_rel=rel(s1["loss"], ref["loss"]),
               step1_grad_norm_rel=rel(s1["grad_norm"], ref["grad_norm"]),
               step1_param_err=max(r["step1"]["param_err"] for r in ranks),
               step1_update_miss=max(r["step1"]["update_miss"]
                                     for r in ranks),
               losses=[s["loss"] for s in r0["steps"]], step_s=step_s,
               save_s=r0["save_s"], restore_1x4_s=r0["restore_1x4_s"],
               restore_one_s=r0["restore_one_s"],
               compression=[r["compression"] for r in ranks],
               step6_loss_rel=rel(a["loss"], b["loss"]),
               step6_grad_norm_rel=rel(a["grad_norm"], b["grad_norm"]),
               step6_param_err=max(r["step6_1x4"]["param_err"]
                                   for r in ranks),
               step6_update_miss=max(r["step6_1x4"]["update_miss"]
                                     for r in ranks),
               leaves_checked=int(r0["live"].shape[0]),
               peak_allocated=[r["peak_allocated"] for r in ranks],
               setup_s=[r["setup_s"] for r in ranks])
    _train_families_gates(out, family_refs, ranks, card)
    out["families_s"] = dict(unsharded=family_refs_s,
                             world=r0["families_s"])
    print(f"mesh: the families' training: unsharded steps "
          f"{family_refs_s:.1f} s in this process, {r0['families_s']:.1f} s "
          f"of the world's {world_s:.1f} s; {card}", flush=True)
    print(f"mesh: {MESH_TRAIN_ARCH} at {MESH_TRAIN_LAYERS} layers on "
          f"{MESH_TRAIN_SHAPE[0]}x{MESH_TRAIN_SHAPE[1]} (global batch "
          f"{MESH_TRAIN_BATCH} x "
          f"{MESH_TRAIN_SEQ}): step 1 loss {s1['loss']:.6f} "
          f"({out['step1_loss_rel']:.2e} relative to unsharded), grad norm "
          f"({out['step1_grad_norm_rel']:.2e}), params within "
          f"{out['step1_param_err']:.2e} (tolerance {MESH_TRAIN_TOL}), "
          f"update misses {out['step1_update_miss']:.3e} of the moved "
          f"elements (tolerance {UPDATE_MISS_TOL}); "
          f"losses {json.dumps([round(x, 5) for x in out['losses']])}, "
          f"ms/step {json.dumps([round(x * 1e3, 1) for x in step_s])}; masks "
          f"held; compressed all-reduce of the step-1 gradients at most "
          f"{max(c['worst_share_of_bound'] for c in out['compression']):.3f}"
          f" of its bound; saved in {r0['save_s']:.1f} s, restored onto 1x4"
          f" in {r0['restore_1x4_s']:.1f} s and onto one rank in "
          f"{r0['restore_one_s']:.1f} s, {out['leaves_checked']} leaves' "
          f"checksums equal the saved state's; step 6 on 1x4 vs 2x2: loss "
          f"{out['step6_loss_rel']:.2e}, grad norm "
          f"{out['step6_grad_norm_rel']:.2e} relative, params within "
          f"{out['step6_param_err']:.2e}, update misses "
          f"{out['step6_update_miss']:.3e}; "
          f"peak allocated per rank {out['peak_allocated']} B; {card}",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# the mesh phase's families over four ranks that share the card:
# qwen3-moe-30b-a3b with expert parallelism, minicpm3_4b with MLA,
# recurrentgemma-9b (RG-LRU and the window ring over the ranks),
# mamba2-130m (SSD), qwen2-vl-2b (M-RoPE) and musicgen-large (codebooks)
# ---------------------------------------------------------------------------

MESH_FAMILIES = ("qwen3_moe_30b_a3b", "minicpm3_4b", "recurrentgemma_9b",
                 "mamba2_130m", "qwen2_vl_2b", "musicgen_large")
# Every family's ranks are held against the unsharded build, leaf by leaf
# (``_leaf_digests``: each rank's leaf is the slice of the whole build).
# These families' ranks are also held against the dry run of their cell
# (``_family_known``, ``_family_launches``): the per-rank bytes and the
# decode step's launch list that ``specs.build_cell`` predicts, a check of
# the dry run that the digests cannot make. The other families' dry-run
# bytes are held against the reference's in tests/test_torch_specs.py.
MESH_DRY_FAMILIES = ("qwen3_moe_30b_a3b", "minicpm3_4b")
# Three layers keep one whole period of recurrentgemma's (RG-LRU, RG-LRU,
# local attention) pattern, so its ring request still wraps a window.
MESH_FAMILY_DEPTH = 3
# The families are built at the 3 layers they serve: qwen3-moe
# went to 16 of its 48 when the SSM, hybrid, vlm and audio families came
# (the script ran 1135 s against the 1100 s it is held to, its 48-layer
# builds 35.6 s of it), and every family to 8 when the training world
# took one step of each (about 100 s more; the part took 162.6 s with
# the full-depth builds, NVIDIA H100 80GB HBM3, 700 W), to 4 when the
# whole script ran past its 1200 s limit on a slow host, and to 3 when
# it ran 1038 and 1096 s against the 1000 s it is held to (the part's
# world 75.0 and 99.2 s).
MESH_FAMILY_BUILD_LAYERS = {arch: 3 for arch in MESH_FAMILIES}
# qwen2-vl's prompt: an 8 x 8 patch grid at t = 0 with its rows and
# columns as h and w ids, then text at 8 on (all three ids)
MESH_VLM_GRID = 8
# recurrentgemma's one request past its 2048-position window: the ring,
# its slots over model, wraps at the prefill and goes on wrapping
MESH_RING_PROMPT = 2100
MESH_RING_MAX_LEN = MESH_RING_PROMPT + MESH_NEW
# what ``specs``' struct and ``serve.build`` hold apart besides lm_head and
# the norm scales, for these families (reference-side: ROADMAP.md queue 3
# items 4 and 5): the struct keeps MoE's routed stacks dense and encodes
# MLA's latent factors; the build encodes the stacks per expert and keeps
# the factors dense (``w_ukv`` in f32)
ROUTED = re.compile(r"\['moe'\]\['(gate|up|down)'\]$")
FACTOR = re.compile(r"\['attn'\]\['(w_dq|w_uq|w_dkv|w_ukv)'\]\['w'\]$")
DIGEST_CHUNK = 1 << 26


def _route_trace(torch, mods, cfg, pin=None, keep=True):
    """A :class:`RouteTrace` for an MoE config, else a null context."""
    if not cfg.n_routed_experts:
        import contextlib
        return contextlib.nullcontext(None)
    return RouteTrace(torch, mods["moe"], cfg.top_k, pin=pin, keep=keep)


def _family_config(mods, arch: str):
    """The family's config as the part builds it
    (``MESH_FAMILY_BUILD_LAYERS``)."""
    return dataclasses.replace(mods["configs"].get(arch),
                               n_layers=MESH_FAMILY_BUILD_LAYERS[arch])


def _family_inputs(torch, cfg, prompts) -> dict:
    """The prefill's extra inputs of a family's prompts: for M-RoPE, [3,
    B, S] positions (``MESH_VLM_GRID``'s patch grid, then text), else
    none."""
    if cfg.mrope_sections is None:
        return {}
    B, S = prompts.shape
    G = MESH_VLM_GRID * MESH_VLM_GRID
    dev = prompts.device
    r = torch.arange(G, device=dev) // MESH_VLM_GRID
    c = torch.arange(G, device=dev) % MESH_VLM_GRID
    text = MESH_VLM_GRID + torch.arange(S - G, device=dev)
    thw = torch.stack([torch.cat([torch.zeros_like(r), text]),
                       torch.cat([r, text]), torch.cat([c, text])])
    return {"positions": thw[:, None].expand(3, B, S).contiguous()}


def _recurrent(cfg) -> bool:
    """A stack with RG-LRU or SSM layers: its sharded first step is gated
    in f32 activations (``MESH_F32_TOL``, ``_f32_step``), its bf16
    figure printed."""
    return any(cfg.layer_kind(i) in ("rglru", "ssm")
               for i in range(cfg.n_layers))


# The recurrent stacks' sharded first step, free-running through every
# layer, is gated in f32 activations at the f32 tolerance of the CPU mesh
# tests (tests/test_torch_mesh.py). In bf16 a recurrent layer carries
# each rounding difference on through its state: at 4 layers
# recurrentgemma's bf16 logits moved by 4.688e-02 between the sharded and
# the unsharded run, where the unsharded bf16 run is itself 8.517e-02 off
# the f32 one, and the f32 runs agreed to 4.431e-04 (NVIDIA H100 80GB
# HBM3, 700 W). The bf16 figure is printed beside the gate.
MESH_F32_TOL = 1e-3


def _f32_step(torch, mods, params, cfg, prompts, max_len, tok=None,
              mesh=None):
    """The first decode step with f32 activations (the bf16 build's
    weights; each kernel takes f32 B), free-running through every layer:
    (the prefill's first tokens, the step's logits), numpy; ``tok``
    (numpy) teacher-forces the first tokens."""
    own, step, _ = _first_step(
        torch, mods["engine"], params,
        dataclasses.replace(cfg, dtype="float32"), prompts,
        None if tok is None else torch.from_numpy(tok), mesh, max_len,
        layout=False)
    return own.numpy(), step.numpy()


def _ring_prompt(mods, cfg, dev):
    """The one ``MESH_RING_PROMPT``-token request past the window."""
    return mods["serve"].make_prompts(cfg, 1, MESH_RING_PROMPT, SEED + 17,
                                      dev)


def _leaf_digests(torch, sharding, tree, mesh=None, coords=None) -> dict:
    """{path: (shape, dtype, digest)} of every leaf (Tiled-CSL words and
    counters too): the sum of its bits times a hash of their positions,
    mod 2**64 (an integer sum, so in any order the same); with ``mesh``
    (``{axis: size}``) and ``coords``, of the block of the leaf that the
    sharding rules give that rank."""
    out = {}
    views = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    for path, t in sharding.leaves_with_paths(tree):
        if mesh is not None:
            t = sharding.shard_leaf(t, sharding.spec_for(
                path, tuple(t.shape), mesh), mesh, coords=coords)
        flat = t.detach().contiguous().reshape(-1)
        if flat.dtype == torch.bool:
            flat = flat.to(torch.uint8)
        bits = flat.view(views[flat.element_size()])
        acc = torch.zeros((), dtype=torch.int64, device=flat.device)
        for lo in range(0, flat.numel(), DIGEST_CHUNK):
            i = torch.arange(lo, min(lo + DIGEST_CHUNK, flat.numel()),
                             device=flat.device, dtype=torch.int64)
            w = i * 0x5851F42D4C957F2D + 0x14057B7EF767814F
            acc = acc + (bits[lo:lo + DIGEST_CHUNK].to(torch.int64)
                         * w).sum()
        out[path] = (tuple(t.shape), str(t.dtype), int(acc))
    return out


def _family_reference(torch, mods, arch: str) -> dict:
    """The unsharded side of one family, in this process: the model built
    whole (at ``MESH_FAMILY_BUILD_LAYERS``' depth; its
    non-zeros and bytes; the digests of each model rank's block of every
    leaf), then at ``MESH_FAMILY_DEPTH`` layers the first decode step
    (a recurrent stack's also in f32, ``_f32_step``) and ``generate``'s
    greedy streams with each step's top-2 margins, for MoE every MoE
    call's routes and margins (the first step's with their logits, the
    ranks' pin), and for the window ring the same of one
    ``MESH_RING_PROMPT``-token request."""
    serve, engine = mods["serve"], mods["engine"]
    cfg = _family_config(mods, arch)
    release(torch)
    params, built = serve.build(cfg, seed=SEED, sparsity=SPARSITY,
                                device=MESH_DEVICE)
    m = MESH_SERVE_SHAPE
    digests = [_leaf_digests(torch, mods["sharding"], params,
                             {"data": m[0], "model": m[1]},
                             {"data": 0, "model": r}) for r in range(m[1])]
    prompts = serve.make_prompts(cfg, MESH_REQUESTS, MESH_PROMPT, SEED + 13,
                                 MESH_DEVICE)
    p = dict(params, layers=params["layers"][:MESH_FAMILY_DEPTH])
    c = dataclasses.replace(cfg, n_layers=MESH_FAMILY_DEPTH)
    inputs = _family_inputs(torch, cfg, prompts)
    with _route_trace(torch, mods, c) as tap:
        tok, step, first_margins = _first_step(torch, engine, p, c, prompts,
                                               **inputs)
    pin = tap.calls if tap is not None else None
    f32 = (_f32_step(torch, mods, p, c, prompts, MESH_MAX_LEN)
           if _recurrent(c) else None)
    times = {}
    with _MarginTap(engine) as mt, _route_trace(torch, mods, c,
                                               keep=False) as gen_tap:
        streams = engine.generate(p, prompts, c, max_new_tokens=MESH_NEW,
                                  max_len=MESH_MAX_LEN, timings=times)
    out = dict(nnz=built["nnz"], weight_bytes=built["weight_bytes"],
               build_s=built["build_s"], prompts=prompts.cpu().numpy(),
               tok=tok.numpy(), step=step.numpy(),
               first_margins=first_margins.numpy(), pin=pin,
               streams=streams[..., MESH_PROMPT:].cpu().numpy(),
               margins=torch.stack(mt.margins).numpy(),
               routes=gen_tap.calls if gen_tap is not None else None,
               prefill_ms=times["prefill_s"] * 1e3,
               decode_ms_per_step=times["decode_s"] / (MESH_NEW - 1) * 1e3,
               digests=digests, ring=None, f32=f32)
    if cfg.local_window is not None:
        out["ring"] = _ring_request(torch, mods, p, c)
        out["ring"]["f32"] = _f32_step(
            torch, mods, p, c, _ring_prompt(mods, c, MESH_DEVICE),
            MESH_RING_MAX_LEN)
    del params, p, prompts
    release(torch)
    return out


def _ring_request(torch, mods, params, cfg, mesh=None, tok=None) -> dict:
    """One ``MESH_RING_PROMPT``-token request past the window: its first
    decode step (``tok`` teacher-forcing the first token) and its greedy
    stream of ``MESH_NEW`` with each step's margins, at
    ``MESH_RING_MAX_LEN``; under ``mesh`` the ring's slots lie over
    model."""
    engine = mods["engine"]
    dev = mods["mesh"].rank_device(mesh) if mesh is not None else MESH_DEVICE
    prompt = _ring_prompt(mods, cfg, dev)
    with torch.inference_mode():
        last, cache = engine.prefill(params, prompt, cfg, MESH_RING_MAX_LEN,
                                     mesh=mesh)
        ring = cache[2]["k"].shape[1]       # layer 2: the first attention
        if mesh is not None:
            check(cache.seq == "model" and ring * MESH_SERVE_SHAPE[1]
                  == cfg.local_window, f"mesh: {cfg.name}'s ring lies by "
                  f"{cache.seq!r}, {ring} slots a rank")
        own = torch.argmax(last, dim=-1)
        first = own if tok is None else torch.from_numpy(tok).to(dev)
        step, _ = engine.serve_step(params, cache, first[:, None],
                                    MESH_RING_PROMPT, cfg, mesh=mesh)
        del cache
        with _MarginTap(engine) as mt:
            stream = engine.generate(params, prompt, cfg,
                                     max_new_tokens=MESH_NEW,
                                     max_len=MESH_RING_MAX_LEN, mesh=mesh)
    return dict(tok=own.cpu().numpy(), step=step.float().cpu().numpy(),
                first_margins=_row_margins(last).cpu().numpy(),
                streams=stream[:, MESH_RING_PROMPT:].cpu().numpy(),
                margins=torch.stack(mt.margins).numpy(), ring_slots=ring)


def _dry_family_cell(torch, mods, cfg, rank: int) -> dict:
    """``build_cell`` on meta for what a family rank serves (decode, batch
    ``MESH_REQUESTS``, ``MESH_MAX_LEN`` positions, ``sparse_xla``) on a
    dry ``MESH_SERVE_SHAPE`` mesh as rank ``rank``: each leaf's per-rank
    bytes and the LSCD launch list of a decode step."""
    from repro_torch.models.config import ShapeConfig
    specs, dryrun, sharding = mods["specs"], mods["dryrun"], mods["sharding"]
    mesh = mods["mesh"].DryMesh(MESH_SERVE_SHAPE, ("data", "model"),
                                rank=rank)
    shape = ShapeConfig("mesh_decode", "decode", MESH_MAX_LEN, MESH_REQUESTS)
    cell = specs.build_cell(cfg, shape, mesh, weight_mode="sparse_xla")
    ran = dryrun.execute(cell, mesh, train=False)
    return dict(params=_leaf_bytes(sharding, cell.args[0]),
                cache=_leaf_bytes(sharding, list(cell.args[1])),
                lscd=ran["lscd"], arg_bytes=cell.arg_bytes())


def mesh_family_rank(mesh, refs: dict, mods) -> dict:
    """One rank's families part, in the serving world (1x4): per family,
    the model built (``_family_config``) with this rank's shard
    (``serve.build(mesh=)``, layer by layer, the ranks in turn) and the
    digests of its leaves, then at ``MESH_FAMILY_DEPTH`` layers the
    first decode step teacher-forced with the unsharded first tokens
    (MoE: routes pinned to the unsharded run's; M-RoPE: the prompt's
    t/h/w positions) under the kernel profiler, ``engine.generate``'s
    greedy streams with its LSCD launches counted from 0 (MoE: each
    call's routes), for the window ring the ``MESH_RING_PROMPT``-token
    request, every launch configuration held against its plain version,
    a recurrent stack's first step in f32 (``_f32_step``; its ring
    request's too), and (``MESH_DRY_FAMILIES``) the dry run of this
    rank's cell with what ran beside it."""
    import torch
    import torch.distributed as dist
    serve, engine, spmm = mods["serve"], mods["engine"], mods["spmm"]
    sharding, dryrun = mods["sharding"], mods["dryrun"]
    rank = dist.get_rank()
    dev = mods["mesh"].rank_device(mesh)
    t0 = time.perf_counter()
    out = dict(rank=rank)
    for arch in MESH_FAMILIES:
        ref = refs[arch]
        cfg = _family_config(mods, arch)
        c = dataclasses.replace(cfg, n_layers=MESH_FAMILY_DEPTH)
        torch.cuda.reset_peak_memory_stats()
        t_arch = time.perf_counter()
        params, built = _in_turn(torch, lambda: serve.build(
            cfg, seed=SEED, sparsity=SPARSITY, device=dev, mesh=mesh))
        r = dict(nnz=built["nnz"], nnz_replicated=built["nnz_replicated"],
                 build_s=built["build_s"],
                 weight_bytes=built["weight_bytes"],
                 sparse_bytes=built["sparse_bytes"],
                 build_peak_allocated=built["max_memory_allocated"],
                 digests=_leaf_digests(torch, sharding, params))
        p = dict(params, layers=params["layers"][:MESH_FAMILY_DEPTH])
        del params
        prompts = torch.from_numpy(ref["prompts"]).to(dev)
        inputs = _family_inputs(torch, cfg, prompts)
        probe = LaunchProbe(spmm)
        prof = mods["obs_profile"].KernelProfiler()
        with probe, torch.inference_mode():
            probe.phase = "serve"           # the first step and generate
            with _route_trace(torch, mods, c, pin=ref["pin"]) as tap:
                last, cache = engine.prefill(p, prompts, c, MESH_MAX_LEN,
                                             mesh=mesh, **inputs)
                _check_mesh_layout_of(cache, c)
                r["cache_bytes"] = _leaf_bytes(sharding, list(cache))
                tok = torch.from_numpy(ref["tok"]).to(dev)[..., None]
                with mods["obs_profile"].profiled(prof):
                    step, _ = engine.serve_step(p, cache, tok, MESH_PROMPT,
                                                c, mesh=mesh)
            del cache
            r.update(tok=torch.argmax(last, dim=-1).cpu().numpy(),
                     step=step.float().cpu().numpy(),
                     pinned=tap.pinned if tap is not None else 0,
                     first_routes=tap.calls if tap is not None else None,
                     launches_step=_launch_rows(dryrun, prof))
            for call in r["first_routes"] or ():
                call["logits"] = None
            times = {}
            spmm.reset_launch_counts()
            with _route_trace(torch, mods, c, keep=False) as gen_tap:
                streams = engine.generate(p, prompts, c,
                                          max_new_tokens=MESH_NEW,
                                          max_len=MESH_MAX_LEN, mesh=mesh,
                                          timings=times)
            r.update(launches=spmm.launch_counts(),
                     streams=streams[..., MESH_PROMPT:].cpu().numpy(),
                     routes=gen_tap.calls if gen_tap is not None else None,
                     prefill_ms=times["prefill_s"] * 1e3,
                     decode_ms_per_step=times["decode_s"] / (MESH_NEW - 1)
                     * 1e3)
            if ref["ring"] is not None:
                probe.phase = "ring"
                r["ring"] = _ring_request(torch, mods, p, c, mesh,
                                          ref["ring"]["tok"])
        # the f32 gate's runs, whose f32 launches serve nothing
        if ref["f32"] is not None:
            r["f32"] = _f32_step(torch, mods, p, c, prompts, MESH_MAX_LEN,
                                 ref["f32"][0], mesh)
        if ref["ring"] is not None:
            r["ring"]["f32"] = _f32_step(
                torch, mods, p, c, _ring_prompt(mods, c, dev),
                MESH_RING_MAX_LEN, ref["ring"]["f32"][0], mesh)
        r["peak_allocated"] = torch.cuda.max_memory_allocated()
        r["param_bytes"] = _leaf_bytes(sharding, p)
        r["checked"] = len(_check_served_launches(
            torch, mods, probe.seen, c, label=f"mesh: {arch} rank {rank}"))
        r["dry"] = (_dry_family_cell(torch, mods, c, rank)
                    if arch in MESH_DRY_FAMILIES else None)
        del p, probe, prompts, streams, last, step
        release(torch)
        r["arch_s"] = time.perf_counter() - t_arch
        out[arch] = r
    dist.barrier()
    out["families_s"] = time.perf_counter() - t0
    return out


def _check_mesh_layout_of(cache, cfg) -> None:
    """The families' serving caches: the K/V sequence (a ring's slots)
    over model (``MESH_MAX_LEN`` divides it), MLA's latents whole over
    model, the SSM's states whole over model (no positions)."""
    want = None if cfg.attn_kind == "mla" or cfg.family == "ssm" \
        else "model"
    check(getattr(cache, "seq", None) == want, f"mesh: {cfg.name}'s cache "
          f"lies by {getattr(cache, 'seq', None)!r}, not {want!r}")


def _first_route_flip(got_calls, want_calls):
    """The first MoE call and token whose routes differ between two runs,
    as (call, token, the first run's margin, the second's), or None."""
    import numpy as np
    for i, (g, w) in enumerate(zip(got_calls, want_calls)):
        diff = np.nonzero((g["idx"] != w["idx"]).any(axis=-1))[0]
        if len(diff):
            t = int(diff[0])
            return (i, t, float(w["margin"][t]), float(g["margin"][t]))
    return None


def _family_streams(label, got, want, layers: int) -> dict:
    """Each rank-0 stream against the unsharded one: a row that parts
    must part at a near tie of the unsharded logits (top-2 margin below
    ``NEAR_TIE``; of codebooks, the smallest), or, for MoE, after a route
    flipped at a router near tie (the first differing route at or before
    that step, both top-k margins below ``NEAR_TIE``)."""
    import numpy as np
    flip = None
    if want.get("routes") is not None:
        flip = _first_route_flip(got["routes"], want["routes"])
    cut = []
    for row in range(len(want["streams"])):
        a, b = got["streams"][row], want["streams"][row]
        diff = np.nonzero((a != b).reshape(-1, a.shape[-1]).any(axis=0))[0]
        if not len(diff):
            continue
        i = int(diff[0])
        margin = float(want["margins"][i][row])
        # MoE calls: prefill's ``layers``, then ``layers`` a decode step;
        # token i of the stream is sampled after step i's calls
        routed = flip is not None and flip[0] < layers * (i + 1) and \
            max(flip[2], flip[3]) < NEAR_TIE
        check(margin < NEAR_TIE or routed, f"{label}: request {row} parts "
              f"from the unsharded stream at token {i}, where its top-2 "
              f"margin is {margin:.3e} and the first route flip is {flip} "
              f"(a near tie is below {NEAR_TIE:.1e})")
        cut.append((row, i, margin))
    return dict(cut=cut, first_route_flip=flip)


def _family_known(label, r: dict, cfg) -> tuple:
    """The rank's params (cut to the served depth) and cache against the
    dry run of its cell, leaf by leaf, but for the struct's known
    differences from the build (``_compare_params``: lm_head and the norm
    scales; here also MoE's routed stacks, dense in the struct and
    Tiled-CSL stacks of the rank's experts as built, and MLA's latent
    factors, Tiled-CSL in the struct and dense as built, ``w_ukv`` in
    f32), each held to be exactly that. Returns (leaves held, the known
    differences met)."""
    d = r["dry"]
    got = dict(r["param_bytes"])
    want = dict(d["params"])
    known = set()
    layer = lambda path: re.sub(r"\['layers'\]\[\d+\]", "['layers'][*]",
                                path)
    for path in [p for p in want if ROUTED.search(p)]:
        elems, width = want.pop(path)
        e, m = cfg.n_routed_experts // MESH_SERVE_SHAPE[1], got.get(
            path + ".words")
        check(width == 2 and m is not None and m[0] % e == 0
              and path + ".nnz" in got, f"{label}: {path} is "
              f"{got.get(path + '.words')} on the rank, dense bf16 "
              f"{(elems, width)} in the dry run: not the known Tiled-CSL "
              f"stack of {e} experts")
        got.pop(path + ".words"), got.pop(path + ".nnz")
        known.add(("routed stack", layer(path)))
    for path in [p for p in got if FACTOR.search(p)]:
        elems, width = got.pop(path)
        check(path + ".words" in want and path + ".nnz" in want
              and width in (2, 4), f"{label}: {path} is dense {(elems, width)}"
              f" on the rank and {'Tiled-CSL' if path + '.words' in want else 'dense'}"
              f" in the dry run: not the known latent factor")
        want.pop(path + ".words"), want.pop(path + ".nnz")
        known.add(("latent factor", layer(path)))
    head_mk = (cfg.vocab // MESH_SERVE_SHAPE[1], cfg.d_model)
    held = _compare_params(label, got, want, head_mk[0] * head_mk[1], known)
    held += _compare_bytes(f"{label} cache", r["cache_bytes"], d["cache"])
    return held, known


def _dry_head_mk(cfg) -> tuple:
    """(M, K) of the dry run's Tiled-CSL lm_head launch on a rank: its
    tiles split over model where their count divides the axis, else the
    whole padded head (``fit_spec`` leaves it whole)."""
    m = MESH_SERVE_SHAPE[1]
    tiles = -(-cfg.vocab // 128)
    return (tiles * 128 // (m if tiles % m == 0 else 1),
            -(-cfg.d_model // 128) * 128)


def _family_launches(label, r: dict, cfg) -> dict:
    """The rank's decode-step LSCD launch list against the dry run's: the
    dry run's less lm_head's one launch and (MLA) the latent factors'
    launches, which the build runs dense, equal to the rank's less (MoE)
    its expert-batched launches, which the struct's dense stacks do not
    make."""
    mla = cfg.attn_kind == "mla"
    h, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    m = MESH_SERVE_SHAPE[1]
    factors = set()
    if mla:
        pad = lambda x: -(-x // 128) * 128
        factors = {(pad(cfg.q_lora_rank), cfg.d_model),
                   (pad(cfg.kv_lora_rank + dr), cfg.d_model),
                   (pad(h * (dn + dr)), pad(cfg.q_lora_rank)),
                   (pad(h * (dn + dv)) // m, pad(cfg.kv_lora_rank)),
                   (pad(h * (dn + dr)) // m, pad(cfg.q_lora_rank))}
    from collections import Counter
    dry, head = _split_head(r["dry"]["lscd"], _dry_head_mk(cfg))
    ran = [tuple(x) for x in r["launches_step"]]
    batched = [x for x in ran if x[0].endswith("batched")]
    ran_rest = [x for x in ran if not x[0].endswith("batched")]
    unran = sorted((Counter(dry) - Counter(ran_rest)).elements())
    check(not Counter(ran_rest) - Counter(dry)
          and all((x[1], x[2]) in factors for x in unran),
          f"{label}: the decode step launched {ran_rest} beside its batched "
          f"launches, the dry run predicts {dry} beside lm_head's: more "
          f"than the latent factors' launches apart")
    check(bool(batched) == bool(cfg.n_routed_experts), f"{label}: batched "
          f"launches {batched}")
    return dict(launch_list=sorted(ran_rest), head=head, batched=batched,
                factors=unran)


def _f32_gate(torch, label: str, got: list, want: dict, what: str) -> dict:
    """A recurrent stack's sharded first step against the unsharded one,
    both with f32 activations and free-running: every rank's logits the
    same, rank 0's within ``MESH_F32_TOL``; the bf16 step's difference
    (``step``) beside it, printed."""
    import numpy as np
    for g in got[1:]:
        check(np.array_equal(g["f32"][1], got[0]["f32"][1]),
              f"{label}: the ranks' f32 first-step logits differ")
    err = close(torch, torch.from_numpy(got[0]["f32"][1]),
                torch.from_numpy(want["f32"][1]),
                dict(rtol=MESH_F32_TOL, atol=MESH_F32_TOL),
                f"{label}: first decode-step logits {what} vs unsharded, f32 "
                f"activations, free-running through every layer")
    return dict(max_abs_err=err, tol=MESH_F32_TOL,
                bf16=_tol_share(got[0]["step"], want["step"], LOGITS_TOL))


def _gate_text(gate: dict) -> str:
    """How a first-step figure was gated, for the summary lines."""
    if gate.get("bf16") is None:
        return f"(tolerance {LOGITS_TOL} + {LOGITS_TOL} relative"
    b = gate["bf16"]
    return (f"with f32 activations, free-running through every layer "
            f"(tolerance {MESH_F32_TOL} + {MESH_F32_TOL} relative; bf16 "
            f"free-running {b['max_abs_err']:.3e}, {b['share']:.3f} of "
            f"{LOGITS_TOL} + {LOGITS_TOL} relative, printed")


def _ring_gates(torch, label, got: list, want: dict) -> dict:
    """The ranks' ring request against the unsharded ring: every rank's
    stream and first-step logits the same, those logits within
    ``MESH_F32_TOL`` in f32 (``_f32_gate``), its first token and stream
    equal but at a near tie."""
    import numpy as np
    for g in got[1:]:
        check(np.array_equal(g["streams"], got[0]["streams"])
              and np.array_equal(g["step"], got[0]["step"]),
              f"{label} ring: the ranks differ")
    gate = _f32_gate(torch, f"{label} ring", got, want, "past the window")
    ties = [(int(i), float(want["first_margins"][i]))
            for i in np.nonzero(got[0]["tok"] != want["tok"])[0]]
    check(all(m < NEAR_TIE for _, m in ties), f"{label} ring: first token "
          f"differs from the unsharded ring at {ties}")
    streams = _family_streams(f"{label} ring", got[0], want,
                              MESH_FAMILY_DEPTH)
    return dict(gate, first_token_ties=ties, cut=streams["cut"],
                ring_slots=got[0]["ring_slots"])


def _tol_share(got, want, tol: float) -> dict:
    """The max abs difference of two logits arrays and its largest share
    of ``tol + tol * |want|``."""
    import numpy as np
    d = np.abs(got - want)
    return dict(max_abs_err=float(d.max()),
                share=float((d / (tol + tol * np.abs(want))).max()))


def _family_references(torch, mods, card: str) -> tuple:
    """The families' unsharded runs, in this process, before the serving
    world starts: (refs by arch, seconds)."""
    t0 = time.perf_counter()
    refs = {}
    for arch in MESH_FAMILIES:
        refs[arch] = w = _family_reference(torch, mods, arch)
        print(f"mesh: unsharded {arch} built at "
              f"{_family_config(mods, arch).n_layers} layers in "
              f"{w['build_s']:.1f} s, {w['weight_bytes']} B, {w['nnz']} "
              f"non-zeros; at {MESH_FAMILY_DEPTH} layers prefill "
              f"{w['prefill_ms']:.1f} ms, decode "
              f"{w['decode_ms_per_step']:.3f} ms/step; {card}", flush=True)
    return refs, time.perf_counter() - t0


def _mesh_families(torch, mods, card: str, refs: dict, refs_s: float,
                   ranks: list) -> dict:
    """The gates of qwen3-moe-30b-a3b (expert parallelism, 32 experts a
    rank), minicpm3_4b (MLA, 10 heads a rank), recurrentgemma-9b (RG-LRU
    widths and MLP over the ranks, its ring's slots over model),
    mamba2-130m (SSD, ``in_proj`` 838 rows a rank), qwen2-vl-2b (3 query
    heads a rank, M-RoPE) and musicgen-large (a codebook a rank of the
    head) on ``MESH_SERVE_SHAPE``: the ranks' families results against
    the unsharded runs."""
    import numpy as np
    out = dict(card=card, world_s=ranks[0]["families_s"], families={})
    launches = dict.fromkeys(mods["spmm"].KERNELS, 0)
    for arch in MESH_FAMILIES:
        cfg = _family_config(mods, arch)
        c = dataclasses.replace(cfg, n_layers=MESH_FAMILY_DEPTH)
        w = refs[arch]
        got = [r[arch] for r in ranks]
        label = f"mesh: {arch}"
        nnz = sum(g["nnz"] - g["nnz_replicated"] for g in got) + \
            got[0]["nnz_replicated"]
        check(nnz == w["nnz"], f"{label}: the ranks encode {nnz} non-zeros "
              f"(each replicated leaf once), the unsharded build {w['nnz']}")
        for g in got[1:]:
            check(np.array_equal(g["streams"], got[0]["streams"]),
                  f"{label}: the ranks' streams differ")
            check(np.array_equal(g["step"], got[0]["step"]),
                  f"{label}: the ranks' first-step logits differ")
        if w["f32"] is not None:
            gate = _f32_gate(torch, label, got, w,
                             f"at {MESH_FAMILY_DEPTH} layers")
        else:
            gate = dict(tol=LOGITS_TOL, bf16=None, max_abs_err=close(
                torch, torch.from_numpy(got[0]["step"]),
                torch.from_numpy(w["step"]),
                dict(rtol=LOGITS_TOL, atol=LOGITS_TOL),
                f"{label}: first decode-step logits at {MESH_FAMILY_DEPTH} "
                f"layers vs unsharded"
                + (" (routes pinned)" if cfg.n_routed_experts else "")))
        err = gate["max_abs_err"]
        ties = [(int(i), float(w["first_margins"][i]))
                for i in np.nonzero(got[0]["tok"] != w["tok"])[0]]
        check(all(m < NEAR_TIE for _, m in ties), f"{label}: first tokens "
              f"differ from unsharded at {ties}")
        pre_flip = None
        if cfg.n_routed_experts:
            pre_flip = _first_route_flip(got[0]["first_routes"], w["pin"])
            check(pre_flip is None or max(pre_flip[2:]) < NEAR_TIE,
                  f"{label}: the first step's first route flip before the "
                  f"pin, {pre_flip}, is not at a router near tie")
        streams = _family_streams(label, got[0], w, MESH_FAMILY_DEPTH)
        held, digested, known = 0, 0, set()
        lists = []
        for rank, g in enumerate(got):
            # the decode pair serves every family's decode step (N = 8)
            # but the SSM's, which encodes no weight; which kernels a
            # prefill takes is select's pick at its N
            missing = [k for k in ("lscd_spmm_splitk",
                                   "lscd_spmm_splitk_grouped")
                       if not g["launches"][k] and cfg.family != "ssm"]
            if cfg.n_routed_experts and not any(
                    g["launches"][k] for k in mods["spmm"].BATCHED_KERNELS):
                missing.append("an expert-batched kernel")
            check(not missing, f"{label}: rank {rank} never launched "
                  f"{missing}")
            mine, whole = g["digests"], w["digests"][rank]
            bad = sorted(q for q in set(mine) | set(whole)
                         if mine.get(q) != whole.get(q))
            check(not bad, f"{label}: rank {rank}'s leaves are not the "
                  f"slices of the unsharded build: {bad[:8]}")
            digested += len(mine)
            if arch not in MESH_DRY_FAMILIES:
                continue
            n, k = _family_known(f"{label} rank {rank}", g, c)
            held += n
            known |= k
            lists.append(_family_launches(f"{label} rank {rank}", g, c))
        ring = None
        if w["ring"] is not None:
            ring = _ring_gates(torch, label, [g["ring"] for g in got],
                               w["ring"])
        for k in launches:
            launches[k] += sum(g["launches"][k] for g in got)
        out["families"][arch] = dict(
            nnz=nnz, unsharded_nnz=w["nnz"],
            weight_bytes=[g["weight_bytes"] for g in got],
            unsharded_weight_bytes=w["weight_bytes"],
            build_s=[g["build_s"] for g in got],
            peak_allocated=[g["peak_allocated"] for g in got],
            max_abs_err=err, tol=gate["tol"], first_token_ties=ties,
            bf16_free_running=gate["bf16"],
            pinned=got[0]["pinned"], pre_pin_flip=pre_flip, **streams,
            prefill_ms=[g["prefill_ms"] for g in got],
            decode_ms_per_step=[g["decode_ms_per_step"] for g in got],
            unsharded_prefill_ms=w["prefill_ms"],
            unsharded_decode_ms_per_step=w["decode_ms_per_step"],
            launches=[g["launches"] for g in got],
            checked=[g["checked"] for g in got], leaves_held=held,
            leaves_digested=digested,
            known_differences=sorted(known),
            launch_list=lists[0] if lists else None,
            dry_arg_bytes=got[0]["dry"]["arg_bytes"] if got[0]["dry"]
            else None, ring=ring, arch_s=[g["arch_s"] for g in got],
            param_bytes=[sum(e * b for e, b in g["param_bytes"].values())
                         for g in got],
            cache_bytes=[sum(e * b for e, b in g["cache_bytes"].values())
                         for g in got])
        f = out["families"][arch]
        print(f"mesh: {arch} on {MESH_SERVE_SHAPE[0]}x"
              f"{MESH_SERVE_SHAPE[1]}: built at {cfg.n_layers} layers, "
              f"per rank {json.dumps(f['weight_bytes'])} B (unsharded "
              f"{w['weight_bytes']} B), build s "
              f"{json.dumps([round(s, 1) for s in f['build_s']])}, "
              f"non-zeros {nnz} = unsharded; at {MESH_FAMILY_DEPTH} layers "
              f"first decode-step logits vs unsharded max abs err {err:.3e} "
              + _gate_text(gate)
              + (f"; {f['pinned']} token routes pinned, first flip before "
                 f"the pin {pre_flip}" if cfg.n_routed_experts else "")
              + f"); {MESH_REQUESTS - len(f['cut'])} of {MESH_REQUESTS} "
              f"streams of {MESH_NEW} equal, {len(f['cut'])} parted "
              f"{json.dumps([[r, i, round(m, 5)] for r, i, m in f['cut']])}"
              f" (first route flip {f['first_route_flip']}); rank 0 prefill "
              f"{f['prefill_ms'][0]:.1f} ms, decode "
              f"{f['decode_ms_per_step'][0]:.3f} ms/step (unsharded "
              f"{w['prefill_ms']:.1f} ms, {w['decode_ms_per_step']:.3f} "
              f"ms/step); LSCD launches by rank "
              f"{json.dumps(f['launches'])}; {sum(f['checked'])} launch "
              f"configurations held against their plain versions; peak "
              f"allocated a rank {json.dumps(f['peak_allocated'])} B; the "
              f"arch's part of the world {f['arch_s'][0]:.1f} s; {card}",
              flush=True)
        if ring is not None:
            print(f"mesh: {arch}: one {MESH_RING_PROMPT}-token request past "
                  f"the {cfg.local_window}-position window, the ring's "
                  f"{ring['ring_slots']} slots a rank over model: first "
                  f"decode-step logits vs the unsharded ring max abs err "
                  f"{ring['max_abs_err']:.3e} {_gate_text(ring)}); stream "
                  f"of {MESH_NEW} "
                  f"{'equal' if not ring['cut'] else 'parted at a near tie ' + json.dumps(ring['cut'])}"
                  f"; {card}", flush=True)
        print(f"mesh: {arch}: each rank's {digested // len(got)} leaves "
              f"are the slices of the unsharded build, digest for digest; "
              f"per-rank param bytes {json.dumps(f['param_bytes'])} at "
              f"{MESH_FAMILY_DEPTH} layers, cache bytes "
              f"{json.dumps(f['cache_bytes'])}", flush=True)
        if arch not in MESH_DRY_FAMILIES:
            continue
        print(f"mesh: {arch}: the dry run of each rank's cell against what "
              f"ran: {held} leaves' per-rank elements and bytes equal; the "
              f"decode step's LSCD launch list equal "
              f"({sum(x[-1] for x in lists[0]['launch_list'])} launches) "
              f"beside lm_head's {lists[0]['head']['kernel']}, the latent "
              f"factors' {lists[0]['factors']} and the batched "
              f"{lists[0]['batched']}; known differences, each held: "
              f"{json.dumps(sorted(known))}; dry-run per-rank bytes "
              f"{json.dumps(f['dry_arg_bytes'])}", flush=True)
    out["launches"] = launches
    out["phase_s"] = refs_s + out["world_s"]
    print(f"mesh: the families part took {out['phase_s']:.1f} s (the "
          f"unsharded runs {refs_s:.1f} s, rank 0's part of the serving "
          f"world {out['world_s']:.1f} s); {card}", flush=True)
    return out


def mesh_phase(torch, mods) -> dict:
    """The mesh phase: four ranks share the one card over gloo (NCCL
    refuses two ranks on a device); no speed is claimed, since they
    time-share it and gloo stages every collective through the host."""
    card = card_line()
    print(f"mesh: four ranks share the card over gloo; {card}", flush=True)
    refs, refs_s = _family_references(torch, mods, card)
    serving, family_ranks = _mesh_serving(torch, mods, card, refs)
    families = _mesh_families(torch, mods, card, refs, refs_s, family_ranks)
    del refs, family_ranks
    training = _mesh_training(torch, mods, card)
    return dict(card=card, serving=serving, training=training,
                families=families,
                launches={k: serving["launches"][k]
                          + families["launches"][k]
                          for k in serving["launches"]})


# ---------------------------------------------------------------------------
# cells phase: the dry run of every production cell on meta tensors, and
# tinyllama-1.1b on 2x2 (four ranks sharing the card): decode with the
# sequence over model, decode at batch 1 with the sequence over data, and
# one ZeRO-3 (FSDP) train step; the dry run of those cells against what ran
# ---------------------------------------------------------------------------

CELLS_ARCH, CELLS_SHAPE = "tinyllama_1_1b", (2, 2)
CELLS_MAX_LEN, CELLS_NEW = 4096, 32
# Six prompts cross the model ranks' block boundary at 2048; two end
# before it, so model rank 1's block holds none of their positions in any
# of the 32 steps. Right-padded to the longest, each row from its own end.
CELLS_LENGTHS = (2200, 2350, 2500, 2650, 2800, 3000, 1000, 1900)
CELLS_ONE = 3000                        # the batch-1 prompt (seq_shard)
# The decode cells take tinyllama's first 8 of its 22 layers at its
# published widths: at 22 the cells world took 84.3 s and the whole
# script ran past its 1200 s limit on a slow host (NVIDIA H100 80GB HBM3,
# 700 W). The dry run of the cells is built at the same depth.
CELLS_LAYERS = 8
CELLS_TOL = depth_logits_tol(CELLS_LAYERS)
SWEEP_MODES = ("dense", "sparse_xla")
SWEEP_TIMEOUT_S = 900          # the build and the whole sweep
SPARSE_TRAIN_ITEM = "ROADMAP.md queue 3 item 13"
# PR 23's 2x2 tensor-parallel-only train step peaked at this much a rank
# (PERF.md, NVIDIA H100 80GB HBM3, 700 W): the FSDP step's beside it.
TP_ONLY_PEAK = 16_477_831_168


def _sweep_init(src: str) -> None:
    """A sweep worker sees no card, runs one thread and yields the CPU
    to the build (nice 19)."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    os.nice(19)
    if src not in sys.path:
        sys.path.insert(0, src)
    import torch
    torch.set_num_threads(1)


def _sweep_cell(job) -> dict:
    """One cell of the sweep, in a worker: ``dryrun.run_cell``'s record
    (also written to ``results/dryrun_torch/``)."""
    from repro_torch.launch import dryrun
    arch, shape, multi_pod, mode = job
    return dryrun.run_cell(arch, shape, multi_pod=multi_pod,
                           weight_mode=mode, force=True)


def start_sweep(mods) -> dict:
    """Start the dry run of every (arch x cell) on 16x16 and 2x16x16 in
    both weight modes: worker processes (one fewer than the cores) that
    see no card, started with the kernels' build, which they yield the
    CPU to; ``finish_sweep`` waits for them before the first timed
    phase. The records are written anew: ``results/dryrun_torch/`` is
    emptied first."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    dryrun = mods["dryrun"]
    shutil.rmtree(os.path.abspath(dryrun.RESULTS_DIR), ignore_errors=True)
    jobs = [job for mode in SWEEP_MODES for multi_pod in (False, True)
            for job in dryrun.iter_cells(multi_pod, mode)]
    workers = max(1, len(os.sched_getaffinity(0)) - 1)
    pool = ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn"),
        initializer=_sweep_init, initargs=(os.path.join(ROOT, "src"),))
    return dict(pool=pool, jobs=jobs, workers=workers, start=time.time(),
                recs=pool.map(_sweep_cell, jobs, timeout=SWEEP_TIMEOUT_S))


def finish_sweep(mods, sweep) -> dict:
    """Wait for the sweep; each record must be fresh (its file newer than
    the sweep's start); print each cell's line and hold the gates: every
    cell of every family ok but the train x sparse_xla cells, each an
    error naming queue 3 item 13."""
    dryrun = mods["dryrun"]
    jobs, start = sweep["jobs"], sweep["start"]
    try:
        recs = list(sweep["recs"])
    finally:
        sweep["pool"].shutdown(cancel_futures=True)
    wall_s = time.time() - start
    counts = dict(ok=0, error=0)
    cell_s = {mode: 0.0 for mode in SWEEP_MODES}
    table = []
    for (arch, shape, multi_pod, mode), rec in zip(jobs, recs):
        path = dryrun.cell_path(arch, shape, multi_pod, mode)
        check(os.path.exists(path) and os.path.getmtime(path) >= start,
              f"cells: the sweep wrote no fresh record for "
              f"{arch}/{shape}/{dryrun.mesh_name(multi_pod)}/{mode}")
        with open(path) as f:
            check(json.load(f)["status"] == rec["status"], f"cells: the "
                  f"record of {arch}/{shape}/{mode} on disk is not the "
                  f"cell's")
        print(f"cells: {dryrun.summary_line(rec)}", flush=True)
        counts[rec["status"]] = counts.get(rec["status"], 0) + 1
        cell_s[mode] += rec["total_s"]
        sparse_train = shape.startswith("train") and mode == "sparse_xla"
        label = f"cells: dry run {arch}/{shape}/{rec['mesh']}/{mode}"
        if not sparse_train:
            check(rec["status"] == "ok", f"{label}: {rec.get('error')}")
            b = rec["memory"]["argument_bytes"]
            table.append(dict(
                arch=arch, shape=shape, mesh=rec["mesh"], mode=mode, bytes=b,
                flops=rec["cost"]["flops"],
                collective=rec["collective_bytes"],
                lscd_launches=sum(r["count"] for r in rec["lscd"]),
                lscd_predicted_ms=rec["cost"]["lscd_predicted_s"] * 1e3))
        else:
            item = SPARSE_TRAIN_ITEM
            check(rec["status"] == "error" and item in rec.get("error", ""),
                  f"{label}: {rec['status']} {rec.get('error', '')!r}, not "
                  f"{item}")
            counts[item] = counts.get(item, 0) + 1
    return dict(counts=counts, table=table, cell_seconds=cell_s,
                wall_s=wall_s, workers=sweep["workers"])


def _dry_cells(torch, mods, rank: int = 0) -> dict:
    """``build_cell`` on meta for the executed cells on a dry 2x2 mesh,
    as rank ``rank``: each leaf's per-rank bytes and the LSCD launch list
    a decode step would make."""
    from repro_torch.models.config import ShapeConfig
    specs, dryrun, sharding = mods["specs"], mods["dryrun"], mods["sharding"]
    cfg = _cells_config(mods)
    out = {}
    for name, shape, mode in (
            ("decode", ShapeConfig("cells_decode", "decode", CELLS_MAX_LEN,
                                   len(CELLS_LENGTHS)), "sparse_xla"),
            ("one", ShapeConfig("cells_one", "decode", CELLS_MAX_LEN, 1),
             "sparse_xla"),
            ("train", ShapeConfig("cells_train", "train", MESH_TRAIN_SEQ,
                                  MESH_TRAIN_BATCH), "dense")):
        mesh = mods["mesh"].DryMesh(CELLS_SHAPE, ("data", "model"),
                                    rank=rank)
        c = cfg if name != "train" else dataclasses.replace(
            cfg, n_layers=MESH_TRAIN_LAYERS)
        cell = specs.build_cell(c, shape, mesh, weight_mode=mode)
        ran = dryrun.execute(cell, mesh, train=shape.kind == "train")
        trees = dict(params=cell.args[0].params if name == "train"
                     else cell.args[0])
        if name == "train":
            trees.update(mu=cell.args[0].opt_state.mu,
                         nu=cell.args[0].opt_state.nu)
        else:
            trees["cache"] = list(cell.args[1])
        out[name] = dict(
            bytes={g: _leaf_bytes(sharding, tree)
                   for g, tree in trees.items()},
            arg_bytes=cell.arg_bytes(), lscd=ran["lscd"],
            collective=ran["collective_bytes_by_axis"])
    return out


def _leaf_bytes(sharding, tree) -> dict:
    """{path: (elements, bytes an element)} of every leaf."""
    return {p: (t.numel(), t.element_size())
            for p, t in sharding.leaves_with_paths(tree)}


def _launch_rows(dryrun, prof) -> list:
    """(kernel, M, K, N, S, count) of each launch a profiler noted."""
    return sorted((r["kernel"], r["m"], r["k"], r["n"], r["s"], r["count"])
                  for r in dryrun.launch_list(prof))


def _cells_decode(torch, mods, params, cfg, prompts, lengths, tok, mesh,
                  seq_shard: bool) -> dict:
    """Prefill the right-padded ``prompts`` at ``CELLS_MAX_LEN``, then one
    decode step teacher-forced with ``tok`` under the kernel profiler:
    (this rank's first tokens, the step's f32 logits, the prefill's top-2
    margins, the step's LSCD launch list, the cache's per-leaf bytes)."""
    engine, dryrun = mods["engine"], mods["dryrun"]
    prof = mods["obs_profile"].KernelProfiler()
    with torch.inference_mode():
        last, cache = engine.prefill(params, prompts, cfg, CELLS_MAX_LEN,
                                     mesh=mesh, seq_shard=seq_shard,
                                     lengths=lengths)
        top = last.float().topk(2, dim=-1).values
        own = torch.argmax(last, dim=-1)
        tok = own if tok is None else tok.to(own.device)
        with mods["obs_profile"].profiled(prof):
            step, _ = engine.serve_step(params, cache, tok[:, None], lengths,
                                        cfg, mesh=mesh)
    out = dict(tok=own.cpu(), step=step.float().cpu(),
               margins=(top[:, 0] - top[:, 1]).cpu(),
               launches=_launch_rows(dryrun, prof),
               seq=getattr(cache, "seq", None))
    if mesh is not None:
        out["cache_bytes"] = _leaf_bytes(mods["sharding"], list(cache))
    del cache
    return out


def _cells_generate(torch, mods, params, cfg, prompts, lengths, mesh,
                    seq_shard: bool) -> dict:
    """``engine.generate``'s greedy streams (CELLS_NEW tokens), each
    step's top-2 margins, and the LSCD launches, counted from 0."""
    engine, spmm = mods["engine"], mods["spmm"]
    times = {}
    spmm.reset_launch_counts()
    with _MarginTap(engine) as tap:
        toks = engine.generate(params, prompts, cfg,
                               max_new_tokens=CELLS_NEW,
                               max_len=CELLS_MAX_LEN, mesh=mesh,
                               seq_shard=seq_shard, lengths=lengths,
                               timings=times)
    return dict(streams=toks[:, prompts.shape[1]:].cpu().numpy(),
                margins=[m.numpy() for m in tap.margins],
                launches=spmm.launch_counts(),
                prefill_ms=times["prefill_s"] * 1e3,
                decode_ms_per_step=times["decode_s"] / (CELLS_NEW - 1) * 1e3)


def _cells_config(mods):
    """tinyllama-1.1b cut to ``CELLS_LAYERS``."""
    return dataclasses.replace(mods["configs"].get(CELLS_ARCH),
                               n_layers=CELLS_LAYERS)


def _cells_prompts(torch, mods, cfg, dev):
    """The decode cells' prompts: [8, 3000] right-padded with their
    lengths, and the [1, 3000] batch-1 prompt."""
    serve = mods["serve"]
    longest = max(CELLS_LENGTHS)
    prompts = serve.make_prompts(cfg, len(CELLS_LENGTHS), longest,
                                 SEED + 11, dev)
    lengths = torch.tensor(CELLS_LENGTHS, dtype=torch.int64, device=dev)
    col = torch.arange(longest, device=dev)[None, :]
    prompts = torch.where(col < lengths[:, None], prompts, 0)
    one = serve.make_prompts(cfg, 1, CELLS_ONE, SEED + 12, dev)
    return prompts, lengths, one


def _cells_reference(torch, mods) -> dict:
    """The unsharded side, in this process: tinyllama-1.1b at 0.8 built
    whole, the first decode step and the greedy streams of both decode
    cells."""
    serve = mods["serve"]
    cfg = _cells_config(mods)
    release(torch)
    params, _ = serve.build(cfg, seed=SEED, sparsity=SPARSITY,
                            device=MESH_DEVICE)
    prompts, lengths, one = _cells_prompts(torch, mods, cfg, MESH_DEVICE)
    out = {}
    for name, p, n in (("decode", prompts, lengths),
                       ("one", one, torch.full((1,), CELLS_ONE,
                                               device=MESH_DEVICE))):
        first = _cells_decode(torch, mods, params, cfg, p, n, None, None,
                              False)
        gen = _cells_generate(torch, mods, params, cfg, p, n, None, False)
        out[name] = dict(tok=first["tok"].numpy(), step=first["step"],
                         first_margins=first["margins"].numpy(),
                         launches_unsharded=first["launches"], **gen)
    del params
    release(torch)
    return out


def _fsdp_run(torch, mods, dev, mesh) -> dict:
    """The mesh phase's training run sharded for ZeRO-3: the lines of
    ``launch.train.setup`` (the whole draw from the seed, the launcher's
    masks on the whole leaves, then this rank's shard) with the specs of
    ``params_shardings(..., fsdp=True)``, as ``specs.build_cell``'s train
    cells take them."""
    train, sharding, opt_mod = mods["train"], mods["sharding"], mods[
        "optimizer"]
    args = _mesh_train_args(mods)
    cfg = train.run_config(args)
    opt = opt_mod.AdamW(lr=opt_mod.cosine_schedule(args.lr, args.warmup,
                                                   args.steps))
    params = mods["transformer"].init_model(cfg, seed=args.seed, device=dev)
    masks = train.reference_masks(params, cfg, args.sparsity)
    params = opt_mod.apply_masks(params, masks)
    shardings = sharding.params_shardings(params, mesh, fsdp=True)
    params = sharding.shard_params(params, mesh, fsdp=True)
    masks = sharding.shard_params(masks, mesh, fsdp=True)
    state = mods["train_loop"].TrainState(
        params, opt.init(params), torch.zeros((), dtype=torch.int32,
                                              device=dev))
    stream = mods["data"].SyntheticLM(cfg.vocab, args.seq, args.batch,
                                      seed=args.seed,
                                      n_codebooks=cfg.n_codebooks)
    return dict(cfg=cfg, opt=opt, state=state, masks=masks,
                shardings=shardings, stream=stream)


def cells_rank(mesh, ref_tok: dict, work: str) -> dict:
    """One rank of the cells world (2x2): tinyllama-1.1b at 0.8 built
    with this rank's shard; the decode cell with the sequence over model
    and the batch over data, and the batch-1 cell with the sequence over
    data (first step teacher-forced with the unsharded first tokens, the
    step's LSCD launch list, ``engine.generate``'s streams, every launch
    configuration held against its plain version); then one FSDP train
    step from the mesh phase's masked state sharded for ZeRO-3
    (``_fsdp_run``) against its unsharded step 1; and the dry run of the
    three cells as this rank."""
    import torch
    import torch.distributed as dist
    mods = load_mods()
    torch.backends.cuda.matmul.allow_tf32 = False
    serve, spmm, ft = mods["serve"], mods["spmm"], mods["ft"]
    train_loop, data, sharding = (mods["train_loop"], mods["data"],
                                  mods["sharding"])
    rank = dist.get_rank()
    dev = mods["mesh"].rank_device(mesh)
    cfg = _cells_config(mods)
    out = dict(rank=rank, coords=sharding.coordinates(mesh),
               dry=_dry_cells(torch, mods, rank))
    params, built = _in_turn(torch, lambda: serve.build(
        cfg, seed=SEED, sparsity=SPARSITY, device=dev, mesh=mesh))
    out["param_bytes"] = _leaf_bytes(sharding, params)
    out["max_nnz"] = [t.max_nnz for t in serve.tiled_csl_leaves(params)]
    prompts, lengths, one = _cells_prompts(torch, mods, cfg, dev)
    probe = LaunchProbe(spmm)
    with probe:
        for name, p, n, ss in (("decode", prompts, lengths, False),
                               ("one", one, torch.full((1,), CELLS_ONE,
                                                       device=dev), True)):
            probe.phase = name
            first = _cells_decode(torch, mods, params, cfg, p, n,
                                  torch.from_numpy(ref_tok[name]), mesh, ss)
            out[name] = dict(step=first["step"].numpy(),
                             tok=first["tok"].numpy(),
                             launches_step=first["launches"],
                             cache_bytes=first["cache_bytes"],
                             seq=first["seq"],
                             **_cells_generate(torch, mods, params, cfg, p,
                                               n, mesh, ss))
    out["checked"] = len(_check_served_launches(
        torch, mods, probe.seen, cfg, label=f"cells: rank {rank}"))
    del params, probe, built
    release(torch)
    # the ZeRO-3 step: the launcher's masked state, sharded for FSDP
    torch.cuda.reset_peak_memory_stats()
    run = _in_turn(torch, lambda: _fsdp_run(torch, mods, dev, mesh))
    state, masks, shardings = run["state"], run["masks"], run["shardings"]
    out["state_bytes"] = dict(
        params=_leaf_bytes(sharding, state.params),
        mu=_leaf_bytes(sharding, state.opt_state.mu),
        nu=_leaf_bytes(sharding, state.opt_state.nu))
    step_fn = train_loop.make_train_step(run["cfg"], run["opt"], masks=masks,
                                         mesh=mesh, shardings=shardings,
                                         fsdp=True)
    at = (mesh.get_local_rank("data"), mesh.size(0))
    batch = train_loop.batch_to(
        data.batch_slice(run["stream"].next_batch(), *at), dev)
    before = _host_params(ft, state.params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = step_fn(state, batch)
    loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
    step_s = time.perf_counter() - t0
    want = torch.load(os.path.join(work, "step1_params.pt"), mmap=True)
    out["train"] = dict(
        loss=loss, grad_norm=gnorm, step_s=step_s,
        peak_allocated=torch.cuda.max_memory_allocated(),
        masked_nonzero=_masked_nonzeros(torch, ft, state.params, masks),
        **_update_gap(torch, ft, state.params,
                      lambda path: sharding.shard_leaf(
                          want[path], shardings[path], mesh),
                      before, float(run["opt"].lr(1))))
    del want, before, state, masks, step_fn, run, batch, metrics
    release(torch)
    dist.barrier()
    return out


def _cells_streams(check_label, got, want, margins_of) -> list:
    """Rows whose stream parts from the unsharded one, each at a near tie
    of the unsharded run (else a failure): [(row, token, margin)]."""
    import numpy as np
    cut = []
    for row in range(want.shape[0]):
        diff = np.nonzero(got[row] != want[row])[0]
        if not len(diff):
            continue
        i = int(diff[0])
        margin = float(margins_of(i)[row])
        check(margin < NEAR_TIE, f"{check_label}: request {row} parts from "
              f"the unsharded stream at token {i}, where its top-2 margin "
              f"is {margin:.3e} (a near tie is below {NEAR_TIE:.1e})")
        cut.append((row, i, margin))
    return cut


def _compare_bytes(label, got: dict, want: dict) -> int:
    """Every leaf's per-rank elements and bytes an element, the executed
    against the dry run's; returns how many leaves were held."""
    for path, (elems, width) in want.items():
        check(got.get(path) == (elems, width), f"{label}: {path} holds "
              f"{got.get(path)} (elements, bytes an element) on the rank, "
              f"the dry run predicts {(elems, width)}")
    return len(want)


# Where the reference's dry-run struct (``launch.specs``) and its serving
# build (``launch.serve``) differ, the port copies both: the struct
# encodes lm_head as Tiled-CSL and holds every leaf in the step's dtype;
# the build keeps lm_head dense and the norm scales f32, as drawn.
HEAD = "['lm_head']['w']"
NORM_SCALE = re.compile(r"norm'\]\['scale'\]$")


def _compare_params(label, got: dict, want: dict, head_elems: int,
                    known: set) -> int:
    """A decode cell's params, the built rank's against the dry run's:
    every dense leaf's elements and bytes equal, but for the two known
    differences of struct and build, each held to be exactly that: a
    norm scale (its elements equal, 2 B an element in the struct, 4 B
    built) and lm_head (Tiled-CSL in the struct, a dense bf16 shard of
    ``head_elems`` built). Tiled-CSL words and counters are the build's
    own grouping and ``max_nnz`` (their ratio is printed), not held.
    Adds the known differences met to ``known``; returns the leaves
    held."""
    csl = (".words", ".nnz")
    n = 0
    for path, (elems, width) in want.items():
        if path.endswith(csl):
            continue
        if NORM_SCALE.search(path):
            check(width == 2 and got.get(path) == (elems, 4), f"{label}: "
                  f"{path} holds {got.get(path)} on the rank, the dry run "
                  f"{(elems, width)}: not the known f32-against-bf16 norm "
                  f"scale")
            known.add(("norm scale", re.sub(r"\['layers'\]\[\d+\]",
                                            "['layers'][*]", path)))
            continue
        n += _compare_bytes(label, got, {path: (elems, width)})
    check(HEAD + ".words" in want and got.get(HEAD) == (head_elems, 2),
          f"{label}: lm_head is {got.get(HEAD)} on the rank and "
          f"{'Tiled-CSL' if HEAD + '.words' in want else 'dense'} in the "
          f"dry run: not the known dense-against-Tiled-CSL head")
    known.add(("lm_head", HEAD))
    extra = sorted(p for p in got if not p.endswith(csl) and p not in want
                   and p != HEAD)
    check(not extra, f"{label}: the rank holds {extra}, which the dry run "
          f"does not")
    return n


def _split_head(rows: list, head_mk: tuple) -> tuple:
    """The dry run's launch rows of a decode step as (the rows the
    serving build runs, the lm_head's one launch, which it does not)."""
    head = [r for r in rows if "grouped" not in r["kernel"]
            and (r["m"], r["k"]) == head_mk]
    check(len(head) == 1 and head[0]["count"] == 1, f"cells: the dry run "
          f"predicts {head} for lm_head, not one launch")
    rest = sorted((r["kernel"], r["m"], r["k"], r["n"], r["s"], r["count"])
                  for r in rows if r is not head[0])
    return rest, head[0]


def cells_phase(torch, mods) -> dict:
    """The dry-run sweep's counts (``finish_sweep`` held its gates); the
    dry run of the executed cells with no card memory allocated; then
    the cells world."""
    import numpy as np
    card = card_line()
    print(f"cells: {card}", flush=True)
    spmm, sharding, budget = mods["spmm"], mods["sharding"], mods["budget"]
    sweep = mods.pop("sweep")
    n = sweep["counts"]
    print(f"cells: the sweep's {n['ok'] + n['error']} cells (run with the "
          f"build): {n['ok']} built and {n['error']} errors, "
          f"{n.get(SPARSE_TRAIN_ITEM, 0)} naming {SPARSE_TRAIN_ITEM} (train "
          f"x sparse_xla); every family's prefill, decode, long_500k and "
          f"dense train cells ok", flush=True)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    dry = _dry_cells(torch, mods)
    after = torch.cuda.memory_allocated()
    check(after == before, f"cells: the dry run of the executed cells "
          f"allocated {after - before} B on the card")
    print(f"cells: dry run of the executed cells on a dry 2x2 mesh: "
          f"per-rank bytes {json.dumps({k: v['arg_bytes'] for k, v in dry.items()})}"
          f"; card memory allocated {before} B before and {after} B after",
          flush=True)
    ref = _cells_reference(torch, mods)
    for name in ("decode", "one"):
        r = ref[name]
        print(f"cells: unsharded {CELLS_ARCH} {name}: prefill "
              f"{r['prefill_ms']:.1f} ms, decode {r['decode_ms_per_step']:.3f}"
              f" ms/step; {card}", flush=True)
    work = mods.pop("mesh_train_work")
    try:
        t0 = time.perf_counter()
        ranks = mods["mesh"].run_world(
            cells_rank, CELLS_SHAPE, device=MESH_DEVICE,
            args=({k: v["tok"] for k, v in ref.items()}, work))
        world_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = dict(card=card, sweep=sweep, world_s=world_s, dry=dry, cells={})
    for name in ("decode", "one"):
        w = ref[name]
        got = [r[name] for r in ranks]
        for g in got[1:]:
            check(np.array_equal(g["streams"], got[0]["streams"]),
                  f"cells: {name}: the ranks' streams differ")
        err = close(torch, torch.from_numpy(got[0]["step"]), w["step"],
                    dict(rtol=CELLS_TOL, atol=CELLS_TOL),
                    f"cells: {name}: first decode-step logits on 2x2 vs "
                    f"unsharded")
        ties = [(int(i), float(w["first_margins"][i]))
                for i in np.nonzero(got[0]["tok"] != w["tok"])[0]]
        check(all(m < NEAR_TIE for _, m in ties), f"cells: {name}: first "
              f"tokens differ from unsharded at {ties}")
        cut = _cells_streams(f"cells: {name}", got[0]["streams"],
                             w["streams"], lambda i: w["margins"][i])
        want_seq = "model" if name == "decode" else "data"
        check(all(g["seq"] == want_seq for g in got),
              f"cells: {name}: cache layout {got[0]['seq']}, not the "
              f"sequence over {want_seq}")
        # the dry run against what ran: per-leaf bytes, launch list
        ccfg = _cells_config(mods)
        head_mk = (ccfg.vocab // CELLS_SHAPE[1], ccfg.d_model)
        held, known = 0, set()
        for r in ranks:
            d = r["dry"][name]["bytes"]
            held += _compare_bytes(f"cells: {name}: rank {r['rank']} cache",
                                   r[name]["cache_bytes"], d["cache"])
            held += _compare_params(
                f"cells: {name}: rank {r['rank']} params", r["param_bytes"],
                d["params"], head_mk[0] * head_mk[1], known)
        dry_launch, head = _split_head(ranks[0]["dry"][name]["lscd"],
                                       head_mk)
        for r in ranks:
            ran = [tuple(x) for x in r[name]["launches_step"]]
            check(ran == dry_launch, f"cells: {name}: rank {r['rank']}'s "
                  f"decode step launched {ran}, the dry run predicts "
                  f"{dry_launch} beside lm_head's")
        predicted_ms = sum(x["predicted_s"] * x["count"]
                           for x in ranks[0]["dry"][name]["lscd"]) * 1e3
        out["cells"][name] = dict(
            max_abs_err=err, tol=CELLS_TOL, first_token_ties=ties, cut=cut,
            prefill_ms=[g["prefill_ms"] for g in got],
            decode_ms_per_step=[g["decode_ms_per_step"] for g in got],
            unsharded_prefill_ms=w["prefill_ms"],
            unsharded_decode_ms_per_step=w["decode_ms_per_step"],
            launches=[g["launches"] for g in got], leaves_held=held,
            known_differences=sorted(known), launch_list=dry_launch,
            head_launch=head, predicted_ms=predicted_ms)
        print(f"cells: {name} ({'sequence over model, batch over data' if name == 'decode' else 'batch 1, sequence over data, KV heads over model'}"
              f"): first decode-step logits vs unsharded max abs err "
              f"{err:.3e} (tolerance {CELLS_TOL:.4f}); "
              f"{len(w['streams']) - len(cut)} of {len(w['streams'])} "
              f"streams of {CELLS_NEW} equal, {len(cut)} parted at a near "
              f"tie {json.dumps([[r, i, round(m, 5)] for r, i, m in cut])};"
              f" rank 0 prefill {got[0]['prefill_ms']:.1f} ms, decode "
              f"{got[0]['decode_ms_per_step']:.3f} ms/step (unsharded "
              f"{w['prefill_ms']:.1f} ms, {w['decode_ms_per_step']:.3f} "
              f"ms/step); {card}", flush=True)
        print(f"cells: {name}: the dry run (the reference's dry-run "
              f"program) against what ran: {held} leaves' per-rank "
              f"elements and bytes equal; its LSCD launch list equal to each "
              f"rank's decode step ({sum(x[-1] for x in dry_launch)} "
              f"launches) but for lm_head's {head['kernel']} "
              f"{head['m']}x{head['k']} N={head['n']} S={head['s']}; known "
              f"differences of the dry-run struct and the serving build, "
              f"not held: {json.dumps(sorted(known))} (lm_head Tiled-CSL in "
              f"the struct, dense as built; norm scales bf16 in the struct, "
              f"f32 as built); predicted LSCD time (schedule.predicted, "
              f"H100 roofline) {predicted_ms:.3f} ms a step, "
              f"{head['predicted_s'] * 1e3:.3f} ms of it lm_head's",
              flush=True)
    # the ZeRO-3 step
    train_ref = mods.pop("mesh_train_ref")
    rel = lambda a, b: abs(a - b) / abs(b)
    for r in ranks:
        t = r["train"]
        for what, a, b in (("loss", t["loss"], train_ref["loss"]),
                           ("grad norm", t["grad_norm"],
                            train_ref["grad_norm"])):
            check(rel(a, b) <= MESH_TRAIN_TOL, f"cells: FSDP step {what} "
                  f"{a} on rank {r['rank']} vs {b} unsharded: "
                  f"{rel(a, b):.3e} relative")
        check(t["param_err"] <= MESH_TRAIN_TOL, f"cells: FSDP step: rank "
              f"{r['rank']}'s {t['param_err_leaf']} off the unsharded step "
              f"by {t['param_err']:.3e}")
        check(t["update_miss"] <= UPDATE_MISS_TOL, f"cells: FSDP step: rank "
              f"{r['rank']}'s update of {t['update_miss_leaf']} misses on "
              f"{t['update_miss']:.3e} of the moved elements")
        check(t["masked_nonzero"] == 0, f"cells: FSDP step: rank "
              f"{r['rank']} has {t['masked_nonzero']} masked weights "
              f"nonzero")
        d = r["dry"]["train"]["bytes"]
        for g in ("params", "mu", "nu"):
            _compare_bytes(f"cells: train: rank {r['rank']} {g}",
                           r["state_bytes"][g], d[g])
    analytic = budget.analytic_max_nnz(SPARSITY)
    nnz = np.array([x for r in ranks for x in r["max_nnz"]], dtype=float)
    t0 = ranks[0]["train"]
    total = lambda leaves: sum(n * w for n, w in leaves.values())
    per_rank = [dict(rank=r["rank"],
                     params=total(r["state_bytes"]["params"]),
                     optimizer=total(r["state_bytes"]["mu"])
                     + total(r["state_bytes"]["nu"]),
                     peak=r["train"]["peak_allocated"]) for r in ranks]
    out["train"] = dict(loss=t0["loss"], grad_norm=t0["grad_norm"],
                        loss_rel=rel(t0["loss"], train_ref["loss"]),
                        grad_norm_rel=rel(t0["grad_norm"],
                                          train_ref["grad_norm"]),
                        param_err=max(r["train"]["param_err"] for r in ranks),
                        step_s=[r["train"]["step_s"] for r in ranks],
                        per_rank=per_rank, tp_only_peak=TP_ONLY_PEAK)
    out["max_nnz"] = dict(analytic=analytic,
                          ratio_mean=float(nnz.mean() / analytic),
                          ratio_min=float(nnz.min() / analytic),
                          ratio_max=float(nnz.max() / analytic),
                          leaves=int(nnz.size))
    print(f"cells: FSDP (ZeRO-3) step of {CELLS_ARCH} at "
          f"{MESH_TRAIN_LAYERS} layers on 2x2 (batch {MESH_TRAIN_BATCH} x "
          f"{MESH_TRAIN_SEQ}, f32, 0.8 masks): loss "
          f"{t0['loss']:.6f} ({out['train']['loss_rel']:.2e} relative to the "
          f"mesh phase's unsharded step 1), grad norm "
          f"({out['train']['grad_norm_rel']:.2e}), params within "
          f"{out['train']['param_err']:.2e} (tolerance {MESH_TRAIN_TOL}), "
          f"masks held, ms/step "
          f"{json.dumps([round(s * 1e3, 1) for s in out['train']['step_s']])}"
          f"; per rank {json.dumps(per_rank)} B (params, AdamW moments, "
          f"peak allocated) beside the tensor-parallel-only step's "
          f"{TP_ONLY_PEAK} B peak at 22 layers (PERF.md); the dry run's "
          f"per-leaf bytes "
          f"equal on every rank; {card}", flush=True)
    print(f"cells: built max_nnz / analytic ({analytic}): mean "
          f"{out['max_nnz']['ratio_mean']:.4f}, min "
          f"{out['max_nnz']['ratio_min']:.4f}, max "
          f"{out['max_nnz']['ratio_max']:.4f} over "
          f"{out['max_nnz']['leaves']} Tiled-CSL leaves (the measured "
          f"IMBALANCE against 1.15)", flush=True)
    out["launches"] = {k: sum(r[n]["launches"][k] for r in ranks
                              for n in ("decode", "one"))
                       for k in spmm.KERNELS}
    out["checked"] = [r["checked"] for r in ranks]
    return out


# The full-depth phase holds 76.1e9 B of weights and pool and needs up
# to 1.9e9 B more for a decode step's attention on a card of 85.0e9 B.
# The caching allocator's default fixed segments left 5.3 GiB reserved but
# unallocated there and failed the step's first f32 copy (896 MiB);
# expandable segments grow in place (NVIDIA H100 80GB HBM3, 700 W).
ALLOC_CONF = "expandable_segments:True"


# The phases after the window phase, in order, by their summary's name.
PHASES = {"analysis": "analysis_phase", "full": "full_depth_phase",
          "tiny": "tinyllama_phase", "examples": "examples_phase",
          "mla": "mla_phase", "moe": "moe_phase", "hybrid": "hybrid_phase",
          "ssm": "ssm_phase", "vlm": "vlm_phase", "audio": "audio_phase",
          "train": "train_phase", "mesh": "mesh_phase",
          "cells": "cells_phase"}

# The train phase's resume check runs under deterministic algorithms,
# which need cuBLAS's workspace fixed before its first handle is made.
# This setting is the H100's default workspace (8 buffers of 4 MiB).
CUBLAS_WORKSPACE = ":4096:8"


def load_mods() -> dict:
    """The port's modules this script drives, by short name (the mesh
    phase's ranks load them again in their own processes)."""
    src = os.path.join(ROOT, "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    from repro_torch import configs, convert
    from repro_torch.analysis import (contracts, findings, kernel_pass, lint,
                                      obs_pass, trace_audit)
    from repro_torch.core import (pruning, roofline, sparse_linear,
                                  tiled_csl)
    from repro_torch.kernels import build, gemm, ops, ref, schedule, spmm
    from repro_torch.distributed import compression, sharding
    from repro_torch.distributed import fault_tolerance
    from repro_torch.distributed import tensor_parallel
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import serve, specs
    from repro_torch.launch import train as train_launch
    from repro_torch.models import (attention, layers, moe, ssm,
                                    transformer)
    from repro_torch.obs import profile as obs_profile
    from repro_torch.serving import (api, batching, budget, engine,
                                     loadgen, scheduler, speculative)
    from repro_torch.serving import config as serve_config
    from repro_torch.serving import step
    from repro_torch.training import data, optimizer, train_loop
    return dict(configs=configs, contracts=contracts, pruning=pruning,
                roofline=roofline, tiled_csl=tiled_csl, build=build, ops=ops,
                ref=ref, schedule=schedule, spmm=spmm, gemm=gemm, serve=serve,
                engine=engine, api=api, loadgen=loadgen, scheduler=scheduler,
                serve_config=serve_config, budget=budget,
                speculative=speculative, transformer=transformer,
                attention=attention, layers=layers, moe=moe, ssm=ssm,
                batching=batching, sparse_linear=sparse_linear,
                convert=convert, ft=fault_tolerance, train=train_launch,
                obs_profile=obs_profile, data=data, optimizer=optimizer,
                train_loop=train_loop, mesh=mesh_mod, sharding=sharding,
                compression=compression, tensor_parallel=tensor_parallel,
                dryrun=dryrun, specs=specs, findings=findings,
                kernel_pass=kernel_pass, lint=lint, obs_pass=obs_pass,
                trace_audit=trace_audit, step=step)


def _timed_phase(torch, mods, name: str) -> dict:
    t0 = time.perf_counter()
    out = globals()[PHASES[name]](torch, mods)
    out["phase_s"] = time.perf_counter() - t0
    built = out.get("build", {}).get("build_s")
    print(f"{name}: phase took {out['phase_s']:.1f} s"
          + (f" (build {built:.1f} s)" if built is not None else ""),
          flush=True)
    return out


def main() -> int:
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", ALLOC_CONF)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        mods = load_mods()
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    # The dry run of every production cell (cells_phase's sweep) runs on
    # the CPU beside the build, and ends before the first timed phase.
    allocated = torch.cuda.memory_allocated()
    sweep = start_sweep(mods)
    try:
        return _run(torch, mods, card, sweep, allocated)
    finally:
        sweep["pool"].shutdown(cancel_futures=True)


def _run(torch, mods, card: str, sweep: dict, allocated: int) -> int:
    """The build beside the sweep, then every phase, in order; the
    summary lines."""
    build, spmm = mods["build"], mods["spmm"]
    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {len(build.SOURCES)} kernel sources in "
          f"{time.perf_counter() - t0:.2f} s "
          f"(nvcc, sm_90a; the dry-run sweep's {sweep['workers']} workers "
          f"beside it at nice 19)", flush=True)
    dry_sweep = mods["sweep"] = finish_sweep(mods, sweep)
    check(torch.cuda.memory_allocated() == allocated, "cells: card memory "
          "was allocated during the dry-run sweep")
    print(f"cells: the sweep ended {dry_sweep['wall_s']:.1f} s after it "
          f"began with the build, in {dry_sweep['workers']} worker processes"
          f" that saw no card; its cells took "
          f"{json.dumps({k: round(v, 1) for k, v in dry_sweep['cell_seconds'].items()})}"
          f" s a weight mode; card memory allocated {allocated} B before and "
          f"after", flush=True)
    ptxas = {}
    for name in build.SOURCES:
        log = build.build_dir() / f"{name}.log"
        if log.exists():
            ptxas[name] = ptxas_report(log.read_text())
            print(f"build: {name}: by body, kernels with spills and ptxas "
                  f"warnings {json.dumps(ptxas[name])}")
    bad = {f"{name}/{body}": {c: n for c, n in r.items() if n}
           for name, report in ptxas.items() for body, r in report.items()
           if body in WGMMA_BODIES and any(r.values())}
    check(not bad, f"ptxas spills or warns in a wgmma body: {bad}")

    n = small_checks(torch, mods)
    print(f"kernels: {n} small-shape checks against the plain versions "
          f"passed (incl. split-K S=1 bit-match)", flush=True)
    flush = torch.empty(2 ** 28, dtype=torch.int32, device="cuda")
    rows, best, compare, sweep, rings, gemm_launches = opt_shapes(
        torch, mods, flush)
    del flush
    mods["kernel_rows"] = rows
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    rep, counts, built, prof, params, cfg = slice_phase(torch, mods)
    t0 = time.perf_counter()
    serving, serve_phases, plain = serving_phase(torch, mods, params, cfg)
    serving["phase_s"] = time.perf_counter() - t0
    print(f"serving: phase took {serving['phase_s']:.1f} s", flush=True)
    t0 = time.perf_counter()
    window, window_phases = window_phase(torch, mods, params, cfg, plain)
    window["phase_s"] = time.perf_counter() - t0
    print(f"window: phase took {window['phase_s']:.1f} s", flush=True)
    rep.pop("params")
    mods["slice_model"] = (params, cfg)     # the analysis phase's model
    del params
    (analysis, full, tiny, examples, mla, moe_out, hybrid, ssm_out, vlm,
     audio, train, mesh, cells) = (_timed_phase(torch, mods, name)
                                   for name in PHASES)

    kernels = []
    serve_counts = {k: serve_phases["prefill"][k] + serve_phases["decode"][k]
                    for k in spmm.KERNELS}
    full_counts = full["serve"]["launches"]
    tiny_counts = tiny["serve"]["launches"]
    mla_counts = mla["launches"]
    moe_counts = moe_out["launches"]
    hybrid_counts = hybrid["launches"]
    ring_counts = hybrid["ring"]["launches"]
    (analysis_counts, examples_counts, ssm_counts, vlm_counts, audio_counts,
     train_counts, mesh_counts, cells_counts) = (r["launches"] for r in (
         analysis, examples, ssm_out, vlm, audio, train, mesh, cells))
    window_counts = {k: sum(window_phases[op][k] for op in STEP_OPS)
                     for k in spmm.KERNELS}
    launches = {k: counts[k] + serve_counts[k] + window_counts[k]
                + analysis_counts[k] + full_counts[k] + tiny_counts[k]
                + examples_counts[k] + mla_counts[k]
                + moe_counts[k] + hybrid_counts[k] + ring_counts[k]
                + ssm_counts[k] + vlm_counts[k] + audio_counts[k]
                + train_counts[k] + mesh_counts[k] + cells_counts[k]
                for k in spmm.KERNELS}
    launches["dense_gemm"] = gemm_launches
    best.update(moe_out["kernel_rows"])
    for name in spmm.KERNELS + ("dense_gemm",):
        r = best[name]
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{name}.cu",
            replaces=SOURCES[name], launches=launches[name],
            launches_slice=counts.get(name, 0),
            launches_serving=serve_counts.get(name, 0),
            launches_serving_prefill=serve_phases["prefill"].get(name, 0),
            launches_serving_decode=serve_phases["decode"].get(name, 0),
            launches_window=window_counts.get(name, 0),
            launches_window_verify=window_phases["verify"].get(name, 0),
            launches_window_mixed=window_phases["mixed"].get(name, 0),
            launches_analysis=analysis_counts.get(name, 0),
            launches_full_depth=full_counts.get(name, 0),
            launches_tinyllama=tiny_counts.get(name, 0),
            launches_examples=examples_counts.get(name, 0),
            launches_mla=mla_counts.get(name, 0),
            launches_mla_verify=mla["launches_by_phase"].get(
                "verify", {}).get(name, 0),
            launches_moe=moe_counts.get(name, 0),
            launches_moe_decode=moe_out["launches_by_phase"].get(
                "decode", {}).get(name, 0),
            launches_hybrid=hybrid_counts.get(name, 0),
            launches_hybrid_decode=hybrid["launches_by_phase"].get(
                "decode", {}).get(name, 0),
            launches_ring=ring_counts.get(name, 0),
            launches_ssm=ssm_counts.get(name, 0),
            launches_vlm=vlm_counts.get(name, 0),
            launches_audio=audio_counts.get(name, 0),
            launches_train=train_counts.get(name, 0),
            launches_mesh=mesh_counts.get(name, 0),
            launches_mesh_per_rank=mesh["serving"][
                "launches_per_rank"].get(name, 0),
            launches_mesh_families=mesh["families"]["launches"].get(name, 0),
            launches_cells=cells_counts.get(name, 0),
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"]))
    slice_summary = dict(
        prefill_ms=rep["prefill_s"] * 1e3,
        decode_ms_per_step=rep["decode_ms_per_step"],
        tokens_per_s=rep["tokens_per_s"], encode_s=built["encode_s"],
        sparse_bytes=built["sparse_bytes"], dense_bytes=built["dense_bytes"],
        launches=counts)
    summary = dict(card=card, ptxas=ptxas, rows=rows, compare=compare,
                   sweep=sweep, rings=rings, kernels=kernels,
                   slice=slice_summary, profile=prof, serving=serving,
                   window=window, analysis=analysis, full_depth=full,
                   tinyllama=tiny, examples=examples, mla=mla,
                   moe=moe_out, hybrid=hybrid, ssm=ssm_out, vlm=vlm,
                   audio=audio, train=train, mesh=mesh, cells=cells)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
