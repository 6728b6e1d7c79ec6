#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the numbers it prints). In order it

1. prints the card's name and power limit and builds the five CUDA
   kernels (four LSCD SpMM kernels and the dense GEMM baseline) from
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
   it, the whole block map, for comparison);
5. full-depth phase: prints the planner's sparse and dense plans for
   OPT-30B, OPT-66B and OPT-175B at 80 GB (``serving.budget``), builds
   OPT-30B at all 48 layers layer by layer (``serve.build``), prints its
   built against its planned weight bytes, holds the first decode step
   against the plain path at 4, 12, 24 and 48 layers
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
6. tinyllama phase: tinyllama_1_1b at full size served through the same
   server (16 slots, max_len 512, 16 requests, 32 new tokens): GQA and
   the grouped ``gate_up`` ``silu_mul`` launch on a served path, every
   launch configuration against its plain version, and the first decode
   step against the plain path;
7. prints the kernels' JSON line (launches of the slice, the serving
   runs, the full-depth run and the tinyllama run, the serving ones also
   by prefill and decode), the card line, and last
   ``{"ok": true, "device": {...}}``; the
   full summary goes to ``chiprun_out/chip_smoke.json``.

Any failure raises and exits non-zero. The plain versions run with
``torch.backends.cuda.matmul.allow_tf32 = False`` (full f32 matmuls).
The script sets ``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True``
unless the environment sets it (``ALLOC_CONF``).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
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
    missing = [k for k, v in counts.items() if v == 0]
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
            key = (name, tuple(t.shape), t.group or 1, int(b.shape[1]),
                   kw["n_tb"], kw.get("split_k", 1),
                   kw.get("epilogue", "none"), bias is not None,
                   b.dtype, kw.get("out_dtype") or b.dtype,
                   self.phase)
            self.seen.setdefault(key, (t, bias))
            return fn(t, b, **kw)
        return probed


def _instrument(stepper, spmm, probe=None) -> dict:
    """Wrap ``stepper.prefill`` and ``stepper.decode``: record each decode
    call's host time (it ends in a device synchronise: the tokens come
    back to the host), add each call's LSCD launches (graph replays
    counted) to its phase's tally, and tell ``probe`` which phase is
    launching."""
    out = dict(decode_s=[], launches={"prefill": dict.fromkeys(
        spmm.KERNELS, 0), "decode": dict.fromkeys(spmm.KERNELS, 0)})

    def wrap(phase, inner):
        def call(*args):
            if probe is not None:
                probe.phase = phase
            before = spmm.launch_counts()
            t0 = time.perf_counter()
            res = inner(*args)
            if phase == "decode":
                out["decode_s"].append(time.perf_counter() - t0)
            after = spmm.launch_counts()
            for k in after:
                out["launches"][phase][k] += after[k] - before[k]
            return res
        return call
    stepper.prefill = wrap("prefill", stepper.prefill)
    stepper.decode = wrap("decode", stepper.decode)
    return out


def _check_served_launches(torch, mods, seen, cfg,
                           label: str = "serving") -> list:
    """Each launch configuration the probe saw on the serving path, held
    against the kernel's plain version (the split-K pair against the
    split-K reference, which sums the same slices) on the same weight and
    bias and a fresh B on the card of the recorded shape and dtype."""
    ref, spmm = mods["ref"], mods["spmm"]
    d, f, kvd = cfg.d_model, cfg.d_ff, cfg.n_kv * cfg.head_dim
    names = {((d, d), 3): "wqkv", ((d, d), 1): "wo", ((f, d), 1): "up",
             ((d, f), 1): "down", ((f, d), 2): "gate_up",
             ((kvd, d), 2): "wk+wv"}
    names.setdefault(((kvd, d), 1), "wk")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)
    rows = []
    for key in sorted(seen, key=lambda k: (str(k[-1]), k[3], k[:3])):
        name, (m, k), g, n, n_tb, sk, epi, _, b_dtype, out_dtype, phase = key
        t, bias = seen[key]
        b = (0.1 * torch.randn((k, n), generator=gen, device="cuda")).to(
            b_dtype)
        kw = dict(out_dtype=out_dtype, epilogue=epi, bias=bias)
        grouped = name.endswith("grouped")
        if "splitk" in name:
            got = getattr(spmm, name)(t, b, n_tb=n_tb, split_k=sk, **kw)
            want = (ref.spmm_splitk_grouped_ref if grouped
                    else ref.spmm_splitk_ref)(t, b, sk, **kw)
        else:
            got = getattr(spmm, name)(t, b, n_tb=n_tb, **kw)
            want = (ref.spmm_grouped_ref if grouped
                    else ref.spmm_ref)(t, b, **kw)
        shape = names.get(((m, k), g), f"{m}x{k} G={g}")
        tol = BF16_TOL if b_dtype == torch.bfloat16 else F32_TOL
        err = close(torch, got, want, tol, f"{label} path: {name} at "
                    f"{shape} N={n} n_tb={n_tb} S={sk} {epi} ({phase})")
        rows.append(dict(kernel=name, shape=shape, m=m, k=k, group=g, n=n,
                         n_tb=n_tb, split_k=sk, epilogue=epi, phase=phase,
                         max_abs_err=err))
        print(f"{label}: checked {phase:7s} {name:25s} {shape:5s} N={n:<5d}"
              f" n_tb={n_tb:<3d} S={sk:<2d} {epi:8s} max err {err:.2e}",
              flush=True)
        del b, got, want
    torch.cuda.synchronize()
    return rows


def _closed_loop(torch, mods, params, cfg, prompts, probe, *, paged, graph,
                 config=None, new=SERVE_NEW, label="serving"):
    """Drain ``prompts`` (``new`` greedy new tokens each) through one
    ``StreamingServer`` (``config``, default the serving phase's).
    Returns the server and its measurements."""
    api, scheduler = mods["api"], mods["scheduler"]
    if config is None:
        config = _serve_config(mods, paged=paged)
    server = api.StreamingServer(params, cfg, config=config, graph=graph)
    inst = _instrument(server.batcher.stepper, mods["spmm"], probe)
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
    steady = sorted(times[1:])          # the first call captures the graph
    out = dict(
        paged=paged, graph=graph, wall_s=wall, completed=len(responses),
        tokens=sum(len(t) for t in streams.values()),
        tokens_per_s=sum(len(t) for t in streams.values()) / wall,
        decode_steps=len(times), first_decode_ms=times[0] * 1e3,
        decode_ms_per_step=sum(steady) / len(steady) * 1e3,
        decode_ms_median=steady[len(steady) // 2] * 1e3,
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
    eager decode step. Returns the phase's summary and the kernels'
    launches on the serving path (the dense graphed run)."""
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
        missing = [k for k, v in counts.items() if v == 0]
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
    checked = _check_served_launches(torch, mods, probe.seen, cfg)
    print(f"serving: {len(checked)} launch configurations of the serving "
          f"path held against the plain versions", flush=True)
    summary = dict(closed_loop={"dense_graph": run_g, "dense_eager": run_e,
                                "paged_graph": run_p},
                   open_loop=open_loop, logits_max_abs_err=err,
                   shared_prefix=prefix, profile=profile, launches=counts,
                   launches_by_phase=by_phase, checked_launches=checked)
    return summary, by_phase


def _shared_prefix(torch, mods, params, cfg) -> dict:
    """Whether a later admission rewrites prompt blocks that a request in
    flight shares. Request A (32 tokens: two full blocks, the 32-token
    bucket, so prefill N = 4 x 32 = 128, where ``select`` splits K) is
    admitted alone and decodes once; then B, A's 32 tokens and 400 more
    (the 512-token bucket: N = 2048, single pass), is admitted on the same
    paged server and maps A's two blocks as prefix hits. Compares those
    blocks' bits in every cache leaf before and after B's admission, and
    A's greedy stream against a run without B: as the port writes
    (``AdmissionPlan.write_targets``), and, for comparison, as the
    reference writes (the plan's whole block map, ``targets``)."""
    import numpy as np
    api, plan_cls = mods["api"], mods["scheduler"].AdmissionPlan
    rng = np.random.default_rng(SEED + 3)
    a = rng.integers(0, cfg.vocab, 32).astype(np.int64)
    b = np.concatenate([a, rng.integers(0, cfg.vocab, 400).astype(np.int64)])

    def run(with_b: bool) -> dict:
        server = api.StreamingServer(params, cfg,
                                     config=_serve_config(mods, paged=True))
        server.submit(api.GenerationRequest(a, SERVE_NEW, session_id="a"))
        server.step()                   # admits A, decodes once
        bt = server.batcher
        (slot,) = bt.sched.active_slot_ids()
        shared = list(bt.sched.tables[slot].blocks[:2])
        idx = torch.tensor(shared, device="cuda")
        leaves = [layer[n] for layer in bt.stepper.cache for n in ("k", "v")]
        before = [leaf[idx].clone() for leaf in leaves]
        res = {}
        if with_b:
            server.submit(api.GenerationRequest(b, SERVE_NEW,
                                                session_id="b"))
            server.step()               # admits B, decodes both
            other = [s for s in bt.sched.active_slot_ids() if s != slot]
            check(len(other) == 1 and list(
                bt.sched.tables[other[0]].blocks[:2]) == shared,
                "shared prefix: B does not map A's two prompt blocks")
            torch.cuda.synchronize()
            after = [leaf[idx] for leaf in leaves]
            res = dict(
                blocks=shared, prefix_hit_tokens=int(
                    bt.metrics.prefix_hit_tokens),
                buckets=sorted(bt.metrics.bucket_admits),
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
    saved = plan_cls.write_targets
    plan_cls.write_targets = lambda plan: plan.targets
    try:
        ref = run(True)
    finally:
        plan_cls.write_targets = saved
    release(torch)
    out.update(stream_same=out.pop("stream") == alone,
               reference=dict(elements_changed=ref["elements_changed"],
                              max_abs_change=ref["max_abs_change"],
                              stream_same=ref["stream"] == alone))
    for label, r in (("as the port writes", out),
                     ("as the reference writes", out["reference"])):
        print(f"serving: shared prefix, {label}: B (bucket "
              f"{out['buckets'][-1]}) mapped A's blocks {out['blocks']} "
              f"({out['prefix_hit_tokens']} hit tokens); "
              f"{r['elements_changed']} of {out['elements']} cache elements "
              f"of those blocks changed at B's admission (max abs change "
              f"{r['max_abs_change']:.3e}); A's stream "
              f"{'equals' if r['stream_same'] else 'differs from'} its run "
              f"without B", flush=True)
    return out


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
    tokens must agree. Returns (kernels' logits, plain logits), f32."""
    steps = {}
    S = prompts.shape[1]
    with torch.inference_mode():
        for backend in ("cuda", "torch"):
            last, cache = engine.prefill(params, prompts, cfg, S + 1,
                                         backend=backend)
            tok = torch.argmax(last, dim=-1)[:, None]
            logits, _ = engine.serve_step(params, cache, tok, S, cfg,
                                          backend=backend)
            steps[backend] = (tok, logits.float())
            del cache, last
    check(torch.equal(steps["cuda"][0], steps["torch"][0]),
          f"{cfg.n_layers} layers: first token differs between kernels and "
          "plain versions")
    return steps["cuda"][1], steps["torch"][1]


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
# tinyllama's 22. The 4-layer checks keep LOGITS_TOL.
DEPTH_SWEEP = (4, 12, 24, 48)


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
        got, want = _logits_vs_plain(
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
    missing = [k for k, v in counts.items() if v == 0]
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


# The full-depth phase holds 76.1e9 B of weights and pool and needs up
# to 1.9e9 B more for a decode step's attention on a card of 85.0e9 B.
# The caching allocator's default fixed segments left 5.3 GiB reserved but
# unallocated there and failed the step's first f32 copy (896 MiB);
# expandable segments grow in place (NVIDIA H100 80GB HBM3, 700 W).
ALLOC_CONF = "expandable_segments:True"


def main() -> int:
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", ALLOC_CONF)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch import configs
        from repro_torch.analysis import contracts
        from repro_torch.core import pruning, roofline, tiled_csl
        from repro_torch.kernels import build, gemm, ops, ref, schedule, spmm
        from repro_torch.launch import serve
        from repro_torch.serving import (api, budget, engine, loadgen,
                                         scheduler)
        from repro_torch.serving import config as serve_config
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    mods = dict(configs=configs, contracts=contracts, pruning=pruning,
                roofline=roofline, tiled_csl=tiled_csl, build=build, ops=ops,
                ref=ref, schedule=schedule, spmm=spmm, gemm=gemm, serve=serve,
                engine=engine, api=api, loadgen=loadgen, scheduler=scheduler,
                serve_config=serve_config, budget=budget)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {len(build.SOURCES)} kernel sources in "
          f"{time.perf_counter() - t0:.2f} s "
          f"(nvcc, sm_90a)", flush=True)
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
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    rep, counts, built, prof, params, cfg = slice_phase(torch, mods)
    t0 = time.perf_counter()
    serving, serve_phases = serving_phase(torch, mods, params, cfg)
    serving["phase_s"] = time.perf_counter() - t0
    print(f"serving: phase took {serving['phase_s']:.1f} s", flush=True)
    rep.pop("params")
    del params
    release(torch)
    t0 = time.perf_counter()
    full = full_depth_phase(torch, mods)
    full["phase_s"] = time.perf_counter() - t0
    print(f"full depth: phase took {full['phase_s']:.1f} s (build "
          f"{full['build']['build_s']:.1f} s)", flush=True)
    t0 = time.perf_counter()
    tiny = tinyllama_phase(torch, mods)
    tiny["phase_s"] = time.perf_counter() - t0
    print(f"tinyllama: phase took {tiny['phase_s']:.1f} s", flush=True)

    kernels = []
    serve_counts = {k: serve_phases["prefill"][k] + serve_phases["decode"][k]
                    for k in spmm.KERNELS}
    full_counts = full["serve"]["launches"]
    tiny_counts = tiny["serve"]["launches"]
    launches = {k: counts[k] + serve_counts[k] + full_counts[k]
                + tiny_counts[k] for k in spmm.KERNELS}
    launches["dense_gemm"] = gemm_launches
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
            launches_full_depth=full_counts.get(name, 0),
            launches_tinyllama=tiny_counts.get(name, 0),
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
                   full_depth=full, tinyllama=tiny)
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
