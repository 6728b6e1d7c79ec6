"""Serving launcher (CLI) of the port: continuous batching over a
(optionally Tiled-CSL sparse) model on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch opt_30b --smoke --sparsity 0.8 --slots 4 --paged

Builds the model from ``--seed``, optionally prunes and reformats its
projections to Tiled-CSL on the device (``lm_head`` stays dense, as in
the JAX launcher), then serves a synthetic workload through the session
API (``serving.api.StreamingServer`` over the continuous batcher, its
decode step a CUDA graph), reporting tokens/s, TTFT/TPOT percentiles and
the weight-bytes saving. Default is a closed-loop drain; ``--trace-rate
R`` switches to an open-loop Poisson trace (``serving.loadgen``) at R
requests per engine step. The flags are those of ``repro.launch.serve``
whose modules are ported (ROADMAP.md lists the rest).

``run`` serves one fixed batch through ``engine.generate`` instead (the
slice that ``chip_smoke.py`` drives and profiles).
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import pruning, tiled_csl
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.models import transformer
from repro_torch.serving import api, engine, loadgen
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.scheduler import latency_summary

SPARSE_NAMES = ("'wq'", "'wk'", "'wv'", "'wo'", "'gate'", "'up'", "'down'")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def tiled_csl_leaves(tree):
    if isinstance(tree, tiled_csl.TiledCSL):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tiled_csl_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tiled_csl_leaves(v)]
    return []


def build(cfg, *, seed: int = 0, sparsity: Optional[float] = None,
          balanced: bool = False, device: DeviceLike = None):
    """Random params on ``device``, pruned and reformatted to Tiled-CSL
    when ``sparsity`` is given. Returns (params, report dict)."""
    dev = resolve_device(device)
    params = transformer.init_model(cfg, seed=seed, device=dev)
    report = {"encode_s": 0.0, "sparse_bytes": 0, "dense_bytes": 0,
              "n_tiled_csl": 0}
    if sparsity:
        _sync(dev)
        t0 = time.perf_counter()
        params = pruning.sparsify_params(
            params, sparsity,
            should_sparsify=lambda n: any(k in n for k in SPARSE_NAMES),
            balanced=balanced)
        params = pruning.group_projections(params)
        _sync(dev)
        csl = tiled_csl_leaves(params)
        report.update(encode_s=time.perf_counter() - t0, n_tiled_csl=len(csl),
                      sparse_bytes=sum(t.nbytes_sparse for t in csl),
                      dense_bytes=sum(t.nbytes_dense for t in csl))
    # Dense 2-D weights are cast to the compute dtype once (the forward
    # would cast them on every call to the same values).
    dt = getattr(torch, cfg.dtype)
    params["embed"]["table"] = params["embed"]["table"].to(dt)
    if "lm_head" in params:
        params["lm_head"]["w"] = params["lm_head"]["w"].to(dt)
    return params, report


def make_prompts(cfg, requests: int, prompt_len: int, seed: int,
                 device) -> torch.Tensor:
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    return torch.randint(0, cfg.vocab, (requests, prompt_len),
                         generator=gen).to(device)


def run(cfg, *, requests: int = 8, prompt_len: int = 16, max_new: int = 16,
        seed: int = 0, sparsity: Optional[float] = None,
        balanced: bool = False, backend: str = "auto",
        device: DeviceLike = None, params=None) -> dict:
    """Build (unless ``params`` is given) and serve one batch; returns the
    tokens and the measured times."""
    dev = resolve_device(device)
    report = {}
    if params is None:
        params, report = build(cfg, seed=seed, sparsity=sparsity,
                               balanced=balanced, device=dev)
    prompts = make_prompts(cfg, requests, prompt_len, seed, dev)
    times: dict = {}
    tokens = engine.generate(params, prompts, cfg, max_new_tokens=max_new,
                             backend=backend, timings=times)
    n_new = requests * max_new
    report.update(
        tokens=tokens, prefill_s=times["prefill_s"],
        decode_s=times["decode_s"], decode_steps=max_new - 1,
        decode_ms_per_step=times["decode_s"] / max(max_new - 1, 1) * 1e3,
        tokens_per_s=n_new / (times["prefill_s"] + times["decode_s"]),
        params=params,
        schedules=dict(ops.SCHEDULES))
    return report


def main(argv: Optional[Sequence[str]] = None, *,
         device: DeviceLike = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--sparsity", type=float, default=None)
    ap.add_argument("--balanced", action="store_true",
                    help="tile-balanced pruning (zero pad overhead)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache with prefix sharing")
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV block positions (paged cache)")
    ap.add_argument("--n-blocks", type=int, default=None,
                    help="usable KV blocks; default: dense byte-equivalent")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--trace-rate", type=float, default=None, metavar="R",
                    help="open-loop mode: Poisson arrivals at R requests "
                         "per engine step (default: closed-loop drain)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="admission queue bound; beyond it submissions are "
                         "shed with backpressure (open-loop mode)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="total latency budget per request; missing it ends "
                         "the session with finish_reason='deadline'")
    ap.add_argument("--ttft-deadline-ms", type=float, default=None,
                    help="first-token latency budget per request")
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "cuda", "torch"),
                    help="sparse matmul dispatch (kernels.ops)")
    args = ap.parse_args(argv)
    if args.max_len <= args.max_new:
        ap.error("--max-len must exceed --max-new")
    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    params, rep = build(cfg, seed=args.seed, sparsity=args.sparsity,
                        balanced=args.balanced, device=device)
    if args.sparsity:
        print(f"reformatted {rep['n_tiled_csl']} weights to Tiled-CSL in "
              f"{rep['encode_s']:.2f}s: {rep['dense_bytes'] / 2 ** 20:.1f} "
              f"MiB dense -> {rep['sparse_bytes'] / 2 ** 20:.1f} MiB sparse "
              f"({rep['sparse_bytes'] / rep['dense_bytes']:.3f}x)")
    server = api.StreamingServer(params, cfg,
                                 config=ServeConfig.from_flags(args))
    ttft_dl = (None if args.ttft_deadline_ms is None
               else args.ttft_deadline_ms / 1e3)
    total_dl = None if args.deadline_ms is None else args.deadline_ms / 1e3
    dev = resolve_device(device)
    _sync(dev)
    t0 = time.perf_counter()
    n_shed = 0
    if args.trace_rate is not None:
        # Open loop: arrivals on their own (virtual-step) schedule; the
        # server's latency stamps stay on the host clock.
        lo = 4
        hi = max(lo + 1, min(16, args.max_len - args.max_new))
        trace = loadgen.make_trace(
            seed=args.seed, n_requests=args.requests,
            rate=args.trace_rate, vocab=cfg.vocab,
            tenants=[loadgen.TenantSpec(
                "cli", suffix_len=(lo, hi),
                max_new=(args.max_new, args.max_new + 1),
                ttft_deadline=ttft_dl, deadline=total_dl)])
        result = loadgen.replay(server, trace, loadgen.StepClock(dt=1.0))
        responses, n_shed = result.responses, len(result.shed)
    else:
        rng = np.random.default_rng(args.seed)
        for _ in range(args.requests):
            plen = int(rng.integers(4, min(16, args.max_len - args.max_new)))
            server.submit(api.GenerationRequest(
                prompt=rng.integers(0, cfg.vocab, plen).astype(np.int64),
                max_new_tokens=args.max_new,
                ttft_deadline_s=ttft_dl, deadline_s=total_dl))
        responses = server.run_until_drained()
    _sync(dev)
    dt = time.perf_counter() - t0
    n_tokens = sum(len(r.tokens) for r in responses)
    print(f"served {len(responses)} requests / {n_tokens} tokens in "
          f"{dt:.2f}s ({n_tokens / dt:.1f} tok/s"
          + (f", {n_shed} shed by backpressure" if n_shed else "") + ")")
    b = server.batcher
    m = b.metrics
    ttft = latency_summary([r.ttft_s for r in responses
                            if r.ttft_s is not None])
    tpot = latency_summary([r.tpot_s for r in responses
                            if r.tpot_s is not None])
    if ttft["n"]:
        print(f"latency: ttft p50/p99 = {ttft['p50'] * 1e3:.1f}/"
              f"{ttft['p99'] * 1e3:.1f} ms"
              + (f", tpot p50/p99 = {tpot['p50'] * 1e3:.1f}/"
                 f"{tpot['p99'] * 1e3:.1f} ms" if tpot["n"] else ""))
    print(f"scheduler: occupancy={m.occupancy:.2f} "
          f"queue_wait={m.mean_queue_wait_steps:.1f} steps "
          f"prefill/decode={m.prefill_tokens}/{m.decode_tokens} tok "
          f"prefill_shapes={b.prefill_compiles} "
          f"admit/decode time={m.admit_time_s:.2f}/{m.decode_time_s:.2f}s "
          f"graph={b.stepper.graph}")
    if args.paged:
        print(f"paged: prefix_hit_rate={m.prefix_hit_rate:.2f} "
              f"peak_active={m.peak_active_slots} "
              f"preemptions={m.preemptions} "
              f"pool={b.pool.blocks_in_use}/{b.pool.n_blocks} in use, "
              f"peak {m.peak_blocks_in_use}")
    rep.update(responses=responses, server=server, wall_s=dt,
               tokens_per_s=n_tokens / dt, ttft=ttft, tpot=tpot,
               shed=n_shed)
    return rep


if __name__ == "__main__":
    main()
