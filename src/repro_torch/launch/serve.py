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
requests per engine step.

With ``--paged --hbm-budget-gb G`` (and no ``--n-blocks``) the block pool
is sized by ``serving.budget.plan``: G GB less the weights (the sparse
weight mode when ``--sparsity`` is given) and a workspace, in KV blocks.
``--ttft-target-ms``/``--tpot-target-ms``/``--priority`` attach one
``SLOSpec`` to every request; ``--fault-plan`` injects a saved
``serving.faults.FaultPlan``; ``--metrics-port``/``--digest-every``
expose the scheduler's metrics (``obs.metrics``); ``--trace-out`` writes
the run's trace as Chrome/Perfetto JSON (``obs.export``).

The flags are those of ``repro.launch.serve`` but for the ones whose
modules are not ported yet: ``--spec-k``, ``--drafter``,
``--draft-arch``, ``--max-ngram``, ``--chunked``, ``--chunk-size`` and
``--chunk-budget`` (speculation and chunked prefill, ROADMAP.md queue 1
item 9), ``--profile-kernels`` (item 12), ``--ckpt`` and
``--snapshot-dir`` (item 14).

``run`` serves one fixed batch through ``engine.generate`` instead (the
slice that ``chip_smoke.py`` drives and profiles).
"""

from __future__ import annotations

import argparse
import dataclasses
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import pruning, tiled_csl
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.models import transformer
from repro_torch.obs import export as obs_export
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serving import api, budget, engine, faults, loadgen
from repro_torch.serving.config import SLOSpec, ServeConfig
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


def _sparse_path(path: str) -> bool:
    return any(k in path for k in SPARSE_NAMES)


def build(cfg, *, seed: int = 0, sparsity: Optional[float] = None,
          balanced: bool = False, device: DeviceLike = None):
    """Random params on ``device``, pruned and reformatted to Tiled-CSL
    when ``sparsity`` is given. Returns (params, report dict).

    The sparse build goes layer by layer, so a full-depth model never
    exists in f32: each layer is drawn (``transformer.init_model_parts``,
    the same generator and order as ``init_model``) and its projections
    are pruned and encoded one at a time, each f32 source freed as soon as
    it is encoded, before the next layer is drawn. ``sparsify_params``
    pads every layer of a stack to the stack's largest ``max_nnz``, which
    is known only after the last layer; a second pass re-pads and groups
    (``group_projections``) one layer at a time.
    The result equals ``init_model`` + ``sparsify_params`` +
    ``group_projections`` bit for bit; the peak is about the encoded model
    plus one layer. ``embed`` and ``lm_head`` are cast to the compute
    dtype as they are drawn (the forward would cast them on every call to
    the same values); ``lm_head`` stays dense, as in the JAX launcher.

    The report holds ``encode_s`` (the prune, encode, re-pad and group
    time, device synchronised), ``build_s`` (all of it, init included), the
    Tiled-CSL count and bytes (``sparse_bytes``; ``dense_bytes`` is their
    bf16 size), ``weight_bytes`` (every leaf as built) and, on a card,
    ``max_memory_allocated`` at the end of the build.
    """
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    report = {"encode_s": 0.0, "sparse_bytes": 0, "dense_bytes": 0,
              "n_tiled_csl": 0}
    _sync(dev)
    t_start = time.perf_counter()
    params = {}
    for name, part in transformer.init_model_parts(cfg, seed=seed,
                                                   device=dev):
        if name != "layers":
            if name in ("embed", "lm_head"):
                key = "table" if name == "embed" else "w"
                part[key] = part[key].to(dt)
            params[name] = part
            continue
        stack = params.setdefault("layers", [])
        if sparsity:
            _sync(dev)
            t0 = time.perf_counter()
            part = pruning.encode_in_place(
                part, sparsity, _sparse_path, balanced=balanced,
                prefix=f"['layers'][{len(stack)}]")
            _sync(dev)
            report["encode_s"] += time.perf_counter() - t0
        stack.append(part)
    if sparsity:
        _sync(dev)
        t0 = time.perf_counter()
        stack = params["layers"]
        stack_max = pruning.stack_max_nnz(
            pv for i, p in enumerate(stack)
            for pv in pruning.tiled_csl_paths(p, f"['layers'][{i}]"))
        for i in range(len(stack)):
            stack[i] = pruning.group_projections(pruning.pad_to_stack_max(
                stack[i], stack_max, f"['layers'][{i}]"))
        _sync(dev)
        report["encode_s"] += time.perf_counter() - t0
        csl = tiled_csl_leaves(params)
        report.update(n_tiled_csl=len(csl),
                      sparse_bytes=sum(t.nbytes_sparse for t in csl),
                      dense_bytes=sum(t.nbytes_dense for t in csl))
    _sync(dev)
    report["build_s"] = time.perf_counter() - t_start
    report["weight_bytes"] = params_bytes(params)
    report["max_memory_allocated"] = (torch.cuda.max_memory_allocated(dev)
                                      if dev.type == "cuda" else None)
    return params, report


def params_bytes(tree) -> int:
    """Bytes of every leaf of a params tree as it lies on the device:
    Tiled-CSL leaves their words and counters, tensors their storage."""
    if isinstance(tree, tiled_csl.TiledCSL):
        return tree.nbytes_sparse
    if isinstance(tree, dict):
        return sum(params_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(params_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


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
                    help="usable KV blocks; default: dense byte-equivalent "
                         "or derived from --hbm-budget-gb")
    ap.add_argument("--hbm-budget-gb", type=float, default=None,
                    help="size the block pool from an HBM budget via "
                         "serving.budget.plan (weights + workspace + KV)")
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
    ap.add_argument("--ttft-target-ms", type=float, default=None,
                    help="soft first-token SLO target per request: "
                         "attainment accounting (never kills a request; "
                         "see --ttft-deadline-ms)")
    ap.add_argument("--tpot-target-ms", type=float, default=None,
                    help="soft per-token SLO target per request")
    ap.add_argument("--priority", type=int, default=0,
                    help="SLO priority class (higher = scheduled first)")
    ap.add_argument("--fault-plan", default=None, metavar="PATH",
                    help="JSON FaultPlan (serving.faults) injected into the "
                         "run: chaos replay from a file")
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "cuda", "torch"),
                    help="sparse matmul dispatch (kernels.ops)")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="P",
                    help="serve live scheduler metrics on "
                         "http://127.0.0.1:P/metrics (Prometheus text "
                         "exposition; /metrics.json for JSON)")
    ap.add_argument("--digest-every", type=float, default=None, metavar="S",
                    help="print a one-line operator digest of the key "
                         "metrics every S seconds while serving")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="export the run's structured trace (scheduler "
                         "decisions, engine steps) as Perfetto/Chrome "
                         "trace_event JSON")
    args = ap.parse_args(argv)
    if args.max_len <= args.max_new:
        ap.error("--max-len must exceed --max-new")
    if args.trace_out:
        obs_trace.get_tracer().enable()
    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    params, rep = build(cfg, seed=args.seed, sparsity=args.sparsity,
                        balanced=args.balanced, device=device)
    if args.sparsity:
        print(f"reformatted {rep['n_tiled_csl']} weights to Tiled-CSL in "
              f"{rep['encode_s']:.2f}s: {rep['dense_bytes'] / 2 ** 20:.1f} "
              f"MiB dense -> {rep['sparse_bytes'] / 2 ** 20:.1f} MiB sparse "
              f"({rep['sparse_bytes'] / rep['dense_bytes']:.3f}x)")
    config = ServeConfig.from_flags(args)
    if args.paged and args.hbm_budget_gb is not None \
            and args.n_blocks is None:
        # Spend the Tiled-CSL weight savings on KV blocks: the sparse mode
        # affords a larger pool at equal budget.
        mode = "sparse_pallas" if args.sparsity else "dense"
        p = budget.plan(cfg, hbm_budget=int(args.hbm_budget_gb * 1e9),
                        weight_mode=mode, sparsity=args.sparsity or 0.8,
                        block=args.block_size)
        print(f"budget: {args.hbm_budget_gb:.1f} GB -> weights "
              f"{p.weight_bytes / 1e9:.2f} GB ({mode}), "
              f"{p.n_blocks} KV blocks x {p.block} tok "
              f"({p.kv_bytes / 1e9:.2f} GB KV; dense-slot baseline "
              f"{p.n_dense_slots(args.max_len)} slots at max_len)")
        config = dataclasses.replace(config, n_blocks=p.n_blocks).validate()
        rep["plan"] = p
    plan = faults.FaultPlan.load(args.fault_plan) if args.fault_plan else None
    if plan is not None:
        print(f"fault plan: {len(plan)} events, "
              f"fingerprint {plan.fingerprint()[:12]}")
    server = api.StreamingServer(params, cfg, config=config, fault_plan=plan)
    # Soft targets (or a priority class) promote the flat deadline flags
    # into one typed SLOSpec; without them the flat fields stay.
    slo = None
    if (args.ttft_target_ms is not None or args.tpot_target_ms is not None
            or args.priority):
        slo = SLOSpec(ttft_target_ms=args.ttft_target_ms,
                      tpot_target_ms=args.tpot_target_ms,
                      priority=args.priority,
                      ttft_deadline_ms=args.ttft_deadline_ms,
                      deadline_ms=args.deadline_ms).validate()
    ttft_dl = (args.ttft_deadline_ms / 1e3
               if slo is None and args.ttft_deadline_ms is not None else None)
    total_dl = (args.deadline_ms / 1e3
                if slo is None and args.deadline_ms is not None else None)
    b = server.batcher
    registry = http_srv = stop_digest = None
    if args.metrics_port is not None or args.digest_every is not None:
        registry = obs_metrics.MetricsRegistry()
        obs_metrics.register_scheduler_metrics(registry, lambda: b.metrics)
    if args.metrics_port is not None:
        http_srv = obs_metrics.start_http_server(registry, args.metrics_port)
        print(f"metrics: http://127.0.0.1:{args.metrics_port}/metrics "
              f"(/metrics.json for JSON)")
    if args.digest_every is not None:
        stop_digest = threading.Event()

        def _digest_loop():
            while not stop_digest.wait(args.digest_every):
                print("digest: " + registry.digest(obs_metrics.DIGEST_KEYS))

        threading.Thread(target=_digest_loop, daemon=True).start()
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
                ttft_deadline=ttft_dl, deadline=total_dl, slo=slo)])
        result = loadgen.replay(server, trace, loadgen.StepClock(dt=1.0))
        responses, n_shed = result.responses, len(result.shed)
    else:
        rng = np.random.default_rng(args.seed)
        for _ in range(args.requests):
            plen = int(rng.integers(4, min(16, args.max_len - args.max_new)))
            server.submit(api.GenerationRequest(
                prompt=rng.integers(0, cfg.vocab, plen).astype(np.int64),
                max_new_tokens=args.max_new,
                ttft_deadline_s=ttft_dl, deadline_s=total_dl, slo=slo))
        responses = server.run_until_drained()
    _sync(dev)
    dt = time.perf_counter() - t0
    n_tokens = sum(len(r.tokens) for r in responses)
    print(f"served {len(responses)} requests / {n_tokens} tokens in "
          f"{dt:.2f}s ({n_tokens / dt:.1f} tok/s"
          + (f", {n_shed} shed by backpressure" if n_shed else "") + ")")
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
    for tenant, c in sorted(m.slo_attainment.items()):
        print(f"slo[{tenant}]: ttft {c['ttft_ok']}/"
              f"{c['ttft_ok'] + c['ttft_miss']} met, "
              f"tpot {c['tpot_ok']}/{c['tpot_ok'] + c['tpot_miss']} met")
    if plan is not None:
        frep = b.faults.report()
        print(f"faults: {frep['fired']}/{frep['plan_events']} events fired "
              f"{frep['by_kind']}; retries={m.step_retries} "
              f"quarantined={m.quarantined} deadline={m.deadline_expired} "
              f"peak_degradation={m.peak_degradation_level}")
    if registry is not None:
        print("digest: " + registry.digest(obs_metrics.DIGEST_KEYS))
    if stop_digest is not None:
        stop_digest.set()
    if http_srv is not None:
        http_srv.shutdown()
    if args.trace_out:
        tr = obs_trace.get_tracer()
        obs_export.write_chrome_trace(tr.records(), args.trace_out)
        print(f"wrote {args.trace_out}: {len(tr)} trace records "
              f"({tr.dropped} dropped)")
        tr.disable()
        tr.clear()
    rep.update(responses=responses, server=server, wall_s=dt,
               tokens_per_s=n_tokens / dt, ttft=ttft, tpot=tpot,
               shed=n_shed, n_blocks=b.pool.n_blocks if args.paged else None)
    return rep


if __name__ == "__main__":
    main()
