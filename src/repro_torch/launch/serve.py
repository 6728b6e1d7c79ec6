"""Serving launcher (CLI) of the port: continuous batching over a
(optionally Tiled-CSL sparse) model on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch opt_30b --smoke --sparsity 0.8 --slots 4 --paged

Builds the model from ``--seed``, optionally prunes and reformats its
projections to Tiled-CSL on the device (``lm_head`` and, for MLA
(``--arch minicpm3_4b``), the four latent factors stay dense, as in the
JAX launcher; for MoE (``--arch qwen3_moe_30b_a3b``, ``qwen2_moe_a2_7b``)
the routed ``gate``/``up``/``down`` stacks are encoded per expert into
expert stacks, which the JAX launcher's scan-stacked layout leaves dense,
and the router stays dense; for mamba2 (``--arch mamba2_130m``) the SSM's
``in_proj``/``out_proj`` stay dense, as the JAX launcher's list does not
name them), then serves a synthetic workload through the session
API (``serving.api.StreamingServer`` over the continuous batcher, its
decode step a CUDA graph), reporting tokens/s, TTFT/TPOT percentiles and
the weight-bytes saving. Default is a closed-loop drain; ``--trace-rate
R`` switches to an open-loop Poisson trace (``serving.loadgen``) at R
requests per engine step.

With ``--paged --hbm-budget-gb G`` (and no ``--n-blocks``) the block pool
is sized by ``serving.budget.plan``: G GB less the weights (the sparse
weight mode when ``--sparsity`` is given) and a workspace, in KV blocks.
It prints the planned weight bytes beside those built: the plan counts
``lm_head`` and the MLA factors as Tiled-CSL, as the reference's does,
where the build keeps them dense.
``--spec-k K`` (with ``--paged``) verifies up to K drafts a step, from
the request's own n-grams (``--drafter ngram``, ``--max-ngram``) or a
smoke-sized draft model (``--drafter model``, ``--draft-arch``);
``--chunked`` (with ``--paged``) streams prompts in ``--chunk-size``
positions at a time through the mixed step, at most ``--chunk-budget`` a
step. ``--ttft-target-ms``/``--tpot-target-ms``/``--priority`` attach one
``SLOSpec`` to every request; ``--fault-plan`` injects a saved
``serving.faults.FaultPlan``; ``--metrics-port``/``--digest-every``
expose the scheduler's metrics (``obs.metrics``); ``--trace-out`` writes
the run's trace as Chrome/Perfetto JSON (``obs.export``).

``--ckpt DIR`` serves the params of the newest training checkpoint in
DIR instead of random ones: one that ``repro_torch.launch.train`` wrote,
or ``repro.launch.train`` (its ``(TrainState, data state)`` leaves; the
params subtree is taken, through ``convert.params_from_checkpoint``).
With ``--sparsity`` they are pruned and encoded as random weights are,
except that where the checkpoint's manifest records masked training at
the same sparsity, the weights the trainer masked are encoded as they
stand, so the served Tiled-CSL holds exactly the trained masks.
``--snapshot-dir DIR`` restores in-flight sessions from the newest
``StreamingServer`` snapshot there at start and writes one after the run
drains. ``--profile-kernels`` records each unique LSCD launch
(``obs.profile``) and, after the run drains, times each on its own
(CUDA events on the card) and prints the predicted-against-measured
drift table. The flags are those of ``repro.launch.serve``.

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

from repro_torch import configs, convert
from repro_torch.core import pruning, tiled_csl
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.distributed import sharding
from repro_torch.kernels import ops
from repro_torch.launch import train as train_launch
from repro_torch.models import transformer
from repro_torch.obs import export as obs_export
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import profile as obs_profile
from repro_torch.obs import trace as obs_trace
from repro_torch.serving import (api, budget, engine, faults, loadgen,
                                 speculative)
from repro_torch.serving.config import SLOSpec, ServeConfig
from repro_torch.serving.scheduler import latency_summary

# The JAX launcher's list. On an MLA model it matches wo, gate, up and
# down; the latent factors (w_dq, w_uq, w_dkv, w_ukv) stay dense. On an
# MoE model it matches the routed stacks (moe['gate'], ...) and the shared
# expert; the router stays dense.
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


# Dense weights the forward reads outside ``sparse_linear.linear``: MLA's
# absorbed steps take ``w_uk``/``w_uv`` from ``w_ukv`` in f32, and the
# RG-LRU gates read ``wa`` by an f32 matmul, as the reference does from
# its f32 params, so the build leaves them as drawn.
KEEP_AS_DRAWN = ("w_ukv", "wa")


def _cast_dense_matrices(tree, dtype):
    """Cast every dense 2-D weight (a ``"w"`` tensor) of ``tree`` that only
    ``sparse_linear.linear`` reads to ``dtype``, in place: ``linear``
    casts a dense weight to the activation dtype on every call, to the
    same values. Subtrees named in ``KEEP_AS_DRAWN`` keep their dtype."""
    for key, v in tree.items():
        if key in KEEP_AS_DRAWN:
            continue
        if isinstance(v, dict):
            _cast_dense_matrices(v, dtype)
        elif key == "w" and isinstance(v, torch.Tensor) and v.dim() == 2:
            tree[key] = v.to(dtype)
    return tree


def params_parts(params):
    """A params tree as ``transformer.init_model_parts`` yields a model's
    parts, for :func:`build`'s ``source``."""
    yield "embed", dict(params["embed"])
    for layer in params["layers"]:
        yield "layers", _copy_tree(layer)
    yield "final_norm", dict(params["final_norm"])
    if "lm_head" in params:
        yield "lm_head", dict(params["lm_head"])


def _copy_tree(tree):
    """The containers of ``tree`` anew, its leaves shared (the build
    replaces leaves in place)."""
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_tree(v) for v in tree]
    return tree


def build(cfg, *, seed: int = 0, sparsity: Optional[float] = None,
          balanced: bool = False, device: DeviceLike = None, source=None,
          masked=None, mesh=None):
    """Random params on ``device``, pruned and reformatted to Tiled-CSL
    when ``sparsity`` is given. Returns (params, report dict).

    ``source``, a params tree on ``device`` (a checkpoint's), stands in
    for the random draw; it is left as it was. ``masked(path)`` names
    the weights whose zeros are already their masks (masked training at
    this sparsity): those are encoded as they stand, every other one
    listed is pruned to ``sparsity`` first.

    The sparse build goes layer by layer, so a full-depth model never
    exists in f32: each layer is drawn (``transformer.init_model_parts``,
    the same generator and order as ``init_model``) and its projections
    are pruned and encoded one at a time, each f32 source freed as soon as
    it is encoded, before the next layer is drawn. Where the reference
    stacks the layers for ``lax.scan`` (``transformer.uses_scan``),
    ``sparsify_params`` pads every layer of a stack to the stack's
    largest ``max_nnz``, which is known only after the last layer; a
    second pass re-pads and groups (``group_projections``) one layer at a
    time. An unrolled stack (recurrentgemma's) keeps each leaf's own
    ``max_nnz`` and is only grouped.
    The result equals ``init_model`` + ``sparsify_params`` +
    ``group_projections`` and the casts below bit for bit; the peak is
    about the encoded model plus one layer. ``embed`` (a codebook model's
    ``[n_cb, vocab, d]`` stack too), ``lm_head`` and every weight matrix
    left dense that the forward reads only through
    ``linear`` (all of them in a dense build, MLA's ``w_ukv`` aside) are
    cast to the compute dtype as they are drawn (the forward would cast
    them on every call to the same values); ``w_ukv`` and ``wa`` stay
    f32 (``KEEP_AS_DRAWN``). ``lm_head`` stays dense, as in the JAX
    launcher.

    With ``mesh`` (``launch.mesh``) this rank keeps its shard
    (``distributed.sharding.shard_params``): each layer is drawn, pruned
    and encoded whole, as without a mesh, then cut to the rank's shard
    and the whole freed before the next layer; a shard keeps its whole
    leaf's ``max_nnz``, so the re-pad and the grouping decide as on the
    whole model, and the result is the shard of the unsharded build bit
    for bit.

    The report holds ``encode_s`` (the prune, encode, re-pad and group
    time, device synchronised), ``build_s`` (all of it, init included), the
    Tiled-CSL count and bytes (``sparse_bytes``; ``dense_bytes`` is their
    bf16 size), ``nnz`` (the non-zeros encoded), ``weight_bytes`` (every
    leaf as built) and, on a card, ``max_memory_allocated`` at the end of
    the build.
    """
    dev = resolve_device(device)
    if mesh is not None:
        transformer.rank_config(cfg, mesh)      # refuses what TP cannot
    dt = getattr(torch, cfg.dtype)
    report = {"encode_s": 0.0, "sparse_bytes": 0, "dense_bytes": 0,
              "n_tiled_csl": 0}
    _sync(dev)
    t_start = time.perf_counter()
    params = {}
    parts = (transformer.init_model_parts(cfg, seed=seed, device=dev)
             if source is None else params_parts(source))
    for name, part in parts:
        if name != "layers":
            if name in ("embed", "lm_head"):
                key = "table" if name == "embed" else "w"
                part[key] = part[key].to(dt)
            params[name] = _rank_part(part, mesh, f"['{name}']")
            continue
        stack = params.setdefault("layers", [])
        if sparsity:
            _sync(dev)
            t0 = time.perf_counter()
            prefix = f"['layers'][{len(stack)}]"
            if masked is not None:      # their nonzeros are their masks
                part = pruning.encode_in_place(
                    part, 0.0, lambda p: _sparse_path(p) and masked(p),
                    prefix=prefix)
            part = pruning.encode_in_place(
                part, sparsity, _sparse_path, balanced=balanced,
                prefix=prefix)
            _sync(dev)
            report["encode_s"] += time.perf_counter() - t0
        part = _rank_part(part, mesh, f"['layers'][{len(stack)}]")
        stack.append(_cast_dense_matrices(part, dt))
    if sparsity:
        _sync(dev)
        t0 = time.perf_counter()
        stack = params["layers"]
        stack_max = pruning.stack_max_nnz(
            pv for i, p in enumerate(stack)
            for pv in pruning.tiled_csl_paths(p, f"['layers'][{i}]"))
        for i in range(len(stack)):
            if transformer.uses_scan(cfg):
                stack[i] = pruning.pad_to_stack_max(stack[i], stack_max,
                                                    f"['layers'][{i}]")
            stack[i] = pruning.group_projections(stack[i])
        _sync(dev)
        report["encode_s"] += time.perf_counter() - t0
        csl = tiled_csl_leaves(params)
        report.update(n_tiled_csl=len(csl),
                      sparse_bytes=sum(t.nbytes_sparse for t in csl),
                      dense_bytes=sum(t.nbytes_dense for t in csl),
                      nnz=sum(int(t.nnz.sum()) for t in csl))
    _sync(dev)
    report["build_s"] = time.perf_counter() - t_start
    report["weight_bytes"] = params_bytes(params)
    report["max_memory_allocated"] = (torch.cuda.max_memory_allocated(dev)
                                      if dev.type == "cuda" else None)
    return params, report


def _rank_part(part, mesh, prefix: str):
    """``part`` (a params subtree at ``prefix``) as this rank keeps it."""
    if mesh is None:
        return part
    return sharding.shard_params(part, mesh, prefix=prefix)


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
    """[requests, prompt_len] token ids from ``seed``; a codebook config
    draws [requests, n_codebooks, prompt_len]."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    shape = ((requests, cfg.n_codebooks, prompt_len) if cfg.n_codebooks
             else (requests, prompt_len))
    return torch.randint(0, cfg.vocab, shape, generator=gen).to(device)


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
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: drafts verified per step "
                         "(DESIGN.md §11; requires --paged)")
    ap.add_argument("--drafter", default="ngram", choices=("ngram", "model"),
                    help="draft source: the request's own n-gram history, "
                         "or a small draft model sharing the tokenizer")
    ap.add_argument("--draft-arch", default=None,
                    help="arch id for --drafter model (smoke-sized init)")
    ap.add_argument("--max-ngram", type=int, default=3,
                    help="longest suffix n-gram the ngram drafter matches")
    ap.add_argument("--chunked", action="store_true",
                    help="chunked prefill: stream prompts into their slots "
                         "chunk-size positions per mixed step instead of "
                         "bucketed whole-prompt admission (DESIGN.md §16; "
                         "requires --paged)")
    ap.add_argument("--chunk-size", type=int, default=16,
                    help="prompt positions per prefill chunk (--chunked)")
    ap.add_argument("--chunk-budget", type=int, default=32,
                    help="max prefill positions granted per mixed step "
                         "across all slots (--chunked)")
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
    ap.add_argument("--ckpt", default=None, metavar="DIR",
                    help="serve the params of the newest training "
                         "checkpoint in DIR (the port's or the JAX "
                         "launcher's)")
    ap.add_argument("--snapshot-dir", default=None, metavar="DIR",
                    help="restore in-flight sessions from the newest "
                         "snapshot in DIR at start, and write one after "
                         "the run drains")
    ap.add_argument("--profile-kernels", action="store_true",
                    help="record every unique kernel launch, time each on "
                         "its own after the run drains, and print the "
                         "predicted-against-measured drift table")
    args = ap.parse_args(argv)
    if args.max_len <= args.max_new:
        ap.error("--max-len must exceed --max-new")
    if args.trace_out:
        obs_trace.get_tracer().enable()
    profiler = obs_profile.KernelProfiler() if args.profile_kernels else None
    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    source = masked = None
    if args.ckpt:
        source, meta = convert.params_from_checkpoint(args.ckpt,
                                                      device=device)
        trained = meta.get("extra", {}).get("sparsity")
        print(f"params from {args.ckpt}, step {meta['step']}"
              + (f" (trained with {trained} masks)" if trained else ""))
        if args.sparsity and trained == args.sparsity:
            def masked(path):
                return train_launch.masked_leaf(cfg, path, 2)
    params, rep = build(cfg, seed=args.seed, sparsity=args.sparsity,
                        balanced=args.balanced, device=device, source=source,
                        masked=masked)
    del source
    if args.sparsity:
        # No weight of an SSM stack is on the list: no ratio to print.
        ratio = (f" ({rep['sparse_bytes'] / rep['dense_bytes']:.3f}x)"
                 if rep["dense_bytes"] else "")
        print(f"reformatted {rep['n_tiled_csl']} weights to Tiled-CSL in "
              f"{rep['encode_s']:.2f}s: {rep['dense_bytes'] / 2 ** 20:.1f} "
              f"MiB dense -> {rep['sparse_bytes'] / 2 ** 20:.1f} MiB sparse"
              f"{ratio}")
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
              f"{p.weight_bytes / 1e9:.2f} GB ({mode}; "
              f"{rep['weight_bytes'] / 1e9:.2f} GB as built), "
              f"{p.n_blocks} KV blocks x {p.block} tok "
              f"({p.kv_bytes / 1e9:.2f} GB KV; dense-slot baseline "
              f"{p.n_dense_slots(args.max_len)} slots at max_len)")
        config = dataclasses.replace(config, n_blocks=p.n_blocks).validate()
        rep["plan"] = p
    dev = resolve_device(device)
    drafter = None
    if args.spec_k:
        draft_params = draft_cfg = None
        if args.drafter == "model":
            draft_cfg = configs.smoke(args.draft_arch or args.arch)
            draft_params = transformer.init_model(draft_cfg,
                                                  seed=args.seed + 1,
                                                  device=dev)
        drafter = speculative.make_drafter(
            args.drafter, max_ngram=args.max_ngram,
            draft_params=draft_params, draft_cfg=draft_cfg,
            vocab=cfg.vocab if args.drafter == "model" else None,
            device=dev)
    plan = faults.FaultPlan.load(args.fault_plan) if args.fault_plan else None
    if plan is not None:
        print(f"fault plan: {len(plan)} events, "
              f"fingerprint {plan.fingerprint()[:12]}")
    live_kwargs = dict(fault_plan=plan, drafter=drafter)
    resume = (ft.SnapshotStore(args.snapshot_dir).latest_path()
              if args.snapshot_dir else None)
    if resume is not None:
        server = api.StreamingServer.restore(args.snapshot_dir, params, cfg,
                                             config=config, **live_kwargs)
        print(f"restored {len(server.live_sessions())} in-flight "
              f"session(s) from {resume}")
    else:
        server = api.StreamingServer(params, cfg, config=config,
                                     **live_kwargs)
    if profiler is not None:
        obs_profile.set_profiler(profiler)
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
    if profiler is not None:
        obs_profile.set_profiler(None)
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
    if args.chunked:
        print(f"chunked: mixed_steps={m.mixed_steps} "
              f"chunk_tokens={m.chunk_tokens} "
              f"compute_positions={m.compute_positions}")
    for tenant, c in sorted(m.slo_attainment.items()):
        print(f"slo[{tenant}]: ttft {c['ttft_ok']}/"
              f"{c['ttft_ok'] + c['ttft_miss']} met, "
              f"tpot {c['tpot_ok']}/{c['tpot_ok'] + c['tpot_miss']} met")
    if args.spec_k:
        print(f"speculative (k={args.spec_k}, {args.drafter}): "
              f"drafted={m.drafted} accepted={m.accepted} "
              f"accept_rate={m.accept_rate:.2f} "
              f"tokens_per_step={m.tokens_per_step:.2f}")
    if plan is not None:
        frep = b.faults.report()
        print(f"faults: {frep['fired']}/{frep['plan_events']} events fired "
              f"{frep['by_kind']}; retries={m.step_retries} "
              f"quarantined={m.quarantined} deadline={m.deadline_expired} "
              f"peak_degradation={m.peak_degradation_level}")
    if args.snapshot_dir:
        rep["snapshot"] = server.snapshot(args.snapshot_dir)
        print(f"snapshot: {rep['snapshot']}")
    if registry is not None:
        print("digest: " + registry.digest(obs_metrics.DIGEST_KEYS))
    if stop_digest is not None:
        stop_digest.set()
    if http_srv is not None:
        http_srv.shutdown()
    if profiler is not None:
        rep["drift"] = profiler.drift_report(reps=2)
        print(f"kernel drift ({rep['drift']['n_unique_launches']} unique "
              f"launches):")
        print(obs_profile.render_drift_table(rep["drift"]["rows"]))
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
