"""Serving launcher (CLI) of the port: a Tiled-CSL sparse model served as
one batch through ``engine.generate`` on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch opt_30b --smoke --sparsity 0.8 --requests 8

Builds the model from ``--seed``, optionally prunes and reformats its
projections to Tiled-CSL on the device (``lm_head`` stays dense, as in
the JAX launcher), serves ``--requests`` prompts of ``--max-len -
--max-new`` tokens as one batch, and prints tokens/s and the weight-bytes
saving. The flags are a subset of ``repro.launch.serve``'s.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch

from repro_torch import configs
from repro_torch.core import pruning, tiled_csl
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.models import transformer
from repro_torch.serving import engine

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
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "cuda", "torch"),
                    help="sparse matmul dispatch (kernels.ops)")
    args = ap.parse_args(argv)
    if args.max_len <= args.max_new:
        ap.error("--max-len must exceed --max-new")
    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    rep = run(cfg, requests=args.requests,
              prompt_len=args.max_len - args.max_new, max_new=args.max_new,
              seed=args.seed, sparsity=args.sparsity, balanced=args.balanced,
              backend=args.backend, device=device)
    if args.sparsity:
        print(f"reformatted {rep['n_tiled_csl']} weights to Tiled-CSL in "
              f"{rep['encode_s']:.2f}s: {rep['dense_bytes'] / 2 ** 20:.1f} "
              f"MiB dense -> {rep['sparse_bytes'] / 2 ** 20:.1f} MiB sparse "
              f"({rep['sparse_bytes'] / rep['dense_bytes']:.3f}x)")
    print(f"served {args.requests} requests / {args.requests * args.max_new} "
          f"tokens: prefill {rep['prefill_s'] * 1e3:.1f} ms, decode "
          f"{rep['decode_ms_per_step']:.2f} ms/step, "
          f"{rep['tokens_per_s']:.1f} tok/s")
    return rep


if __name__ == "__main__":
    main()
