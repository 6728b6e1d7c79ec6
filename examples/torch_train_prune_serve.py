"""The paper's lifecycle on the port: train -> prune -> mask-preserving
finetune -> reformat to Tiled-CSL -> serve with continuous batching.

The counterpart of ``examples/train_prune_serve.py`` (paper §6.3.1 and
§5): a small llama-style model trained on a learnable synthetic grammar,
pruned with the paper's layer plan (``pruning.opt_style_plan``: the MLP
of the first and last quarter of the layers kept dense, the rest and
every attention projection at 0.8), retrained with its masks held,
its attention reformatted to Tiled-CSL and served through
``serving.batching.ContinuousBatcher``. On a card the Tiled-CSL
projections run the port's CUDA kernels.

Each stage is a function of a ``ModelConfig`` (:func:`train`,
:func:`make_masks`, :func:`finetune`, :func:`reformat`, :func:`serve`),
so a caller can run the lifecycle at other widths than the demo's.

Run:  PYTHONPATH=src python examples/torch_train_prune_serve.py [--full]
      [--steps N] [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import pruning
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.models import nn
from repro_torch.models.config import ModelConfig
from repro_torch.serving import batching
from repro_torch.serving.config import SchedulerConfig, ServeConfig
from repro_torch.training import data as data_mod
from repro_torch.training import optimizer as opt_mod
from repro_torch.training import train_loop

SPARSITY = 0.8
PRUNED = ("'gate'", "'up'", "'down'", "'wq'", "'wk'", "'wv'", "'wo'")
ATTENTION = ("'wq'", "'wk'", "'wv'", "'wo'")


def demo_config(full: bool = False) -> ModelConfig:
    """The reference example's model: 6.3M params, or 53M with ``full``."""
    return ModelConfig(
        name="e2e-demo", family="dense",
        n_layers=8 if full else 4,
        d_model=768 if full else 320,
        n_heads=12 if full else 8,
        n_kv=4 if full else 2,
        d_ff=2048 if full else 1024,
        vocab=2048, mlp_kind="swiglu", norm_kind="rmsnorm")


def train(cfg: ModelConfig, steps: int, *, batch: int = 4, seq: int = 128,
          lr: float = 1e-3, seed: int = 0, device: DeviceLike = None,
          log_every: int = 50) -> Dict[str, Any]:
    """``steps`` f32 AdamW steps (cosine schedule, peak ``lr``, the
    reference example's 1e-3 by default, 20 warm-up steps) on
    ``SyntheticLM`` batches of ``batch`` x ``seq``. Returns the state,
    the stream, each step's loss and the mean ms a step."""
    dev = resolve_device(device)
    opt = opt_mod.AdamW(lr=opt_mod.cosine_schedule(lr, 20, steps))
    state = train_loop.init_train_state(cfg, opt, seed=seed, device=dev)
    stream = data_mod.SyntheticLM(cfg.vocab, seq, batch, seed=seed)
    step = train_loop.make_train_step(cfg, opt)
    losses = []
    t0 = time.perf_counter()
    for s in range(steps):
        state, m = step(state, train_loop.batch_to(stream.next_batch(), dev))
        losses.append(float(m["loss"]))
        if (s + 1) % log_every == 0:
            print(f"  step {s + 1}: loss {losses[-1]:.4f} "
                  f"({(time.perf_counter() - t0) / (s + 1):.2f} s/step)")
    ms = (time.perf_counter() - t0) / max(steps, 1) * 1e3
    return dict(state=state, stream=stream, losses=losses, ms_per_step=ms)


def make_masks(params: Any, cfg: ModelConfig,
               sparsity: float = SPARSITY) -> Any:
    """The reference example's rule: every projection of every layer by
    magnitude, the attention at ``sparsity`` and the MLP at
    ``opt_style_plan``'s (dense, all kept, where the plan says 0.0). A
    tree like ``params`` with a bool mask at each pruned weight and
    ``None`` elsewhere."""
    plan = pruning.opt_style_plan(cfg.n_layers, sparsity)
    masks = opt_mod.tree_map(lambda _: None, params)
    for i, layer in enumerate(params["layers"]):
        for path, w in ft.flatten_with_paths(layer):
            if w.dim() != 2 or not any(k in path for k in PRUNED):
                continue
            s = plan[i] if "'mlp'" in path else sparsity
            m = (pruning.unstructured_mask(pruning.magnitude_scores(w), s)
                 if s > 0 else torch.ones_like(w, dtype=torch.bool))
            _set(masks["layers"][i], path, m)
    return masks


def _set(tree: Any, path: str, value: Any) -> None:
    steps = ft.split_path(path)
    for step in steps[:-1]:
        tree = tree[step]
    tree[steps[-1]] = value


def masked_nonzeros(params: Any, masks: Any) -> int:
    """Positions a mask prunes that hold a nonzero, over every mask."""
    by_path = dict(ft.flatten_with_paths(params))
    return sum(int(((by_path[path] != 0) & ~m).sum())
               for path, m in ft.flatten_with_paths(masks))


def loss_of(params: Any, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig) -> float:
    with torch.no_grad():
        return float(train_loop.loss_fn(params, batch, cfg)[0])


def finetune(params: Any, masks: Any, cfg: ModelConfig,
             stream: data_mod.SyntheticLM, steps: int, *,
             lr: float = 3e-4) -> Dict[str, Any]:
    """Retraining with the masks held: ``steps`` AdamW steps at ``lr``
    from ``params`` (already masked). Returns the state, each step's
    loss and the masked positions holding a nonzero after each step."""
    dev = opt_mod.tree_leaves(params)[0].device
    opt = opt_mod.AdamW(lr=lr)
    state = train_loop.TrainState(params, opt.init(params),
                                  torch.zeros((), dtype=torch.int32,
                                              device=dev))
    step = train_loop.make_train_step(cfg, opt, masks=masks)
    losses, leaked = [], []
    for _ in range(steps):
        state, m = step(state, train_loop.batch_to(stream.next_batch(), dev))
        losses.append(float(m["loss"]))
        leaked.append(masked_nonzeros(state.params, masks))
    return dict(state=state, losses=losses, masked_nonzero=leaked)


def reformat(params: Any) -> tuple:
    """The attention projections of every layer to Tiled-CSL, encoded as
    they stand (sparsity 0.0: they are already pruned). The MLP stays
    dense: the plan keeps its first and last quarter dense, and a dense
    matrix in Tiled-CSL takes twice its bytes, as in the paper's
    FasterTransformer integration. Returns (params, dense bf16 bytes and
    Tiled-CSL bytes of the encoded weights)."""
    sparse = pruning.sparsify_params(
        params, 0.0, should_sparsify=lambda p: p.endswith("['w']") and any(
            k in p for k in ATTENTION))
    csl = [t for _, t in pruning.tiled_csl_paths(sparse)]
    return sparse, dict(
        n_tiled_csl=len(csl),
        dense_bytes=sum(t.nbytes_dense for t in csl),
        sparse_bytes=sum(t.nbytes_sparse for t in csl))


def serve(params: Any, cfg: ModelConfig, *, requests: int = 8,
          prompt_len: int = 8, max_new: int = 12, slots: int = 4,
          max_len: int = 64, seed: int = 1, backend: str = "auto",
          graph: Optional[bool] = None) -> Dict[str, Any]:
    """``requests`` prompts of ``prompt_len`` tokens from ``seed``,
    ``max_new`` greedy tokens each, through ``ContinuousBatcher`` over
    ``slots`` slots (``backend``: the kernels' dispatch; ``graph``: the
    decode step as a CUDA graph, by default on a card). Returns the
    prompts, the streams by request and the seconds the drain took."""
    b = batching.ContinuousBatcher(params, cfg, config=ServeConfig(
        scheduler=SchedulerConfig(n_slots=slots, max_len=max_len),
        backend=backend), graph=graph)
    rng = np.random.default_rng(seed)
    prompts = {}
    for uid in range(requests):
        prompts[uid] = rng.integers(0, cfg.vocab, prompt_len).astype(np.int64)
        b.submit(uid, prompts[uid], max_new)
    t0 = time.perf_counter()
    done = b.run_to_completion()
    seconds = time.perf_counter() - t0
    return dict(prompts=prompts, done=done, seconds=seconds, batcher=b)


def main(argv: Optional[Sequence[str]] = None, *,
         device: DeviceLike = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true", help="53M params")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)
    cfg = demo_config(args.full)

    # ---- 1. train ----------------------------------------------------------
    trained = train(cfg, args.steps, device=dev)
    params = trained["state"].params
    print(f"model: {nn.count_params(params) / 1e6:.1f}M params on {dev}")
    loss_dense = trained["losses"][-1]

    # ---- 2. prune (paper layer plan: first/last quarter FFNs dense) --------
    masks = make_masks(params, cfg)
    pruned = opt_mod.apply_masks(params, masks)
    eval_batch = train_loop.batch_to(trained["stream"].next_batch(), dev)
    loss_pruned = loss_of(pruned, eval_batch, cfg)

    # ---- 3. mask-preserving finetune (retraining-based pruning) ------------
    ft_run = finetune(pruned, masks, cfg, trained["stream"], args.steps // 3)
    loss_ft = loss_of(ft_run["state"].params, eval_batch, cfg)
    print(f"loss: dense {loss_dense:.4f} -> pruned {loss_pruned:.4f} "
          f"-> finetuned {loss_ft:.4f}  (the paper's accuracy-recovery shape)")

    # ---- 4. reformat to Tiled-CSL + serve ----------------------------------
    sparse, nbytes = reformat(ft_run["state"].params)
    print(f"Tiled-CSL: {nbytes['dense_bytes'] / 2 ** 20:.1f} MiB "
          f"-> {nbytes['sparse_bytes'] / 2 ** 20:.1f} MiB weights")
    served = serve(sparse, cfg)
    n_tok = sum(len(v) for v in served["done"].values())
    print(f"served {len(served['done'])} requests / {n_tok} tokens in "
          f"{served['seconds']:.1f}s ({n_tok / served['seconds']:.1f} tok/s) "
          f"with sparse weights")
    return dict(cfg=cfg, losses=dict(dense=loss_dense, pruned=loss_pruned,
                                     finetuned=loss_ft),
                masks=masks, params=ft_run["state"].params, sparse=sparse,
                bytes=nbytes, served=served,
                masked_nonzero=ft_run["masked_nonzero"])


if __name__ == "__main__":
    main()
