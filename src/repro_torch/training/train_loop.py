"""Training loop: cross-entropy loss, the train step with gradient
accumulation, and sparsity-mask-preserving updates.

The port's counterpart of ``repro.training.train_loop``. The forward is
``transformer.forward_train`` (params in f32, compute in ``cfg.dtype``,
the MoE aux losses summed); the gradients come from
``torch.autograd.grad`` over every params leaf, and the update is the
port's own ``optimizer`` (the reference's arithmetic). A step is eager
and changes nothing it is given: it returns a new :class:`TrainState`.

Under a mesh (``launch.mesh``) the state is a rank's shard
(``distributed.sharding.shard_params``; the AdamW moments are sharded
like their params), the batch its data slice, and the step runs
tensor-parallel over ``model`` and data-parallel over ``data``: the
gradients and the metrics are mean-reduced over ``data`` in f32, and the
global gradient norm sums each model-split leaf's squares over ``model``
and counts each replicated leaf once.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import sharding, tensor_parallel
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.training import optimizer as opt_mod


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  aux_loss: Any = 0.0, aux_weight: float = 0.01
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token CE in f32. logits ``[..., V]``; targets ``[...]``.
    Codebook logits ``[..., n_cb, V]`` with targets ``[..., n_cb]`` reduce
    over every codebook. The gold logit is gathered; the reference's
    one-hot contraction adds the same single product to zeros."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].to(torch.int64))[..., 0]
    ce = torch.mean(logz - gold)
    aux = torch.as_tensor(aux_loss, dtype=torch.float32, device=ce.device)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def loss_fn(params: Any, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            *, backend: str = "auto", mesh=None):
    """(loss, {"ce", "aux"}) of one batch: tokens ``[B, S]`` (``[B, n_cb,
    S]`` for codebooks) and targets of the same shape."""
    logits, aux = transformer.forward_train(
        params, {"tokens": batch["tokens"]}, cfg, backend=backend, mesh=mesh)
    targets = batch["targets"]
    if cfg.n_codebooks:                          # [B, n_cb, S] -> [B, S, n_cb]
        targets = torch.movedim(targets, 1, -1)
    return cross_entropy(logits, targets, aux)


def batch_to(batch: Dict[str, Any], device: DeviceLike = None
             ) -> Dict[str, torch.Tensor]:
    """A data stream's numpy batch as int64 tensors on ``device``."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(v)).to(dev, torch.int64)
            for k, v in batch.items()}


def value_and_grad(params: Any, batch, cfg: ModelConfig, *,
                   backend: str = "auto", mesh=None):
    """(loss, {"ce", "aux"}, grads) of one batch; the grads have the
    params' structure (zeros where a leaf does not reach the loss)."""
    leaves = opt_mod.tree_map(lambda p: p.detach().requires_grad_(True),
                              params)
    loss, parts = loss_fn(leaves, batch, cfg, backend=backend, mesh=mesh)
    flat = opt_mod.tree_leaves(leaves)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    by_id = {id(p): g for p, g in zip(flat, grads)}

    def grad_of(p):
        g = by_id[id(p)]
        return torch.zeros_like(p) if g is None else g
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            opt_mod.tree_map(grad_of, leaves))


def mesh_global_norm(grads: Any, shardings: Dict[str, Any],
                     mesh) -> torch.Tensor:
    """The global norm of a rank's gradient shards: each leaf that
    ``shardings`` (``sharding.params_shardings`` of the whole params)
    splits over ``model`` has its squares summed over the model ranks, a
    replicated leaf counts once."""
    tp = tensor_parallel.of(mesh)
    split, whole = [], []
    for path, g in sharding.leaves_with_paths(grads):
        sq = torch.sum(torch.square(g.to(torch.float32)))
        (split if tp is not None and sharding.model_sharded(shardings[path])
         else whole).append(sq)
    zero = torch.zeros((), dtype=torch.float32,
                       device=opt_mod.tree_leaves(grads)[0].device)
    total = sum(whole, zero)
    if split:
        total = total + tensor_parallel.all_reduce(sum(split, zero),
                                                   tp.group)
    return torch.sqrt(total)


def _data_mean(x: torch.Tensor, dp) -> torch.Tensor:
    """``x`` averaged over the data ranks in f32, in its own dtype."""
    return (tensor_parallel.all_reduce(x.to(torch.float32), dp.group)
            / dp.size).to(x.dtype)


def make_train_step(cfg: ModelConfig, optimizer, *, masks: Any = None,
                    microbatches: int = 1, backend: str = "auto",
                    mesh=None, shardings: Optional[Dict[str, Any]] = None
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``train_step(state, batch) -> (state, metrics)``; metrics are 0-d
    tensors ``loss``, ``ce``, ``aux`` and ``grad_norm`` (of the unclipped
    gradients). ``microbatches > 1`` splits the batch on axis 0 and
    averages loss, parts and gradients over the slices, as the
    reference's scan does. Under ``mesh`` the state and ``masks`` are a
    rank's shards, the batch its data slice, and ``shardings`` the
    params' specs (``sharding.params_shardings`` of the whole params)."""
    tp, dp = tensor_parallel.of(mesh), tensor_parallel.axis(mesh, "data")
    if tp is not None and shardings is None:
        raise ValueError("a model axis needs the params' shardings")

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        params = state.params
        if microbatches == 1:
            loss, parts, grads = value_and_grad(params, batch, cfg,
                                                 backend=backend, mesh=mesh)
        else:
            n = next(iter(batch.values())).shape[0]
            if n % microbatches:
                raise ValueError(f"batch {n} does not split into "
                                 f"{microbatches} microbatches")
            mb = n // microbatches
            dev = opt_mod.tree_leaves(params)[0].device
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            parts = {"ce": loss, "aux": loss}
            grads = opt_mod.tree_map(torch.zeros_like, params)
            for i in range(microbatches):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l, p, g = value_and_grad(params, part, cfg, backend=backend,
                                         mesh=mesh)
                loss = loss + l
                parts = {k: parts[k] + p[k] for k in parts}
                grads = opt_mod.tree_map(torch.add, grads, g)
            inv = 1.0 / microbatches
            loss = loss * inv
            parts = {k: v * inv for k, v in parts.items()}
            grads = opt_mod.tree_map(lambda g: g * inv, grads)
        if dp is not None:
            grads = opt_mod.tree_map(lambda g: _data_mean(g, dp), grads)
            loss = _data_mean(loss, dp)
            parts = {k: _data_mean(v, dp) for k, v in parts.items()}
        gnorm = (opt_mod.global_norm(grads) if tp is None
                 else mesh_global_norm(grads, shardings, mesh))
        new_params, new_opt = optimizer.update(grads, state.opt_state,
                                               params, masks=masks,
                                               gnorm=gnorm)
        metrics = {"loss": loss, **parts, "grad_norm": gnorm}
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step


def init_train_state(cfg: ModelConfig, optimizer, *, seed: int = 0,
                     device: DeviceLike = None) -> TrainState:
    """Random f32 params from ``seed`` on ``device`` (default ``"cuda"``),
    the optimizer's zero state and step 0."""
    params = transformer.init_model(cfg, seed=seed, device=device,
                                    dtype=torch.float32)
    return TrainState(params=params, opt_state=optimizer.init(params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=resolve_device(device)))
