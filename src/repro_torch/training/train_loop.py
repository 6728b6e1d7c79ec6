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
tensor-parallel over ``model`` and data-parallel over the batch axes
(``pod`` and ``data``): the gradients and the metrics are mean-reduced
over them in f32, and the global gradient norm sums each leaf's squares
over the axes that split it and counts a replicated leaf once. Every
family trains so: the forward's collectives carry their backward, a
leaf that a split block reads whole sums its gradient over ``model``
in the backward (``tensor_parallel.shared``), so each rank's gradient
is the whole gradient of its shard before the data mean, and MoE's aux
loss is the whole batch's on every rank (its data mean is itself).
The reductions after the backward run with gradients off. With
``fsdp`` (ZeRO-3) the params, the AdamW moments and the masks are
shards of ``params_shardings(..., fsdp=True)``: the forward gathers each
layer over ``data`` just before it runs (``transformer.forward_train``),
the gather's backward leaves each rank its shard of the gradient's mean
over ``data``, and the update runs on the shard.
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
            *, backend: str = "auto", mesh=None, fsdp=None):
    """(loss, {"ce", "aux"}) of one batch: tokens ``[B, S]`` (``[B, n_cb,
    S]`` for codebooks) and targets of the same shape; M-RoPE
    ``positions [3, B, S]`` where the batch has them (else arange on all
    three axes)."""
    inputs = {k: batch[k] for k in ("tokens", "positions") if k in batch}
    logits, aux = transformer.forward_train(
        params, inputs, cfg, backend=backend, mesh=mesh, fsdp=fsdp)
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
                   backend: str = "auto", mesh=None, fsdp=None):
    """(loss, {"ce", "aux"}, grads) of one batch; the grads have the
    params' structure (zeros where a leaf does not reach the loss)."""
    leaves = opt_mod.tree_map(lambda p: p.detach().requires_grad_(True),
                              params)
    loss, parts = loss_fn(leaves, batch, cfg, backend=backend, mesh=mesh,
                          fsdp=fsdp)
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
    """The global norm of a rank's gradient shards: each leaf's squares
    summed over the axes that ``shardings`` (``sharding.params_shardings``
    of the whole params) splits it over, so a replicated leaf counts
    once."""
    by_axes: Dict[Tuple[str, ...], list] = {}
    for path, g in sharding.leaves_with_paths(grads):
        axes = tuple(a for a in sharding.split_axes(shardings[path])
                     if tensor_parallel.axis(mesh, a) is not None)
        by_axes.setdefault(axes, []).append(
            torch.sum(torch.square(g.to(torch.float32))))
    zero = torch.zeros((), dtype=torch.float32,
                       device=opt_mod.tree_leaves(grads)[0].device)
    total = zero
    for axes in sorted(by_axes):
        part = sum(by_axes[axes], zero)
        for a in axes:
            part = tensor_parallel.all_reduce(
                part, tensor_parallel.axis(mesh, a).group)
        total = total + part
    return torch.sqrt(total)


def _mean_over(x: torch.Tensor, axes) -> torch.Tensor:
    """``x`` averaged over each of ``axes`` in f32, in its own dtype."""
    if not axes:
        return x
    y = x.to(torch.float32)
    for ax in axes:
        y = tensor_parallel.all_reduce(y, ax.group) / ax.size
    return y.to(x.dtype)


def make_train_step(cfg: ModelConfig, optimizer, *, masks: Any = None,
                    microbatches: int = 1, backend: str = "auto",
                    mesh=None, shardings: Optional[Dict[str, Any]] = None,
                    fsdp: bool = False, donate: bool = False
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``train_step(state, batch) -> (state, metrics)``; metrics are 0-d
    tensors ``loss``, ``ce``, ``aux`` and ``grad_norm`` (of the unclipped
    gradients). ``microbatches > 1`` splits the batch on axis 0 and
    averages loss, parts and gradients over the slices, as the
    reference's scan does. Under ``mesh`` the state and ``masks`` are a
    rank's shards, the batch its slice over the batch axes, and
    ``shardings`` the params' specs (``sharding.params_shardings`` of
    the whole params, with ``fsdp`` as given here). ``fsdp`` runs
    ZeRO-3 (the state is a shard of the ``fsdp=True`` specs). ``donate``
    (AdamW) writes the new state over the one it is given, as the
    reference's jitted step donates its state: the same values, and a
    step that holds one state instead of two."""
    tp = tensor_parallel.of(mesh)
    batch_axes = [ax for ax in (tensor_parallel.axis(mesh, a)
                                for a in ("pod", "data")) if ax is not None]
    names = [a for a in ("pod", "data")
             if tensor_parallel.axis(mesh, a) is not None]
    if (tp is not None or fsdp) and shardings is None:
        raise ValueError("a model axis or FSDP needs the params' shardings")
    fsdp_specs = shardings if fsdp else None

    def grad_mean(path: str, g: torch.Tensor) -> torch.Tensor:
        """The mean over the batch axes that do not split the leaf (the
        FSDP gather's backward has taken the mean over ``data``)."""
        split = sharding.split_axes(shardings[path]) if fsdp else ()
        return _mean_over(g, [ax for ax, n in zip(batch_axes, names)
                              if n not in split])

    def grads_of(params, batch) -> Tuple[Dict, Any]:
        if microbatches == 1:
            loss, parts, grads = value_and_grad(params, batch, cfg,
                                                 backend=backend, mesh=mesh,
                                                 fsdp=fsdp_specs)
        else:
            n = batch["tokens"].shape[0]
            if n % microbatches:
                raise ValueError(f"batch {n} does not split into "
                                 f"{microbatches} microbatches")
            mb = n // microbatches
            dev = opt_mod.tree_leaves(params)[0].device
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            parts = {"ce": loss, "aux": loss}
            grads = opt_mod.tree_map(torch.zeros_like, params)
            for i in range(microbatches):
                rows = slice(i * mb, (i + 1) * mb)
                part = {k: v[:, rows] if k == "positions" else v[rows]
                        for k, v in batch.items()}
                l, p, g = value_and_grad(params, part, cfg, backend=backend,
                                         mesh=mesh, fsdp=fsdp_specs)
                loss = loss + l
                parts = {k: parts[k] + p[k] for k in parts}
                grads = opt_mod.tree_map(torch.add, grads, g)
            inv = 1.0 / microbatches
            loss = loss * inv
            parts = {k: v * inv for k, v in parts.items()}
            grads = opt_mod.tree_map(lambda g: g * inv, grads)
        with torch.no_grad():
            if batch_axes:
                grads = _map_paths(grad_mean, grads)
                loss = _mean_over(loss, batch_axes)
                parts = {k: _mean_over(v, batch_axes)
                         for k, v in parts.items()}
            gnorm = (opt_mod.global_norm(grads) if tp is None and not fsdp
                     else mesh_global_norm(grads, shardings, mesh))
        return {"loss": loss, **parts, "grad_norm": gnorm}, grads

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        metrics, grads = grads_of(state.params, batch)
        with torch.no_grad():
            new_params, new_opt = optimizer.update(
                grads, state.opt_state, state.params, masks=masks,
                gnorm=metrics["grad_norm"], **({"inplace": True} if donate
                                               else {}))
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step


def _map_paths(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a tree's tensor leaves, by
    ``sharding.leaves_with_paths``' paths."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{prefix}['{k}']")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_paths(fn, v, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return None if tree is None else fn(prefix, tree)


def init_train_state(cfg: ModelConfig, optimizer, *, seed: int = 0,
                     device: DeviceLike = None) -> TrainState:
    """Random f32 params from ``seed`` on ``device`` (default ``"cuda"``),
    the optimizer's zero state and step 0."""
    params = transformer.init_model(cfg, seed=seed, device=device,
                                    dtype=torch.float32)
    return TrainState(params=params, opt_state=optimizer.init(params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=resolve_device(device)))
