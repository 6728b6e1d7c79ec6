"""Optimizers written out by hand: AdamW, SGD-M, schedules, global-norm
clipping and sparsity-mask-preserving updates.

The port's counterpart of ``repro.training.optimizer``, over nested dicts
and lists of tensors (the port's params trees). The arithmetic is the
reference's, op for op: the clip scale ``clip_norm / (gnorm + 1e-9)``,
bias corrections with the step in f32, ``eps`` outside the square root,
decoupled weight decay ``u + wd * p`` on every leaf (norms and
embeddings included), and the masks applied after the update.
``torch.optim.AdamW`` computes the same algebra with other rounding, so
the port does not use it. The state mirrors the params tree, as in the
reference (an AdamW moment has its parameter's shape).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, NamedTuple, Optional, Union

import torch

Schedule = Callable[[Union[int, torch.Tensor]], torch.Tensor]


# ---------------------------------------------------------------------------
# trees: nested dicts, lists and tuples whose leaves are tensors (or None)
# ---------------------------------------------------------------------------

def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure). A ``None`` in ``tree`` is a leaf, so a mask
    tree with ``None`` where a leaf is unmasked maps like its params."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in the reference's order (dict keys sorted,
    as ``jax.tree.leaves`` flattens them); ``None`` leaves dropped."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves))


def apply_masks(params: Any, masks: Any) -> Any:
    """Zero out pruned positions. ``masks``: 0/1 (or bool) tensors, or
    ``None`` where a leaf is unmasked."""
    return tree_map(lambda m, p: p if m is None else p * m.to(p.dtype),
                    masks, params)


def _clip_scale(grads: Any, clip_norm: Optional[float],
                gnorm: Optional[torch.Tensor] = None
                ) -> Optional[torch.Tensor]:
    """The factor that clips ``grads`` to ``clip_norm`` (None: no clip)."""
    if clip_norm is None:
        return None
    if gnorm is None:
        gnorm = global_norm(grads)
    return torch.clamp(clip_norm / (gnorm + 1e-9), max=1.0)


def _clip(grads: Any, clip_norm: Optional[float],
          gnorm: Optional[torch.Tensor] = None) -> Any:
    scale = _clip_scale(grads, clip_norm, gnorm)
    return grads if scale is None else tree_map(lambda g: g * scale, grads)


class _Moved(NamedTuple):
    """One leaf's new first and second moments and param."""
    m: torch.Tensor
    v: torch.Tensor
    p: torch.Tensor


def _step_tensor(params: Any) -> torch.Tensor:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=dev)


# ---------------------------------------------------------------------------
# AdamW, SGD-M
# ---------------------------------------------------------------------------

class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[Schedule, float] = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0

    def init(self, params: Any) -> AdamWState:
        return AdamWState(step=_step_tensor(params),
                          mu=tree_map(torch.zeros_like, params),
                          nu=tree_map(torch.zeros_like, params))

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(step)
        return torch.tensor(self.lr, dtype=torch.float32, device=step.device)

    def update(self, grads: Any, state: AdamWState, params: Any, *,
               masks: Any = None, gnorm: Optional[torch.Tensor] = None,
               inplace: bool = False):
        """One step; returns (new params, new state). ``masks`` (a tree of
        0/1 tensors, ``None`` where unmasked) pins pruned weights at zero:
        the retraining-based pruning loop. ``gnorm`` is the gradients'
        global norm where the caller knows it better than the tree it
        holds (the leaves of a rank's shard). The update runs leaf by leaf
        (the clip, both moments, the param and its mask, in the
        reference's arithmetic), so no whole tree of intermediates is
        held: a step holds the old and the new state and the gradients.
        ``inplace`` writes the new moments and params into the old ones
        (the reference's donated step): the same values bit for bit, a
        step then holds one state, the gradients and a leaf's few
        temporaries, and ``state`` and ``params`` are the new ones."""
        scale = _clip_scale(grads, self.clip_norm, gnorm)
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        stepf = step.to(torch.float32)
        mu_hat_c = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                                device=step.device), stepf)
        nu_hat_c = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                                device=step.device), stepf)
        lr = self._lr(step)

        def leaf(g, m, v, p, mask):
            if scale is not None:
                g = g * scale
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * torch.square(g)
            u = (m / mu_hat_c) / (torch.sqrt(v / nu_hat_c) + self.eps)
            u = u + self.weight_decay * p
            p = (p - lr * u).to(p.dtype)
            return _Moved(m, v, p if mask is None else p * mask.to(p.dtype))

        def leaf_inplace(g, m, v, p, mask):
            # leaf's operations one by one, each result written over its
            # operand's buffer
            if scale is not None:
                g = g * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            del g
            u = m / mu_hat_c
            u.div_(torch.sqrt(v / nu_hat_c).add_(self.eps))
            u.add_(self.weight_decay * p)
            p.copy_(p - lr * u)
            if mask is not None:
                p.mul_(mask.to(p.dtype))
            return _Moved(m, v, p)

        if inplace:
            leaf = leaf_inplace
        if masks is None:
            masks = tree_map(lambda _: None, params)
        moved = tree_map(leaf, grads, state.mu, state.nu, params, masks)
        return (tree_map(lambda o: o.p, moved),
                AdamWState(step=step, mu=tree_map(lambda o: o.m, moved),
                           nu=tree_map(lambda o: o.v, moved)))


class SGDMState(NamedTuple):
    step: torch.Tensor
    mom: Any


@dataclasses.dataclass(frozen=True)
class SGDM:
    lr: Union[Schedule, float] = 1e-2
    momentum: float = 0.9
    clip_norm: Optional[float] = 1.0

    def init(self, params: Any) -> SGDMState:
        return SGDMState(step=_step_tensor(params),
                         mom=tree_map(torch.zeros_like, params))

    def update(self, grads: Any, state: SGDMState, params: Any, *,
               masks: Any = None, gnorm: Optional[torch.Tensor] = None):
        grads = _clip(grads, self.clip_norm, gnorm)
        step = state.step + 1
        mom = tree_map(lambda m, g: self.momentum * m + g, state.mom, grads)
        lr = self.lr(step) if callable(self.lr) else self.lr
        new_params = tree_map(lambda p, m: (p - lr * m).to(p.dtype),
                              params, mom)
        if masks is not None:
            new_params = apply_masks(new_params, masks)
        return new_params, SGDMState(step=step, mom=mom)


# ---------------------------------------------------------------------------
# schedules: the step as an int or a 0-d tensor
# ---------------------------------------------------------------------------

def _step_f32(step: Union[int, torch.Tensor]) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Schedule:
    def fn(step):
        step = _step_f32(step)
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return fn


def linear_schedule(peak_lr: float, warmup: int, total: int) -> Schedule:
    def fn(step):
        step = _step_f32(step)
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        return torch.where(step < warmup, warm, peak_lr * (1.0 - frac))
    return fn
