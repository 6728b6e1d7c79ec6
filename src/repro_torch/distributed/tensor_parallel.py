"""Tensor-parallel collectives of the model: the Megatron pair.

An :class:`Axis` is this rank's view of one mesh axis: its group, size
and index; :func:`of` gives the ``model`` axis, which the model splits.
Every collective of the forward is an all-reduce (gloo takes CUDA
tensors for all-reduce and broadcast only, so one code path serves NCCL
and gloo):

* :func:`copy_to` — identity forward, all-reduce backward: before a
  column-parallel product, whose input every rank holds whole;
* :func:`reduce_from` — all-reduce forward, identity backward: after a
  row-parallel product's partial sums, the vocab-parallel embedding's
  masked lookups and the logits head's zero-filled blocks (every rank
  takes the same loss of the whole logits);
* :func:`gather_from` — all-reduce forward and backward: the ranks'
  zero-filled blocks of a tensor that each rank uses its own way (the
  KV heads that ranks share where there are fewer than model ranks).

With them, the gradient of a replicated leaf (a norm scale, a
row-parallel bias) is the same on every model rank. Sums are reduced in
f32, so row-parallel partials round once, after the reduce.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Axis:
    """This rank's place on one mesh axis. ``kv_heads`` is the whole
    model's KV head count, where ``transformer.rank_config`` splits
    attention over this axis."""
    group: Any
    size: int
    rank: int
    kv_heads: int = 0


def axis(mesh, name: str) -> Optional[Axis]:
    """The mesh's axis ``name``; None without a mesh, without the axis,
    or where it has one rank (nothing is split)."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return None
    size = int(mesh.size(mesh.mesh_dim_names.index(name)))
    if size == 1:
        return None
    return Axis(group=mesh.get_group(name), size=size,
                rank=int(mesh.get_local_rank(name)))


def of(mesh) -> Optional[Axis]:
    """The ``model`` axis, which tensor parallelism splits."""
    return axis(mesh, "model")


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over ``group`` (a new tensor; ``x`` is left as it
    was)."""
    out = x.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.contiguous(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous(), ctx.group), None


def copy_to(x: torch.Tensor, tp: Axis) -> torch.Tensor:
    """Identity forward, all-reduce of the gradient backward."""
    if not torch.is_grad_enabled() or not x.requires_grad:
        return x
    return _CopyTo.apply(x, tp.group)


def reduce_from(x: torch.Tensor, tp: Axis) -> torch.Tensor:
    """All-reduce (sum) forward, identity backward."""
    if not torch.is_grad_enabled() or not x.requires_grad:
        return all_reduce(x.contiguous(), tp.group)
    return _ReduceFrom.apply(x, tp.group)


def gather_from(x: torch.Tensor, tp: Axis) -> torch.Tensor:
    """All-reduce (sum) forward and backward."""
    if not torch.is_grad_enabled() or not x.requires_grad:
        return all_reduce(x.contiguous(), tp.group)
    return _GatherFrom.apply(x, tp.group)
