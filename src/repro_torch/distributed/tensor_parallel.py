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

Two more pieces serve the sequence-sharded K/V cache and FSDP:

* :func:`attend_combine` — the partial-softmax combine of an attention
  whose keys are split over an axis (``model`` or ``data``): each rank
  scores its block of positions; an all-reduce MAX of the row maxima,
  an all-reduce SUM of the exp-sums rescaled to that maximum, then each
  rank's weights divided by the whole sum, its weighted V, and an
  all-reduce SUM of those (all f32 up to the one division). A rank whose
  block holds no live position adds exact zeros.
* :func:`fsdp_gather` — ZeRO-3: forward, a leaf's ``data`` shards
  gathered into the leaf (a zero-filled all-reduce); backward, the
  gradient summed over ``data`` and this rank's shard kept, divided by
  the data ranks (their mean).

A dry mesh (``launch.mesh.make_production_mesh``) has :class:`DryGroup`
groups: a collective on one moves nothing, returns a meta tensor of its
result's shape and records ``(kind, axis, bytes)``, the counterpart of
the collective bytes the reference reads off its compiled HLO.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist


class DryGroup:
    """The group of one axis of a dry mesh: no process, no device.
    ``records`` is the mesh's list of ``(kind, axis, bytes)``."""

    def __init__(self, axis: str, size: int, records: list):
        self.axis, self.size, self.records = axis, size, records

    def __repr__(self) -> str:
        return f"DryGroup({self.axis!r}, {self.size})"


@dataclasses.dataclass(frozen=True)
class Axis:
    """This rank's place on one mesh axis. Where
    ``transformer.rank_config`` splits attention over this axis,
    ``heads`` and ``kv_heads`` are the whole model's head counts and
    ``split_heads`` says whether each rank computes its own query heads
    (False: every rank computes all of them, their projections split by
    element and gathered whole); ``experts`` is the MoE experts this rank
    holds (E / size under expert parallelism, all E where E does not
    divide the axis and each expert is split instead; 0 without MoE)."""
    group: Any
    size: int
    rank: int
    kv_heads: int = 0
    heads: int = 0
    split_heads: bool = True
    experts: int = 0


def axis(mesh, name: str) -> Optional[Axis]:
    """The mesh's axis ``name``; None without a mesh, without the axis,
    or where it has one rank (nothing is split). A dry mesh's axis has
    a :class:`DryGroup`."""
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


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM, *,
               kind: str = "all-reduce") -> torch.Tensor:
    """``x`` reduced over ``group`` (a new tensor; ``x`` is left as it
    was). On a :class:`DryGroup` nothing moves: the result is ``x``'s
    shape and the collective is recorded as ``kind``, the operation the
    all-reduce stands for (``"all-gather"`` for a zero-filled gather)."""
    if isinstance(group, DryGroup):
        group.records.append((kind, group.axis,
                              x.numel() * x.element_size()))
        return x.clone()
    out = x.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def gather_dim(x: torch.Tensor, dim: int, ax: Axis, *,
               kind: str = "all-gather") -> torch.Tensor:
    """The whole tensor from every rank's equal block of dim ``dim`` of
    it (this rank's at ``ax.rank``): a zero-filled all-reduce, exact in
    any dtype."""
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * ax.size
    full = x.new_zeros(shape)
    full.narrow(dim, ax.rank * n, n).copy_(x)
    return all_reduce(full, ax.group, kind=kind)


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
        return all_reduce(x.contiguous(), group, kind="all-gather")

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous(), ctx.group), None


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, dp):
        ctx.dim, ctx.dp = dim, dp
        return gather_dim(x, dim, dp)

    @staticmethod
    def backward(ctx, grad):
        dp, dim = ctx.dp, ctx.dim
        whole = all_reduce(grad.contiguous(), dp.group, kind="reduce-scatter")
        n = grad.shape[dim] // dp.size
        return whole.narrow(dim, dp.rank * n, n) / dp.size, None, None


def fsdp_gather(x: torch.Tensor, dim: int, dp: Axis) -> torch.Tensor:
    """ZeRO-3's gather of a leaf split over ``data`` at ``dim``; its
    backward keeps this rank's shard of the gradient's mean over the data
    ranks."""
    if not torch.is_grad_enabled() or not x.requires_grad:
        return gather_dim(x, dim, dp)
    return _FsdpGather.apply(x, dim, dp)


def attend_combine(scores: torch.Tensor, v: torch.Tensor, ax: Axis,
                   out_fn) -> torch.Tensor:
    """Softmax attention over keys split over ``ax``: ``scores`` (f32,
    masked columns at a large negative, the keys on the last dim) are
    this rank's block's; ``out_fn(weights, v)`` is the weighted sum
    (f32; it casts the weights as the unsplit attention does). The
    weights are ``exp(s - M) / L`` with ``M`` and ``L`` the whole row's
    maximum and exp-sum, kept in f32 up to that division, as
    ``torch.softmax`` over the whole row computes them, so the result is
    the unsplit attention's up to the order of the sums."""
    m = torch.amax(scores, dim=-1, keepdim=True)
    m = all_reduce(m, ax.group, dist.ReduceOp.MAX)
    e = torch.exp(scores - m)
    denom = all_reduce(torch.sum(e, dim=-1, keepdim=True), ax.group)
    return all_reduce(out_fn(e / denom, v), ax.group)


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
        return all_reduce(x.contiguous(), tp.group, kind="all-gather")
    return _GatherFrom.apply(x, tp.group)
