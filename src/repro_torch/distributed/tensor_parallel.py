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
  KV heads that ranks share where there are fewer than model ranks);
  :func:`gather_dim` is the same from each rank's block of one dim.

With them, the gradient of a replicated leaf that sits outside a
model-parallel region (a norm scale before :func:`copy_to`, a
row-parallel bias after the reduce) is the same whole gradient on every
model rank. Inside a region (between :func:`copy_to` or a gather and the
row-parallel reduce) each rank's gradient of a whole tensor is only its
share, which the gather's or :func:`copy_to`'s backward sums. A
replicated leaf read there (the RG-LRU and SSM gates, norms and convs,
MLA's ``w_dkv``, a weight the rules hold whole) passes through
:func:`shared`: its gradient is summed over ``model`` in the backward,
so every rank holds the whole one. A whole value that every rank adds
to the loss from inside a region (the MoE aux loss) passes through
:func:`model_share`, which divides its gradient by the ranks that the
region's gathers sum it over. Sums are reduced in f32, so row-parallel
partials round once, after the reduce.

Every collective of a train step carries its backward: an
:func:`all_reduce` reached while gradients are on counts in
``raw_under_grad`` (the tests hold it at 0 over a train step); the
helpers above run it raw only where no gradient is wanted.

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
import torch.nn.functional as F


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


# raw all-reduces reached while gradients were on (autograd sees them as
# the identity): 0 over a train step
raw_under_grad = 0


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM, *,
               kind: str = "all-reduce") -> torch.Tensor:
    """``x`` reduced over ``group`` (a new tensor; ``x`` is left as it
    was), with no backward: autograd sees the identity, so a caller that
    differentiates uses :func:`sum_over` or the helpers below. On a
    :class:`DryGroup` nothing moves: the result is ``x``'s shape and the
    collective is recorded as ``kind``, the operation the all-reduce
    stands for (``"all-gather"`` for a zero-filled gather)."""
    global raw_under_grad
    if torch.is_grad_enabled():
        raw_under_grad += 1
    if isinstance(group, DryGroup):
        group.records.append((kind, group.axis,
                              x.numel() * x.element_size()))
        return x.clone()
    out = x.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def _raw(x: torch.Tensor, group, op=dist.ReduceOp.SUM, *,
         kind: str = "all-reduce") -> torch.Tensor:
    """:func:`all_reduce` where no gradient is wanted."""
    with torch.no_grad():
        return all_reduce(x, group, op, kind=kind)


def _wants_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def sum_over(x: torch.Tensor, group, *,
             kind: str = "all-reduce") -> torch.Tensor:
    """``x`` summed over ``group``, its backward the same sum of the
    gradient: the adjoint where each rank's loss is its own and the
    objective their sum (the data axes: a whole-batch statistic, the
    MoE experts' blocks summed over the data ranks a subgroup spans), or
    where each rank uses the result its own way (:func:`gather_from`)."""
    if not _wants_grad(x):
        return _raw(x.contiguous(), group, kind=kind)
    return _SumOver.apply(x, group, kind)


def gather_dim(x: torch.Tensor, dim: int, ax: Axis, *,
               kind: str = "all-gather") -> torch.Tensor:
    """The whole tensor from every rank's equal block of dim ``dim`` of
    it (this rank's at ``ax.rank``): a zero-filled all-reduce, exact in
    any dtype. Its backward sums the gradient over the ranks and keeps
    this rank's block (:func:`gather_from`)."""
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * ax.size
    if _wants_grad(x):
        pad = [0, 0] * (x.dim() - 1 - dim) + [ax.rank * n,
                                               (ax.size - 1 - ax.rank) * n]
        return _SumOver.apply(F.pad(x, pad), ax.group, kind)
    full = x.new_zeros(shape)
    full.narrow(dim, ax.rank * n, n).copy_(x)
    return _raw(full, ax.group, kind=kind)


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, kind):
        ctx.group, ctx.kind = group, kind
        return all_reduce(x.contiguous(), group, kind=kind)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous(), ctx.group), None, None


class _ModelShare(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, size):
        ctx.size = size
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.size, None


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
    if not _wants_grad(x):
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
    if not _wants_grad(x):
        return x
    return _CopyTo.apply(x, tp.group)


def shared(tree: Any, tp: Optional[Axis]) -> Any:
    """A replicated leaf (or a dict of them) read inside a
    model-parallel region, where each rank's gradient is its share:
    :func:`copy_to` of each tensor, so that its gradient is summed over
    ``model`` and every rank holds the whole one. The tree itself
    without ``tp`` or where no gradient is wanted."""
    if tp is None:
        return tree
    if isinstance(tree, dict):
        return {k: shared(v, tp) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return copy_to(tree, tp)
    return tree


def model_share(x: torch.Tensor, tp: Optional[Axis]) -> torch.Tensor:
    """A whole value that every model rank computes inside a region and
    adds to its loss: identity forward, the gradient divided by the model
    ranks, since the region's gathers sum it over them."""
    if tp is None or not _wants_grad(x):
        return x
    return _ModelShare.apply(x, tp.size)


def reduce_from(x: torch.Tensor, tp: Axis) -> torch.Tensor:
    """All-reduce (sum) forward, identity backward."""
    if not _wants_grad(x):
        return _raw(x.contiguous(), tp.group)
    return _ReduceFrom.apply(x, tp.group)


def gather_from(x: torch.Tensor, tp: Axis) -> torch.Tensor:
    """All-reduce (sum) forward and backward."""
    return sum_over(x, tp.group, kind="all-gather")
