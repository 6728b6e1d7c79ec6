"""Mixture-of-Experts: top-k routed experts and an optional shared expert.

The port's counterpart of ``repro.models.moe``: qwen2-moe-a2.7b (60
routed experts top-4, d_expert 1408, four shared experts fused into one
5632-wide SwiGLU) and qwen3-moe-30b-a3b (128 routed experts top-8,
d_expert 768, no shared expert).

Dispatch is the reference's dropping scheme: the tokens are cut into
subgroups of ``moe_subgroup``; within a subgroup each expert takes at most
C = int(ceil(sg * k / E) * capacity_factor) tokens, in token order, and
routing builds a one-hot dispatch tensor ``[G, sg, E, C]`` that two
einsums contract, so every expert multiplies a fixed ``[G * C, d]`` block
(zeros where it has fewer tokens) and no shape depends on the routing: a
decode step captures as one CUDA graph. A token past its expert's
capacity is dropped from it, so a row's output depends on the rows ahead
of it in its subgroup, the bucket padding and a stepper's idle slots
included, as in the reference.

The expert weights are stacks ``gate``/``up`` ``[E, d_expert, d]`` and
``down`` ``[E, d, d_expert]``, dense or Tiled-CSL expert stacks
(``tiled_csl.encode_stack``), which run through one expert-batched LSCD
launch a projection (``sparse_linear.linear_batched``), the counterpart
of the reference's ``jax.vmap`` over the per-expert kernel.

Under a mesh (``tp``, the ``model`` axis; ``rows``, how the batch rows
split over the data axes) the routing is the unsharded one on every
rank. The router is column-parallel over the experts and each rank's
block of the logits is gathered whole (a zero-filled all-reduce), so
softmax, top-k and the capacity positions run on one tensor, identical
on every model rank. Where E divides the model axis (expert parallelism,
EP) a rank dispatches to its own E/m experts, one batched launch a
projection at E/m; else every rank holds every expert's column share of
``gate``/``up`` and row share of ``down`` (tensor parallelism inside each
expert). Either way the combine gives a partial y, which the shared
expert's row-parallel partial joins; the ranks sum it in f32. Where a
subgroup spans several data ranks' rows (a decode batch split finer than
``moe_subgroup``, or a train batch split over the data ranks), each
rank's capacity positions start after the earlier ranks' counts (an
exclusive scan over the data axes) and every expert's ``[C, d]`` block
is summed over those ranks before its FFN, as the reference's
contraction over a data-sharded token axis sums it.

In training (``train``) the aux loss is the whole batch's, as the
reference's is over every token: ``me`` and ``fe`` are summed over the
data ranks (``me``'s sum carries its backward) before their product, so
every data rank adds the same aux to its loss and the data mean of the
gradients leaves its gradient whole. Every collective here carries its
backward (``tensor_parallel.sum_over``): the span's sum and the gathers
sum the gradient over the same ranks. Under ``tp`` the router's gathered
logits and everything after them are a model-parallel region, whose
gradients the gather sums: the block's input enters it through
``copy_to`` and the aux loss through ``model_share``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import sparse_linear, tiled_csl
from repro_torch.distributed import tensor_parallel
from repro_torch.models import layers, nn
from repro_torch.models.config import ModelConfig


class RowSplit(NamedTuple):
    """How a mesh splits the batch rows: over ``axes``
    (``tensor_parallel.Axis``, in the layout's order) into ``parts``, this
    rank's rows being part ``index`` (row-major over the axes)."""
    axes: tuple
    parts: int
    index: int


def init_moe(gen: torch.Generator, cfg: ModelConfig, device,
             dtype=torch.float32) -> dict:
    """The router ``[E, d]``, the routed stacks and, where the config has
    shared experts, their fused SwiGLU (width ``d_shared_expert *
    n_shared_experts``), drawn from ``gen`` in that order."""
    d, e, dff = cfg.d_model, cfg.n_routed_experts, cfg.d_expert

    def stack(rows, cols):
        w = torch.randn((e, rows, cols), generator=gen, dtype=torch.float32,
                        device=device)
        return (w * cols ** -0.5).to(dtype)
    p = {"router": {"w": nn.dense_init(gen, e, d, device, dtype)},
         "gate": stack(dff, d), "up": stack(dff, d), "down": stack(d, dff)}
    if cfg.n_shared_experts:
        p["shared"] = layers.init_swiglu_mlp(
            gen, d, cfg.d_shared_expert * cfg.n_shared_experts, device,
            dtype)
    return p


def _expert_ffn(params: dict, xe: torch.Tensor, *, backend: str = "auto",
                tp=None, width: int = 0) -> torch.Tensor:
    """xe ``[E, C*, d]`` -> ``[E, C*, d]``: every expert's SwiGLU on its
    block, one batched product a projection. With Tiled-CSL stacks the
    hidden width is the padded out dim (``gate.shape[0]``), as in the
    reference; the padded rows give silu(0) * 0. With ``tp`` (tensor
    parallelism inside each expert, ``width`` the whole ``d_expert``)
    ``gate``/``up`` are column shares and ``down`` a row share: this
    rank's f32 partial."""
    gate = params["gate"]
    d = xe.shape[-1]
    if tp is not None:
        g, u = (sparse_linear.column_parallel_batched(
            params[n], xe, out=width, tp=tp, backend=backend)
            for n in ("gate", "up"))
        return sparse_linear.row_partial_batched(
            params["down"], F.silu(g) * u, out=d, tp=tp, backend=backend)
    dff = (gate.shape[0] if isinstance(gate, tiled_csl.TiledCSL)
           else gate.shape[1])
    g = sparse_linear.linear_batched(gate, xe, declared_out=dff,
                                     backend=backend)
    u = sparse_linear.linear_batched(params["up"], xe, declared_out=dff,
                                     backend=backend)
    return sparse_linear.linear_batched(params["down"], F.silu(g) * u,
                                        declared_out=d, backend=backend)


def _batch_gather(x: torch.Tensor, rows: RowSplit) -> torch.Tensor:
    """``[parts, *x.shape]`` with every data rank's ``x`` at its part: a
    zero-filled all-reduce over each axis in turn, in f32 (exact); its
    backward sums the gradient over the same ranks."""
    pad = [0, 0] * x.dim() + [rows.index, rows.parts - 1 - rows.index]
    full = torch.nn.functional.pad(x.to(torch.float32)[None], pad)
    for ax in rows.axes:
        full = tensor_parallel.sum_over(full, ax.group, kind="all-gather")
    return full


def _router_logits(w, xt: torch.Tensor, E: int, tp, backend: str):
    """The whole router logits ``[G, sg, E]`` (f32) on every rank."""
    if tp is None:
        y = sparse_linear.linear(w, xt, declared_out=E, backend=backend)
    else:
        y = sparse_linear.column_gathered(w, xt, out=E, tp=tp,
                                          backend=backend)
    return y.to(torch.float32)


def top_k(probs: torch.Tensor, k: int):
    """The ``k`` largest values on the last dim and their indices, the
    lower index first among equal values, as ``jax.lax.top_k`` orders
    them (``torch.topk`` breaks ties its own way): a descending stable
    sort cut to ``k``, on the device with no host read."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_block(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
              backend: str = "auto", tp=None,
              rows: Optional[RowSplit] = None, train: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x ``[B, S, d]`` -> (y ``[B, S, d]``, the Switch aux loss): routed
    top-k with capacity dropping, then the shared expert. The B * S
    tokens must split into whole subgroups (the reference asserts it).

    ``tp`` (``transformer.rank_config``'s axis, ``tp.experts`` the
    experts this rank holds) runs the block over the model ranks;
    ``rows`` says how the batch rows split over the data axes (None: every
    rank holds every row), so that the subgroups are the unsharded
    batch's: a rank's rows hold whole subgroups, or a subgroup spans
    ``sg / (B * S)`` consecutive data ranks. With ``train`` the aux loss
    is the whole batch's; else (serving, which discards it) that of this
    rank's rows."""
    bsz, s, d = x.shape
    E, k = cfg.n_routed_experts, cfg.top_k
    T = bsz * s
    parts = rows.parts if rows is not None else 1
    sg = min(cfg.moe_subgroup, T * parts)
    if (T * parts) % sg:
        raise ValueError(f"{T * parts} tokens do not split into subgroups "
                         f"of {sg}")
    span = 1                       # data ranks a subgroup spans
    if T % sg:
        if sg % T:
            raise ValueError(
                f"a rank's {T} tokens neither hold whole subgroups of {sg} "
                f"nor split one evenly")
        span = sg // T
    G = max(T // sg, 1)
    xt = x.reshape(G, T // G, d)
    # the router's and the routed experts' input: its gradient is each
    # rank's share (the shared expert's copies its own)
    xin = xt if tp is None else tensor_parallel.copy_to(xt, tp)

    logits = _router_logits(params["router"]["w"], xin, E, tp, backend)
    probs = torch.softmax(logits, dim=-1)                       # [G, sg, E]
    gate_vals, idx = top_k(probs, k)                            # [G, sg, k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # load-balancing aux loss (Switch): E * sum_e f_e * p_e
    experts = torch.arange(E, device=x.device)
    onehot_k = (idx[..., None] == experts).to(torch.float32)   # [G,sg,k,E]
    oh_e = onehot_k.sum(dim=2)                                  # [G, sg, E]
    aux = _aux_loss(probs, oh_e, E, rows if train else None, tp)

    C = max(int(-(-sg * k // E) * cfg.capacity_factor), 1)
    gates_e = torch.einsum("gsk,gske->gse", gate_vals, onehot_k)
    pos_e = _positions(oh_e, rows, span)
    # A compare, not F.one_hot: -1 (not chosen) and >= C (over capacity)
    # give all-zero rows, as jax.nn.one_hot does, and no host read.
    dispatch = (pos_e[..., None] == torch.arange(C, device=x.device)
                ).to(torch.float32)                             # [G,sg,E,C]
    combine = dispatch * gates_e[..., None]
    shared_ff = cfg.d_shared_expert * cfg.n_shared_experts
    if tp is None and span == 1:
        xe = torch.einsum("gsec,gsd->egcd", dispatch.to(x.dtype), xt)
        ye = _expert_ffn(params, xe.reshape(E, G * C, d), backend=backend)
        y = torch.einsum("gsec,egcd->gsd", combine.to(x.dtype),
                         ye.reshape(E, G, C, d))
        if cfg.n_shared_experts:
            y = y + layers.swiglu_mlp(params["shared"], xt, d_ff=shared_ff,
                                      d_model=d, backend=backend)
        return y.reshape(bsz, s, d), aux

    ep = tp is not None and tp.experts < E
    lo, n = (tp.rank * tp.experts, tp.experts) if ep else (0, E)
    xe = torch.einsum("gsec,gsd->egcd", dispatch[:, :, lo:lo + n].to(x.dtype),
                      xin)
    if span > 1:                  # each expert's block summed over the span
        xe = _span_sum(xe, rows, span).to(x.dtype)
    ye = _expert_ffn(params, xe.reshape(n, G * C, d), backend=backend,
                     tp=None if ep else tp, width=cfg.d_expert)
    y = torch.einsum("gsec,egcd->gsd", combine[:, :, lo:lo + n],
                     ye.reshape(n, G, C, d).to(torch.float32))
    if cfg.n_shared_experts:
        y = y + layers.swiglu_mlp(params["shared"], xt, d_ff=shared_ff,
                                  d_model=d, backend=backend, tp=tp,
                                  partial=True).to(torch.float32)
    if tp is not None:
        y = tensor_parallel.reduce_from(y, tp)
    return y.to(x.dtype).reshape(bsz, s, d), aux


def _aux_loss(probs: torch.Tensor, oh_e: torch.Tensor, E: int,
              rows: Optional[RowSplit], tp) -> torch.Tensor:
    """The Switch aux loss ``E * sum_e me_e * fe_e`` of the routing
    probabilities ``[G, sg, E]`` and the picks ``oh_e``: with ``rows``
    over the whole batch (each rank's means summed over the data ranks,
    ``me``'s with its backward; the ranks hold equal token counts), else
    over these tokens. Under ``tp`` its gradient enters the router's
    region through ``model_share``."""
    me = probs.mean(dim=(0, 1))
    fe = oh_e.mean(dim=(0, 1))
    if rows is not None:
        for ax in rows.axes:
            me = tensor_parallel.sum_over(me, ax.group)
            with torch.no_grad():
                fe = tensor_parallel.all_reduce(fe, ax.group)
        me, fe = me / rows.parts, fe / rows.parts
    return tensor_parallel.model_share(E * torch.sum(me * fe), tp)


def _positions(oh_e: torch.Tensor, rows: Optional[RowSplit],
               span: int) -> torch.Tensor:
    """Each token's position in the capacity of each expert it picked
    (``oh_e [G, sg, E]`` 0/1), in token order within its subgroup; -1
    where not picked. Where the subgroup spans ``span`` data ranks, the
    positions start after the earlier ranks' counts (an exclusive scan
    over the data axes)."""
    taken = torch.cumsum(oh_e, dim=1)
    if span > 1:
        with torch.no_grad():
            counts = _batch_gather(oh_e.sum(dim=(0, 1)), rows)  # [parts, E]
        first = rows.index - rows.index % span
        taken = taken + counts[first:rows.index].sum(dim=0)
    return (taken * oh_e - 1.0).to(torch.int32)


def _span_sum(x: torch.Tensor, rows: RowSplit, span: int) -> torch.Tensor:
    """``x`` summed (in f32) over the ``span`` consecutive data ranks
    whose rows share this rank's subgroup: one all-reduce where the span
    is every data rank, else each rank's ``x`` gathered and the span's
    summed. Its backward sums the gradient over the same ranks."""
    if span == rows.parts:
        out = x.to(torch.float32)
        for ax in rows.axes:
            out = tensor_parallel.sum_over(out, ax.group)
        return out
    first = rows.index - rows.index % span
    return _batch_gather(x, rows)[first:first + span].sum(dim=0)
