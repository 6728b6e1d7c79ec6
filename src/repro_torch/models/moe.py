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
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import sparse_linear, tiled_csl
from repro_torch.models import layers, nn
from repro_torch.models.config import ModelConfig


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


def _expert_ffn(params: dict, xe: torch.Tensor, *,
                backend: str = "auto") -> torch.Tensor:
    """xe ``[E, C*, d]`` -> ``[E, C*, d]``: every expert's SwiGLU on its
    block, one batched product a projection. With Tiled-CSL stacks the
    hidden width is the padded out dim (``gate.shape[0]``), as in the
    reference; the padded rows give silu(0) * 0."""
    gate = params["gate"]
    dff = (gate.shape[0] if isinstance(gate, tiled_csl.TiledCSL)
           else gate.shape[1])
    d = xe.shape[-1]
    g = sparse_linear.linear_batched(gate, xe, declared_out=dff,
                                     backend=backend)
    u = sparse_linear.linear_batched(params["up"], xe, declared_out=dff,
                                     backend=backend)
    return sparse_linear.linear_batched(params["down"], F.silu(g) * u,
                                        declared_out=d, backend=backend)


def moe_block(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
              backend: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """x ``[B, S, d]`` -> (y ``[B, S, d]``, the Switch aux loss): routed
    top-k with capacity dropping, then the shared expert. The B * S
    tokens must split into whole subgroups (the reference asserts it)."""
    bsz, s, d = x.shape
    E, k = cfg.n_routed_experts, cfg.top_k
    T = bsz * s
    sg = min(cfg.moe_subgroup, T)
    if T % sg:
        raise ValueError(f"{T} tokens do not split into subgroups of {sg}")
    G = T // sg
    xt = x.reshape(G, sg, d)

    logits = sparse_linear.linear(params["router"]["w"], xt, declared_out=E,
                                  backend=backend).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                       # [G, sg, E]
    gate_vals, idx = torch.topk(probs, k, dim=-1)               # [G, sg, k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # load-balancing aux loss (Switch): E * sum_e f_e * p_e
    experts = torch.arange(E, device=x.device)
    onehot_k = (idx[..., None] == experts).to(torch.float32)   # [G,sg,k,E]
    me = probs.mean(dim=(0, 1))
    oh_e = onehot_k.sum(dim=2)                                  # [G, sg, E]
    aux = E * torch.sum(me * oh_e.mean(dim=(0, 1)))

    C = max(int(-(-sg * k // E) * cfg.capacity_factor), 1)
    gates_e = torch.einsum("gsk,gske->gse", gate_vals, onehot_k)
    pos_e = (torch.cumsum(oh_e, dim=1) * oh_e - 1.0).to(torch.int32)
    # A compare, not F.one_hot: -1 (not chosen) and >= C (over capacity)
    # give all-zero rows, as jax.nn.one_hot does, and no host read.
    dispatch = (pos_e[..., None] == torch.arange(C, device=x.device)
                ).to(torch.float32)                             # [G,sg,E,C]
    combine = dispatch * gates_e[..., None]

    xe = torch.einsum("gsec,gsd->egcd", dispatch.to(x.dtype), xt)
    ye = _expert_ffn(params, xe.reshape(E, G * C, d), backend=backend)
    y = torch.einsum("gsec,egcd->gsd", combine.to(x.dtype),
                     ye.reshape(E, G, C, d))
    if cfg.n_shared_experts:
        y = y + layers.swiglu_mlp(
            params["shared"], xt,
            d_ff=cfg.d_shared_expert * cfg.n_shared_experts, d_model=d,
            backend=backend)
    return y.reshape(bsz, s, d), aux
