"""Norms, MLPs, embeddings and the logits head (dense family)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import sparse_linear
from repro_torch.models import nn

# ---------------------------------------------------------------------------
# norms (computed in f32, cast back to the activation dtype)
# ---------------------------------------------------------------------------


def init_rmsnorm(dim: int, device, dtype=torch.float32) -> dict:
    return {"scale": nn.ones_init((dim,), device, dtype)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].to(torch.float32)).to(dt)


def init_layernorm(dim: int, device, dtype=torch.float32) -> dict:
    return {"scale": nn.ones_init((dim,), device, dtype),
            "bias": nn.zeros_init((dim,), device, dtype)}


def layernorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].to(torch.float32) + params["bias"].to(torch.float32)
    return y.to(dt)


# ---------------------------------------------------------------------------
# MLPs (weights stored [out, in], the paper's A[M, K] orientation)
# ---------------------------------------------------------------------------

def init_swiglu_mlp(gen, d_model: int, d_ff: int, device,
                    dtype=torch.float32) -> dict:
    return {
        "gate": {"w": nn.dense_init(gen, d_ff, d_model, device, dtype)},
        "up": {"w": nn.dense_init(gen, d_ff, d_model, device, dtype)},
        "down": {"w": nn.dense_init(gen, d_model, d_ff, device, dtype)},
    }


def swiglu_mlp(params: dict, x: torch.Tensor, *, d_ff: int, d_model: int,
               backend: str = "auto") -> torch.Tensor:
    # Grouped fused path: gate+up in one launch, silu(g)*u at the flush.
    if "gate_up" in params:
        h = sparse_linear.linear_grouped(
            params["gate_up"]["w"], x, declared_outs=(d_ff, d_ff),
            epilogue="silu_mul", backend=backend)
    else:
        gw, uw = params["gate"]["w"], params["up"]["w"]
        if sparse_linear.groupable((gw, uw)):
            h = sparse_linear.linear_grouped(
                (gw, uw), x, declared_outs=(d_ff, d_ff),
                epilogue="silu_mul", backend=backend)
        else:
            g = sparse_linear.linear(gw, x, declared_out=d_ff, backend=backend)
            u = sparse_linear.linear(uw, x, declared_out=d_ff, backend=backend)
            h = F.silu(g) * u
    return sparse_linear.linear(params["down"]["w"], h, declared_out=d_model,
                                backend=backend)


def init_gelu_mlp(gen, d_model: int, d_ff: int, device, dtype=torch.float32,
                  bias: bool = True) -> dict:
    p = {
        "up": {"w": nn.dense_init(gen, d_ff, d_model, device, dtype)},
        "down": {"w": nn.dense_init(gen, d_model, d_ff, device, dtype)},
    }
    if bias:
        p["up"]["b"] = nn.zeros_init((d_ff,), device, dtype)
        p["down"]["b"] = nn.zeros_init((d_model,), device, dtype)
    return p


def gelu_mlp(params: dict, x: torch.Tensor, *, d_ff: int, d_model: int,
             backend: str = "auto") -> torch.Tensor:
    # bias + tanh-GELU ride the kernel flush for Tiled-CSL weights.
    h = sparse_linear.linear(params["up"]["w"], x, params["up"].get("b"),
                             declared_out=d_ff, epilogue="gelu",
                             backend=backend)
    return sparse_linear.linear(params["down"]["w"], h,
                                params["down"].get("b"),
                                declared_out=d_model, backend=backend)


# ---------------------------------------------------------------------------
# embeddings / logits
# ---------------------------------------------------------------------------

def init_embed(gen, vocab: int, dim: int, device, dtype=torch.float32) -> dict:
    return {"table": nn.embed_init(gen, vocab, dim, device, dtype)}


def embed(params: dict, tokens: torch.Tensor,
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    return params["table"].to(compute_dtype)[tokens]


def logits_head(params: Optional[dict], embed_params: Optional[dict],
                x: torch.Tensor, *, vocab: int,
                backend: str = "auto") -> torch.Tensor:
    """Untied head if ``params`` is given, else tied to the embedding."""
    if params is not None:
        return sparse_linear.linear(params["w"], x, declared_out=vocab,
                                    backend=backend)
    return x @ embed_params["table"].to(x.dtype).T
