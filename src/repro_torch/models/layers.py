"""Norms, MLPs, embeddings and the logits head (dense family)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import sparse_linear
from repro_torch.distributed import tensor_parallel
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
               backend: str = "auto", tp=None) -> torch.Tensor:
    """``d_ff`` is the whole hidden width; with ``tp`` (tensor
    parallelism) gate and up are column-parallel and down row-parallel."""
    if tp is not None:
        return _swiglu_tp(params, x, d_ff=d_ff, d_model=d_model,
                          backend=backend, tp=tp)
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


def _swiglu_tp(params, x, *, d_ff, d_model, backend, tp):
    x = tensor_parallel.copy_to(x, tp)
    ws = params["gate_up"]["w"] if "gate_up" in params else \
        (params["gate"]["w"], params["up"]["w"])
    if isinstance(ws, tuple) and not sparse_linear.groupable(ws):
        g, u = (sparse_linear.column_parallel(w, x, out=d_ff, tp=tp,
                                              backend=backend) for w in ws)
        h = F.silu(g) * u
    else:
        h = sparse_linear.column_parallel_grouped(
            ws, x, outs=(d_ff, d_ff), tp=tp, epilogue="silu_mul",
            backend=backend)
    return sparse_linear.row_parallel(params["down"]["w"], h, out=d_model,
                                      tp=tp, backend=backend)


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
             backend: str = "auto", tp=None) -> torch.Tensor:
    """``d_ff`` is the whole hidden width; with ``tp`` up is
    column-parallel (bias and GELU on the rank's share, fused as
    without) and down row-parallel (its bias added after the sum)."""
    if tp is not None:
        x = tensor_parallel.copy_to(x, tp)
        h = sparse_linear.column_parallel(
            params["up"]["w"], x, params["up"].get("b"), out=d_ff, tp=tp,
            epilogue="gelu", backend=backend)
        return sparse_linear.row_parallel(
            params["down"]["w"], h, params["down"].get("b"), out=d_model,
            tp=tp, backend=backend)
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
          compute_dtype=torch.bfloat16, *, tp=None,
          vocab: Optional[int] = None) -> torch.Tensor:
    """Look the tokens up. With ``tp`` and a table split by vocab rows
    (vocab-parallel: fewer rows than ``vocab``), each rank looks up the
    ids in its rows, zeros the rest, and the ranks' rows are summed."""
    table = params["table"].to(compute_dtype)
    rows = table.shape[0]
    if tp is None or rows >= vocab:
        return table[tokens]
    lo = tp.rank * rows
    ids = tokens - lo
    mine = (ids >= 0) & (ids < rows)
    x = table[ids.clamp(0, rows - 1)] * mine[..., None].to(compute_dtype)
    return tensor_parallel.reduce_from(x.to(torch.float32), tp).to(
        compute_dtype)


def logits_head(params: Optional[dict], embed_params: Optional[dict],
                x: torch.Tensor, *, vocab: int, backend: str = "auto",
                tp=None) -> torch.Tensor:
    """Untied head if ``params`` is given, else tied to the embedding.
    With ``tp`` and a head split by vocab rows, each rank's logits land
    in its block of a zero-filled ``[..., vocab]`` buffer that the ranks
    sum (in f32): every rank gets the whole logits."""
    w = params["w"] if params is not None else embed_params["table"]
    if tp is not None and w.shape[0] < vocab:
        x = tensor_parallel.copy_to(x, tp)
        rows = w.shape[0]
        if params is not None:
            y = sparse_linear.linear(w, x, declared_out=rows,
                                     backend=backend)
        else:
            y = x @ w.to(x.dtype).T
        lo = tp.rank * rows
        y = F.pad(y.to(torch.float32), (lo, rows * tp.size - lo - rows))
        return tensor_parallel.reduce_from(y, tp)[..., :vocab].to(x.dtype)
    if params is not None:
        return sparse_linear.linear(w, x, declared_out=vocab,
                                    backend=backend)
    return x @ w.to(x.dtype).T
