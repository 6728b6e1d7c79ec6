"""Minimal NN substrate of the port: param init and f32-accumulating einsum.

Params are nested dicts of tensors, as in ``repro.models.nn``; layer
stacks are Python lists (one dict per layer) instead of scan-stacked
``[L, ...]`` leaves. Init draws from an explicit ``torch.Generator``; it
does not reproduce the JAX package's random numbers (the parity tests
bring the reference's params over with ``convert``).
"""

from __future__ import annotations

from typing import Sequence

import torch


def dense_init(gen: torch.Generator, out_dim: int, in_dim: int,
               device, dtype=torch.float32) -> torch.Tensor:
    """[out, in] weight, truncated normal in [-2, 2], 1/sqrt(fan_in) scale
    (on meta, its shape and dtype only)."""
    if torch.device(device).type == "meta":
        return torch.empty((out_dim, in_dim), dtype=dtype, device=device)
    w = torch.empty((out_dim, in_dim), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, std=1.0, a=-2.0, b=2.0, generator=gen)
    return (w * in_dim ** -0.5).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, device,
               dtype=torch.float32) -> torch.Tensor:
    if torch.device(device).type == "meta":
        return torch.empty((vocab, dim), dtype=dtype, device=device)
    w = torch.randn((vocab, dim), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


def zeros_init(shape: Sequence[int], device, dtype=torch.float32):
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def ones_init(shape: Sequence[int], device, dtype=torch.float32):
    return torch.ones(tuple(shape), dtype=dtype, device=device)


def einsum_f32acc(subscripts: str, *operands: torch.Tensor) -> torch.Tensor:
    """Einsum with f32 accumulation and an f32 result over (possibly bf16)
    operands, as the reference computes it on the CPU: operands are
    upcast first."""
    return torch.einsum(subscripts, *[o.to(torch.float32) for o in operands])
