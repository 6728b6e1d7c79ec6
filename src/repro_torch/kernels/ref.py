"""Plain PyTorch versions of the four LSCD SpMM kernels.

The counterparts of ``repro.kernels.ref``, with the same rounding points:
decode the weight to f32, an f32 matmul, the f32 bias, the f32 epilogue,
one cast to ``out_dtype``. The CPU tests run them, and ``chip_smoke.py``
holds each CUDA kernel against its plain version on the card. On the
card they are only ever called with ``torch.backends.cuda.matmul.
allow_tf32 = False`` (its default, which ``chip_smoke.py`` sets
explicitly), so the f32 matmul runs in full f32.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import tiled_csl
from repro_torch.kernels import spmm as spmm_mod


def _biased(y: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    if bias is None:
        return y
    return y + bias.to(torch.float32)[..., None]


def spmm_ref(t: tiled_csl.TiledCSL, b: torch.Tensor,
             out_dtype=torch.float32, epilogue: str = "none",
             bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C = epilogue(decode(A) @ B + bias), cast once."""
    spmm_mod.epilogue_kind(epilogue)
    a = tiled_csl.decode(t)
    y = _biased(a @ b.to(torch.float32), bias)
    return spmm_mod.apply_epilogue(epilogue, y).to(out_dtype)


def _splitk_partials(a: torch.Tensor, b: torch.Tensor, k_tb: int, kt: int,
                     split_k: int) -> torch.Tensor:
    """Per-slice f32 partial products: slice s owns K tiles
    [s*ceil(Kt/S), (s+1)*ceil(Kt/S)); the ragged last slice covers fewer."""
    cols = -(-kt // split_k) * k_tb
    parts = []
    for s in range(split_k):
        lo = min(s * cols, a.shape[1])
        hi = min(lo + cols, a.shape[1])
        parts.append(a[:, lo:hi] @ b[lo:hi])
    return torch.stack(parts)                             # [S, M, N]


def spmm_splitk_ref(t: tiled_csl.TiledCSL, b: torch.Tensor, split_k: int,
                    out_dtype=torch.float32, epilogue: str = "none",
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Split-K: per-slice f32 partials summed in slice order, then bias +
    epilogue at the single rounding point."""
    spmm_mod.epilogue_kind(epilogue)
    a = tiled_csl.decode(t)
    y = _splitk_partials(a, b.to(torch.float32), t.k_tb, t.grid[1],
                         split_k).sum(0)
    y = _biased(y, bias)
    return spmm_mod.apply_epilogue(epilogue, y).to(out_dtype)


def _grouped_out(y: torch.Tensor, kind: str, epilogue: str, out_dtype):
    if kind == "binary":
        return spmm_mod.apply_epilogue(epilogue, y[0], y[1]).to(out_dtype)
    return spmm_mod.apply_epilogue(epilogue, y).to(out_dtype)


def spmm_grouped_ref(t: tiled_csl.TiledCSL, b: torch.Tensor,
                     out_dtype=torch.float32, epilogue: str = "none",
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grouped: C[G, M, N] (unary epilogue per group, bias [G, M]) or
    C[M, N] (binary epilogue combining the G == 2 pair)."""
    groups = t.group
    if groups is None:
        raise ValueError("ungrouped TiledCSL: use spmm_ref")
    kind = spmm_mod.epilogue_kind(epilogue, groups=groups)
    a = tiled_csl.decode(t)                               # [G, M, K]
    y = _biased(torch.einsum("gmk,kn->gmn", a, b.to(torch.float32)), bias)
    return _grouped_out(y, kind, epilogue, out_dtype)


def spmm_splitk_grouped_ref(t: tiled_csl.TiledCSL, b: torch.Tensor,
                            split_k: int, out_dtype=torch.float32,
                            epilogue: str = "none",
                            bias: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Grouped split-K, mirroring :func:`spmm_splitk_ref` per group."""
    groups = t.group
    if groups is None:
        raise ValueError("ungrouped TiledCSL: use spmm_splitk_ref")
    kind = spmm_mod.epilogue_kind(epilogue, groups=groups)
    a = tiled_csl.decode(t)
    bf = b.to(torch.float32)
    y = torch.stack([
        _splitk_partials(a[g], bf, t.k_tb, t.grid[1], split_k).sum(0)
        for g in range(groups)])
    return _grouped_out(_biased(y, bias), kind, epilogue, out_dtype)
