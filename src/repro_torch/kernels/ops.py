"""Framework-facing LSCD SpMM ops: backend dispatch, schedule, N padding.

The counterpart of ``repro.kernels.ops``. ``backend``:

* ``"auto"``  — the CUDA kernel for a CUDA tensor, the plain PyTorch
  version (``kernels/ref.py``) for a CPU tensor;
* ``"cuda"``  — the CUDA kernel; raises for a tensor that is not on a card;
* ``"torch"`` — the plain version (tests and ``chip_smoke.py``'s
  comparisons).

A CUDA tensor never reaches the plain version under ``"auto"``, and no
failed build or launch falls back to it. On the kernel path
``schedule.select`` picks the N tile and split-K factor per call;
``split_k > 1`` runs the split-K pair. N is padded to the N tile and
sliced back; epilogues are elementwise, so the slice commutes with them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import tiled_csl
from repro_torch.kernels import ref as ref_mod
from repro_torch.kernels import schedule as schedule_mod
from repro_torch.kernels import spmm as spmm_mod

BACKENDS = ("auto", "cuda", "torch")

#: (kind, M, K, N, group) -> the schedule picked for it, for reports.
SCHEDULES: Dict[Tuple[str, int, int, int, int], schedule_mod.Schedule] = {}


def resolve_backend(backend: str, b: torch.Tensor) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")
    if backend == "auto":
        return "cuda" if b.is_cuda else "torch"
    if backend == "cuda" and not b.is_cuda:
        raise ValueError(f"backend='cuda' needs a CUDA tensor, got {b.device}")
    return backend


def _pick(kind: str, t: tiled_csl.TiledCSL, b: torch.Tensor,
          n_tb: Optional[int], split_k: Optional[int],
          binary: bool = False) -> schedule_mod.Schedule:
    m, k = t.shape
    n = b.shape[1]
    sched = schedule_mod.select(
        m, k, n, m_tb=t.m_tb, k_tb=t.k_tb, max_nnz=t.max_nnz, n_tb=n_tb,
        split_k=split_k, group=t.group or 1, b_dtype_bytes=b.element_size(),
        binary=binary)
    SCHEDULES[(kind, m, k, n, t.group or 1)] = sched
    return sched


def _pad_n(b: torch.Tensor, n_tb: int) -> torch.Tensor:
    n = b.shape[1]
    n_pad = -(-n // n_tb) * n_tb
    b = F.pad(b, (0, n_pad - n)) if n_pad != n else b
    return b.contiguous()


def spmm(t: tiled_csl.TiledCSL, b: torch.Tensor, *, out_dtype=None,
         backend: str = "auto", n_tb: Optional[int] = None,
         split_k: Optional[int] = None, epilogue: str = "none",
         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C[M, N] = epilogue(A_tiled_csl[M, K] @ B[K, N] + bias)."""
    if t.group is not None:
        raise ValueError("grouped TiledCSL: use spmm_grouped")
    spmm_mod.epilogue_kind(epilogue)
    out_dtype = out_dtype or b.dtype
    if resolve_backend(backend, b) == "torch":
        return ref_mod.spmm_ref(t, b, out_dtype=out_dtype, epilogue=epilogue,
                                bias=bias)
    n = b.shape[1]
    sched = _pick("spmm", t, b, n_tb, split_k)
    bp = _pad_n(b, sched.n_tb)
    if sched.split_k == 1:
        out = spmm_mod.lscd_spmm(t, bp, n_tb=sched.n_tb, out_dtype=out_dtype,
                                 epilogue=epilogue, bias=bias)
    else:
        out = spmm_mod.lscd_spmm_splitk(
            t, bp, n_tb=sched.n_tb, split_k=sched.split_k,
            out_dtype=out_dtype, epilogue=epilogue, bias=bias)
    return out[:, :n] if bp.shape[1] != n else out


def spmm_grouped(t: tiled_csl.TiledCSL, b: torch.Tensor, *, out_dtype=None,
                 backend: str = "auto", n_tb: Optional[int] = None,
                 split_k: Optional[int] = None, epilogue: str = "none",
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grouped SpMM: C[G, M, N] (unary epilogues; bias [G, M]) or C[M, N]
    (binary epilogues combining the G == 2 pair)."""
    groups = t.group
    if groups is None:
        raise ValueError("ungrouped TiledCSL: use spmm")
    kind = spmm_mod.epilogue_kind(epilogue, groups=groups)
    out_dtype = out_dtype or b.dtype
    if resolve_backend(backend, b) == "torch":
        return ref_mod.spmm_grouped_ref(t, b, out_dtype=out_dtype,
                                        epilogue=epilogue, bias=bias)
    n = b.shape[1]
    sched = _pick("spmm_grouped", t, b, n_tb, split_k,
                  binary=kind == "binary")
    bp = _pad_n(b, sched.n_tb)
    if sched.split_k == 1:
        out = spmm_mod.lscd_spmm_grouped(
            t, bp, n_tb=sched.n_tb, out_dtype=out_dtype, epilogue=epilogue,
            bias=bias)
    else:
        out = spmm_mod.lscd_spmm_splitk_grouped(
            t, bp, n_tb=sched.n_tb, split_k=sched.split_k,
            out_dtype=out_dtype, epilogue=epilogue, bias=bias)
    if bp.shape[1] != n:
        out = out[:, :n] if kind == "binary" else out[..., :n]
    return out


class _SpmmDiff(torch.autograd.Function):
    """Gradient flows to B and the bias only: Tiled-CSL is a frozen
    inference format."""

    @staticmethod
    def forward(ctx, b, bias, t, epilogue, backend):
        ctx.t = t
        ctx.bias_dtype = None if bias is None else bias.dtype
        return spmm(t, b, epilogue=epilogue, bias=bias, backend=backend)

    @staticmethod
    def backward(ctx, g):
        a = tiled_csl.decode(ctx.t)
        gf = g.to(torch.float32)
        db = (a.T @ gf).to(g.dtype)
        dbias = (None if ctx.bias_dtype is None
                 else gf.sum(1).to(ctx.bias_dtype))
        return db, dbias, None, None, None


def spmm_diff(t: tiled_csl.TiledCSL, b: torch.Tensor, *,
              epilogue: str = "none", bias: Optional[torch.Tensor] = None,
              backend: str = "auto") -> torch.Tensor:
    """SpMM differentiable in (B, bias). The backward does not
    differentiate through a fused epilogue, so one raises up front."""
    spmm_mod.epilogue_kind(epilogue)
    if epilogue != "none" and (b.requires_grad or (
            bias is not None and bias.requires_grad)):
        raise ValueError(
            f"spmm_diff backward does not differentiate through the fused "
            f"epilogue {epilogue!r}; apply the activation outside spmm_diff "
            f"(epilogue='none') when gradients are needed")
    return _SpmmDiff.apply(b, bias, t, epilogue, backend)
