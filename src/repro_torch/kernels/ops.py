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

Observability (:func:`_note_launch`, the reference's hook): while a
``obs.profile`` profiler is active or the tracer is on, each dispatch
is noted with its schedule and the roofline's predicted time, on the
plain path too (the schedule the kernel would run). The port dispatches
on every eager call and once per CUDA-graph capture; a graph replay is
no dispatch, as a compiled call is none in the reference, which notes
once per jit trace. The tracer gets one ``"kernel"`` event per distinct
launch (``Tracer.first``), so eager serving cannot evict the
scheduler's records from its bounded ring.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import tiled_csl
from repro_torch.kernels import ref as ref_mod
from repro_torch.kernels import schedule as schedule_mod
from repro_torch.kernels import spmm as spmm_mod
from repro_torch.obs import profile as obs_profile
from repro_torch.obs import trace as obs_trace

BACKENDS = ("auto", "cuda", "torch")

#: (kind, M, K, N, group or experts) -> the schedule picked for it, for
#: reports.
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
          n_tb: Optional[int], split_k: Optional[int], *,
          binary: bool = False, epilogue: str = "none",
          backend: str = "cuda") -> schedule_mod.Schedule:
    """The schedule of one launch (``kind``: "spmm", "spmm_grouped" or
    "spmm_batched"); a kernel launch's is kept in ``SCHEDULES``."""
    m, k = t.shape
    n = b.shape[-1]
    sched = schedule_mod.select(
        m, k, n, m_tb=t.m_tb, k_tb=t.k_tb, max_nnz=t.max_nnz, n_tb=n_tb,
        split_k=split_k, group=t.group or 1, b_dtype_bytes=b.element_size(),
        binary=binary, experts=t.experts or 1)
    if backend == "cuda":
        SCHEDULES[(kind, m, k, n, t.experts or t.group or 1)] = sched
    _note_launch(kind, t, b, sched, backend, epilogue, binary)
    return sched


def _observed() -> bool:
    return obs_profile.active() is not None or obs_trace.get_tracer().enabled


def _note_launch(kind: str, t: tiled_csl.TiledCSL, b: torch.Tensor,
                 sched: schedule_mod.Schedule, backend: str, epilogue: str,
                 binary: bool) -> None:
    """Feed the active profiler, and the tracer one ``"kernel"`` event per
    distinct launch, with the schedule and the predicted time."""
    prof = obs_profile.active()
    tr = obs_trace.get_tracer()
    if prof is None and not tr.enabled:
        return
    m, k = t.shape
    n = b.shape[-1]
    group, experts = t.group or 1, t.experts or 1
    sparsity = schedule_mod.sparsity_from_max_nnz(t.max_nnz, t.m_tb, t.k_tb)
    dtype = str(b.dtype).rsplit(".", 1)[-1]
    if prof is not None:
        prof.note_dispatch(kind, m, k, n, sparsity, group, t.max_nnz,
                           t.m_tb, t.k_tb, backend, sched, experts=experts,
                           epilogue=epilogue, dtype=dtype, binary=binary)
    if tr.enabled and tr.first(("kernel", kind, m, k, n, group, experts,
                                backend, sched)):
        terms = schedule_mod.predicted(
            m, k, n, sparsity, sched, group=group, max_nnz=t.max_nnz,
            b_dtype_bytes=b.element_size(), binary=binary, experts=experts)
        tr.event("kernel", f"{kind} {m}x{k}x{n}", "kernel",
                 backend=backend, schedule=sched.as_dict(), group=group,
                 experts=experts, sparsity=round(float(sparsity), 4),
                 predicted_us=terms.effective_s * 1e6)


def _pad_n(b: torch.Tensor, n_tb: int) -> torch.Tensor:
    """B (``[K, N]``, or ``[E, K, N]``) with N padded to the N tile."""
    n = b.shape[-1]
    n_pad = -(-n // n_tb) * n_tb
    b = F.pad(b, (0, n_pad - n)) if n_pad != n else b
    return b.contiguous()


def _refuse_stack(t: tiled_csl.TiledCSL, op: str) -> None:
    if t.stack:
        raise ValueError(f"{op}: an expert stack is no projection group and "
                         "no single weight; use spmm_batched")


def spmm(t: tiled_csl.TiledCSL, b: torch.Tensor, *, out_dtype=None,
         backend: str = "auto", n_tb: Optional[int] = None,
         split_k: Optional[int] = None, epilogue: str = "none",
         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C[M, N] = epilogue(A_tiled_csl[M, K] @ B[K, N] + bias)."""
    _refuse_stack(t, "spmm")
    if t.group is not None:
        raise ValueError("grouped TiledCSL: use spmm_grouped")
    spmm_mod.epilogue_kind(epilogue)
    out_dtype = out_dtype or b.dtype
    if resolve_backend(backend, b) == "torch":
        if _observed():
            _pick("spmm", t, b, n_tb, split_k, epilogue=epilogue,
                  backend="torch")
        return ref_mod.spmm_ref(t, b, out_dtype=out_dtype, epilogue=epilogue,
                                bias=bias)
    n = b.shape[1]
    sched = _pick("spmm", t, b, n_tb, split_k, epilogue=epilogue)
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
    _refuse_stack(t, "spmm_grouped")
    groups = t.group
    if groups is None:
        raise ValueError("ungrouped TiledCSL: use spmm")
    kind = spmm_mod.epilogue_kind(epilogue, groups=groups)
    out_dtype = out_dtype or b.dtype
    binary = kind == "binary"
    if resolve_backend(backend, b) == "torch":
        if _observed():
            _pick("spmm_grouped", t, b, n_tb, split_k, binary=binary,
                  epilogue=epilogue, backend="torch")
        return ref_mod.spmm_grouped_ref(t, b, out_dtype=out_dtype,
                                        epilogue=epilogue, bias=bias)
    n = b.shape[1]
    sched = _pick("spmm_grouped", t, b, n_tb, split_k, binary=binary,
                  epilogue=epilogue)
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


def spmm_batched(t: tiled_csl.TiledCSL, b: torch.Tensor, *, out_dtype=None,
                 backend: str = "auto", n_tb: Optional[int] = None,
                 split_k: Optional[int] = None) -> torch.Tensor:
    """Expert-batched SpMM: C[E, M, N], C[e] = A[e] @ B[e], for an expert
    stack ``t`` (``tiled_csl.encode_stack``) and B ``[E, K, N]``. On the
    kernel path one launch serves all E experts (``lscd_spmm_batched``,
    or the ``lscd_spmm_splitk_batched`` pair), with one schedule for the
    stack; N is padded to its N tile."""
    if not t.stack:
        raise ValueError("spmm_batched needs an expert stack")
    out_dtype = out_dtype or b.dtype
    if resolve_backend(backend, b) == "torch":
        if _observed():
            _pick("spmm_batched", t, b, n_tb, split_k, backend="torch")
        return ref_mod.spmm_batched_ref(t, b, out_dtype=out_dtype)
    n = b.shape[2]
    sched = _pick("spmm_batched", t, b, n_tb, split_k)
    bp = _pad_n(b, sched.n_tb)
    if sched.split_k == 1:
        out = spmm_mod.lscd_spmm_batched(t, bp, n_tb=sched.n_tb,
                                         out_dtype=out_dtype)
    else:
        out = spmm_mod.lscd_spmm_splitk_batched(
            t, bp, n_tb=sched.n_tb, split_k=sched.split_k,
            out_dtype=out_dtype)
    return out[..., :n] if bp.shape[-1] != n else out


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
