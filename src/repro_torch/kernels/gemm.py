"""Dense GEMM baseline on Hopper: the paper's dense comparison point.

The port's counterpart of ``repro.kernels.gemm``. :func:`dense_gemm`
computes ``C[M, N] = A[M, K] @ B[K, N]`` with an f32 accumulator and one
cast to ``out_dtype`` (f32 by default, as in JAX). Its CUDA kernel
(``csrc/dense_gemm.cu``) runs the LSCD kernels' pipelined mainloop
(``csrc/hopper_pipe.cuh``) with A read dense by TMA, so an LSCD time
minus this kernel's time at the same tiles is the Load-as-Sparse cost.
bf16 inputs run on tensor cores (a persistent grid; ``n_tb=256`` gives
the kernel's widest tile, 128 x 256), f32 inputs on CUDA-core FMAs (full
f32). No serving path calls it. A launch the card refuses, or a tensor
map that cannot be encoded, raises.

Dispatch as ``ops.spmm``: ``backend="auto"`` launches the kernel for CUDA
tensors and takes the plain version, :func:`dense_gemm_ref`, for CPU
tensors; ``"cuda"`` raises for a tensor off the card; ``"torch"`` is the
plain version. Shapes that the tiles do not divide raise, as the JAX
kernel's do; its VMEM budget becomes the shared-memory contract
``analysis.contracts.check_gemm``.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.analysis import contracts
from repro_torch.kernels import ops

_IN_CODES = {torch.float32: 0, torch.bfloat16: 1}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 2}

LAUNCHES: Dict[str, int] = {"dense_gemm": 0}


def reset_launch_counts() -> None:
    LAUNCHES["dense_gemm"] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def _require_tiles(a: torch.Tensor, b: torch.Tensor, m_tb: int, k_tb: int,
                   n_tb: int) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(b.shape)} do "
                         "not chain")
    if a.dtype != b.dtype or a.dtype not in _IN_CODES:
        raise ValueError(f"A and B must share a dtype in {list(_IN_CODES)}, "
                         f"got {a.dtype} and {b.dtype}")
    (m, k), n = a.shape, b.shape[1]
    contracts.require_gemm(m, k, n, m_tb=m_tb, k_tb=k_tb, n_tb=n_tb,
                           dtype_bytes=a.element_size())


def dense_gemm_ref(a: torch.Tensor, b: torch.Tensor, *,
                   out_dtype=torch.float32) -> torch.Tensor:
    """Plain version: an f32 matmul, one cast. On the card it runs in full
    f32 only with ``torch.backends.cuda.matmul.allow_tf32 = False``."""
    return (a.to(torch.float32) @ b.to(torch.float32)).to(out_dtype)


def dense_gemm_kernel(a: torch.Tensor, b: torch.Tensor, *, m_tb: int = 128,
                      k_tb: int = 128, n_tb: int = 128,
                      out_dtype=torch.float32) -> torch.Tensor:
    """Raw CUDA kernel entry: CUDA tensors only."""
    for name, x in (("A", a), ("B", b)):
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if x.device != a.device:
            raise ValueError(f"{name} on {x.device}, A on {a.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if out_dtype not in _OUT_CODES:
        raise ValueError(f"out dtype {out_dtype} not in {list(_OUT_CODES)}")
    _require_tiles(a, b, m_tb, k_tb, n_tb)
    from repro_torch.kernels import build   # builds with nvcc at first use
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = build.entry("dense_gemm")(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n, m_tb, k_tb,
        n_tb, _IN_CODES[a.dtype] | _OUT_CODES[out_dtype], stream)
    if rc != 0:
        raise RuntimeError(f"dense_gemm launch failed with CUDA error {rc}")
    LAUNCHES["dense_gemm"] += 1
    return out


def dense_gemm(a: torch.Tensor, b: torch.Tensor, *, m_tb: int = 128,
               k_tb: int = 128, n_tb: int = 128, out_dtype=torch.float32,
               backend: str = "auto") -> torch.Tensor:
    """C[M, N] = A[M, K] @ B[K, N], tiled. Dims must divide the tiles."""
    _require_tiles(a, b, m_tb, k_tb, n_tb)
    if ops.resolve_backend(backend, b) == "torch":
        return dense_gemm_ref(a, b, out_dtype=out_dtype)
    return dense_gemm_kernel(a, b, m_tb=m_tb, k_tb=k_tb, n_tb=n_tb,
                             out_dtype=out_dtype)
