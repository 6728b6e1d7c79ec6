"""LSCD sparse linear layer: one ``linear()`` that dispatches on the weight.

The counterpart of ``repro.core.sparse_linear``: a dense ``[out, in]``
tensor goes to ``torch.matmul`` (the paper's cuBLAS path); a
``tiled_csl.TiledCSL`` goes to the LSCD SpMM (``kernels.ops``).
``linear_grouped()`` runs G same-shape projections of one ``x`` through
one grouped launch, optionally with a unary or binary epilogue.
``linear_batched()`` runs an MoE expert stack, each expert against its
own activation block: a dense ``[E, out, in]`` stack through one batched
einsum, a stacked Tiled-CSL through one expert-batched launch.

Orientation is the paper's: weights are ``[out, in]`` = A[M, K] and the
activation is transposed to B = ``[in, tokens]``, so N is the skinny
token dimension and the schedule sees the true tokens in flight per call.

Out-dim contract: Tiled-CSL pads the out dim to the tile multiple; every
entry slices the result back to ``declared_out`` (default: the bias
length, else the padded dim).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core import tiled_csl
from repro_torch.kernels import ops, spmm as spmm_mod

Weight = Union[torch.Tensor, tiled_csl.TiledCSL]


def _to_skinny_b(x: torch.Tensor, k_pad: int) -> torch.Tensor:
    """[..., in] -> B[in_padded, tokens], contiguous."""
    k_in = x.shape[-1]
    xt = x.reshape(-1, k_in).T
    if k_pad != k_in:
        xt = F.pad(xt, (0, 0, 0, k_pad - k_in))
    return xt.contiguous()


def _pad_bias(b: Optional[torch.Tensor], m_pad: int) -> Optional[torch.Tensor]:
    if b is None or b.shape[0] == m_pad:
        return b
    return F.pad(b, (0, m_pad - b.shape[0]))


def linear_batched(w: Weight, x: torch.Tensor, *,
                   declared_out: Optional[int] = None,
                   backend: str = "auto") -> torch.Tensor:
    """y[e, ..., declared_out] = x[e, ..., in] @ W[e]^T for the E experts
    of a stack: a dense ``[E, out, in]`` tensor (one einsum in the
    activation dtype, as the reference's ``_expert_ffn``) or a stacked
    Tiled-CSL (``ops.spmm_batched``: B[e] = x[e]^T, one launch for all
    E, the out dim sliced back to ``declared_out``)."""
    if not isinstance(w, tiled_csl.TiledCSL):
        y = torch.einsum("e...d,efd->e...f", x, w.to(x.dtype))
        return y if declared_out is None else y[..., :declared_out]
    if not w.stack:
        raise ValueError("linear_batched needs an expert stack")
    e, lead, k_in = x.shape[0], x.shape[1:-1], x.shape[-1]
    xt = x.reshape(e, -1, k_in).transpose(1, 2)             # [E, in, tokens]
    if w.shape[1] != k_in:
        xt = F.pad(xt, (0, 0, 0, w.shape[1] - k_in))
    y = ops.spmm_batched(w, xt.contiguous(), out_dtype=x.dtype,
                         backend=backend)                    # [E, M, tokens]
    y = y.transpose(1, 2).reshape(e, *lead, w.shape[0])
    out_dim = w.shape[0] if declared_out is None else declared_out
    return y[..., :out_dim] if out_dim != w.shape[0] else y


def linear(w: Weight, x: torch.Tensor, b: Optional[torch.Tensor] = None, *,
           declared_out: Optional[int] = None, epilogue: str = "none",
           backend: str = "auto") -> torch.Tensor:
    """y[..., declared_out] = epilogue(x[..., in] @ W^T + b).

    Tiled-CSL weights fuse the bias and the unary epilogue into the
    kernel flush (f32, one cast); dense weights apply them as plain ops in
    the activation dtype."""
    spmm_mod.epilogue_kind(epilogue)
    if isinstance(w, tiled_csl.TiledCSL):
        if w.group is not None:
            raise ValueError("grouped TiledCSL: use linear_grouped")
        lead = x.shape[:-1]
        xt = _to_skinny_b(x, w.shape[1])
        y = ops.spmm(w, xt, out_dtype=x.dtype, backend=backend,
                     epilogue=epilogue, bias=_pad_bias(b, w.shape[0]))
        y = y.T.reshape(*lead, w.shape[0])
        out_dim = declared_out if declared_out is not None else (
            b.shape[0] if b is not None else w.shape[0])
        return y[..., :out_dim] if out_dim != w.shape[0] else y
    y = x @ w.T.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    y = spmm_mod.apply_epilogue(epilogue, y)
    if declared_out is not None and declared_out != y.shape[-1]:
        y = y[..., :declared_out]
    return y


# A group shares one max_nnz; skip grouping when G * max(max_nnz) exceeds
# this factor of the summed per-member streams.
GROUP_MAX_NNZ_WASTE = 1.25


def balanced_group(ws: Sequence[tiled_csl.TiledCSL]) -> bool:
    """Members pad to one max_nnz: group only comparable streams."""
    mnz = [w.max_nnz for w in ws]
    return len(ws) * max(mnz) <= GROUP_MAX_NNZ_WASTE * sum(mnz)


def groupable(ws: Sequence[Weight]) -> bool:
    """True iff ``ws`` can ride one grouped launch profitably."""
    if not ws or not all(isinstance(w, tiled_csl.TiledCSL) for w in ws):
        return False
    if any(w.group is not None for w in ws):
        return False
    key = (ws[0].shape, ws[0].m_tb, ws[0].k_tb)
    return all((w.shape, w.m_tb, w.k_tb) == key for w in ws) and \
        balanced_group(ws)


def linear_grouped(ws: Union[tiled_csl.TiledCSL, Sequence[Weight]],
                   x: torch.Tensor,
                   bs: Optional[Sequence[Optional[torch.Tensor]]] = None, *,
                   declared_outs: Sequence[int], epilogue: str = "none",
                   backend: str = "auto"
                   ) -> Union[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """G same-shape projections of one ``x`` through one grouped launch.

    ``ws`` is a grouped TiledCSL or a sequence of G weights (groupable
    TiledCSLs are stacked on the fly; anything else runs per weight).
    Returns G tensors sliced to ``declared_outs`` (unary epilogues), or
    one tensor for binary epilogues (``silu_mul``/``gelu_mul``, G == 2).
    """
    douts = tuple(declared_outs)
    if isinstance(ws, tiled_csl.TiledCSL):
        grouped = ws
        if grouped.group is None:
            raise ValueError("linear_grouped needs a grouped TiledCSL")
        n_w = grouped.group
    else:
        ws = tuple(ws)
        n_w = len(ws)
        grouped = tiled_csl.group_stack(ws) if groupable(ws) else None
    binary = spmm_mod.epilogue_kind(epilogue, groups=n_w) == "binary"
    if len(douts) != n_w:
        raise ValueError(f"declared_outs {douts} does not match G={n_w}")
    bs = tuple(bs) if bs is not None else (None,) * n_w
    if len(bs) != n_w:
        raise ValueError(f"{len(bs)} biases for G={n_w}")
    if binary and len(set(douts)) != 1:
        raise ValueError(f"binary epilogue pair must share declared_out, "
                         f"got {douts}")

    if grouped is None:
        ys = [linear(w, x, b, declared_out=do, backend=backend)
              for w, b, do in zip(ws, bs, douts)]
        if binary:
            return spmm_mod.apply_epilogue(epilogue, ys[0], ys[1])
        if epilogue != "none":
            ys = [spmm_mod.apply_epilogue(epilogue, y) for y in ys]
        return tuple(ys)

    lead = x.shape[:-1]
    m_pad = grouped.shape[0]
    xt = _to_skinny_b(x, grouped.shape[1])
    bias = None
    if any(b is not None for b in bs):
        bias = torch.stack([
            torch.zeros((m_pad,), dtype=torch.float32, device=x.device)
            if b is None else _pad_bias(b.to(torch.float32), m_pad)
            for b in bs])
    y = ops.spmm_grouped(grouped, xt, out_dtype=x.dtype, backend=backend,
                         epilogue=epilogue, bias=bias)
    if binary:
        out = y.T.reshape(*lead, m_pad)
        return out[..., :douts[0]] if douts[0] != m_pad else out
    outs = []
    for g, do in enumerate(douts):
        og = y[g].T.reshape(*lead, m_pad)
        outs.append(og[..., :do] if do != m_pad else og)
    return tuple(outs)
