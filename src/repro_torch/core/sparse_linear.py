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
from repro_torch.distributed import tensor_parallel
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


# ---------------------------------------------------------------------------
# tensor parallelism: a rank's share of a product (``distributed.
# tensor_parallel``). A weight is this rank's shard of the whole leaf, or
# the whole leaf where the sharding rule left it whole (``fit_spec``: its
# split dim does not divide the model axis); the whole leaf's product is
# cut to this rank's share after it. A whole leaf read for a share is a
# replicated leaf inside the model-parallel region: its gradient on each
# rank is that share's, so it passes through ``tensor_parallel.shared``
# (its gradient summed over ``model`` in the backward).
# ---------------------------------------------------------------------------

def _share(full: int, tp) -> Tuple[int, int]:
    """(offset, length) of this rank's share of a dim of ``full``."""
    if full % tp.size:
        raise ValueError(f"dim {full} does not split over {tp.size} model "
                         "ranks")
    n = full // tp.size
    return tp.rank * n, n


def _held_whole(held: int, full: int, tp, what: str) -> bool:
    """True iff a weight dim of ``held`` (Tiled-CSL: padded to the tile)
    is the whole dim of ``full``; False iff it is this rank's share."""
    if held >= full:
        return True
    if held * tp.size == full:
        return False
    raise ValueError(f"{what} of {held} is neither the whole {full} nor a "
                     f"1/{tp.size} share")


def _padded_block(held: int, full: int, tp) -> bool:
    """True iff a Tiled-CSL dim of ``held`` is this rank's block of whole
    tiles of ``full`` padded to the tile, which is not its share of
    ``full`` (a 192-row leaf of two 128-row tiles over two ranks)."""
    return held < full < held * tp.size


def _blocks_whole(y: torch.Tensor, held: int, full: int, tp) -> torch.Tensor:
    """The whole ``[..., full]`` from every rank's block ``y [..., held]``
    of the padded dim: a zero-filled f32 all-reduce (exact)."""
    lo = tp.rank * held
    buf = F.pad(y.to(torch.float32), (lo, held * tp.size - lo - held))
    return tensor_parallel.gather_from(buf, tp)[..., :full].to(y.dtype)


def _bias_share(b: Optional[torch.Tensor], full: int, tp,
                whole: bool) -> Optional[torch.Tensor]:
    """The bias for a product whose weight is whole (the whole bias,
    zero-padded if the rank holds its share only) or a share (its
    share)."""
    if b is None:
        return None
    lo, n = _share(full, tp)
    if b.shape[0] == full:
        b = tensor_parallel.shared(b, tp)
    if whole:
        return b if b.shape[0] == full else F.pad(b, (lo, full - lo - n))
    return b[lo:lo + n] if b.shape[0] == full else b


def column_parallel(w: Weight, x: torch.Tensor,
                    b: Optional[torch.Tensor] = None, *, out: int, tp,
                    epilogue: str = "none", backend: str = "auto"
                    ) -> torch.Tensor:
    """This rank's out columns ``[r * out/m, (r+1) * out/m)`` of
    ``epilogue(x @ W^T + b)``, ``x`` whole on every rank (the caller has
    passed it through ``tensor_parallel.copy_to``)."""
    lo, n = _share(out, tp)
    if _padded_block(w.shape[0], out, tp):
        y = _blocks_whole(linear(w, x, declared_out=w.shape[0],
                                 backend=backend), w.shape[0], out, tp)
        return _plain_epilogue(y[..., lo:lo + n], _bias_share(
            b, out, tp, False), epilogue)
    whole = _held_whole(w.shape[0], out, tp, "out dim")
    b = _bias_share(b, out, tp, whole)
    if not whole:
        return linear(w, x, b, declared_out=n, epilogue=epilogue,
                      backend=backend)
    return linear(tensor_parallel.shared(w, tp), x, b, declared_out=out,
                  epilogue=epilogue, backend=backend)[..., lo:lo + n]


def column_parallel_grouped(ws, x: torch.Tensor, bs=None, *,
                            outs: Sequence[int], tp, epilogue: str = "none",
                            backend: str = "auto"):
    """:func:`linear_grouped` column-parallel: each member's share of its
    out dim (``outs``, whole sizes). Members share one shape, so they are
    whole or shares alike."""
    held = ws.shape[0] if isinstance(ws, tiled_csl.TiledCSL) \
        else tuple(ws)[0].shape[0]
    bs = tuple(bs) if bs is not None else (None,) * len(outs)
    shares = [_share(o, tp) for o in outs]
    if _padded_block(held, max(outs), tp):
        return _grouped_blocks(ws, x, bs, outs, shares, held, tp, epilogue,
                               backend)
    whole = _held_whole(held, max(outs), tp, "out dim")
    bs = tuple(_bias_share(b, o, tp, whole) for b, o in zip(bs, outs))
    if not whole:
        return linear_grouped(ws, x, bs, declared_outs=[n for _, n in shares],
                              epilogue=epilogue, backend=backend)
    if not isinstance(ws, tiled_csl.TiledCSL):
        ws = tuple(tensor_parallel.shared(w, tp) for w in ws)
    y = linear_grouped(ws, x, bs, declared_outs=outs, epilogue=epilogue,
                       backend=backend)
    if isinstance(y, torch.Tensor):                  # a binary epilogue
        lo, n = shares[0]
        return y[..., lo:lo + n]
    return tuple(yg[..., lo:lo + n] for yg, (lo, n) in zip(y, shares))


def _plain_epilogue(y: torch.Tensor, b: Optional[torch.Tensor],
                    epilogue: str) -> torch.Tensor:
    """``epilogue(y + b)`` as plain ops in ``y``'s dtype."""
    if b is not None:
        y = y + b.to(y.dtype)
    return spmm_mod.apply_epilogue(epilogue, y)


def _grouped_blocks(ws, x, bs, outs, shares, held: int, tp, epilogue: str,
                    backend: str):
    """:func:`column_parallel_grouped` where each member holds this
    rank's block of its padded out dim: every member's whole product
    from the ranks' blocks, then its share (a binary epilogue, zero on
    the padding rows, runs fused before the gather)."""
    n_w = len(outs)
    binary = spmm_mod.epilogue_kind(epilogue, groups=n_w) == "binary"
    if binary and any(b is not None for b in bs):
        raise ValueError("a binary epilogue with a bias")
    y = linear_grouped(ws, x, None, declared_outs=(held,) * n_w,
                       epilogue=epilogue if binary else "none",
                       backend=backend)
    if binary:
        lo, n = shares[0]
        return _blocks_whole(y, held, outs[0], tp)[..., lo:lo + n]
    return tuple(_plain_epilogue(
        _blocks_whole(yg, held, o, tp)[..., lo:lo + n],
        _bias_share(b, o, tp, False), epilogue)
        for yg, b, o, (lo, n) in zip(y, bs, outs, shares))


def row_parallel(w: Weight, x: torch.Tensor,
                 b: Optional[torch.Tensor] = None, *, out: int, tp,
                 backend: str = "auto") -> torch.Tensor:
    """``x_whole @ W^T + b`` from this rank's in columns ``x [..., K/m]``:
    the rank's partial product (:func:`row_partial`), summed over the
    model ranks in f32, the replicated bias added once after the sum, one
    cast to ``x``'s dtype. No nonlinear epilogue runs before the sum."""
    y = tensor_parallel.reduce_from(
        row_partial(w, x, out=out, tp=tp, backend=backend), tp)
    if b is not None:
        y = y + b.to(torch.float32)
    return y.to(x.dtype)


def _whole_in(w_in: int, x: torch.Tensor, tp) -> torch.Tensor:
    """``x`` (this rank's in columns) zero-padded to the whole in dim
    where the weight's in dim of ``w_in`` is the whole one; where it is
    this rank's block of the in dim padded to whole tiles, the columns
    of that block (``x`` gathered whole, exact)."""
    k = x.shape[-1] * tp.size
    if _padded_block(w_in, k, tp):
        lo = tp.rank * w_in
        xw = tensor_parallel.gather_dim(x.to(torch.float32), x.dim() - 1,
                                        tp)
        return F.pad(xw, (0, w_in * tp.size - k))[..., lo:lo + w_in].to(
            x.dtype)
    if _held_whole(w_in, k, tp, "in dim"):
        lo, n = _share(k, tp)
        x = F.pad(x, (lo, k - lo - n))
    return x


def row_partial(w: Weight, x: torch.Tensor, *, out: int, tp,
                backend: str = "auto") -> torch.Tensor:
    """This rank's f32 partial of a row-parallel product, not yet summed
    over the model ranks (:func:`row_parallel` sums it; the MoE block
    joins the shared expert's to the routed experts' sum). A Tiled-CSL
    product takes ``x`` in f32 (its values exactly), since the kernel
    writes in its B's dtype: the partial stays f32 and rounds once, after
    the sum. A dense product runs in ``x``'s dtype, as the unsharded one
    does."""
    w = _shared_if_whole(w, w.shape[1], x.shape[-1], tp)
    x = _whole_in(w.shape[1], x, tp)
    if isinstance(w, tiled_csl.TiledCSL):
        x = x.to(torch.float32)
    return linear(w, x, declared_out=out, backend=backend).to(torch.float32)


def _shared_if_whole(w: Weight, w_in: int, share: int, tp) -> Weight:
    """``w`` through ``tensor_parallel.shared`` where its in dim of
    ``w_in`` is the whole one (``share`` this rank's columns of it)."""
    k = share * tp.size
    if not _padded_block(w_in, k, tp) and _held_whole(w_in, k, tp, "in dim"):
        return tensor_parallel.shared(w, tp)
    return w


def column_gathered(w: Weight, x: torch.Tensor, *, out: int, tp,
                    backend: str = "auto") -> torch.Tensor:
    """The whole ``x @ W^T`` (``[..., out]``) on every rank, from a
    column-parallel weight: a weight the rule left whole is multiplied
    whole, with no collective; a share's product lands in its block of
    a zero-filled f32 buffer that the ranks sum (exact)."""
    if _padded_block(w.shape[0], out, tp):
        return _blocks_whole(linear(w, x, declared_out=w.shape[0],
                                    backend=backend), w.shape[0], out, tp)
    if _held_whole(w.shape[0], out, tp, "out dim"):
        return linear(tensor_parallel.shared(w, tp), x, declared_out=out,
                      backend=backend)
    y = column_parallel(w, x, out=out, tp=tp, backend=backend)
    lo, n = _share(out, tp)
    full = F.pad(y.to(torch.float32), (lo, out - lo - n))
    return tensor_parallel.gather_from(full, tp).to(y.dtype)


def _stack_rows(w: Weight) -> int:
    """The out dim of one expert of a stack (Tiled-CSL: padded)."""
    return w.shape[0] if isinstance(w, tiled_csl.TiledCSL) else w.shape[1]


def _stack_cols(w: Weight) -> int:
    """The in dim of one expert of a stack (Tiled-CSL: padded)."""
    return w.shape[1] if isinstance(w, tiled_csl.TiledCSL) else w.shape[2]


def column_parallel_batched(w: Weight, x: torch.Tensor, *, out: int, tp,
                            backend: str = "auto") -> torch.Tensor:
    """:func:`linear_batched` column-parallel inside each expert (MoE's
    tensor parallelism where the experts do not split over the model
    axis): this rank's share of every expert's out dim ``out``. A stack
    the rule left whole is multiplied whole and cut to the share."""
    lo, n = _share(out, tp)
    if not _held_whole(_stack_rows(w), out, tp, "expert out dim"):
        return linear_batched(w, x, declared_out=n, backend=backend)
    return linear_batched(tensor_parallel.shared(w, tp), x,
                          declared_out=out, backend=backend)[..., lo:lo + n]


def row_partial_batched(w: Weight, x: torch.Tensor, *, out: int, tp,
                        backend: str = "auto") -> torch.Tensor:
    """:func:`linear_batched` row-parallel inside each expert, from this
    rank's in columns of every expert's block: the rank's f32 partial,
    not yet summed over the model ranks. A Tiled-CSL stack takes ``x``
    in f32, as :func:`row_partial` does."""
    w = _shared_if_whole(w, _stack_cols(w), x.shape[-1], tp)
    x = _whole_in(_stack_cols(w), x, tp)
    if isinstance(w, tiled_csl.TiledCSL):
        x = x.to(torch.float32)
    return linear_batched(w, x, declared_out=out,
                          backend=backend).to(torch.float32)
