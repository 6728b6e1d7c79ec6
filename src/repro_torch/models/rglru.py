"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

The port's counterpart of ``repro.models.rglru``. The recurrence:

    r_t = sigmoid(W_a x_t + b_a)             (recurrence gate)
    i_t = sigmoid(w_i * x_t + b_i)           (diagonal input gate)
    a_t = a^(c * r_t),  a = sigmoid(Lambda), c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

inside the Griffin recurrent block: x -> (linear -> causal depthwise conv
-> RG-LRU), gated elementwise by a GeLU branch (the tanh form, as
``jax.nn.gelu`` computes it), then an output linear. The gates, the conv
and the scan run in f32; ``w_a`` is read by an f32 matmul, not through
``sparse_linear``, so it stays a dense f32 matrix. The state per
sequence is ``h [r]`` and the last ``conv - 1`` pre-conv inputs.

Prefill runs the recurrence as a log-depth doubling scan over the
sequence with the reference's combine ``(a1 a2, a2 b1 + b2)``: about
log2(L) steps of whole-tensor arithmetic instead of L. Its association
order is not ``jax.lax.associative_scan``'s, so the two agree to f32
rounding, not bit for bit. Decode writes the state it is given in place
(``copy_``), so a captured CUDA graph replays against the same buffers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import sparse_linear
from repro_torch.distributed import tensor_parallel
from repro_torch.models import nn
from repro_torch.models.config import ModelConfig

_C = 8.0  # the paper's fixed exponent scale


def init_rglru(gen, cfg: ModelConfig, device, dtype=torch.float32) -> dict:
    d, r = cfg.d_model, cfg.rnn_dim
    w_x = nn.dense_init(gen, r, d, device, dtype)             # branch proj
    w_gate = nn.dense_init(gen, r, d, device, dtype)          # GeLU branch
    w_out = nn.dense_init(gen, d, r, device, dtype)
    conv_w = (torch.randn((cfg.rglru_conv, r), generator=gen,
                          dtype=torch.float32, device=device) * 0.1).to(dtype)
    wa = nn.dense_init(gen, r, r, device, dtype)              # recurrence gate
    return {
        "w_x": {"w": w_x}, "w_gate": {"w": w_gate}, "w_out": {"w": w_out},
        "conv_w": conv_w, "conv_b": nn.zeros_init((r,), device, dtype),
        "wa": {"w": wa}, "ba": nn.zeros_init((r,), device, dtype),
        "wi_b": nn.zeros_init((r,), device, dtype),            # input gate bias
        "wi_diag": nn.ones_init((r,), device, dtype),          # diag input gate
        "lam": torch.full((r,), 2.2, device=device).to(dtype),  # a ~ 0.9
    }


def init_rglru_cache(cfg: ModelConfig, batch: int, device,
                     dtype=torch.float32) -> dict:
    return {"h": torch.zeros((batch, cfg.rnn_dim), dtype=dtype,
                             device=device),
            "conv": torch.zeros((batch, cfg.rglru_conv - 1, cfg.rnn_dim),
                                dtype=dtype, device=device)}


REPLICATED = ("conv_w", "conv_b", "ba", "wi_b", "wi_diag", "lam")


def _in_region(params, cfg: ModelConfig, tp) -> dict:
    """``params`` with the leaves that the recurrence reads whole on
    every model rank (the conv, the gates' vectors, ``wa`` where the
    rules hold it whole) through ``tensor_parallel.shared``: each rank's
    gradient of them is the share of its ``w_out`` channels, summed over
    ``model`` in the backward."""
    if tp is None:
        return params
    names = REPLICATED + (("wa",) if params["wa"]["w"].shape[0] ==
                          cfg.rnn_dim else ())
    return {**params, **{n: tensor_parallel.shared(params[n], tp)
                         for n in names}}


def _rglru_gates(params, xr: torch.Tensor, tp=None):
    """xr: [..., r] f32 -> (log_a, gated input), both [..., r] f32. Under
    ``tp`` ``wa`` is column-parallel: each rank's share of the f32
    product from the whole ``xr``, gathered whole (exact)."""
    f32 = torch.float32
    wa = xr @ params["wa"]["w"].to(f32).T
    if tp is not None and wa.shape[-1] < xr.shape[-1]:
        wa = tensor_parallel.gather_dim(wa, wa.dim() - 1, tp)
    r_gate = torch.sigmoid(wa + params["ba"].to(f32))
    i_gate = torch.sigmoid(xr * params["wi_diag"].to(f32)
                           + params["wi_b"].to(f32))
    a_base = torch.sigmoid(params["lam"].to(f32))
    log_a = _C * r_gate * torch.log(a_base)                    # < 0
    a = torch.exp(log_a)
    gx = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i_gate * xr)
    return log_a, gx


def _linear_scan(log_a: torch.Tensor, gx: torch.Tensor, h0: torch.Tensor):
    """h_t = exp(log_a_t) h_{t-1} + gx_t over axis 1 by doubling: after
    the step of span s, element t holds the combine of elements
    (t - 2s, t] (only products of a in (0, 1], never 1/a).

    log_a, gx: [B, L, r]; h0: [B, r]. Returns y [B, L, r], h_final [B, r].
    """
    a, b = torch.exp(log_a), gx
    span = 1
    while span < a.shape[1]:
        # element t combines with t - span: (a1 a2, a2 b1 + b2)
        b = torch.cat([b[:, :span], a[:, span:] * b[:, :-span]
                       + b[:, span:]], dim=1)
        a = torch.cat([a[:, :span], a[:, :-span] * a[:, span:]], dim=1)
        span *= 2
    y = a * h0[:, None, :] + b
    return y, y[:, -1]


def _gelu_gate(y: torch.Tensor, gate: torch.Tensor, dtype) -> torch.Tensor:
    return y.to(dtype) * F.gelu(gate.to(torch.float32),
                                approximate="tanh").to(dtype)


def _branches(params, x: torch.Tensor, cfg: ModelConfig, backend: str, tp):
    """(the whole ``w_x`` branch, the ``w_gate`` branch: under ``tp`` this
    rank's share of it, the part ``w_out``'s row-parallel product
    reads). Under ``tp`` ``w_x`` is column-parallel and gathered whole:
    the conv and ``wa`` read every channel."""
    r = cfg.rnn_dim
    if tp is None:
        return (sparse_linear.linear(params["w_x"]["w"], x, declared_out=r,
                                     backend=backend),
                sparse_linear.linear(params["w_gate"]["w"], x,
                                     declared_out=r, backend=backend))
    x = tensor_parallel.copy_to(x, tp)
    return (sparse_linear.column_gathered(params["w_x"]["w"], x, out=r,
                                          tp=tp, backend=backend),
            sparse_linear.column_parallel(params["w_gate"]["w"], x, out=r,
                                          tp=tp, backend=backend))


def _out(params, y: torch.Tensor, gate: torch.Tensor, dtype,
         cfg: ModelConfig, backend: str, tp) -> torch.Tensor:
    """``w_out`` of the GeLU-gated recurrence: under ``tp`` row-parallel
    over this rank's share of the channels (``gate`` is that share)."""
    if tp is None:
        return sparse_linear.linear(params["w_out"]["w"],
                                    _gelu_gate(y, gate, dtype),
                                    declared_out=cfg.d_model,
                                    backend=backend)
    n = gate.shape[-1]
    y = y[..., tp.rank * n:(tp.rank + 1) * n]
    return sparse_linear.row_parallel(params["w_out"]["w"],
                                      _gelu_gate(y, gate, dtype),
                                      out=cfg.d_model, tp=tp,
                                      backend=backend)


def rglru_block(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                cache: Optional[dict] = None, backend: str = "auto", tp=None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Prefill, x: [B, L, d]. The scan starts from ``cache["h"]`` when a
    cache is given (a fresh one holds zeros), else from zero; the conv
    always starts from zero inputs, as in the reference. With ``cache``,
    the final state and the last ``conv - 1`` pre-conv inputs are
    written into it (in place) and it is returned. With ``tp`` (tensor
    parallelism over ``model``) ``w_x``, ``w_gate`` and ``wa`` are
    column-parallel, ``w_x``'s and ``wa``'s products gathered whole, so
    the conv, the gates and the scan run whole on every rank (the state
    stays whole over ``model``), and ``w_out`` is row-parallel; the
    gathers carry their backward and the leaves the recurrence reads whole
    sum their gradients over ``model`` (:func:`_in_region`), so the
    block trains under a mesh."""
    B, L, _ = x.shape
    r = cfg.rnn_dim
    f32 = torch.float32
    params = _in_region(params, cfg, tp)
    xr, gate = _branches(params, x, cfg, backend, tp)
    cv = params["conv_w"].shape[0]
    xr_pad = torch.cat([xr.new_zeros((B, cv - 1, r)), xr], dim=1)
    cw = params["conv_w"].to(f32)
    conv = xr_pad[:, :L].to(f32) * cw[0]
    for i in range(1, cv):                   # causal depthwise conv
        conv = conv + xr_pad[:, i:i + L].to(f32) * cw[i]
    xc = conv + params["conv_b"].to(f32)
    log_a, gx = _rglru_gates(params, xc, tp)
    h0 = (torch.zeros((B, r), dtype=f32, device=x.device) if cache is None
          else cache["h"].to(f32))
    y, h_final = _linear_scan(log_a, gx, h0)
    out = _out(params, y, gate, x.dtype, cfg, backend, tp)
    if cache is not None:
        cache["h"].copy_(h_final)
        cache["conv"].copy_(xr_pad[:, L:])
    return out, cache


def rglru_decode(params: dict, x: torch.Tensor, cache: dict,
                 cfg: ModelConfig, *, backend: str = "auto", tp=None
                 ) -> Tuple[torch.Tensor, dict]:
    """One token per row, x: [B, 1, d], from the state in ``cache``,
    which is advanced in place and returned. ``tp`` as in
    :func:`rglru_block`."""
    f32 = torch.float32
    xr, gate = _branches(params, x, cfg, backend, tp)
    xr, gate = xr[:, 0], gate[:, 0]
    hist = torch.cat([cache["conv"].to(xr.dtype), xr[:, None]], dim=1)
    xc = torch.einsum("bcf,cf->bf", hist.to(f32), params["conv_w"].to(f32)) \
        + params["conv_b"].to(f32)
    log_a, gx = _rglru_gates(params, xc, tp)
    h = cache["h"].to(f32) * torch.exp(log_a) + gx
    out = _out(params, h[:, None], gate[:, None], x.dtype, cfg, backend, tp)
    cache["h"].copy_(h)
    cache["conv"].copy_(hist[:, 1:])
    return out, cache
