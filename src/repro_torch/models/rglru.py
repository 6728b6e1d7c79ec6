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


def _rglru_gates(params, xr: torch.Tensor):
    """xr: [..., r] f32 -> (log_a, gated input), both [..., r] f32."""
    f32 = torch.float32
    r_gate = torch.sigmoid(xr @ params["wa"]["w"].to(f32).T
                           + params["ba"].to(f32))
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


def rglru_block(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                cache: Optional[dict] = None, backend: str = "auto"
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Prefill, x: [B, L, d]. The scan starts from ``cache["h"]`` when a
    cache is given (a fresh one holds zeros), else from zero; the conv
    always starts from zero inputs, as in the reference. With ``cache``,
    the final state and the last ``conv - 1`` pre-conv inputs are
    written into it (in place) and it is returned."""
    B, L, _ = x.shape
    r = cfg.rnn_dim
    f32 = torch.float32
    xr = sparse_linear.linear(params["w_x"]["w"], x, declared_out=r,
                              backend=backend)
    gate = sparse_linear.linear(params["w_gate"]["w"], x, declared_out=r,
                                backend=backend)
    cv = params["conv_w"].shape[0]
    xr_pad = torch.cat([xr.new_zeros((B, cv - 1, r)), xr], dim=1)
    cw = params["conv_w"].to(f32)
    conv = xr_pad[:, :L].to(f32) * cw[0]
    for i in range(1, cv):                   # causal depthwise conv
        conv = conv + xr_pad[:, i:i + L].to(f32) * cw[i]
    xc = conv + params["conv_b"].to(f32)
    log_a, gx = _rglru_gates(params, xc)
    h0 = (torch.zeros((B, r), dtype=f32, device=x.device) if cache is None
          else cache["h"].to(f32))
    y, h_final = _linear_scan(log_a, gx, h0)
    out = sparse_linear.linear(params["w_out"]["w"],
                               _gelu_gate(y, gate, x.dtype),
                               declared_out=cfg.d_model, backend=backend)
    if cache is not None:
        cache["h"].copy_(h_final)
        cache["conv"].copy_(xr_pad[:, L:])
    return out, cache


def rglru_decode(params: dict, x: torch.Tensor, cache: dict,
                 cfg: ModelConfig, *, backend: str = "auto"
                 ) -> Tuple[torch.Tensor, dict]:
    """One token per row, x: [B, 1, d], from the state in ``cache``,
    which is advanced in place and returned."""
    r = cfg.rnn_dim
    f32 = torch.float32
    xr = sparse_linear.linear(params["w_x"]["w"], x, declared_out=r,
                              backend=backend)[:, 0]
    gate = sparse_linear.linear(params["w_gate"]["w"], x, declared_out=r,
                                backend=backend)[:, 0]
    hist = torch.cat([cache["conv"].to(xr.dtype), xr[:, None]], dim=1)
    xc = torch.einsum("bcf,cf->bf", hist.to(f32), params["conv_w"].to(f32)) \
        + params["conv_b"].to(f32)
    log_a, gx = _rglru_gates(params, xc)
    h = cache["h"].to(f32) * torch.exp(log_a) + gx
    out = sparse_linear.linear(params["w_out"]["w"],
                               _gelu_gate(h, gate, x.dtype)[:, None, :],
                               declared_out=cfg.d_model, backend=backend)
    cache["h"].copy_(h)
    cache["conv"].copy_(hist[:, 1:])
    return out, cache
