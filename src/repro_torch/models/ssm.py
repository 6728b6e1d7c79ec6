"""Mamba2 SSD (state-space duality) block, the attention-free family
(mamba2-130m; Dao & Gu, arXiv:2405.21060).

The port's counterpart of ``repro.models.ssm``. Prefill runs the chunked
SSD algorithm (§6 of the paper): chunk-local quadratic "attention" with
decay plus an inter-chunk state recurrence, O(L) in the sequence; decode
runs the O(1)-per-token recurrent form. A is one scalar a head (the SSD
restriction), B and C are shared by every head (one group).

One fused ``in_proj`` [2 d_inner + 2 n + heads, d_model] produces (z, x,
B, C, dt) and ``out_proj`` [d_model, d_inner] maps back; both go through
``sparse_linear`` (dense or Tiled-CSL). The causal depthwise conv and its
SiLU run in f32, the state is f32 throughout, ``y`` is cast to the
activation dtype before it meets the gate ``silu(z)`` (computed in f32,
then cast), as in the reference. The per-sequence state is ``state [heads,
head_dim, n]`` and the last ``conv - 1`` pre-activation inputs ``conv``,
both f32.

The reference's three-operand einsums are contracted pairwise here, in
an order that never builds a ``[b, chunks, c, c, heads, head_dim]``
intermediate; the largest is the ``[b, chunks, c, c, heads]`` decay.
Its inter-chunk ``lax.scan`` is a Python loop over the chunks. Decode
writes the state it is given in place (``copy_``), so a captured CUDA
graph replays against the same buffers.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import sparse_linear
from repro_torch.models import layers, nn
from repro_torch.models.config import ModelConfig


def _dims(cfg: ModelConfig):
    return cfg.ssm_inner, cfg.ssm_heads, cfg.ssm_state


def init_ssm(gen, cfg: ModelConfig, device, dtype=torch.float32) -> dict:
    d = cfg.d_model
    din, heads, n = _dims(cfg)
    f32 = torch.float32
    in_proj = nn.dense_init(gen, 2 * din + 2 * n + heads, d, device, dtype)
    out_proj = nn.dense_init(gen, d, din, device, dtype)
    conv_w = torch.randn((cfg.ssm_conv, din + 2 * n), generator=gen,
                         dtype=f32, device=device) * 0.1
    return {
        "in_proj": {"w": in_proj},
        "out_proj": {"w": out_proj},
        "conv_w": conv_w.to(dtype),
        "conv_b": nn.zeros_init((din + 2 * n,), device, dtype),
        "a_log": torch.log(torch.linspace(1.0, float(heads), heads,
                                          device=device)).to(dtype),
        "d_skip": nn.ones_init((heads,), device, dtype),
        "dt_bias": torch.full((heads,), math.log(math.expm1(1e-2)),
                              device=device).to(dtype),
        "norm": layers.init_rmsnorm(din, device, dtype),
    }


def init_ssm_cache(cfg: ModelConfig, batch: int, device,
                   dtype=torch.float32) -> dict:
    din, heads, n = _dims(cfg)
    return {"state": torch.zeros((batch, heads, cfg.ssm_head_dim, n),
                                 dtype=dtype, device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, din + 2 * n),
                                dtype=dtype, device=device)}


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    din, _, n = _dims(cfg)
    return (zxbcdt[..., :din], zxbcdt[..., din:2 * din + 2 * n],
            zxbcdt[..., 2 * din + 2 * n:])


def _ssd_chunked(x, dt, a_log, B, C, d_skip, chunk: int, init_state=None):
    """Chunked SSD scan. x: [b, l, h, p]; dt: [b, l, h] (after softplus);
    B, C: [b, l, n]; a_log: [h]; l a multiple of ``chunk``. Returns y
    [b, l, h, p] and the final state [b, h, p, n], both f32."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    nc = l // chunk
    f32 = torch.float32
    A = -torch.exp(a_log.to(f32))                              # [h], < 0
    dt = dt.to(f32)
    xr = x.reshape(b, nc, chunk, h, p).to(f32)
    Br = B.reshape(b, nc, chunk, n).to(f32)
    Cr = C.reshape(b, nc, chunk, n).to(f32)
    dAr = (dt * A).reshape(b, nc, chunk, h)
    dtr = dt.reshape(b, nc, chunk, h)

    seg = torch.cumsum(dAr, dim=2)                             # [b,z,c,h]
    # Intra-chunk (diagonal block): causal attention with decay. Above
    # the diagonal seg_c - seg_s > 0 and its exp may overflow, so those
    # entries are masked to -inf before the exp (exactly 0 after it).
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    diff = (seg[:, :, :, None, :] - seg[:, :, None, :, :]).masked_fill(
        ~causal[None, None, :, :, None], float("-inf"))
    cb = torch.einsum("bzcn,bzsn->bzcs", Cr, Br)               # [b,z,c,s]
    att = cb[..., None] * torch.exp(diff) * dtr[:, :, None]    # [b,z,c,s,h]
    y = torch.einsum("bzcsh,bzshp->bzchp", att, xr)
    del diff, att

    # Chunk-final states: sum_s exp(seg_end - seg_s) dt_s B_s x_s.
    w = (torch.exp(seg[:, :, -1:] - seg) * dtr)[..., None] * xr  # [b,z,s,h,p]
    chunk_state = torch.einsum("bzsn,bzshp->bzhpn", Br, w)
    chunk_decay = torch.exp(dAr.sum(dim=2))                    # [b,z,h]

    # Inter-chunk recurrence over the chunks: the state entering each.
    st = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
          if init_state is None else init_state.to(f32))
    prev = []
    for z in range(nc):
        prev.append(st)
        st = st * chunk_decay[:, z, :, None, None] + chunk_state[:, z]
    prev_states = torch.stack(prev, dim=1)                     # [b,z,h,p,n]

    # Inter-chunk contribution: C_t exp(seg_t) state_prev.
    y_off = torch.einsum("bzcn,bzhpn->bzchp", Cr, prev_states)
    y = (y + y_off * torch.exp(seg)[..., None]).reshape(b, l, h, p)
    return y + d_skip.to(f32)[None, None, :, None] * x.to(f32), st


def _gate_out(params, y, z, x_dtype, cfg: ModelConfig, backend: str):
    """rmsnorm(y * silu(z)) through ``out_proj``: y cast to the activation
    dtype first, the gate in f32 then cast, as the reference rounds."""
    y = y.to(x_dtype) * F.silu(z.to(torch.float32)).to(x_dtype)
    return sparse_linear.linear(params["out_proj"]["w"],
                                layers.rmsnorm(params["norm"], y),
                                declared_out=cfg.d_model, backend=backend)


def ssm_block(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
              cache: Optional[dict] = None, backend: str = "auto"
              ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Prefill, x: [B, L, d], any L. The scan starts from zero state and
    the conv from zero inputs, as in the reference. L is padded up to a
    multiple of the chunk (``min(ssm_chunk, L)``) with dt = 0 on the pad,
    which passes the state through unchanged, so the final state is
    exact. With ``cache``, the final state and the last ``conv - 1``
    pre-activation inputs (zeros ahead of a prompt shorter than that)
    are written into it, in place, and it is returned."""
    Bsz, L, _ = x.shape
    din, heads, n = _dims(cfg)
    hp = cfg.ssm_head_dim
    f32 = torch.float32
    zxbcdt = sparse_linear.linear(params["in_proj"]["w"], x,
                                  declared_out=2 * din + 2 * n + heads,
                                  backend=backend)
    z, xbc, dt = _split_proj(zxbcdt, cfg)
    cw = params["conv_w"].to(f32)                              # [cv, ch]
    cv = cw.shape[0]
    xbc_pad = torch.cat([xbc.new_zeros((Bsz, cv - 1, xbc.shape[-1])), xbc],
                        dim=1)
    conv = xbc_pad[:, :L].to(f32) * cw[0]
    for i in range(1, cv):                   # causal depthwise conv
        conv = conv + xbc_pad[:, i:i + L].to(f32) * cw[i]
    xbc = F.silu(conv + params["conv_b"].to(f32))
    xs = xbc[..., :din].reshape(Bsz, L, heads, hp)
    Bmat, Cmat = xbc[..., din:din + n], xbc[..., din + n:]
    dt = F.softplus(dt.to(f32) + params["dt_bias"].to(f32))

    chunk = min(cfg.ssm_chunk, L)
    Lp = -(-L // chunk) * chunk
    if Lp != L:
        padw = Lp - L
        xs = F.pad(xs, (0, 0, 0, 0, 0, padw))
        Bmat = F.pad(Bmat, (0, 0, 0, padw))
        Cmat = F.pad(Cmat, (0, 0, 0, padw))
        dt = F.pad(dt, (0, 0, 0, padw))       # dt = 0: an exact passthrough
    y, final_state = _ssd_chunked(xs, dt, params["a_log"], Bmat, Cmat,
                                  params["d_skip"], chunk)
    out = _gate_out(params, y[:, :L].reshape(Bsz, L, din), z, x.dtype, cfg,
                    backend)
    if cache is not None:
        cache["state"].copy_(final_state)
        cache["conv"].copy_(xbc_pad[:, L:L + cv - 1])
    return out, cache


def ssm_decode(params: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig,
               *, backend: str = "auto") -> Tuple[torch.Tensor, dict]:
    """One token per row, x: [B, 1, d], from the state in ``cache``,
    which is advanced in place and returned."""
    Bsz = x.shape[0]
    din, heads, n = _dims(cfg)
    hp = cfg.ssm_head_dim
    f32 = torch.float32
    zxbcdt = sparse_linear.linear(params["in_proj"]["w"], x,
                                  declared_out=2 * din + 2 * n + heads,
                                  backend=backend)
    z, xbc_new, dt = _split_proj(zxbcdt, cfg)
    # the conv ring: cache["conv"] holds the previous conv - 1 raw inputs
    hist = torch.cat([cache["conv"].to(xbc_new.dtype), xbc_new], dim=1)
    conv = torch.einsum("bcf,cf->bf", hist.to(f32), params["conv_w"].to(f32))
    xbc = F.silu(conv + params["conv_b"].to(f32))
    xs = xbc[:, :din].reshape(Bsz, heads, hp)
    Bv, Cv = xbc[:, din:din + n], xbc[:, din + n:]
    dt = F.softplus(dt[:, 0].to(f32) + params["dt_bias"].to(f32))  # [B, h]
    dA = torch.exp(dt * -torch.exp(params["a_log"].to(f32)))
    upd = (dt[:, :, None] * xs)[..., None] * Bv[:, None, None, :]
    st = cache["state"].to(f32) * dA[:, :, None, None] + upd   # [B,h,p,n]
    y = (st @ Cv[:, None, :, None])[..., 0]                    # [B,h,p]
    y = y + params["d_skip"].to(f32)[None, :, None] * xs
    out = _gate_out(params, y.reshape(Bsz, 1, din), z, x.dtype, cfg, backend)
    cache["state"].copy_(st)
    cache["conv"].copy_(hist[:, 1:])
    return out, cache
