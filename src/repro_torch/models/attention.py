"""GQA attention with RoPE and a dense KV cache.

The port's counterpart of the dense-cache path of
``repro.models.attention``: ``_project_qkv``, ``attention`` (prefill)
and ``attention_decode``. Projections go through ``sparse_linear`` (dense
or Tiled-CSL weights); the score and weighted-sum einsums stay plain
PyTorch, as the reference leaves them to XLA. K/V are stored in bf16.
The cache is updated in place.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import sparse_linear
from repro_torch.models import nn, rope
from repro_torch.models.config import ModelConfig

NEG_INF = -2.3819763e38  # large negative for bf16-safe masking


def init_attention(gen, cfg: ModelConfig, device, dtype=torch.float32) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    p = {
        "wq": {"w": nn.dense_init(gen, h * hd, d, device, dtype)},
        "wk": {"w": nn.dense_init(gen, kv * hd, d, device, dtype)},
        "wv": {"w": nn.dense_init(gen, kv * hd, d, device, dtype)},
        "wo": {"w": nn.dense_init(gen, d, h * hd, device, dtype)},
    }
    if cfg.qkv_bias:
        p["wq"]["b"] = nn.zeros_init((h * hd,), device, dtype)
        p["wk"]["b"] = nn.zeros_init((kv * hd,), device, dtype)
        p["wv"]["b"] = nn.zeros_init((kv * hd,), device, dtype)
    return p


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               dtype=torch.bfloat16) -> dict:
    kv, hd = cfg.n_kv, cfg.head_dim
    return {"k": torch.zeros((batch, max_len, kv, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, max_len, kv, hd), dtype=dtype,
                             device=device)}


def _project_qkv(params, x, cfg: ModelConfig, backend: str):
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    bs = tuple(params.get(n, {}).get("b") for n in ("wq", "wk", "wv"))
    outs = (h * hd, kv * hd, kv * hd)
    if "wqkv" in params:
        q, k, v = sparse_linear.linear_grouped(
            params["wqkv"]["w"], x, bs, declared_outs=outs, backend=backend)
    else:
        ws = tuple(params[n]["w"] for n in ("wq", "wk", "wv"))
        if sparse_linear.groupable(ws):
            q, k, v = sparse_linear.linear_grouped(
                ws, x, bs, declared_outs=outs, backend=backend)
        elif sparse_linear.groupable(ws[1:]):
            # GQA: wk/wv share a shape even when wq does not.
            q = sparse_linear.linear(ws[0], x, bs[0], declared_out=outs[0],
                                     backend=backend)
            k, v = sparse_linear.linear_grouped(
                ws[1:], x, bs[1:], declared_outs=outs[1:], backend=backend)
        else:
            q, k, v = (sparse_linear.linear(w, x, b, declared_out=o,
                                            backend=backend)
                       for w, b, o in zip(ws, bs, outs))
    B, S = x.shape[0], x.shape[1]
    return (q.reshape(B, S, h, hd), k.reshape(B, S, kv, hd),
            v.reshape(B, S, kv, hd))


def _gqa_scores(q, k):
    """q: [B,S,H,D], k: [B,T,KV,D] -> f32 scores [B,KV,G,S,T]."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    q = q.reshape(B, S, KV, H // KV, D)
    return nn.einsum_f32acc("bskgd,btkd->bkgst", q, k) * (D ** -0.5)


def _gqa_out(weights, v):
    """weights: [B,KV,G,S,T], v: [B,T,KV,D] -> f32 [B,S,H*D]."""
    B, KV, G, S, T = weights.shape
    o = nn.einsum_f32acc("bkgst,btkd->bskgd", weights.to(v.dtype), v)
    return o.reshape(B, S, KV * G * v.shape[-1])


def _attend(q, k, v, valid) -> torch.Tensor:
    """Masked softmax attention; ``valid`` broadcasts to [B, S, T]."""
    scores = _gqa_scores(q, k)
    scores = torch.where(valid[:, None, None], scores,
                         torch.tensor(NEG_INF, dtype=scores.dtype,
                                      device=scores.device))
    return _gqa_out(torch.softmax(scores, dim=-1), v)


def attention(params: dict, x: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig, *, cache: Optional[dict] = None,
              backend: str = "auto") -> Tuple[torch.Tensor, Optional[dict]]:
    """Full-sequence (prefill) causal attention. With ``cache``, the new
    K/V are written at positions [0, S) of it."""
    S = x.shape[1]
    q, k, v = _project_qkv(params, x, cfg, backend)
    q = rope.apply_rope(q, positions, cfg.rope_theta)
    k = rope.apply_rope(k, positions, cfg.rope_theta).to(torch.bfloat16)
    v = v.to(torch.bfloat16)
    # Query chunks bound the score block to [B, KV, G, chunk, S]; each
    # chunk sees every key, so the result is the full-scores one.
    chunk = cfg.attn_q_chunk if cfg.attn_q_chunk and S > cfg.attn_q_chunk \
        else S
    if chunk < S:
        q = q.to(k.dtype)      # the reference's chunked path scores in bf16
    outs = []
    for lo in range(0, S, chunk):
        qp = positions[:, lo:lo + chunk]
        valid = positions[:, None, :] <= qp[:, :, None]        # [B, c, T]
        outs.append(_attend(q[:, lo:lo + chunk], k, v, valid))
    o = torch.cat(outs, dim=1).to(x.dtype)
    y = sparse_linear.linear(params["wo"]["w"], o, declared_out=cfg.d_model,
                             backend=backend)
    if cache is not None:
        cache["k"][:, :S] = k.to(cache["k"].dtype)
        cache["v"][:, :S] = v.to(cache["v"].dtype)
    return y, cache


def attention_decode(params: dict, x: torch.Tensor, cache: dict, pos: int,
                     cfg: ModelConfig, *, backend: str = "auto"
                     ) -> Tuple[torch.Tensor, dict]:
    """Single-token decode at absolute position ``pos`` (same for every
    row): writes K/V at ``pos`` and attends over positions [0, pos]."""
    B = x.shape[0]
    positions = torch.full((B, 1), int(pos), dtype=torch.int64,
                           device=x.device)
    q, k, v = _project_qkv(params, x, cfg, backend)
    q = rope.apply_rope(q, positions, cfg.rope_theta)
    k = rope.apply_rope(k, positions, cfg.rope_theta)
    cache["k"][:, pos] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, pos] = v[:, 0].to(cache["v"].dtype)
    T = cache["k"].shape[1]
    valid = (torch.arange(T, device=x.device) <= pos)[None, None, :]
    o = _attend(q, cache["k"], cache["v"], valid.expand(B, 1, T))
    y = sparse_linear.linear(params["wo"]["w"], o.to(x.dtype),
                             declared_out=cfg.d_model, backend=backend)
    return y, cache
