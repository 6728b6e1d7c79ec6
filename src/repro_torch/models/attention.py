"""GQA attention with RoPE and a dense or paged KV cache.

The port's counterpart of the GQA path of ``repro.models.attention``:
``_project_qkv``, ``attention`` (prefill), ``attention_decode`` (dense
cache, one position per row) and ``attention_decode_paged`` (a block pool
read through per-request block tables). Projections go through
``sparse_linear`` (dense or Tiled-CSL weights); the score and
weighted-sum einsums stay plain PyTorch, as the reference leaves them to
XLA. K/V are stored in bf16.

Where the reference returns a new cache, the port writes the one it was
given in place (``index_put_``) and returns it: the serving stepper
allocates its cache once and a captured CUDA graph holds those tensors'
addresses. Nothing on the decode path reads a device value on the host,
so the step can be captured.
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


def init_paged_cache(cfg: ModelConfig, n_physical: int, block: int, device,
                     dtype=torch.bfloat16) -> dict:
    """Block-pool K/V: ``[n_physical, block, n_kv, head_dim]``. Requests
    map onto the pool through per-request block tables; physical block 0
    is the reserved trash block (``serving.paged_cache``)."""
    kv, hd = cfg.n_kv, cfg.head_dim
    return {"k": torch.zeros((n_physical, block, kv, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((n_physical, block, kv, hd), dtype=dtype,
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
    scores = _gqa_scores(q, k).masked_fill(~valid[:, None, None], NEG_INF)
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


def _pos_vector(pos, batch: int, device) -> torch.Tensor:
    """``pos`` (an int, a 0-d tensor shared by every row, or a [B] tensor
    of per-row positions) as [B] int64. A 0-d tensor is broadcast with
    ``expand``, with no read back to the host, so a captured step can take
    it."""
    if isinstance(pos, torch.Tensor):
        pos = pos.to(device=device, dtype=torch.int64)
        return pos.expand(batch) if pos.dim() == 0 else pos.reshape(batch)
    return torch.full((batch,), int(pos), dtype=torch.int64, device=device)


def write_decode_token(buf: torch.Tensor, new: torch.Tensor,
                       slot_vec: torch.Tensor) -> torch.Tensor:
    """``buf[b, slot_vec[b]] = new[b, 0]`` in place. ``buf`` is
    [B, T, ...], ``new`` [B, 1, ...]."""
    rows = torch.arange(buf.shape[0], device=buf.device)
    buf.index_put_((rows, slot_vec), new[:, 0].to(buf.dtype))
    return buf


def write_decode_token_paged(pool: torch.Tensor, new: torch.Tensor,
                             phys: torch.Tensor,
                             off: torch.Tensor) -> torch.Tensor:
    """Paged decode write ``pool[phys[b], off[b]] = new[b, 0]`` in place.
    The scheduler's copy-on-write rule keeps every (phys, off) of a live
    row private to it; idle rows all write the trash block."""
    pool.index_put_((phys, off), new[:, 0].to(pool.dtype))
    return pool


def _masked_decode_attend(q, ck, cv, pos_vec) -> torch.Tensor:
    """Scores, validity mask and weighted sum for one-token decode over a
    [B, T, KV, D] key/value sequence (the dense cache, or a block-table
    gather, whose T is whole blocks): column t is valid iff t <= pos, and
    masked columns get exact softmax zeros."""
    T = ck.shape[1]
    valid = torch.arange(T, device=q.device)[None, :] <= pos_vec[:, None]
    return _attend(q, ck, cv, valid[:, None, :])


def _decode_qkv(params, x, pos_vec, cfg: ModelConfig, backend: str):
    q, k, v = _project_qkv(params, x, cfg, backend)
    positions = pos_vec[:, None]
    return (rope.apply_rope(q, positions, cfg.rope_theta),
            rope.apply_rope(k, positions, cfg.rope_theta), v)


def attention_decode(params: dict, x: torch.Tensor, cache: dict, pos,
                     cfg: ModelConfig, *, backend: str = "auto"
                     ) -> Tuple[torch.Tensor, dict]:
    """Single-token decode against the dense cache. ``pos`` is the
    absolute position of every row (an int) or of each row (a [B]
    tensor: continuous batching decodes every slot at its own position).
    Writes K/V at ``pos`` and attends over positions [0, pos]."""
    pos_vec = _pos_vector(pos, x.shape[0], x.device)
    q, k, v = _decode_qkv(params, x, pos_vec, cfg, backend)
    write_decode_token(cache["k"], k, pos_vec)
    write_decode_token(cache["v"], v, pos_vec)
    o = _masked_decode_attend(q, cache["k"], cache["v"], pos_vec)
    y = sparse_linear.linear(params["wo"]["w"], o.to(x.dtype),
                             declared_out=cfg.d_model, backend=backend)
    return y, cache


def attention_decode_paged(params: dict, x: torch.Tensor, cache: dict,
                           block_tables: torch.Tensor, pos,
                           cfg: ModelConfig, *, backend: str = "auto"
                           ) -> Tuple[torch.Tensor, dict]:
    """Single-token decode against a paged block pool. Cache leaves are
    ``[n_physical, block, kv, hd]``; ``block_tables`` is
    [B, blocks_per_seq] physical block ids (padding entries name the trash
    block and are masked); ``pos`` is per row. Each row's K/V is gathered
    through its table into [B, blocks_per_seq * block, ...], position
    order being gather order."""
    B = x.shape[0]
    pos_vec = _pos_vector(pos, B, x.device)
    q, k, v = _decode_qkv(params, x, pos_vec, cfg, backend)
    blk = cache["k"].shape[1]
    logical = torch.div(pos_vec, blk, rounding_mode="floor")
    phys = torch.gather(block_tables, 1, logical[:, None])[:, 0]
    off = pos_vec - logical * blk
    write_decode_token_paged(cache["k"], k, phys, off)
    write_decode_token_paged(cache["v"], v, phys, off)
    kv_heads, hd = cache["k"].shape[-2], cache["k"].shape[-1]
    kg = cache["k"][block_tables].reshape(B, -1, kv_heads, hd)
    vg = cache["v"][block_tables].reshape(B, -1, kv_heads, hd)
    o = _masked_decode_attend(q, kg, vg, pos_vec)
    y = sparse_linear.linear(params["wo"]["w"], o.to(x.dtype),
                             declared_out=cfg.d_model, backend=backend)
    return y, cache
