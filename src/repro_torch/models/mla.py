"""Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 style).

The port's counterpart of ``repro.models.mla``. Q comes through a
low-rank bottleneck (``w_dq`` then ``w_uq``); K/V come from a shared
compressed latent ``c_kv = w_dkv · x`` of rank ``kv_lora_rank``, plus a
decoupled RoPE key part ``k_rope`` shared across heads. The cache stores
only (c_kv, k_rope), ``kv_lora_rank + qk_rope_dim`` values a token a
layer (288 for minicpm3) where GQA stores K/V heads, and ``w_ukv``
expands them at attention time.

Every factor goes through ``sparse_linear.linear`` with its logical out
dim, so each may be dense or Tiled-CSL: ``w_dkv``'s 288 rows pad to 384
in Tiled-CSL and are sliced back. Prefill expands the latents through
``w_ukv`` and attends in f32 (``_mla_attend``, q-chunked as the
reference's scan is, with a loop since nothing here is differentiated).
Decode, paged decode and the verify window run the absorbed form
(``_absorbed_attend``): ``w_uk`` folds into the query and ``w_uv`` into
the output, so attention runs in the latent space against the bf16
cache with the reference's compensated hi/lo query split.

As in ``attention``, the cache given is written in place and returned,
and nothing on the decode or verify path reads a device value on the
host, so the serving steps can be captured as CUDA graphs. A Tiled-CSL
``w_ukv`` is decoded inside every absorbed step, as the reference does
(``tiled_csl.decode`` has no host read either).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import sparse_linear, tiled_csl
from repro_torch.models import nn, rope
from repro_torch.models.attention import (NEG_INF, _pos_vector,
                                          verify_window_mask,
                                          write_decode_token,
                                          write_decode_token_paged)
from repro_torch.models.config import ModelConfig


def init_mla(gen, cfg: ModelConfig, device, dtype=torch.float32) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "w_dq": {"w": nn.dense_init(gen, qr, d, device, dtype)},
        "w_uq": {"w": nn.dense_init(gen, h * (dn + dr), qr, device, dtype)},
        # the down-projection makes [c_kv (kvr) | k_rope (dr)]
        "w_dkv": {"w": nn.dense_init(gen, kvr + dr, d, device, dtype)},
        "w_ukv": {"w": nn.dense_init(gen, h * (dn + dv), kvr, device, dtype)},
        "wo": {"w": nn.dense_init(gen, d, h * dv, device, dtype)},
    }


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, device,
                   dtype=torch.bfloat16) -> dict:
    return {"ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                               dtype=dtype, device=device),
            "krope": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                                 dtype=dtype, device=device)}


def init_paged_mla_cache(cfg: ModelConfig, n_physical: int, block: int,
                         device, dtype=torch.bfloat16) -> dict:
    """Block-pool latent cache ``[n_physical, block, kvr / dr]``: each
    block holds ``block`` latent rows instead of K/V heads. Physical
    block 0 is the reserved trash block (``serving.paged_cache``)."""
    return {"ckv": torch.zeros((n_physical, block, cfg.kv_lora_rank),
                               dtype=dtype, device=device),
            "krope": torch.zeros((n_physical, block, cfg.qk_rope_dim),
                                 dtype=dtype, device=device)}


def _mla_qkv(params, x, positions, cfg: ModelConfig, backend: str):
    """Returns q_nope, q_rope (roped), c_kv, k_rope (roped)."""
    B, S = x.shape[0], x.shape[1]
    h, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    kvr = cfg.kv_lora_rank
    cq = sparse_linear.linear(params["w_dq"]["w"], x,
                              declared_out=cfg.q_lora_rank, backend=backend)
    q = sparse_linear.linear(params["w_uq"]["w"], cq,
                             declared_out=h * (dn + dr), backend=backend)
    q = q.reshape(B, S, h, dn + dr)
    q_nope = q[..., :dn]
    q_rope = rope.apply_rope(q[..., dn:], positions, cfg.rope_theta)
    dkv = sparse_linear.linear(params["w_dkv"]["w"], x,
                               declared_out=kvr + dr, backend=backend)
    c_kv = dkv[..., :kvr]
    k_rope = rope.apply_rope(dkv[..., kvr:][:, :, None, :], positions,
                             cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


def _mla_attend(params, q_nope, q_rope, c_kv, k_rope, mask,
                cfg: ModelConfig, backend: str) -> torch.Tensor:
    """Attention over expanded latents, then ``wo``. q_nope [B,S,H,dn],
    q_rope [B,S,H,dr], c_kv [B,T,kvr], k_rope [B,T,dr]; ``mask``
    broadcasts against [B,H,S,T]. For S past ``attn_q_chunk`` (and a
    multiple of it) the scores go a query chunk at a time, each chunk in
    the same f32 arithmetic as the whole."""
    B, S, h, dn = q_nope.shape
    T = c_kv.shape[1]
    dv = cfg.v_head_dim
    kv = sparse_linear.linear(params["w_ukv"]["w"], c_kv,
                              declared_out=h * (dn + dv), backend=backend)
    kv = kv.reshape(B, T, h, dn + dv)
    k_nope = kv[..., :dn].to(torch.float32)
    v = kv[..., dn:].to(torch.float32)
    k_rope_f = k_rope.to(torch.float32)
    scale = (dn + cfg.qk_rope_dim) ** -0.5

    def attend_block(qn, qr, blk_mask):
        s = (torch.einsum("bshd,bthd->bhst", qn.to(torch.float32), k_nope)
             + torch.einsum("bshd,btd->bhst", qr.to(torch.float32),
                            k_rope_f)) * scale
        s = s.masked_fill(~blk_mask, NEG_INF)
        return torch.einsum("bhst,bthd->bshd", torch.softmax(s, dim=-1), v)

    Cq = cfg.attn_q_chunk
    if Cq and S > Cq and S % Cq == 0 and mask.shape[-2] == S:
        o = torch.cat([attend_block(q_nope[:, lo:lo + Cq],
                                    q_rope[:, lo:lo + Cq],
                                    mask[..., lo:lo + Cq, :])
                       for lo in range(0, S, Cq)], dim=1)
    else:
        o = attend_block(q_nope, q_rope, mask)
    o = o.reshape(B, S, h * dv).to(q_nope.dtype)
    return sparse_linear.linear(params["wo"]["w"], o,
                                declared_out=cfg.d_model, backend=backend)


def mla_attention(params: dict, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig, *, cache: Optional[dict] = None,
                  backend: str = "auto") -> Tuple[torch.Tensor, Optional[dict]]:
    """Full-sequence (prefill) MLA. With ``cache``, the latents are
    written at positions [0, S) of it."""
    S = x.shape[1]
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(params, x, positions, cfg,
                                            backend)
    mask = (positions[:, None, :] <= positions[:, :, None])[:, None]
    y = _mla_attend(params, q_nope, q_rope, c_kv, k_rope, mask, cfg, backend)
    if cache is not None:
        cache["ckv"][:, :S] = c_kv.to(cache["ckv"].dtype)
        cache["krope"][:, :S] = k_rope.to(cache["krope"].dtype)
    return y, cache


def mla_decode(params: dict, x: torch.Tensor, cache: dict, pos,
               cfg: ModelConfig, *, backend: str = "auto"
               ) -> Tuple[torch.Tensor, dict]:
    """One-token MLA decode in the absorbed form against the dense latent
    cache. ``pos`` is every row's position (an int or a 0-d tensor) or
    each row's (a [B] tensor); the latents are written there, in place.

    The naive form re-expands the whole latent cache through ``w_ukv``
    every step; the absorbed form folds ``w_uk`` into the query
    (``q_lat = q_nope @ w_uk`` a head) and ``w_uv`` into the output, so
    the scores and the weighted sum run over the kvr-wide latents."""
    pos_vec = _pos_vector(pos, x.shape[0], x.device)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(params, x, pos_vec[:, None], cfg,
                                            backend)
    write_decode_token(cache["ckv"], c_kv, pos_vec)
    write_decode_token(cache["krope"], k_rope, pos_vec)
    y = _absorbed_attend(params, x, q_nope, q_rope, cache["ckv"],
                         cache["krope"], pos_vec, cfg, backend)
    return y, cache


def _gather(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """[B, blocks_per_seq * block, width] of a latent pool, position order
    being gather order."""
    B = block_tables.shape[0]
    return pool[block_tables].reshape(B, -1, pool.shape[-1])


def mla_decode_paged(params: dict, x: torch.Tensor, cache: dict,
                     block_tables: torch.Tensor, pos, cfg: ModelConfig, *,
                     backend: str = "auto") -> Tuple[torch.Tensor, dict]:
    """Absorbed-form decode against a paged latent pool. Cache leaves are
    ``[n_physical, block, kvr / dr]``; ``block_tables`` is
    [B, blocks_per_seq] (padding entries name the trash block and are
    masked); ``pos`` is per row. The same write and gather discipline as
    ``attention.attention_decode_paged``."""
    pos_vec = _pos_vector(pos, x.shape[0], x.device)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(params, x, pos_vec[:, None], cfg,
                                            backend)
    blk = cache["ckv"].shape[1]
    logical = torch.div(pos_vec, blk, rounding_mode="floor")
    phys = torch.gather(block_tables, 1, logical[:, None])[:, 0]
    off = pos_vec - logical * blk
    write_decode_token_paged(cache["ckv"], c_kv, phys, off)
    write_decode_token_paged(cache["krope"], k_rope, phys, off)
    y = _absorbed_attend(params, x, q_nope, q_rope,
                         _gather(cache["ckv"], block_tables),
                         _gather(cache["krope"], block_tables), pos_vec, cfg,
                         backend)
    return y, cache


def mla_verify_paged(params: dict, x: torch.Tensor, cache: dict,
                     block_tables: torch.Tensor, pos, cfg: ModelConfig, *,
                     backend: str = "auto") -> Tuple[torch.Tensor, dict]:
    """A verify window of W positions per row over the paged latent pools,
    the MLA twin of ``attention.attention_verify_paged``. ``x [B, W, d]``;
    ``pos`` is window column 0's position of each row. The old latents are
    gathered before anything is written; the window's fresh (c_kv,
    k_rope), rounded to the cache dtype as a write and a gather would
    round them, ride as W extra masked columns. The pool is left as it
    was. Returns (y [B, W, d], fresh {"ckv"/"krope": [B, W, *]})."""
    if cfg.local_window is not None:
        raise ValueError("sliding-window rings are not supported for MLA "
                         "paged verify")
    B, W = x.shape[0], x.shape[1]
    pos_vec = _pos_vector(pos, B, x.device)
    positions = pos_vec[:, None] + torch.arange(W, device=x.device)[None, :]
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(params, x, positions, cfg,
                                            backend)
    c_kv = c_kv.to(cache["ckv"].dtype)
    k_rope = k_rope.to(cache["krope"].dtype)
    ckv_old = _gather(cache["ckv"], block_tables)
    krope_old = _gather(cache["krope"], block_tables)
    mask = verify_window_mask(pos_vec, W, ckv_old.shape[1])
    y = _absorbed_attend(params, x, q_nope, q_rope,
                         torch.cat([ckv_old, c_kv], dim=1),
                         torch.cat([krope_old, k_rope], dim=1), pos_vec, cfg,
                         backend, mask=mask[:, None])
    return y, {"ckv": c_kv, "krope": k_rope}


def _absorbed_attend(params: dict, x: torch.Tensor, q_nope, q_rope, ckv,
                     ckrope, pos_vec, cfg: ModelConfig, backend: str, *,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Absorbed-form attention over a [B, T, *] latent sequence (the dense
    cache, or a block-table gather whose padding columns mask to exact
    softmax zeros), then the ``w_uv`` and ``wo`` output path. ``mask``
    (broadcastable against [B, h, S, T]) replaces the single-query causal
    bound ``t <= pos``; the verify window passes its own."""
    B, T = x.shape[0], ckv.shape[1]
    h, dn, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    w_ukv = params["w_ukv"]["w"]
    if isinstance(w_ukv, tiled_csl.TiledCSL):
        w_ukv = tiled_csl.decode(w_ukv)[:h * (dn + dv), :kvr]
    w_ukv = w_ukv.reshape(h, dn + dv, kvr)
    w_uk = w_ukv[:, :dn].to(torch.float32)                     # [h, dn, kvr]
    w_uv = w_ukv[:, dn:].to(torch.float32)                     # [h, dv, kvr]

    q_lat = torch.einsum("bshd,hdr->bshr", q_nope.to(torch.float32), w_uk)
    cdt = ckv.dtype
    scale = (dn + cfg.qk_rope_dim) ** -0.5
    # Rounding q_lat straight to the cache dtype loses the mantissa bits
    # the prefill path's f32 scores keep. The compensated split carries
    # the rounding residual as a second cache-dtype row, stacked on the s
    # axis, so the latent cache is contracted once for both rows.
    S = q_lat.shape[1]
    q_lat_hi = q_lat.to(cdt)
    q_lat_lo = (q_lat - q_lat_hi.to(torch.float32)).to(cdt)
    s_pair = nn.einsum_f32acc("bshr,btr->bhst",
                              torch.cat([q_lat_hi, q_lat_lo], dim=1),
                              ckv)                              # [B,h,2S,T]
    scores = (s_pair[:, :, :S] + s_pair[:, :, S:]
              + nn.einsum_f32acc("bshd,btd->bhst", q_rope.to(cdt),
                                 ckrope)) * scale
    if mask is None:
        mask = (torch.arange(T, device=x.device)[None, :]
                <= pos_vec[:, None])[:, None, None, :]
    scores = scores.masked_fill(~mask, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    o_lat = nn.einsum_f32acc("bhst,btr->bshr", w.to(cdt), ckv)   # [B,S,h,kvr]
    o = torch.einsum("bshr,hdr->bshd", o_lat, w_uv)              # [B,S,h,dv]
    o = o.reshape(B, S, h * dv).to(x.dtype)
    return sparse_linear.linear(params["wo"]["w"], o,
                                declared_out=cfg.d_model, backend=backend)
