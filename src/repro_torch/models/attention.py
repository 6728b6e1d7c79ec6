"""GQA attention with RoPE and a dense or paged KV cache.

The port's counterpart of the GQA path of ``repro.models.attention``:
``_project_qkv``, ``attention`` (prefill), ``attention_decode`` (dense
cache, one position per row), ``attention_decode_paged`` (a block pool
read through per-request block tables) and ``attention_verify_paged``
(a window of W positions per row against the block pool, the cache write
left to the caller: speculative verify and the chunked-prefill mixed
step). A config with ``local_window`` W attends to the last W positions
only and keeps them in a ring: the dense cache holds min(max_len, W)
positions, position p at slot ``p % W``, and the paged cache puts p at
``p % ring_len`` of the request's blocks, ``ring_len`` = min(max_len, W)
given by the caller. Projections go through
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
from repro_torch.distributed import tensor_parallel
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
    """K/V ``[batch, max_len, n_kv, head_dim]``; a sliding window caps the
    length at the window (the ring)."""
    kv, hd = cfg.n_kv, cfg.head_dim
    if cfg.local_window is not None:
        max_len = min(max_len, cfg.local_window)
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


def _project_qkv(params, x, cfg: ModelConfig, backend: str, tp=None):
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    bs = tuple(params.get(n, {}).get("b") for n in ("wq", "wk", "wv"))
    outs = (h * hd, kv * hd, kv * hd)
    if tp is not None:
        q, k, v = _project_qkv_tp(params, x, bs, outs, hd, backend, tp)
    elif "wqkv" in params:
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


def _project_qkv_tp(params, x, bs, outs, hd: int, backend: str, tp):
    """Column-parallel q/k/v: ``cfg`` is the rank's (its heads), so the
    whole q dim is ``outs[0] * tp.size`` and the whole k/v dims
    ``tp.kv_heads * head_dim``. Where there are fewer KV heads than
    ranks, each rank computes its share of k/v, the shares are summed
    into the whole k/v (``gather_from``) and the rank keeps the one head
    its query heads read."""
    x = tensor_parallel.copy_to(x, tp)
    full = (outs[0] * tp.size,) + (tp.kv_heads * hd,) * 2
    if "wqkv" in params:
        q, k, v = sparse_linear.column_parallel_grouped(
            params["wqkv"]["w"], x, bs, outs=full, tp=tp, backend=backend)
        return q, k, v
    ws = tuple(params[n]["w"] for n in ("wq", "wk", "wv"))
    if full[0] == full[1] and sparse_linear.groupable(ws):
        return sparse_linear.column_parallel_grouped(
            ws, x, bs, outs=full, tp=tp, backend=backend)
    q = sparse_linear.column_parallel(ws[0], x, bs[0], out=full[0], tp=tp,
                                      backend=backend)
    if sparse_linear.groupable(ws[1:]):
        k, v = sparse_linear.column_parallel_grouped(
            ws[1:], x, bs[1:], outs=full[1:], tp=tp, backend=backend)
    else:
        k, v = (sparse_linear.column_parallel(w, x, b, out=o, tp=tp,
                                              backend=backend)
                for w, b, o in zip(ws[1:], bs[1:], full[1:]))
    if tp.kv_heads < tp.size:               # ranks share each KV head
        head = tp.rank // (tp.size // tp.kv_heads)
        k, v = (_whole_kv(t, tp)[..., head * hd:(head + 1) * hd]
                for t in (k, v))
    return q, k, v


def _whole_kv(share: torch.Tensor, tp) -> torch.Tensor:
    """The whole k or v from every rank's column share."""
    n = share.shape[-1]
    lo = tp.rank * n
    full = torch.nn.functional.pad(share.to(torch.float32),
                                   (lo, n * tp.size - lo - n))
    return tensor_parallel.gather_from(full, tp).to(share.dtype)


def _out_proj(params, o, cfg: ModelConfig, backend: str, tp=None):
    """wo: row-parallel over the rank's heads with ``tp``."""
    if tp is not None:
        return sparse_linear.row_parallel(params["wo"]["w"], o,
                                          params["wo"].get("b"),
                                          out=cfg.d_model, tp=tp,
                                          backend=backend)
    return sparse_linear.linear(params["wo"]["w"], o,
                                declared_out=cfg.d_model, backend=backend)


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


def _rope_q_k(q, k, positions, cfg: ModelConfig):
    """RoPE at ``positions [B, S]``, or M-RoPE at ``[3, B, S]`` (t, h, w
    ids) where the config has ``mrope_sections``."""
    if cfg.mrope_sections is not None:
        return (rope.apply_mrope(q, positions, cfg.mrope_sections,
                                 cfg.rope_theta),
                rope.apply_mrope(k, positions, cfg.mrope_sections,
                                 cfg.rope_theta))
    return (rope.apply_rope(q, positions, cfg.rope_theta),
            rope.apply_rope(k, positions, cfg.rope_theta))


def attention(params: dict, x: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig, *, cache: Optional[dict] = None,
              backend: str = "auto", tp=None
              ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full-sequence (prefill) causal attention, within the last
    ``local_window`` positions where the config has one. ``positions``
    is [B, S], or [3, B, S] with M-RoPE, whose temporal row orders the
    causal mask. With ``cache``, the new K/V are written at positions
    [0, S) of it; a ring shorter than S takes the trailing window,
    position p at slot ``p % W``."""
    S = x.shape[1]
    q, k, v = _project_qkv(params, x, cfg, backend, tp)
    q, k = _rope_q_k(q, k, positions, cfg)
    k = k.to(torch.bfloat16)
    v = v.to(torch.bfloat16)
    if positions.dim() == 3:
        positions = positions[0]
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
        if cfg.local_window is not None:
            valid &= (qp[:, :, None] - positions[:, None, :]) \
                < cfg.local_window
        outs.append(_attend(q[:, lo:lo + chunk], k, v, valid))
    o = torch.cat(outs, dim=1).to(x.dtype)
    y = _out_proj(params, o, cfg, backend, tp)
    if cache is not None:
        W = cache["k"].shape[1]
        if cfg.local_window is not None and S > W:
            # The trailing W positions cover every residue once: a roll.
            slots = torch.arange(S - W, S, device=x.device) % W
            cache["k"][:, slots] = k[:, S - W:].to(cache["k"].dtype)
            cache["v"][:, slots] = v[:, S - W:].to(cache["v"].dtype)
        else:
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


def _masked_decode_attend(q, ck, cv, pos_vec, slot,
                          ring_len: Optional[int]) -> torch.Tensor:
    """Scores, validity mask and weighted sum for one-token decode over a
    [B, T, KV, D] key/value sequence (the dense cache, or a block-table
    gather, whose T is whole blocks): column t is valid iff t <= pos, and
    masked columns get exact softmax zeros. In a ring of ``ring_len``
    (the token at pos written at ``slot``), column t holds the newest
    position p <= pos with p % ring_len == t, valid iff p >= 0."""
    idx = torch.arange(ck.shape[1], device=q.device)[None, :]
    if ring_len is not None:
        age = torch.remainder(slot[:, None] - idx, ring_len)
        valid = (pos_vec[:, None] - age >= 0) & (idx < ring_len)
    else:
        valid = idx <= pos_vec[:, None]
    return _attend(q, ck, cv, valid[:, None, :])


def _decode_qkv(params, x, positions, cfg: ModelConfig, backend: str,
                tp=None):
    """Projections with RoPE at ``positions [B, S]``; with M-RoPE every
    axis takes the same position, as the reference's decode does."""
    q, k, v = _project_qkv(params, x, cfg, backend, tp)
    if cfg.mrope_sections is not None:
        positions = positions[None].expand(3, -1, -1)
    q, k = _rope_q_k(q, k, positions, cfg)
    return q, k, v


def attention_decode(params: dict, x: torch.Tensor, cache: dict, pos,
                     cfg: ModelConfig, *, backend: str = "auto", tp=None
                     ) -> Tuple[torch.Tensor, dict]:
    """Single-token decode against the dense cache. ``pos`` is the
    absolute position of every row (an int) or of each row (a [B]
    tensor: continuous batching decodes every slot at its own position).
    Writes K/V at ``pos`` and attends over positions [0, pos]; with a
    sliding window, writes at ``pos % W`` of the ring (W its length) and
    attends over the positions the ring still holds."""
    pos_vec = _pos_vector(pos, x.shape[0], x.device)
    q, k, v = _decode_qkv(params, x, pos_vec[:, None], cfg, backend, tp)
    ring_len = cache["k"].shape[1] if cfg.local_window is not None else None
    slot = pos_vec % ring_len if ring_len is not None else pos_vec
    write_decode_token(cache["k"], k, slot)
    write_decode_token(cache["v"], v, slot)
    o = _masked_decode_attend(q, cache["k"], cache["v"], pos_vec, slot,
                              ring_len)
    return _out_proj(params, o.to(x.dtype), cfg, backend, tp), cache


def attention_decode_paged(params: dict, x: torch.Tensor, cache: dict,
                           block_tables: torch.Tensor, pos,
                           cfg: ModelConfig, *,
                           ring_len: Optional[int] = None,
                           backend: str = "auto"
                           ) -> Tuple[torch.Tensor, dict]:
    """Single-token decode against a paged block pool. Cache leaves are
    ``[n_physical, block, kv, hd]``; ``block_tables`` is
    [B, blocks_per_seq] physical block ids (padding entries name the trash
    block and are masked); ``pos`` is per row. Each row's K/V is gathered
    through its table into [B, blocks_per_seq * block, ...], position
    order being gather order. A sliding-window config passes ``ring_len``
    = min(max_len, window): position p lives at ``p % ring_len``, as in
    the dense ring, so a request's blocks are overwritten cyclically."""
    B = x.shape[0]
    pos_vec = _pos_vector(pos, B, x.device)
    ring = cfg.local_window is not None
    if ring and ring_len is None:
        raise ValueError("sliding-window paged decode needs ring_len")
    q, k, v = _decode_qkv(params, x, pos_vec[:, None], cfg, backend)
    blk = cache["k"].shape[1]
    slot = pos_vec % ring_len if ring else pos_vec
    logical = torch.div(slot, blk, rounding_mode="floor")
    phys = torch.gather(block_tables, 1, logical[:, None])[:, 0]
    off = slot - logical * blk
    write_decode_token_paged(cache["k"], k, phys, off)
    write_decode_token_paged(cache["v"], v, phys, off)
    kv_heads, hd = cache["k"].shape[-2], cache["k"].shape[-1]
    kg = cache["k"][block_tables].reshape(B, -1, kv_heads, hd)
    vg = cache["v"][block_tables].reshape(B, -1, kv_heads, hd)
    # Each row reads back its own token at its slot, as from the dense
    # cache.
    # A live row's write is private to it, so this changes none of its
    # bits; the idle rows all write the trash block, where one idle row
    # would read another's token. An MoE layer's capacity makes the live
    # rows depend on the idle ones, so dense and paged steps must agree
    # on them.
    rows = torch.arange(B, device=x.device)
    kg[rows, slot] = k[:, 0].to(kg.dtype)
    vg[rows, slot] = v[:, 0].to(vg.dtype)
    o = _masked_decode_attend(q, kg, vg, pos_vec, slot,
                              ring_len if ring else None)
    y = sparse_linear.linear(params["wo"]["w"], o.to(x.dtype),
                             declared_out=cfg.d_model, backend=backend)
    return y, cache


def verify_window_mask(pos_vec: torch.Tensor, W: int, T_old: int,
                       ring_len: Optional[int] = None) -> torch.Tensor:
    """[B, W, T_old + W] validity mask of a verify window whose query i
    sits at absolute position ``pos_vec + i``. The first ``T_old`` columns
    are the old cache gathered through the block tables before any
    window write: valid strictly before the window (which also masks what
    a rejected earlier window left at positions >= pos). The last W are
    the window's own fresh keys: column j is valid for query i iff
    j <= i. Per query that is exactly the set plain decode at pos + i
    attends, so the masked softmax terms are exact zeros. In a ring of
    ``ring_len``, old column t holds the newest position p < pos with
    p % ring_len == t, valid iff p >= 0 and p lies within query i's own
    window (the scheduler keeps W <= ring_len, so no fresh column ages
    out inside the window)."""
    B, dev = pos_vec.shape[0], pos_vec.device
    idx = torch.arange(T_old, device=dev)[None, :]
    if ring_len is None:
        old = (idx < pos_vec[:, None])[:, None, :].expand(B, W, T_old)
    else:
        last = pos_vec[:, None] - 1                 # last position before
        abs_pos = last - torch.remainder(last - idx, ring_len)
        qpos = pos_vec[:, None] + torch.arange(W, device=dev)[None, :]
        old = (((abs_pos >= 0) & (idx < ring_len))[:, None, :]
               & (qpos[:, :, None] - abs_pos[:, None, :] < ring_len))
    j = torch.arange(W, device=dev)
    fresh = j[None, :] <= j[:, None]
    return torch.cat([old, fresh[None].expand(B, W, W)], dim=-1)


def attention_verify_paged(params: dict, x: torch.Tensor, cache: dict,
                           block_tables: torch.Tensor, pos,
                           cfg: ModelConfig, *,
                           ring_len: Optional[int] = None,
                           backend: str = "auto"
                           ) -> Tuple[torch.Tensor, dict]:
    """A window of W positions per row against a paged block pool, with
    the cache write left to the caller. ``x [B, W, d]``; ``pos`` is the
    absolute position of window column 0 of each row. The old K/V is
    gathered through the tables before anything is written, and the
    window's fresh K/V rides as W extra masked columns, rounded to the
    cache dtype as plain decode's write-then-gather rounds it. Returns
    (y [B, W, d], fresh {"k"/"v": [B, W, kv, hd]} in the cache dtype);
    the pool is left as it was (``transformer.commit_verify_window``
    writes the accepted columns). A sliding-window config needs
    ``ring_len``, as in ``attention_decode_paged``."""
    if cfg.local_window is not None and ring_len is None:
        raise ValueError("sliding-window paged verify needs ring_len")
    B, W = x.shape[0], x.shape[1]
    pos_vec = _pos_vector(pos, B, x.device)
    positions = pos_vec[:, None] + torch.arange(W, device=x.device)[None, :]
    q, k, v = _decode_qkv(params, x, positions, cfg, backend)
    cdt = cache["k"].dtype
    k, v = k.to(cdt), v.to(cdt)
    kv_heads, hd = cache["k"].shape[-2], cache["k"].shape[-1]
    kg = cache["k"][block_tables].reshape(B, -1, kv_heads, hd)
    vg = cache["v"][block_tables].reshape(B, -1, kv_heads, hd)
    valid = verify_window_mask(pos_vec, W, kg.shape[1], ring_len)
    o = _attend(q, torch.cat([kg, k], dim=1), torch.cat([vg, v], dim=1),
                valid)
    y = sparse_linear.linear(params["wo"]["w"], o.to(x.dtype),
                             declared_out=cfg.d_model, backend=backend)
    return y, {"k": k, "v": v}
