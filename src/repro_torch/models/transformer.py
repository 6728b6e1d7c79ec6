"""Model assembly for every family: init, cache and forward.

The port's counterpart of ``repro.models.transformer`` for ``family ==
"dense"``, ``"moe"``, ``"hybrid"``, ``"ssm"``, ``"vlm"`` and ``"audio"``:
a pre-norm decoder of residual blocks, its layers a Python list walked
in order (the reference's ``lax.scan`` stack, or its unrolled list for a
heterogeneous pattern).
Block kinds follow ``cfg.layer_kind(i)``. An ``"attn"`` block is
attention + MLP: GQA (``attention``, K/V cache leaves ``"k"``/``"v"``,
a sliding-window ring where the config has ``local_window``) or
Multi-head Latent Attention (``mla``, latent cache leaves
``"ckv"``/``"krope"``); an MoE model's MLP is routed experts (``moe``,
params ``p["moe"]``; GQA attention only), whose aux loss only the train
mode returns. An ``"rglru"`` block
(the hybrid family, recurrentgemma) is the RG-LRU recurrent block
(``rglru``, state leaves ``"h"``/``"conv"``, one row a slot) + SwiGLU
MLP. An ``"ssm"`` block (mamba2) is the Mamba2 SSD block (``ssm``, state
leaves ``"state"``/``"conv"``), with a SwiGLU MLP only where ``d_ff`` is
set. The vlm family (qwen2-vl) is the GQA block with M-RoPE: prefill
positions are [3, B, S] (t, h, w ids), and ``inputs["embeds"]`` may stand
in for the tokens (the stubbed vision frontend's patch embeddings). The
audio family (musicgen) reads ``n_codebooks`` parallel token streams
``[B, n_cb, S]``, sums their embeddings, and its untied head returns
``[B, S, n_cb, vocab]``. Four modes share the block code:

  train   — full sequence, no cache (:func:`forward_train`): params in
            f32, compute in ``cfg.dtype``, the blocks' MoE aux losses
            summed, ``cfg.remat`` honoured

  prefill — full sequence; writes the cache when one is given
  decode  — one token per row + cache (the paper's skinny-MatMul regime),
            each row at its own position, against the dense cache or a
            paged block pool
  verify  — a window of W positions per row against a paged block pool,
            the cache left unwritten (speculative verify and the mixed
            prefill-chunk/decode step); returns each layer's fresh K/V
            (or latents)

The serving cache helpers (``scatter_cache_slots``,
``scatter_cache_pages``, ``copy_cache_block``, ``commit_verify_window``)
write the cache they are given in place, where the reference returns a
new one. They walk every cache leaf, whatever the attention kind.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import dataclasses

import torch
import torch.utils.checkpoint as torch_checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import tensor_parallel
from repro_torch.models import attention, layers, mla, moe, nn, rglru, ssm
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]


def _check_family(cfg: ModelConfig) -> None:
    gqa = cfg.attn_kind == "gqa"
    plain = cfg.layer_pattern is None
    no_moe = not cfg.n_routed_experts
    dense = cfg.family == "dense" and cfg.attn_kind in ("gqa", "mla") \
        and no_moe and plain
    routed = cfg.family == "moe" and gqa and cfg.n_routed_experts > 0 \
        and plain and cfg.local_window is None
    hybrid = cfg.family == "hybrid" and gqa and no_moe \
        and not plain and set(cfg.layer_pattern) <= {"rglru", "attn"}
    ssm_ok = cfg.family == "ssm" and cfg.ssm_state > 0 and no_moe \
        and plain and cfg.local_window is None
    vlm = cfg.family == "vlm" and gqa and no_moe and plain \
        and cfg.mrope_sections is not None
    audio = cfg.family == "audio" and gqa and no_moe and plain \
        and cfg.n_codebooks > 0
    window = cfg.local_window is None or gqa
    if not (dense or routed or hybrid or ssm_ok or vlm or audio) \
            or not window or (cfg.n_codebooks and not audio) \
            or (cfg.mrope_sections is not None and not vlm):
        raise NotImplementedError(
            f"{cfg.name}: the port serves the dense family with GQA or MLA "
            "attention (a sliding window with GQA only), the MoE family "
            "with GQA attention, the hybrid family of RG-LRU and GQA "
            "blocks, the SSM family, the vlm family (GQA with M-RoPE) and "
            "the audio family (GQA over codebooks) only")


MESH_ITEM = "ROADMAP.md queue 1 item 14"


def check_tensor_parallel(cfg: ModelConfig, model: int) -> None:
    """Raise unless tensor parallelism over ``model`` ranks covers
    ``cfg``: the dense family with GQA attention (no sliding window),
    whose query heads and ``d_ff`` split ``model`` ways, and whose KV
    heads split ``model`` ways or are fewer and divide it (each shared
    by ``model / n_kv`` ranks)."""
    if model == 1:
        return
    dense = (cfg.family == "dense" and cfg.attn_kind == "gqa"
             and not cfg.n_routed_experts and cfg.layer_pattern is None
             and cfg.local_window is None and not cfg.n_codebooks
             and cfg.mrope_sections is None)
    if not dense:
        raise NotImplementedError(
            f"{cfg.name}: tensor parallelism covers the dense family with "
            f"GQA attention only; the {cfg.family} family "
            f"({cfg.attn_kind} attention) under a model axis of {model} "
            f"is {MESH_ITEM}")
    kv_ok = cfg.n_kv % model == 0 or model % cfg.n_kv == 0
    for what, n, ok in (("n_heads", cfg.n_heads, cfg.n_heads % model == 0),
                        ("n_kv", cfg.n_kv, kv_ok),
                        ("d_ff", cfg.d_ff, cfg.d_ff % model == 0)):
        if not ok:
            raise ValueError(
                f"{cfg.name}: {what} {n} does not split over a model axis "
                f"of {model} ({MESH_ITEM})")


def rank_config(cfg: ModelConfig, mesh) -> Tuple[ModelConfig, Any]:
    """(the config as one model rank sees it, its ``tensor_parallel.Axis``)
    under ``mesh``: the rank's query and KV heads (``n_heads / m``, and
    ``n_kv / m`` or the one KV head it shares where ``n_kv < m``; the
    head dim kept); ``d_ff`` stays whole (the MLPs take their shares
    themselves). Without a mesh, or with a ``model`` axis of 1, the
    config as it is and None. Raises where :func:`check_tensor_parallel`
    does."""
    tp = tensor_parallel.of(mesh)
    if tp is None:
        return cfg, None
    check_tensor_parallel(cfg, tp.size)
    tp = dataclasses.replace(tp, kv_heads=cfg.n_kv)
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp.size,
                               n_kv=max(cfg.n_kv // tp.size, 1),
                               d_head=cfg.head_dim), tp


def _init_norm(cfg: ModelConfig, device, dtype):
    return (layers.init_rmsnorm(cfg.d_model, device, dtype)
            if cfg.norm_kind == "rmsnorm"
            else layers.init_layernorm(cfg.d_model, device, dtype))


def _norm(cfg: ModelConfig, p, x):
    return (layers.rmsnorm(p, x) if cfg.norm_kind == "rmsnorm"
            else layers.layernorm(p, x))


def init_block(gen, cfg: ModelConfig, device, dtype=torch.float32, *,
               kind: str = "attn") -> Params:
    if kind == "ssm":
        p = {"pre_norm": _init_norm(cfg, device, dtype),
             "ssm": ssm.init_ssm(gen, cfg, device, dtype)}
        if cfg.d_ff:
            p["mlp_norm"] = _init_norm(cfg, device, dtype)
            p["mlp"] = layers.init_swiglu_mlp(gen, cfg.d_model, cfg.d_ff,
                                              device, dtype)
        return p
    if kind == "rglru":
        return {"pre_norm": _init_norm(cfg, device, dtype),
                "rglru": rglru.init_rglru(gen, cfg, device, dtype),
                "mlp_norm": _init_norm(cfg, device, dtype),
                "mlp": layers.init_swiglu_mlp(gen, cfg.d_model, cfg.d_ff,
                                              device, dtype)}
    p: Params = {"pre_norm": _init_norm(cfg, device, dtype),
                 "attn": (mla.init_mla(gen, cfg, device, dtype)
                          if cfg.attn_kind == "mla"
                          else attention.init_attention(gen, cfg, device,
                                                        dtype)),
                 "mlp_norm": _init_norm(cfg, device, dtype)}
    if cfg.n_routed_experts:
        p["moe"] = moe.init_moe(gen, cfg, device, dtype)
    elif cfg.mlp_kind == "swiglu":
        p["mlp"] = layers.init_swiglu_mlp(gen, cfg.d_model, cfg.d_ff, device,
                                          dtype)
    else:
        p["mlp"] = layers.init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, device,
                                        dtype, bias=cfg.mlp_bias)
    return p


def init_model_parts(cfg: ModelConfig, *, seed: int = 0,
                     device: DeviceLike = None, dtype=torch.float32
                     ) -> Iterator[Tuple[str, Params]]:
    """``init_model``'s draws, one part at a time and in its order:
    ``("embed", p)``, ``("layers", p)`` once per layer, ``("final_norm",
    p)``, then ``("lm_head", p)`` unless the head is tied. A part is drawn
    only when the caller asks for the next one, so a caller that shrinks
    each part first (the layer-by-layer sparse build) holds one part at
    full precision at a time."""
    _check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if cfg.n_codebooks:                 # one table a codebook, [n_cb, V, d]
        yield "embed", {"table": torch.stack([
            nn.embed_init(gen, cfg.vocab, cfg.d_model, dev, dtype)
            for _ in range(cfg.n_codebooks)])}
    else:
        yield "embed", layers.init_embed(gen, cfg.vocab, cfg.d_model, dev,
                                         dtype)
    for i in range(cfg.n_layers):
        yield "layers", init_block(gen, cfg, dev, dtype,
                                   kind=cfg.layer_kind(i))
    yield "final_norm", _init_norm(cfg, dev, dtype)
    if not cfg.tie_embeddings:
        yield "lm_head", {"w": nn.dense_init(
            gen, cfg.vocab * max(cfg.n_codebooks, 1), cfg.d_model, dev,
            dtype)}


def init_model(cfg: ModelConfig, *, seed: int = 0, device: DeviceLike = None,
               dtype=torch.float32) -> Params:
    """Random params from ``seed`` on ``device`` (default ``"cuda"``)."""
    params: Params = {}
    for name, part in init_model_parts(cfg, seed=seed, device=device,
                                       dtype=dtype):
        if name == "layers":
            params.setdefault("layers", []).append(part)
        else:
            params[name] = part
    params.setdefault("layers", [])
    return params


def uses_scan(cfg: ModelConfig) -> bool:
    """The reference's rule for a scan-stacked layer stack: a homogeneous
    pattern with ``scan_layers``. The port's stack is always a list; the
    rule decides only whether a sparse build pads each Tiled-CSL leaf to
    the largest ``max_nnz`` of its place in the stack (the reference's
    stacked ``[L, ...]`` leaves share one) or leaves it its own."""
    return cfg.scan_layers and cfg.uniform_layers


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: DeviceLike = None,
               dtype=torch.bfloat16, mesh=None) -> List[dict]:
    """Per-layer caches: K/V ``[batch, max_len, n_kv, head_dim]`` (a
    sliding window caps the length at the window), MLA latents
    ``[batch, max_len, kv_lora_rank / qk_rope_dim]`` (both in ``dtype``),
    an RG-LRU layer's f32 state ``h [batch, rnn]`` and ``conv [batch,
    conv - 1, rnn]``, or an SSM layer's f32 ``state [batch, heads,
    head_dim, n]`` and ``conv [batch, conv - 1, d_inner + 2 n]``. Under
    ``mesh`` a rank's K/V hold its KV heads."""
    _check_family(cfg)
    cfg, _ = rank_config(cfg, mesh)
    dev = resolve_device(device)
    attn = (mla.init_mla_cache if cfg.attn_kind == "mla"
            else attention.init_cache)

    def layer(kind):
        if kind == "rglru":
            return rglru.init_rglru_cache(cfg, batch, dev)
        if kind == "ssm":
            return ssm.init_ssm_cache(cfg, batch, dev)
        return attn(cfg, batch, max_len, dev, dtype)
    return [layer(cfg.layer_kind(i)) for i in range(cfg.n_layers)]


def init_paged_cache(cfg: ModelConfig, n_physical: int, block: int, *,
                     device: DeviceLike = None,
                     dtype=torch.bfloat16) -> List[dict]:
    """Block-pool serving cache: per-layer leaves ``[n_physical, block,
    n_kv, head_dim]`` (MLA: ``[n_physical, block, kv_lora_rank /
    qk_rope_dim]``). ``n_physical`` includes the reserved trash block 0
    (``serving.paged_cache.BlockPool.physical_blocks``). Paging applies
    to position-indexed caches only: recurrent state has no per-token
    axis to page, so a stack with RG-LRU or SSM layers keeps the dense
    cache."""
    _check_family(cfg)
    kinds = {cfg.layer_kind(i) for i in range(cfg.n_layers)}
    if kinds != {"attn"}:
        raise ValueError(
            f"paged KV cache requires a pure-attention stack, got {kinds}")
    dev = resolve_device(device)
    init = (mla.init_paged_mla_cache if cfg.attn_kind == "mla"
            else attention.init_paged_cache)
    return [init(cfg, n_physical, block, dev, dtype)
            for _ in range(cfg.n_layers)]


def paged_blocks_per_seq(cfg: ModelConfig, max_len: int, block: int) -> int:
    """Static per-request block-table width: the blocks ``max_len``
    positions need (a sliding window caps them: the ring reuses its
    blocks cyclically)."""
    positions = max_len
    if cfg.local_window is not None:
        positions = min(max_len, cfg.local_window)
    return -(-positions // block)


def _leaves(cache: List[dict]):
    return [layer[name] for layer in cache for name in sorted(layer)]


def state_leaves(cfg: ModelConfig, cache: List[dict]) -> List[torch.Tensor]:
    """The recurrent-state leaves of a dense cache (an RG-LRU layer's
    ``h`` and ``conv``, an SSM layer's ``state`` and ``conv``): what a
    decode step overwrites as a function of itself, where it writes K/V
    at a position."""
    return [t for i, layer in enumerate(cache)
            if cfg.layer_kind(i) in ("rglru", "ssm") for t in layer.values()]


def scatter_cache_slots(cfg: ModelConfig, full: List[dict],
                        part: List[dict], slots: torch.Tensor) -> List[dict]:
    """Write a ``k``-request scratch cache (``init_cache(cfg, k, S)``)
    into rows ``slots [k]`` of the serving cache, in place: K/V and latent
    leaves at positions [0, S) (a ring's scratch holds min(S, window)
    positions, already at their residues), recurrent-state leaves (no
    position axis) over the whole row. Duplicate slots are allowed iff
    their rows carry identical data (admission pads its group to a static
    size this way)."""
    for f, p in zip(_leaves(full), _leaves(part)):
        f[slots, :p.shape[1]] = p.to(f.dtype)
    return full


def scatter_cache_pages(cfg: ModelConfig, full: List[dict],
                        part: List[dict],
                        flat_blocks: torch.Tensor) -> List[dict]:
    """Write a ``k``-request scratch cache into pool blocks of the paged
    serving cache, in place: each [k, S, ...] leaf is padded to whole
    blocks, cut into [k * nblk, block, ...] and stored at physical rows
    ``flat_blocks [k * nblk]``. Entries may repeat only where the written
    data is identical (admission group padding, recomputed shared-prefix
    content) or where they name the trash block (bucket padding past a
    prompt's own blocks), whose contents are never read unmasked. A ring's
    scratch is min(S, ring_len) long with each position at its residue,
    the layout of the ring's blocks, so it scatters the same way."""
    for f, p in zip(_leaves(full), _leaves(part)):
        block = f.shape[1]
        k, S = p.shape[0], p.shape[1]
        nblk = -(-S // block)
        if nblk * block != S:
            p = torch.nn.functional.pad(
                p, (0, 0) * (p.dim() - 2) + (0, nblk * block - S))
        if flat_blocks.shape[0] != k * nblk:
            raise ValueError(
                f"block map covers {flat_blocks.shape[0]} chunks, scratch "
                f"leaf has {k}x{nblk}")
        f[flat_blocks] = p.reshape((k * nblk, block) + tuple(p.shape[2:])
                                   ).to(f.dtype)
    return full


def commit_verify_window(cfg: ModelConfig, cache: List[dict],
                         fresh: List[dict], block_tables: torch.Tensor,
                         pos_vec: torch.Tensor, commit: torch.Tensor,
                         ring_len: Optional[int] = None) -> List[dict]:
    """Write a verify window's fresh K/V or latents
    (``forward(mode="verify")``'s per-layer ``[B, W, ...]`` leaves) into
    the paged pools in place, committing only where ``commit [B, W]`` is
    True; the block size is read off the first leaf. Window column j of
    row b lands at cache position ``pos_vec[b] + j``; an uncommitted
    column, or one past the table, is written to the trash block
    (physical block 0, ``serving.paged_cache.TRASH_BLOCK``), so a rejected
    draft never touches a real block and rollback is the write that never
    happened, which keeps a ring exact (a rejected entry must not clobber
    the older position of its residue). With ``ring_len``, column j lands
    at ring residue ``(pos_vec[b] + j) % ring_len``. ``index_put_`` keeps
    the write capturable in a graph."""
    blk = _leaves(cache)[0].shape[cache_slot_axis(cfg) + 1]
    W = commit.shape[1]
    slot = pos_vec[:, None] + torch.arange(W, device=pos_vec.device)[None]
    if ring_len is not None:
        slot = slot % ring_len
    logical = torch.div(slot, blk, rounding_mode="floor")
    nblk = block_tables.shape[1]
    ok = commit & (logical < nblk)          # beyond-table windows -> trash
    phys = torch.gather(block_tables, 1, logical.clamp(max=nblk - 1))
    phys = torch.where(ok, phys, torch.zeros_like(phys))  # TRASH_BLOCK
    off = slot - logical * blk
    for f, p in zip(_leaves(cache), _leaves(fresh)):
        f.index_put_((phys, off), p.to(f.dtype))
    return cache


def cache_slot_axis(cfg: ModelConfig) -> int:
    """Axis of the batch (decode-slot) dim in every cache leaf: 0, since
    the port's layers are an unrolled list of [B, ...] leaves."""
    return 0


def copy_cache_block(cfg: ModelConfig, cache: List[dict], src: int,
                     dst: int) -> List[dict]:
    """Copy one physical pool block in every cache leaf (copy-on-write),
    in place."""
    for f in _leaves(cache):
        f[dst].copy_(f[src])
    return cache


def _mlp_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, backend: str,
               tp=None):
    if cfg.mlp_kind == "swiglu":
        return layers.swiglu_mlp(p, x, d_ff=cfg.d_ff, d_model=cfg.d_model,
                                 backend=backend, tp=tp)
    return layers.gelu_mlp(p, x, d_ff=cfg.d_ff, d_model=cfg.d_model,
                           backend=backend, tp=tp)


def block_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
                kind: str = "attn", positions=None, cache=None, pos=None,
                block_tables=None, ring_len: Optional[int] = None,
                backend: str = "auto", tp=None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Residual block of ``kind``: attention + MLP (or routed experts),
    RG-LRU + MLP, or SSD (+ MLP where ``d_ff`` is set). Returns (x,
    cache), or in verify mode (x, the window's fresh {"k", "v"} or
    {"ckv", "krope"}). ``ring_len`` is a sliding-window config's ring on
    the paged cache. With ``tp`` (``cfg`` the rank's, from
    :func:`rank_config`) the attention and the MLP are split over the
    model ranks (prefill, dense decode and train)."""
    x, cache, _ = _block(p, x, cfg, mode=mode, kind=kind,
                         positions=positions, cache=cache, pos=pos,
                         block_tables=block_tables, ring_len=ring_len,
                         backend=backend, tp=tp)
    return x, cache


def _block(p: Params, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
           kind: str, positions, cache, pos, block_tables,
           ring_len: Optional[int], backend: str, tp=None):
    """:func:`block_apply`, also returning the block's aux loss (the MoE
    load-balancing term; 0 for every other block)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = _norm(cfg, p["pre_norm"], x)
    if kind == "ssm":                   # dense cache only: no verify mode
        if mode == "decode":
            s, cache = ssm.ssm_decode(p["ssm"], h, cache, cfg,
                                      backend=backend)
        else:
            s, cache = ssm.ssm_block(p["ssm"], h, cfg, cache=cache,
                                     backend=backend)
        x = x + s
        if cfg.d_ff:
            x = x + _mlp_apply(p["mlp"], _norm(cfg, p["mlp_norm"], x), cfg,
                               backend)
        return x, cache, aux
    if kind == "rglru":                 # dense cache only: no verify mode
        if mode == "decode":
            r, cache = rglru.rglru_decode(p["rglru"], h, cache, cfg,
                                          backend=backend)
        else:
            r, cache = rglru.rglru_block(p["rglru"], h, cfg, cache=cache,
                                         backend=backend)
        x = x + r
        return x + _mlp_apply(p["mlp"], _norm(cfg, p["mlp_norm"], x), cfg,
                              backend), cache, aux
    if cfg.attn_kind == "mla":
        if mode == "verify":
            a, cache = mla.mla_verify_paged(p["attn"], h, cache, block_tables,
                                            pos, cfg, backend=backend)
        elif mode == "decode" and block_tables is not None:
            a, cache = mla.mla_decode_paged(p["attn"], h, cache, block_tables,
                                            pos, cfg, backend=backend)
        elif mode == "decode":
            a, cache = mla.mla_decode(p["attn"], h, cache, pos, cfg,
                                      backend=backend)
        else:
            a, cache = mla.mla_attention(p["attn"], h, positions, cfg,
                                         cache=cache, backend=backend)
    elif mode == "verify":
        a, cache = attention.attention_verify_paged(
            p["attn"], h, cache, block_tables, pos, cfg, ring_len=ring_len,
            backend=backend)
    elif mode == "decode" and block_tables is not None:
        a, cache = attention.attention_decode_paged(
            p["attn"], h, cache, block_tables, pos, cfg, ring_len=ring_len,
            backend=backend)
    elif mode == "decode":
        a, cache = attention.attention_decode(p["attn"], h, cache, pos, cfg,
                                              backend=backend, tp=tp)
    else:
        a, cache = attention.attention(p["attn"], h, positions, cfg,
                                       cache=cache, backend=backend, tp=tp)
    x = x + a
    h = _norm(cfg, p["mlp_norm"], x)
    if cfg.n_routed_experts:
        m, aux = moe.moe_block(p["moe"], h, cfg, backend=backend)
    else:
        m = _mlp_apply(p["mlp"], h, cfg, backend, tp)
    return x + m, cache, aux


def _embed_tokens(params: Params, inputs: Dict[str, torch.Tensor],
                  cfg: ModelConfig, compute_dtype, tp=None) -> torch.Tensor:
    """``inputs["embeds"] [B, S, d]`` where given, else the tokens'
    embeddings; codebook tokens ``[B, n_cb, S]`` sum one lookup a
    codebook, in codebook order."""
    if inputs.get("embeds") is not None:
        return inputs["embeds"].to(compute_dtype)
    tokens = inputs["tokens"]
    if cfg.n_codebooks:
        tab = params["embed"]["table"].to(compute_dtype)       # [ncb, V, d]
        x = tab[0][tokens[:, 0]]
        for i in range(1, cfg.n_codebooks):
            x = x + tab[i][tokens[:, i]]
        return x
    return layers.embed(params["embed"], tokens, compute_dtype, tp=tp,
                        vocab=cfg.vocab)


def forward(params: Params, inputs: Dict[str, torch.Tensor],
            cfg: ModelConfig, *, mode: str, cache: Any = None,
            pos: Union[int, torch.Tensor, None] = None,
            block_tables: Optional[torch.Tensor] = None,
            ring_len: Optional[int] = None,
            backend: str = "auto", mesh=None) -> Tuple[torch.Tensor, Any]:
    """Run the stack. Returns (logits [B, S, vocab], or [B, S, n_cb,
    vocab] for an untied codebook head, and the cache).

    inputs: {"tokens": [B, S] (or [B, n_cb, S])} or {"embeds": [B, S, d]},
    optional "positions": [B, S] ([3, B, S] for M-RoPE; prefill's default
    is arange(S) on every row, on all three axes with M-RoPE).
    decode: S == 1 and ``pos`` is the absolute position of every row (an
    int) or of each row (a [B] tensor).
    paged decode: ``cache`` is a block pool (``init_paged_cache``) and
    ``block_tables [B, blocks_per_seq]`` maps each row's logical blocks to
    physical ones; one table per request serves every layer.
    verify: S == W window positions per row against the paged pool,
    ``pos`` [B] each window's first position. The second result is not
    the cache but each layer's fresh window K/V; the caller commits what
    it accepts with ``commit_verify_window``. For MLA (``attn_kind ==
    "mla"``) decode and verify run the absorbed form over the latents.
    ``ring_len`` (paged decode and verify of a sliding-window config) is
    the ring's length, min(max_len, window); the dense ring reads it off
    the cache.
    ``mesh`` (``launch.mesh``): ``params`` are this rank's shard
    (``distributed.sharding.shard_params``) and the cache its KV heads
    (``init_cache(..., mesh=mesh)``); the stack runs tensor-parallel
    over the ``model`` axis (prefill and dense decode) and every rank
    returns the whole logits.
    """
    _check_family(cfg)
    if mode not in ("prefill", "decode", "verify"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode != "prefill" and (cache is None or pos is None):
        raise ValueError(f"{mode} needs a cache and pos")
    if mode == "verify" and block_tables is None:
        raise ValueError("verify needs block_tables (the paged cache)")
    cfg, tp = rank_config(cfg, mesh)
    if tp is not None and block_tables is not None:
        raise NotImplementedError(
            f"the paged cache and the verify window under a mesh are "
            f"{MESH_ITEM}")
    compute_dtype = getattr(torch, cfg.dtype)
    x = _embed_tokens(params, inputs, cfg, compute_dtype, tp)
    B, S = x.shape[0], x.shape[1]
    positions = inputs.get("positions")
    if positions is None and mode == "prefill":
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        if cfg.mrope_sections is not None:
            positions = positions[None].expand(3, B, S)
    fresh = []
    for i, p in enumerate(params["layers"]):
        cache_l = cache[i] if cache is not None else None
        x, out_l = block_apply(p, x, cfg, mode=mode, kind=cfg.layer_kind(i),
                               positions=positions, cache=cache_l, pos=pos,
                               block_tables=block_tables, ring_len=ring_len,
                               backend=backend, tp=tp)
        fresh.append(out_l)
    logits = _head(params, x, cfg, backend, tp)
    return logits, (fresh if mode == "verify" else cache)


def _head(params: Params, x: torch.Tensor, cfg: ModelConfig,
          backend: str, tp=None) -> torch.Tensor:
    """Final norm and logits: [B, S, vocab], or [B, S, n_cb, vocab] for an
    untied codebook head."""
    x = _norm(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:             # a codebook model ties to table 0
        table = params["embed"]["table"]
        return layers.logits_head(
            None, {"table": table[0] if cfg.n_codebooks else table}, x,
            vocab=cfg.vocab, backend=backend, tp=tp)
    logits = layers.logits_head(params["lm_head"], None, x,
                                vocab=cfg.vocab * max(cfg.n_codebooks, 1),
                                backend=backend, tp=tp)
    if cfg.n_codebooks:
        logits = logits.reshape(*logits.shape[:-1], cfg.n_codebooks,
                                cfg.vocab)
    return logits


# Matmuls without a batch dimension (``aten.mm``/``addmm``; a linear on a
# [B, S, d] activation folds into one): what the reference's "dots"
# policy (``dots_with_no_batch_dims_saveable``) keeps; attention's
# batched products and everything else are recomputed.
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    cp = torch_checkpoint.CheckpointPolicy
    return cp.MUST_SAVE if op in _SAVED_DOTS else cp.PREFER_RECOMPUTE


def _dots_context():
    return torch_checkpoint.create_selective_checkpoint_contexts(
        _dots_policy)


def forward_train(params: Params, inputs: Dict[str, torch.Tensor],
                  cfg: ModelConfig, *, backend: str = "auto", mesh=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The train mode of the reference's ``forward``: the full sequence
    with no cache, compute in ``cfg.dtype`` from the params as given (f32
    in training). Returns (logits, aux): the logits as :func:`forward`
    gives them and the sum of the blocks' aux losses (f32, 0 without
    MoE). ``cfg.remat`` recomputes each block in the backward pass:
    ``"full"`` keeps only its input, ``"dots"`` also its matmul outputs
    (the reference's ``jax.checkpoint`` policies). ``mesh`` as in
    :func:`forward`: a rank's shard, tensor-parallel over ``model``."""
    _check_family(cfg)
    cfg, tp = rank_config(cfg, mesh)
    compute_dtype = getattr(torch, cfg.dtype)
    x = _embed_tokens(params, inputs, cfg, compute_dtype, tp)
    B, S = x.shape[0], x.shape[1]
    positions = inputs.get("positions")
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        if cfg.mrope_sections is not None:
            positions = positions[None].expand(3, B, S)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, p in enumerate(params["layers"]):
        def block(x, p=p, kind=cfg.layer_kind(i)):
            x, _, aux = _block(p, x, cfg, mode="train", kind=kind,
                               positions=positions, cache=None, pos=None,
                               block_tables=None, ring_len=None,
                               backend=backend, tp=tp)
            return x, aux
        if cfg.remat == "none":
            x, aux = block(x)
        else:
            extra = ({} if cfg.remat == "full"
                     else dict(context_fn=_dots_context))
            x, aux = torch_checkpoint.checkpoint(block, x,
                                                 use_reentrant=False, **extra)
        aux_total = aux_total + aux
    return _head(params, x, cfg, backend, tp), aux_total
