"""Model assembly for the dense family: init, cache and forward.

The port's counterpart of ``repro.models.transformer`` for ``family ==
"dense"``: a pre-norm decoder of attention + MLP blocks, its layers a
Python list walked in order (the reference's ``lax.scan`` stack). Two
modes share the block code:

  prefill — full sequence; writes the cache when one is given
  decode  — one token per row + cache (the paper's skinny-MatMul regime),
            each row at its own position, against the dense cache or a
            paged block pool

The serving cache helpers (``scatter_cache_slots``,
``scatter_cache_pages``, ``copy_cache_block``) write the cache they are
given in place, where the reference returns a new one.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention, layers, nn
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.attn_kind != "gqa" or cfg.n_codebooks \
            or cfg.n_routed_experts or cfg.layer_pattern is not None \
            or cfg.local_window is not None or cfg.mrope_sections is not None:
        raise NotImplementedError(
            f"{cfg.name}: the port serves the dense GQA family only")


def _init_norm(cfg: ModelConfig, device, dtype):
    return (layers.init_rmsnorm(cfg.d_model, device, dtype)
            if cfg.norm_kind == "rmsnorm"
            else layers.init_layernorm(cfg.d_model, device, dtype))


def _norm(cfg: ModelConfig, p, x):
    return (layers.rmsnorm(p, x) if cfg.norm_kind == "rmsnorm"
            else layers.layernorm(p, x))


def init_block(gen, cfg: ModelConfig, device, dtype=torch.float32) -> Params:
    p: Params = {"pre_norm": _init_norm(cfg, device, dtype),
                 "attn": attention.init_attention(gen, cfg, device, dtype),
                 "mlp_norm": _init_norm(cfg, device, dtype)}
    if cfg.mlp_kind == "swiglu":
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
    yield "embed", layers.init_embed(gen, cfg.vocab, cfg.d_model, dev, dtype)
    for _ in range(cfg.n_layers):
        yield "layers", init_block(gen, cfg, dev, dtype)
    yield "final_norm", _init_norm(cfg, dev, dtype)
    if not cfg.tie_embeddings:
        yield "lm_head", {"w": nn.dense_init(gen, cfg.vocab, cfg.d_model,
                                             dev, dtype)}


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


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: DeviceLike = None,
               dtype=torch.bfloat16) -> List[dict]:
    """Per-layer K/V caches ``[batch, max_len, n_kv, head_dim]``."""
    _check_family(cfg)
    dev = resolve_device(device)
    return [attention.init_cache(cfg, batch, max_len, dev, dtype)
            for _ in range(cfg.n_layers)]


def init_paged_cache(cfg: ModelConfig, n_physical: int, block: int, *,
                     device: DeviceLike = None,
                     dtype=torch.bfloat16) -> List[dict]:
    """Block-pool serving cache: per-layer leaves ``[n_physical, block,
    n_kv, head_dim]``. ``n_physical`` includes the reserved trash block 0
    (``serving.paged_cache.BlockPool.physical_blocks``)."""
    _check_family(cfg)
    dev = resolve_device(device)
    return [attention.init_paged_cache(cfg, n_physical, block, dev, dtype)
            for _ in range(cfg.n_layers)]


def paged_blocks_per_seq(cfg: ModelConfig, max_len: int, block: int) -> int:
    """Static per-request block-table width: the blocks ``max_len``
    positions need."""
    return -(-max_len // block)


def _leaves(cache: List[dict]):
    return [layer[name] for layer in cache for name in sorted(layer)]


def scatter_cache_slots(cfg: ModelConfig, full: List[dict],
                        part: List[dict], slots: torch.Tensor) -> List[dict]:
    """Write a ``k``-request scratch cache (``init_cache(cfg, k, S)``)
    into rows ``slots [k]`` of the serving cache, positions [0, S), in
    place. Duplicate slots are allowed iff their rows carry identical
    data (admission pads its group to a static size this way)."""
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
    prompt's own blocks), whose contents are never read unmasked."""
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


def copy_cache_block(cfg: ModelConfig, cache: List[dict], src: int,
                     dst: int) -> List[dict]:
    """Copy one physical pool block in every cache leaf (copy-on-write),
    in place."""
    for f in _leaves(cache):
        f[dst].copy_(f[src])
    return cache


def _mlp_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, backend: str):
    if cfg.mlp_kind == "swiglu":
        return layers.swiglu_mlp(p, x, d_ff=cfg.d_ff, d_model=cfg.d_model,
                                 backend=backend)
    return layers.gelu_mlp(p, x, d_ff=cfg.d_ff, d_model=cfg.d_model,
                           backend=backend)


def block_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
                positions=None, cache=None, pos=None, block_tables=None,
                backend: str = "auto") -> Tuple[torch.Tensor, Optional[dict]]:
    """Residual attention + MLP block. Returns (x, cache)."""
    h = _norm(cfg, p["pre_norm"], x)
    if mode == "decode" and block_tables is not None:
        a, cache = attention.attention_decode_paged(
            p["attn"], h, cache, block_tables, pos, cfg, backend=backend)
    elif mode == "decode":
        a, cache = attention.attention_decode(p["attn"], h, cache, pos, cfg,
                                              backend=backend)
    else:
        a, cache = attention.attention(p["attn"], h, positions, cfg,
                                       cache=cache, backend=backend)
    x = x + a
    x = x + _mlp_apply(p["mlp"], _norm(cfg, p["mlp_norm"], x), cfg, backend)
    return x, cache


def forward(params: Params, inputs: Dict[str, torch.Tensor],
            cfg: ModelConfig, *, mode: str, cache: Any = None,
            pos: Union[int, torch.Tensor, None] = None,
            block_tables: Optional[torch.Tensor] = None,
            backend: str = "auto") -> Tuple[torch.Tensor, Any]:
    """Run the stack. Returns (logits [B, S, vocab], cache).

    inputs: {"tokens": [B, S]} (optional "positions": [B, S]).
    decode: S == 1 and ``pos`` is the absolute position of every row (an
    int) or of each row (a [B] tensor).
    paged decode: ``cache`` is a block pool (``init_paged_cache``) and
    ``block_tables [B, blocks_per_seq]`` maps each row's logical blocks to
    physical ones; one table per request serves every layer.
    """
    _check_family(cfg)
    if mode not in ("prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "decode" and (cache is None or pos is None):
        raise ValueError("decode needs a cache and pos")
    compute_dtype = getattr(torch, cfg.dtype)
    tokens = inputs["tokens"]
    x = layers.embed(params["embed"], tokens, compute_dtype)
    B, S = tokens.shape
    positions = inputs.get("positions")
    if positions is None and mode != "decode":
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    for i, p in enumerate(params["layers"]):
        cache_l = cache[i] if cache is not None else None
        x, cache_l = block_apply(p, x, cfg, mode=mode, positions=positions,
                                 cache=cache_l, pos=pos,
                                 block_tables=block_tables, backend=backend)
    x = _norm(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = layers.logits_head(None, params["embed"], x, vocab=cfg.vocab,
                                    backend=backend)
    else:
        logits = layers.logits_head(params["lm_head"], None, x,
                                    vocab=cfg.vocab, backend=backend)
    return logits, cache
