"""Inference engine: prefill, decode step, sampling, generation loop.

The port's counterpart of ``repro.serving.engine`` (``prefill``,
``length_buckets``/``bucket_for``, ``prefill_into_slots``,
``prefill_into_pages``, ``serve_step``, ``verify_step``,
``prefill_chunk_into_pages``, ``sample_per_slot``, ``generate``). The
same engine runs dense weights (``torch.matmul``) or Tiled-CSL weights
(the LSCD kernels): the dispatch happens per weight inside
``sparse_linear.linear``. Everything runs on the device of the params;
the KV cache lives there too and is updated in place.

Sampling: greedy decoding is exact and token-identical to the reference.
Temperature sampling (``sample_per_slot``) is Gumbel-max over noise
hashed from (seed, request uid, token index, vocab id), so a slot's draw
is a pure function of those, like the reference's keys folded by (uid,
token index), and a preempted request's re-prefill redraws the same
token; the hash is not the reference's threefry, so sampled streams are
compared within the port only. It is plain tensor arithmetic, so a
captured decode step can sample too. ``generate`` draws row b as uid b.
A codebook model (musicgen) samples ``[B, n_cb, vocab]`` logits, each
codebook with noise of its own (the codebook index is folded in), as
the reference draws each codebook independently.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.device import device_of
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, max_len: int, *,
            embeds: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            backend: str = "auto", mesh=None) -> Tuple[torch.Tensor, Any]:
    """Process the prompt; returns (last-token logits, filled cache).
    ``embeds [B, S, d]`` stand in for the tokens' embeddings (a stubbed
    modality frontend's output); ``positions`` are explicit prefill
    positions ([3, B, S] t/h/w ids for M-RoPE). ``tokens`` still sets
    the batch and the device. With ``mesh`` (``launch.mesh``), ``params``
    are this rank's shard, the cache holds its KV heads, and every rank
    returns the whole logits."""
    cache = transformer.init_cache(cfg, tokens.shape[0], max_len,
                                   device=tokens.device, mesh=mesh)
    inputs: Dict[str, Any] = {"tokens": tokens}
    if embeds is not None:
        inputs["embeds"] = embeds
    if positions is not None:
        inputs["positions"] = positions
    logits, cache = transformer.forward(params, inputs, cfg, mode="prefill",
                                        cache=cache, backend=backend,
                                        mesh=mesh)
    return logits[:, -1], cache


def length_buckets(max_len: int, min_bucket: int = 8) -> Tuple[int, ...]:
    """Static prompt-length buckets: powers of two from ``min_bucket`` up
    to ``max_len``. Admission pads each prompt to its bucket, so prefill
    runs at most ``ceil(log2(max_len))`` shapes."""
    if max_len < 1:
        raise ValueError(f"max_len must be >= 1, got {max_len}")
    buckets = []
    b = min(min_bucket, max_len)
    while b < max_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_len)
    return tuple(buckets)


def bucket_for(length: int, buckets: Tuple[int, ...]) -> int:
    """Smallest bucket that fits ``length``."""
    for b in buckets:
        if length <= b:
            return b
    raise ValueError(f"prompt length {length} exceeds largest bucket "
                     f"{buckets[-1]}")


def _prefill_scratch(params, tokens: torch.Tensor, lengths: torch.Tensor,
                     cfg: ModelConfig, backend: str):
    """Prefill ``k`` right-padded prompts into a [k, S] scratch cache;
    returns (logits at each prompt's last real token [k, vocab],
    scratch)."""
    k, S = tokens.shape
    scratch = transformer.init_cache(cfg, k, S, device=tokens.device)
    logits, scratch = transformer.forward(params, {"tokens": tokens}, cfg,
                                          mode="prefill", cache=scratch,
                                          backend=backend)
    rows = torch.arange(k, device=tokens.device)
    return logits[rows, lengths.to(torch.int64) - 1], scratch


def prefill_into_slots(params, cache, tokens: torch.Tensor,
                       slots: torch.Tensor, lengths: torch.Tensor,
                       cfg: ModelConfig, *, backend: str = "auto"
                       ) -> Tuple[torch.Tensor, Any]:
    """Bucketed in-slot prefill: ``k`` right-padded prompts
    (``tokens [k, S]``, true ``lengths [k]``) go through a [k, S] scratch
    cache whose K/V is then written into rows ``slots [k]`` of the shared
    [n_slots, max_len] cache, in place. Duplicate slots are allowed for
    identical rows (admission pads its group to a static k that way).
    Returns (logits at each prompt's last real token [k, vocab], cache).

    Right-padding is exact for attention stacks: the causal mask keeps
    real positions from attending pad positions, and the pad K/V written
    at [length, S) is overwritten by decode at position p before the mask
    ``t <= p`` first exposes it."""
    last, scratch = _prefill_scratch(params, tokens, lengths, cfg, backend)
    transformer.scatter_cache_slots(cfg, cache, scratch, slots)
    return last, cache


def prefill_into_pages(params, cache, tokens: torch.Tensor,
                       block_map: torch.Tensor, lengths: torch.Tensor,
                       cfg: ModelConfig, *, backend: str = "auto"
                       ) -> Tuple[torch.Tensor, Any]:
    """Bucketed prefill into a paged block pool, the paged twin of
    ``prefill_into_slots``: ``block_map [k, nblk]`` names the physical
    block receiving each S-position chunk of each prompt's scratch K/V
    (chunks past a prompt's own blocks name the trash block). Rows may
    repeat physical ids only where the written data is identical."""
    last, scratch = _prefill_scratch(params, tokens, lengths, cfg, backend)
    transformer.scatter_cache_pages(cfg, cache, scratch,
                                    block_map.reshape(-1))
    return last, cache


def serve_step(params, cache, token: torch.Tensor, pos,
               cfg: ModelConfig, *, backend: str = "auto", mesh=None
               ) -> Tuple[torch.Tensor, Any]:
    """One decode step: token [B, 1] (or [B, n_cb, 1]) at absolute
    position ``pos`` (an int, or a [B] tensor of per-row positions).
    Every weight product has N = B, the skinny regime the paper
    targets. ``mesh`` as in :func:`prefill`."""
    logits, cache = transformer.forward(params, {"tokens": token}, cfg,
                                        mode="decode", cache=cache, pos=pos,
                                        backend=backend, mesh=mesh)
    return (logits[:, 0] if cfg.n_codebooks else logits[:, -1]), cache


def accept_drafts(logits: torch.Tensor, tokens: torch.Tensor,
                  draft_lens: torch.Tensor, uids: Optional[torch.Tensor],
                  counts: Optional[torch.Tensor], *,
                  temperature: float = 0.0, top_k: int = 0, seed: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The target's token after each window prefix and the accepted draft
    count of a verify window (logits [B, W, V], tokens [B, W]). Column j
    draws as the non-speculative loop draws token index ``counts + j``
    (argmax when greedy), so speculation leaves the streams as they
    were. ``n_accept`` is the length of the prefix of drafts that match,
    capped at each row's ``draft_lens``: a cumulative product on the
    device, with no host read."""
    B, W = tokens.shape
    if temperature == 0.0:
        tgt = torch.argmax(logits, dim=-1)
    else:
        cols = torch.arange(W, device=tokens.device)
        tgt = sample_per_slot(
            logits.reshape(B * W, -1), uids[:, None].expand(B, W).reshape(-1),
            (counts[:, None] + cols[None, :]).reshape(-1),
            temperature=temperature, top_k=top_k, seed=seed).reshape(B, W)
    steps = torch.arange(W - 1, device=tokens.device)
    match = (tokens[:, 1:] == tgt[:, :-1]) & (steps[None, :]
                                              < draft_lens[:, None])
    n_accept = torch.cumprod(match.to(torch.int64), dim=1).sum(dim=1)
    return tgt, n_accept


def verify_step(params, cache, tokens: torch.Tensor, pos_vec: torch.Tensor,
                tables: torch.Tensor, draft_lens: torch.Tensor,
                uids: Optional[torch.Tensor], counts: Optional[torch.Tensor],
                cfg: ModelConfig, *, ring_len: Optional[int] = None,
                temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                backend: str = "auto"
                ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
    """Speculative verification: score W = k+1 candidate positions per
    slot in one forward over the paged cache, accept the longest matching
    draft prefix, and commit only the accepted positions' K/V.

    tokens [B, W]: column 0 is each slot's committed last token, the rest
    its drafts (right-padded past ``draft_lens [B]``); ``pos_vec [B]`` is
    column 0's absolute position; ``tables [B, blocks_per_seq]``.
    Returns (tgt [B, W], n_accept [B], cache): the slot emits
    ``tgt[:, :a+1]`` (its a accepted drafts and the bonus token) and moves
    to ``pos + a + 1``; rejected positions go to the trash block.
    ``ring_len`` is a sliding-window config's ring (positions at
    ``p % ring_len``)."""
    W = tokens.shape[1]
    logits, fresh = transformer.forward(
        params, {"tokens": tokens}, cfg, mode="verify", cache=cache,
        pos=pos_vec, block_tables=tables, ring_len=ring_len,
        backend=backend)
    tgt, n_accept = accept_drafts(logits, tokens, draft_lens, uids, counts,
                                  temperature=temperature, top_k=top_k,
                                  seed=seed)
    commit = (torch.arange(W, device=tokens.device)[None, :]
              <= n_accept[:, None])
    transformer.commit_verify_window(cfg, cache, fresh, tables, pos_vec,
                                     commit, ring_len=ring_len)
    return tgt, n_accept, cache


def prefill_chunk_into_pages(params, cache, tokens: torch.Tensor,
                             pos_vec: torch.Tensor, tables: torch.Tensor,
                             n_tokens: torch.Tensor, cfg: ModelConfig, *,
                             ring_len: Optional[int] = None,
                             backend: str = "auto"
                             ) -> Tuple[torch.Tensor, Any]:
    """The mixed prefill-chunk/decode step over the paged cache: a
    prefill chunk is a fully accepted verify window. ``tokens [B, W]``
    holds a chunk slot's next ``n_tokens[b]`` prompt tokens (positions
    ``pos_vec[b]`` on), a decode slot's last token in column 0
    (``n_tokens[b] = 1``), an idle slot padding (``n_tokens[b] = 0``);
    every real column's K/V is committed, padding goes to the trash
    block. Returns (last [B, V], cache): the logits after each row's last
    real column (meaningless for idle and mid-prompt rows). Every weight
    product runs at N = B * W for the weight traffic of one step.
    ``ring_len`` as in ``verify_step`` (the batcher refuses chunked
    prefill on a ring, as the reference does)."""
    B, W = tokens.shape
    logits, fresh = transformer.forward(
        params, {"tokens": tokens}, cfg, mode="verify", cache=cache,
        pos=pos_vec, block_tables=tables, ring_len=ring_len,
        backend=backend)
    cols = torch.arange(W, device=tokens.device)
    transformer.commit_verify_window(cfg, cache, fresh, tables, pos_vec,
                                     cols[None, :] < n_tokens[:, None],
                                     ring_len=ring_len)
    idx = (n_tokens.to(torch.int64) - 1).clamp(min=0)
    return logits[torch.arange(B, device=tokens.device), idx], cache


# splitmix64's multipliers and increment, as signed 64-bit integers.
_MIX1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_MIX2 = 0x94D049BB133111EB - (1 << 64)
_GOLDEN = 0x9E3779B97F4A7C15 - (1 << 64)


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finaliser on int64 tensors (products wrap mod 2^64)."""
    x = (x ^ _shr(x, 30)) * _MIX1
    x = (x ^ _shr(x, 27)) * _MIX2
    return x ^ _shr(x, 31)


def _slot_noise(seed: int, uids: torch.Tensor, counts: torch.Tensor,
                vocab: int, codebooks: int = 0) -> torch.Tensor:
    """Gumbel noise [B, vocab] (f32), a pure function of (seed, uid, token
    index, vocab id): the per-slot counterpart of the reference's keys
    folded by (uid, token index). With ``codebooks``, [B, codebooks,
    vocab], the codebook index folded in after the token index."""
    dev = uids.device
    key = _mix64(torch.full_like(uids, seed, dtype=torch.int64) + _GOLDEN)
    key = _mix64(key + uids.to(torch.int64) * _GOLDEN)
    key = _mix64(key + counts.to(torch.int64) * _GOLDEN)
    if codebooks:
        cb = torch.arange(codebooks, device=dev, dtype=torch.int64)
        key = _mix64(key[:, None] + cb[None, :] * _GOLDEN)
    ids = torch.arange(vocab, device=dev, dtype=torch.int64) * _GOLDEN
    bits = _mix64(key[..., None] + ids)
    u = (_shr(bits, 41).to(torch.float32) + 0.5) * (2.0 ** -23)  # (0, 1)
    return -torch.log(-torch.log(u))


def sample_per_slot(logits: torch.Tensor, uids: Optional[torch.Tensor],
                    counts: Optional[torch.Tensor], *,
                    temperature: float = 0.0, top_k: int = 0,
                    seed: int = 0) -> torch.Tensor:
    """Per-slot sampling for continuous batching: logits [B, vocab] (or
    [B, n_cb, vocab], one draw a codebook); row b draws with noise from
    (seed, uids[b], counts[b]), so a slot's stream is independent of
    admission order, slot and preemption. T == 0 is exact greedy (no
    folds needed): the argmax."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.to(torch.float32) / temperature
    if top_k:
        vals = torch.topk(logits, top_k, dim=-1).values
        logits = logits.masked_fill(logits < vals[..., -1:], float("-inf"))
    noise = _slot_noise(seed, uids, counts, logits.shape[-1],
                        logits.shape[1] if logits.dim() == 3 else 0)
    return torch.argmax(logits + noise, dim=-1)


def generate(params, prompt: torch.Tensor, cfg: ModelConfig, *,
             max_new_tokens: int, max_len: Optional[int] = None,
             temperature: float = 0.0, seed: int = 0,
             backend: str = "auto",
             timings: Optional[dict] = None, mesh=None) -> torch.Tensor:
    """Autoregressive generation: prompt [B, S] -> [B, S + new] (a
    codebook model: [B, n_cb, S] -> [B, n_cb, S + new]). With ``mesh``
    (``params`` this rank's shard) every rank returns the same tokens.

    ``timings``, when given, receives ``prefill_s`` (prompt through the
    first token) and ``decode_s`` (the remaining steps), host clock around
    work that ends in a device synchronise."""
    dev = device_of(params)
    if dev is not None and prompt.device != dev:
        raise ValueError(f"prompt on {prompt.device}, params on {dev}")
    S = prompt.shape[-1]
    max_len = max_len or (S + max_new_tokens)
    uids = torch.arange(prompt.shape[0], dtype=torch.int64,
                        device=prompt.device)

    def sample(logits: torch.Tensor, index: int) -> torch.Tensor:
        return sample_per_slot(logits, uids, torch.full_like(uids, index),
                               temperature=temperature, seed=seed)
    sync = (lambda: torch.cuda.synchronize(prompt.device)) \
        if prompt.is_cuda else (lambda: None)
    with torch.inference_mode():
        sync()
        t0 = time.perf_counter()
        last_logits, cache = prefill(params, prompt, cfg, max_len,
                                     backend=backend, mesh=mesh)
        out = [prompt]
        tok = sample(last_logits, S)
        sync()
        t1 = time.perf_counter()
        for i in range(max_new_tokens):
            nxt = tok[:, :, None] if cfg.n_codebooks else tok[:, None]
            out.append(nxt)
            if i == max_new_tokens - 1:
                break
            logits, cache = serve_step(params, cache, nxt, S + i, cfg,
                                       backend=backend, mesh=mesh)
            tok = sample(logits, S + i + 1)
        sync()
        if timings is not None:
            timings.update(prefill_s=t1 - t0,
                           decode_s=time.perf_counter() - t1)
        return torch.cat(out, dim=-1)
