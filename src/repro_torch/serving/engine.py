"""Inference engine: prefill, decode step, sampling, generation loop.

The port's counterpart of ``repro.serving.engine`` (``prefill``,
``serve_step``, ``sample``, ``generate``). The same engine runs dense
weights (``torch.matmul``) or Tiled-CSL weights (the LSCD kernels): the
dispatch happens per weight inside ``sparse_linear.linear``. Everything
runs on the device of the params; the KV cache lives there too and is
updated in place.

Sampling: greedy decoding is exact and token-identical to the reference.
Temperature sampling draws from an explicit ``torch.Generator`` seeded
per token index (``seed + absolute index``), a pure function of
(seed, index) like the reference's folded keys, but with torch's
generator, so sampled streams are compared within the port only.
"""

from __future__ import annotations

import time
from typing import Any, Optional, Tuple

import torch

from repro_torch.device import device_of
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, max_len: int, *,
            backend: str = "auto") -> Tuple[torch.Tensor, Any]:
    """Process the prompt; returns (last-token logits, filled cache)."""
    cache = transformer.init_cache(cfg, tokens.shape[0], max_len,
                                   device=tokens.device)
    logits, cache = transformer.forward(params, {"tokens": tokens}, cfg,
                                        mode="prefill", cache=cache,
                                        backend=backend)
    return logits[:, -1], cache


def serve_step(params, cache, token: torch.Tensor, pos: int,
               cfg: ModelConfig, *, backend: str = "auto"
               ) -> Tuple[torch.Tensor, Any]:
    """One decode step: token [B, 1] at absolute position ``pos``. Every
    weight product has N = B, the skinny regime the paper targets."""
    logits, cache = transformer.forward(params, {"tokens": token}, cfg,
                                        mode="decode", cache=cache, pos=pos,
                                        backend=backend)
    return logits[:, -1], cache


def sample(logits: torch.Tensor, *, temperature: float = 0.0,
           top_k: int = 0, seed: int = 0, index: int = 0) -> torch.Tensor:
    """Greedy (T=0) / temperature / top-k sampling; the draw for token
    ``index`` uses a generator seeded with ``seed + index``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.to(torch.float32) / temperature
    if top_k:
        vals = torch.topk(logits, top_k, dim=-1).values
        logits = torch.where(logits < vals[..., -1:],
                             torch.full_like(logits, float("-inf")), logits)
    gen = torch.Generator(device=logits.device)
    gen.manual_seed(seed + index)
    return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                             generator=gen)[..., 0]


def generate(params, prompt: torch.Tensor, cfg: ModelConfig, *,
             max_new_tokens: int, max_len: Optional[int] = None,
             temperature: float = 0.0, seed: int = 0,
             backend: str = "auto",
             timings: Optional[dict] = None) -> torch.Tensor:
    """Autoregressive generation: prompt [B, S] -> [B, S + new].

    ``timings``, when given, receives ``prefill_s`` (prompt through the
    first token) and ``decode_s`` (the remaining steps), host clock around
    work that ends in a device synchronise."""
    dev = device_of(params)
    if dev is not None and prompt.device != dev:
        raise ValueError(f"prompt on {prompt.device}, params on {dev}")
    S = prompt.shape[-1]
    max_len = max_len or (S + max_new_tokens)
    sync = (lambda: torch.cuda.synchronize(prompt.device)) \
        if prompt.is_cuda else (lambda: None)
    with torch.inference_mode():
        sync()
        t0 = time.perf_counter()
        last_logits, cache = prefill(params, prompt, cfg, max_len,
                                     backend=backend)
        out = [prompt]
        tok = sample(last_logits, temperature=temperature, seed=seed,
                     index=S)
        sync()
        t1 = time.perf_counter()
        for i in range(max_new_tokens):
            nxt = tok[:, None]
            out.append(nxt)
            if i == max_new_tokens - 1:
                break
            logits, cache = serve_step(params, cache, nxt, S + i, cfg,
                                       backend=backend)
            tok = sample(logits, temperature=temperature, seed=seed,
                         index=S + i + 1)
        sync()
        if timings is not None:
            timings.update(prefill_s=t1 - t0,
                           decode_s=time.perf_counter() - t1)
        return torch.cat(out, dim=-1)
