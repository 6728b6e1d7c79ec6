"""Speculative decoding drafters (DESIGN.md §11).

The port's counterpart of ``repro.serving.speculative``. Decode-time
skinny products are bandwidth-bound, so verifying k drafted tokens in one
forward widens every weight product from N = B to N = B·(k+1) at about
the same weight traffic: each accepted draft turns that headroom into a
token.

A drafter proposes up to ``k`` continuation tokens from a request's own
history (prompt + generated so far): ``propose(tokens, k) -> np.ndarray``
of at most ``k`` ids, possibly empty (the step then falls back to plain
decode). Proposals never change the stream — the verify window
(``engine.verify_step``) accepts only what the target itself emits —
they only set the accept rate.

* :class:`NgramDrafter` — prompt lookup over the request's own history:
  the continuation of the most recent earlier occurrence of the
  history's longest matching suffix n-gram. Numpy, as in the reference.
* :class:`DraftModelDrafter` — a greedy k-token rollout of a small model
  sharing the target's tokenizer.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, device_of
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.serving import engine


class NgramDrafter:
    """Prompt-lookup drafting: propose the continuation of the most recent
    earlier occurrence of the history's longest matching suffix n-gram.

    ``max_ngram`` .. ``min_ngram`` is the suffix ladder (longer matches
    first); the first rung with an earlier occurrence wins.
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(f"need 1 <= min_ngram <= max_ngram, got "
                             f"({min_ngram}, {max_ngram})")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, tokens: np.ndarray, k: int) -> np.ndarray:
        n = len(tokens)
        if k <= 0 or n < self.min_ngram + 1:
            return np.empty(0, np.int64)
        for g in range(min(self.max_ngram, n - 1), self.min_ngram - 1, -1):
            suffix = tokens[n - g:]
            # windows[i] == tokens[i:i+g]; candidates are starts i < n-g so
            # the continuation begins strictly before the suffix itself.
            windows = np.lib.stride_tricks.sliding_window_view(tokens, g)
            hits = np.flatnonzero(
                (windows[: n - g] == suffix[None, :]).all(axis=1))
            if hits.size == 0:
                continue
            # Most recent occurrence with a full k-token continuation; on a
            # short-period history (constant runs, repeated patterns) the
            # latest hit ends just before the suffix and would give a
            # 1-token draft. Fall back to the earliest hit — the longest
            # continuation available — when none is full.
            full = hits[hits + g + k <= n]
            start = (int(full[-1]) if full.size else int(hits[0])) + g
            cont = tokens[start: start + k]
            if cont.size:
                return np.asarray(cont, np.int64)
        return np.empty(0, np.int64)


class DraftModelDrafter:
    """Draft-model drafting: the greedy k-token rollout of a small model
    that shares the target's tokenizer (vocab ids must coincide —
    checked).

    Each call prefills the slot's history afresh and decodes k - 1 steps
    (``engine.serve_step``), so the drafter keeps no state across
    preemption or slot reuse. Pure-attention stacks pad the history to a
    power-of-two bucket, as the reference does: the pads sit causally
    after every real position, and each decode step overwrites the next
    one before the mask exposes it. ``device`` defaults to the params'.
    """

    def __init__(self, params, cfg: ModelConfig, *, backend: str = "auto",
                 vocab: Optional[int] = None, min_bucket: int = 8,
                 device: DeviceLike = None):
        if vocab is not None and cfg.vocab != vocab:
            raise ValueError(
                f"draft model vocab {cfg.vocab} != target vocab {vocab}; "
                f"speculative drafts must share the tokenizer")
        self.params = params
        self.cfg = cfg
        self.backend = backend
        self.min_bucket = min_bucket
        self.device = torch.device(device) if device is not None else (
            device_of(params) or torch.device("cpu"))
        self._pure_attn = all(cfg.layer_kind(i) == "attn"
                              for i in range(cfg.n_layers))

    def propose(self, tokens: np.ndarray, k: int) -> np.ndarray:
        if k <= 0:
            return np.empty(0, np.int64)
        n = len(tokens)
        S = n
        if self._pure_attn:
            S = self.min_bucket
            while S < n:
                S *= 2
        padded = np.zeros((1, S), np.int64)
        padded[0, :n] = tokens
        cfg, dev = self.cfg, self.device
        with torch.inference_mode():
            cache = transformer.init_cache(cfg, 1, S + k, device=dev)
            logits, cache = transformer.forward(
                self.params, {"tokens": torch.from_numpy(padded).to(dev)},
                cfg, mode="prefill", cache=cache, backend=self.backend)
            tok = torch.argmax(logits[:, n - 1], dim=-1)        # [1]
            out = [tok]
            for i in range(k - 1):
                lg, cache = engine.serve_step(self.params, cache,
                                              tok[:, None], n + i, cfg,
                                              backend=self.backend)
                tok = torch.argmax(lg, dim=-1)
                out.append(tok)
            return torch.stack(out, dim=1)[0].cpu().numpy().astype(np.int64)


def make_drafter(kind: str, *, max_ngram: int = 3,
                 draft_params=None, draft_cfg: Optional[ModelConfig] = None,
                 vocab: Optional[int] = None, backend: str = "auto",
                 device: DeviceLike = None):
    """CLI/config factory: ``"ngram"`` or ``"model"`` (needs draft
    params)."""
    if kind == "ngram":
        return NgramDrafter(max_ngram=max_ngram)
    if kind == "model":
        if draft_params is None or draft_cfg is None:
            raise ValueError("drafter 'model' needs draft_params + draft_cfg")
        return DraftModelDrafter(draft_params, draft_cfg, vocab=vocab,
                                 backend=backend, device=device)
    raise ValueError(f"unknown drafter kind {kind!r} (ngram|model)")
