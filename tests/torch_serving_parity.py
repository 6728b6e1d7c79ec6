"""Shared set-up of the serving parity tests: the same reference params in
both packages (f32 configs, from ``torch_parity.models``), the workloads
of the reference's serving tests, and the stream comparison with the
near-tie rule of ``test_torch_slice.py``.

Greedy streams are compared token for token. Where they first differ, the
port's own next-token logits along its stream (a prefill of prompt +
generated so far) must have a top-2 margin below ``F32_TOL``: a near-tie
that either side may break, after which that request is compared no
further. Anything else is a failure.
"""

import functools

import numpy as np
import torch

from repro_torch.serving import engine
from torch_parity import models

F32_TOL = 1e-3


@functools.lru_cache(maxsize=None)
def f32_models(arch, sparsity):
    """(rcfg, jparams, pcfg, pparams), cached per (arch, sparsity)."""
    return models(arch, sparsity, "float32")


def prompts_of(cfg, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, L).astype(np.int64) for L in lengths]


def _margin(pparams, pcfg, tokens):
    with torch.inference_mode():
        last, _ = engine.prefill(pparams, torch.from_numpy(
            np.asarray(tokens, np.int64)[None]), pcfg, len(tokens))
    top = np.sort(last.float().numpy()[0])[-2:]
    return float(top[1] - top[0])


def assert_streams_agree(pparams, pcfg, prompts, got, want):
    """``got`` (port) and ``want`` (reference): {key: generated tokens};
    ``prompts``: {key: prompt}. Returns the number of requests cut at a
    near-tie."""
    assert set(got) == set(want)
    ties = 0
    for key in want:
        g, w = list(got[key]), list(want[key])
        i = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if i is None:
            assert len(g) == len(w), (key, g, w)
            continue
        ctx = list(prompts[key]) + g[:i]
        margin = _margin(pparams, pcfg, ctx)
        assert margin < F32_TOL, (
            f"request {key}: streams differ at token {i} with a top-2 "
            f"margin of {margin:.2e}: port {g}, reference {w}")
        ties += 1
    return ties
