"""The slice end to end: reference params through ``convert`` into the
port's model and engine, against the reference's, on both smoke configs,
dense and at sparsity 0.8.

* ``dtype="float32"`` configs: prefill and first decode-step logits match
  within ``rtol=atol=1e-3`` and greedy ``engine.generate`` tokens are
  identical. The point is the algorithm, so it is compared in f32; the
  tolerance is not 1e-5 because K/V are stored in bf16 even in f32
  configs, and one rounding flip there moves the logits. Where a step's
  top-2 logit margin falls below that tolerance the argmax is a near-tie
  that either side may break; token comparison stops at that step.

The default bf16 configs are held in ``test_torch_slice_bf16.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import engine as ref_engine
from repro_torch.serving import engine
from torch_parity import models, prompt_of, step_logits

F32_TOL = 1e-3
MAX_NEW = 5


def _near_tie_step(logits_steps, tol):
    """First step whose top-2 margin is below ``tol`` (or None)."""
    for i, lg in enumerate(logits_steps):
        top = np.sort(lg, axis=-1)[:, -2:]
        if np.any(top[:, 1] - top[:, 0] < tol):
            return i
    return None


# Each config dense and at 0.8; the ones added since, one of the two each.
CASES = [(arch, sparsity)
         for arch in ("opt_30b", "tinyllama_1_1b", "minicpm3_4b")
         for sparsity in (None, 0.8)] + [
    ("deepseek_coder_33b", 0.8), ("qwen2_1_5b", None),
    ("qwen2_moe_a2_7b", 0.8), ("qwen3_moe_30b_a3b", None)]


@pytest.mark.parametrize("arch,sparsity", CASES)
def test_f32_logits_and_greedy_tokens(arch, sparsity):
    rcfg, jparams, pcfg, pparams = models(arch, sparsity, "float32")
    prompt = prompt_of(rcfg)
    S = prompt.shape[1]
    for want, got in step_logits(rcfg, jparams, pcfg, pparams, prompt,
                                  S + MAX_NEW):
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)

    jtok = np.asarray(ref_engine.generate(jparams, jnp.asarray(prompt), rcfg,
                                          max_new_tokens=MAX_NEW))
    ptok = engine.generate(pparams, torch.from_numpy(prompt).long(), pcfg,
                           max_new_tokens=MAX_NEW).numpy()
    # Near-ties, judged on the port's per-step logits along its own stream.
    steps = []
    with torch.inference_mode():
        last, cache = engine.prefill(pparams, torch.from_numpy(ptok[:, :S]),
                                     pcfg, S + MAX_NEW)
        steps.append(last.float().numpy())
        for i in range(MAX_NEW - 1):
            last, cache = engine.serve_step(
                pparams, cache, torch.from_numpy(ptok[:, S + i:S + i + 1]),
                S + i, pcfg)
            steps.append(last.float().numpy())
    tie = _near_tie_step(steps, F32_TOL)
    upto = S + (MAX_NEW if tie is None else tie)
    np.testing.assert_array_equal(ptok[:, :upto], jtok[:, :upto])
    assert ptok.shape == jtok.shape


def test_sampling_is_a_function_of_seed_and_index():
    """Temperature sampling, the per-slot draw ``generate`` makes (row b
    as uid b), is a pure function of (seed, token index): the same
    (seed, index) gives the same tokens, and top-k keeps every draw among
    the k largest logits."""
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.standard_normal((4, 50)).astype(np.float32))
    uid = torch.arange(4, dtype=torch.int64)

    def sample(index, **kw):
        return engine.sample_per_slot(logits, uid, torch.full_like(uid, index),
                                      seed=5, **kw)
    assert torch.equal(engine.sample_per_slot(logits, None, None),
                       logits.argmax(-1))
    once = sample(9, temperature=0.7)
    assert torch.equal(once, sample(9, temperature=0.7))
    draws = torch.stack([sample(i, temperature=1.0, top_k=3)
                         for i in range(40)])
    top3 = torch.topk(logits, 3, dim=-1).indices                # [4, 3]
    assert bool((draws[..., None] == top3[None]).any(-1).all())
    assert len(set(draws.flatten().tolist())) > 4               # not greedy
