"""The slice in the default bf16 configs: reference params through
``convert`` into the port; prefill and first decode-step logits match the
reference's within ``atol=rtol=3e-2`` (bf16 rounds at other places in the
two frameworks), on the smoke configs (``CASES``), dense and at sparsity
0.8.

For the MoE configs the reference runs op by op (``jax.disable_jit``).
Its compiled graph rounds the bf16 steps of the router softmax, the
gates and the norms apart from its op-by-op run: on qwen3-moe smoke
(dense weights) the two reference runs' logits differ by 3.5e-2, above
the tolerance, where the port and the op-by-op run differ by at most one
bf16 ulp (1.6e-2) and qwen2-moe's dense weights give the same bits. So
the port is held against one of the reference's two results, the one
whose rounding points it follows."""

import contextlib

import jax
import numpy as np
import pytest

from torch_parity import models, prompt_of, step_logits

BF16_TOL = 3e-2


# Each config dense and at 0.8; the MoE configs, one of the two each.
CASES = [(arch, sparsity)
         for arch in ("opt_30b", "tinyllama_1_1b", "minicpm3_4b")
         for sparsity in (None, 0.8)] + [
    ("qwen2_moe_a2_7b", 0.8), ("qwen3_moe_30b_a3b", None)]


@pytest.mark.parametrize("arch,sparsity", CASES)
def test_bf16_logits(arch, sparsity):
    rcfg, jparams, pcfg, pparams = models(arch, sparsity, "bfloat16")
    prompt = prompt_of(rcfg)
    op_by_op = (jax.disable_jit() if rcfg.family == "moe"
                else contextlib.nullcontext())
    with op_by_op:
        steps = step_logits(rcfg, jparams, pcfg, pparams, prompt,
                            prompt.shape[1] + 2)
    for want, got in steps:
        np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL)


def test_sparse_path_runs_grouped_weights():
    """At 0.8 the OPT smoke params carry grouped wqkv, so the slice above
    exercises the grouped and ungrouped paths."""
    _, _, _, pparams = models("opt_30b", 0.8, "float32")
    assert "wqkv" in pparams["layers"][0]["attn"]
    _, _, _, pparams = models("tinyllama_1_1b", 0.8, "float32")
    assert "gate_up" in pparams["layers"][0]["mlp"]
