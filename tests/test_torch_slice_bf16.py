"""The slice in the default bf16 configs: reference params through
``convert`` into the port; prefill and first decode-step logits match the
reference's within ``atol=rtol=3e-2`` (bf16 rounds at other places in the
two frameworks), on both smoke configs, dense and at sparsity 0.8."""

import numpy as np
import pytest

from torch_parity import models, prompt_of, step_logits

BF16_TOL = 3e-2


@pytest.mark.parametrize("sparsity", [None, 0.8])
@pytest.mark.parametrize("arch", ["opt_30b", "tinyllama_1_1b"])
def test_bf16_logits(arch, sparsity):
    rcfg, jparams, pcfg, pparams = models(arch, sparsity, "bfloat16")
    prompt = prompt_of(rcfg)
    for want, got in step_logits(rcfg, jparams, pcfg, pparams, prompt,
                                  prompt.shape[1] + 2):
        np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL)


def test_sparse_path_runs_grouped_weights():
    """At 0.8 the OPT smoke params carry grouped wqkv, so the slice above
    exercises the grouped and ungrouped paths."""
    _, _, _, pparams = models("opt_30b", 0.8, "float32")
    assert "wqkv" in pparams["layers"][0]["attn"]
    _, _, _, pparams = models("tinyllama_1_1b", 0.8, "float32")
    assert "gate_up" in pparams["layers"][0]["mlp"]
