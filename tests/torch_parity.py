"""Shared set-up of the slice parity tests: the same reference params
(seeded, converted with ``convert``) in both packages, and their prefill
and first decode-step logits."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as ref_configs
from repro.core import pruning as ref_pruning
from repro.models import transformer as ref_tf
from repro.serving import engine as ref_engine
from repro_torch import configs, convert
from repro_torch.serving import engine

SPARSE = ("'wq'", "'wk'", "'wv'", "'wo'", "'gate'", "'up'", "'down'")
# The launchers' list above keeps the MLA factors dense; this one encodes
# every factor as well (the reference's default_should_sparsify).
SPARSE_ALL = SPARSE + ("'w_dq'", "'w_uq'", "'w_dkv'", "'w_ukv'")


def should_sparsify(name, names=SPARSE):
    # weights only (the reference's scan-stacked [L, d] biases are 2-D too)
    return name.endswith("['w']") and any(k in name for k in names)


def models(arch, sparsity, dtype, names=SPARSE):
    rcfg = dataclasses.replace(ref_configs.smoke(arch), dtype=dtype)
    pcfg = dataclasses.replace(configs.smoke(arch), dtype=dtype)
    jparams = ref_tf.init_model(jax.random.PRNGKey(0), rcfg)
    if sparsity:
        jparams = ref_pruning.group_projections(ref_pruning.sparsify_params(
            jparams, sparsity,
            should_sparsify=lambda n: should_sparsify(n, names)))
    pparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    return rcfg, jparams, pcfg, pparams


def prompt_of(cfg):
    rng = np.random.default_rng(17)
    return rng.integers(0, cfg.vocab, (3, 9)).astype(np.int32)


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# The reference's prefill and step compiled whole, as its batcher serves
# them (one XLA compile instead of one per primitive).
_REF_PREFILL = jax.jit(ref_engine.prefill, static_argnums=(2, 3))
_REF_STEP = jax.jit(ref_engine.serve_step, static_argnums=(4,))


def step_logits(rcfg, jparams, pcfg, pparams, prompt, max_len, jit=False):
    """Prefill and one decode-step logits from both packages; with
    ``jit`` the reference's engine runs jitted."""
    prefill, step = ((_REF_PREFILL, _REF_STEP) if jit
                     else (ref_engine.prefill, ref_engine.serve_step))
    jlast, jcache = prefill(jparams, jnp.asarray(prompt), rcfg, max_len)
    tok = np.array(jnp.argmax(jlast, -1))[:, None]
    jstep, _ = step(jparams, jcache, jnp.asarray(tok),
                    jnp.array(prompt.shape[1], jnp.int32), rcfg)
    with torch.inference_mode():
        plast, pcache = engine.prefill(pparams, torch.from_numpy(prompt).long(),
                                       pcfg, max_len)
        pstep, _ = engine.serve_step(pparams, pcache,
                                     torch.from_numpy(tok).long(),
                                     prompt.shape[1], pcfg)
    return ((_f32(jlast), plast.float().numpy()),
            (_f32(jstep), pstep.float().numpy()))
