"""The audio family (musicgen-large: 4 parallel EnCodec codebooks) in the
port, against the reference, on its smoke config (2 layers, d_model 64,
MHA of 4 heads, LayerNorm, a 128-wide GELU MLP with biases, 4 codebooks
of 64, untied head of 256 rows).

Reference params come through ``convert`` and inputs are made from a
seed with numpy. Held to the reference on the same inputs: the summed
codebook embedding; the ``[B, S, n_cb, V]`` head in prefill and decode,
dense and with Tiled-CSL at 0.8, f32 and bf16; the tied-head branch
(table 0, ``[B, S, V]`` logits) on a smoke config with
``tie_embeddings``; ``engine.generate``'s greedy frames on ``[B, 4, S]``
prompts; and the batcher's refusal. Sampling at T > 0 draws each
codebook with noise of its own, and the same (seed, uid, index) draws
the same frames.

Tolerances: f32 within ``rtol = atol = 1e-3`` (``ATTN_TOL``: attention
over bf16 K/V, where an f32 difference of one ulp in a projection can
flip a bf16 rounding, as in ``test_torch_slice``), ``1e-5`` for the
embedding (``F32_TOL``); bf16 within ``3e-2`` (``BF16_TOL``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import transformer as ref_tf
from repro.serving import batching as ref_batching
from repro.serving import engine as ref_engine
from repro_torch import configs, convert
from repro_torch.launch import serve
from repro_torch.models import transformer
from repro_torch.serving import batching, engine
from torch_parity import models

ARCH = "musicgen_large"
F32_TOL = dict(rtol=1e-5, atol=1e-5)
ATTN_TOL = dict(rtol=1e-3, atol=1e-3)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
DTYPES = ("float32", "bfloat16")


@functools.lru_cache(maxsize=None)
def _models(sparsity, dtype, tied=False):
    if not tied:
        return models(ARCH, sparsity, dtype)
    rcfg = dataclasses.replace(ref_configs.smoke(ARCH), dtype=dtype,
                               tie_embeddings=True)
    pcfg = dataclasses.replace(configs.smoke(ARCH), dtype=dtype,
                               tie_embeddings=True)
    jparams = ref_tf.init_model(jax.random.PRNGKey(0), rcfg)
    pparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    return rcfg, jparams, pcfg, pparams


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _prompt(cfg, B=3, S=11, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, cfg.n_codebooks, S)).astype(np.int32)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_equals_reference(smoke):
    get = "smoke" if smoke else "get"
    rcfg, pcfg = getattr(ref_configs, get)(ARCH), getattr(configs, get)(ARCH)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(rcfg)
    assert pcfg.param_count() == rcfg.param_count()


def test_params_through_convert_and_own_init():
    """The [n_cb, V, d] table and the [n_cb V, d] head come across
    unchanged; the port's own ``init_model`` draws the same shapes."""
    rcfg, jparams, pcfg, pparams = _models(None, "float32")
    own = transformer.init_model(pcfg, seed=0, device="cpu")
    shape = (pcfg.n_codebooks, pcfg.vocab, pcfg.d_model)
    for p in (pparams, own):
        assert tuple(p["embed"]["table"].shape) == shape
        assert tuple(p["lm_head"]["w"].shape) == (
            pcfg.n_codebooks * pcfg.vocab, pcfg.d_model)
    np.testing.assert_array_equal(pparams["embed"]["table"].numpy(),
                                  np.asarray(jparams["embed"]["table"]))


@pytest.mark.parametrize("dtype", DTYPES)
def test_summed_embedding_matches_reference(dtype):
    """One lookup a codebook, summed in codebook order in the compute
    dtype."""
    rcfg, jparams, pcfg, pparams = _models(None, dtype)
    prompt = _prompt(pcfg)
    cdt = jnp.dtype(rcfg.dtype)
    want = ref_tf._embed_tokens(jparams, {"tokens": jnp.asarray(prompt)},
                                rcfg, cdt)
    got = transformer._embed_tokens(
        pparams, {"tokens": torch.from_numpy(prompt).long()}, pcfg,
        getattr(torch, pcfg.dtype))
    assert tuple(got.shape) == (3, 11, pcfg.d_model)
    np.testing.assert_allclose(_f32(got), _f32(want), **(
        F32_TOL if dtype == "float32" else dict(rtol=0, atol=0)))


_REF_PREFILL = jax.jit(ref_engine.prefill, static_argnums=(2, 3))
_REF_STEP = jax.jit(ref_engine.serve_step, static_argnums=(4,))


def _step_logits(rcfg, jparams, pcfg, pparams, prompt, max_len):
    """Prefill and one decode step through both packages' engines: the
    last position's [B, n_cb, V] logits of each."""
    S = prompt.shape[-1]
    jlast, jcache = _REF_PREFILL(jparams, jnp.asarray(prompt), rcfg, max_len)
    tok = np.array(jnp.argmax(jlast, -1))[..., None]
    jstep, _ = _REF_STEP(jparams, jcache, jnp.asarray(tok),
                         jnp.array(S, jnp.int32), rcfg)
    with torch.inference_mode():
        plast, pcache = engine.prefill(pparams,
                                       torch.from_numpy(prompt).long(),
                                       pcfg, max_len)
        pstep, _ = engine.serve_step(pparams, pcache, torch.from_numpy(tok),
                                     S, pcfg)
    return (_f32(jlast), _f32(plast)), (_f32(jstep), _f32(pstep))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sparsity", [None, 0.8], ids=["dense", "csl"])
def test_head_and_step_match_reference(sparsity, dtype):
    """The untied head's [B, S, n_cb, V] logits in prefill and the first
    decode step, dense and with the projections in Tiled-CSL."""
    rcfg, jparams, pcfg, pparams = _models(sparsity, dtype)
    prompt = _prompt(pcfg, seed=1)
    with torch.inference_mode():
        full, _ = transformer.forward(
            pparams, {"tokens": torch.from_numpy(prompt).long()}, pcfg,
            mode="prefill")
    assert tuple(full.shape) == (3, 11, pcfg.n_codebooks, pcfg.vocab)
    for want, got in _step_logits(rcfg, jparams, pcfg, pparams, prompt, 16):
        assert got.shape == (3, pcfg.n_codebooks, pcfg.vocab)
        np.testing.assert_allclose(
            got, want, **(ATTN_TOL if dtype == "float32" else BF16_TOL))


def test_tied_head_reads_table_zero():
    """With ``tie_embeddings`` the head is codebook 0's table and the
    logits stay [B, S, V], as the reference writes the branch."""
    rcfg, jparams, pcfg, pparams = _models(None, "float32", tied=True)
    assert "lm_head" not in pparams
    prompt = _prompt(pcfg, seed=2)
    want, _, _ = ref_tf.forward(jparams, {"tokens": jnp.asarray(prompt)},
                                rcfg, mode="prefill")
    with torch.inference_mode():
        got, _ = transformer.forward(
            pparams, {"tokens": torch.from_numpy(prompt).long()}, pcfg,
            mode="prefill")
    assert tuple(got.shape) == (3, 11, pcfg.vocab)
    np.testing.assert_allclose(_f32(got), _f32(want), **ATTN_TOL)


@functools.lru_cache(maxsize=None)
def _ref_generate(prompt_bytes, shape, new):
    rcfg, jparams, _, _ = _models(None, "float32")
    prompt = np.frombuffer(prompt_bytes, np.int32).reshape(shape)
    return np.asarray(ref_engine.generate(jparams, jnp.asarray(prompt), rcfg,
                                          max_new_tokens=new))


def test_generate_frames_equal_reference():
    """Greedy ``engine.generate`` on [3, 4, 13] prompts for 10 frames:
    every codebook's stream identical to the reference's."""
    _, _, pcfg, pparams = _models(None, "float32")
    prompt = _prompt(pcfg, S=13, seed=3)
    want = _ref_generate(prompt.tobytes(), prompt.shape, 10)
    with torch.inference_mode():
        got = engine.generate(pparams, torch.from_numpy(prompt).long(), pcfg,
                              max_new_tokens=10)
    assert tuple(got.shape) == (3, pcfg.n_codebooks, 23)
    np.testing.assert_array_equal(got.numpy(), want)


def test_serve_run_and_prompts_carry_codebooks():
    """``serve.make_prompts`` draws [B, n_cb, S] for a codebook config
    and ``serve.run`` generates through it, at sparsity 0.8."""
    cfg = configs.smoke(ARCH)
    prompts = serve.make_prompts(cfg, 2, 6, 0, "cpu")
    assert tuple(prompts.shape) == (2, cfg.n_codebooks, 6)
    rep = serve.run(cfg, requests=2, prompt_len=6, max_new=3, sparsity=0.8,
                    device="cpu")
    assert tuple(rep["tokens"].shape) == (2, cfg.n_codebooks, 9)
    assert rep["params"]["embed"]["table"].dtype == torch.bfloat16


def test_batcher_refuses_codebooks_as_the_reference():
    rcfg, jparams, pcfg, pparams = _models(None, "float32")
    for cls, params, cfg in ((ref_batching.ContinuousBatcher, jparams, rcfg),
                             (batching.ContinuousBatcher, pparams, pcfg)):
        with pytest.raises(ValueError, match="codebook"):
            cls(params, cfg, n_slots=2, max_len=32)


def test_sampling_draws_each_codebook_alone():
    """At T > 0 each codebook gets noise of its own (one noise row
    broadcast to all four would draw the same token from equal logits),
    greedy stays the argmax, and the same (seed, uid, token index) draw
    the same frames: ``generate`` twice gives one stream, another seed
    another."""
    _, _, pcfg, pparams = _models(None, "float32")
    uids, counts = torch.arange(3), torch.full((3,), 7)
    noise = engine._slot_noise(5, uids, counts, 64, codebooks=4)
    assert tuple(noise.shape) == (3, 4, 64)
    for c in range(1, 4):
        assert not torch.equal(noise[:, 0], noise[:, c])
    assert torch.equal(engine._slot_noise(5, uids, counts, 64),
                       engine._slot_noise(5, uids, counts, 64))
    flat = torch.zeros((3, 4, 64))
    drawn = engine.sample_per_slot(flat, uids, counts, temperature=1.0,
                                   seed=5)
    assert tuple(drawn.shape) == (3, 4)
    assert any(len(set(row.tolist())) > 1 for row in drawn)
    logits = torch.randn((3, 4, 64), generator=torch.Generator().manual_seed(1))
    assert torch.equal(engine.sample_per_slot(logits, uids, counts),
                       torch.argmax(logits, dim=-1))
    prompt = torch.from_numpy(_prompt(pcfg, S=7, seed=4)).long()
    runs = [engine.generate(pparams, prompt, pcfg, max_new_tokens=6,
                            temperature=0.9, seed=s) for s in (11, 11, 12)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])


def test_cli_refuses_codebooks_as_the_reference():
    """The CLI serves through the batcher, which refuses a codebook
    config with the reference's error."""
    with pytest.raises(ValueError, match="codebook"):
        serve.main(["--arch", ARCH, "--smoke", "--requests", "2",
                    "--max-new", "2", "--max-len", "16"], device="cpu")
