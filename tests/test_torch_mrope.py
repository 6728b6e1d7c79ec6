"""M-RoPE and the vlm family (qwen2-vl-2b's backbone) in the port, against
the reference, on its smoke config (2 layers, d_model 96, 6 heads and 2
K/V heads of 16, q/k/v bias, sections (2, 3, 3), tied head).

Reference params come through ``convert`` and inputs are made from a
seed with numpy. Held to the reference on the same inputs:
``apply_mrope`` with distinct (t, h, w) ids, and with equal ids, where it
must equal plain RoPE exactly; prefill attention and its cache at a
vision-grid prefix (t fixed, distinct h and w ids) followed by text;
``transformer.forward`` with the default positions, explicit ``[3, B,
S]`` positions and an ``embeds`` input (the stubbed vision frontend),
and ``engine.prefill``'s ``embeds=``/``positions=``; dense and paged
decode and the verify window (every axis at the decode position, as the
reference decodes); the whole stack dense and with Tiled-CSL at 0.8, f32
and bf16; and greedy streams through both packages' batchers, dense and
paged.

Tolerances: f32 within ``rtol = atol = 1e-5`` (``F32_TOL``), ``1e-3``
where attention runs over bf16 K/V (``ATTN_TOL``: an f32 difference of
one ulp in a projection can flip a bf16 rounding, as in
``test_torch_slice``); bf16 within ``3e-2`` (``BF16_TOL``), a bf16
stack's K/V within ``3e-2`` of the leaf's largest magnitude; cache
writes of f32 activations within one bf16 ulp.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import attention as ref_attention
from repro.models import rope as ref_rope
from repro.models import transformer as ref_tf
from repro.serving import batching as ref_batching
from repro.serving import engine as ref_engine
from repro_torch import configs
from repro_torch.models import attention, rope, transformer
from repro_torch.serving import batching, engine
from torch_parity import models, step_logits
from torch_serving_parity import prompts_of
from torch_window_parity import (BF16_ULP, port_cache, random_pools,
                                 ref_cache)

ARCH = "qwen2_vl_2b"
F32_TOL = dict(rtol=1e-5, atol=1e-5)
ATTN_TOL = dict(rtol=1e-3, atol=1e-3)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
DTYPES = ("float32", "bfloat16")
GRID = 4                                # a 4 x 4 patch grid, then text
TEXT = 5


@functools.lru_cache(maxsize=None)
def _models(sparsity, dtype):
    return models(ARCH, sparsity, dtype)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


def _x(shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _vision_positions(B):
    """[3, B, GRID^2 + TEXT]: the grid's patches at t = 0 with their row
    and column as h and w, then text at max + 1 on, equal on all three
    axes (Qwen2-VL's layout)."""
    r, c = np.divmod(np.arange(GRID * GRID), GRID)
    text = GRID + np.arange(TEXT)
    thw = np.stack([np.concatenate([np.zeros_like(r), text]),
                    np.concatenate([r, text]), np.concatenate([c, text])])
    return np.ascontiguousarray(np.broadcast_to(
        thw[:, None], (3, B, thw.shape[1]))).astype(np.int64)


def _attn_params(jparams, pparams, i=0):
    return (jax.tree.map(lambda a: a[i], jparams["layers"]["attn"]),
            pparams["layers"][i]["attn"])


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_equals_reference(smoke):
    get = "smoke" if smoke else "get"
    rcfg, pcfg = getattr(ref_configs, get)(ARCH), getattr(configs, get)(ARCH)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(rcfg)
    assert pcfg.param_count() == rcfg.param_count()
    assert sum(pcfg.mrope_sections) == pcfg.head_dim // 2


# ---------------------------------------------------------------------------
# the rotation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_mrope_matches_reference(dtype):
    """Distinct t, h and w ids at head_dim 128 with qwen2-vl's sections
    (16, 24, 24) and theta 1e6."""
    jx, px = _x((2, 21, 3, 128), dtype, seed=1)
    pos = np.random.default_rng(2).integers(0, 3000, (3, 2, 21))
    want = ref_rope.apply_mrope(jx, jnp.asarray(pos, jnp.int32),
                                (16, 24, 24), 1e6)
    got = rope.apply_mrope(px, torch.from_numpy(pos), (16, 24, 24), 1e6)
    assert got.dtype == px.dtype
    _close(got, want, F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_mrope_with_equal_ids_is_rope(dtype):
    """Text tokens carry equal ids on the three axes: M-RoPE is then 1-D
    RoPE, bit for bit."""
    _, px = _x((2, 9, 4, 16), dtype, seed=3)
    pos = torch.from_numpy(np.random.default_rng(4).integers(0, 500, (2, 9)))
    got = rope.apply_mrope(px, pos[None].expand(3, -1, -1), (2, 3, 3), 1e6)
    assert torch.equal(got, rope.apply_rope(px, pos, 1e6))
    with pytest.raises(ValueError, match="sections"):
        rope.apply_mrope(px, pos[None].expand(3, -1, -1), (2, 3, 4), 1e6)


# ---------------------------------------------------------------------------
# attention: prefill, decode, paged decode, verify
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_attention_at_a_vision_prefix_matches_reference(dtype):
    """Prefill over a patch grid then text: output and the K/V cache
    (the mask orders by the temporal ids, as the reference's
    ``positions[0]``)."""
    rcfg, jparams, pcfg, pparams = _models(None, dtype)
    jp, pp = _attn_params(jparams, pparams, 1)
    pos = _vision_positions(2)
    S = pos.shape[-1]
    jx, px = _x((2, S, pcfg.d_model), dtype, seed=5)
    want, wcache = ref_attention.attention(
        jp, jx, jnp.asarray(pos, jnp.int32), rcfg,
        cache=ref_attention.init_cache(rcfg, 2, S + 3))
    got, gcache = attention.attention(
        pp, px, torch.from_numpy(pos), pcfg,
        cache=attention.init_cache(pcfg, 2, S + 3, "cpu"))
    _close(got, want, ATTN_TOL if dtype == "float32" else BF16_TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(_f32(gcache[n]), _f32(wcache[n]),
                                   rtol=BF16_ULP, atol=1e-6)


def _kv(cfg, rows, T, seed):
    rng = np.random.default_rng(seed)
    xs = {n: rng.standard_normal((rows, T, cfg.n_kv, cfg.head_dim)).astype(
        np.float32) for n in ("k", "v")}
    return ({n: jnp.asarray(x, jnp.bfloat16) for n, x in xs.items()},
            {n: torch.from_numpy(x).to(torch.bfloat16)
             for n, x in xs.items()})


DECODE_POS = np.array([3, 21, 30], np.int64)


@pytest.mark.parametrize("uniform", [False, True], ids=["per-row", "0-d"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_dense_decode_matches_reference(dtype, uniform):
    """Decode against the dense cache, the decode position on all three
    axes: a per-row and a shared position."""
    rcfg, jparams, pcfg, pparams = _models(None, dtype)
    jp, pp = _attn_params(jparams, pparams)
    jc, pc = _kv(pcfg, 3, 32, seed=6)
    jx, px = _x((3, 1, pcfg.d_model), dtype, seed=7)
    pos = DECODE_POS
    jpos, ppos = ((jnp.asarray(pos[1], jnp.int32), torch.tensor(pos[1]))
                  if uniform else
                  (jnp.asarray(pos, jnp.int32), torch.from_numpy(pos)))
    want, wcache = ref_attention.attention_decode(jp, jx, jc, jpos, rcfg)
    got, gcache = attention.attention_decode(pp, px, pc, ppos, pcfg)
    _close(got, want, ATTN_TOL if dtype == "float32" else BF16_TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(_f32(gcache[n]), _f32(wcache[n]),
                                   rtol=BF16_ULP, atol=1e-6)


BLOCK, NBLK = 8, 4


@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_decode_and_verify_match_reference(dtype):
    """Paged decode (the row's own position on every axis) and a verify
    window of 4 (positions pos..pos+3 on every axis) over one random
    pool: outputs, the decode's pool writes, the window's fresh K/V."""
    rcfg, jparams, pcfg, pparams = _models(None, dtype)
    jp, pp = _attn_params(jparams, pparams)
    rows = len(DECODE_POS)
    tables = 1 + np.arange(rows * NBLK).reshape(rows, NBLK)
    jt, pt = jnp.asarray(tables, jnp.int32), torch.from_numpy(tables)
    jpos, ppos = jnp.asarray(DECODE_POS, jnp.int32), torch.from_numpy(
        DECODE_POS)
    tol = ATTN_TOL if dtype == "float32" else BF16_TOL
    pools = random_pools(pcfg, 1 + rows * NBLK, BLOCK, seed=8)
    pc, rc = port_cache(pools), ref_cache(pools)
    jx, px = _x((rows, 1, pcfg.d_model), dtype, seed=9)
    want, wcache = ref_attention.attention_decode_paged(
        jp, jx, {n: rc[n][0] for n in ("k", "v")}, jt, jpos, rcfg)
    got, gcache = attention.attention_decode_paged(pp, px, pc[0], pt, ppos,
                                                   pcfg)
    _close(got, want, tol)
    for n in ("k", "v"):
        np.testing.assert_allclose(_f32(gcache[n]), _f32(wcache[n]),
                                   rtol=BF16_ULP, atol=1e-6)
    pools = random_pools(pcfg, 1 + rows * NBLK, BLOCK, seed=10)
    pc, rc = port_cache(pools), ref_cache(pools)
    jx, px = _x((rows, 4, pcfg.d_model), dtype, seed=11)
    want, wfresh = ref_attention.attention_verify_paged(
        jp, jx, {n: rc[n][0] for n in ("k", "v")}, jt, jpos, rcfg)
    got, gfresh = attention.attention_verify_paged(pp, px, pc[0], pt, ppos,
                                                   pcfg)
    _close(got, want, tol)
    for n in ("k", "v"):
        np.testing.assert_allclose(_f32(gfresh[n]), _f32(wfresh[n]),
                                   rtol=BF16_ULP, atol=1e-6)


# ---------------------------------------------------------------------------
# the whole stack
# ---------------------------------------------------------------------------

_REF_FORWARD = jax.jit(functools.partial(ref_tf.forward, mode="prefill"),
                       static_argnames=("cfg",))


@pytest.mark.parametrize("inputs", ["default", "positions", "embeds"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_inputs_match_reference(dtype, inputs):
    """``transformer.forward`` in prefill: tokens at the default [3, B,
    S] positions; tokens at explicit vision-prefix positions; and
    ``embeds`` (a stub frontend's [B, S, d]) at them. Logits and every
    layer's cache."""
    rcfg, jparams, pcfg, pparams = _models(None, dtype)
    pos = _vision_positions(2)
    S = pos.shape[-1]
    tokens = np.random.default_rng(12).integers(0, pcfg.vocab, (2, S))
    jin = {"tokens": jnp.asarray(tokens, jnp.int32)}
    pin = {"tokens": torch.from_numpy(tokens)}
    if inputs != "default":
        jin["positions"] = jnp.asarray(pos, jnp.int32)
        pin["positions"] = torch.from_numpy(pos)
    if inputs == "embeds":
        je, pe = _x((2, S, pcfg.d_model), dtype, seed=13)
        jin["embeds"], pin["embeds"] = je * 0.02, pe * 0.02
    want, wcache, _ = _REF_FORWARD(jparams, jin, cfg=rcfg,
                                   cache=ref_tf.init_cache(rcfg, 2, S))
    with torch.inference_mode():
        got, gcache = transformer.forward(
            pparams, pin, pcfg, mode="prefill",
            cache=transformer.init_cache(pcfg, 2, S, device="cpu"))
    assert tuple(got.shape) == (2, S, pcfg.vocab)
    _close(got, want, ATTN_TOL if dtype == "float32" else BF16_TOL)
    # f32: each side rounds the same K/V to bf16 (one ulp apart at most).
    # bf16: the K/V come from bf16 activations each side rounds on its
    # own, and a layer's rmsnorm scales the residual's differences up to
    # the K/V's own size: within 3e-2 of the leaf's largest magnitude.
    for i, layer in enumerate(gcache):
        for n in ("k", "v"):
            want_kv = _f32(wcache[n][i])
            kv_tol = (dict(rtol=BF16_ULP, atol=1e-6) if dtype == "float32"
                      else dict(rtol=3e-2, atol=3e-2 * np.abs(want_kv).max()))
            np.testing.assert_allclose(_f32(layer[n]), want_kv, **kv_tol)


def test_engine_prefill_takes_embeds_and_positions():
    """``engine.prefill(..., embeds=, positions=)`` against the
    reference's, then a decode step after the vision prefix (the scalar
    position on every axis)."""
    rcfg, jparams, pcfg, pparams = _models(None, "float32")
    pos = _vision_positions(3)
    S = pos.shape[-1]
    tokens = np.zeros((3, S), np.int32)
    je, pe = _x((3, S, pcfg.d_model), "float32", seed=14)
    jlast, jcache = ref_engine.prefill(
        jparams, jnp.asarray(tokens), rcfg, S + 2, embeds=je * 0.02,
        positions=jnp.asarray(pos, jnp.int32))
    with torch.inference_mode():
        plast, pcache = engine.prefill(
            pparams, torch.from_numpy(tokens).long(), pcfg, S + 2,
            embeds=pe * 0.02, positions=torch.from_numpy(pos))
    _close(plast, jlast, ATTN_TOL)
    tok = np.array(jnp.argmax(jlast, -1))[:, None]
    jstep, _ = ref_engine.serve_step(jparams, jcache, jnp.asarray(tok),
                                     jnp.array(S, jnp.int32), rcfg)
    with torch.inference_mode():
        pstep, _ = engine.serve_step(pparams, pcache, torch.from_numpy(tok),
                                     S, pcfg)
    _close(pstep, jstep, ATTN_TOL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sparsity", [None, 0.8], ids=["dense", "csl"])
def test_forward_matches_reference(sparsity, dtype):
    """Prefill and the first decode step of the whole stack (jitted
    reference), dense and with the projections in Tiled-CSL."""
    rcfg, jparams, pcfg, pparams = _models(sparsity, dtype)
    prompt = np.random.default_rng(15).integers(
        0, pcfg.vocab, (3, 19)).astype(np.int32)
    for want, got in step_logits(rcfg, jparams, pcfg, pparams, prompt, 24,
                                 jit=True):
        np.testing.assert_allclose(
            got, want, **(ATTN_TOL if dtype == "float32" else BF16_TOL))


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_batcher_streams_match_reference(kind):
    """Greedy streams through both packages' ``ContinuousBatcher`` (3
    slots, bucketed admission, slot reuse), dense and paged: identical
    token for token."""
    rcfg, jparams, pcfg, pparams = _models(0.8, "float32")
    lengths, new = [5, 17, 9, 12, 3], [10, 6, 12, 8, 9]
    prompts = prompts_of(pcfg, lengths, seed=16)
    kw = dict(n_slots=3, max_len=40)
    if kind == "paged":
        kw.update(cache_kind="paged", block_size=8)
    out = []
    for cls, params, cfg in ((ref_batching.ContinuousBatcher, jparams, rcfg),
                             (batching.ContinuousBatcher, pparams, pcfg)):
        b = cls(params, cfg, **kw)
        for uid, (p, n) in enumerate(zip(prompts, new)):
            b.submit(uid, p, max_new_tokens=n)
        out.append(b.run_to_completion(max_steps=500))
        if kind == "paged":
            b.pool.check_invariants()
            assert b.pool.blocks_in_use == 0
    want, got = out
    assert got == want


def test_cli_serves_the_vlm_paged_with_speculation():
    """``--arch qwen2_vl_2b --paged --spec-k 2`` serves through
    ``StreamingServer``: M-RoPE through the paged decode and verify
    graphs' eager steps, every request to its length, the pool clean."""
    from repro_torch.launch import serve
    rep = serve.main(["--arch", ARCH, "--smoke", "--sparsity", "0.8",
                      "--requests", "3", "--slots", "2", "--max-new", "6",
                      "--max-len", "48", "--paged", "--spec-k", "2"],
                     device="cpu")
    assert all(len(r.tokens) == 6 for r in rep["responses"])
    pool = rep["server"].batcher.pool
    pool.check_invariants()
    assert pool.blocks_in_use == 0
