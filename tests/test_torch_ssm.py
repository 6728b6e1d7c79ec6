"""The SSM family (Mamba2 SSD, mamba2-130m) in the port, against the
reference, on its smoke config (2 layers, d_model 64, d_inner 128, 8
heads of 16, state 16, conv 4, chunk 16, tied head).

Reference params come through ``convert`` and inputs are made from a
seed with numpy. Held to the reference on the same inputs: the chunked
SSD scan with and without a carried state, and against a sequential f64
recurrence; ``ssm_block`` (prefill) output and cache at lengths below,
at and past the chunk and past two chunks, and shorter than the conv;
``ssm_decode`` over 8 steps from a carried state; ``transformer.forward``
in prefill and decode, f32 and bf16; ``engine.generate``'s greedy
streams; the batcher's and ``StreamingServer``'s streams with mixed
prompt lengths (exact-length admission); and ``serve.build``.

Tolerances: f32 within ``rtol = atol = 1e-5`` (``F32_TOL``; the port
contracts the reference's three-operand einsums pairwise, so sums
associate differently); against the f64 recurrence ``1e-5``; bf16 within
``3e-2`` (``BF16_TOL``, the repo's bound for a few bf16 layers).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.core import pruning as ref_pruning
from repro.models import ssm as ref_ssm
from repro.serving import batching as ref_batching
from repro.serving import budget as ref_budget
from repro.serving import engine as ref_engine
from repro_torch import configs, convert
from repro_torch.launch import serve
from repro_torch.models import ssm, transformer
from repro_torch.serving import api, batching, budget, engine
from torch_parity import models, step_logits
from torch_serving_parity import prompts_of

ARCH = "mamba2_130m"
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
DTYPES = ("float32", "bfloat16")
# below, at and past the smoke chunk (16), past two chunks, and shorter
# than the conv's history (conv - 1 = 3)
LENGTHS = (1, 2, 3, 15, 16, 17, 33)


@functools.lru_cache(maxsize=None)
def _models(dtype):
    return models(ARCH, None, dtype)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


def _x(cfg, shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


# The reference's block and step, compiled whole (op by op they cost
# seconds a call on the CPU).
_REF_BLOCK = jax.jit(ref_ssm.ssm_block, static_argnames=("cfg",))
_REF_DECODE = jax.jit(ref_ssm.ssm_decode, static_argnames=("cfg",))


def _ssm_params(jparams, pparams, i=0):
    return (jax.tree.map(lambda a: a[i], jparams["layers"]["ssm"]),
            pparams["layers"][i]["ssm"])


# ---------------------------------------------------------------------------
# config, params, caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_and_param_count_equal_reference(smoke):
    get = "smoke" if smoke else "get"
    rcfg, pcfg = getattr(ref_configs, get)(ARCH), getattr(configs, get)(ARCH)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(rcfg)
    assert pcfg.param_count() == rcfg.param_count()
    assert {pcfg.layer_kind(i) for i in range(pcfg.n_layers)} == {"ssm"}
    assert configs.LONG_CTX_ARCHS == ref_configs.LONG_CTX_ARCHS
    if not smoke:
        assert (pcfg.n_layers, pcfg.d_model, pcfg.ssm_inner, pcfg.ssm_heads,
                pcfg.ssm_head_dim, pcfg.ssm_state, pcfg.vocab) == \
            (24, 768, 1536, 24, 64, 128, 50280)


def test_init_through_convert_and_own_init():
    """The reference's scan-stacked SSM leaves come across as one dict a
    layer, every leaf's shape and bits kept; the port's own
    ``init_model`` draws a tree of the same paths and shapes, with the
    reference's deterministic leaves (``a_log``, ``d_skip``, ``dt_bias``,
    the norm) equal to its."""
    rcfg, jparams, pcfg, pparams = _models("float32")
    own = transformer.init_model(pcfg, seed=0, device="cpu")
    assert len(pparams["layers"]) == len(own["layers"]) == pcfg.n_layers
    for i, (got, mine) in enumerate(zip(pparams["layers"], own["layers"])):
        assert list(got) == list(mine) == ["pre_norm", "ssm"]
        paths = sorted(_walk(got))
        assert [(p, tuple(t.shape)) for p, t in paths] == \
            [(p, tuple(t.shape)) for p, t in sorted(_walk(mine))]
        for path, leaf in paths:
            want = functools.reduce(lambda t, k: t[k], path,
                                    jparams["layers"])[i]
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(want))
        for name in ("a_log", "d_skip", "dt_bias"):
            np.testing.assert_allclose(mine["ssm"][name].numpy(),
                                       got["ssm"][name].numpy(), rtol=1e-6)
    assert tuple(pparams["embed"]["table"].shape) == (pcfg.vocab,
                                                      pcfg.d_model)
    assert "lm_head" not in pparams and "lm_head" not in own


def _walk(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def test_cache_layout_and_state_leaves():
    """``init_cache`` gives each layer the reference's two f32 leaves,
    whatever the K/V dtype asked for, and ``state_leaves`` lists both of
    every layer (the capture warm-up restores them)."""
    _, _, pcfg, _ = _models("float32")
    from repro.models import transformer as ref_tf
    rcfg = ref_configs.smoke(ARCH)
    want = ref_tf.init_cache(rcfg, 3, 40)
    cache = transformer.init_cache(pcfg, 3, 40, device="cpu")
    assert len(cache) == pcfg.n_layers
    for layer in cache:
        assert sorted(layer) == ["conv", "state"]
        for name in layer:
            assert tuple(layer[name].shape) == tuple(want[name].shape[1:])
            assert layer[name].dtype == torch.float32
    leaves = transformer.state_leaves(pcfg, cache)
    assert len(leaves) == 2 * pcfg.n_layers
    assert {id(t) for t in leaves} == {id(t) for layer in cache
                                       for t in layer.values()}


def test_paged_cache_is_refused_as_the_reference():
    """No paged cache for a recurrent stack: ``init_paged_cache``, the
    batcher and the planner's block bytes and plans raise the
    reference's ``ValueError``."""
    _, _, pcfg, pparams = _models("float32")
    rcfg = ref_configs.smoke(ARCH)
    with pytest.raises(ValueError, match="pure-attention"):
        transformer.init_paged_cache(pcfg, 9, 8, device="cpu")
    with pytest.raises(ValueError, match="pure-attention"):
        batching.ContinuousBatcher(pparams, pcfg, n_slots=2, max_len=32,
                                   cache_kind="paged", block_size=8)
    for mod, cfg in ((budget, pcfg), (ref_budget, rcfg)):
        with pytest.raises(ValueError, match="pure-attention"):
            mod.block_bytes(cfg, 16)
        with pytest.raises(ValueError, match="pure-attention"):
            mod.plan(cfg, hbm_budget=80e9, weight_mode="sparse_pallas",
                     block=16)
    with pytest.raises(ValueError, match="paged"):
        batching.ContinuousBatcher(pparams, pcfg, n_slots=2, max_len=32,
                                   spec_k=2)


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------

def _ssd_inputs(b=2, l=48, h=3, p=4, n=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    a_log = np.log(np.linspace(1.0, h, h)).astype(np.float32)
    B = rng.standard_normal((b, l, n)).astype(np.float32)
    C = rng.standard_normal((b, l, n)).astype(np.float32)
    d_skip = rng.standard_normal(h).astype(np.float32)
    st = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, a_log, B, C, d_skip, st


def _sequential_f64(x, dt, a_log, B, C, d_skip, st=None):
    """h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T; y_t = h_t C_t + D x_t,
    one step at a time in f64."""
    x, dt, B, C = (a.astype(np.float64) for a in (x, dt, B, C))
    A = -np.exp(a_log.astype(np.float64))
    b, l, h, p = x.shape
    hs = (np.zeros((b, h, p, B.shape[-1])) if st is None
          else st.astype(np.float64))
    ys = []
    for t in range(l):
        hs = hs * np.exp(dt[:, t] * A)[:, :, None, None] + \
            (dt[:, t, :, None] * x[:, t])[..., None] * B[:, t, None, None, :]
        ys.append(np.einsum("bhpn,bn->bhp", hs, C[:, t])
                  + d_skip[None, :, None] * x[:, t])
    return np.stack(ys, axis=1), hs


@pytest.mark.parametrize("chunk", [8, 16, 48])
@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
def test_ssd_chunked_matches_reference_and_sequential_f64(carried, chunk):
    """Three chunk sizes over 48 steps (6, 3 and 1 chunks), from zero and
    from a carried state: y and the final state equal the reference's
    and a sequential f64 recurrence, within 1e-5."""
    x, dt, a_log, B, C, d_skip, st = _ssd_inputs()
    st = st if carried else None
    wy, wst = ref_ssm._ssd_chunked(
        *(jnp.asarray(a) for a in (x, dt, a_log, B, C, d_skip)), chunk,
        init_state=None if st is None else jnp.asarray(st))
    gy, gst = ssm._ssd_chunked(
        *(torch.from_numpy(a) for a in (x, dt, a_log, B, C, d_skip)), chunk,
        init_state=None if st is None else torch.from_numpy(st))
    assert gy.dtype == gst.dtype == torch.float32
    _close(gy, wy, F32_TOL)
    _close(gst, wst, F32_TOL)
    sy, sst = _sequential_f64(x, dt, a_log, B, C, d_skip, st)
    np.testing.assert_allclose(gy.numpy(), sy, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gst.numpy(), sst, rtol=1e-5, atol=1e-5)


def test_ssd_chunked_stays_finite_where_the_decay_overflows():
    """Large dt A over a chunk: exp(seg_c - seg_s) above the diagonal
    overflows f32, which a 0/1 mask multiplied in would turn into NaN;
    the port stays finite and equal to the reference."""
    x, dt, a_log, B, C, d_skip, _ = _ssd_inputs(l=32)
    dt, x = dt * 40.0, x / 40.0          # the same scale of output
    wy, wst = ref_ssm._ssd_chunked(
        *(jnp.asarray(a) for a in (x, dt, a_log, B, C, d_skip)), 32)
    gy, gst = ssm._ssd_chunked(
        *(torch.from_numpy(a) for a in (x, dt, a_log, B, C, d_skip)), 32)
    assert torch.isfinite(gy).all() and torch.isfinite(gst).all()
    _close(gy, wy, F32_TOL)
    _close(gst, wst, F32_TOL)


# ---------------------------------------------------------------------------
# the block: prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssm_block_matches_reference(dtype, L):
    """Prefill output, final state and conv cache (the last conv - 1
    pre-activation inputs, zeros ahead of a shorter prompt)."""
    rcfg, jparams, pcfg, pparams = _models(dtype)
    jp, pp = _ssm_params(jparams, pparams, 1)
    jx, px = _x(pcfg, (2, L), dtype, seed=L)
    jcache = ref_ssm.init_ssm_cache(rcfg, 2)
    pcache = ssm.init_ssm_cache(pcfg, 2, "cpu")
    want, wcache = _REF_BLOCK(jp, jx, cfg=rcfg, cache=jcache)
    got, gcache = ssm.ssm_block(pp, px, pcfg, cache=pcache)
    assert gcache is pcache and got.dtype == px.dtype
    _close(got, want, _tol(dtype))
    _close(gcache["state"], wcache["state"], _tol(dtype))
    _close(gcache["conv"], wcache["conv"], _tol(dtype))
    if L < pcfg.ssm_conv - 1:
        assert not gcache["conv"][:, :pcfg.ssm_conv - 1 - L].any()


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssm_decode_matches_reference(dtype):
    """Eight decode steps from a prefilled state of 9 positions: every
    step's output and the state and conv cache after it."""
    rcfg, jparams, pcfg, pparams = _models(dtype)
    jp, pp = _ssm_params(jparams, pparams)
    jx, px = _x(pcfg, (3, 9), dtype, seed=5)
    _, jcache = _REF_BLOCK(jp, jx, cfg=rcfg,
                           cache=ref_ssm.init_ssm_cache(rcfg, 3))
    _, pcache = ssm.ssm_block(pp, px, pcfg,
                              cache=ssm.init_ssm_cache(pcfg, 3, "cpu"))
    for t in range(8):
        jxt, pxt = _x(pcfg, (3, 1), dtype, seed=100 + t)
        want, jcache = _REF_DECODE(jp, jxt, jcache, cfg=rcfg)
        got, pcache = ssm.ssm_decode(pp, pxt, pcache, pcfg)
        _close(got, want, _tol(dtype))
        _close(pcache["state"], jcache["state"], _tol(dtype))
        _close(pcache["conv"], jcache["conv"], _tol(dtype))


@pytest.mark.parametrize("L", [1, 3, 15, 16, 17, 33])
def test_chunked_prefill_equals_token_by_token_decode(L):
    """The chunked prefill's final state and conv cache equal those of
    the same input fed token by token through ``ssm_decode`` (f32)."""
    _, _, pcfg, pparams = _models("float32")
    pp = pparams["layers"][0]["ssm"]
    _, px = _x(pcfg, (2, L), "float32", seed=7)
    _, whole = ssm.ssm_block(pp, px, pcfg,
                             cache=ssm.init_ssm_cache(pcfg, 2, "cpu"))
    steps = ssm.init_ssm_cache(pcfg, 2, "cpu")
    for t in range(L):
        _, steps = ssm.ssm_decode(pp, px[:, t:t + 1], steps, pcfg)
    for name in ("state", "conv"):
        np.testing.assert_allclose(whole[name].numpy(), steps[name].numpy(),
                                   rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the whole stack and serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", [9, 40])
def test_forward_matches_reference(S, dtype):
    """``engine.prefill`` and the first decode step through the whole
    2-layer stack (jitted reference), one and three chunks long."""
    rcfg, jparams, pcfg, pparams = _models(dtype)
    prompt = np.random.default_rng(S).integers(
        0, pcfg.vocab, (3, S)).astype(np.int32)
    for want, got in step_logits(rcfg, jparams, pcfg, pparams, prompt,
                                 S + 4, jit=True):
        np.testing.assert_allclose(got, want, **_tol(dtype))


@functools.lru_cache(maxsize=None)
def _ref_generate(prompt_bytes, shape, new):
    rcfg, jparams, _, _ = _models("float32")
    prompt = np.frombuffer(prompt_bytes, np.int32).reshape(shape)
    return np.asarray(ref_engine.generate(jparams, jnp.asarray(prompt), rcfg,
                                          max_new_tokens=new))


def test_generate_streams_equal_reference():
    """Greedy ``engine.generate`` on 3 prompts of 21 tokens, 12 new
    tokens: identical token for token."""
    _, _, pcfg, pparams = _models("float32")
    prompt = np.random.default_rng(21).integers(
        0, pcfg.vocab, (3, 21)).astype(np.int32)
    want = _ref_generate(prompt.tobytes(), prompt.shape, 12)
    with torch.inference_mode():
        got = engine.generate(pparams, torch.from_numpy(prompt).long(), pcfg,
                              max_new_tokens=12)
    np.testing.assert_array_equal(got.numpy(), want)


LENS, NEW = [5, 17, 3, 33, 16, 9], [10, 6, 12, 8, 4, 11]


def _drain(batcher_cls, params, cfg, prompts, **kw):
    b = batcher_cls(params, cfg, n_slots=3, max_len=48, **kw)
    for uid, (p, n) in enumerate(zip(prompts, NEW)):
        b.submit(uid, p, max_new_tokens=n)
    out = b.run_to_completion(max_steps=500)
    assert len(out) == len(prompts)
    return b, out


def test_batcher_streams_equal_reference_and_generate():
    """Both packages' ``ContinuousBatcher`` (3 slots, slot reuse) and the
    port's ``StreamingServer`` over mixed prompt lengths: exact-length
    admission (one prefill shape a distinct length), streams identical to
    each other and to each request run alone through ``generate``."""
    rcfg, jparams, pcfg, pparams = _models("float32")
    prompts = prompts_of(pcfg, LENS, seed=4)
    rb, want = _drain(ref_batching.ContinuousBatcher, jparams, rcfg, prompts)
    pb, got = _drain(batching.ContinuousBatcher, pparams, pcfg, prompts)
    assert got == want
    assert pb.buckets is None and rb.buckets is None
    assert set(pb.metrics.bucket_admits) == set(LENS)
    assert {s[1] for s in pb.stepper.prefill_shapes} == set(LENS)
    assert pb.slots == [None] * 3
    server = api.StreamingServer(pparams, pcfg, n_slots=3, max_len=48,
                                 graph=False)
    for uid, (p, n) in enumerate(zip(prompts, NEW)):
        server.submit(api.GenerationRequest(p, n, session_id=f"r{uid}"))
    streamed = {r.session_id: list(r.tokens)
                for r in server.run_until_drained()}
    assert streamed == {f"r{k}": list(v) for k, v in got.items()}
    for uid, (p, n) in enumerate(zip(prompts, NEW)):
        with torch.inference_mode():
            alone = engine.generate(pparams, torch.from_numpy(p[None]), pcfg,
                                    max_new_tokens=n, max_len=48)
        assert alone[0, len(p):].tolist() == list(got[uid]), uid


def test_graph_capture_warm_up_restores_the_state():
    """The stepper's capture warm-up runs the decode step once before it
    captures; ``state_leaves`` must cover the SSM's state, or the
    captured step would start from a state advanced twice. On the CPU
    the restore is checked through the leaves it saves: a decode step
    changes every one of them."""
    _, _, pcfg, pparams = _models("float32")
    cache = transformer.init_cache(pcfg, 2, 16, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, pcfg.vocab, (2, 5)))
    with torch.inference_mode():
        transformer.forward(pparams, {"tokens": prompt}, pcfg,
                            mode="prefill", cache=cache)
        before = [t.clone() for t in transformer.state_leaves(pcfg, cache)]
        engine.serve_step(pparams, cache, prompt[:, -1:], 5, pcfg)
    after = transformer.state_leaves(pcfg, cache)
    assert all(not torch.equal(a, b) for a, b in zip(after, before))


def test_build_equals_reference_launcher_build():
    """``serve.build`` at sparsity 0.8 against the reference's pruning of
    the same drawn tree with the JAX launcher's list: no SSM weight is
    named there, so nothing is encoded; ``in_proj``/``out_proj`` and the
    tied embedding are cast to bf16, the conv, gates and norm stay f32
    as drawn."""
    cfg = configs.smoke(ARCH)
    got, rep = serve.build(cfg, seed=3, sparsity=0.8, device="cpu")
    drawn = transformer.init_model(cfg, seed=3, device="cpu")
    stacked = {k: (jax.tree.map(lambda *a: jnp.stack(a),
                                *[jax.tree.map(lambda t: jnp.asarray(
                                    t.numpy()), layer)
                                  for layer in v])
                   if k == "layers" else
                   jax.tree.map(lambda t: jnp.asarray(t.numpy()), v))
               for k, v in drawn.items()}
    jsparse = ref_pruning.group_projections(ref_pruning.sparsify_params(
        stacked, 0.8,
        should_sparsify=lambda n: any(k in n for k in serve.SPARSE_NAMES)))
    want = convert.params_from_numpy(jax.tree.map(np.asarray, jsparse),
                                     device="cpu")
    assert rep["n_tiled_csl"] == 0 and not serve.tiled_csl_leaves(got)
    assert got["embed"]["table"].dtype == torch.bfloat16
    torch.testing.assert_close(got["embed"]["table"],
                               want["embed"]["table"].to(torch.bfloat16),
                               rtol=0, atol=0)
    for g, w in zip(got["layers"], want["layers"]):
        for path, leaf in _walk(g):
            ref = functools.reduce(lambda t, k: t[k], path, w)
            bf16 = path[-1] == "w"
            assert leaf.dtype == (torch.bfloat16 if bf16 else torch.float32)
            assert torch.equal(leaf, ref.to(leaf.dtype)), path
    assert rep["weight_bytes"] == serve.params_bytes(got)


def test_cli_serves_mamba2_at_a_sparsity_and_refuses_paged(capsys):
    """``--arch mamba2_130m --sparsity 0.8`` serves through
    ``StreamingServer`` with nothing encoded (the reference's launcher
    divides by the zero dense bytes there: ROADMAP queue 3 item 9) at
    exact-length admission; ``--paged`` raises as the JAX launcher
    does."""
    argv = ["--arch", ARCH, "--smoke", "--sparsity", "0.8", "--requests",
            "3", "--slots", "2", "--max-new", "4", "--max-len", "48"]
    rep = serve.main(argv, device="cpu")
    assert "reformatted 0 weights" in capsys.readouterr().out
    assert len(rep["responses"]) == 3
    assert all(len(r.tokens) == 4 for r in rep["responses"])
    assert rep["server"].batcher.buckets is None
    with pytest.raises(ValueError, match="pure-attention"):
        serve.main(argv + ["--paged"], device="cpu")


def test_bf16_stack_sits_from_f32_as_the_references_does():
    """The port's bf16 rounding points are the reference's: over 24 smoke
    layers the port's bf16 first decode-step logits sit from its own f32
    ones about as far as the reference's bf16 logits sit from its f32
    ones (within 1.5x; measured 0.031 and 0.026), while f32 agrees to
    1e-5. This is the yardstick for the full-depth bf16 gap that
    ``chip_smoke.py``'s SSM phase prints."""
    from repro.models import transformer as ref_tf
    rcfg0 = dataclasses.replace(ref_configs.smoke(ARCH), n_layers=24)
    pcfg0 = dataclasses.replace(configs.smoke(ARCH), n_layers=24)
    jparams = ref_tf.init_model(jax.random.PRNGKey(0), rcfg0)
    pparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    prompt = np.random.default_rng(1).integers(
        0, rcfg0.vocab, (4, 128)).astype(np.int32)
    out = {}
    for dt in DTYPES:
        rcfg = dataclasses.replace(rcfg0, dtype=dt)
        pcfg = dataclasses.replace(pcfg0, dtype=dt)
        out[dt] = step_logits(rcfg, jparams, pcfg, pparams, prompt, 129,
                              jit=True)[1]          # (reference, port)
    (rf, pf), (rb, pb) = out["float32"], out["bfloat16"]
    np.testing.assert_allclose(pf, rf, **F32_TOL)
    ref_gap, port_gap = np.abs(rb - rf).max(), np.abs(pb - pf).max()
    assert 0 < port_gap <= 1.5 * ref_gap, (port_gap, ref_gap)
