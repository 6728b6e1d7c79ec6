"""Multi-head Latent Attention (``repro_torch.models.mla``) against the
reference's ``repro.models.mla``, on the minicpm3 smoke config.

Reference params come through ``convert``, dense and with every MLA
factor in Tiled-CSL (``w_dq``, ``w_uq``, ``w_dkv`` with its 24 rows
padded to a tile, ``w_ukv``, ``wo``), and inputs are made from a seed
with numpy. Each function is held to the reference's on the same
inputs: prefill (q-chunked and whole), decode at an int, a 0-d and a
per-slot position, paged decode and the verify window (with its
``[B, W]`` fresh leaves), the latent pools' cache helpers and the window
commit (bit-identical blocks), and ``transformer.forward`` in its three
modes. f32 results agree within ``rtol = atol = 1e-5``, bf16 within
``3e-2``; Tiled-CSL words are byte-equal, greedy streams identical.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.core import tiled_csl as ref_tiled_csl
from repro.models import mla as ref_mla
from repro.models import transformer as ref_tf
from repro.serving import engine as ref_engine
from repro_torch import configs
from repro_torch.core import pruning, tiled_csl
from repro_torch.launch import serve
from repro_torch.models import mla, transformer
from repro_torch.serving import engine
from torch_parity import SPARSE_ALL, models
from torch_window_parity import (port_cache, port_np, random_pools,
                                 ref_cache, ref_np)

ARCH = "minicpm3_4b"
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
FACTORS = ("w_dq", "w_uq", "w_dkv", "w_ukv", "wo")
B, BLOCK, NBLK, W = 3, 4, 4, 4
POS = np.array([5, 2, 13], np.int64)          # row 2's window runs past


@functools.lru_cache(maxsize=None)
def _models(sparse, dtype):
    """(rcfg, jparams, pcfg, pparams); ``sparse``: every factor (and the
    MLP) in Tiled-CSL at 0.8."""
    return models(ARCH, 0.8 if sparse else None, dtype, names=SPARSE_ALL)


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _layer(jparams, pparams, i=0):
    """Layer ``i``'s attention params in both packages."""
    return (jax.tree.map(lambda a: a[i], jparams["layers"]["attn"]),
            pparams["layers"][i]["attn"])


def _x(cfg, shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _tables():
    return 1 + np.arange(B * NBLK).reshape(B, NBLK)


def _latent_cache(cfg, rows, T, seed):
    """A random dense latent cache, bf16 values, in both packages."""
    rng = np.random.default_rng(seed)
    xs = {n: rng.standard_normal((rows, T, w)).astype(np.float32)
          for n, w in (("ckv", cfg.kv_lora_rank),
                       ("krope", cfg.qk_rope_dim))}
    return ({n: jnp.asarray(x, jnp.bfloat16) for n, x in xs.items()},
            {n: torch.from_numpy(x).to(torch.bfloat16)
             for n, x in xs.items()})


# ---------------------------------------------------------------------------
# config, params and the numpy bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_and_param_count_equal_reference(smoke):
    get = "smoke" if smoke else "get"
    rcfg, pcfg = getattr(ref_configs, get)(ARCH), getattr(configs, get)(ARCH)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(rcfg)
    assert pcfg.param_count() == rcfg.param_count()
    assert pcfg.matmul_param_count() == rcfg.matmul_param_count()
    if not smoke:
        assert (pcfg.n_layers, pcfg.d_model, pcfg.kv_lora_rank,
                pcfg.qk_rope_dim) == (62, 2560, 256, 32)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csl"])
def test_convert_brings_every_factor_across(sparse):
    """Dense factors equal the reference's arrays; Tiled-CSL factors keep
    the reference's words byte for byte, their padded shape and nnz."""
    _, jparams, pcfg, pparams = _models(sparse, "float32")
    for i, layer in enumerate(pparams["layers"]):
        jattn, pattn = _layer(jparams, pparams, i)
        assert sorted(pattn) == sorted(FACTORS)
        for name in FACTORS:
            want, got = jattn[name]["w"], pattn[name]["w"]
            if not sparse:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
                continue
            assert isinstance(got, tiled_csl.TiledCSL)
            assert got.shape == tuple(want.shape)
            np.testing.assert_array_equal(
                got.words.numpy().view(np.uint32), np.asarray(want.words))
            np.testing.assert_array_equal(got.nnz.numpy(),
                                          np.asarray(want.nnz))
    if sparse:                  # 24 rows of [c_kv | k_rope] pad to a tile
        assert pparams["layers"][0]["attn"]["w_dkv"]["w"].shape == (128, 128)


def test_check_family_admits_mla_and_refuses_the_rest():
    """MLA is served, MoE with GQA attention, the hybrid family
    (recurrentgemma: RG-LRU and GQA blocks), a sliding window on GQA
    attention and the SSM, vlm and audio families (mamba2, qwen2-vl,
    musicgen); MoE with MLA, an SSM family without a state, M-RoPE and
    codebooks outside their families still raise
    ``NotImplementedError``, and so do a sliding window and an RG-LRU
    pattern with MLA (no reference config has either)."""
    cfg = configs.smoke(ARCH)
    transformer._check_family(cfg)
    transformer._check_family(configs.smoke("qwen3_moe_30b_a3b"))
    transformer.init_cache(ref_configs.smoke("recurrentgemma_9b"), 1, 8,
                           device="cpu")
    gqa = configs.smoke("tinyllama_1_1b")
    for ok in (dict(local_window=8),
               dict(family="hybrid", layer_pattern=("rglru", "attn"),
                    rnn_width=64)):
        transformer.init_model(dataclasses.replace(gqa, **ok), device="cpu")
    for arch in ("mamba2_130m", "qwen2_vl_2b", "musicgen_large"):
        transformer.init_cache(ref_configs.smoke(arch), 1, 8, device="cpu")
    for bad in (dict(n_routed_experts=4, top_k=2, d_expert=32),
                dict(family="moe", n_routed_experts=4, top_k=2,
                     d_expert=32),
                dict(local_window=8), dict(family="ssm"),
                dict(layer_pattern=("rglru", "attn")),
                dict(mrope_sections=(2, 1, 1)), dict(n_codebooks=2),
                dict(attn_kind="none")):
        with pytest.raises(NotImplementedError):
            transformer.init_model(dataclasses.replace(cfg, **bad),
                                   device="cpu")


def test_cache_layouts_equal_reference():
    cfg = configs.smoke(ARCH)
    rcfg = ref_configs.smoke(ARCH)
    dense = transformer.init_cache(cfg, 3, 20, device="cpu")
    paged = transformer.init_paged_cache(cfg, 7, 4, device="cpu")
    rdense = ref_tf.init_cache(rcfg, 3, 20)
    rpaged = ref_tf.init_paged_cache(rcfg, 7, 4)
    for got, want in ((dense, rdense), (paged, rpaged)):
        assert len(got) == cfg.n_layers
        for name in ("ckv", "krope"):
            assert got[0][name].dtype == torch.bfloat16
            assert tuple(got[0][name].shape) == tuple(want[name].shape[1:])


# ---------------------------------------------------------------------------
# one layer: prefill, decode, paged decode, verify
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [0, 8], ids=["whole", "q_chunked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csl"])
def test_mla_attention_matches_reference(sparse, dtype, chunk):
    """Prefill of 16 positions (two query chunks of 8 when chunked): the
    output within tolerance and the written latents within one bf16 ulp
    (each side rounds its own c_kv)."""
    rcfg, jparams, pcfg, pparams = _models(sparse, dtype)
    rcfg = dataclasses.replace(rcfg, attn_q_chunk=chunk)
    pcfg = dataclasses.replace(pcfg, attn_q_chunk=chunk)
    jp, pp = _layer(jparams, pparams)
    S = 16
    jx, px = _x(pcfg, (2, S), dtype, seed=1)
    positions = np.broadcast_to(np.arange(S), (2, S))
    rcache = ref_mla.init_mla_cache(rcfg, 2, S + 4)
    pcache = mla.init_mla_cache(pcfg, 2, S + 4, "cpu")
    want, rcache = ref_mla.mla_attention(jp, jx, jnp.asarray(positions),
                                         rcfg, cache=rcache)
    got, pcache = mla.mla_attention(pp, px, torch.from_numpy(
        positions.copy()), pcfg, cache=pcache)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))
    for name in ("ckv", "krope"):
        np.testing.assert_allclose(_f32(pcache[name]), _f32(rcache[name]),
                                   rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("pos_kind", ["int", "0d", "per_slot"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csl"])
def test_mla_decode_matches_reference(sparse, dtype, pos_kind):
    """Absorbed decode against one random latent cache: the output within
    tolerance, the written row within one bf16 ulp, every other row
    unchanged."""
    rcfg, jparams, pcfg, pparams = _models(sparse, dtype)
    jp, pp = _layer(jparams, pparams)
    jx, px = _x(pcfg, (B, 1), dtype, seed=2)
    rcache, pcache = _latent_cache(pcfg, B, 16, seed=3)
    before = {n: _f32(v) for n, v in pcache.items()}
    pos = {"int": 7, "0d": np.array(7), "per_slot": np.array([0, 7, 15])}[
        pos_kind]
    jpos = jnp.asarray(pos, jnp.int32)
    ppos = pos if pos_kind == "int" else torch.from_numpy(
        np.asarray(pos, np.int64))
    want, rcache = ref_mla.mla_decode(jp, jx, rcache, jpos, rcfg)
    got, pcache = mla.mla_decode(pp, px, pcache, ppos, pcfg)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))
    pos_vec = np.broadcast_to(np.asarray(pos), (B,))
    for name in ("ckv", "krope"):
        g, w = _f32(pcache[name]), _f32(rcache[name])
        np.testing.assert_allclose(g, w, rtol=2 ** -7, atol=1e-6)
        keep = np.ones(g.shape[:2], bool)
        keep[np.arange(B), pos_vec] = False
        np.testing.assert_array_equal(g[keep], before[name][keep])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csl"])
def test_mla_decode_paged_matches_reference(sparse, dtype):
    rcfg, jparams, pcfg, pparams = _models(sparse, dtype)
    jp, pp = _layer(jparams, pparams)
    jx, px = _x(pcfg, (B, 1), dtype, seed=4)
    pools = random_pools(pcfg, 1 + B * NBLK, BLOCK, seed=5)
    tables = _tables()
    pc, rc = port_cache(pools)[0], ref_cache(pools)
    want, rnew = ref_mla.mla_decode_paged(
        jp, jx, {n: rc[n][0] for n in rc}, jnp.asarray(tables, jnp.int32),
        jnp.asarray(POS, jnp.int32), rcfg)
    got, pnew = mla.mla_decode_paged(pp, px, pc, torch.from_numpy(tables),
                                     torch.from_numpy(POS), pcfg)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))
    for name in ("ckv", "krope"):
        np.testing.assert_allclose(_f32(pnew[name]), _f32(rnew[name]),
                                   rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csl"])
def test_mla_verify_paged_matches_reference(sparse, dtype):
    """A W = 4 window over the latent pools: the output within tolerance,
    the fresh ``[B, W, *]`` latents in the cache dtype within one bf16
    ulp, and the pools left as they were."""
    rcfg, jparams, pcfg, pparams = _models(sparse, dtype)
    jp, pp = _layer(jparams, pparams)
    jx, px = _x(pcfg, (B, W), dtype, seed=6)
    pools = random_pools(pcfg, 1 + B * NBLK, BLOCK, seed=7)
    tables = _tables()
    pc, rc = port_cache(pools), ref_cache(pools)
    before = port_np(pc)
    want, rfresh = ref_mla.mla_verify_paged(
        jp, jx, {n: rc[n][0] for n in rc}, jnp.asarray(tables, jnp.int32),
        jnp.asarray(POS, jnp.int32), rcfg)
    got, fresh = mla.mla_verify_paged(pp, px, pc[0], torch.from_numpy(tables),
                                      torch.from_numpy(POS), pcfg)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))
    for name, width in (("ckv", pcfg.kv_lora_rank),
                        ("krope", pcfg.qk_rope_dim)):
        assert fresh[name].dtype == torch.bfloat16
        assert tuple(fresh[name].shape) == (B, W, width)
        np.testing.assert_allclose(_f32(fresh[name]), _f32(rfresh[name]),
                                   rtol=2 ** -7, atol=1e-6)
    after = port_np(pc)
    for name in before:
        np.testing.assert_array_equal(after[name], before[name])


def test_verify_window_equals_decode_at_each_position():
    """Inside the port: window column i scores what plain paged decode at
    ``pos + i`` scores once columns 0..i-1 are written (f32, dense)."""
    _, _, pcfg, pparams = _models(False, "float32")
    pp = pparams["layers"][0]["attn"]
    _, px = _x(pcfg, (B, W), "float32", seed=8)
    pools = random_pools(pcfg, 1 + B * NBLK, BLOCK, seed=9)
    tables = torch.from_numpy(_tables()[:, :NBLK])
    pos = torch.tensor([1, 4, 9])
    y, _ = mla.mla_verify_paged(pp, px, port_cache(pools)[0], tables, pos,
                                pcfg)
    pc = port_cache(pools)[0]
    for i in range(W):
        yi, pc = mla.mla_decode_paged(pp, px[:, i:i + 1], pc, tables,
                                      pos + i, pcfg)
        np.testing.assert_allclose(yi[:, 0].numpy(), y[:, i].numpy(),
                                   **F32_TOL)


# ---------------------------------------------------------------------------
# cache helpers on latent pools
# ---------------------------------------------------------------------------

def test_commit_verify_window_on_latent_pools_is_bit_identical():
    """The same fresh latents committed by both packages where ``commit``
    says (rows past their table go to the trash block): every block,
    trash block aside, bit-identical to the reference's."""
    cfg = configs.smoke(ARCH)
    rcfg = ref_configs.smoke(ARCH)
    pools = random_pools(cfg, 1 + B * NBLK, BLOCK, seed=10)
    rng = np.random.default_rng(11)
    fresh = [{n: torch.from_numpy(rng.standard_normal(
        (B, W) + x.shape[2:]).astype(np.float32)).to(torch.bfloat16)
        for n, x in layer.items()} for layer in pools]
    commit = np.array([[1, 1, 1, 0], [1, 0, 0, 0], [1, 1, 1, 1]], bool)
    tables = _tables()
    pc = transformer.commit_verify_window(
        cfg, port_cache(pools), fresh, torch.from_numpy(tables),
        torch.from_numpy(POS), torch.from_numpy(commit))
    rfresh = {n: jnp.stack([jnp.asarray(f[n].float().numpy(), jnp.bfloat16)
                            for f in fresh]) for n in fresh[0]}
    rc = ref_tf.commit_verify_window(
        rcfg, ref_cache(pools), rfresh, jnp.asarray(tables, jnp.int32),
        jnp.asarray(POS, jnp.int32), jnp.asarray(commit))
    got, want = port_np(pc), ref_np(rc)
    assert set(got) == {"ckv", "krope"}
    for name in got:
        np.testing.assert_array_equal(got[name][:, 1:], want[name][:, 1:])
    assert not np.array_equal(got["ckv"], port_np(port_cache(pools))["ckv"])


def test_scatter_and_copy_on_latent_leaves_equal_reference():
    """``scatter_cache_slots``, ``scatter_cache_pages`` and
    ``copy_cache_block`` walk the latent leaves as the reference's do."""
    cfg = configs.smoke(ARCH)
    rcfg = dataclasses.replace(ref_configs.smoke(ARCH), n_layers=1,
                               scan_layers=False)
    rng = np.random.default_rng(12)
    widths = {"ckv": cfg.kv_lora_rank, "krope": cfg.qk_rope_dim}

    def rand(*lead):
        return {n: rng.standard_normal(lead + (w,)).astype(np.float32)
                for n, w in widths.items()}

    def port_tree(xs):
        return [{n: torch.from_numpy(x.copy()) for n, x in xs.items()}]

    def ref_tree(xs):
        return [{n: jnp.asarray(x) for n, x in xs.items()}]

    full, part, dense = rand(6, 4), rand(2, 7), rand(3, 12)
    bmap = np.array([3, 1, 5, 0], np.int64)
    got = transformer.scatter_cache_pages(cfg, port_tree(full),
                                          port_tree(part),
                                          torch.from_numpy(bmap))
    want = ref_tf.scatter_cache_pages(rcfg, ref_tree(full), ref_tree(part),
                                      jnp.asarray(bmap))
    got = transformer.copy_cache_block(cfg, got, 3, 4)
    want = ref_tf.copy_cache_block(rcfg, want, 3, 4)
    slots = np.array([2, 0], np.int64)
    got_s = transformer.scatter_cache_slots(cfg, port_tree(dense),
                                            port_tree(part),
                                            torch.from_numpy(slots))
    want_s = ref_tf.scatter_cache_slots(rcfg, ref_tree(dense),
                                        ref_tree(part), jnp.asarray(slots))
    for g, w in ((got, want), (got_s, want_s)):
        for name in widths:
            np.testing.assert_array_equal(g[0][name].numpy(),
                                          np.asarray(w[0][name]))


# ---------------------------------------------------------------------------
# the whole stack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csl"])
def test_forward_modes_match_reference(sparse, dtype):
    """``transformer.forward`` in prefill (cache written), paged decode at
    per-slot positions and verify: logits within tolerance, and each
    layer's fresh verify latents within one bf16 ulp in f32 (in bf16 a
    layer's input already differs by the bf16 tolerance)."""
    rcfg, jparams, pcfg, pparams = _models(sparse, dtype)
    tol = _tol(dtype)
    tokens = np.random.default_rng(13).integers(
        0, pcfg.vocab, (B, 9)).astype(np.int64)
    want, rcache, _ = ref_tf.forward(
        jparams, {"tokens": jnp.asarray(tokens, jnp.int32)}, rcfg,
        mode="prefill", cache=ref_tf.init_cache(rcfg, B, 16))
    with torch.inference_mode():
        got, pcache = transformer.forward(
            pparams, {"tokens": torch.from_numpy(tokens)}, pcfg,
            mode="prefill", cache=transformer.init_cache(pcfg, B, 16,
                                                         device="cpu"))
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)

    pools = random_pools(pcfg, 1 + B * NBLK, BLOCK, seed=14)
    tables = _tables()
    for mode, S in (("decode", 1), ("verify", W)):
        tok = tokens[:, :S]
        want, rout, _ = ref_tf.forward(
            jparams, {"tokens": jnp.asarray(tok, jnp.int32)}, rcfg,
            mode=mode, cache=ref_cache(pools),
            pos=jnp.asarray(POS, jnp.int32),
            block_tables=jnp.asarray(tables, jnp.int32))
        with torch.inference_mode():
            got, pout = transformer.forward(
                pparams, {"tokens": torch.from_numpy(tok)}, pcfg, mode=mode,
                cache=port_cache(pools), pos=torch.from_numpy(POS),
                block_tables=torch.from_numpy(tables))
        np.testing.assert_allclose(_f32(got), _f32(want), **tol)
        if mode == "verify":            # fresh [B, W, *] latents per layer
            ftol = dict(rtol=2 ** -7, atol=1e-6) if dtype == "float32" \
                else tol
            for i, layer in enumerate(pout):
                for name in ("ckv", "krope"):
                    np.testing.assert_allclose(
                        _f32(layer[name]), _f32(rout[name][i]), **ftol)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csl"])
def test_greedy_streams_equal_reference(sparse):
    """f32 greedy ``generate`` (prefill, then absorbed decode), every
    factor Tiled-CSL or none: identical tokens."""
    rcfg, jparams, pcfg, pparams = _models(sparse, "float32")
    prompt = np.random.default_rng(15).integers(
        0, pcfg.vocab, (2, 7)).astype(np.int32)
    want = np.asarray(ref_engine.generate(jparams, jnp.asarray(prompt), rcfg,
                                          max_new_tokens=6))
    got = engine.generate(pparams, torch.from_numpy(prompt).long(), pcfg,
                          max_new_tokens=6).numpy()
    np.testing.assert_array_equal(got, want)


def _to_ref(pparams):
    """Port params as the reference holds them: layers stacked, every
    tensor in its own dtype, Tiled-CSL words as uint32."""
    def leaf(x):
        if isinstance(x, tiled_csl.TiledCSL):
            return ref_tiled_csl.TiledCSL(
                words=jnp.asarray(x.words.numpy().view(np.uint32)),
                nnz=jnp.asarray(x.nnz.numpy()), shape=x.shape, m_tb=x.m_tb,
                k_tb=x.k_tb, dtype=jnp.dtype(str(x.dtype).split(".")[-1]))
        if isinstance(x, dict):
            return {k: leaf(v) for k, v in x.items()}
        if x.dtype == torch.bfloat16:
            return jnp.asarray(x.float().numpy(), jnp.bfloat16)
        return jnp.asarray(x.numpy())
    out = {k: leaf(v) for k, v in pparams.items() if k != "layers"}
    out["layers"] = jax.tree.map(lambda *xs: jnp.stack(xs),
                                 *[leaf(p) for p in pparams["layers"]])
    return out


def test_served_build_keeps_reference_arithmetic():
    """``serve.build``'s minicpm3 params (bf16 compute, wo and the MLP in
    Tiled-CSL, the latent factors dense, the build's casts) through
    prefill, dense decode, paged decode and verify: bit-equal to the same
    params as drawn (f32, uncast), as the reference's launcher holds them,
    and within the bf16 tolerance of the reference on those. ``w_ukv``
    stays f32: the absorbed steps read it there, as the reference does."""
    pcfg, rcfg = configs.smoke(ARCH), ref_configs.smoke(ARCH)
    assert pcfg.dtype == "bfloat16"
    built, _ = serve.build(pcfg, seed=5, sparsity=0.8, device="cpu")
    drawn = pruning.group_projections(pruning.sparsify_params(
        transformer.init_model(pcfg, seed=5, device="cpu"), 0.8,
        should_sparsify=serve._sparse_path))
    for got, want in zip(built["layers"], drawn["layers"]):
        w = got["attn"]["w_ukv"]["w"]
        assert w.dtype == torch.float32
        assert torch.equal(w, want["attn"]["w_ukv"]["w"])
    jparams = _to_ref(drawn)
    tokens = np.random.default_rng(16).integers(
        0, pcfg.vocab, (B, 9)).astype(np.int64)
    pools = random_pools(pcfg, 1 + B * NBLK, BLOCK, seed=17)
    tables = _tables()

    def port(params, mode, tok, cache, **kw):
        with torch.inference_mode():
            return transformer.forward(params, {"tokens": tok}, pcfg,
                                       mode=mode, cache=cache, **kw)

    want, rcache, _ = ref_tf.forward(
        jparams, {"tokens": jnp.asarray(tokens, jnp.int32)}, rcfg,
        mode="prefill", cache=ref_tf.init_cache(rcfg, B, 16))
    got, gcache = port(built, "prefill", torch.from_numpy(tokens),
                       transformer.init_cache(pcfg, B, 16, device="cpu"))
    same, dcache = port(drawn, "prefill", torch.from_numpy(tokens),
                        transformer.init_cache(pcfg, B, 16, device="cpu"))
    runs = [("prefill", got, same, want)]
    tok = tokens[:, :1]
    want, _, _ = ref_tf.forward(
        jparams, {"tokens": jnp.asarray(tok, jnp.int32)}, rcfg,
        mode="decode", cache=rcache, pos=jnp.asarray(POS, jnp.int32))
    got, _ = port(built, "decode", torch.from_numpy(tok), gcache,
                  pos=torch.from_numpy(POS))
    same, _ = port(drawn, "decode", torch.from_numpy(tok), dcache,
                   pos=torch.from_numpy(POS))
    runs.append(("decode", got, same, want))
    for mode, S in (("decode", 1), ("verify", W)):
        tok = tokens[:, :S]
        want, _, _ = ref_tf.forward(
            jparams, {"tokens": jnp.asarray(tok, jnp.int32)}, rcfg,
            mode=mode, cache=ref_cache(pools),
            pos=jnp.asarray(POS, jnp.int32),
            block_tables=jnp.asarray(tables, jnp.int32))
        kw = dict(pos=torch.from_numpy(POS),
                  block_tables=torch.from_numpy(tables))
        got, _ = port(built, mode, torch.from_numpy(tok), port_cache(pools),
                      **kw)
        same, _ = port(drawn, mode, torch.from_numpy(tok), port_cache(pools),
                       **kw)
        runs.append((f"paged {mode}", got, same, want))
    for name, got, same, want in runs:
        assert got.dtype == torch.bfloat16, name
        assert torch.equal(got, same), name
        np.testing.assert_allclose(_f32(got), _f32(want), **BF16_TOL,
                                   err_msg=name)


def test_cli_serves_minicpm3_paged_with_speculation(capsys):
    """``--arch minicpm3_4b`` through ``serve.main`` on the CPU: the
    layer-by-layer sparse build (wo and the MLP in Tiled-CSL, the latent
    factors dense), the planner-sized paged pool, and the speculative
    verify over the latent pool."""
    rep = serve.main(["--arch", ARCH, "--smoke", "--sparsity", "0.8",
                      "--paged", "--hbm-budget-gb", "0.02", "--spec-k", "2",
                      "--requests", "3", "--slots", "2", "--max-new", "4",
                      "--max-len", "32"], device="cpu")
    out = capsys.readouterr().out
    assert "as built" in out and "speculative (k=2" in out
    assert len(rep["responses"]) == 3
    attn = rep["server"].batcher.params["layers"][0]["attn"]
    assert isinstance(attn["wo"]["w"], tiled_csl.TiledCSL)
    assert all(isinstance(attn[n]["w"], torch.Tensor)
               for n in ("w_dq", "w_uq", "w_dkv", "w_ukv"))
    assert rep["plan"].weight_bytes != rep["weight_bytes"]
