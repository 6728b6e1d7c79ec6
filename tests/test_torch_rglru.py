"""The hybrid family (RG-LRU + local attention) and the sliding-window ring
in the port, against the reference, on two smoke configs:
recurrentgemma-9b's (3 layers cycling rglru, rglru, attn; window 32) and
tinyllama's with ``local_window`` 16 (the dense GQA family with a ring,
as the reference's own ring tests use it).

Reference params come through ``convert`` and inputs are made from a
seed with numpy. Held to the reference on the same inputs:
``rglru_block`` at lengths that are not powers of two and
``rglru_decode`` from a carried state; local-attention prefill longer
than the window in the whole and the q-chunked branch, with the rolled
cache; dense ring decode past the wrap; paged ring decode; the verify
window's ring mask, attention and commit; ``transformer.forward`` in
prefill and decode; greedy streams through both packages' batchers with
exact-length admission and the ring wrapping; and ``serve.build`` bit for
bit. Tolerances: f32 within ``rtol = atol = 1e-4`` where the RG-LRU scan
runs (the port's doubling scan associates the products in another order
than ``jax.lax.associative_scan``), ``1e-3`` for attention over many
positions (``ATTN_TOL``), ``1e-5`` elsewhere; bf16 within ``3e-2``, the
whole stack's logits within ``6e-2`` (``BF16_FWD_TOL``); cache writes in
bf16 within one bf16 ulp.
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
from repro.models import attention as ref_attention
from repro.models import rglru as ref_rglru
from repro.models import transformer as ref_tf
from repro.serving import batching as ref_batching
from repro_torch import configs, convert
from repro_torch.core import pruning, tiled_csl
from repro_torch.launch import serve
from repro_torch.models import attention, rglru, transformer
from repro_torch.serving import batching, budget, engine
from torch_parity import models, should_sparsify, step_logits
from torch_serving_parity import assert_streams_agree, prompts_of
from torch_window_parity import (BF16_ULP, port_cache, port_np,
                                 random_pools, ref_cache, ref_np)

HYB = "recurrentgemma_9b"
SCAN_TOL = dict(rtol=1e-4, atol=1e-4)      # f32 through the RG-LRU scan
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# f32 attention over more than a few positions: both packages round K/V
# to bf16, and an f32 difference of one ulp in a projection can flip that
# rounding, which moves an output by up to about 1e-4 (test_torch_slice's
# tolerance).
ATTN_TOL = dict(rtol=1e-3, atol=1e-3)
# bf16 logits of the whole stack on a 45-token prompt: each package rounds
# its bf16 products on its own, and the residual stream carries the
# differences through every layer. On these smoke configs both packages'
# bf16 logits sit up to 0.09 from the reference's f32 logits, and up to
# 0.04 from each other (3e-2 is the repo's bound for 2 layers at 9 tokens).
BF16_FWD_TOL = dict(rtol=6e-2, atol=6e-2)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
WINDOW = 16                                # the tinyllama ring's window
DTYPES = ("float32", "bfloat16")


def _win(cfg):
    return dataclasses.replace(cfg, local_window=WINDOW)


@functools.lru_cache(maxsize=None)
def _models(arch, sparsity, dtype):
    """(rcfg, jparams, pcfg, pparams); the tinyllama pair with the ring."""
    rcfg, jparams, pcfg, pparams = models(arch, sparsity, dtype)
    if arch != HYB:
        rcfg, pcfg = _win(rcfg), _win(pcfg)
    return rcfg, jparams, pcfg, pparams


def _tol(dtype, scan=False):
    if dtype == "bfloat16":
        return BF16_TOL
    return SCAN_TOL if scan else F32_TOL


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _x(cfg, shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _close(got, want, tol):
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


# ---------------------------------------------------------------------------
# config, params, caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_and_param_count_equal_reference(smoke):
    get = "smoke" if smoke else "get"
    rcfg, pcfg = getattr(ref_configs, get)(HYB), getattr(configs, get)(HYB)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(rcfg)
    assert pcfg.param_count() == rcfg.param_count()
    assert [pcfg.layer_kind(i) for i in range(pcfg.n_layers)] == \
        [rcfg.layer_kind(i) for i in range(rcfg.n_layers)]
    if not smoke:
        kinds = [pcfg.layer_kind(i) for i in range(pcfg.n_layers)]
        assert (kinds.count("rglru"), kinds.count("attn")) == (26, 12)
        assert not transformer.uses_scan(pcfg)


@pytest.mark.parametrize("sparsity", [None, 0.8], ids=["dense", "csl"])
def test_init_rglru_through_convert(sparsity):
    """The reference's unrolled stack comes across layer by layer: every
    leaf's path, shape and bits, the projections' Tiled-CSL words byte for
    byte; the port's own ``init_model`` draws the same tree."""
    rcfg, jparams, pcfg, pparams = _models(HYB, sparsity, "float32")
    own = transformer.init_model(pcfg, seed=0, device="cpu")
    assert len(pparams["layers"]) == len(own["layers"]) == 3
    for i, (got, mine) in enumerate(zip(pparams["layers"], own["layers"])):
        kind = pcfg.layer_kind(i)
        assert sorted(got) == sorted(mine) == sorted(
            ["pre_norm", kind, "mlp_norm", "mlp"])
        if not sparsity:                  # the sparse tree is grouped
            assert [(p, tuple(t.shape)) for p, t in sorted(_walk(got))] == \
                [(p, tuple(t.shape)) for p, t in sorted(_walk(mine))]
        want = jparams["layers"][i]
        for path, leaf in _walk(got):
            ref = functools.reduce(lambda t, k: t[k], path, want)
            if isinstance(leaf, tiled_csl.TiledCSL):
                np.testing.assert_array_equal(
                    leaf.words.numpy().view(np.uint32),
                    np.asarray(ref.words))
            else:
                np.testing.assert_array_equal(leaf.numpy(), np.asarray(ref))
    p = pparams["layers"][0]["rglru"]
    assert p["wa"]["w"].shape == (pcfg.rnn_dim, pcfg.rnn_dim)
    assert p["conv_w"].shape == (pcfg.rglru_conv, pcfg.rnn_dim)
    if sparsity:         # the launchers' list: the MLP, not the RG-LRU
        assert isinstance(pparams["layers"][0]["mlp"]["gate_up"]["w"],
                          tiled_csl.TiledCSL)
        assert isinstance(p["w_x"]["w"], torch.Tensor)


def _walk(tree, path=()):
    if isinstance(tree, dict):
        return [pv for k, v in tree.items() for pv in _walk(v, path + (k,))]
    return [(path, tree)]


@pytest.mark.parametrize("arch", [HYB, "tinyllama_1_1b"])
def test_cache_layouts_equal_reference(arch):
    """Dense caches leaf for leaf (the ring capped at the window, RG-LRU
    state in f32); the paged cache refused for a recurrent stack, with the
    reference's error, and capped by the ring in its table width."""
    rcfg, _, pcfg, _ = _models(arch, None, "float32")
    for max_len in (8, 64):
        got = transformer.init_cache(pcfg, 3, max_len, device="cpu")
        want = ref_tf.init_cache(rcfg, 3, max_len)
        if isinstance(want, dict):                # scan-stacked [L, ...]
            want = [jax.tree.map(lambda a: a[i], want)
                    for i in range(rcfg.n_layers)]
        assert len(got) == len(want) == pcfg.n_layers
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for n in g:
                assert tuple(g[n].shape) == tuple(w[n].shape)
                assert str(g[n].dtype).split(".")[-1] == str(w[n].dtype)
        assert transformer.paged_blocks_per_seq(pcfg, max_len, 4) == \
            ref_tf.paged_blocks_per_seq(rcfg, max_len, 4)
    state = transformer.state_leaves(pcfg, got)
    assert len(state) == 2 * sum(pcfg.layer_kind(i) == "rglru"
                                 for i in range(pcfg.n_layers))
    assert all(t.dtype == torch.float32 for t in state)
    if arch == HYB:
        with pytest.raises(ValueError, match="pure-attention"):
            transformer.init_paged_cache(pcfg, 5, 4, device="cpu")
        with pytest.raises(ValueError, match="pure-attention"):
            ref_tf.init_paged_cache(rcfg, 5, 4)


# ---------------------------------------------------------------------------
# the RG-LRU block
# ---------------------------------------------------------------------------

def _rglru_params(jparams, pparams, i=0):
    return jparams["layers"][i]["rglru"], pparams["layers"][i]["rglru"]


def _state(cfg, rows, seed):
    """A random carried RG-LRU state, f32, in both packages."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((rows, cfg.rnn_dim)).astype(np.float32)
    conv = rng.standard_normal(
        (rows, cfg.rglru_conv - 1, cfg.rnn_dim)).astype(np.float32)
    return ({"h": jnp.asarray(h), "conv": jnp.asarray(conv)},
            {"h": torch.from_numpy(h), "conv": torch.from_numpy(conv)})


@pytest.mark.parametrize("L", [1, 7, 45])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_block_matches_reference(dtype, L):
    """Prefill from a fresh cache at lengths that are neither powers of
    two nor chunk multiples (one shorter than the conv): output and the
    written state (final ``h`` and the last ``conv - 1`` inputs)."""
    rcfg, jparams, pcfg, pparams = _models(HYB, None, dtype)
    jp, pp = _rglru_params(jparams, pparams, 1)
    jx, px = _x(pcfg, (2, L), dtype, seed=L)
    want, wcache = ref_rglru.rglru_block(
        jp, jx, rcfg, cache=ref_rglru.init_rglru_cache(rcfg, 2))
    pcache = rglru.init_rglru_cache(pcfg, 2, "cpu")
    got, gcache = rglru.rglru_block(pp, px, pcfg, cache=pcache)
    assert gcache is pcache                       # written in place
    assert got.dtype == px.dtype
    _close(got, want, _tol(dtype, scan=True))
    for n in ("h", "conv"):
        _close(gcache[n], wcache[n], _tol(dtype, scan=True))
    got_nc, none = rglru.rglru_block(pp, px, pcfg)
    assert none is None
    torch.testing.assert_close(got_nc, got, rtol=0, atol=0)


def test_linear_scan_is_the_sequential_recurrence():
    """The doubling scan against the recurrence run one position at a
    time, in f64, at a length past a power of two."""
    rng = np.random.default_rng(4)
    B, L, r = 2, 37, 5
    log_a = torch.from_numpy(-rng.uniform(0.01, 3.0, (B, L, r)))
    gx = torch.from_numpy(rng.standard_normal((B, L, r)))
    h0 = torch.from_numpy(rng.standard_normal((B, r)))
    y, last = rglru._linear_scan(log_a, gx, h0)
    h, want = h0, []
    for t in range(L):
        h = torch.exp(log_a[:, t]) * h + gx[:, t]
        want.append(h)
    torch.testing.assert_close(y, torch.stack(want, 1), rtol=1e-12,
                               atol=1e-12)
    torch.testing.assert_close(last, want[-1], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_decode_matches_reference(dtype):
    """Three decode steps from a random carried state: each step's output
    and the state it leaves, written in place."""
    rcfg, jparams, pcfg, pparams = _models(HYB, None, dtype)
    jp, pp = _rglru_params(jparams, pparams)
    jc, pc = _state(pcfg, 3, seed=5)
    for step in range(3):
        jx, px = _x(pcfg, (3, 1), dtype, seed=10 + step)
        want, jc = ref_rglru.rglru_decode(jp, jx, jc, rcfg)
        got, out = rglru.rglru_decode(pp, px, pc, pcfg)
        assert out is pc
        _close(got, want, _tol(dtype))
        for n in ("h", "conv"):
            _close(pc[n], jc[n], _tol(dtype))


# ---------------------------------------------------------------------------
# local attention: prefill, the dense and paged ring, the verify window
# ---------------------------------------------------------------------------

def _attn_params(jparams, pparams, arch, i):
    if arch == HYB:
        return jparams["layers"][i]["attn"], pparams["layers"][i]["attn"]
    return (jax.tree.map(lambda a: a[i], jparams["layers"]["attn"]),
            pparams["layers"][i]["attn"])


ATTN_LAYER = {HYB: 2, "tinyllama_1_1b": 0}


@pytest.mark.parametrize("q_chunk", [0, 8], ids=["whole", "q-chunked"])
@pytest.mark.parametrize("S", [12, 45])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", [HYB, "tinyllama_1_1b"])
def test_local_attention_prefill_matches_reference(arch, dtype, S, q_chunk):
    """Prefill with the window mask in the whole-scores and the q-chunked
    branch; past the window (S = 45) the cache takes the trailing window
    rolled to its residues, which must hold the reference's K/V."""
    rcfg, jparams, pcfg, pparams = _models(arch, None, dtype)
    rcfg = dataclasses.replace(rcfg, attn_q_chunk=q_chunk)
    pcfg = dataclasses.replace(pcfg, attn_q_chunk=q_chunk)
    jp, pp = _attn_params(jparams, pparams, arch, ATTN_LAYER[arch])
    jx, px = _x(pcfg, (2, S), dtype, seed=S)
    pos = np.broadcast_to(np.arange(S), (2, S))
    want, wcache = ref_attention.attention(
        jp, jx, jnp.asarray(pos, jnp.int32), rcfg,
        cache=ref_attention.init_cache(rcfg, 2, S))
    pcache = attention.init_cache(pcfg, 2, S, "cpu")
    assert pcache["k"].shape[1] == min(S, pcfg.local_window)
    got, gcache = attention.attention(pp, px, torch.from_numpy(pos.copy()),
                                      pcfg, cache=pcache)
    _close(got, want, ATTN_TOL if dtype == "float32" else BF16_TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(_f32(gcache[n]), _f32(wcache[n]),
                                   rtol=BF16_ULP, atol=1e-6)


def _kv_cache(cfg, rows, T, seed):
    rng = np.random.default_rng(seed)
    xs = {n: rng.standard_normal((rows, T, cfg.n_kv, cfg.head_dim)).astype(
        np.float32) for n in ("k", "v")}
    return ({n: jnp.asarray(x, jnp.bfloat16) for n, x in xs.items()},
            {n: torch.from_numpy(x).to(torch.bfloat16)
             for n, x in xs.items()})


# per-row positions: before the window fills, at it, and past the wrap
RING_POS = np.array([3, 16, 37, 70], np.int64)


@pytest.mark.parametrize("uniform", [False, True], ids=["per-row", "0-d"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", [HYB, "tinyllama_1_1b"])
def test_dense_ring_decode_matches_reference(arch, dtype, uniform):
    """Decode against a full ring: the write at ``pos % W`` and the
    age mask, at a per-row position past the wrap and at a shared one."""
    rcfg, jparams, pcfg, pparams = _models(arch, None, dtype)
    jp, pp = _attn_params(jparams, pparams, arch, ATTN_LAYER[arch])
    W = pcfg.local_window
    jc, pc = _kv_cache(pcfg, len(RING_POS), W, seed=6)
    jx, px = _x(pcfg, (len(RING_POS), 1), dtype, seed=7)
    pos = RING_POS * (2 if arch == HYB else 1)
    if uniform:
        jpos, ppos = jnp.asarray(pos[2], jnp.int32), torch.tensor(pos[2])
    else:
        jpos, ppos = jnp.asarray(pos, jnp.int32), torch.from_numpy(pos)
    want, wcache = ref_attention.attention_decode(jp, jx, jc, jpos, rcfg)
    got, gcache = attention.attention_decode(pp, px, pc, ppos, pcfg)
    _close(got, want, _tol(dtype))
    for n in ("k", "v"):
        np.testing.assert_allclose(_f32(gcache[n]), _f32(wcache[n]),
                                   rtol=BF16_ULP, atol=1e-6)


RING_LEN, BLOCK, NBLK = WINDOW, 4, 4          # the tinyllama ring, paged


def _ring_tables(rows):
    return 1 + np.arange(rows * NBLK).reshape(rows, NBLK)


@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_ring_decode_matches_reference(dtype):
    """Paged decode on the ring: position p written at ``p % ring_len``
    of the row's blocks, the age mask over the gather; every block of
    the pool as the reference leaves it; without ``ring_len`` both
    packages raise."""
    rcfg, jparams, pcfg, pparams = _models("tinyllama_1_1b", None, dtype)
    jp, pp = _attn_params(jparams, pparams, "tinyllama_1_1b", 0)
    rows = len(RING_POS)
    pools = random_pools(pcfg, 1 + rows * NBLK, BLOCK, seed=8)
    tables = _ring_tables(rows)
    jx, px = _x(pcfg, (rows, 1), dtype, seed=9)
    pc, rc = port_cache(pools), ref_cache(pools)
    want, wcache = ref_attention.attention_decode_paged(
        jp, jx, {n: rc[n][0] for n in ("k", "v")},
        jnp.asarray(tables, jnp.int32), jnp.asarray(RING_POS, jnp.int32),
        rcfg, ring_len=RING_LEN)
    got, _ = attention.attention_decode_paged(
        pp, px, pc[0], torch.from_numpy(tables), torch.from_numpy(RING_POS),
        pcfg, ring_len=RING_LEN)
    _close(got, want, _tol(dtype))
    for n in ("k", "v"):
        np.testing.assert_allclose(pc[0][n].float().numpy(), _f32(wcache[n]),
                                   rtol=BF16_ULP, atol=1e-6)
    with pytest.raises(ValueError, match="ring_len"):
        attention.attention_decode_paged(
            pp, px, pc[0], torch.from_numpy(tables),
            torch.from_numpy(RING_POS), pcfg)


@pytest.mark.parametrize("ring", [4, 16])
@pytest.mark.parametrize("W", [1, 4])
def test_verify_window_mask_ring_matches_reference(W, ring):
    pos = np.array([0, 3, 7, 12, 16, 21, 40], np.int64)
    T_old = -(-ring // 4) * 4                       # whole blocks of 4
    got = attention.verify_window_mask(torch.from_numpy(pos), W, T_old,
                                       ring_len=ring)
    want = ref_attention.verify_window_mask(
        jnp.asarray(pos, jnp.int32), W, T_old, ring)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


VERIFY_W = 4
VERIFY_POS = np.array([5, 14, 37], np.int64)  # within, across, past the wrap


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_verify_paged_ring_matches_reference(dtype):
    """A verify window over the ring: output, fresh K/V in the cache
    dtype, the pool untouched; without ``ring_len`` both packages
    raise."""
    rcfg, jparams, pcfg, pparams = _models("tinyllama_1_1b", None, dtype)
    jp, pp = _attn_params(jparams, pparams, "tinyllama_1_1b", 0)
    rows = len(VERIFY_POS)
    pools = random_pools(pcfg, 1 + rows * NBLK, BLOCK, seed=11)
    tables = _ring_tables(rows)
    jx, px = _x(pcfg, (rows, VERIFY_W), dtype, seed=12)
    pc, rc = port_cache(pools), ref_cache(pools)
    before = port_np(pc)
    args = (jnp.asarray(tables, jnp.int32),
            jnp.asarray(VERIFY_POS, jnp.int32), rcfg)
    want, wfresh = ref_attention.attention_verify_paged(
        jp, jx, {n: rc[n][0] for n in ("k", "v")}, *args, ring_len=RING_LEN)
    got, gfresh = attention.attention_verify_paged(
        pp, px, pc[0], torch.from_numpy(tables),
        torch.from_numpy(VERIFY_POS), pcfg, ring_len=RING_LEN)
    _close(got, want, _tol(dtype))
    for n in ("k", "v"):
        assert gfresh[n].dtype == torch.bfloat16
        np.testing.assert_allclose(_f32(gfresh[n]), _f32(wfresh[n]),
                                   rtol=BF16_ULP, atol=1e-6)
        np.testing.assert_array_equal(port_np(pc)[n], before[n])
    with pytest.raises(ValueError, match="ring_len"):
        attention.attention_verify_paged(
            pp, px, pc[0], torch.from_numpy(tables),
            torch.from_numpy(VERIFY_POS), pcfg)
    with pytest.raises(ValueError, match="ring_len"):
        ref_attention.attention_verify_paged(
            jp, jx, {n: rc[n][0] for n in ("k", "v")}, *args)


def test_commit_verify_window_ring_matches_reference():
    """The ring commit: accepted columns land at ``(pos + j) % ring_len``,
    rejected ones in the trash block; every block of every layer as the
    reference leaves it, bit for bit (the fresh K/V are the same bf16
    values on both sides)."""
    rcfg, _, pcfg, _ = _models("tinyllama_1_1b", None, "float32")
    rows = len(VERIFY_POS)
    pools = random_pools(pcfg, 1 + rows * NBLK, BLOCK, seed=13)
    tables = _ring_tables(rows)
    fresh = random_pools(pcfg, rows, VERIFY_W, seed=14)
    commit = np.array([[1, 1, 0, 0], [1, 1, 1, 1], [1, 0, 0, 0]], bool)
    pc = port_cache(pools)
    transformer.commit_verify_window(
        pcfg, pc, port_cache(fresh), torch.from_numpy(tables),
        torch.from_numpy(VERIFY_POS), torch.from_numpy(commit),
        ring_len=RING_LEN)
    rc = ref_tf.commit_verify_window(
        rcfg, ref_cache(pools), ref_cache(fresh),
        jnp.asarray(tables, jnp.int32), jnp.asarray(VERIFY_POS, jnp.int32),
        jnp.asarray(commit), ring_len=RING_LEN)
    got, want = port_np(pc), ref_np(rc)
    for n in ("k", "v"):
        np.testing.assert_array_equal(got[n][:, 1:], want[n][:, 1:])
    # row 2 (position 37 -> residue 5): block 1 of its table, offset 1
    for i in range(pcfg.n_layers):
        np.testing.assert_array_equal(got["k"][i, tables[2, 1], 1],
                                      fresh[i]["k"][2, 0])


# ---------------------------------------------------------------------------
# the whole stack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch,sparsity", [(HYB, None), (HYB, 0.8),
                                           ("tinyllama_1_1b", None)])
def test_forward_matches_reference(arch, sparsity, dtype):
    """``engine.prefill`` (``transformer.forward`` in prefill) of a prompt
    longer than the window, and the first decode step, at a position
    past the wrap, against the reference (jitted, as its batcher runs
    it); the hybrid dense and with its projections in Tiled-CSL."""
    rcfg, jparams, pcfg, pparams = _models(arch, sparsity, dtype)
    prompt = np.random.default_rng(15).integers(
        0, pcfg.vocab, (3, 45)).astype(np.int32)
    tol = ATTN_TOL if dtype == "float32" else BF16_FWD_TOL
    for got_want in step_logits(rcfg, jparams, pcfg, pparams, prompt, 64,
                                jit=True):
        want, got = got_want
        np.testing.assert_allclose(got, want, **tol)


def _run(batcher_cls, params, cfg, prompts, max_new, **kw):
    b = batcher_cls(params, cfg, **kw)
    for uid, (p, n) in enumerate(zip(prompts, max_new)):
        b.submit(uid, p, max_new_tokens=n)
    out = b.run_to_completion(max_steps=2000)
    assert len(out) == len(prompts)
    if b.paged:
        b.pool.check_invariants()
        assert b.pool.blocks_in_use == 0
    return b, out


# Hybrid: exact-length admission, prompts past the window and decode
# across the wrap at max_len 64 > window 32. Ring: prompts within the
# window, decode across it at max_len 48.
STREAMS = {HYB: dict(lengths=[5, 40, 20, 33, 5], new=[30, 12, 20, 16, 6],
                     max_len=64, sparsity=0.8),
           "tinyllama_1_1b": dict(lengths=[3, 9, 12, 16], new=[20] * 4,
                                  max_len=48, sparsity=None)}


@pytest.mark.parametrize("arch", [HYB, "tinyllama_1_1b"])
def test_batcher_streams_match_reference(arch):
    """Greedy streams through both packages' ``ContinuousBatcher`` (three
    slots, slot reuse) under the near-tie rule; the hybrid admits at
    exact-length buckets, one prefill shape per distinct length."""
    case = STREAMS[arch]
    rcfg, jparams, pcfg, pparams = _models(arch, case["sparsity"], "float32")
    prompts = prompts_of(pcfg, case["lengths"], seed=16)
    kw = dict(n_slots=3, max_len=case["max_len"])
    rb, want = _run(ref_batching.ContinuousBatcher, jparams, rcfg, prompts,
                    case["new"], **kw)
    pb, got = _run(batching.ContinuousBatcher, pparams, pcfg, prompts,
                   case["new"], **kw)
    assert_streams_agree(pparams, pcfg, dict(enumerate(prompts)), got, want)
    assert pb.ring_len == rb.ring_len == min(case["max_len"],
                                             pcfg.local_window)
    assert pb.metrics.bucket_admits == rb.metrics.bucket_admits
    assert pb.prefill_compiles == len(pb.stepper.prefill_shapes)
    if arch == HYB:
        assert pb.buckets is None
        assert set(pb.metrics.bucket_admits) == set(case["lengths"])
        assert {s[1] for s in pb.stepper.prefill_shapes} == \
            set(case["lengths"])
    assert max(len(p) + n for p, n in zip(prompts, case["new"])) \
        > pb.ring_len                        # some stream wraps the ring
    assert pb.slots == [None] * 3


def test_batcher_refusals_match_reference():
    """Chunked prefill on a ring, a verify window longer than the ring,
    and the paged cache on a recurrent stack raise, as in the
    reference."""
    _, _, pcfg, pparams = _models("tinyllama_1_1b", None, "float32")
    with pytest.raises(ValueError, match="sliding-window"):
        batching.ContinuousBatcher(pparams, pcfg, n_slots=2, max_len=32,
                                   cache_kind="paged", chunked_prefill=True)
    small = dataclasses.replace(pcfg, local_window=4)
    with pytest.raises(ValueError, match="ring"):
        batching.ContinuousBatcher(pparams, small, n_slots=2, max_len=32,
                                   cache_kind="paged", block_size=4,
                                   n_blocks=8, spec_k=4)
    _, _, hcfg, hparams = _models(HYB, None, "float32")
    with pytest.raises(ValueError, match="pure-attention"):
        batching.ContinuousBatcher(hparams, hcfg, n_slots=2, max_len=32,
                                   cache_kind="paged", block_size=4)


def test_spec_greedy_parity_sliding_window_ring():
    """The port of the reference's ring test: verify windows against a
    ring must not clobber still-valid older residues with rejected
    entries; decode drives every request past the wrap and the paged
    speculative streams equal the dense plain ones."""
    _, _, pcfg, pparams = _models("tinyllama_1_1b", None, "float32")
    prompts = prompts_of(pcfg, [3, 9, 12], seed=3)
    _, want = _run(batching.ContinuousBatcher, pparams, pcfg, prompts,
                   [16] * 3, n_slots=2, max_len=48)
    bs, got = _run(batching.ContinuousBatcher, pparams, pcfg, prompts,
                   [16] * 3, n_slots=2, max_len=48, cache_kind="paged",
                   block_size=8, n_blocks=10, spec_k=4)
    assert got == want
    assert bs.metrics.drafted > 0
    _, paged = _run(batching.ContinuousBatcher, pparams, pcfg, prompts,
                    [16] * 3, n_slots=2, max_len=48, cache_kind="paged",
                    block_size=8, n_blocks=10)
    assert paged == want


def test_ring_with_a_bucket_past_the_window_follows_reference():
    """A prompt whose length bucket exceeds the window: the prefill rolls
    the bucket's trailing window, pad positions included, over real ones
    (ROADMAP queue 3). The port keeps the reference's streams."""
    rcfg, jparams, pcfg, pparams = _models("tinyllama_1_1b", None,
                                           "float32")
    prompts = prompts_of(pcfg, [20], seed=17)
    kw = dict(n_slots=1, max_len=64)
    _, want = _run(ref_batching.ContinuousBatcher, jparams, rcfg, prompts,
                   [6], **kw)
    _, got = _run(batching.ContinuousBatcher, pparams, pcfg, prompts, [6],
                  **kw)
    assert_streams_agree(pparams, pcfg, {0: prompts[0]}, got, want)
    alone = engine.generate(pparams, torch.from_numpy(prompts[0][None]),
                            pcfg, max_new_tokens=6, max_len=64)
    assert alone[0, 20:].tolist() != got[0]          # the fault shows


# ---------------------------------------------------------------------------
# the build, the planner and the CLI
# ---------------------------------------------------------------------------

def _to_ref_layout(tree):
    """The port's dense params as the reference's unrolled tree (jnp)."""
    if isinstance(tree, dict):
        return {k: _to_ref_layout(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_ref_layout(v) for v in tree]
    return jnp.asarray(tree.numpy())


def _assert_same(a, b, path=""):
    if isinstance(a, tiled_csl.TiledCSL):
        assert isinstance(b, tiled_csl.TiledCSL), path
        assert (a.shape, a.m_tb, a.k_tb, a.group) == \
            (b.shape, b.m_tb, b.k_tb, b.group), path
        assert torch.equal(a.words, b.words), path
        assert torch.equal(a.nnz, b.nnz), path
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}['{k}']")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    else:
        assert a.dtype == b.dtype and torch.equal(a, b), path


@pytest.mark.parametrize("sparsity", [0.8, 0.95])
def test_build_equals_reference_bit_for_bit(sparsity):
    """``serve.build`` layer by layer against the reference's
    ``sparsify_params`` + ``group_projections`` over the whole unrolled
    tree drawn by the port's ``init_model``: every leaf keeps its own
    ``max_nnz`` (the reference pads only scan-stacked leaves), the MLP
    groups into ``gate_up``, ``wq`` does not group with ``wk``/``wv``,
    ``wa`` stays f32 and the other dense matrices are cast to bf16. Six
    layers with a 1024-wide MLP, where the layers' own ``max_nnz``
    differ."""
    cfg = dataclasses.replace(configs.smoke(HYB), n_layers=6, d_ff=1024)
    got, rep = serve.build(cfg, seed=3, sparsity=sparsity, device="cpu")
    drawn = transformer.init_model(cfg, seed=3, device="cpu")
    jsparse = ref_pruning.group_projections(ref_pruning.sparsify_params(
        _to_ref_layout(drawn), sparsity,
        should_sparsify=lambda n: should_sparsify(n)))
    want = convert.params_from_numpy(jax.tree.map(np.asarray, jsparse),
                                     device="cpu")
    want["embed"]["table"] = want["embed"]["table"].to(torch.bfloat16)
    want["lm_head"]["w"] = want["lm_head"]["w"].to(torch.bfloat16)
    for layer in want["layers"]:
        for part in layer.values():
            for name, sub in part.items():
                if isinstance(sub, dict) and isinstance(
                        sub.get("w"), torch.Tensor) \
                        and name not in serve.KEEP_AS_DRAWN:
                    sub["w"] = sub["w"].to(torch.bfloat16)
    _assert_same(got, want)
    for i, layer in enumerate(got["layers"]):
        assert "gate_up" in layer["mlp"] and "gate" not in layer["mlp"]
        if cfg.layer_kind(i) == "attn":
            assert "wqkv" not in layer["attn"]    # MQA: wk, wv mostly pad
        else:
            assert layer["rglru"]["wa"]["w"].dtype == torch.float32
            assert layer["rglru"]["w_x"]["w"].dtype == torch.bfloat16
    assert rep["n_tiled_csl"] > 0
    own = {}
    for layer in got["layers"]:
        for path, t in pruning.tiled_csl_paths(layer):
            own.setdefault(path, set()).add(t.max_nnz)
    assert any(len(v) > 1 for v in own.values())   # unpadded: layers differ


def test_planner_refuses_the_hybrid_as_the_reference():
    """Weight bytes in every mode equal the reference's; the plan and
    the block bytes raise its pure-attention ``ValueError``."""
    from repro.serving import budget as ref_budget
    for get in ("get", "smoke"):
        rcfg, pcfg = getattr(ref_configs, get)(HYB), getattr(configs, get)(HYB)
        for mode in budget.WEIGHT_MODES:
            assert budget.weight_bytes(pcfg, mode, 0.8) == \
                ref_budget.weight_bytes(rcfg, mode, 0.8)
        for mod, cfg in ((budget, pcfg), (ref_budget, rcfg)):
            with pytest.raises(ValueError, match="pure-attention"):
                mod.plan(cfg, hbm_budget=80e9, weight_mode="sparse_pallas",
                         block=16)


def test_cli_serves_the_hybrid_and_refuses_paged():
    """``--arch recurrentgemma_9b`` serves through ``StreamingServer``
    (dense cache, exact-length admission); ``--paged`` raises as the
    reference's launcher does."""
    argv = ["--arch", HYB, "--smoke", "--sparsity", "0.8", "--requests",
            "3", "--slots", "2", "--max-new", "4", "--max-len", "48"]
    rep = serve.main(argv, device="cpu")
    assert len(rep["responses"]) == 3
    assert all(len(r.tokens) == 4 for r in rep["responses"])
    assert rep["server"].batcher.buckets is None
    with pytest.raises(ValueError, match="pure-attention"):
        serve.main(argv + ["--paged"], device="cpu")
