"""Mixture-of-Experts (``repro_torch.models.moe``) against the reference's
``repro.models.moe``, on the qwen2-moe-a2.7b and qwen3-moe-30b-a3b smoke
configs.

Reference params come through ``convert``, the routed expert stacks
dense or in stacked Tiled-CSL (each layer's ``[E, f, d]`` stack encoded
per expert by the reference's ``sparsify_params``, the layers re-padded
to one ``max_nnz`` and stacked for its scan), and inputs are made from a
seed with numpy. ``moe_block``, ``transformer.forward`` in prefill,
paged decode and paged verify, and greedy streams are held to the
reference's on the same inputs, at the smoke configs' dropless capacity
factor (4.0) and at 1.0, where tokens are dropped. f32 results agree
within ``rtol = atol = 1e-5``, bf16 within ``3e-2``; expert words are
byte-equal, greedy streams identical.
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
from repro.core import tiled_csl as ref_tiled_csl
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tf
from repro.serving import engine as ref_engine
from repro_torch import configs, convert
from repro_torch.core import pruning, sparse_linear, tiled_csl
from repro_torch.kernels import ops, ref
from repro_torch.models import moe, transformer
from repro_torch.serving import engine
from torch_parity import should_sparsify
from torch_window_parity import port_cache, random_pools, ref_cache

ARCHS = ("qwen2_moe_a2_7b", "qwen3_moe_30b_a3b")
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# Whole-model f32 logits: K/V are stored in bf16 even in f32 configs, and
# the two packages' layer inputs differ in the last f32 bits, so a K/V
# element near a bf16 rounding boundary rounds apart and moves a few
# logits by up to about 1e-3 (test_torch_slice.py's F32_TOL).
MODEL_F32_TOL = dict(rtol=1e-3, atol=1e-3)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
EXPERT_STACKS = ("gate", "up", "down")
SPARSITY = 0.8
B, BLOCK, NBLK, W = 3, 4, 4, 4
POS = np.array([5, 2, 11], np.int64)


def _cfgs(arch, dtype="float32", cf=None):
    kw = dict(dtype=dtype)
    if cf is not None:
        kw["capacity_factor"] = cf
    return (dataclasses.replace(ref_configs.smoke(arch), **kw),
            dataclasses.replace(configs.smoke(arch), **kw))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _ref_stack_csl(stack):
    """A reference expert stack ``[E, f, d]`` in Tiled-CSL, as the
    reference's ``sparsify_params`` encodes a 3-D leaf."""
    return ref_pruning.sparsify_params({"x": stack}, SPARSITY,
                                       should_sparsify=lambda n: True)["x"]


def _ref_sparse_experts(moe_params):
    """The scan-stacked ``[L, E, f, d]`` routed stacks as scan-stacked
    Tiled-CSL ``words [L, E, mt, kt, w]``: each layer's stack encoded per
    expert, the layers re-padded to one ``max_nnz``."""
    out = dict(moe_params)
    for name in EXPERT_STACKS:
        per = [_ref_stack_csl(s) for s in moe_params[name]]
        mx = max(t.max_nnz for t in per)
        out[name] = ref_tiled_csl.TiledCSL(
            words=jnp.stack([jnp.pad(t.words, ((0, 0),) * 3
                                     + ((0, mx - t.max_nnz),)) for t in per]),
            nnz=jnp.stack([t.nnz for t in per]), shape=per[0].shape,
            m_tb=per[0].m_tb, k_tb=per[0].k_tb, dtype=per[0].dtype)
    return out


@functools.lru_cache(maxsize=None)
def _params(arch, sparse):
    """(jparams, pparams) of the smoke config, f32; ``sparse``: the
    attention, the shared expert and the routed stacks in Tiled-CSL at
    0.8. The compute dtype and the capacity factor are the config's."""
    jparams = ref_tf.init_model(jax.random.PRNGKey(0), _cfgs(arch)[0])
    if sparse:
        jparams = ref_pruning.group_projections(ref_pruning.sparsify_params(
            jparams, SPARSITY, should_sparsify=should_sparsify))
        layers = dict(jparams["layers"])
        layers["moe"] = _ref_sparse_experts(layers["moe"])
        jparams = dict(jparams, layers=layers)
    pparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    return jparams, pparams


def _models(arch, sparse, dtype="float32", cf=None):
    """(rcfg, jparams, pcfg, pparams)."""
    rcfg, pcfg = _cfgs(arch, dtype, cf)
    jparams, pparams = _params(arch, sparse)
    return rcfg, jparams, pcfg, pparams


def _x(cfg, shape, seed=3):
    return np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)


# ---------------------------------------------------------------------------
# params, the bridge, the encoding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_moe_shapes_and_param_count(arch):
    """The port's ``init_model`` draws the reference's leaves, shape for
    shape (the router ``[E, d]``, the stacks ``[E, f, d]``/``[E, d, f]``,
    the fused shared SwiGLU), and their sizes sum to ``param_count``."""
    rcfg, pcfg = _cfgs(arch)
    jp = ref_tf.init_model(jax.random.PRNGKey(0), rcfg)
    pp = transformer.init_model(pcfg, seed=0, device="cpu")
    want = {jax.tree_util.keystr(k): v.shape[1:] for k, v in
            jax.tree_util.tree_leaves_with_path(jp["layers"])}
    for layer in pp["layers"]:
        got = {p: tuple(t.shape) for p, t in pruning._walk(layer)}
        assert got == want
    m = pp["layers"][0]["moe"]
    assert tuple(m["router"]["w"].shape) == (pcfg.n_routed_experts,
                                             pcfg.d_model)
    assert ("shared" in m) == bool(pcfg.n_shared_experts)
    total = sum(t.numel() for path, t in pruning._walk(pp)
                if not path.endswith(("['scale']", "['b']")))  # norms, biases
    assert total == pcfg.param_count() == rcfg.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_bridge_and_expert_words_byte_equal(arch):
    """Scan-stacked ``[L, E, ...]`` leaves split into per-layer dicts; the
    reference's Tiled-CSL expert stacks come across as expert stacks
    with the same bits, equal to the port's own encoding of the same
    dense stacks (``sparsify_params`` on a 3-D leaf), router dense."""
    _, jdense, _, pdense = _models(arch, False)
    _, jsparse, _, psparse = _models(arch, True)
    mine = pruning.group_projections(pruning.sparsify_params(
        pdense, SPARSITY, should_sparsify=lambda n: should_sparsify(n)
        or any(f"['moe']['{s}']" in n and not n.endswith("]['w']")
               for s in EXPERT_STACKS)))
    for i in range(len(pdense["layers"])):
        dm, sm, om = (p["layers"][i]["moe"] for p in (pdense, psparse, mine))
        np.testing.assert_array_equal(
            dm["gate"].numpy(), np.asarray(jdense["layers"]["moe"]["gate"][i]))
        assert isinstance(dm["router"]["w"], torch.Tensor)
        for name in EXPERT_STACKS:
            t = sm[name]
            assert t.stack and t.group is None and t.experts == \
                dm[name].shape[0]
            ref_t = jsparse["layers"]["moe"][name]
            np.testing.assert_array_equal(
                t.words.numpy().view(np.uint32), np.asarray(ref_t.words[i]))
            np.testing.assert_array_equal(t.nnz.numpy(),
                                          np.asarray(ref_t.nnz[i]))
            own = _ref_stack_csl(jdense["layers"]["moe"][name][i])
            assert om[name].stack
            np.testing.assert_array_equal(
                om[name].words.numpy().view(np.uint32),
                np.asarray(own.words))
        if "shared" in sm:        # the shared expert's gate/up do group
            assert "gate_up" in sm["shared"] and "gate_up" in om["shared"]


def test_encode_stack_pads_to_the_stack_max():
    """Experts of unequal density: ``encode_stack`` gives each expert the
    reference's per-expert words, padded to the largest ``max_nnz``, and
    decodes back to the pruned stack."""
    rng = np.random.default_rng(4)
    w = rng.standard_normal((3, 256, 128)).astype(np.float32)
    w[1] *= rng.random((256, 128)) < 0.05            # a sparser expert
    w[2, :128] = 0.0                                 # an empty tile row
    want = _ref_stack_csl(jnp.asarray(w))
    got = pruning.sparsify_matrix(torch.from_numpy(w), SPARSITY)
    assert got.stack and got.experts == 3
    np.testing.assert_array_equal(got.words.numpy().view(np.uint32),
                                  np.asarray(want.words))
    np.testing.assert_array_equal(got.nnz.numpy(), np.asarray(want.nnz))
    dense = tiled_csl.decode(got)
    for e in range(3):
        np.testing.assert_array_equal(
            dense[e].numpy(), tiled_csl.decode(
                tiled_csl.expert_slice(got, e)).numpy())


def test_group_projections_leaves_expert_stacks_alone():
    """Bare ``gate``/``up`` stacks under ``moe`` are no projection pair:
    they stay two expert stacks; a ``{"w": ...}`` pair groups."""
    rng = np.random.default_rng(5)
    st = [pruning.sparsify_matrix(torch.from_numpy(rng.standard_normal(
        (4, 128, 128)).astype(np.float32)), SPARSITY) for _ in range(2)]
    pair = [pruning.sparsify_matrix(torch.from_numpy(rng.standard_normal(
        (128, 128)).astype(np.float32)), SPARSITY) for _ in range(2)]
    tree = {"moe": {"gate": st[0], "up": st[1],
                    "shared": {"gate": {"w": pair[0]}, "up": {"w": pair[1]}}}}
    out = pruning.group_projections(tree)["moe"]
    assert out["gate"] is st[0] and out["up"] is st[1]
    assert sorted(out["shared"]) == ["gate_up"]
    with pytest.raises(ValueError):
        tiled_csl.group_stack(st)


def test_expert_stack_refused_by_grouped_and_single_ops():
    """An expert stack is neither a projection group nor one weight: the
    grouped and single-weight ops refuse it, ``spmm_batched`` takes it."""
    rng = np.random.default_rng(6)
    t = pruning.sparsify_matrix(torch.from_numpy(rng.standard_normal(
        (2, 128, 128)).astype(np.float32)), SPARSITY)
    b = torch.from_numpy(rng.standard_normal((128, 5)).astype(np.float32))
    for fn in (ops.spmm_grouped, ops.spmm):
        with pytest.raises(ValueError, match="expert stack"):
            fn(t, b)
    with pytest.raises(ValueError):
        sparse_linear.linear_grouped(t, b.T, declared_outs=(128, 128))
    with pytest.raises(ValueError, match="expert stack"):
        ops.spmm_batched(tiled_csl.expert_slice(t, 0), b[None])
    assert ops.spmm_batched(t, torch.stack([b, b])).shape == (2, 128, 5)


@pytest.mark.parametrize("split_k", [1, 3])
def test_spmm_batched_plain_version_is_the_loop(split_k):
    """``spmm_batched``'s plain version (the CPU path) equals a loop of
    ``spmm_ref`` / ``spmm_splitk_ref`` over the experts, and the
    reference's vmapped plain version, in f32 and bf16."""
    rng = np.random.default_rng(7)
    w = rng.standard_normal((4, 256, 384)).astype(np.float32)
    t = pruning.sparsify_matrix(torch.from_numpy(w), SPARSITY)
    rt = _ref_stack_csl(jnp.asarray(w))
    x = rng.standard_normal((4, 384, 6)).astype(np.float32)
    for dt in (torch.float32, torch.bfloat16):
        b = torch.from_numpy(x).to(dt)
        got = (ops.spmm_batched(t, b) if split_k == 1 else
               ref.spmm_splitk_batched_ref(t, b, split_k, out_dtype=dt))
        loop = torch.stack([
            ref.spmm_splitk_ref(tiled_csl.expert_slice(t, e), b[e], split_k,
                                out_dtype=dt) for e in range(4)])
        assert torch.equal(got, loop)
    from repro.kernels import ref as ref_kernels
    want = jax.vmap(lambda wd, nz, xb: ref_kernels.spmm_ref(
        ref_tiled_csl.TiledCSL(words=wd, nnz=nz, shape=rt.shape,
                               m_tb=rt.m_tb, k_tb=rt.k_tb, dtype=rt.dtype),
        xb))(rt.words, rt.nnz, jnp.asarray(x))
    np.testing.assert_allclose(_f32(ops.spmm_batched(t, torch.from_numpy(x))),
                               _f32(want), **F32_TOL)


# ---------------------------------------------------------------------------
# moe_block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [None, 1.0], ids=["dropless", "cf1"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csl"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_reference(arch, sparse, dtype, cf):
    """``moe_block`` on the reference's layer-0 params and one input of 4
    x 16 tokens: output and aux loss. At capacity factor 1.0 every
    expert takes C = 4 of a subgroup's 64 tokens, so tokens are
    dropped, and the routes must still agree."""
    rcfg, jparams, pcfg, pparams = _models(arch, sparse, dtype, cf)
    rp = jax.tree.map(lambda a: a[0], jparams["layers"]["moe"])
    pp = pparams["layers"][0]["moe"]
    x = _x(pcfg, (4, 16))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want, waux = ref_moe.moe_block(rp, jnp.asarray(x, jdt), rcfg)
    with torch.inference_mode():
        got, gaux = moe.moe_block(pp, torch.from_numpy(x).to(
            getattr(torch, dtype)), pcfg)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    np.testing.assert_allclose(float(gaux), float(waux), **tol)
    if cf == 1.0:                   # some expert is picked past capacity
        E, k = pcfg.n_routed_experts, pcfg.top_k
        logits = torch.from_numpy(x).reshape(64, -1) @ \
            pp["router"]["w"].float().T
        picks = torch.topk(logits, k, dim=-1).indices
        C = int(-(-64 * k // E) * 1.0)
        assert int(torch.bincount(picks.reshape(-1), minlength=E).max()) > C


def test_subgroup_refusals_match_reference():
    """B * S tokens that do not split into whole subgroups: the reference
    asserts, the port raises, in ``moe_block``, in a prefill bucket
    (3 x 8 tokens, subgroups of 16), at decode (3 slots, subgroups of 2)
    and in a verify window (3 x 2, subgroups of 4)."""
    arch = "qwen3_moe_30b_a3b"
    _, jparams, _, pparams = _models(arch, False)
    rcfg, pcfg = _cfgs(arch)
    rp = jax.tree.map(lambda a: a[0], jparams["layers"]["moe"])
    for sg, shape in ((16, (3, 8)), (2, (3, 1)), (4, (3, 2))):
        rc = dataclasses.replace(rcfg, moe_subgroup=sg)
        pc = dataclasses.replace(pcfg, moe_subgroup=sg)
        x = _x(pc, shape)
        with pytest.raises(AssertionError):
            ref_moe.moe_block(rp, jnp.asarray(x), rc)
        with pytest.raises(ValueError, match="subgroups"):
            moe.moe_block(pparams["layers"][0]["moe"], torch.from_numpy(x),
                          pc)
    rc = dataclasses.replace(rcfg, moe_subgroup=16)
    pc = dataclasses.replace(pcfg, moe_subgroup=16)
    tokens = np.zeros((3, 8), np.int32)
    with pytest.raises(AssertionError):
        ref_engine.prefill(jparams, jnp.asarray(tokens), rc, 16)
    with pytest.raises(ValueError, match="subgroups"):
        engine.prefill(pparams, torch.from_numpy(tokens).long(), pc, 16)


# ---------------------------------------------------------------------------
# the whole stack
# ---------------------------------------------------------------------------

def _tables():
    return 1 + np.arange(B * NBLK, dtype=np.int64).reshape(B, NBLK)


def _kv_flips(port_kv, ref_kv):
    """Per-layer ``(k, v)`` pairs ``[B, S, kv, hd]`` of both packages: each
    element within one bf16 ulp (each side rounds its own f32 value), and
    the ``[B, S]`` positions where some layer's K or V rounded apart."""
    flips = None
    for pk, rk in zip(port_kv, ref_kv):
        for a, b in zip(pk, rk):
            np.testing.assert_allclose(a, b, rtol=2 ** -7, atol=1e-6)
            diff = (a != b).reshape(a.shape[:2] + (-1,)).any(-1)
            flips = diff if flips is None else flips | diff
    return flips


def _assert_logits(got, want, flips):
    """Logits ``[B, S, V]`` at ``MODEL_F32_TOL``, but from a row's first
    K/V rounding flip on, where an input of the attention differs by a
    bf16 ulp, at ``BF16_TOL``."""
    after = np.cumsum(flips, axis=1) > 0
    g, w = _f32(got), _f32(want)
    np.testing.assert_allclose(g[~after], w[~after], **MODEL_F32_TOL)
    np.testing.assert_allclose(g[after], w[after], **BF16_TOL)


@pytest.mark.parametrize("cf", [None, 1.0], ids=["dropless", "cf1"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csl"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_modes_match_reference(arch, sparse, cf):
    """``transformer.forward`` in prefill (cache written), paged decode at
    per-slot positions and a paged verify window of 4, f32: the K/V each
    writes or returns within one bf16 ulp, the logits within
    ``MODEL_F32_TOL`` up to a K/V rounding flip (``_assert_logits``)."""
    rcfg, jparams, pcfg, pparams = _models(arch, sparse, "float32", cf)
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
    flips = _kv_flips(
        [(_f32(c["k"])[:, :9], _f32(c["v"])[:, :9]) for c in pcache],
        [(_f32(rcache["k"][i])[:, :9], _f32(rcache["v"][i])[:, :9])
         for i in range(len(pcache))])
    _assert_logits(got, want, flips)

    pools = random_pools(pcfg, 1 + B * NBLK, BLOCK, seed=14)
    tables = _tables()
    rows = np.arange(B)
    phys, off = tables[rows, POS // BLOCK], POS % BLOCK
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
        n = len(pout)
        if mode == "decode":    # the token each row wrote into its block
            port_kv = [tuple(_f32(c[x])[phys, off][:, None] for x in "kv")
                       for c in pout]
            ref_kv = [tuple(_f32(rout[x][i])[phys, off][:, None]
                            for x in "kv") for i in range(n)]
        else:                   # the window's fresh K/V
            port_kv = [(_f32(c["k"]), _f32(c["v"])) for c in pout]
            ref_kv = [(_f32(rout["k"][i]), _f32(rout["v"][i]))
                      for i in range(n)]
        _assert_logits(got, want, _kv_flips(port_kv, ref_kv))


@pytest.mark.parametrize("cf", [None, 1.0], ids=["dropless", "cf1"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csl"])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_streams_equal_reference(arch, sparse, cf):
    """f32 greedy ``generate`` (prefill of 2 x 7, then decode): identical
    tokens."""
    rcfg, jparams, pcfg, pparams = _models(arch, sparse, "float32", cf)
    prompt = np.random.default_rng(15).integers(
        0, pcfg.vocab, (2, 7)).astype(np.int32)
    want = np.asarray(ref_engine.generate(jparams, jnp.asarray(prompt), rcfg,
                                          max_new_tokens=6))
    got = engine.generate(pparams, torch.from_numpy(prompt).long(), pcfg,
                          max_new_tokens=6).numpy()
    np.testing.assert_array_equal(got, want)


def test_idle_rows_decode_alike_dense_and_paged():
    """A decode step with two idle rows (token 0 at position 0, as the
    stepper feeds them) ahead of two live ones, capacity factor 1.0 and
    one subgroup, so the idle rows' routes take capacity from the live
    ones. Against the dense cache each idle row reads its own fresh K/V;
    against the paged pool all idle rows write the trash block, and each
    must still read its own, or the live rows' logits differ between the
    two caches. All four rows' logits must be equal."""
    _, _, pcfg, pparams = _models("qwen3_moe_30b_a3b", False, "float32", 1.0)
    n_slots = 4
    pools = random_pools(pcfg, 1 + n_slots * NBLK, BLOCK, seed=22)
    paged = port_cache(pools)
    tables = np.zeros((n_slots, NBLK), np.int64)          # idle: trash
    tables[2:] = 1 + np.arange(2 * NBLK).reshape(2, NBLK)
    dense = []
    for layer in paged:                                    # same contents
        d = {}
        for name, pool in layer.items():
            rows = pool[torch.from_numpy(tables)].reshape(
                (n_slots, NBLK * BLOCK) + tuple(pool.shape[2:]))
            d[name] = rows.clone()
        dense.append(d)
    tok = torch.tensor([[0], [0], [31], [7]])
    pos = torch.tensor([0, 0, 9, 13])
    with torch.inference_mode():
        got_d, _ = transformer.forward(pparams, {"tokens": tok}, pcfg,
                                       mode="decode", cache=dense, pos=pos)
        got_p, _ = transformer.forward(
            pparams, {"tokens": tok}, pcfg, mode="decode", cache=paged,
            pos=pos, block_tables=torch.from_numpy(tables))
    np.testing.assert_array_equal(got_p.numpy(), got_d.numpy())
