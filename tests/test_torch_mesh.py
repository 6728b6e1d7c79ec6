"""The port's tensor-parallel serving on a host mesh, against the
reference's unsharded engine, on the CPU.

Four gloo ranks (``launch.mesh.run_world``, ``device="cpu"``) on meshes
2x2 and 1x4 serve widened smoke configs of OPT (MHA, GELU, biases,
grouped ``wqkv``) and tinyllama (GQA, SwiGLU, grouped ``gate_up``; its
two-tile ``wk``/``wv`` stay whole at model = 4, where the rule leaves
them whole), in f32 and bf16, dense and at sparsity 0.8 (pruned and
encoded whole by ``convert.rank_params_from_numpy``, then sharded):

* prefill and first decode-step logits against the reference's
  unsharded ``engine.prefill``/``serve_step`` within the slice tests'
  tolerances (``tests/test_torch_slice.py`` f32 1e-3,
  ``test_torch_slice_bf16.py`` bf16 3e-2);
* greedy streams equal to the reference's, up to the first step whose
  top-2 margin (on the port's own stream) is below that tolerance, and
  every rank's stream the same;
* ``serve.build(..., mesh=)`` equal, leaf for leaf and bit for bit, to
  the shard of the unsharded build, and the ranks' encoded non-zeros
  summing to the whole model's;
* refusals: every family outside the dense GQA family, a model axis that
  does not split the heads, and the paged cache under a mesh raise,
  naming ROADMAP.md queue 1 item 14.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_worlds as worlds
from repro import configs as ref_configs
from repro.core import pruning as ref_pruning
from repro.models import transformer as ref_tf
from repro.serving import engine as ref_engine
from repro_torch import configs
from repro_torch.launch import mesh as mesh_mod

TOL = {"float32": 1e-3, "bfloat16": 3e-2}
MAX_NEW = 5
ARCHS = ("opt_30b", "tinyllama_1_1b")
CASES = [(arch, dtype, sparsity) for arch in ARCHS
         for dtype in ("float32", "bfloat16") for sparsity in (None, 0.8)]

_PREFILL = jax.jit(ref_engine.prefill, static_argnums=(2, 3))
_STEP = jax.jit(ref_engine.serve_step, static_argnums=(4,))


def _prompt():
    return np.random.default_rng(17).integers(0, 256, (3, 9)).astype(
        np.int32)


@functools.lru_cache(maxsize=None)
def _ref_params(arch, sparsity):
    rcfg = worlds.wide(ref_configs.smoke(arch), arch, "float32")
    jparams = ref_tf.init_model(jax.random.PRNGKey(0), rcfg)
    dense = jax.tree.map(np.asarray, jparams)
    if sparsity:
        jparams = ref_pruning.group_projections(ref_pruning.sparsify_params(
            jparams, sparsity, should_sparsify=worlds.should_sparsify))
    return dense, jparams


@functools.lru_cache(maxsize=None)
def _ref_serve(arch, dtype, sparsity):
    """The reference's prefill and first-step logits and greedy stream."""
    rcfg = worlds.wide(ref_configs.smoke(arch), arch, dtype)
    _, jparams = _ref_params(arch, sparsity)
    prompt = _prompt()
    S = prompt.shape[1]
    last, cache = _PREFILL(jparams, jnp.asarray(prompt), rcfg, S + MAX_NEW)
    f32 = lambda x: np.asarray(jnp.asarray(x, jnp.float32))
    first = f32(last)
    toks = [prompt]
    tok = np.asarray(jnp.argmax(last, -1))[:, None]
    step = None
    for i in range(MAX_NEW):
        toks.append(tok)
        if i == MAX_NEW - 1:
            break
        last, cache = _STEP(jparams, cache, jnp.asarray(tok),
                            jnp.array(S + i, jnp.int32), rcfg)
        step = f32(last) if step is None else step
        tok = np.asarray(jnp.argmax(last, -1))[:, None]
    return first, step, np.concatenate(toks, axis=1)


def _serve_world(shape):
    cases = [(f"{a}-{d}-{s}", a, d, s, _ref_params(a, s)[0])
             for a, d, s in CASES]
    return mesh_mod.run_world(worlds.serve_world, shape, device="cpu",
                              args=(cases, _prompt(), MAX_NEW,
                                    shape[1] == 4))


@pytest.fixture(scope="module")
def world_2x2():
    return _serve_world((2, 2))


@pytest.fixture(scope="module")
def world_1x4():
    return _serve_world((1, 4))


def _near_tie_step(steps, tol):
    for i, lg in enumerate(steps):
        top = np.sort(lg, axis=-1)[:, -2:]
        if np.any(top[:, 1] - top[:, 0] < tol):
            return i
    return None


@pytest.mark.parametrize("arch,dtype,sparsity", CASES)
@pytest.mark.parametrize("world", ("world_2x2", "world_1x4"))
def test_sharded_serving_matches_reference(world, arch, dtype, sparsity,
                                           request):
    results = request.getfixturevalue(world)
    key = f"{arch}-{dtype}-{sparsity}"
    first, step, want_tok = _ref_serve(arch, dtype, sparsity)
    tol = TOL[dtype]
    got = [r["serve"][key] for r in results]
    for g in got:
        np.testing.assert_array_equal(g["tokens"], got[0]["tokens"])
        np.testing.assert_array_equal(g["prefill"], got[0]["prefill"])
    g = got[0]
    np.testing.assert_allclose(g["prefill"], first, rtol=tol, atol=tol)
    np.testing.assert_allclose(g["step"], step, rtol=tol, atol=tol)
    S = _prompt().shape[1]
    tie = _near_tie_step(g["steps"], tol)
    upto = S + (MAX_NEW if tie is None else tie)
    np.testing.assert_array_equal(g["tokens"][:, :upto], want_tok[:, :upto])
    assert g["tokens"].shape == want_tok.shape


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world", ("world_2x2", "world_1x4"))
def test_build_under_a_mesh_is_the_shard_of_the_build(world, arch,
                                                      request):
    results = request.getfixturevalue(world)
    model = 4 if world == "world_1x4" else 2
    nnz = 0
    for r in results[:model]:                 # data row 0: the model ranks
        b = r["build"][arch]
        assert b["equal"] and all(b["equal"].values()), \
            [p for p, ok in b["equal"].items() if not ok]
        assert not b["extra"]
        nnz += b["nnz_split"]
    assert nnz + results[0]["build"][arch]["nnz_whole_leaves"] == \
        results[0]["build"][arch]["nnz_unsharded"]


def _splits_four_ways(cfg) -> bool:
    return (cfg.family == "dense" and cfg.attn_kind == "gqa"
            and cfg.n_heads % 4 == 0 and cfg.d_ff % 4 == 0
            and (cfg.n_kv % 4 == 0 or 4 % cfg.n_kv == 0))


def test_refusals_name_the_queue_item(world_1x4):
    msgs = world_1x4[0]["refusals"]
    want = {a for a in configs.ARCH_IDS
            if not _splits_four_ways(configs.smoke(a))}
    assert "opt_30b" not in want and "tinyllama_1_1b" not in want
    want |= {"tinyllama_1_1b_kv3", "paged"}
    assert set(msgs) == want, sorted(msgs)
    for arch, msg in msgs.items():
        assert "ROADMAP.md queue 1 item 14" in msg, (arch, msg)
