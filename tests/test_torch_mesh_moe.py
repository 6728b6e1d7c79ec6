"""The port's MoE family under a host mesh, against the reference's
unsharded engine, on the CPU.

gloo ranks (``launch.mesh.run_world``, ``device="cpu"``) serve the
qwen3-moe and qwen2-moe smoke configs (qwen2-moe's two shared experts
widened to 128 each, so the fused 256-wide shared SwiGLU splits by whole
128-row tiles) from the reference's numpy params, dense and at sparsity
0.8 (the attention, the shared expert and every layer's routed stacks
pruned and encoded whole by ``convert.rank_params_from_numpy``, then
cut to the rank's shard):

* here, 1x2 and 1x4: expert parallelism (8 experts, 4 or 2 a rank);
  on 1x2 also qwen2-moe's own 192-wide shared expert, whose Tiled-CSL
  rows pad to two tiles, one a rank;
* in ``tests/test_torch_mesh_moe_data.py``, 1x4 with 6 experts, which
  do not divide 4: tensor parallelism inside each expert (column shares
  of ``gate``/``up``, a row share of ``down``); and 2x2: the batch of 4
  over ``data``; at capacity factor 1.0 (tokens dropped) every subgroup
  spans both data ranks (the prefill's 44 tokens and the decode step's
  4), and with ``moe_subgroup`` 11 the prefill's subgroups lie inside a
  rank while the decode step's spans both.

Held against the reference's unsharded ``engine.prefill`` and
``serve_step`` (per-slot positions, teacher-forced with the reference's
first tokens) within the slice tests' tolerances (f32 1e-3, bf16 3e-2;
``tests/test_torch_mesh.py``; a row whose bf16 K/V cache differs from the
reference's at all is held at the bf16 tolerance, the rule of
``tests/test_torch_seqshard.py``: the unsharded port rounds such K/V
elements apart too), the ranks' cache blocks put together within the
bf16 tolerance of the reference's cache, every rank's stream the same;
in f32 the greedy streams identical to the reference's and every
token's experts and capacity positions (so the dropped assignments)
equal to the reference's, token by token. The bf16 reference runs op by
op (``jax.disable_jit``), as ``tests/test_torch_moe.py``'s does. ``serve.build(..., mesh=)`` is the
shard of the unsharded build bit for bit, the ranks' non-zeros summing
to the whole model's.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_worlds as worlds
from repro import configs as ref_configs
from repro.core import pruning as ref_pruning
from repro.core import sparse_linear as ref_sparse_linear
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tf
from repro.serving import engine as ref_engine
from repro_torch.launch import mesh as mesh_mod
from test_torch_moe import _ref_sparse_experts

TOL = {"float32": 1e-3, "bfloat16": 3e-2}
PROMPT_LEN, MAX_NEW = 11, 5
MAX_LEN = PROMPT_LEN + MAX_NEW
STEP_POS = np.array([11, 9, 10, 11], np.int64)
SHARED = (("d_shared_expert", 128),)
BASE = {"qwen3_moe_30b_a3b": (), "qwen2_moe_a2_7b": SHARED}
ARCHS = tuple(BASE)


def _over(arch, **kw):
    return tuple(sorted(dict(BASE[arch], **kw).items()))


# (name, arch, dtype, sparsity, overrides) by world
# bf16 on qwen2-moe (routed and shared experts) only: the reference's
# op-by-op bf16 run takes 10-25 s a config on one core
EP = [(f"{a}-{d}-{s}", a, d, s, _over(a)) for a in ARCHS
      for d, s in (("float32", None), ("float32", 0.8))]
EP_BF16 = [("qwen2_moe_a2_7b-bfloat16-0.8", "qwen2_moe_a2_7b", "bfloat16",
            0.8, _over("qwen2_moe_a2_7b"))]
FALLBACK = [(f"{a}-e6-{s}", a, "float32", s, _over(a, n_routed_experts=6))
            for a in ARCHS for s in (None, 0.8)]
CROSS = [(f"{a}-cf1-{s}", a, "float32", s, _over(a, capacity_factor=1.0))
         for a, s in ((ARCHS[0], None), (ARCHS[1], None), (ARCHS[1], 0.8))]
LOCAL = [(f"{a}-sg11", a, "float32", None,
          _over(a, capacity_factor=1.0, moe_subgroup=11)) for a in ARCHS]
# expert parallelism here; tests/test_torch_mesh_moe_data.py runs the
# fallback and the data-split worlds
# qwen2-moe's own 192-wide shared expert: at 0.8 its gate_up rows pad to
# two 128-row tiles, one a rank at model 2 (not a rank's share)
PADDED = [("qwen2_moe_a2_7b-s192-0.8", "qwen2_moe_a2_7b", "float32", 0.8,
           ())]
WORLDS = {"1x2": ((1, 2), EP + EP_BF16 + PADDED),
          "1x4": ((1, 4), EP + EP_BF16)}
BUILDS = {"1x4": [(a, _over(a)) for a in ARCHS]}


def _prompt():
    return np.random.default_rng(23).integers(0, 256, (4, PROMPT_LEN)) \
        .astype(np.int32)


def _rcfg(arch, dtype, over):
    return dataclasses.replace(ref_configs.smoke(arch), dtype=dtype,
                               **dict(over))


@functools.lru_cache(maxsize=None)
def _ref_params(arch, sparsity, over):
    """(the dense params as numpy, the reference's params: with
    ``sparsity``, pruned and encoded, its routed stacks per expert)."""
    rcfg = _rcfg(arch, "float32", over)
    jparams = ref_tf.init_model(jax.random.PRNGKey(0), rcfg)
    dense = jax.tree.map(np.asarray, jparams)
    if sparsity:
        jparams = ref_pruning.group_projections(ref_pruning.sparsify_params(
            jparams, sparsity, should_sparsify=worlds.should_sparsify))
        layers = dict(jparams["layers"])
        layers["moe"] = _ref_sparse_experts(layers["moe"])
        jparams = dict(jparams, layers=layers)
    return dense, jparams


class _RefRoutes:
    """While entered, the reference's MoE blocks also emit their routing
    (each token's experts ``[G, sg, E]`` and capacity positions) through
    an ordered ``jax.debug.callback``: the reference's routing lines on
    the block's own inputs."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        self.orig = orig = ref_moe.moe_block

        def tapped(params, x, cfg, *, backend="auto"):
            y, aux = orig(params, x, cfg, backend=backend)
            B, S, d = x.shape
            E, k = cfg.n_routed_experts, cfg.top_k
            sg = min(cfg.moe_subgroup, B * S)
            xt = x.reshape(B * S // sg, sg, d)
            logits = ref_sparse_linear.linear_logical_out(
                params["router"]["w"], E, xt,
                backend=backend).astype(jnp.float32)
            _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
            oh_e = jnp.sum(jax.nn.one_hot(idx, E, dtype=jnp.float32), axis=2)
            pos = (jnp.cumsum(oh_e, axis=1) * oh_e - 1.0).astype(jnp.int32)
            jax.debug.callback(
                lambda a, b: self.calls.append((np.asarray(a),
                                                np.asarray(b))),
                oh_e, pos, ordered=True)
            return y, aux
        ref_moe.moe_block = tapped
        return self

    def __exit__(self, *exc):
        ref_moe.moe_block = self.orig


def ref_run(rcfg, jparams, prompt: np.ndarray, pos: np.ndarray,
            routes: bool = False) -> dict:
    """The reference's prefill logits and cache, its first decode step's
    logits and cache at per-slot positions ``pos`` (teacher-forced with
    its own first tokens), with ``routes`` both routings, and (f32) its
    greedy stream. bf16 runs op by op: XLA's fusions round elsewhere than
    the port's (and the reference's) op-by-op bf16 program
    (``tests/test_torch_moe.py``)."""
    f32 = lambda x: np.asarray(jnp.asarray(x, jnp.float32))
    # fresh jitted wrappers: this tap's traces, no other file's
    prefill = jax.jit(lambda p, t: ref_engine.prefill(p, t, rcfg, MAX_LEN))
    step = jax.jit(lambda p, c, t, q: ref_engine.serve_step(p, c, t, q,
                                                            rcfg))
    bf16 = rcfg.dtype == "bfloat16"
    eager = jax.disable_jit() if bf16 else contextlib.nullcontext()
    tap = _RefRoutes() if routes else contextlib.nullcontext()
    with tap as rt, eager:
        last, cache = prefill(jparams, jnp.asarray(prompt))
        jax.effects_barrier()
        pre_routes = list(rt.calls) if routes else None
        tok = np.asarray(jnp.argmax(last, -1))
        logits, after = step(jparams, cache, jnp.asarray(tok)[:, None],
                             jnp.asarray(pos, jnp.int32))
        jax.effects_barrier()
        step_routes = rt.calls[len(pre_routes):] if routes else None
        toks, cur, c = [prompt], tok[:, None], cache
        for i in range(0 if bf16 else MAX_NEW):
            toks.append(cur)
            if i == MAX_NEW - 1:
                break
            lg, c = step(jparams, c, jnp.asarray(cur),
                         jnp.full((prompt.shape[0],), PROMPT_LEN + i,
                                  jnp.int32))
            cur = np.asarray(jnp.argmax(lg, -1))[:, None]
        jax.effects_barrier()
    return dict(prefill=f32(last), step=f32(logits), first_tok=tok,
                tokens=np.concatenate(toks, axis=1),
                routes=dict(prefill=pre_routes, step=step_routes),
                kv_pre=ref_cache_layers(cache), kv_step=ref_cache_layers(after))


@functools.lru_cache(maxsize=None)
def _ref_serve(arch, dtype, sparsity, over):
    """``ref_run`` of a case, with its routings."""
    return ref_run(_rcfg(arch, dtype, over), _ref_params(arch, sparsity,
                                                         over)[1],
                   _prompt(), STEP_POS, routes=True)


def ref_cache_layers(cache):
    """The reference's cache as the port's per-layer list: each layer's
    leaves (f32 numpy) in name order."""
    f32 = lambda x: np.asarray(jnp.asarray(x, jnp.float32))
    if isinstance(cache, dict):                 # scan-stacked [L, ...]
        names = sorted(cache)
        return [tuple(f32(cache[n][i]) for n in names)
                for i in range(cache[names[0]].shape[0])]
    return [tuple(f32(layer[n]) for n in sorted(layer)) for layer in cache]


def flip_rows(results, key, which, ref_kv, upto):
    """The ranks' cache blocks put together, over positions [0, upto):
    within the bf16 tolerance of the reference's cache; True for each row
    where some layer's leaf differs from it at all (a bf16 rounding flip
    of the f32 sums taken in another order, or what one flip upstream
    moved: ``tests/test_torch_seqshard.py``'s rule)."""
    flips = None
    for layer, leaves in enumerate(ref_kv):
        for j, want in enumerate(leaves):
            got = np.full_like(want, np.nan)
            for r in results:
                blk = r["serve"][key][which]
                part = blk["kv"][layer][j]
                b, s, h = blk["at"]
                idx = (slice(b, b + part.shape[0]),
                       slice(s, s + part.shape[1]))
                if part.ndim == 4:
                    idx += (slice(h, h + part.shape[2]),)
                got[idx] = part
            got, want = got[:, :upto], want[:, :upto]
            np.testing.assert_allclose(got, want, rtol=TOL["bfloat16"],
                                       atol=TOL["bfloat16"])
            rows = (got != want).reshape(got.shape[0], -1).any(-1)
            flips = rows if flips is None else flips | rows
    return flips


def close_rows(got, want, flips, tol):
    """Rows at ``tol``, those with a cache rounding flip at the bf16
    tolerance."""
    np.testing.assert_allclose(got[~flips], want[~flips], rtol=tol, atol=tol)
    bf16 = TOL["bfloat16"]
    np.testing.assert_allclose(got[flips], want[flips], rtol=bf16, atol=bf16)


def run_family_world(shape, cases, builds, ref_params, ref_serve):
    """A ``worlds.family_world`` on ``shape`` for ``cases`` (``(name,
    arch, dtype, sparsity, overrides)``, the reference's first tokens
    teacher-forcing the first step) and ``builds``."""
    full = [(key, a, d, s, o, ref_params(a, s, o)[0],
             ref_serve(a, d, s, o)["first_tok"]) for key, a, d, s, o in cases]
    return mesh_mod.run_world(
        worlds.family_world, shape, device="cpu",
        args=((full, _prompt(), MAX_LEN, MAX_NEW, STEP_POS), builds))


@pytest.fixture(scope="module")
def results():
    """The worlds run so far, by name: each runs at its first test."""
    out = {}

    def get(table, name):
        if name not in out:
            shape, cases = table["worlds"][name]
            out[name] = run_family_world(shape, cases,
                                         table["builds"].get(name, ()),
                                         _ref_params, _ref_serve)
        return out[name]
    return get


def _tokens(routes, rows, per_row):
    """Each call's (experts, positions) as ``[tokens, E]`` of the rows
    ``rows`` (``per_row`` tokens a row) of a whole-batch routing, or of a
    rank's own."""
    out = []
    for oh, pos in routes:
        oh, pos = oh.reshape(-1, oh.shape[-1]), pos.reshape(-1, oh.shape[-1])
        if rows is not None:
            lo, hi = rows[0] * per_row, rows[1] * per_row
            oh, pos = oh[lo:hi], pos[lo:hi]
        out.append((oh, pos))
    return out


def check_serving(res, case, want, model: int, routes: bool) -> dict:
    """A family case's ranks against the reference: logits (the flip
    rule), every rank's stream the same, in f32 the stream identical
    and (``routes``) each token's experts and capacity positions equal;
    returns rank 0's results."""
    key, _, dtype, _, _ = case
    tol = TOL[dtype]
    got = [r["serve"][key] for r in res]
    for g in got[1:]:
        np.testing.assert_array_equal(g["tokens"], got[0]["tokens"])
        np.testing.assert_array_equal(g["prefill"], got[0]["prefill"])
    g = got[0]
    pre = flip_rows(res, key, "kv_pre", want["kv_pre"], PROMPT_LEN)
    close_rows(g["prefill"], want["prefill"], pre, tol)
    close_rows(g["step"], want["step"], pre | flip_rows(
        res, key, "kv_step", want["kv_step"], MAX_LEN), tol)
    if dtype == "float32":
        np.testing.assert_array_equal(g["tokens"], want["tokens"])
    if dtype == "float32" and routes:
        for r in got[::model]:                   # one rank a data row
            for phase, per_row in (("prefill", PROMPT_LEN), ("step", 1)):
                mine = _tokens(r["routes"][phase], None, per_row)
                ref = _tokens(want["routes"][phase], r["rows"], per_row)
                assert len(mine) == len(ref) == 2, phase
                for (oh, pos), (roh, rpos) in zip(mine, ref):
                    np.testing.assert_array_equal(oh, roh)
                    np.testing.assert_array_equal(pos, rpos)
    return g


def check_build(res, model: int, key: str) -> None:
    """``serve.build(..., mesh=)`` on the model ranks of data row 0: the
    shard of the unsharded build, leaf for leaf and bit for bit; their
    non-zeros in split leaves, with the whole leaves' once, the whole
    build's."""
    nnz = 0
    for r in res[:model]:
        b = r["build"][key]
        assert b["equal"] and all(b["equal"].values()), \
            [p for p, ok in b["equal"].items() if not ok]
        assert not b["extra"]
        nnz += b["nnz_split"]
    assert nnz + res[0]["build"][key]["nnz_whole_leaves"] == \
        res[0]["build"][key]["nnz_unsharded"]


TABLE = dict(worlds=WORLDS, builds=BUILDS)
CASES = [(w, c) for w, (_, cases) in WORLDS.items() for c in cases]


@pytest.mark.parametrize("world,case", CASES,
                         ids=[f"{w}-{c[0]}" for w, c in CASES])
def test_sharded_moe_serving_matches_reference(world, case, results):
    _, arch, dtype, sparsity, over = case
    g = check_serving(results(TABLE, world), case,
                      _ref_serve(arch, dtype, sparsity, over),
                      WORLDS[world][0][1], routes=True)
    assert g["seq"] == "model"


BUILD_CASES = [(w, a, o) for w, bs in BUILDS.items() for a, o in bs]


@pytest.mark.parametrize("world,arch,over", BUILD_CASES,
                         ids=[f"{w}-{a}" for w, a, o in BUILD_CASES])
def test_moe_build_under_a_mesh_is_the_shard_of_the_build(world, arch, over,
                                                          results):
    check_build(results(TABLE, world), WORLDS[world][0][1],
                f"{arch}-{dict(over)}")
