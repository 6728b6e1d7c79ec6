"""Shared test-side set-up of the SSM, ring and media mesh tests
(``tests/test_torch_mesh_ssm.py``, ``_ring.py``, ``_media.py``): the
reference's params and its unsharded engine run of a case, the gloo
world that serves the cases (``torch_mesh_worlds.media_world``), and the
checks that hold the ranks' results against the reference.

A case is ``(key, arch, dtype, sparsity, overrides)`` with its inputs
``(prompt, max_len, one, extra)``: the prompt ``[B, S]`` (codebooks
``[B, n_cb, S]``), the cache length, ``one`` (batch 1 with the sequence
over ``data``, ``seq_shard``) and ``extra`` (numpy ``embeds`` /
``positions`` for the prefill). Tolerances are the slice tests'
(``tests/test_torch_mesh.py``: f32 1e-3, bf16 3e-2). K/V caches are
bf16 in both packages: a row whose K/V differs from the reference's at
all (a rounding flip of sums taken in another order) is held at the
bf16 tolerance, ``tests/test_torch_mesh_moe.py``'s rule; recurrent state
leaves (f32) are held at the case's tolerance. f32 greedy streams must be
identical to the reference's, and every rank's stream the same.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

import torch_mesh_worlds as worlds
from repro import configs as ref_configs
from repro.core import pruning as ref_pruning
from repro.models import transformer as ref_tf
from repro.serving import engine as ref_engine
from repro_torch.launch import mesh as mesh_mod
from test_torch_mesh_moe import check_build, close_rows  # noqa: F401

TOL = {"float32": 1e-3, "bfloat16": 3e-2}
KV = ("k", "v")


def rcfg_of(arch, dtype, over):
    return dataclasses.replace(ref_configs.smoke(arch), dtype=dtype,
                               **dict(over))


@functools.lru_cache(maxsize=None)
def ref_params(arch, sparsity, over):
    """(the dense params as numpy, the reference's params: with
    ``sparsity``, the serving build's weights pruned and encoded)."""
    jparams = ref_tf.init_model(jax.random.PRNGKey(0),
                                rcfg_of(arch, "float32", over))
    dense = jax.tree.map(np.asarray, jparams)
    if sparsity:
        jparams = ref_pruning.group_projections(ref_pruning.sparsify_params(
            jparams, sparsity, should_sparsify=worlds.should_sparsify))
    return dense, jparams


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def cache_layers(cache):
    """The reference's cache as the port's per-layer list of each
    layer's leaves (f32 numpy) in name order, with their names."""
    if isinstance(cache, dict):                 # scan-stacked [L, ...]
        names = sorted(cache)
        return [[(n, _f32(cache[n][i])) for n in names]
                for i in range(cache[names[0]].shape[0])]
    return [[(n, _f32(layer[n])) for n in sorted(layer)] for layer in cache]


def ref_run(rcfg, jparams, prompt, max_len, max_new, extra=None) -> dict:
    """The reference's prefill logits and cache, its first decode step's
    at the prompt's end (from its own first tokens) and cache, and its
    greedy stream of ``max_new`` tokens from that prefill (f32: the
    streams compared; with ``extra``, its ``embeds`` and M-RoPE
    ``positions`` reach the stream through the prefill's cache, and the
    decode steps go on at the cache's next index, as ``serve_step``
    takes them). f32 runs jitted; bf16 runs op by op,
    since XLA's fusions round elsewhere than the op-by-op programs of
    both packages (``tests/test_torch_mesh_moe.py``'s rule)."""
    extra = {k: jnp.asarray(v) for k, v in (extra or {}).items()}
    S = prompt.shape[-1]
    prefill = jax.jit(lambda p, t, e: ref_engine.prefill(p, t, rcfg, max_len,
                                                         **e))
    step = jax.jit(lambda p, c, t, q: ref_engine.serve_step(p, c, t, q,
                                                            rcfg))
    bf16 = rcfg.dtype == "bfloat16"
    with jax.disable_jit() if bf16 else contextlib.nullcontext():
        last, cache = prefill(jparams, jnp.asarray(prompt), extra)
        tok = np.asarray(jnp.argmax(last, -1))
        nxt = lambda t: jnp.asarray(t)[..., None]
        logits, after = step(jparams, cache, nxt(tok), jnp.int32(S))
    toks, cur = [prompt], tok
    stream = not bf16
    if stream:
        c = cache
        for i in range(max_new):
            toks.append(np.asarray(cur)[..., None])
            if i == max_new - 1:
                break
            lg, c = step(jparams, c, nxt(cur), jnp.int32(S + i))
            cur = np.asarray(jnp.argmax(lg, -1))
    return dict(prefill=_f32(last), step=_f32(logits), first_tok=tok,
                tokens=np.concatenate(toks, axis=-1) if stream else None,
                kv_pre=cache_layers(cache), kv_step=cache_layers(after))


def run_world(shape, cases, ref_of, max_new, builds=()):
    """``worlds.media_world`` on ``shape`` for ``cases`` (``(key, arch,
    dtype, sparsity, overrides, prompt, max_len, one, extra)``), the
    reference's first tokens teacher-forcing the first step."""
    full = []
    for key, a, d, s, o, prompt, max_len, one, extra in cases:
        full.append((key, a, d, s, o, ref_params(a, s, o)[0], prompt,
                     max_len, one, extra, ref_of(key)["first_tok"]))
    return mesh_mod.run_world(worlds.media_world, shape, device="cpu",
                              args=(full, max_new, builds))


def _assemble(results, key, which, layer, j, shape):
    whole = np.full(shape, np.nan, np.float32)
    for r in results:
        at, part = r["serve"][key][which][layer][j]
        whole[tuple(slice(a, a + n) for a, n in zip(at, part.shape))] = part
    assert not np.isnan(whole).any(), (key, which, layer, j)
    return whole


def flip_rows(results, key, which, want_layers, tol):
    """The ranks' cache blocks put together, leaf by leaf, against the
    reference's cache: K/V within the bf16 tolerance, with True for each
    row where some K/V element differs at all; state leaves within
    ``tol``."""
    flips = None
    for layer, leaves in enumerate(want_layers):
        for j, (name, want) in enumerate(leaves):
            got = _assemble(results, key, which, layer, j, want.shape)
            t = TOL["bfloat16"] if name in KV else tol
            np.testing.assert_allclose(got, want, rtol=t, atol=t,
                                       err_msg=f"{key} {which} [{layer}] "
                                       f"{name}")
            if name in KV:
                rows = (got != want).reshape(got.shape[0], -1).any(-1)
                flips = rows if flips is None else flips | rows
    return flips if flips is not None else np.zeros(
        want_layers[0][0][1].shape[0], bool)


def check_case(results, case, want) -> dict:
    """A case's ranks against the reference: every rank's prefill logits
    and stream the same; the prefill and first-step logits and the
    cache (K/V and states) after each within the tolerances; in f32 the
    greedy stream identical. Returns rank 0's results."""
    key, _, dtype = case[:3]
    tol = TOL[dtype]
    got = [r["serve"][key] for r in results]
    for g in got[1:]:
        np.testing.assert_array_equal(g["tokens"], got[0]["tokens"])
        np.testing.assert_array_equal(g["prefill"], got[0]["prefill"])
    g = got[0]
    pre = flip_rows(results, key, "kv_pre", want["kv_pre"], tol)
    close_rows(g["prefill"], want["prefill"], pre, tol)
    after = flip_rows(results, key, "kv_step", want["kv_step"], tol)
    close_rows(g["step"], want["step"], pre | after, tol)
    if dtype == "float32" and want["tokens"] is not None:
        np.testing.assert_array_equal(g["tokens"], want["tokens"])
    return g
