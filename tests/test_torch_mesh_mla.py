"""The port's dense family with Multi-head Latent Attention under a host
mesh, against the reference's unsharded engine, on the CPU.

gloo ranks (``launch.mesh.run_world``, ``device="cpu"``) serve the
minicpm3 smoke config from the reference's numpy params, dense and at
sparsity 0.8 (``wo`` and the MLP, as the serving build encodes them),
pruned and encoded whole by ``convert.rank_params_from_numpy`` and cut
to the rank's shard:

* 1x2 and 1x4: the 4 heads split over ``model``; ``w_dq``'s product is
  gathered whole, ``w_uq``/``w_ukv`` column-parallel over the heads,
  ``wo`` row-parallel, the latents whole on every rank;
* 1x4 with 6 heads, which do not split four ways: every rank computes
  every head, the products split by element and gathered whole, the
  absorbed decode step gathering ``w_ukv`` whole;
* 1x2 and 1x4, every latent factor Tiled-CSL too, widened (8 heads,
  ``q_lora`` 256, ``kv_lora`` 128) so that ``w_dq``, ``w_uq``, ``w_ukv``
  and ``wo`` split by whole tiles (at model 4 ``w_dq`` and ``wo`` stay
  whole, as the rule leaves them); and with 6 heads over two ranks,
  whose ``w_uq`` and ``w_ukv`` rows pad to two tiles, one a rank (the
  ranks' blocks gathered whole, each keeping its share);
* 2x2: the batch over ``data``, and batch 1 with the latent sequence over
  ``data`` (``seq_shard``: the rank that holds a position writes it, the
  partial softmaxes combine over ``data``).

Held against the reference's unsharded ``engine.prefill`` and
``serve_step`` (per-slot positions, teacher-forced with the reference's
first tokens) within the slice tests' tolerances (f32 1e-3, bf16 3e-2;
a row whose bf16 latent cache differs from the reference's at all at
the bf16 tolerance, ``tests/test_torch_mesh_moe.py``'s rule), the ranks'
latent blocks put together within the bf16 tolerance of the reference's
cache, every rank's stream the same, f32 greedy streams identical to the
reference's. The bf16 reference runs op by op. ``serve.build(...,
mesh=)`` is the shard of the unsharded build bit for bit.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest

import torch_mesh_worlds as worlds
from repro import configs as ref_configs
from repro.core import pruning as ref_pruning
from repro.models import transformer as ref_tf
from repro_torch.launch import mesh as mesh_mod
from test_torch_mesh_moe import (MAX_LEN, MAX_NEW, PROMPT_LEN, STEP_POS,
                                 check_build, check_serving, ref_run)

ARCH = "minicpm3_4b"
WIDE = (("d_ff", 512), ("d_model", 256), ("kv_lora_rank", 128),
        ("n_heads", 8), ("n_kv", 8), ("q_lora_rank", 256),
        ("qk_nope_dim", 32), ("qk_rope_dim", 32), ("v_head_dim", 32))
FACTORS = tuple(sorted(WIDE + (("factors", True),)))
SIX = (("n_heads", 6), ("n_kv", 6))

# (name, arch, dtype, sparsity, overrides) by world
SPLIT = [(f"{d}-{s}", ARCH, d, s, ()) for d, s in
         (("float32", None), ("float32", 0.8), ("bfloat16", 0.8))]
# 6 heads over 2 ranks, every factor Tiled-CSL: w_uq's 144 and w_ukv's
# 192 rows pad to two 128-row tiles, one a rank, not a rank's share
ALL = [("factors", ARCH, "float32", 0.8, FACTORS)]
PADDED = [("six-factors", ARCH, "float32", 0.8,
           tuple(sorted(SIX + (("factors", True),))))]
WHOLE = [(f"six-{s}", ARCH, "float32", s, SIX) for s in (None, 0.8)]
DATA = [("f32-data", ARCH, "float32", None, ()),
        ("one", ARCH, "float32", None, (("one", True),)),
        ("one-sparse", ARCH, "float32", 0.8, (("one", True),))]
WORLDS = {"1x2": ((1, 2), SPLIT + ALL + PADDED),
          "1x4": ((1, 4), SPLIT + ALL + WHOLE), "2x2": ((2, 2), DATA)}
BUILDS = {"1x4": [(ARCH, ()), (ARCH, SIX)], "1x2": [(ARCH, ())]}


def _prompt():
    return np.random.default_rng(31).integers(0, 256, (4, PROMPT_LEN)) \
        .astype(np.int32)


def _rcfg(dtype, over):
    over = {k: v for k, v in over if k not in worlds.CASE_FLAGS}
    return dataclasses.replace(ref_configs.smoke(ARCH), dtype=dtype, **over)


@functools.lru_cache(maxsize=None)
def _ref_params(sparsity, over):
    """(the dense params as numpy, the reference's params: with
    ``sparsity``, pruned and encoded)."""
    rcfg = _rcfg("float32", over)
    jparams = ref_tf.init_model(jax.random.PRNGKey(0), rcfg)
    dense = jax.tree.map(np.asarray, jparams)
    if sparsity:
        should = worlds.family_sparsify_all if dict(over).get("factors") \
            else worlds.should_sparsify
        jparams = ref_pruning.group_projections(ref_pruning.sparsify_params(
            jparams, sparsity, should_sparsify=should))
    return dense, jparams


@functools.lru_cache(maxsize=None)
def _ref_serve(dtype, sparsity, over):
    """``ref_run`` of a case (batch 1 for ``one``)."""
    one = dict(over).get("one", False)
    return ref_run(_rcfg(dtype, over), _ref_params(sparsity, over)[1],
                   _prompt()[:1] if one else _prompt(),
                   STEP_POS[:1] if one else STEP_POS)


def _world(name):
    shape, cases = WORLDS[name]
    full = [(key, a, d, s, o, _ref_params(s, o)[0],
             _ref_serve(d, s, o)["first_tok"]) for key, a, d, s, o in cases]
    return mesh_mod.run_world(
        worlds.family_world, shape, device="cpu",
        args=((full, _prompt(), MAX_LEN, MAX_NEW, STEP_POS),
              BUILDS.get(name, ())))


@pytest.fixture(scope="module")
def results():
    return {}


def _results(results, name):
    if name not in results:
        results[name] = _world(name)
    return results[name]


CASES = [(w, c) for w, (_, cases) in WORLDS.items() for c in cases]


@pytest.mark.parametrize("world,case", CASES,
                         ids=[f"{w}-{c[0]}" for w, c in CASES])
def test_sharded_mla_serving_matches_reference(world, case, results):
    _, _, dtype, sparsity, over = case
    g = check_serving(_results(results, world), case,
                      _ref_serve(dtype, sparsity, over), WORLDS[world][0][1],
                      routes=False)
    one = dict(over).get("one", False)
    assert g["seq"] == ("data" if one else None)
    assert g["batch"] == (None if one else "data")


BUILD_CASES = [(w, a, o) for w, bs in BUILDS.items() for a, o in bs]


@pytest.mark.parametrize("world,arch,over", BUILD_CASES,
                         ids=[f"{w}-six" if o else w
                              for w, a, o in BUILD_CASES])
def test_mla_build_under_a_mesh_is_the_shard_of_the_build(world, arch, over,
                                                          results):
    check_build(_results(results, world), WORLDS[world][0][1],
                f"{arch}-{dict(over)}")
