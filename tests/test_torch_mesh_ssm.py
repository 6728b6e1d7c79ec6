"""The port's SSM family and the hybrid's RG-LRU blocks under a host
mesh, against the reference's unsharded engine, on the CPU.

gloo ranks (``launch.mesh.run_world``, ``device="cpu"``) serve from the
reference's numpy params, cut to the rank's shard:

* mamba2 smoke (no weight encoded, as the serving build leaves it) on
  1x2, 1x4 and 2x2: ``in_proj`` column-parallel and gathered whole (z,
  xBC and dt are read whole), the conv, the SSD scan and the gated norm
  whole on every rank, ``out_proj`` row-parallel, the state and conv
  leaves whole over ``model`` (the batch over ``data`` on 2x2); and with
  a 17-wide state, whose 298-row ``in_proj`` splits two ways and is held
  whole at four (as the rule leaves mamba2-130m's 3352 rows at 16);
* recurrentgemma's RG-LRU blocks alone (``layer_pattern`` ``("rglru",)``,
  widened to 256), dense and with the MLP at sparsity 0.8: ``w_x`` and
  ``wa`` column-parallel and gathered whole before the conv and the
  gates, ``w_gate`` column-parallel, ``w_out`` row-parallel, ``h`` and
  the conv state whole over ``model``.

Held against the reference's unsharded ``engine.prefill`` and
``serve_step`` (``tests/torch_mesh_media.py``): prefill and first-step
logits, the state leaves after each put together from the ranks, f32
greedy streams identical; ``serve.build(..., mesh=)`` is the shard of
the unsharded build bit for bit.
"""

import functools

import numpy as np
import pytest

import torch_mesh_media as media

MAX_NEW = 5
MAMBA = "mamba2_130m"
RG = "recurrentgemma_9b"
N17 = (("ssm_state", 17),)
RGLRU = (("d_ff", 512), ("d_model", 256), ("layer_pattern", ("rglru",)),
         ("n_layers", 2), ("rnn_width", 256))


def _prompt(batch=4, length=21):
    return np.random.default_rng(41).integers(0, 256, (batch, length)) \
        .astype(np.int32)


# (name, arch, dtype, sparsity, overrides) by world
BASE = [("f32", MAMBA, "float32", None, ()),
        ("n17", MAMBA, "float32", None, N17),
        ("rglru", RG, "float32", None, RGLRU)]
WORLDS = {"1x2": ((1, 2), BASE + [
              ("bf16", MAMBA, "bfloat16", None, ()),
              ("rglru-0.8", RG, "float32", 0.8, RGLRU)]),
          "1x4": ((1, 4), BASE + [("rglru-0.8", RG, "float32", 0.8, RGLRU)]),
          "2x2": ((2, 2), BASE)}
BUILDS = {"1x4": [(MAMBA, ()), (RG, RGLRU)]}
MAX_LEN = 21 + MAX_NEW


def _inputs(case):
    return _prompt(), MAX_LEN, False, None


@functools.lru_cache(maxsize=None)
def _ref(key):
    case = {c[0]: c for _, cs in WORLDS.values() for c in cs}[key]
    _, arch, dtype, sparsity, over = case
    prompt, max_len, _, extra = _inputs(case)
    return media.ref_run(media.rcfg_of(arch, dtype, over),
                         media.ref_params(arch, sparsity, over)[1], prompt,
                         max_len, MAX_NEW, extra)


@pytest.fixture(scope="module")
def results():
    out = {}

    def get(name):
        if name not in out:
            shape, cases = WORLDS[name]
            out[name] = media.run_world(
                shape, [c + _inputs(c) for c in cases], _ref, MAX_NEW,
                BUILDS.get(name, ()))
        return out[name]
    return get


CASES = [(w, c) for w, (_, cases) in WORLDS.items() for c in cases]


@pytest.mark.parametrize("world,case", CASES,
                         ids=[f"{w}-{c[0]}" for w, c in CASES])
def test_sharded_ssm_serving_matches_reference(world, case, results):
    g = media.check_case(results(world), case, _ref(case[0]))
    assert g["head_dim"] is None
    assert g["batch"] == "data"
    if case[1] == RG:
        assert g["seq"] is None                  # no attention layer
    # mamba2's states [B, h, p, n] and conv: rows only over data
    d = WORLDS[world][0][0]
    assert g["kv_pre"][0][0][1].shape[0] == 4 // d


BUILD_CASES = [(w, a, o) for w, bs in BUILDS.items() for a, o in bs]


@pytest.mark.parametrize("world,arch,over", BUILD_CASES,
                         ids=[f"{w}-{a}" for w, a, o in BUILD_CASES])
def test_ssm_build_under_a_mesh_is_the_shard_of_the_build(world, arch, over,
                                                          results):
    media.check_build(results(world), WORLDS[world][0][1],
                      f"{arch}-{dict(over)}")
