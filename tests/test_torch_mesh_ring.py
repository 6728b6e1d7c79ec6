"""The port's hybrid family under a host mesh, its window ring split over
the ranks, against the reference's unsharded engine, on the CPU.

gloo ranks (``launch.mesh.run_world``, ``device="cpu"``) serve
recurrentgemma smoke (RG-LRU, RG-LRU, local attention; one KV head,
window 32), widened to 256 with 8 heads and ``d_ff`` 512 so that the
Tiled-CSL attention and MLP split by whole tiles, from the reference's
numpy params, dense and at sparsity 0.8, cut to the rank's shard. The
ring's 32 slots lie by the reference's layout
(``sharding.cache_shardings``):

* 1x2, 1x4 and 2x2: the slots over ``model`` (16 or 8 a rank; the batch
  over ``data`` on 2x2); a 40-token prompt, past the window, fills the
  ring's trailing window across the ranks' blocks, and a 28-token
  prompt wraps it during decode, the write moving to the next owner;
* 1x4 with a window of 30, which does not split four ways, nor does the
  one KV head: the head dim splits (the partial q.k summed over
  ``model`` in f32 before the softmax, each rank's ``p @ V`` its share of
  the head dim, gathered before ``wo``), the ring wrapping at 30;
* 2x2 at batch 1 (``seq_shard``): the slots over ``data`` and the head
  dim over ``model`` (the layout of recurrentgemma-9b's long_500k cell).

Held against the reference's unsharded ``engine.prefill`` and
``serve_step`` (``tests/torch_mesh_media.py``): prefill and first-step
logits, the ring's K/V and the RG-LRU states after each put together
from the ranks, f32 greedy streams identical; ``serve.build(...,
mesh=)`` is the shard of the unsharded build bit for bit.
"""

import functools

import numpy as np
import pytest

import torch_mesh_media as media

MAX_NEW = 8
RG = "recurrentgemma_9b"
WIDE = (("d_ff", 512), ("d_model", 256), ("n_heads", 8), ("rnn_width", 256))
W30 = tuple(sorted(WIDE + (("local_window", 30),)))
PAST, WRAP = 40, 28                      # prompt lengths: past, wraps later


def _prompt(batch, length):
    return np.random.default_rng(43).integers(0, 256, (batch, length)) \
        .astype(np.int32)


# (name, arch, dtype, sparsity, overrides, prompt length, batch 1) by world
WORLDS = {
    "1x2": ((1, 2), [("past", RG, "float32", None, WIDE, PAST, False),
                     ("wrap-0.8", RG, "float32", 0.8, WIDE, WRAP, False),
                     ("wrap-bf16", RG, "bfloat16", 0.8, WIDE, WRAP, False)]),
    "1x4": ((1, 4), [("wrap", RG, "float32", None, WIDE, WRAP, False),
                     ("past-0.8", RG, "float32", 0.8, WIDE, PAST, False),
                     ("hd", RG, "float32", None, W30, WRAP, False),
                     ("hd-0.8", RG, "float32", 0.8, W30, PAST, False)]),
    "2x2": ((2, 2), [("wrap", RG, "float32", None, WIDE, WRAP, False),
                     ("one", RG, "float32", None, WIDE, PAST, True),
                     ("one-wrap-0.8", RG, "float32", 0.8, WIDE, WRAP,
                      True)])}
BUILDS = {"1x2": [(RG, WIDE)], "1x4": [(RG, WIDE)]}


def _inputs(case):
    length, one = case[5], case[6]
    return _prompt(1 if one else 4, length), length + MAX_NEW, one, None


@functools.lru_cache(maxsize=None)
def _ref(key):
    case = {c[0]: c for _, cs in WORLDS.values() for c in cs}[key]
    _, arch, dtype, sparsity, over = case[:5]
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
                shape, [c[:5] + _inputs(c) for c in cases], _ref, MAX_NEW,
                BUILDS.get(name, ()))
        return out[name]
    return get


CASES = [(w, c) for w, (_, cases) in WORLDS.items() for c in cases]


@pytest.mark.parametrize("world,case", CASES,
                         ids=[f"{w}-{c[0]}" for w, c in CASES])
def test_sharded_ring_serving_matches_reference(world, case, results):
    g = media.check_case(results(world), case[:5], _ref(case[0]))
    d, m = WORLDS[world][0]
    one, hd = case[6], dict(case[4]).get("local_window") == 30
    assert g["seq"] == ("data" if one else None if hd else "model")
    assert g["head_dim"] == ("model" if one or hd else None)
    assert g["batch"] == (None if one else "data")
    ring = g["kv_pre"][2][0][1]                  # layer 2's K block
    ring_len = 30 if hd else 32
    assert ring.shape[1] == ring_len // (d if one else 1 if hd else m)
    assert ring.shape[3] == 32 // (m if one or hd else 1)
    # the ring wraps: at the prefill or during the decode steps
    assert case[5] > ring_len or case[5] + MAX_NEW > ring_len


BUILD_CASES = [(w, a, o) for w, bs in BUILDS.items() for a, o in bs]


@pytest.mark.parametrize("world,arch,over", BUILD_CASES,
                         ids=[f"{w}-{a}" for w, a, o in BUILD_CASES])
def test_ring_build_under_a_mesh_is_the_shard_of_the_build(world, arch, over,
                                                           results):
    media.check_build(results(world), WORLDS[world][0][1],
                      f"{arch}-{dict(over)}")
