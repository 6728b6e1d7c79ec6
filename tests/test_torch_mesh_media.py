"""The port's vlm and audio families under a host mesh, against the
reference's unsharded engine, on the CPU.

gloo ranks (``launch.mesh.run_world``, ``device="cpu"``) serve from the
reference's numpy params, dense and at sparsity 0.8 (attention and MLP
Tiled-CSL), cut to the rank's shard:

* qwen2-vl smoke (GQA with M-RoPE, 6 heads, 2 KV heads): on 1x2 the
  heads split, on 1x4 they do not (every rank computes every head, the
  products split by element); a prompt of a 4 x 4 patch grid then text
  whose t, h and w position ids differ, its ``embeds`` standing in for
  the tokens (the stubbed vision frontend), both split by rows with the
  batch; 2x2 splits the batch over ``data``;
* musicgen smoke (4 codebooks of 64), widened to 256 with ``d_ff`` 512:
  each codebook's table ``[64 / m, d]`` looked up vocab-parallel and the
  lookups summed in codebook order, the untied head ``[4 * 64, d]``
  vocab-parallel over the flattened rows (one codebook a rank at model
  4), gathered whole before the reshape to ``[.., 4, 64]``; codebook
  tokens ``[B, 4, S]`` through ``generate``.

Held against the reference's unsharded ``engine.prefill`` and
``serve_step`` (``tests/torch_mesh_media.py``): prefill and first-step
logits, the K/V after each put together from the ranks, f32 greedy
streams identical; ``serve.build(..., mesh=)`` is the shard of the
unsharded build bit for bit.
"""

import functools

import numpy as np
import pytest

import torch_mesh_media as media

MAX_NEW = 5
VL, MG = "qwen2_vl_2b", "musicgen_large"
MG_WIDE = (("d_ff", 512), ("d_model", 256))
GRID, TEXT = 4, 5
S = GRID * GRID + TEXT


def _vision_positions(B):
    """[3, B, S]: the grid's patches at t = 0 with their row and column
    as h and w, then text at GRID on, equal on all three axes."""
    r, c = np.divmod(np.arange(GRID * GRID), GRID)
    text = GRID + np.arange(TEXT)
    thw = np.stack([np.concatenate([np.zeros_like(r), text]),
                    np.concatenate([r, text]), np.concatenate([c, text])])
    return np.ascontiguousarray(np.broadcast_to(
        thw[:, None], (3, B, S))).astype(np.int64)


# (name, arch, dtype, sparsity, overrides, the prefill's embeds) by world
WORLDS = {
    "1x2": ((1, 2), [("vl", VL, "float32", None, (), False),
                     ("vl-embeds", VL, "float32", None, (), True),
                     ("vl-0.8", VL, "float32", 0.8, (), False),
                     ("mg", MG, "float32", None, MG_WIDE, False),
                     ("mg-0.8", MG, "float32", 0.8, MG_WIDE, False),
                     ("mg-bf16", MG, "bfloat16", 0.8, MG_WIDE, False)]),
    "1x4": ((1, 4), [("vl", VL, "float32", None, (), False),
                     ("vl-embeds-0.8", VL, "float32", 0.8, (), True),
                     ("mg", MG, "float32", None, MG_WIDE, False),
                     ("mg-0.8", MG, "float32", 0.8, MG_WIDE, False)]),
    "2x2": ((2, 2), [("vl", VL, "float32", None, (), False),
                     ("vl-embeds", VL, "float32", None, (), True),
                     ("mg", MG, "float32", None, MG_WIDE, False)])}
BUILDS = {"1x4": [(VL, ()), (MG, MG_WIDE)]}


def _inputs(case):
    arch, over, embeds = case[1], case[4], case[5]
    cfg = media.rcfg_of(arch, "float32", over)
    rng = np.random.default_rng(47)
    if arch == MG:
        prompt = rng.integers(0, cfg.vocab, (4, cfg.n_codebooks, 9))
    else:
        prompt = rng.integers(0, cfg.vocab, (4, S))
    extra = None
    if embeds:
        extra = dict(embeds=(rng.standard_normal((4, S, cfg.d_model))
                             * 0.02).astype(np.float32),
                     positions=_vision_positions(4))
    # a cache length that divides four: the K/V sequence over model
    max_len = -(-(prompt.shape[-1] + MAX_NEW) // 4) * 4
    return prompt.astype(np.int32), max_len, False, extra


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
def test_sharded_media_serving_matches_reference(world, case, results):
    g = media.check_case(results(world), case[:5], _ref(case[0]))
    assert (g["seq"], g["head_dim"], g["batch"]) == ("model", None, "data")
    if case[1] == MG:
        B, n_cb = 4 // WORLDS[world][0][0], 4
        assert g["step"].shape == (4, n_cb, 64)
        assert g["tokens"].shape == (4, n_cb, 9 + MAX_NEW)
        assert g["kv_pre"][0][0][1].shape[0] == B


BUILD_CASES = [(w, a, o) for w, bs in BUILDS.items() for a, o in bs]


@pytest.mark.parametrize("world,arch,over", BUILD_CASES,
                         ids=[f"{w}-{a}" for w, a, o in BUILD_CASES])
def test_media_build_under_a_mesh_is_the_shard_of_the_build(world, arch,
                                                            over, results):
    media.check_build(results(world), WORLDS[world][0][1],
                      f"{arch}-{dict(over)}")
