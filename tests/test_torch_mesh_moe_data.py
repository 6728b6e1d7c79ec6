"""The port's MoE family under a host mesh where the experts do not
divide the model axis, and where the batch splits over ``data``, against
the reference's unsharded engine, on the CPU (the setup and the criteria
of ``tests/test_torch_mesh_moe.py``, which runs expert parallelism):

* 1x4 with 6 experts: tensor parallelism inside each expert (column
  shares of ``gate``/``up``, a row share of ``down``; Tiled-CSL stacks
  stay whole, as the rule leaves them, and each rank keeps its share of
  their products);
* 2x2: the batch of 4 over ``data``, 2 rows a rank. At capacity factor
  1.0 (the reference drops tokens) every subgroup spans both data ranks:
  the prefill's 44 tokens and the decode step's 4, so a rank's capacity
  positions start after the other rank's counts and each expert's block
  is summed over both before its FFN. With ``moe_subgroup`` 11 the
  prefill's subgroups lie inside a rank and the decode step's spans
  both.

In f32 every token's experts and capacity positions, and so the dropped
assignments, equal the reference's.
"""

import pytest

from test_torch_mesh_moe import (ARCHS, CROSS, EP, FALLBACK, LOCAL,
                                 PROMPT_LEN, _over, _ref_serve, check_build,
                                 check_serving, results)  # noqa: F401

WORLDS = {"1x4": ((1, 4), FALLBACK), "2x2": ((2, 2), EP + CROSS + LOCAL)}
BUILDS = {"1x4": [(a, _over(a, n_routed_experts=6)) for a in ARCHS],
          "2x2": [("qwen2_moe_a2_7b", _over("qwen2_moe_a2_7b"))]}
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
                         ids=[f"{w}-{a}-e6" if dict(o).get("n_routed_experts")
                              else f"{w}-{a}" for w, a, o in BUILD_CASES])
def test_moe_build_under_a_mesh_is_the_shard_of_the_build(world, arch, over,
                                                          results):
    check_build(results(TABLE, world), WORLDS[world][0][1],
                f"{arch}-{dict(over)}")


def test_crossing_cases_drop_and_cross():
    """The 2x2 cases at capacity factor 1.0 drop assignments in the
    reference, and their decode subgroups (and, at ``moe_subgroup`` 64,
    their prefill subgroups) span both data ranks' rows."""
    for _, arch, dtype, sparsity, over in CROSS + LOCAL:
        want = _ref_serve(arch, dtype, sparsity, over)
        for phase in ("prefill", "step"):
            oh, pos = want["routes"][phase][0]
            cap = -(-oh.shape[1] * 2 // dict(over).get("n_routed_experts", 8))
            assert ((pos >= cap) & (oh > 0)).any(), (arch, phase)
        sg = dict(over).get("moe_subgroup", 64)
        assert min(sg, 4) > 2                      # decode: 2 rows a rank
        assert (min(sg, 4 * PROMPT_LEN) > 2 * PROMPT_LEN) == (sg == 64)
