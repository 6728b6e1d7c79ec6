"""Training the SSM, hybrid, vlm and audio families under a host mesh,
against the reference's unsharded step, on the CPU (four gloo ranks; the
test side in ``tests/torch_mesh_train.py``, the criteria of
``tests/test_torch_mesh_train_moe.py``).

One masked f32 step of widened smoke mamba2-130m (SSD, ``d_inner`` over
``model``, the conv, A, D, dt's bias and the gated norm whole on every
rank), recurrentgemma-9b (one period of (rglru, rglru, attn): the RG-LRU
width over ``model``, its recurrence and gates whole; no leaf masked, as
the reference's launcher masks nothing of an unrolled stack), qwen2-vl-2b
(M-RoPE) and musicgen-large (4 codebooks: summed vocab-parallel lookups,
a codebook a rank of the head at model 4) on 2x2, 4x1 and 1x4; and a
ZeRO-3 step of recurrentgemma on 2x2 against its step without FSDP.
"""

import pytest

import torch_mesh_train as mt

CASES = [("mamba2", "mamba2_130m", ()),
         ("recurrentgemma", "recurrentgemma_9b", ()),
         ("qwen2_vl", "qwen2_vl_2b", ()),
         ("musicgen", "musicgen_large", ())]
SHAPES = {"2x2": (2, 2), "4x1": (4, 1), "1x4": (1, 4)}
FSDP = CASES[1]


@pytest.fixture(scope="module")
def worlds_run():
    """The three meshes' results by name, from one world run at the
    first use."""
    out = {}

    def get(name):
        if not out:
            plans = []
            for w, shape in SHAPES.items():
                cases = [mt.world_case(*c) for c in CASES]
                if w == "2x2":
                    cases.append(mt.world_case("recurrentgemma_fsdp",
                                               *FSDP[1:], fsdp=True))
                plans.append((w, shape, cases, ()))
            out.update(mt.run(plans))
        return out[name]
    return get


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("world", SHAPES)
def test_sharded_step_matches_reference(world, case, worlds_run):
    mt.check_step(worlds_run(world), case, SHAPES[world])


def test_fsdp_step_matches_the_step_without_it(worlds_run):
    res = worlds_run("2x2")
    mt.check_step(res, ("recurrentgemma_fsdp",) + FSDP[1:], (2, 2),
                  fsdp=True)
    mt.check_fsdp(res, res, "recurrentgemma_fsdp", "recurrentgemma", FSDP,
                  (2, 2))
