"""Training the MoE and MLA families under a host mesh, against the
reference's unsharded step, on the CPU (four gloo ranks,
``launch.mesh.run_world``; the test side in ``tests/torch_mesh_train.py``).

One masked f32 step (the launcher's 0.8 masks) of widened smoke
qwen3-moe-30b-a3b and qwen2-moe-a2.7b at their published capacity factor
1.25 (the smoke configs' 4.0 drops nothing) and of minicpm3_4b (MLA), on
2x2, 4x1 and 1x4, against ``jax.value_and_grad`` of the reference's loss
and its jitted ``make_train_step``:

* loss, ce, aux and gradient norm within 1e-5 relative; every gradient
  leaf, put together from the ranks, within 1e-5 of its largest
  absolute value (one bf16 ulp, 2^-8, where the train path rounds K/V
  to bf16: ``tests/torch_mesh_train.py``); every param within 5e-3 and its update's misses
  within 0.25; masked weights zero; no raw (backward-less) collective
  reached while gradients were on;
* MoE routing: every token's experts and capacity positions equal the
  reference's on the whole batch. The global batch's 64 tokens are one
  ``moe_subgroup`` of 64, so on 4x1 a subgroup spans the four data ranks
  (16 tokens a rank) and on 2x2 two; the reference drops assignments;
  the aux loss is the whole batch's;
* qwen2-moe with 6 experts: on 1x4 each expert split inside (column
  and row shares), the router held whole;
* ZeRO-3 (``fsdp``) on 2x2 against the same step without it;
* the qwen3-moe state saved from 2x2 restores on 1x4 (each rank its
  block) and on one process, every leaf equal.
"""

import functools

import numpy as np
import pytest
import torch

import torch_mesh_train as mt
import torch_mesh_worlds as worlds
from repro_torch import configs
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.distributed import sharding
from repro_torch.models import transformer
from repro_torch.training import train_loop

CF = (("capacity_factor", 1.25),)
CASES = [("qwen3_moe", "qwen3_moe_30b_a3b", CF),
         ("qwen2_moe", "qwen2_moe_a2_7b", CF),
         ("minicpm3", "minicpm3_4b", ())]
MOE = [c for c in CASES if c[0].endswith("moe")]
SHAPES = {"2x2": (2, 2), "4x1": (4, 1), "1x4": (1, 4)}
# 6 experts on 1x4: each expert split inside (column and row shares),
# the router's 6 rows held whole (a leaf read whole sums its gradient)
E6 = ("qwen2_moe_e6", "qwen2_moe_a2_7b", CF + (("n_routed_experts", 6),))
WORLD_CASES = {w: CASES + ([E6] if w == "1x4" else []) for w in SHAPES}
STEPS = [(w, c) for w, cases in WORLD_CASES.items() for c in cases]
CKPT = CASES[0]


@pytest.fixture(scope="module")
def ckpt_root(tmp_path_factory):
    return tmp_path_factory.mktemp("moe_train_ckpt")


@pytest.fixture(scope="module")
def worlds_run(ckpt_root):
    """The three meshes' results by name, from one world run at the
    first use: 2x2 first (it writes the checkpoint 1x4 restores)."""
    out = {}
    ckpt = str(ckpt_root / "qwen3_moe")

    def get(name):
        if not out:
            plans = []
            for w, shape in SHAPES.items():
                cases = [mt.world_case(*c) for c in WORLD_CASES[w]]
                restore = ()
                if w == "2x2":
                    cases[0] = mt.world_case(*CKPT, ckpt=ckpt)
                    cases.append(mt.world_case("qwen3_moe_fsdp", *CKPT[1:],
                                               fsdp=True))
                if w == "1x4":
                    restore = [("qwen3_moe", *CKPT[1:], ckpt)]
                plans.append((w, shape, cases, restore))
            out.update(mt.run(plans))
        return out[name]
    return get


@pytest.mark.parametrize("world,case", STEPS,
                         ids=[f"{w}-{c[0]}" for w, c in STEPS])
def test_sharded_step_matches_reference(world, case, worlds_run):
    mt.check_step(worlds_run(world), case, SHAPES[world])


@pytest.mark.parametrize("case", MOE, ids=[c[0] for c in MOE])
@pytest.mark.parametrize("world", SHAPES)
def test_routing_and_drops_match_reference(world, case, worlds_run):
    dropped = mt.check_routes(worlds_run(world), case, SHAPES[world])
    assert dropped > 0, case
    cfg = worlds.wide(configs.smoke(case[1]), case[1], "float32", case[2])
    assert cfg.capacity_factor == 1.25
    tokens = mt.BATCH * (mt.SEQ - 1)
    span = min(cfg.moe_subgroup, tokens) // (tokens // SHAPES[world][0])
    assert span == SHAPES[world][0]      # one subgroup over every data rank


def test_fsdp_step_matches_the_step_without_it(worlds_run):
    res = worlds_run("2x2")
    mt.check_step(res, ("qwen3_moe_fsdp",) + CKPT[1:], (2, 2), fsdp=True)
    mt.check_fsdp(res, res, "qwen3_moe_fsdp", "qwen3_moe", CKPT, (2, 2))


@functools.lru_cache(maxsize=None)
def _template():
    cfg = worlds.wide(configs.smoke(CKPT[1]), CKPT[1], "float32", CKPT[2])
    params = transformer.init_model(cfg, device="cpu")
    opt = worlds._opt()
    return (train_loop.TrainState(params, opt.init(params),
                                  torch.zeros((), dtype=torch.int32)),
            {"seed": 0, "step": 0})


def test_checkpoint_from_2x2_restores_on_1x4_and_one_process(worlds_run,
                                                            ckpt_root):
    res2 = worlds_run("2x2")
    (state, _), meta = ft.CheckpointManager(
        str(ckpt_root / "qwen3_moe")).restore(_template())
    assert meta["step"] == 1
    whole = {p: v.detach().numpy() for p, v in ft.flatten_with_paths(state)
             if isinstance(v, torch.Tensor)}
    specs = {p: ft.leaf_spec(p, v.shape, dict(zip(mt.NAMES, (2, 2))))
             for p, v in whole.items()}
    saved = mt.unshard([r["qwen3_moe"] for r in res2], "state", specs,
                       (2, 2))
    for path, v in whole.items():        # the ranks' shards, bit for bit
        np.testing.assert_array_equal(saved[path], v, err_msg=path)
    routed = [p for p in whole if "['moe']['gate']" in p]
    assert routed and all(sharding.model_sharded(specs[p]) for p in routed)
    mesh4 = dict(zip(mt.NAMES, (1, 4)))
    for r in worlds_run("1x4"):
        got = r["restored"]["qwen3_moe"]
        assert got["step"] == 1
        for path, v in whole.items():
            want = sharding.shard_leaf(
                torch.from_numpy(v), ft.leaf_spec(path, v.shape, mesh4),
                mesh4, coords=got["coords"]).numpy()
            np.testing.assert_array_equal(got["state"][path], want,
                                          err_msg=path)
