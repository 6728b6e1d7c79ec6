"""The port's dry run (``launch.dryrun``) on dry meshes, on the CPU: no
process group, no device, meta tensors only.

* The reference's two small-mesh cases (``tests/test_distributed.py``'s
  dry-run machinery tests, qwen2-moe swapped for tinyllama since MoE
  does not train under a mesh), on a dry 2x2 mesh: FLOPs above 0, and
  collective bytes above 0 for the sharded cells (the reference's own
  criterion there); the sparse decode cell notes its LSCD launches with
  the schedule they would run. MoE (expert parallelism, and tensor
  parallelism inside each expert) and MLA (heads split and not) decode
  cells on the same mesh.
* ``main`` on one production cell writes its record under a temporary
  ``results`` path; its per-rank bytes are the reference's.
* The train cells of every family but the dense GQA one (the MoE, MLA,
  SSM, hybrid, vlm and audio families, which ROADMAP.md queue 1 item 14
  brought under a mesh) build and run on the production mesh (a ``ok``
  record), and a smoke train cell of each on a dry 2x2 mesh; a train
  cell in ``sparse_xla`` mode names queue 3 item 13. The K/V layout's
  head dim fallback builds.
"""

import dataclasses
import json

import pytest
import torch

from repro_torch import configs
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import specs
from repro_torch.models import transformer
from repro_torch.models.config import ShapeConfig

ITEM13 = "ROADMAP.md queue 3 item 13"


def _run(cfg, shape, mesh_shape=(2, 2), weight_mode="dense"):
    mesh = mesh_mod.DryMesh(mesh_shape, ("data", "model"))
    cell = specs.build_cell(cfg, shape, mesh, weight_mode=weight_mode)
    return cell, dryrun.execute(cell, mesh, train=shape.kind == "train")


def test_train_cell_small_mesh():
    cfg = configs.smoke("tinyllama_1_1b")
    cell, ran = _run(cfg, ShapeConfig("train_tiny", "train", 32, 8))
    assert ran["cost"]["flops"] > 0
    assert sum(ran["collective_bytes"].values()) > 0
    # ZeRO-3: the gathers over data and the gradients' reduce-scatter
    assert ran["collective_bytes_by_axis"]["all-gather@data"] > 0
    assert ran["collective_bytes_by_axis"]["reduce-scatter@data"] > 0
    assert set(cell.arg_bytes()) == {"params", "optimizer", "inputs",
                                     "total"}


def test_decode_cell_small_mesh():
    cfg = configs.smoke("tinyllama_1_1b")
    shape = ShapeConfig("decode_tiny", "decode", 64, 8)
    _, ran = _run(cfg, shape)
    assert ran["cost"]["flops"] > 0
    assert ran["collective_bytes"]["all-reduce"] > 0
    assert not ran["lscd"]
    # sparse: the LSCD launches, one row each, with their schedules
    _, ran = _run(cfg, shape, weight_mode="sparse_xla")
    assert ran["lscd"]
    for row in ran["lscd"]:
        assert row["n"] == 4 and row["count"] >= 1           # 8 rows / 2
        assert row["kernel"] in ("lscd_spmm", "lscd_spmm_grouped",
                                 "lscd_spmm_splitk",
                                 "lscd_spmm_splitk_grouped")
        assert row["predicted_s"] > 0
    assert ran["cost"]["lscd_flops"] > 0


def test_seq_shard_decode_cell_small_mesh():
    cfg = dataclasses.replace(configs.smoke("tinyllama_1_1b"), n_kv=2)
    cell, ran = _run(cfg, ShapeConfig("decode_one", "decode", 64, 1))
    k = cell.args[1][0]["k"]
    assert cell.args[1].seq == "data" and tuple(k.shape[:2]) == (1, 32)
    assert ran["collective_bytes_by_axis"]["all-reduce@data"] > 0


def test_main_writes_the_cell(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path / "results"))
    out = dryrun.main(["--arch", "tinyllama_1_1b", "--shape", "decode_32k"])
    assert out == {"ok": 1, "failed": 0}
    path = tmp_path / "results" / \
        "tinyllama_1_1b.decode_32k.16x16.dense.json"
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok"
    assert rec["memory"]["argument_bytes"]["total"] == 506_777_636
    assert rec["memory"]["temp_bytes"] is None
    assert rec["model_flops"] > 0 and rec["cost"]["flops"] > 0
    assert "[ok   ] tinyllama_1_1b" in capsys.readouterr().out
    # a second call reads the record back
    assert dryrun.run_cell("tinyllama_1_1b", "decode_32k",
                           multi_pod=False) == rec


def test_sparse_train_cell_names_item_13():
    rec = dryrun.run_cell("tinyllama_1_1b", "train_4k", multi_pod=False,
                          weight_mode="sparse_xla",
                          mesh=mesh_mod.make_production_mesh())
    assert rec["status"] == "error" and ITEM13 in rec["error"]


# every family runs every cell under a mesh: the train cells of the
# families that queue 1 item 14 brought under one (the name is the
# refusal test's that these cases replace)
REFUSED = [a for a in configs.ARCH_IDS
           if configs.get(a).family != "dense"
           or configs.get(a).attn_kind == "mla"]


@pytest.mark.parametrize("arch", REFUSED)
def test_other_families_name_item_14(arch, tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path / "results"))
    shape = [s for s in configs.cells(arch) if s.kind == "train"][0]
    rec = dryrun.run_cell(arch, shape.name, multi_pod=False,
                          mesh=mesh_mod.make_production_mesh())
    assert rec["status"] == "ok", rec.get("error")
    assert rec["cost"]["flops"] > 0
    assert rec["memory"]["argument_bytes"]["optimizer"] > 0
    _, ran = _run(configs.smoke(arch), ShapeConfig("t", "train", 32, 4))
    assert ran["cost"]["flops"] > 0
    # ZeRO-3: the gathers over data and the gradients' reduce-scatter
    assert ran["collective_bytes_by_axis"]["reduce-scatter@data"] > 0


# MoE and MLA decode cells on a dry 2x2 mesh: (arch, overrides)
FAMILY_CELLS = [("qwen3_moe_30b_a3b", {}), ("qwen2_moe_a2_7b",
                                            {"d_shared_expert": 128}),
                ("qwen2_moe_a2_7b", {"d_shared_expert": 128,
                                     "n_routed_experts": 6}),
                ("minicpm3_4b", {}), ("minicpm3_4b", {"n_heads": 6,
                                                      "n_kv": 6})]


@pytest.mark.parametrize("arch,over", FAMILY_CELLS,
                         ids=["qwen3_moe", "qwen2_moe", "qwen2_moe_e6",
                              "minicpm3", "minicpm3_six_heads"])
def test_family_decode_cell_small_mesh(arch, over):
    """The decode cell of an MoE or MLA smoke config on a dry 2x2 mesh:
    FLOPs and all-reduces above 0, the batch over ``data``; MoE's 8 rows
    a step split 4 a rank under a subgroup of 8, so the routing gathers
    the other data rank's counts and sums each expert's block over
    ``data``; in ``sparse_xla`` mode the LSCD launches at the rank's
    shapes (the routed stacks stay dense, as in the reference's
    struct)."""
    cfg = dataclasses.replace(configs.smoke(arch), **over)
    shape = ShapeConfig("decode_tiny", "decode", 64, 8)
    cell, ran = _run(cfg, shape)
    assert ran["cost"]["flops"] > 0
    assert ran["collective_bytes_by_axis"]["all-reduce@model"] > 0
    assert cell.args[1].batch == "data"
    if cfg.n_routed_experts:
        assert ran["collective_bytes_by_axis"]["all-gather@data"] > 0
        assert ran["collective_bytes_by_axis"]["all-reduce@data"] > 0
    else:                      # latents whole over model, batch over data
        assert cell.args[1].seq is None
        assert tuple(cell.args[1][0]["ckv"].shape) == (4, 64,
                                                       cfg.kv_lora_rank)
    _, ran = _run(cfg, shape, weight_mode="sparse_xla")
    assert ran["lscd"] and all(r["n"] == 4 for r in ran["lscd"])
    assert not any("batched" in r["kernel"] for r in ran["lscd"])


def test_head_dim_fallback_names_item_14():
    # 3 KV heads and 9 positions split neither over model 2: the layout
    # falls back to the head dim.
    cfg = dataclasses.replace(configs.smoke("tinyllama_1_1b"), n_heads=6,
                              n_kv=3, d_head=32)
    mesh = mesh_mod.DryMesh((2, 2), ("data", "model"))
    cache = transformer.init_cache(cfg, 2, 9, device="meta", mesh=mesh)
    assert cache.seq is None and cache.head_dim == "model"
    assert tuple(cache[0]["k"].shape) == (1, 9, 3, 16)
    cache = transformer.init_cache(cfg, 2, 8, device="meta", mesh=mesh)
    assert cache.seq == "model" and cache.head_dim is None
    assert tuple(cache[0]["k"].shape) == (1, 4, 3, 32)


def test_dry_mesh_allocates_nothing():
    mesh = mesh_mod.make_production_mesh(multi_pod=True)
    assert mesh.size() == 512 and mesh.mesh_dim_names == ("pod", "data",
                                                          "model")
    cell = specs.build_cell(configs.get("tinyllama_1_1b"),
                            configs.SHAPES["decode_32k"], mesh)
    for _, t in sharding.leaves_with_paths(cell.args):
        assert t.is_meta
    with torch.no_grad():
        logits, _ = cell.fn(*cell.args)
    assert logits.is_meta and logits.shape == (4, 1, 32000)


def test_meta_batched_launch_at_a_ranks_expert_count():
    """The meta branch of ``ops.spmm_batched`` notes an expert stack's
    launch at the experts a rank holds: a stack of 8 cut over a model
    axis of 4 (expert parallelism) is noted at 2, with the schedule's
    predicted H100 time over those 2."""
    from repro_torch.core import tiled_csl
    from repro_torch.kernels import ops
    from repro_torch.obs import profile as obs_profile
    words = torch.empty((8, 6, 16, 256), dtype=torch.int32, device="meta")
    nnz = torch.empty((8, 6, 16), dtype=torch.int32, device="meta")
    stack = tiled_csl.TiledCSL(words=words, nnz=nnz, shape=(768, 2048),
                               m_tb=128, k_tb=128, dtype=torch.bfloat16,
                               stack=True)
    mine = sharding.shard_tiled_csl(stack, ("model", None, None, None),
                                    {"model": 4}, coords={"model": 1})
    assert mine.experts == 2 and mine.max_nnz == 256
    b = torch.empty((2, 2048, 8), dtype=torch.bfloat16, device="meta")
    prof = obs_profile.KernelProfiler()
    with obs_profile.profiled(prof):
        out = ops.spmm_batched(mine, b)
    assert out.is_meta and tuple(out.shape) == (2, 768, 8)
    [row] = dryrun.launch_list(prof)
    assert row["kernel"].endswith("batched") and row["count"] == 1
    assert (row["m"], row["k"], row["n"]) == (768, 2048, 8)
    assert row["predicted_s"] > 0
    assert [r.experts for r in prof.launches.values()] == [2]


@pytest.mark.parametrize("arch", REFUSED)
def test_fsdp_splits_every_family_leaf_by_one_data_entry(arch):
    """ZeRO-3's specs of every leaf of each family's full config, on a
    2x2 and the 2x16x16 mesh: ``data`` only ever a whole entry of its
    own (``transformer.fsdp_gathered`` gathers and reduce-scatters over
    it and refuses an axis tuple holding it), and the routed expert
    stacks over ``model`` and ``data`` at once where E divides."""
    whole = specs.params_struct(configs.get(arch))
    for shape, names in (((2, 2), ("data", "model")),
                         ((2, 16, 16), ("pod", "data", "model"))):
        got = sharding.params_shardings(whole, mesh_mod.DryMesh(shape, names),
                                        fsdp=True)
        for path, spec in got.items():
            for e in spec:
                assert not (isinstance(e, tuple) and "data" in e), (path, e)
        split = [p for p, spec in got.items() if "data" in spec]
        assert split, (arch, shape)
        if configs.get(arch).n_routed_experts % shape[-1] == 0 and \
                configs.get(arch).n_routed_experts:
            stacks = [p for p in got if p.endswith("['moe']['gate']")]
            assert stacks and all(got[p][:2] == ("model", "data")
                                  for p in stacks), stacks
