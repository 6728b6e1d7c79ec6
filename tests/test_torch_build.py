"""The layer-by-layer sparse build and the serving CLI's remaining flags.

* ``serve.build`` with a sparsity draws, prunes and encodes one layer at a
  time; its result must equal ``init_model`` + ``sparsify_params`` +
  ``group_projections`` over the whole tree bit for bit (words, nnz,
  dense leaves, key order), at 2 layers and at 4, where the layers'
  own ``max_nnz`` differ and the second pass must re-pad them to the
  stack's largest.
* ``--hbm-budget-gb`` sizes the paged pool to the reference planner's
  ``n_blocks``; the SLO, fault-plan, digest and trace flags run through
  ``serve.main(..., device="cpu")``.
"""

import dataclasses
import json

import pytest
import torch

from repro import configs as ref_configs
from repro.serving import budget as ref_budget
from repro_torch import configs
from repro_torch.core import pruning, tiled_csl
from repro_torch.launch import serve
from repro_torch.models import transformer
from repro_torch.serving import faults

SPARSITY = 0.8


def _whole_tree_build(cfg, seed):
    params = transformer.init_model(cfg, seed=seed, device="cpu")
    params = pruning.group_projections(pruning.sparsify_params(
        params, SPARSITY,
        should_sparsify=lambda n: any(k in n for k in serve.SPARSE_NAMES)))
    dt = getattr(torch, cfg.dtype)
    params["embed"]["table"] = params["embed"]["table"].to(dt)
    params["lm_head"]["w"] = params["lm_head"]["w"].to(dt)
    return params


def _assert_same(a, b, path=""):
    if isinstance(a, tiled_csl.TiledCSL):
        assert isinstance(b, tiled_csl.TiledCSL), path
        assert (a.shape, a.m_tb, a.k_tb, a.dtype) == \
            (b.shape, b.m_tb, b.k_tb, b.dtype), path
        assert torch.equal(a.words, b.words), path
        assert torch.equal(a.nnz, b.nnz), path
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}['{k}']")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    else:
        assert a.dtype == b.dtype and torch.equal(a, b), path


@pytest.mark.parametrize("n_layers", [None, 4])
@pytest.mark.parametrize("arch", ["opt_30b", "tinyllama_1_1b"])
def test_layered_build_equals_whole_tree_build(arch, n_layers):
    cfg = configs.smoke(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    want = _whole_tree_build(cfg, seed=3)
    got, rep = serve.build(cfg, seed=3, sparsity=SPARSITY, device="cpu")
    _assert_same(want, got)
    csl = serve.tiled_csl_leaves(got)
    assert rep["n_tiled_csl"] == len(csl) > 0
    assert rep["sparse_bytes"] == sum(t.nbytes_sparse for t in csl)
    assert rep["weight_bytes"] == serve.params_bytes(got)
    assert rep["encode_s"] > 0 and rep["build_s"] >= rep["encode_s"]
    assert rep["max_memory_allocated"] is None


def test_four_layer_build_repads_the_stack():
    """At 4 OPT smoke layers the layers' own pad targets differ, so the
    second pass has work to do; every layer ends at the stack's largest."""
    cfg = dataclasses.replace(configs.smoke("opt_30b"), n_layers=4)
    own = []
    for name, part in transformer.init_model_parts(cfg, seed=3,
                                                   device="cpu"):
        if name == "layers":
            enc = pruning.sparsify_params(
                part, SPARSITY,
                should_sparsify=lambda n: any(k in n for k in
                                              serve.SPARSE_NAMES))
            own.append({p: t.max_nnz
                        for p, t in pruning.tiled_csl_paths(enc)})
    assert any(len({o[p] for o in own}) > 1 for p in own[0])
    got, _ = serve.build(cfg, seed=3, sparsity=SPARSITY, device="cpu")
    for p in own[0]:                    # e.g. "['attn']['wq']['w']"
        top = max(o[p] for o in own)
        part, leaf = p.split("'")[1], p.split("'")[3]
        leaf = "wqkv" if leaf in ("wq", "wk", "wv") else leaf
        for layer in got["layers"]:
            assert layer[part][leaf]["w"].max_nnz >= top


def test_dense_build_is_init_model():
    cfg = configs.smoke("opt_30b")
    want = transformer.init_model(cfg, seed=1, device="cpu")
    got, rep = serve.build(cfg, seed=1, device="cpu")
    dt = getattr(torch, cfg.dtype)
    want["embed"]["table"] = want["embed"]["table"].to(dt)
    want["lm_head"]["w"] = want["lm_head"]["w"].to(dt)
    _assert_same(want, got)
    assert rep["n_tiled_csl"] == 0 and rep["encode_s"] == 0.0


@pytest.mark.parametrize("sparsity", [None, 0.8])
def test_hbm_budget_sizes_the_pool_as_the_reference(sparsity, capsys):
    gb = 0.02
    argv = ["--arch", "opt_30b", "--smoke", "--paged", "--hbm-budget-gb",
            str(gb), "--requests", "3", "--slots", "2", "--max-new", "3",
            "--max-len", "32"]
    if sparsity:
        argv += ["--sparsity", str(sparsity)]
    rep = serve.main(argv, device="cpu")
    want = ref_budget.plan(
        ref_configs.smoke("opt_30b"), hbm_budget=int(gb * 1e9),
        weight_mode="sparse_pallas" if sparsity else "dense",
        sparsity=sparsity or 0.8, block=16)
    assert rep["n_blocks"] == want.n_blocks
    assert rep["server"].batcher.pool.n_blocks == want.n_blocks
    assert rep["plan"].as_dict() == want.as_dict()
    out = capsys.readouterr().out
    assert f"{want.n_blocks} KV blocks x 16 tok" in out
    assert len(rep["responses"]) == 3


def test_n_blocks_flag_wins_over_the_budget():
    rep = serve.main(["--arch", "opt_30b", "--smoke", "--paged",
                      "--hbm-budget-gb", "0.02", "--n-blocks", "40",
                      "--requests", "2", "--slots", "2", "--max-new", "3",
                      "--max-len", "32"], device="cpu")
    assert rep["n_blocks"] == 40 and "plan" not in rep


def test_slo_fault_digest_and_trace_flags(tmp_path, capsys):
    plan_path = tmp_path / "plan.json"
    faults.FaultPlan([faults.FaultEvent(step=2, kind="step_error",
                                        op="decode", attempts=1)]
                     ).save(str(plan_path))
    trace_path = tmp_path / "trace.json"
    rep = serve.main(["--arch", "tinyllama_1_1b", "--smoke", "--paged",
                      "--requests", "4", "--slots", "2", "--max-new", "4",
                      "--max-len", "32", "--ttft-target-ms", "60000",
                      "--tpot-target-ms", "60000", "--priority", "2",
                      "--fault-plan", str(plan_path), "--digest-every",
                      "600", "--trace-out", str(trace_path)], device="cpu")
    out = capsys.readouterr().out
    assert "fault plan: 1 events" in out
    assert "faults: 1/1 events fired" in out
    assert "slo[default]: ttft 4/4 met" in out
    assert "digest: steps_total=" in out
    assert len(rep["responses"]) == 4
    assert all(r.slo is not None and r.slo.priority == 2
               for r in rep["responses"])
    events = json.loads(trace_path.read_text())["traceEvents"]
    assert any(e.get("name") == "decode" for e in events)
