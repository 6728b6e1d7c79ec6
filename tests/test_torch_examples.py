"""The port's four example entry points (``examples/torch_*.py``) on the
CPU, against the reference examples of the same stem.

Each runs at its smallest arguments with ``device="cpu"``. The lifecycle
example (``torch_train_prune_serve``) runs at the reference's demo
widths for 3 + 1 steps; on the same params, brought over from the
reference, its masks and its Tiled-CSL bytes equal the reference
example's rule computed here with ``repro.core.pruning``, and its greedy
streams (f32 compute on both sides) equal those of
``repro.serving.batching.ContinuousBatcher`` by the near-tie rule of
``tests/torch_serving_parity.py``.
"""

import dataclasses
import importlib.util
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pruning as ref_pruning
from repro.core import roofline as ref_roofline
from repro.core import tiled_csl as ref_csl
from repro.models import transformer as ref_tf
from repro.models.config import ModelConfig as RefModelConfig
from repro.serving import batching as ref_batching
from repro.serving.config import SchedulerConfig, ServeConfig
from repro_torch import convert
from repro_torch.core import pruning, tiled_csl
from repro_torch.distributed import fault_tolerance as ft
from torch_serving_parity import assert_streams_agree

ROOT = pathlib.Path(__file__).resolve().parents[1]


def example(stem):
    spec = importlib.util.spec_from_file_location(
        stem, ROOT / "examples" / f"{stem}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_within_bf16_rounding():
    out = example("torch_quickstart").main([], device="cpu")
    w, x = out["w_pruned"], out["x"]
    # The encoding rounds each value to bf16 (half an ulp: at most 2^-8
    # of its size, bf16's unit roundoff), so each output moves by at most
    # 2^-8 of sum |w| |x|, beside which the f32 sums' error is negligible.
    tol = 2.0 ** -8 * float((w.abs() @ x.abs()).max())
    assert 0.0 < out["err"] <= tol
    assert out["err"] == float((out["y"] - out["y_dense"]).abs().max())
    ref = ref_csl.encode(w.numpy())
    np.testing.assert_array_equal(out["encoded"].words.numpy(),
                                  np.asarray(ref.words).view(np.int32))
    assert out["encoded"].pad_overhead == ref.pad_overhead
    m, k, n = w.shape[0], w.shape[1], x.shape[1]
    for got, want in ((out["dense"], ref_roofline.dense_gemm_terms(m, k, n)),
                      (out["lscd"], ref_roofline.lscd_kernel_terms(
                          m, k, n, 0.8, pad_overhead=ref.pad_overhead))):
        assert (got.flops, got.hbm_bytes) == (want.flops, want.hbm_bytes)


@pytest.mark.parametrize("argv", [
    ["--requests", "3"],
    ["--requests", "4", "--paged", "--cancel-after", "2"],
], ids=["dense", "paged-cancel"])
def test_serve_batched_runs_on_cpu(argv):
    out = example("torch_serve_batched").main(argv, device="cpu")
    n = int(argv[1])
    assert sorted(r.session_id for r in out["responses"]) == \
        [f"req{i}" for i in range(n)]
    assert all(r.finish_reason for r in out["responses"])
    assert not out["server"].busy
    if "--cancel-after" in argv:
        assert {r.session_id: r.finish_reason
                for r in out["responses"]}["req3"] == "cancelled"


def test_serve_batched_moe_refuses_at_three_slots_as_reference():
    """ROADMAP.md queue 3 item 18, reference-side and kept: the reference
    example's own command (``--arch qwen2_moe_a2_7b`` at the default 3
    slots) admits 3 rows of a 32-token bucket, 96 tokens, which do not
    split into MoE subgroups of 64: the reference asserts, the port
    refuses (``tests/test_torch_moe.py::
    test_subgroup_refusals_match_reference``). 4 slots serve."""
    main = example("torch_serve_batched").main
    with pytest.raises(ValueError, match="96 tokens do not split into "
                                         "subgroups of 64"):
        main(["--arch", "qwen2_moe_a2_7b", "--requests", "4"], device="cpu")
    out = main(["--arch", "qwen2_moe_a2_7b", "--requests", "4", "--slots",
                "4"], device="cpu")
    assert all(r.finish_reason for r in out["responses"])


def test_serve_chaos_survivors_match_the_fault_free_run():
    out = example("torch_serve_chaos").main([], device="cpu")
    assert out["quarantined"] == 1
    assert out["survivors"] == len(out["chaos"]) - 1 == 4
    assert out["report"]["fired"] == 3


def test_train_prune_serve_main_on_cpu():
    out = example("torch_train_prune_serve").main(["--steps", "3"],
                                                  device="cpu")
    assert all(math.isfinite(v) for v in out["losses"].values())
    assert out["masked_nonzero"] == [0]
    assert out["bytes"]["n_tiled_csl"] == 4 * out["cfg"].n_layers
    assert 0 < out["bytes"]["sparse_bytes"] < out["bytes"]["dense_bytes"]
    assert len(out["served"]["done"]) == 8
    assert all(len(v) == 12 for v in out["served"]["done"].values())


def test_lifecycle_lr_tool_on_cpu():
    """``tools/torch_lifecycle_lr.py`` at the tinyllama smoke config: one
    row a rate, its losses those of the example's functions, its start
    loss that of the params ``train`` starts from."""
    spec = importlib.util.spec_from_file_location(
        "torch_lifecycle_lr", ROOT / "tools" / "torch_lifecycle_lr.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    rows = tool.main(["--smoke", "--layers", "2", "--steps", "2",
                      "--finetune", "1", "--lr", "1e-3", "3e-4"],
                     device="cpu")
    assert [r["lr"] for r in rows] == [1e-3, 3e-4]
    ex = example("torch_train_prune_serve")
    cfg = dataclasses.replace(tool.configs.smoke("tinyllama_1_1b"),
                              n_layers=2)
    for r in rows:
        assert all(math.isfinite(r[k])
                   for k in ("start", "dense", "pruned", "retrained"))
        assert len(r["losses"]) == 2 and len(r["retrain_losses"]) == 1
        assert ex.train(cfg, 2, lr=r["lr"], device="cpu")["losses"] == \
            r["losses"]
    assert rows[0]["start"] == rows[1]["start"]


# --- the lifecycle against the reference example's rule -------------------

ATTENTION = ("'wq'", "'wk'", "'wv'", "'wo'")


def _reference_masks(params, cfg):
    """``examples/train_prune_serve.py``'s ``make_masks``, verbatim."""
    plan = ref_pruning.opt_style_plan(cfg.n_layers, 0.8)

    def f(path, x):
        key = jax.tree_util.keystr(path)
        if x.ndim == 3 and any(k in key for k in ("'gate'", "'up'", "'down'",
                                                  "'wq'", "'wk'", "'wv'",
                                                  "'wo'")):
            per = []
            for layer in range(x.shape[0]):
                s = plan[layer] if "'mlp'" in key else 0.8
                per.append(ref_pruning.unstructured_mask(jnp.abs(x[layer]), s)
                           if s > 0 else jnp.ones_like(x[layer], dtype=bool))
            return jnp.stack(per)
        return None
    return jax.tree_util.tree_map_with_path(f, params)


def test_lifecycle_masks_bytes_and_streams_match_reference():
    ex = example("torch_train_prune_serve")
    cfg = ex.demo_config()
    rcfg = RefModelConfig(**dataclasses.asdict(cfg))
    # the reference's params tree, its values drawn from a numpy seed
    rng = np.random.default_rng(0)
    jparams = jax.tree.map(
        lambda s: jnp.asarray(rng.standard_normal(s.shape, np.float32)
                              / np.sqrt(s.shape[-1])),
        jax.eval_shape(lambda: ref_tf.init_model(jax.random.PRNGKey(0),
                                                 rcfg)))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    # masks: the port's rule against the reference example's
    jmasks = _reference_masks(jparams, rcfg)
    masks = ex.make_masks(params, cfg)
    stacked = {jax.tree_util.keystr(p): np.asarray(m) for p, m in
               jax.tree_util.tree_flatten_with_path(jmasks)[0]}
    got = dict(ft.flatten_with_paths(masks))
    assert len(got) == len(stacked) * cfg.n_layers == 7 * cfg.n_layers
    for path, m in got.items():          # ['layers'][i]... -> [i] of a stack
        i = int(path.split("]")[1].lstrip("["))
        ref_path = path.replace(f"['layers'][{i}]", "['layers']")
        np.testing.assert_array_equal(m.numpy(), stacked[ref_path][i], path)
    kept = {p: float(m.float().mean()) for p, m in got.items()}
    assert kept["['layers'][0]['mlp']['up']['w']"] == 1.0      # plan: dense
    assert kept["['layers'][1]['mlp']['up']['w']"] == pytest.approx(0.2)
    # reformat: the attention's Tiled-CSL, byte for byte
    jpruned = jax.tree.map(lambda p, m: p if m is None else jnp.where(
        m, p, 0.0), jparams, jmasks, is_leaf=lambda x: x is None)
    jsparse = ref_pruning.sparsify_params(
        jpruned, 0.0, should_sparsify=lambda n: any(k in n for k in ATTENTION))
    jcsl = [t for t in jax.tree.leaves(
        jsparse, is_leaf=lambda x: isinstance(x, ref_csl.TiledCSL))
        if isinstance(t, ref_csl.TiledCSL)]
    sparse, nbytes = ex.reformat(ex.opt_mod.apply_masks(params, masks))
    assert nbytes["dense_bytes"] == sum(t.nbytes_dense for t in jcsl)
    assert nbytes["sparse_bytes"] == sum(t.nbytes_sparse for t in jcsl)
    want = dict(pruning.tiled_csl_paths(convert.params_from_numpy(
        jax.tree.map(np.asarray, jsparse), device="cpu")))
    got = dict(pruning.tiled_csl_paths(sparse))
    assert sorted(got) == sorted(want) and len(got) == 4 * cfg.n_layers
    for path, t in got.items():
        assert isinstance(t, tiled_csl.TiledCSL)
        assert torch.equal(t.words, want[path].words), path
        assert torch.equal(t.nnz, want[path].nnz), path
    # serve: greedy streams against the reference's batcher, f32 compute
    f32 = dataclasses.replace(cfg, dtype="float32")
    served = ex.serve(sparse, f32)
    b = ref_batching.ContinuousBatcher(
        jsparse, dataclasses.replace(rcfg, dtype="float32"),
        config=ServeConfig(scheduler=SchedulerConfig(n_slots=4, max_len=64)))
    for uid, prompt in served["prompts"].items():
        b.submit(uid, prompt, 12)
    ref_done = b.run_to_completion()
    assert len(ref_done) == 8
    assert assert_streams_agree(sparse, f32, served["prompts"],
                                served["done"], ref_done) == 0
