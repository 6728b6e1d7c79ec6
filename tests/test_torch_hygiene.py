"""Port hygiene: import boundaries, device discipline, no silent fallback.

* No file under ``src/repro_torch/``, no ``chip_smoke.py``, neither
  ``tools/torch_gemm_sweep.py`` nor ``tools/torch_check.py`` and no
  ``examples/torch_*.py`` imports jax or the reference package
  (checked on the AST, not by text search).
* Entry points called with no ``device`` on a box without CUDA raise
  instead of running on the CPU; the examples' ``main`` too.
* Every top-level function and class, and every method of a top-level
  class, of each ``src/repro/**/*.py`` has a same-named counterpart in
  the port module of the same path, or stands in ``NOT_PORTED`` with its
  reason.
* A kernel wrapper given a CPU tensor with ``backend="cuda"`` raises.
* Every config of the JAX package has its copy in the port, which the
  port's family check accepts.
"""

import ast
import dataclasses
import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro_torch import configs, convert
from repro_torch.core import tiled_csl
from repro_torch.kernels import ops, spmm
from repro_torch.launch import serve
from repro_torch.models import transformer

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "torch_gemm_sweep.py",
    ROOT / "tools" / "torch_check.py",
    ROOT / "tools" / "torch_lifecycle_lr.py"] + EXAMPLES


def _banned(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _banned(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _banned(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str) and _banned(node.args[0].value):
            bad.append(node.args[0].value)
    assert not bad, f"{path}: imports {bad}"


def test_port_files_exist():
    names = {p.name for p in PORT_FILES}
    assert {"chip_smoke.py", "spmm.py", "ops.py", "engine.py",
            "serve.py", "speculative.py"} <= names


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise(monkeypatch):
    _no_cuda(monkeypatch)
    cfg = configs.smoke("opt_30b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.params_from_numpy({"embed": {"table": np.zeros((4, 4))}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "opt_30b", "--smoke", "--requests", "1",
                    "--max-new", "2", "--max-len", "4"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.build(cfg, sparsity=0.8)


def _example(path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_four_examples_are_ported():
    assert [p.stem for p in EXAMPLES] == [
        "torch_quickstart", "torch_serve_batched", "torch_serve_chaos",
        "torch_train_prune_serve"]
    for p in EXAMPLES:
        assert (ROOT / "examples" / f"{p.stem.removeprefix('torch_')}.py"
                ).exists()


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_examples_default_to_cuda_and_raise(path, monkeypatch):
    main = _example(path).main
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([])


def test_entry_points_run_on_cpu_when_asked():
    cfg = configs.smoke("tinyllama_1_1b")
    rep = serve.run(cfg, requests=2, prompt_len=4, max_new=2, sparsity=0.8,
                    device="cpu")
    assert rep["tokens"].shape == (2, 6)
    assert rep["tokens"].device.type == "cpu"


def _small():
    a = torch.zeros(128, 128)
    a[3, 5] = 1.0
    return tiled_csl.encode(a)


def test_cuda_backend_on_cpu_tensor_raises():
    t = _small()
    b = torch.ones(128, 4)
    with pytest.raises(ValueError, match="CUDA"):
        ops.spmm(t, b, backend="cuda")
    g = tiled_csl.group_stack([t, t])
    with pytest.raises(ValueError, match="CUDA"):
        ops.spmm_grouped(g, b, backend="cuda")


@pytest.mark.parametrize("name", spmm.KERNELS)
def test_raw_kernel_entries_refuse_cpu_tensors(name):
    t, b = _small(), torch.ones(128, 8)
    if "grouped" in name:
        t = tiled_csl.group_stack([t, t])
    if "batched" in name:
        t = tiled_csl.encode_stack(tiled_csl.decode(t).expand(2, -1, -1))
        b = torch.ones(2, 128, 8)
    before = spmm.launch_counts()[name]
    with pytest.raises(ValueError, match="CUDA"):
        getattr(spmm, name)(t, b, n_tb=8)
    assert spmm.launch_counts()[name] == before


def test_auto_backend_on_cpu_uses_plain_version_without_counting():
    spmm.reset_launch_counts()
    t = _small()
    y = ops.spmm(t, torch.ones(128, 3))
    assert float(y[3, 0]) == 1.0 and float(y.sum()) == 3.0
    assert sum(spmm.launch_counts().values()) == 0


def test_kernel_sources_carry_their_note():
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    notes = [(name, "Replaces the TPU kernel repro/kernels/spmm.py:" + name)
             for name in spmm.WEIGHT_KERNELS]
    notes += [(name, "Replaces jax.vmap over the TPU kernel "
               "repro/kernels/spmm.py:" + name.removesuffix("_batched"))
              for name in spmm.BATCHED_KERNELS]
    for name, note in notes:
        text = re.sub(r"\s*\n//\s*", " ", (csrc / f"{name}.cu").read_text())
        assert note in text
        assert "Bound on an H100" in text


_REF_ARCHS = ref_configs.ARCH_IDS + ref_configs.PAPER_IDS


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", _REF_ARCHS)
def test_port_serves_every_reference_config(arch, smoke):
    """Every config of the JAX package has the port's own copy, equal
    field for field, and ``transformer``'s family check accepts it."""
    get = "smoke" if smoke else "get"
    pcfg = getattr(configs, get)(arch)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(
        getattr(ref_configs, get)(arch))
    transformer._check_family(pcfg)
    assert configs.LONG_CTX_ARCHS == ref_configs.LONG_CTX_ARCHS


# --- name-level counterparts of the reference's modules -------------------

# "module:name" of the reference with no same-named counterpart in the
# port module of the same path, and why. "renamed: X" and "moved: path:X"
# name the port's counterpart, which the guard checks exists.
NOT_PORTED = {
    # analysis
    "analysis/budgets.py:compile_budget": "renamed: capture_budget",
    "analysis/budgets.py:prefill_compile_budget":
        "renamed: prefill_shape_budget",
    "analysis/budgets.py:vmem_budget": "renamed: smem_budget",
    "analysis/contracts.py:ScheduleContractError.__init__":
        "the port's launch checks return problem strings (check_launch), "
        "not Findings; the error takes their joined message",
    "analysis/contracts.py:VmemBreakdown":
        "TPU: a Pallas schedule's VMEM; the port sizes shared memory "
        "(smem_bytes)",
    "analysis/contracts.py:VmemBreakdown.main_bytes": "TPU: as VmemBreakdown",
    "analysis/contracts.py:VmemBreakdown.total_bytes":
        "TPU: as VmemBreakdown",
    "analysis/contracts.py:schedule_vmem_breakdown":
        "TPU: as VmemBreakdown",
    "analysis/contracts.py:check_schedule": "renamed: check_launch",
    "analysis/contracts.py:require_schedule": "renamed: require_launch",
    "analysis/contracts.py:check_kernel_source":
        "moved: analysis/kernel_pass.py:check_cuda_source",
    "analysis/contracts.py:kernel_source_files":
        "moved: analysis/kernel_pass.py:cuda_source_files",
    "analysis/contracts.py:check_declared_out":
        "moved: analysis/kernel_pass.py:check_declared_out",
    "analysis/contracts.py:_dotted":
        "TPU: reads Pallas sources' AST for KC-ACC; the port reads CUDA "
        "text (kernel_pass.check_cuda_source)",
    "analysis/contracts.py:_is_f32": "TPU: as _dotted",
    "analysis/lint.py:_FileLinter._check_key_reuse":
        "renamed: _FileLinter._check_seed_reuse",
    "analysis/lint.py:_FileLinter._check_traced_branch":
        "renamed: _FileLinter._check_torch_branch",
    "analysis/lint.py:_FileLinter._check_traced_test":
        "jax: a traced value's loop test; eager torch has none",
    "analysis/lint.py:_FileLinter.visit_Assign":
        "the port flags a mutation while iterating at visit_Delete and "
        "visit_Call",
    "analysis/lint.py:_FileLinter.visit_Expr": "as visit_Assign",
    "analysis/trace_audit.py:_build_decode":
        "jax: a smoke step's jaxpr; the port audits live steppers "
        "(stepper_entries)",
    "analysis/trace_audit.py:_build_mixed": "jax: as _build_decode",
    "analysis/trace_audit.py:_build_prefill": "jax: as _build_decode",
    "analysis/trace_audit.py:_build_verify": "jax: as _build_decode",
    "analysis/trace_audit.py:_build_spmm": "renamed: spmm_entry",
    "analysis/trace_audit.py:_smoke_model": "jax: as _build_decode",
    "analysis/trace_audit.py:_sub_jaxprs":
        "jax: walks jaxprs, broken under jax 0.9 (ROADMAP.md queue 3 item "
        "16); the port's Census walks dispatched aten ops",
    "analysis/trace_audit.py:_walk_eqns": "jax: as _sub_jaxprs",
    "analysis/trace_audit.py:audit_jaxpr": "jax: as _sub_jaxprs",
    "analysis/trace_audit.py:audit_retrace":
        "jax: jit retraces; the port counts CUDA-graph captures "
        "(budgets.capture_budget)",
    # core
    "core/roofline.py:cost_analysis_dict": "renamed: cost_dict",
    "core/roofline.py:_epilogue_is_binary":
        "moved: kernels/spmm.py:epilogue_kind",
    "core/sparse_linear.py:linear_logical_out":
        "a positional-argument wrapper over linear; the port's callers "
        "pass linear(declared_out=)",
    "core/roofline.py:from_cost_analysis": "renamed: from_cost_dict",
    "core/roofline.py:parse_collective_bytes": "renamed: collective_bytes",
    "core/tiled_csl.py:_tcsl_flatten_with_keys":
        "jax: TiledCSL's pytree registration",
    "core/tiled_csl.py:_tcsl_unflatten": "jax: as _tcsl_flatten_with_keys",
    "core/tiled_csl.py:decode_jax": "renamed: decode",
    # distributed
    "distributed/compression.py:compressed_psum":
        "renamed: compressed_all_reduce",
    "distributed/compression.py:_dequantize":
        "inlined in compressed_all_reduce",
    "distributed/fault_tolerance.py:_flatten_with_paths":
        "renamed: flatten_with_paths",
    "distributed/fault_tolerance.py:_unflatten_like":
        "renamed: unflatten_like",
    "distributed/sharding.py:_spec":
        "jax: PartitionSpec builders of the rules table; the port's is "
        "spec_for",
    "distributed/sharding.py:_vec": "jax: as _spec",
    "distributed/sharding.py:_replicate": "jax: as _spec",
    "distributed/sharding.py:_csl_words": "renamed: _csl",
    "distributed/sharding.py:_csl_nnz": "renamed: _csl",
    "distributed/sharding.py:_context_mesh":
        "jax: the enclosing jax mesh; the port passes its mesh",
    "distributed/sharding.py:constrain":
        "jax: a GSPMD sharding constraint, broken under jax 0.9 (ROADMAP.md "
        "queue 3 item 12); the port's ranks compute their shards",
    # kernels
    "kernels/gemm.py:_gemm_kernel":
        "TPU: the Pallas kernel body; the port's is csrc/dense_gemm.cu",
    "kernels/ops.py:_on_tpu": "TPU: the backend probe; the port's is "
                              "resolve_backend",
    "kernels/ops.py:_pick_schedule": "renamed: _pick",
    "kernels/ops.py:_spmm_fwd": "jax: custom_vjp; the port's is _SpmmDiff",
    "kernels/ops.py:_spmm_bwd": "jax: as _spmm_fwd",
    "kernels/ops.py:_spmm_diff": "renamed: _SpmmDiff",
    "kernels/schedule.py:_select_analytic": "renamed: select_analytic",
    "kernels/spmm.py:_require_launch": "renamed: _check",
    "kernels/spmm.py:_splitk_chunk":
        "TPU: a Pallas index map's K chunk; the CUDA kernels compute it",
    "kernels/spmm.py:_unpack_scatter":
        "TPU: the Pallas bodies' scatter; the port's bodies are in csrc/",
    **{f"kernels/spmm.py:{name}": "TPU: a Pallas kernel body; the port's "
       "bodies are in csrc/" for name in (
           "_lscd_spmm_kernel", "_lscd_spmm_kernel_bias",
           "_lscd_spmm_grouped_kernel", "_lscd_spmm_grouped_kernel_bias",
           "_lscd_spmm_splitk_kernel", "_lscd_spmm_splitk_grouped_kernel",
           "_splitk_reduce_kernel", "_splitk_reduce_kernel_bias",
           "_splitk_reduce_grouped_kernel",
           "_splitk_reduce_grouped_kernel_bias")},
    # launch
    "launch/dryrun.py:_probe_costs":
        "jax: compiled cost_analysis; the port counts dispatched ops "
        "(CostCounter)",
    "launch/specs.py:_struct": "renamed: _meta",
    # models
    "models/attention.py:_chunked_attention":
        "jax: lax.scan over query chunks; the port's prefill loops its "
        "chunks over _attend",
    "models/attention.py:_full_scores_attention": "renamed: _attend",
    "models/attention.py:_split_heads": "inlined in _project_qkv",
    "models/nn.py:DTypePolicy": "jax: jnp dtypes; the port casts by "
                                "cfg.dtype",
    "models/nn.py:DTypePolicy.__init__": "jax: as DTypePolicy",
    "models/nn.py:split_keys": "jax: PRNG keys; the port draws from one "
                               "torch.Generator",
    "models/nn.py:stack_layers": "jax: stacks layers for lax.scan; the "
                                 "port keeps a list",
    "models/transformer.py:_use_scan": "renamed: uses_scan",
    "models/transformer.py:init_block_cache": "inlined in init_cache",
    # serving
    "serving/engine.py:sample": "jax: PRNG-key sampling; the port's is "
                                "sample_per_slot",
    "serving/engine.py:fold_slot_keys":
        "jax: PRNG keys per slot; the port hashes (uid, index) "
        "(_slot_noise)",
    "serving/speculative.py:DraftModelDrafter._rollout_fn":
        "jax: a jit cache of rollouts; the port's rollout runs eagerly",
    "serving/step.py:DeviceStepper.prefill_compiles":
        "jax: the jit cache's size; the port counts prefill_shapes",
}
_REF = ROOT / "src" / "repro"
_PORT = ROOT / "src" / "repro_torch"
_REF_MODULES = sorted(str(p.relative_to(_REF)) for p in _REF.rglob("*.py"))


def _defined(path: pathlib.Path) -> set:
    """Top-level functions and classes, and the methods of top-level
    classes (``Class.method``)."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef):
            out.add(node.name)
            out |= {f"{node.name}.{m.name}" for m in node.body if isinstance(
                m, (ast.FunctionDef, ast.AsyncFunctionDef))}
    return out


@pytest.mark.parametrize("module", _REF_MODULES)
def test_reference_names_have_port_counterparts(module):
    assert (_PORT / module).exists(), f"no port module {module}"
    missing = sorted(_defined(_REF / module) - _defined(_PORT / module))
    unexplained = [n for n in missing if f"{module}:{n}" not in NOT_PORTED]
    assert not unexplained, f"{module}: no counterpart and no reason for " \
        f"{unexplained} (port them, or add them to NOT_PORTED)"


def test_not_ported_table_is_live():
    """Every entry names a reference name the port still lacks, with a
    reason; a rename or move names a port definition that exists."""
    for key, reason in NOT_PORTED.items():
        module, name = key.split(":")
        assert name in _defined(_REF / module), f"{key}: not in the reference"
        assert name not in _defined(_PORT / module), f"{key}: now ported"
        assert reason.strip(), key
        if reason.startswith("renamed: "):
            target = reason.removeprefix("renamed: ")
            assert target in _defined(_PORT / module), key
        elif reason.startswith("moved: "):
            where, target = reason.removeprefix("moved: ").split(":")
            assert target in _defined(_PORT / where), key
