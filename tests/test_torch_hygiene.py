"""Port hygiene: import boundaries, device discipline, no silent fallback.

* No file under ``src/repro_torch/``, no ``chip_smoke.py`` and neither
  ``tools/torch_gemm_sweep.py`` nor ``tools/torch_check.py`` imports jax
  or the reference package
  (checked on the AST, not by text search).
* Entry points called with no ``device`` on a box without CUDA raise
  instead of running on the CPU.
* A kernel wrapper given a CPU tensor with ``backend="cuda"`` raises.
* Every config of the JAX package has its copy in the port, which the
  port's family check accepts.
"""

import ast
import dataclasses
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
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "torch_gemm_sweep.py",
    ROOT / "tools" / "torch_check.py"]


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
