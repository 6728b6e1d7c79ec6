"""The port's dry-run specs (``launch.specs``) and K/V cache layouts
(``sharding.cache_shardings``) against the reference's, on abstract and
dry meshes, with no device.

* ``input_specs``, ``sparse_params_struct`` and ``cache_struct``: every
  leaf's shape and dtype equal the reference's (a scan config's ``[L]``
  entry dropped; Tiled-CSL words int32 where the reference's are uint32,
  both 4 bytes) for every arch × cell; ``struct_weight_bytes`` and
  ``_model_flops`` equal (the reference's ``_model_flops`` is read out of
  its ``launch/dryrun.py`` source, whose import would fix the host's
  device count).
* ``cache_shardings`` equals the reference's spec per leaf for every
  config, smoke and full, on meshes (2, 2), (1, 4), (4, 2), (16, 16) and
  (2, 16, 16), ``seq_shard`` on and off.
* Per-rank argument bytes of every cell that runs under a mesh
  (``build_cell`` on a dry mesh: every cell of every family, the train
  cells in dense mode) equal the reference's by-hand count
  (``shard_shape`` bytes over ``cell.args``) by group and in total, on
  16x16 and 2x16x16, both weight modes; and, on a 2x2 mesh of four
  forced host devices made with Auto axes, the compiled reference's
  ``argument_size_in_bytes`` for smoke tinyllama's dense cells and a
  smoke qwen3-moe and minicpm3 decode and train cell (the by-hand count
  for the sparse ones).
"""

import ast
import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.distributed import sharding as ref_sharding
from repro.launch import specs as ref_specs
from repro.models.config import ShapeConfig as RefShape
from repro_torch import configs
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import specs
from repro_torch.models import transformer
from repro_torch.models.config import ShapeConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REF_PARAMS_STRUCT = ref_specs.params_struct
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# every family runs every cell under a mesh (train cells in dense mode)
MESH_ARCHS = configs.ARCH_IDS
# The reference's per-rank argument bytes of its 16x16 cells (by hand,
# ``NamedSharding.shard_shape``), which the port's dry run must give.
TABLE_16x16 = {
    ("tinyllama_1_1b", "train_4k", "dense"): 53_190_664,
    ("tinyllama_1_1b", "prefill_32k", "dense"): 137_940_992,
    ("tinyllama_1_1b", "prefill_32k", "sparse_xla"): 816_416_128,
    ("tinyllama_1_1b", "decode_32k", "dense"): 506_777_636,
    ("tinyllama_1_1b", "decode_32k", "sparse_xla"): 1_185_252_772,
    ("qwen2_1_5b", "train_4k", "dense"): 73_972_744,
    ("qwen2_1_5b", "prefill_32k", "dense"): 193_390_592,
    ("qwen2_1_5b", "prefill_32k", "sparse_xla"): 1_258_244_480,
    ("qwen2_1_5b", "decode_32k", "dense"): 662_890_532,
    ("qwen2_1_5b", "decode_32k", "sparse_xla"): 1_727_744_420,
    ("deepseek_coder_33b", "train_4k", "dense"): 1_574_187_016,
    ("deepseek_coder_33b", "prefill_32k", "dense"): 4_169_816_064,
    ("deepseek_coder_33b", "prefill_32k", "sparse_xla"): 31_080_493_312,
    ("deepseek_coder_33b", "decode_32k", "dense"): 8_330_303_524,
    ("deepseek_coder_33b", "decode_32k", "sparse_xla"): 35_240_980_772,
    ("qwen2_moe_a2_7b", "train_4k", "dense"): 708_128_776,
    ("qwen2_moe_a2_7b", "prefill_32k", "dense"): 1_795_446_784,
    ("qwen2_moe_a2_7b", "prefill_32k", "sparse_xla"): 2_696_573_120,
    ("qwen2_moe_a2_7b", "decode_32k", "dense"): 5_016_410_148,
    ("qwen2_moe_a2_7b", "decode_32k", "sparse_xla"): 5_917_536_484,
    ("qwen3_moe_30b_a3b", "train_4k", "dense"): 1_442_938_888,
    ("qwen3_moe_30b_a3b", "prefill_32k", "dense"): 3_817_148_416,
    ("qwen3_moe_30b_a3b", "prefill_32k", "sparse_xla"): 4_098_394_304,
    ("qwen3_moe_30b_a3b", "decode_32k", "dense"): 5_427_499_044,
    ("qwen3_moe_30b_a3b", "decode_32k", "sparse_xla"): 5_708_744_932,
    ("minicpm3_4b", "train_4k", "dense"): 1_014_929_416,
    ("minicpm3_4b", "prefill_32k", "dense"): 1_324_401_664,
    ("minicpm3_4b", "prefill_32k", "sparse_xla"): 4_211_195_744,
    ("minicpm3_4b", "decode_32k", "dense"): 10_685_826_084,
    ("minicpm3_4b", "decode_32k", "sparse_xla"): 13_572_620_164,
    ("recurrentgemma_9b", "train_4k", "dense"): 484_917_256,
    ("recurrentgemma_9b", "prefill_32k", "dense"): 1_253_761_024,
    ("recurrentgemma_9b", "prefill_32k", "sparse_xla"): 710_046_336,
    ("recurrentgemma_9b", "decode_32k", "dense"): 1_279_713_316,
    ("recurrentgemma_9b", "decode_32k", "sparse_xla"): 735_998_628,
    ("recurrentgemma_9b", "long_500k", "dense"): 1_255_301_128,
    ("recurrentgemma_9b", "long_500k", "sparse_xla"): 711_586_440,
    ("mamba2_130m", "train_4k", "dense"): 80_424_712,
    ("mamba2_130m", "prefill_32k", "dense"): 205_144_960,
    ("mamba2_130m", "prefill_32k", "sparse_xla"): 164_322_112,
    ("mamba2_130m", "decode_32k", "dense"): 360_006_564,
    ("mamba2_130m", "decode_32k", "sparse_xla"): 319_183_716,
    ("mamba2_130m", "long_500k", "dense"): 224_273_288,
    ("mamba2_130m", "long_500k", "sparse_xla"): 183_450_440,
    ("qwen2_vl_2b", "train_4k", "dense"): 74_759_176,
    ("qwen2_vl_2b", "prefill_32k", "dense"): 194_177_024,
    ("qwen2_vl_2b", "prefill_32k", "sparse_xla"): 1_259_030_912,
    ("qwen2_vl_2b", "decode_32k", "dense"): 662_890_532,
    ("qwen2_vl_2b", "decode_32k", "sparse_xla"): 1_727_744_420,
    ("musicgen_large", "train_4k", "dense"): 123_158_536,
    ("musicgen_large", "prefill_32k", "dense"): 308_273_152,
    ("musicgen_large", "prefill_32k", "sparse_xla"): 146_764_032,
    ("musicgen_large", "decode_32k", "dense"): 6_749_675_652,
    ("musicgen_large", "decode_32k", "sparse_xla"): 6_588_166_532,
}


def _abstract(name):
    return jax.sharding.AbstractMesh(*MESHES[name])


def _dry(name):
    return mesh_mod.DryMesh(*MESHES[name])


def _scan(arch) -> bool:
    return transformer.uses_scan(configs.get(arch))


def _ref_leaves(tree):
    """{keystr: leaf} of a reference struct tree."""
    return {jax.tree_util.keystr(p): x
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_name(dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def _same_leaves(port: dict, ref: dict, scan: bool, what: str):
    """Every port leaf's shape and dtype against the reference leaf it is
    a layer of; every reference leaf met."""
    seen = set()
    for path, leaf in port.items():
        ref_path = sharding.reference_path(path, scan=scan)
        if ref_path not in ref and path.startswith("[") and scan:
            ref_path = path.split("]", 1)[1]       # a stacked cache's
        want = ref[ref_path]
        stacked = scan and len(want.shape) == leaf.dim() + 1
        shape = tuple(want.shape[1:] if stacked else want.shape)
        assert tuple(leaf.shape) == shape, (what, path)
        name = str(want.dtype).replace("uint32", "int32")
        assert _port_name(leaf.dtype) == name, (what, path, want.dtype)
        seen.add(ref_path)
    assert seen == set(ref), (what, sorted(set(ref) - seen))


@functools.lru_cache(maxsize=None)
def _ref_cache_struct(rcfg, batch, max_len):
    return ref_specs.cache_struct(rcfg, batch, max_len)


@functools.lru_cache(maxsize=None)
def _ref_model_flops():
    path = os.path.join(ROOT, "src", "repro", "launch", "dryrun.py")
    tree = ast.parse(open(path).read())
    fn = [n for n in tree.body if isinstance(n, ast.FunctionDef)
          and n.name == "_model_flops"]
    ns: dict = {}
    exec(compile(ast.Module(body=fn, type_ignores=[]), path, "exec"), ns)
    return ns["_model_flops"]


def _ref_shape(shape):
    return RefShape(shape.name, shape.kind, shape.seq_len,
                    shape.global_batch)


@pytest.fixture(autouse=True)
def _cached_ref_params_struct(monkeypatch):
    """The reference's ``params_struct`` (``jax.eval_shape`` of its init)
    once per config and dtype: a pure function of them, which
    ``build_cell`` and ``sparse_params_struct`` call for every cell."""
    monkeypatch.setattr(ref_specs, "params_struct", _ref_params_struct)


@functools.lru_cache(maxsize=None)
def _ref_params_struct(cfg, dtype=jnp.float32):
    return _REF_PARAMS_STRUCT(cfg, dtype)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_structs_and_inputs_are_the_references(arch):
    cfg, rcfg = configs.get(arch), ref_configs.get(arch)
    scan = _scan(arch)
    want = ref_specs.sparse_params_struct(rcfg, 0.8, jnp.bfloat16)
    got = specs.sparse_params_struct(cfg, 0.8, torch.bfloat16)
    _same_leaves(dict(sharding.leaves_with_paths(got)), _ref_leaves(want),
                 scan, "params")
    assert specs.struct_weight_bytes(got) == \
        ref_specs.struct_weight_bytes(want)
    assert specs.struct_weight_bytes(specs.params_struct(cfg)) == \
        ref_specs.struct_weight_bytes(ref_specs.params_struct(rcfg))
    for shape in configs.cells(arch):
        rshape = _ref_shape(shape)
        want = ref_specs.input_specs(rcfg, rshape)
        got = specs.input_specs(cfg, shape)
        assert set(got) == set(want), shape.name
        for k in got:
            if k == "cache":
                _same_leaves(dict(sharding.leaves_with_paths(got[k])),
                             _ref_leaves(want[k]), scan, "cache")
            else:
                assert tuple(got[k].shape) == tuple(want[k].shape), k
                assert _port_name(got[k].dtype) == str(want[k].dtype), k
        assert dryrun._model_flops(cfg, shape) == \
            _ref_model_flops()(rcfg, rshape)
    assert [s.name for s in configs.cells(arch)] == \
        [s.name for s in ref_configs.cells(arch)]


def _cache_cases(cfg):
    if cfg.n_layers > 8:                       # a full config's cells
        return [(s.global_batch, s.seq_len) for s in configs.SHAPES.values()]
    return [(4, 64), (1, 64), (3, 14), (8, 6)]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_cache_shardings_match_reference(arch, mesh_name):
    amesh = _abstract(mesh_name)
    scan = _scan(arch)
    n = 0
    for cfg, rcfg in ((configs.smoke(arch), ref_configs.smoke(arch)),
                      (configs.get(arch), ref_configs.get(arch))):
        for batch, max_len in _cache_cases(cfg):
            rcache = _ref_cache_struct(rcfg, batch, max_len)
            pcache = specs.cache_struct(cfg, batch, max_len)
            for seq_shard in (False, True):
                ref = ref_sharding.cache_shardings(rcache, amesh,
                                                   stacked=scan,
                                                   seq_shard=seq_shard)
                want = {jax.tree_util.keystr(p): tuple(s.spec)
                        for p, s in jax.tree_util.tree_flatten_with_path(
                            ref, is_leaf=lambda x: isinstance(
                                x, jax.sharding.NamedSharding))[0]}
                got = sharding.cache_shardings(
                    pcache, dict(zip(*MESHES[mesh_name][::-1])),
                    seq_shard=seq_shard)
                for path, spec in got.items():
                    rpath = path.split("]", 1)[1] if scan else path
                    rspec = want[rpath]
                    nd = len(spec) + (1 if scan else 0)
                    rspec = tuple(rspec) + (None,) * (nd - len(rspec))
                    if scan:
                        assert rspec[0] is None
                        rspec = rspec[1:]
                    assert spec == rspec, (path, batch, max_len, seq_shard)
                    n += 1
    assert n > 0


def _ref_arg_bytes(arch, shape, mesh, weight_mode):
    """The reference's per-rank argument bytes by group, by hand."""
    cell = ref_specs.build_cell(ref_configs.get(arch), _ref_shape(shape),
                                mesh, weight_mode=weight_mode)

    def nbytes(args, shards):
        leaves = jax.tree.leaves(args)
        sh = jax.tree.leaves(shards, is_leaf=lambda x: isinstance(
            x, jax.sharding.NamedSharding))
        assert len(leaves) == len(sh)
        return sum(int(np.prod(s.shard_shape(tuple(x.shape))))
                   * np.dtype(x.dtype).itemsize for x, s in zip(leaves, sh))
    a, s = cell.args, cell.in_shardings
    if shape.kind == "train":
        out = {"params": nbytes(a[0].params, s[0].params),
               "optimizer": nbytes((a[0].opt_state, a[0].step),
                                   (s[0].opt_state, s[0].step)),
               "inputs": nbytes(a[1], s[1])}
    elif shape.kind == "prefill":
        out = {"params": nbytes(a[0], s[0]), "inputs": nbytes(a[1], s[1])}
    else:
        out = {"params": nbytes(a[0], s[0]), "cache": nbytes(a[1], s[1]),
               "inputs": nbytes(a[2:], s[2:])}
    out["total"] = sum(out.values())
    return out


@pytest.mark.parametrize("mesh_name", ("16x16", "2x16x16"))
@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_per_rank_argument_bytes_match_reference(arch, mesh_name):
    for shape in configs.cells(arch):
        for mode in specs.WEIGHT_MODES:
            if shape.kind == "train" and mode == "sparse_xla":
                continue
            cell = specs.build_cell(configs.get(arch), shape,
                                    _dry(mesh_name), weight_mode=mode)
            got = cell.arg_bytes()
            want = _ref_arg_bytes(arch, shape, _abstract(mesh_name), mode)
            assert got == want, (shape.name, mode)
            key = (arch, shape.name, mode)
            if mesh_name == "16x16" and key in TABLE_16x16:
                assert got["total"] == TABLE_16x16[key], key


def test_the_16x16_table_is_covered():
    assert {a for a, _, _ in TABLE_16x16} <= set(MESH_ARCHS)


_COMPILED = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np
    from jax.sharding import AxisType
    from repro import configs
    from repro.launch import specs
    from repro.models.config import ShapeConfig
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    import dataclasses
    out = {}
    for name, kind, seq, batch, arch, over in json.loads(sys.argv[1]):
        cfg = dataclasses.replace(configs.smoke(arch), **over)
        shape = ShapeConfig(name, kind, seq, batch)
        for mode in ("dense", "sparse_xla"):
            if kind == "train" and mode == "sparse_xla":
                continue
            with mesh:
                cell = specs.build_cell(cfg, shape, mesh, weight_mode=mode)
                leaves = jax.tree.leaves(cell.args)
                sh = jax.tree.leaves(cell.in_shardings, is_leaf=lambda x:
                                     isinstance(x, jax.sharding.NamedSharding))
                hand = sum(int(np.prod(s.shard_shape(tuple(x.shape))))
                           * np.dtype(x.dtype).itemsize
                           for x, s in zip(leaves, sh))
                compiled = None
                if mode == "dense":
                    c = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                                donate_argnums=cell.donate
                                ).lower(*cell.args).compile()
                    compiled = c.memory_analysis().argument_size_in_bytes
            out[f"{name}/{mode}"] = {"hand": hand, "compiled": compiled}
    print(json.dumps(out))
""")

# smoke tinyllama, its one KV head made two for the batch-1 decode (one
# KV head over model 2 with the sequence over data would split the head
# dim, the layout tests/test_torch_mesh_ring.py serves); an MoE and an
# MLA decode
# cell and train cell (smoke qwen3-moe, whose 8 experts split over
# model; smoke minicpm3, its latents whole over model).
TINY = "tinyllama_1_1b"
SMALL = [("train", "train", 32, 4, TINY, {"n_kv": 1}),
         ("prefill", "prefill", 32, 4, TINY, {"n_kv": 1}),
         ("decode", "decode", 64, 4, TINY, {"n_kv": 1}),
         ("decode1", "decode", 64, 1, TINY, {"n_kv": 2}),
         ("moe_decode", "decode", 64, 4, "qwen3_moe_30b_a3b", {}),
         ("mla_decode", "decode", 64, 4, "minicpm3_4b", {}),
         ("moe_train", "train", 32, 4, "qwen3_moe_30b_a3b", {}),
         ("mla_train", "train", 32, 4, "minicpm3_4b", {})]


def test_argument_bytes_match_the_compiled_reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", _COMPILED,
                          json.dumps(SMALL)], capture_output=True,
                         text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    for name, kind, seq, batch, arch, over in SMALL:
        cfg = dataclasses.replace(configs.smoke(arch), **over)
        shape = ShapeConfig(name, kind, seq, batch)
        for mode in specs.WEIGHT_MODES:
            if kind == "train" and mode == "sparse_xla":
                continue
            got = specs.build_cell(cfg, shape, _dry("2x2"),
                                   weight_mode=mode).arg_bytes()["total"]
            w = want[f"{name}/{mode}"]
            assert got == w["hand"], (name, mode)
            if mode == "dense":
                assert got == w["compiled"], (name, mode)
