"""Dry-run input specs and the cell builder.

The port's counterpart of ``repro.launch.specs``. ``input_specs(cfg,
shape)`` gives meta tensors for every model input of one (arch × shape)
cell: int32 tokens and targets, M-RoPE ``positions [3, B, S]``, a decode
step's token, 0-d int32 ``pos`` and K/V cache. ``build_cell`` assembles
one rank's step and its arguments, the rank's shards, under a mesh; on
``device="meta"`` (the dry run, ``launch.dryrun``, on a dry mesh from
``launch.mesh.make_production_mesh``) nothing is allocated, on a real
device inside a world (``launch.mesh.run_world``) the cell runs.

Weight modes keep the reference's names, so a cell's file has one name
across packages:

  dense      — f32 params for train, bf16 for serving;
  sparse_xla — Tiled-CSL params with the analytic ``max_nnz``
               (``serving.budget.analytic_max_nnz``:
               ceil(tile_elems·(1-s)·IMBALANCE / PAD_QUANTUM)·PAD_QUANTUM).
               In the port they run through the LSCD kernels (on meta,
               their launches are noted: ``kernels.ops``).

As in the reference, train cells shard params and AdamW moments for
FSDP (``params_shardings(..., fsdp=True)``) and recompute each block
(``remat="full"``); decode cells lay the cache out by
``cache_shardings`` with ``seq_shard`` at batch 1. A train cell in
``sparse_xla`` mode raises, as the reference's does (it differentiates
the Tiled-CSL words): ROADMAP.md queue 3 item 13. Every family runs
every cell under a mesh (its train cells in ``dense`` mode). In
``sparse_xla`` mode the
MoE routed stacks stay dense, as in the reference's struct (its
``sparse_params_struct`` encodes only leaves named ``['w']``), and the
RG-LRU and SSM projections are Tiled-CSL, as there (the serving build
keeps them dense: queue 3 item 4).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.core import tiled_csl
from repro_torch.distributed import sharding
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.serving import budget
from repro_torch.training import optimizer as opt_mod
from repro_torch.training import train_loop

WEIGHT_MODES = ("dense", "sparse_xla")
SPARSE_TRAIN_ITEM = "ROADMAP.md queue 3 item 13"
GROUPS = ("params", "optimizer", "cache", "inputs")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype,
                       device="meta")


# ---------------------------------------------------------------------------
# params / cache specs
# ---------------------------------------------------------------------------

def params_struct(cfg: ModelConfig, dtype=torch.float32):
    """The port's own init on meta: every leaf's shape and dtype."""
    return transformer.init_model(cfg, device="meta", dtype=dtype)


def _csl_struct(out_dim: int, in_dim: int,
                sparsity: float) -> tiled_csl.TiledCSL:
    m_tb, k_tb = tiled_csl.DEFAULT_M_TB, tiled_csl.DEFAULT_K_TB
    mt, kt = -(-out_dim // m_tb), -(-in_dim // k_tb)
    return tiled_csl.TiledCSL(
        words=_meta((mt, kt, budget.analytic_max_nnz(sparsity)),
                    torch.int32),
        nnz=_meta((mt, kt), torch.int32), shape=(mt * m_tb, kt * k_tb),
        m_tb=m_tb, k_tb=k_tb, dtype=torch.bfloat16)


def default_should_sparsify(path: str) -> bool:
    """The paper's recipe: sparsify the big projection/FFN weights; keep
    router, norms, embeddings, conv kernels, gates dense."""
    sparse_names = ("wq", "wk", "wv", "wo", "gate", "up", "down",
                    "w_uq", "w_ukv", "w_dq", "w_dkv", "in_proj", "out_proj",
                    "w_x", "w_gate", "w_out", "lm_head")
    if "router" in path or "embed" in path or "norm" in path:
        return False
    if not path.endswith("['w']"):
        return False              # biases must stay dense
    return any(f"'{n}'" in path for n in sparse_names)


def sparse_params_struct(cfg: ModelConfig, sparsity: float,
                         dtype=torch.bfloat16,
                         should_sparsify: Optional[Callable[[str], bool]]
                         = None):
    """The dense struct with selected weights replaced by Tiled-CSL
    structs, one a matrix (no projection grouping, as the reference's
    struct has none). The port's matrices are 2-D, where the reference's
    scan-stacked ones carry ``[L]``; its 4-D expert stacks, which it
    skips, are bare 3-D leaves here whose paths end in no ``['w']``."""
    should = should_sparsify or default_should_sparsify

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}['{k}']") for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, f"{prefix}[{i}]") for i, v in enumerate(tree)]
        if tree.dim() == 2 and should(prefix):
            return _csl_struct(tree.shape[0], tree.shape[1], sparsity)
        return tree
    return walk(params_struct(cfg, dtype), "")


def struct_weight_bytes(params) -> int:
    """Bytes of a params tree: Tiled-CSL leaves count their encoded
    streams (4 B a word, 4 B a tile's nnz counter), dense leaves their
    array bytes. Works on meta structs and on real trees."""
    return sum(leaf.numel() * leaf.element_size()
               for _, leaf in sharding.leaves_with_paths(params))


def cache_struct(cfg: ModelConfig, batch: int, max_len: int):
    return transformer.init_cache(cfg, batch, max_len, device="meta")


# ---------------------------------------------------------------------------
# input specs per shape kind
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Meta tensors for the step inputs of one (arch × shape) cell,
    whole (every rank's rows)."""
    B, S = shape.global_batch, shape.seq_len
    tok = (B, cfg.n_codebooks, S) if cfg.n_codebooks else (B, S)
    if shape.kind in ("train", "prefill"):
        out = {"tokens": _meta(tok, torch.int32)}
        if shape.kind == "train":
            out["targets"] = _meta(tok, torch.int32)
        if cfg.mrope_sections is not None:
            out["positions"] = _meta((3, B, S), torch.int32)
        return out
    if shape.kind == "decode":
        one = (B, cfg.n_codebooks, 1) if cfg.n_codebooks else (B, 1)
        return {"token": _meta(one, torch.int32),
                "pos": _meta((), torch.int32),
                "cache": cache_struct(cfg, B, S)}
    raise ValueError(shape.kind)


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    """One rank's step ``fn(*args)``: ``args`` are the rank's shards,
    ``groups`` maps each argument group (``GROUPS``) to its tensors, and
    ``specs`` the params' and the cache's per-leaf specs."""
    fn: Callable
    args: tuple
    groups: Dict[str, list]
    specs: Dict[str, Dict[str, tuple]]
    label: str

    def arg_bytes(self) -> Dict[str, int]:
        """Per-rank argument bytes by group and in ``"total"``."""
        out = {g: sum(t.numel() * t.element_size()
                      for _, t in sharding.leaves_with_paths(ts))
               for g, ts in self.groups.items()}
        out["total"] = sum(out.values())
        return out


def _rank_batch(x: torch.Tensor, spec, mesh, dev, gen) -> torch.Tensor:
    """This rank's block of a whole int32 input: on meta its shape, on
    a device random ids below 2 (any vocab takes them) from ``gen``."""
    shape = sharding.local_shape(x.shape, spec, mesh)
    if dev.type == "meta":
        return _meta(shape, x.dtype)
    return torch.randint(0, 2, shape, generator=gen, dtype=x.dtype,
                         device="cpu").to(dev)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               weight_mode: str = "dense", sparsity: float = 0.8,
               remat: Optional[str] = None, microbatches: int = 1,
               device: Any = "meta", seed: int = 0) -> Cell:
    """One rank's step and arguments for an (arch × shape) cell under
    ``mesh``: on meta (the dry run) or, for dense weights, on a real
    device inside a world (params from ``seed``)."""
    if weight_mode not in WEIGHT_MODES:
        raise ValueError(f"weight mode {weight_mode!r} not in "
                         f"{WEIGHT_MODES}")
    train = shape.kind == "train"
    if train and weight_mode == "sparse_xla":
        raise ValueError(
            f"{cfg.name}/{shape.name}: a train cell in sparse_xla mode "
            f"would differentiate the Tiled-CSL words, as the reference's "
            f"does and fails on ({SPARSE_TRAIN_ITEM})")
    dev = torch.device(device)
    if weight_mode == "sparse_xla" and dev.type != "meta":
        raise ValueError("a sparse_xla cell is built on meta only; on a "
                         "device, launch.serve.build encodes real weights")
    if remat is None and train:
        remat = "full"
    if remat is not None and remat != "keep":
        cfg = dataclasses.replace(cfg, remat=remat)
    transformer.rank_config(cfg, mesh)
    pdtype = torch.float32 if train else torch.bfloat16
    if weight_mode == "sparse_xla":
        whole = sparse_params_struct(cfg, sparsity, pdtype)
    elif dev.type == "meta":
        whole = params_struct(cfg, pdtype)
    else:
        whole = transformer.init_model(cfg, seed=seed, device=dev,
                                       dtype=pdtype)
    p_specs = sharding.params_shardings(whole, mesh, fsdp=train)
    params = sharding.shard_params(whole, mesh, fsdp=train)
    del whole
    specs = input_specs(cfg, shape)
    label = f"{cfg.name}/{shape.name}/{weight_mode}"
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    B, S = shape.global_batch, shape.seq_len

    def rank_inputs(names):
        return {k: _rank_batch(specs[k], sharding.batch_sharding(
            mesh, specs[k].dim(), batch_axis=1 if k == "positions" else 0,
            shape=specs[k].shape), mesh, dev, gen) for k in names}

    if train:
        opt = opt_mod.AdamW(lr=1e-4)
        step0 = torch.zeros((), dtype=torch.int32, device=dev)
        state = train_loop.TrainState(params, opt.init(params), step0)
        batch = rank_inputs(specs)
        step = train_loop.make_train_step(cfg, opt, microbatches=microbatches,
                                          mesh=mesh, shardings=p_specs,
                                          fsdp=True)
        return Cell(fn=step, args=(state, batch),
                    groups={"params": [params],
                            "optimizer": [state.opt_state, state.step],
                            "inputs": [batch]},
                    specs={"params": p_specs}, label=label)

    if shape.kind == "prefill":
        inputs = rank_inputs(specs)
        rows = inputs["tokens"].shape[0]

        def prefill_fn(params, inputs):
            cache = transformer.init_cache(cfg, B, S, device=dev, mesh=mesh)
            at = torch.full((rows,), S - 1, dtype=torch.int64, device=dev)
            logits, cache = transformer.forward(
                params, inputs, cfg, mode="prefill", cache=cache, mesh=mesh,
                logits_at=at)
            return logits[:, 0], cache
        return Cell(fn=prefill_fn, args=(params, inputs),
                    groups={"params": [params], "inputs": [inputs]},
                    specs={"params": p_specs}, label=label)

    seq_shard = B == 1
    c_specs = sharding.cache_shardings(specs["cache"], mesh,
                                       seq_shard=seq_shard)
    cache = transformer.init_cache(cfg, B, S, device=dev, mesh=mesh,
                                   seq_shard=seq_shard)
    rows = transformer.cache_rows(cache, mesh, B)
    token = specs["token"][rows]
    token = (_meta(token.shape, torch.int32) if dev.type == "meta"
             else torch.zeros(token.shape, dtype=torch.int32, device=dev))
    pos = (_meta((), torch.int32) if dev.type == "meta"
           else torch.zeros((), dtype=torch.int32, device=dev))

    def decode_fn(params, cache, token, pos):
        return transformer.forward(params, {"tokens": token}, cfg,
                                   mode="decode", cache=cache, pos=pos,
                                   mesh=mesh)
    return Cell(fn=decode_fn, args=(params, cache, token, pos),
                groups={"params": [params], "cache": [list(cache)],
                        "inputs": [token, pos]},
                specs={"params": p_specs, "cache": c_specs}, label=label)
