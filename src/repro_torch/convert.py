"""Bring the JAX package's params, already as numpy arrays, into the port.

The reference's params are a pytree of dicts whose dense-family layers
are scan-stacked (``params["layers"]`` holds ``[L, ...]`` leaves); its
Tiled-CSL weights are ``TiledCSL`` objects with uint32 ``words``. The
caller hands them over with every array leaf already a numpy array (for
example ``jax.tree.map(np.asarray, params)``). :func:`params_from_numpy`
then

* recognises a Tiled-CSL leaf by duck typing (``words``, ``nnz``,
  ``shape``, ``m_tb``, ``k_tb``), so the port never imports ``repro``,
  and brings ``words`` in as an int32 tensor with the same bits;
* marks the MoE expert stacks (``moe["gate"]``, ``["up"]``,
  ``["down"]``) that are Tiled-CSL as expert stacks (``TiledCSL.stack``):
  their words ``[E, mt, kt, w]`` have a grouped encoding's layout, and
  only their place in the tree tells them apart;
* splits scan-stacked ``[L, ...]`` leaves under ``"layers"`` into a list
  of L per-layer dicts, Tiled-CSL words included (``[L, mt, kt, w]``,
  grouped ``[L, G, mt, kt, w]`` and expert stacks ``[L, E, mt, kt, w]``);
  the MoE router ``[L, E, d]`` and dense expert stacks ``[L, E, f, d]``
  split the same way.

:func:`rank_params_from_numpy` brings them across whole, prunes and
encodes them whole where a sparsity is given (one threshold over each
whole matrix: pruning a shard by its own threshold gives other masks),
and keeps a mesh rank's shard (``distributed.sharding``).

:func:`train_state_from_checkpoint` reads a training checkpoint, one
that ``repro.launch.train`` wrote or the port's own, into a port
``TrainState`` (params, AdamW moments and step) and the data stream's
state; :func:`params_from_checkpoint` reads only the params. A
reference checkpoint's leaves are ``keystr`` paths over its
``(TrainState, data state)`` pair, scan-stacked ``[L, ...]`` where the
config scans its layers; the moments have the params' structure, so
:func:`params_from_numpy` brings params, ``mu`` and ``nu`` across alike.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import pruning
from repro_torch.core.tiled_csl import TiledCSL
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.distributed import sharding
from repro_torch.training import optimizer, train_loop

_TCSL_ATTRS = ("words", "nnz", "shape", "m_tb", "k_tb")


def is_tiled_csl_like(x: Any) -> bool:
    return all(hasattr(x, a) for a in _TCSL_ATTRS)


def _torch_dtype(name) -> torch.dtype:
    s = str(getattr(name, "name", name))
    return {"bfloat16": torch.bfloat16, "float16": torch.float16}.get(
        s, torch.float32)


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)                    # same bits
    if str(a.dtype) == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)    # a writable copy


def _leaf(x: Any, device) -> Any:
    if is_tiled_csl_like(x):
        return TiledCSL(words=_tensor(x.words, device),
                        nnz=_tensor(x.nnz, device).to(torch.int32),
                        shape=tuple(int(d) for d in x.shape),
                        m_tb=int(x.m_tb), k_tb=int(x.k_tb),
                        dtype=_torch_dtype(getattr(x, "dtype", "float32")))
    if isinstance(x, dict):
        return {k: _leaf(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_leaf(v, device) for v in x]
    if x is None:
        return None
    return _tensor(x, device)


EXPERT_STACKS = ("gate", "up", "down")


def _mark_expert_stacks(tree: Any) -> Any:
    """The Tiled-CSL leaves ``moe[name]`` for name in ``EXPERT_STACKS``
    as expert stacks, in place."""
    if isinstance(tree, dict):
        moe = tree.get("moe")
        if isinstance(moe, dict):
            for name in EXPERT_STACKS:
                if isinstance(moe.get(name), TiledCSL):
                    moe[name] = dataclasses.replace(moe[name], stack=True)
        for v in tree.values():
            _mark_expert_stacks(v)
    elif isinstance(tree, list):
        for v in tree:
            _mark_expert_stacks(v)
    return tree


def _layer(tree: Any, i: int) -> Any:
    """Element ``i`` of a scan-stacked subtree."""
    if is_tiled_csl_like(tree):
        return dataclasses.replace(tree, words=tree.words[i],
                                   nnz=tree.nnz[i])
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _n_layers(tree: Any) -> int:
    if is_tiled_csl_like(tree):
        return int(tree.nnz.shape[0])
    if isinstance(tree, dict):
        return _n_layers(next(iter(tree.values())))
    return int(tree.shape[0])


def params_from_numpy(params: Any, *, device: DeviceLike = None) -> Any:
    """The reference's params (numpy leaves) as port params on ``device``
    (default ``"cuda"``): tensors, TiledCSL, per-layer lists."""
    dev = resolve_device(device)
    out = _mark_expert_stacks(_leaf(params, dev))
    if isinstance(out, dict) and isinstance(out.get("layers"), dict):
        stacked = out["layers"]
        out["layers"] = [_layer(stacked, i) for i in range(_n_layers(stacked))]
    return out


def rank_params_from_numpy(params: Any, mesh, *, device: DeviceLike = None,
                          sparsity: Optional[float] = None,
                          should_sparsify=None) -> Any:
    """This rank's shard of the reference's params (numpy leaves): whole
    through :func:`params_from_numpy`, with ``sparsity`` pruned and
    encoded whole (``pruning.sparsify_params`` with ``should_sparsify``,
    then ``group_projections``), then cut by the sharding rules."""
    whole = params_from_numpy(params, device=device)
    if sparsity:
        whole = pruning.group_projections(pruning.sparsify_params(
            whole, sparsity, should_sparsify))
    return sharding.shard_params(whole, mesh)


def _checkpoint_tree(directory: str, step: Optional[int], prefix: str):
    arrays, meta = ft.CheckpointManager(directory).read(step=step,
                                                        prefix=prefix)
    if not arrays:
        raise KeyError(f"checkpoint in {directory} has no leaf under "
                       f"{prefix!r}")
    dtypes = meta.get("dtypes", {})
    if dtypes:             # the port's bf16 leaves: their uint16 bits
        arrays = {k: (torch.from_numpy(np.ascontiguousarray(v).view(
            np.int16)).view(torch.bfloat16).to(torch.float32).numpy()
            if dtypes.get(k) == "bfloat16" else v)
            for k, v in arrays.items()}
    return ft.tree_from_paths(arrays), meta


def params_from_checkpoint(directory: str, *, step: Optional[int] = None,
                           device: DeviceLike = None) -> Tuple[Any, dict]:
    """The params subtree (``[0].params``) of a training checkpoint (the
    newest unless ``step`` is given), the reference's or the port's, as
    port params on ``device``; and the checkpoint's manifest."""
    tree, meta = _checkpoint_tree(directory, step, "[0].params")
    return params_from_numpy(tree[0]["params"], device=device), meta


def train_state_from_checkpoint(directory: str, *,
                                step: Optional[int] = None,
                                device: DeviceLike = None):
    """(TrainState, data state dict, manifest) from a training checkpoint
    that ``repro.launch.train`` (AdamW) wrote, or the port's: params and
    the ``mu``/``nu`` moments through :func:`params_from_numpy`, the
    optimizer's and the state's step as int32 0-d tensors, and the data
    stream's ``{"seed", "step"}``."""
    tree, meta = _checkpoint_tree(directory, step, "")
    state, data = tree[0], tree[1]
    dev = resolve_device(device)

    def step_of(x):
        return torch.tensor(int(np.asarray(x)), dtype=torch.int32,
                            device=dev)
    opt = state["opt_state"]
    opt_state = optimizer.AdamWState(
        step=step_of(opt["step"]),
        mu=params_from_numpy(opt["mu"], device=dev),
        nu=params_from_numpy(opt["nu"], device=dev))
    ts = train_loop.TrainState(
        params=params_from_numpy(state["params"], device=dev),
        opt_state=opt_state, step=step_of(state["step"]))
    data_state = {k: int(np.asarray(v)) for k, v in data.items()}
    return ts, data_state, meta
