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
* splits scan-stacked ``[L, ...]`` leaves under ``"layers"`` into a list
  of L per-layer dicts, Tiled-CSL words included (``[L, mt, kt, w]`` and
  grouped ``[L, G, mt, kt, w]``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.tiled_csl import TiledCSL
from repro_torch.device import DeviceLike, resolve_device

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


def _layer(tree: Any, i: int) -> Any:
    """Element ``i`` of a scan-stacked subtree."""
    if is_tiled_csl_like(tree):
        return TiledCSL(words=tree.words[i], nnz=tree.nnz[i],
                        shape=tree.shape, m_tb=tree.m_tb, k_tb=tree.k_tb,
                        dtype=tree.dtype)
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
    out = _leaf(params, dev)
    if isinstance(out, dict) and isinstance(out.get("layers"), dict):
        stacked = out["layers"]
        out["layers"] = [_layer(stacked, i) for i in range(_n_layers(stacked))]
    return out
