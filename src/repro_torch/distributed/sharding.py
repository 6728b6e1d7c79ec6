"""Sharding rules: param-tree paths -> partition specs, and a rank's shard.

The port's counterpart of ``repro.distributed.sharding``: the same
MaxText-style rules, as pure functions. A spec is a tuple with one entry
a dim, each ``None``, a mesh-axis name or a tuple of names (the entries
of the reference's ``PartitionSpec``).

* ``model`` axis: tensor parallelism (TP): attention heads, the MLP's
  hidden dim, the vocabulary, MoE's expert dim (EP).
* ``data`` (and ``pod``) axes: the batch (DP); with ``fsdp`` also the
  matrices' free dim.
* Tiled-CSL leaves ``words [lead..., mt, kt, max_nnz]`` shard the out
  tile axis ``mt`` (column-parallel) or the in tile axis ``kt``
  (row-parallel) over ``model``: the encoding is tile-aligned, so a
  shard never splits a tile, and a slice keeps the whole leaf's
  ``max_nnz``.

Paths are ``keystr`` strings over the port's trees (``['layers'][3]
['attn']['wq']['w']``, ``.words`` / ``.nnz`` under a Tiled-CSL leaf).
The port's layers are a list, where the reference's scan configs stack
them ``[L, ...]``; the rules match names, not the layer index, and a
stacked leaf's ``[L]`` entry is always ``None``, so a per-layer leaf
takes the reference's spec with that entry dropped
(:func:`reference_path` spells a port path the reference's way).

A mesh is anything that names its axes and their sizes: a
``DeviceMesh`` (``launch.mesh``), a dry mesh (``launch.mesh.DryMesh``),
a mapping ``{axis: size}``, or an object whose ``shape`` is such a
mapping.

:func:`cache_shardings` is the reference's K/V and state cache layout
over the port's per-layer cache list: the batch over ``(pod, data)``,
the K/V sequence over ``model`` (flash-decode style), with the KV heads
and then the head dim as fallbacks, and with ``seq_shard`` (batch 1) the
sequence over ``data``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.core import tiled_csl

DATA_AXES = ("pod", "data")   # batch shards over both (pod present or not)

Entry = Any                   # None, an axis name, or a tuple of names
Spec = Tuple[Entry, ...]


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh``, a mapping, or an object whose
    ``shape`` is a mapping."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                       # a DeviceMesh
        return {n: int(mesh.size(i)) for i, n in enumerate(names)}
    return {str(k): int(v) for k, v in dict(mesh.shape).items()}


def coordinates(mesh) -> Dict[str, int]:
    """This rank's index on every axis of a ``DeviceMesh``."""
    return {n: int(mesh.get_local_rank(n)) for n in mesh.mesh_dim_names}


def batch_axes(mesh) -> Tuple[str, ...]:
    names = axis_sizes(mesh)
    return tuple(a for a in DATA_AXES if a in names)


# ---------------------------------------------------------------------------
# rules (the reference's, entry for entry)
# ---------------------------------------------------------------------------

def _is_routed_expert(path: str) -> bool:
    """Routed-expert weight stacks [.., E, out, in] (not router / shared)."""
    return "moe" in path and "shared" not in path and "router" not in path


def _mat(out_axis, in_axis, path: str, ndim: int, shape=None,
         model_size: int = 16) -> Spec:
    """A [out, in] matrix with 0-2 leading stack dims. MoE expert stacks
    shard their E dim over model (EP), or inside each expert (TP) where E
    does not divide the model axis."""
    lead = ndim - 2
    if _is_routed_expert(path):
        e = shape[lead - 1] if (shape is not None and lead >= 1) else None
        if e is not None and e % model_size:
            return (None,) * lead + (out_axis, in_axis)
        pre = ((None,) * (lead - 1) + ("model",)) if lead >= 1 else ()
        return pre + (None, None)
    return (None,) * lead + (out_axis, in_axis)


def _csl(out_sharded: bool, path: str, ndim: int, words: bool) -> Spec:
    """words [lead..., mt, kt, max_nnz] or nnz [lead..., mt, kt]."""
    lead = ndim - (3 if words else 2)
    tail = (None,) if words else ()
    if _is_routed_expert(path):
        pre = ((None,) * (lead - 1) + ("model",)) if lead >= 1 else ()
        return pre + (None, None) + tail
    mt_ax, kt_ax = ("model", None) if out_sharded else (None, "model")
    return (None,) * lead + (mt_ax, kt_ax) + tail


# Column-parallel (out dim over model) and row-parallel (in dim over
# model) weight families: the Megatron pairing.
COL = ("wq", "wk", "wv", "gate", "up", "w_uq", "w_ukv", "w_dq", "in_proj",
       "w_x", "w_gate", "wa", "lm_head", "gate_up", "wqkv")
ROW = ("wo", "down", "out_proj", "w_out")


def rule_for(path: str, ndim: int, *, fsdp: bool = False, shape=None,
             model_size: int = 16) -> Spec:
    """The spec of a param leaf at ``path`` (before :func:`fit_spec`)."""
    is_words = path.endswith(".words")
    is_nnz = path.endswith(".nnz")
    other = "data" if fsdp else None

    def family(names) -> bool:
        return any(f"'{n}'" in path for n in names)

    if "'embed'" in path:                  # [V, d] or [n_cb, V, d]
        if is_words or is_nnz:
            return _csl(True, path, ndim, is_words)
        return (None,) * (ndim - 2) + ("model", other)

    if family(("router",)):                # [.., E, d]: E aligns with EP
        if is_words:
            return (None,) * (ndim - 3) + ("model", None, None)
        return (None,) * (ndim - 2) + ("model", None)

    def expert_divides() -> bool:
        lead = ndim - 2
        if shape is None or lead < 1:
            return True
        return shape[lead - 1] % model_size == 0

    for names, out_sharded in ((COL, True), (ROW, False)):
        if not family(names):
            continue
        if is_words or is_nnz:
            return _csl(out_sharded, path, ndim, is_words)
        if ndim == 1 or path.endswith("['b']"):       # bias [out]
            # column-parallel bias over model; row-parallel replicated
            return (None,) * (ndim - 1) + ("model",) if out_sharded else ()
        if _is_routed_expert(path) and fsdp and expert_divides():
            lead = ndim - 2
            pre = ((None,) * (lead - 1) + ("model",)) if lead >= 1 else ()
            return pre + ("data", None)           # EP + expert-dim FSDP
        if out_sharded:
            return _mat("model", other, path, ndim, shape, model_size)
        return _mat(other, "model", path, ndim, shape, model_size)

    # norms, gates, conv kernels, w_dkv, scalars: replicated
    return ()


def _canon(entry: Entry) -> Entry:
    """A tuple of one axis name is that name (as ``PartitionSpec`` holds
    it)."""
    return entry[0] if isinstance(entry, tuple) and len(entry) == 1 \
        else entry


def fit_spec(spec: Sequence[Entry], shape: Sequence[int], mesh) -> Spec:
    """Drop the spec's axes that do not divide their dim (a prefix of an
    axis tuple where one does), and pad to the leaf's rank."""
    sizes = axis_sizes(mesh)
    out = []
    for i, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        size = 1
        for n in names:
            size *= sizes[n]
        if i < len(shape) and shape[i] % size == 0:
            out.append(_canon(entry))
        elif not isinstance(entry, tuple) or len(names) == 1:
            out.append(None)
        else:
            kept, rem = [], shape[i] if i < len(shape) else 0
            for n in names:
                if rem % sizes[n] == 0:
                    kept.append(n)
                    rem //= sizes[n]
            out.append(_canon(tuple(kept)) if kept else None)
    out += [None] * (len(shape) - len(out))
    return tuple(out)


def spec_for(path: str, shape: Sequence[int], mesh, *,
             fsdp: bool = False) -> Spec:
    """``rule_for`` fitted to ``shape`` on ``mesh``."""
    model_size = axis_sizes(mesh).get("model", 1)
    return fit_spec(rule_for(path, len(shape), fsdp=fsdp, shape=shape,
                             model_size=model_size), shape, mesh)


def cache_shardings(cache: Any, mesh, *, seq_shard: bool = False
                    ) -> Dict[str, Spec]:
    """``{path: spec}`` of every leaf of a per-layer cache list (whole
    shapes: tensors or anything with a ``shape``), the reference's
    ``cache_shardings`` leaf by leaf with the ``[L]`` entry of its
    stacked caches dropped. Leaves: K/V ``[B, S, kv, hd]``, MLA latents
    ``ckv [B, S, r]`` / ``krope [B, S, dr]``, SSM ``state [B, h, p, n]``
    / ``conv [B, cv-1, ch]``, RG-LRU ``h [B, r]`` / ``conv``.

    Every choice is guarded by divisibility: the batch over ``(pod,
    data)``, else over ``data``; the K/V sequence over ``model``, else
    its KV heads, else its head dim; with ``seq_shard`` the K/V and
    latent sequence over ``data`` (the batch left whole), the K/V heads
    then over ``model``. MLA latents stay whole over ``model``."""
    sizes = axis_sizes(mesh)
    dax = batch_axes(mesh)
    d_size = 1
    for a in dax:
        d_size *= sizes[a]
    m_size = sizes.get("model", 1)
    out = {}
    for path, leaf in leaves_with_paths(cache):
        shape = tuple(leaf.shape)
        axes: list = [None] * len(shape)
        is_kv = "'k'" in path or "'v'" in path
        positional = is_kv or "'ckv'" in path or "'krope'" in path
        if seq_shard and positional:
            if shape[1] % sizes["data"] == 0:
                axes[1] = "data"
        elif shape[0] % d_size == 0:
            axes[0] = _canon(dax)
        elif shape[0] % sizes["data"] == 0:
            axes[0] = "data"
        if is_kv and len(shape) == 4:
            if axes[1] is None and shape[1] % m_size == 0:
                axes[1] = "model"                   # the sequence
            elif shape[2] % m_size == 0:
                axes[2] = "model"                   # the KV heads
            elif shape[3] % m_size == 0:
                axes[3] = "model"                   # the head dim
        out[path] = tuple(axes)
    return out


def local_shape(shape: Sequence[int], spec: Sequence[Entry], mesh
                ) -> Tuple[int, ...]:
    """The shape of one rank's block of a leaf of ``shape`` split by
    ``spec``."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        parts = 1
        for n in (entry if isinstance(entry, tuple) else (entry,)):
            parts *= sizes[n]
        if out[dim] % parts:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"into {parts}")
        out[dim] //= parts
    return tuple(out)


def replicated(ndim: int = 0) -> Spec:
    return (None,) * ndim


def batch_sharding(mesh, ndim: int, *, batch_axis: int = 0,
                   shape: Optional[Sequence[int]] = None) -> Spec:
    """A batch tensor's leading axis over (pod, data)."""
    axes: list = [None] * ndim
    axes[batch_axis] = _canon(batch_axes(mesh))
    spec = tuple(axes)
    return fit_spec(spec, shape, mesh) if shape is not None else spec


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def leaves_with_paths(tree: Any, prefix: str = ""):
    """(path, leaf) of every array leaf: dict keys ``['k']``, list items
    ``[i]``, a Tiled-CSL leaf's ``.words`` and ``.nnz``; ``None`` leaves
    skipped. A leaf is anything with a ``shape``."""
    if isinstance(tree, dict):
        return [pv for k in sorted(tree)
                for pv in leaves_with_paths(tree[k], f"{prefix}['{k}']")]
    if isinstance(tree, (list, tuple)):
        return [pv for i, v in enumerate(tree)
                for pv in leaves_with_paths(v, f"{prefix}[{i}]")]
    if isinstance(tree, tiled_csl.TiledCSL):
        return [(f"{prefix}.words", tree.words), (f"{prefix}.nnz", tree.nnz)]
    return [] if tree is None else [(prefix, tree)]


_LAYER_INDEX = re.compile(r"^\['layers'\]\[\d+\]")


def reference_path(path: str, *, scan: bool) -> str:
    """A port path as the reference spells it: a scan config's layers
    are one stacked subtree, so the layer index goes."""
    return _LAYER_INDEX.sub("['layers']", path) if scan else path


def params_shardings(params: Any, mesh, *, fsdp: bool = False
                     ) -> Dict[str, Spec]:
    """``{path: spec}`` for every leaf of a params tree of full-size
    leaves (tensors, Tiled-CSL, or anything with a ``shape``)."""
    return {path: spec_for(path, tuple(leaf.shape), mesh, fsdp=fsdp)
            for path, leaf in leaves_with_paths(params)}


def split_axes(spec: Spec) -> Tuple[str, ...]:
    """The axes ``spec`` splits its leaf over, in the order ``pod``,
    ``data``, ``model``."""
    names = {n for e in spec if e is not None
             for n in (e if isinstance(e, tuple) else (e,))}
    return tuple(a for a in ("pod", "data", "model") if a in names)


def model_sharded(spec: Spec) -> bool:
    """True iff some dim of ``spec`` is split over ``model``."""
    return "model" in split_axes(spec)


# ---------------------------------------------------------------------------
# a rank's shard
# ---------------------------------------------------------------------------

def _shard_index(entry: Entry, sizes: Dict[str, int],
                 coords: Dict[str, int]) -> Tuple[int, int]:
    """(parts, this rank's part) of a dim split by ``entry``: row-major
    over an axis tuple, as the reference lays a tuple out."""
    names = entry if isinstance(entry, tuple) else (entry,)
    parts, index = 1, 0
    for n in names:
        parts *= sizes[n]
        index = index * sizes[n] + coords[n]
    return parts, index


def shard_leaf(x: torch.Tensor, spec: Sequence[Entry], mesh, *,
               coords: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """This rank's block of a full-size tensor: a view of ``x`` (``x``
    itself where nothing splits it). ``coords`` (``{axis: index}``) names
    another rank than this one."""
    sizes = axis_sizes(mesh)
    coords = coordinates(mesh) if coords is None else coords
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        parts, index = _shard_index(entry, sizes, coords)
        n = x.shape[dim]
        if n % parts:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"into {parts}")
        x = x.narrow(dim, index * (n // parts), n // parts)
    return x


def shard_tiled_csl(t: tiled_csl.TiledCSL, spec: Sequence[Entry], mesh, *,
                    coords: Optional[Dict[str, int]] = None,
                    nnz_spec: Optional[Sequence[Entry]] = None
                    ) -> tiled_csl.TiledCSL:
    """This rank's Tiled-CSL: ``words`` and ``nnz`` sliced on the axes
    ``spec`` (the words' spec) splits, ``shape`` cut to match. Each
    shard keeps the whole leaf's ``max_nnz``, as a slice of the
    reference's array does."""
    spec = tuple(spec) + (None,) * (t.words.dim() - len(spec))
    if spec[-1] is not None:
        raise ValueError("a Tiled-CSL word stream does not split")
    nnz_spec = spec[:-1] if nnz_spec is None else tuple(nnz_spec)
    if nnz_spec != spec[:-1]:
        raise ValueError(f"words {spec} and nnz {nnz_spec} split apart")
    words = _own(shard_leaf(t.words, spec, mesh, coords=coords), t.words)
    nnz = _own(shard_leaf(t.nnz, nnz_spec, mesh, coords=coords), t.nnz)
    mt, kt = nnz.shape[-2], nnz.shape[-1]
    return dataclasses.replace(t, words=words, nnz=nnz,
                               shape=(mt * t.m_tb, kt * t.k_tb))


def _own(block: torch.Tensor, whole: torch.Tensor) -> torch.Tensor:
    """``block`` in storage of its own, unless it is ``whole`` itself: a
    view would keep the whole leaf alive after the caller drops it."""
    return block if block is whole else block.clone(
        memory_format=torch.contiguous_format)


def shard_params(params: Any, mesh, *,
                 coords: Optional[Dict[str, int]] = None,
                 prefix: str = "", fsdp: bool = False) -> Any:
    """This rank's shard of every leaf of a full-size params tree (a new
    tree; a split leaf's shard is a copy, so the whole leaf can be freed;
    a leaf that nothing splits is shared). ``prefix`` is the subtree's
    path in the whole tree; ``fsdp`` also splits the matrices' free dim
    over ``data`` (ZeRO-3)."""
    if isinstance(params, dict):
        return {k: shard_params(v, mesh, coords=coords,
                                prefix=f"{prefix}['{k}']", fsdp=fsdp)
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(
            shard_params(v, mesh, coords=coords,
                         prefix=f"{prefix}[{i}]", fsdp=fsdp)
            for i, v in enumerate(params))
    if isinstance(params, tiled_csl.TiledCSL):
        return shard_tiled_csl(
            params, spec_for(f"{prefix}.words", tuple(params.words.shape),
                             mesh, fsdp=fsdp), mesh, coords=coords,
            nnz_spec=spec_for(f"{prefix}.nnz", tuple(params.nnz.shape), mesh,
                              fsdp=fsdp))
    if params is None:
        return None
    spec = spec_for(prefix, tuple(params.shape), mesh, fsdp=fsdp)
    return _own(shard_leaf(params, spec, mesh, coords=coords), params)


def shard_cache(cache: Any, specs: Dict[str, Spec], mesh, *,
                coords: Optional[Dict[str, int]] = None) -> Any:
    """This rank's block of every leaf of a whole per-layer cache list,
    by ``specs`` (:func:`cache_shardings`)."""
    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}['{k}']") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, f"{prefix}[{i}]")
                              for i, v in enumerate(tree))
        return _own(shard_leaf(tree, specs[prefix], mesh, coords=coords),
                    tree)
    return walk(cache, "")
