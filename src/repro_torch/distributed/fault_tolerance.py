"""Fault tolerance: atomic checkpoints, preemption handling and failure
injection for tests.

The port's counterpart of ``repro.distributed.fault_tolerance``, with
the reference's on-disk layout: a checkpoint is ``<dir>/step_%010d``
holding ``leaves.npz`` (one array a leaf, keyed by its path string) and
``manifest.json`` (``step``, ``extra`` and the sorted ``leaves``),
written to ``<dir>/tmp.<step>.<pid>`` first and renamed into place only
after every file is complete, so a crash mid-save never corrupts the
newest checkpoint.

Path strings are the reference's ``jax.tree_util.keystr`` spelling over
the port's own trees: ``['key']`` for a dict key, ``[i]`` for a list or
tuple index, ``.name`` for a NamedTuple field (``TrainState``,
``AdamWState``). So the port's ``(TrainState, data state)`` saves as
``[0].params['layers'][3]['attn']['wq']['w']``, ``[0].opt_state.mu[...]``,
``[0].step`` and ``[1]['seed']``, where the reference's scan-stacked
trees have ``[0].params['layers']['attn']['wq']['w']`` with an ``[L,
...]`` leaf (``convert.train_state_from_checkpoint`` reads those).

numpy has no bfloat16: a bf16 leaf is stored as its uint16 bits, and
the manifest's ``dtypes`` names it, so it restores bit for bit.

Elastic restore: a checkpoint holds whole arrays, as the reference stores
them, whatever mesh saved it. ``save(..., mesh=, shardings=)`` gathers a
rank's shards to model rank 0 of data row 0 over a gloo group, on host
tensors, and global rank 0 writes; an FSDP state (``shardings`` with
``data`` splits) is gathered from every rank of the world to global rank
0, again on host tensors over gloo. ``restore(template, mesh=, fsdp=)``
gives each rank its shard of every leaf by the sharding rules
(``distributed.sharding``), so a checkpoint saved on one mesh restores
on another, with or without FSDP, or on one process.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import signal
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import sharding

# ---------------------------------------------------------------------------
# path-keyed (de)serialisation
# ---------------------------------------------------------------------------

_BF16 = "bfloat16"
READ_THREADS = 8


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) of every leaf of ``tree`` (dicts in sorted key order,
    as the reference flattens them; ``None`` subtrees are empty)."""
    if isinstance(tree, dict):
        return [pv for k in sorted(tree)
                for pv in flatten_with_paths(tree[k], f"{prefix}['{k}']")]
    if _is_namedtuple(tree):
        return [pv for name in tree._fields
                for pv in flatten_with_paths(getattr(tree, name),
                                             f"{prefix}.{name}")]
    if isinstance(tree, (list, tuple)):
        return [pv for i, v in enumerate(tree)
                for pv in flatten_with_paths(v, f"{prefix}[{i}]")]
    return [] if tree is None else [(prefix, tree)]


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``; from a card, into page-locked memory (a copy
    into fresh pageable memory ran at about 1e9 B/s on an H100 host)."""
    if t.is_cuda:
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
    return t.clone()


def _to_numpy(leaf: Any) -> Tuple[np.ndarray, Optional[str]]:
    """(array, the dtype name when it is not the array's own): a copy, so
    the caller may go on changing the tensor."""
    if isinstance(leaf, torch.Tensor):
        t = _host_copy(leaf.detach())
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        return t.numpy(), None
    return np.asarray(leaf), None


def _from_numpy(arr: np.ndarray, dtype_name: Optional[str],
                like: torch.Tensor, device) -> torch.Tensor:
    """``arr`` (read from the archive, so the caller's own) as a tensor
    of ``like``'s dtype on ``device``."""
    if not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)
    if dtype_name == _BF16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=like.dtype)


def unflatten_like(template: Any, arrays: Dict[str, np.ndarray],
                   dtypes: Optional[Dict[str, str]] = None,
                   device: DeviceLike = None, prefix: str = "") -> Any:
    """``template``'s structure with each leaf taken from ``arrays`` by
    its path: tensors in the template's dtype on ``device``, python
    scalars as their type. A missing leaf or a shape that differs raises."""
    dtypes = dtypes or {}
    if isinstance(template, dict):
        return {k: unflatten_like(v, arrays, dtypes, device,
                                  f"{prefix}['{k}']")
                for k, v in template.items()}
    if _is_namedtuple(template):
        return type(template)(*(
            unflatten_like(getattr(template, name), arrays, dtypes, device,
                           f"{prefix}.{name}") for name in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(
            unflatten_like(v, arrays, dtypes, device, f"{prefix}[{i}]")
            for i, v in enumerate(template))
    if template is None:
        return None
    if prefix not in arrays:
        raise KeyError(f"checkpoint missing leaf {prefix}")
    arr = arrays[prefix]
    if not isinstance(template, torch.Tensor):       # python scalar leaf
        return type(template)(arr.item())
    if tuple(arr.shape) != tuple(template.shape):
        raise ValueError(f"{prefix}: checkpoint shape {arr.shape} != "
                         f"target {tuple(template.shape)}")
    return _from_numpy(arr, dtypes.get(prefix), template,
                       resolve_device(device) if device is not None
                       else template.device)


# One step of a path: ['key'], [index] or .field
_PATH_PART = re.compile(r"\['([^']*)'\]|\[(\d+)\]|\.(\w+)")


def split_path(path: str) -> List[Any]:
    """The steps of a path string: str for a key or field, int for an
    index."""
    out, at = [], 0
    for m in _PATH_PART.finditer(path):
        if m.start() != at:
            raise ValueError(f"cannot parse path {path!r} at {at}")
        key, idx, field = m.groups()
        out.append(int(idx) if idx is not None
                   else key if key is not None else field)
        at = m.end()
    if at != len(path):
        raise ValueError(f"cannot parse path {path!r} at {at}")
    return out


def tree_from_paths(arrays: Dict[str, Any]) -> Any:
    """Rebuild nested containers from path-keyed leaves with no template:
    dicts for keys and fields, lists for indices."""
    root: Dict[Any, Any] = {}
    for path, leaf in arrays.items():
        steps = split_path(path)
        node = root
        for step in steps[:-1]:
            node = node.setdefault(step, {})
        node[steps[-1]] = leaf

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            if sorted(node) != list(range(len(node))):
                raise ValueError(f"indices {sorted(node)} are not 0..n-1")
            return [fix(node[i]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}
    return fix(root)


# ---------------------------------------------------------------------------
# atomic JSON publication — shared by checkpoints and serving snapshots
# ---------------------------------------------------------------------------

def atomic_write_json(path: str, payload: dict) -> None:
    """Write ``payload`` to ``path`` crash-consistently: serialize to a
    same-directory temp file, fsync, then ``os.replace`` — a reader (or a
    restart) sees either the old complete file or the new complete file,
    never a torn write."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)                   # atomic publish


class SnapshotStore:
    """Small-state sibling of :class:`CheckpointManager`: numbered JSON
    snapshots published atomically, newest-wins restore, bounded history.

    The serving stack uses it for scheduler/session state — host-side
    dicts, no device arrays — so one fsync'd JSON file per snapshot is
    the whole persistence story; model params are immutable and restored
    from their own source.
    """

    def __init__(self, directory: str, *, prefix: str = "snapshot",
                 keep: int = 3):
        self.dir = directory
        self.prefix = prefix
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, seq: int) -> str:
        return os.path.join(self.dir, f"{self.prefix}_{seq:010d}.json")

    def all_seqs(self) -> List[int]:
        out = []
        pat = re.compile(rf"{re.escape(self.prefix)}_(\d+)\.json")
        for name in os.listdir(self.dir):
            m = pat.fullmatch(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def save(self, payload: dict, *, seq: Optional[int] = None) -> str:
        """Publish one snapshot (auto-incrementing sequence number unless
        given); returns its path. Old snapshots beyond ``keep`` are GC'd
        *after* the new one is durable."""
        if seq is None:
            seqs = self.all_seqs()
            seq = (seqs[-1] + 1) if seqs else 0
        path = self._path(seq)
        atomic_write_json(path, payload)
        if self.keep:
            for s in self.all_seqs()[:-self.keep]:
                try:
                    os.remove(self._path(s))
                except OSError:
                    pass  # concurrent GC / already gone — harmless
        return path

    def latest_path(self) -> Optional[str]:
        seqs = self.all_seqs()
        return self._path(seqs[-1]) if seqs else None

    def latest(self) -> Optional[dict]:
        path = self.latest_path()
        if path is None:
            return None
        with open(path) as f:
            return json.load(f)


# ---------------------------------------------------------------------------
# sharded state: a leaf's params path, the gather, the shard
# ---------------------------------------------------------------------------

# A train state leaf that mirrors a params leaf: the params themselves or
# an AdamW moment (``[0].params[...]``, ``[0].opt_state.mu[...]``).
_PARAMS_LEAF = re.compile(r"\.(?:params|mu|nu)((?:\[[^\]]*\])+)$")


def params_path(path: str) -> Optional[str]:
    """The params path a state leaf mirrors, or None (a step, the data
    stream's state)."""
    m = _PARAMS_LEAF.search(path)
    return m.group(1) if m else None


def leaf_spec(path: str, shape, mesh, *, fsdp: bool = False) -> tuple:
    """A state leaf's spec on ``mesh`` from its whole ``shape``: its
    params leaf's (``fsdp``: with the data splits), or replicated."""
    ppath = params_path(path)
    if ppath is None:
        return sharding.replicated(len(shape))
    return sharding.spec_for(ppath, tuple(shape), mesh, fsdp=fsdp)


_HOST_GROUPS: Dict[int, Any] = {}


def host_model_group(mesh):
    """A gloo group over this rank's ``model`` axis (the mesh's own where
    it is gloo already). Every rank makes every row's group, in order."""
    group = mesh.get_group("model")
    if dist.get_backend(group) == "gloo":
        return group
    if id(mesh) not in _HOST_GROUPS:
        ranks = mesh.mesh.reshape(-1, mesh.size(
            mesh.mesh_dim_names.index("model"))).tolist()
        mine = None
        for row in ranks:
            g = dist.new_group(row, backend="gloo")
            if dist.get_rank() in row:
                mine = g
        _HOST_GROUPS[id(mesh)] = mine
    return _HOST_GROUPS[id(mesh)]


def host_world_group():
    """A gloo group over the whole world (the default one where it is
    gloo already)."""
    if dist.get_backend() == "gloo":
        return dist.group.WORLD
    if "world" not in _HOST_GROUPS:
        _HOST_GROUPS["world"] = dist.new_group(
            list(range(dist.get_world_size())), backend="gloo")
    return _HOST_GROUPS["world"]


def _coords_of(mesh, rank: int) -> Dict[str, int]:
    """Global rank ``rank``'s index on every axis of ``mesh``."""
    where = (mesh.mesh == rank).nonzero()[0].tolist()
    return dict(zip(mesh.mesh_dim_names, where))


def _gather_world(leaf: torch.Tensor, spec, mesh, group) -> torch.Tensor:
    """The whole leaf on global rank 0 (``None`` elsewhere) from every
    rank's block, on the host: each block put at its rank's place by
    ``spec``, whatever axes it splits."""
    local = leaf.detach().to("cpu").contiguous()
    if not any(e is not None for e in spec):
        return local
    first = dist.get_rank() == 0
    parts = ([torch.empty_like(local) for _ in range(dist.get_world_size())]
             if first else None)
    dist.gather(local, parts, dst=0, group=group)
    if not first:
        return None
    sizes = sharding.axis_sizes(mesh)
    shape = list(local.shape)
    for dim, entry in enumerate(spec):
        for n in (() if entry is None else
                  entry if isinstance(entry, tuple) else (entry,)):
            shape[dim] *= sizes[n]
    whole = torch.empty(shape, dtype=local.dtype)
    for rank, part in enumerate(parts):
        sharding.shard_leaf(whole, spec, mesh,
                            coords=_coords_of(mesh, rank)).copy_(part)
    return whole


def _gather_whole(leaf: torch.Tensor, spec, mesh, group) -> torch.Tensor:
    """The whole leaf on model rank 0 (``None`` elsewhere) from every
    model rank's block, on the host."""
    local = leaf.detach().to("cpu").contiguous()
    dims = [i for i, e in enumerate(spec) if e is not None]
    if not dims:
        return local
    if len(dims) > 1 or spec[dims[0]] != "model":
        raise NotImplementedError(f"gathering spec {spec} (only a model "
                                  "split is saved from a mesh)")
    size = mesh.size(mesh.mesh_dim_names.index("model"))
    first = mesh.get_local_rank("model") == 0
    parts = [torch.empty_like(local) for _ in range(size)] if first else None
    dist.gather(local, parts, dst=dist.get_global_rank(group, 0),
                group=group)
    return torch.cat(parts, dim=dims[0]) if first else None


# ---------------------------------------------------------------------------
# checkpoint manager
# ---------------------------------------------------------------------------

class CheckpointManager:
    """Atomic, optionally asynchronous checkpoints."""

    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state: Any, *, extra: Optional[dict] = None,
             block: bool = False, mesh=None,
             shardings: Optional[Dict[str, tuple]] = None) -> None:
        """Copy every leaf of ``state`` to the host now (so the caller may
        go on), then write; with ``async_save`` (and not ``block``) the
        write runs on a thread, after the previous one has finished.

        Under ``mesh`` ``state`` is a rank's shard and ``shardings`` its
        params' specs (``sharding.params_shardings`` of the whole
        params): every rank calls ``save``, the whole arrays are gathered
        to global rank 0, which writes; with ``block`` every rank returns
        once the checkpoint is on disk."""
        if mesh is not None:
            self._save_sharded(step, state, extra, block, mesh, shardings)
            return
        arrays, dtypes = {}, {}
        for path, leaf in flatten_with_paths(state):
            arrays[path], name = _to_numpy(leaf)
            if name is not None:
                dtypes[path] = name
        self._publish(step, arrays, dtypes, extra, block)

    def _save_sharded(self, step, state, extra, block, mesh, shardings):
        if any("data" in sharding.split_axes(spec)
               for spec in shardings.values()):
            self._save_fsdp(step, state, extra, block, mesh, shardings)
            return
        group = host_model_group(mesh)
        row0 = mesh.get_local_rank("data") == 0 \
            if "data" in mesh.mesh_dim_names else True
        writer = dist.get_rank() == 0
        arrays, dtypes = {}, {}
        if row0:
            for path, leaf in flatten_with_paths(state):
                if isinstance(leaf, torch.Tensor):
                    ppath = params_path(path)
                    spec = (shardings[ppath] if ppath is not None
                            else sharding.replicated(leaf.dim()))
                    leaf = _gather_whole(leaf, spec, mesh, group)
                if writer:
                    arrays[path], name = _to_numpy(leaf)
                    if name is not None:
                        dtypes[path] = name
        if writer:
            self._publish(step, arrays, dtypes, extra, block)
        if block:
            dist.barrier()

    def _save_fsdp(self, step, state, extra, block, mesh, shardings):
        """Every rank sends its blocks; global rank 0 writes."""
        group = host_world_group()
        writer = dist.get_rank() == 0
        arrays, dtypes = {}, {}
        for path, leaf in flatten_with_paths(state):
            if isinstance(leaf, torch.Tensor):
                ppath = params_path(path)
                spec = (shardings[ppath] if ppath is not None
                        else sharding.replicated(leaf.dim()))
                leaf = _gather_world(leaf, spec, mesh, group)
            if writer:
                arrays[path], name = _to_numpy(leaf)
                if name is not None:
                    dtypes[path] = name
        if writer:
            self._publish(step, arrays, dtypes, extra, block)
        if block:
            dist.barrier()

    def _publish(self, step, arrays, dtypes, extra, block) -> None:
        meta = {"step": int(step), "extra": extra or {},
                "leaves": sorted(arrays)}
        if dtypes:
            meta["dtypes"] = dtypes
        if self.async_save and not block:
            self.wait()
            self._thread = threading.Thread(
                target=self._write_reporting, args=(step, arrays, meta),
                daemon=True)
            self._thread.start()
        else:
            self.wait()
            self._write(step, arrays, meta)

    def _write_reporting(self, step: int, arrays, meta) -> None:
        try:
            self._write(step, arrays, meta)
        except BaseException as e:      # handed to the caller by wait()
            self._error = e

    def _write(self, step: int, arrays: Dict[str, np.ndarray], meta: dict):
        tmp = os.path.join(self.dir, f"tmp.{step}.{os.getpid()}")
        final = os.path.join(self.dir, f"step_{step:010d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        with open(os.path.join(tmp, "leaves.npz"), "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        atomic_write_json(os.path.join(tmp, "manifest.json"), meta)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)               # atomic publish
        self._gc()

    def wait(self) -> None:
        """Block until the pending asynchronous write is on disk; raise
        its error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("asynchronous checkpoint write failed") \
                from err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def read(self, *, step: Optional[int] = None, prefix: str = "",
             transform: Optional[Callable[[str, np.ndarray], np.ndarray]]
             = None) -> Tuple[Dict[str, np.ndarray], dict]:
        """The arrays of one checkpoint (the newest by default) whose
        paths start with ``prefix``, and its manifest. The leaves are
        read by ``READ_THREADS`` threads, each through its own handle
        (the archive's CRC checks and copies release the interpreter
        lock). ``transform(path, array)``, when given, replaces each
        array as it is read (a rank keeps its shard only)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            meta = json.load(f)
        npz = os.path.join(path, "leaves.npz")
        keys = [k for k in meta["leaves"] if k.startswith(prefix)]

        def part(ks):
            with np.load(npz) as z:
                if transform is None:
                    return {k: z[k] for k in ks}
                return {k: transform(k, z[k]) for k in ks}
        arrays: Dict[str, np.ndarray] = {}
        with ThreadPoolExecutor(READ_THREADS) as ex:
            for got in ex.map(part, [keys[i::READ_THREADS]
                                     for i in range(READ_THREADS)]):
                arrays.update(got)
        return arrays, meta

    def restore(self, template: Any, *, step: Optional[int] = None,
                device: DeviceLike = None, mesh=None,
                fsdp: bool = False) -> Tuple[Any, dict]:
        """Restore onto ``template``'s structure and dtypes, on ``device``
        (default: each template leaf's own). Returns (state, manifest).
        Under ``mesh`` ``template`` is a rank's shard (``fsdp``: of the
        FSDP specs), and each leaf is cut to this rank's block by the
        sharding rules on its whole shape (the checkpoint may come from
        any mesh, or none)."""
        transform = None
        if mesh is not None:
            def transform(path, arr):
                spec = leaf_spec(path, arr.shape, mesh, fsdp=fsdp)
                if not any(e is not None for e in spec):
                    return arr
                block = sharding.shard_leaf(torch.from_numpy(arr), spec,
                                            mesh)
                return np.ascontiguousarray(block.numpy())
        arrays, meta = self.read(step=step, transform=transform)
        return unflatten_like(template, arrays, meta.get("dtypes"),
                              device), meta


# ---------------------------------------------------------------------------
# preemption + failure injection
# ---------------------------------------------------------------------------

class PreemptionHandler:
    """SIGTERM -> graceful final checkpoint. Poll ``should_stop`` per step.
    ``close`` puts the previous handler back."""

    def __init__(self, install: bool = True):
        self._stop = threading.Event()
        self._prev = None
        if install:
            try:
                self._prev = signal.signal(signal.SIGTERM, self._on_signal)
            except ValueError:
                pass  # non-main thread (tests)

    def _on_signal(self, signum, frame):
        self._stop.set()

    def request_stop(self):
        self._stop.set()

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()

    def close(self) -> None:
        if self._prev is not None:
            signal.signal(signal.SIGTERM, self._prev)
            self._prev = None


class FailureInjector:
    """Deterministic fault injection for restart tests.

    fail_at: raise RuntimeError *before* executing the given step index —
    simulates a node crash mid-run. The test then restarts from the latest
    checkpoint and asserts bit-exact continuation.
    """

    def __init__(self, fail_at: Optional[int] = None):
        self.fail_at = fail_at
        self.fired = False

    def check(self, step: int):
        if self.fail_at is not None and step == self.fail_at and not self.fired:
            self.fired = True
            raise RuntimeError(f"injected failure at step {step}")


class StepDeadline:
    """Straggler mitigation hook: per-step wall-clock deadline. A step
    that takes longer than ``seconds`` counts a violation and calls
    ``on_straggler(step)``."""

    def __init__(self, seconds: float, on_straggler: Callable[[int], None]):
        self.seconds = seconds
        self.on_straggler = on_straggler
        self.violations = 0

    def observe(self, step: int, elapsed: float):
        if elapsed > self.seconds:
            self.violations += 1
            self.on_straggler(step)
