"""Host meshes over ``torch.distributed``, and a world to run them in.

The port's counterpart of ``repro.launch.mesh``'s ``make_host_mesh``: a
``DeviceMesh`` of shape ``(n // model, model)`` named ``("data",
"model")``, rank ``r`` at ``(r // model, r % model)``. Building it needs
a process group; :func:`run_world` starts one, a process a rank, runs a
function on every rank and returns what each returned.

Rank ``r`` takes ``cuda:(r % device_count)``. The world uses NCCL when
every rank has a card of its own and gloo when ranks share a card (NCCL
refuses two ranks on one device), or on the CPU. Every collective of
the port is written as an all-reduce or a broadcast on the device, so
one code path serves both backends (gloo takes CUDA tensors for those
two only); the checkpoint gather runs over a gloo group on host tensors.

A rank that fails ends the world: the others are terminated, and the
caller gets the failing rank's traceback. ``init_process_group`` is
given a timeout, so a rank blocked on a dead peer gives up too.

:func:`make_production_mesh` is the counterpart of the reference's: the
16x16 (or 2x16x16, with ``pod``) mesh, here a *dry* one
(:class:`DryMesh`) that holds no process group and touches no device.
It answers what the model code asks of a ``DeviceMesh`` for one rank,
and its groups record the collectives the rank would run (the dry run,
``launch.dryrun``, on meta tensors).
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue as queue_mod
import socket
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed import tensor_parallel

AXES = ("data", "model")
# How long a collective waits for a peer before the rank gives up.
COLLECTIVE_TIMEOUT_S = 300
# How long run_world waits for the whole world by default.
WORLD_TIMEOUT_S = 3600
# Intra-op threads of a CPU rank: a CPU world runs small shapes beside
# other processes, and a share of every core for each rank oversubscribed
# the host when several worlds ran at once.
CPU_RANK_THREADS = 1


def make_host_mesh(n_devices: Optional[int] = None, model: int = 2, *,
                   device_type: str = "cuda"):
    """A ``(n // model, model)`` mesh named ``("data", "model")`` over
    the ranks of the running world (``n`` defaults to its size)."""
    from torch.distributed.device_mesh import init_device_mesh
    n = n_devices or dist.get_world_size()
    model = min(model, n)
    if n % model:
        raise ValueError(f"{n} ranks do not split into model groups of "
                         f"{model}")
    return init_device_mesh(device_type, (n // model, model),
                            mesh_dim_names=AXES)


class DryMesh:
    """One rank's view of a mesh of ``shape`` named ``names``, with no
    process behind it: ``mesh_dim_names``, ``size``, ``get_local_rank``
    and ``get_group`` as a ``DeviceMesh`` answers them, ``device_type``
    ``"meta"``. Its groups are :class:`~repro_torch.distributed.
    tensor_parallel.DryGroup` recorders, all writing ``records``. Rank
    ``rank`` (row-major) stands for every rank: the layouts shard
    evenly, so every rank holds and moves the same bytes."""

    device_type = "meta"

    def __init__(self, shape: Sequence[int], names: Sequence[str], *,
                 rank: int = 0):
        if len(shape) != len(names):
            raise ValueError(f"mesh shape {shape} does not name {names}")
        self.mesh_dim_names = tuple(names)
        self.shape_ = tuple(int(s) for s in shape)
        self.records: List[Tuple[str, str, int]] = []
        self._groups = {n: tensor_parallel.DryGroup(n, s, self.records)
                        for n, s in zip(names, self.shape_)}
        self._coords, r = {}, rank
        for n, s in reversed(tuple(zip(names, self.shape_))):
            self._coords[n] = r % s
            r //= s

    def size(self, dim: Optional[int] = None) -> int:
        if dim is None:
            n = 1
            for s in self.shape_:
                n *= s
            return n
        return self.shape_[dim]

    def get_local_rank(self, name: str) -> int:
        return self._coords[name]

    def get_group(self, name: str):
        return self._groups[name]

    def __repr__(self) -> str:
        return f"DryMesh({self.shape_}, {self.mesh_dim_names})"


def make_production_mesh(*, multi_pod: bool = False,
                         rank: int = 0) -> DryMesh:
    """16x16 single-pod (256 chips) or 2x16x16 multi-pod (512 chips), dry.

    Axes: ("data", "model") single-pod; ("pod", "data", "model")
    multi-pod. The pod axis composes with data for the batch."""
    if multi_pod:
        return DryMesh((2, 16, 16), ("pod", "data", "model"), rank=rank)
    return DryMesh((16, 16), AXES, rank=rank)


def parse_mesh(spec: str) -> Tuple[int, int]:
    """``"DxM"`` -> (D, M)."""
    try:
        d, m = (int(v) for v in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"mesh {spec!r} is not of the form DxM") from None
    if d < 1 or m < 1:
        raise ValueError(f"mesh {spec!r} has an empty axis")
    return d, m


def rank_device(mesh) -> torch.device:
    """The device this rank computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def plan_world(world: int, device_type: str) -> Tuple[str, List[str]]:
    """(backend, each rank's device name) for ``world`` ranks."""
    if device_type == "cpu":
        return "gloo", ["cpu"] * world
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA device is present; pass device='cpu' "
                           "to run on the CPU")
    devices = [f"cuda:{r % count}" for r in range(world)]
    return ("nccl" if count >= world else "gloo"), devices


def _rank_main(rank: int, world: int, port: int, backend: str,
               device_type: str, shape: Tuple[int, int], payload: str,
               results) -> None:
    # LOCAL_RANK names the rank's device: DeviceMesh sets it from there.
    local = rank % torch.cuda.device_count() if device_type == "cuda" \
        else rank
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(local), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    try:
        with open(payload, "rb") as f:
            fn, args = pickle.load(f)
        if device_type == "cuda":
            torch.cuda.set_device(local)
        else:
            torch.set_num_threads(CPU_RANK_THREADS)
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{port}",
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        mesh = make_host_mesh(world, shape[1], device_type=device_type)
        out = fn(mesh, *args)
        dist.barrier()
        results.put(("ok", rank, out))
    except BaseException:                   # noqa: BLE001 - sent to caller
        results.put(("error", rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(fn: Callable, mesh_shape: Tuple[int, int], *,
              device: Any = None, args: Sequence[Any] = ()) -> List[Any]:
    """Start ``D * M`` ranks, build the ``(D, M)`` mesh on each, call
    ``fn(mesh, *args)`` there and return the results by rank.

    ``fn`` and ``args`` are pickled into fresh processes (``spawn``), so
    ``fn`` is a module-level function. ``device`` is ``"cuda"`` (the
    default) or ``"cpu"``. Any rank's exception, or a rank that dies,
    raises here with its traceback after every rank has been stopped."""
    dev = torch.device("cuda" if device is None else device)
    d, m = mesh_shape
    world = d * m
    backend, devices = plan_world(world, dev.type)
    print(f"mesh: {d}x{m} world of {world} ranks, backend {backend}, "
          f"rank -> device {dict(enumerate(devices))}", flush=True)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    # The function and its inputs go through a file: a process's spawn
    # arguments are written through a pipe that blocks until the child
    # has started, which would start the ranks one after the other.
    with tempfile.NamedTemporaryFile(suffix=".world", delete=False) as f:
        pickle.dump((fn, tuple(args)), f)
        payload = f.name
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, backend, dev.type, (d, m),
                               payload, results), daemon=True)
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        return _collect(procs, results, (d, m))
    finally:
        os.unlink(payload)


def _collect(procs, results, shape: Tuple[int, int]) -> List[Any]:
    """Every rank's result, or raise on the first failure after stopping
    every rank."""
    d, m = shape
    world = len(procs)
    got: dict = {}
    failure: Optional[str] = None
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    try:
        while len(got) < world and failure is None:
            try:
                status, rank, out = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    failure = (f"rank {dead[0]} exited with code "
                               f"{procs[dead[0]].exitcode} without a result")
                elif time.monotonic() > deadline:
                    failure = (f"the world did not finish in "
                               f"{WORLD_TIMEOUT_S} s")
                continue
            if status == "ok":
                got[rank] = out
            else:
                failure = f"rank {rank} failed:\n{out}"
    finally:
        for p in procs:
            if failure is not None and p.is_alive():
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if failure is not None:
        raise RuntimeError(f"mesh {d}x{m}: {failure}")
    return [got[r] for r in range(world)]
