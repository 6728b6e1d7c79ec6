"""Dry run: build every (arch × shape × mesh) cell for one rank of the
production mesh on meta tensors, and record what it would hold and do.

The port's counterpart of ``repro.launch.dryrun``. The mesh is the dry
16x16 or 2x16x16 one (``launch.mesh.make_production_mesh``): no process
group, no device; rank 0 stands for every rank, since every layout
shards evenly. ``specs.build_cell`` gives the rank's step and its
arguments on ``device="meta"``, and the step runs on them once:

  * per-rank argument bytes, in total and by group (params, optimizer
    state, cache, inputs): the layout, counted exactly;
  * FLOPs and bytes: ``torch.utils.flop_counter``'s formulas over the
    aten ops (:class:`CostCounter`, the counts ``FlopCounterMode`` makes),
    a byte count of their inputs and outputs (views free),
    plus the LSCD launches the meta branch of ``kernels.ops`` notes
    (``core.roofline.cost_dict``);
  * the LSCD launch list by (kernel, M, K, N, S) with its count and
    ``schedule.predicted``'s H100 time;
  * collective bytes by kind and axis, recorded by the dry mesh's groups
    (``core.roofline.collective_bytes``);
  * ``model_flops``.

Temp bytes are "unavailable": nothing is compiled, as the reference
records them where its backend has no ``memory_analysis``. The port's
layers are a list, so the step at full depth on meta is exact; the
reference's ``_probe_costs`` extrapolation exists only because XLA
counts a ``lax.scan`` body once, and is not ported. A cell that fails
(the train × ``sparse_xla`` cells, ROADMAP.md queue 3 item 13) is
recorded as an error with its message, as the reference's ``run_cell``
records a failure. The dry run runs on the CPU and never touches a card.

Usage:
  python -m repro_torch.launch.dryrun --all            # every cell
  python -m repro_torch.launch.dryrun --arch tinyllama_1_1b --shape decode_32k
  python -m repro_torch.launch.dryrun --all --both-meshes --weight-mode sparse_xla

Records go to ``results/dryrun_torch/<arch>.<shape>.<mesh>.<mode>.json``
(``--force`` rebuilds a cell whose file exists).
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Dict, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch import configs
from repro_torch.core import roofline
from repro_torch.kernels import schedule as schedule_mod
from repro_torch.kernels import spmm as spmm_mod
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import specs as specs_mod
from repro_torch.obs import profile as obs_profile

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def cell_path(arch: str, shape: str, multi_pod: bool, weight_mode: str,
              tag: str = "") -> str:
    suffix = f".{tag}" if tag else ""
    return os.path.abspath(os.path.join(
        RESULTS_DIR,
        f"{arch}.{shape}.{mesh_name(multi_pod)}.{weight_mode}{suffix}.json"))


class CostCounter(TorchDispatchMode):
    """FLOPs of every aten op by ``torch.utils.flop_counter``'s formulas
    (``flop_registry``, what ``FlopCounterMode`` counts), and bytes of
    its tensor inputs and outputs (a view moves nothing): the
    counterparts of XLA's "flops" and "bytes accessed"."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if not getattr(func, "is_view", False):
            for t in tree_leaves((args, kwargs, out)):
                if isinstance(t, torch.Tensor):
                    self.bytes += t.numel() * t.element_size()
        return out


def kernel_name(kind: str, split_k: int) -> str:
    """The LSCD kernel a launch of ``kind`` runs at split factor S."""
    base = {"spmm": "lscd_spmm", "spmm_grouped": "lscd_spmm_grouped",
            "spmm_batched": "lscd_spmm_batched"}[kind]
    return base.replace("lscd_spmm", "lscd_spmm_splitk") if split_k > 1 \
        else base


def launch_list(prof: obs_profile.KernelProfiler) -> List[dict]:
    """One row per distinct launch: kernel, M, K, N, S, count, and the
    schedule's roofline terms (``schedule.predicted``, the H100's)."""
    rows = []
    for key, rec in sorted(prof.launches.items()):
        sched = rec.schedule
        binary = rec.kind == "spmm_grouped" and spmm_mod.epilogue_kind(
            rec.epilogue, groups=rec.group) == "binary"
        terms = schedule_mod.predicted(
            rec.m, rec.k, rec.n, rec.sparsity, sched, group=rec.group,
            max_nnz=rec.max_nnz, b_dtype_bytes=getattr(
                torch, rec.dtype).itemsize, binary=binary,
            experts=rec.experts)
        rows.append(dict(kernel=kernel_name(rec.kind, sched.split_k),
                         m=rec.m, k=rec.k, n=rec.n, s=sched.split_k,
                         group=rec.group, max_nnz=rec.max_nnz,
                         n_tb=sched.n_tb, count=prof.dispatch_counts[key],
                         flops=terms.flops, hbm_bytes=terms.hbm_bytes,
                         predicted_s=terms.effective_s))
    return rows


def _model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D for train (N = active matmul params, D = tokens);
    2·N_active per generated token for decode; 2·N·D for prefill.
    Embedding-gather-only params are excluded (no FLOPs)."""
    n_active = cfg.matmul_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token per slot


def execute(cell: specs_mod.Cell, mesh, *, train: bool) -> dict:
    """Run ``cell`` once on its meta arguments (autograd on for a train
    step); what it did, per rank."""
    prof = obs_profile.KernelProfiler()
    counter = CostCounter()
    mesh.records.clear()
    with obs_profile.profiled(prof), torch.set_grad_enabled(train):
        with counter:
            cell.fn(*cell.args)
    launches = launch_list(prof)
    return dict(
        cost=roofline.cost_dict(launches, aten_flops=counter.flops,
                                aten_bytes=counter.bytes),
        collective_bytes=roofline.collective_bytes(mesh.records),
        collective_bytes_by_axis=roofline.collective_bytes(mesh.records,
                                                           by_axis=True),
        lscd=launches)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             weight_mode: str = "dense", sparsity: float = 0.8,
             remat: Optional[str] = None, tag: str = "",
             microbatches: int = 1, force: bool = False,
             mesh=None) -> dict:
    """Build and run one cell on meta; its record, also written to
    :func:`cell_path` (read back instead where it exists, unless
    ``force``). ``mesh`` (a ``DryMesh``) stands in for the production
    one; its cells are not written."""
    out_path = cell_path(arch, shape_name, multi_pod, weight_mode, tag)
    if mesh is None and os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)
    cfg = configs.get(arch)
    shape = configs.SHAPES[shape_name]
    own = mesh is None
    mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod) if own \
        else mesh
    record = {"arch": arch, "shape": shape_name,
              "mesh": mesh_name(multi_pod) if own else
              "x".join(str(mesh.size(i))
                       for i in range(len(mesh.mesh_dim_names))),
              "weight_mode": weight_mode, "sparsity": sparsity,
              "remat": remat, "microbatches": microbatches,
              "chips": mesh.size(), "status": "error"}
    t0 = time.time()
    try:
        cell = specs_mod.build_cell(cfg, shape, mesh,
                                    weight_mode=weight_mode,
                                    sparsity=sparsity, remat=remat,
                                    microbatches=microbatches)
        t_build = time.time() - t0
        ran = execute(cell, mesh, train=shape.kind == "train")
        record.update({
            "status": "ok",
            "build_s": round(t_build, 2),
            "run_s": round(time.time() - t0 - t_build, 2),
            "memory": {"argument_bytes": cell.arg_bytes(),
                       "temp_bytes": None,
                       "unavailable": "temp bytes: nothing is compiled"},
            **ran,
            "model_flops": _model_flops(cfg, shape),
            "label": cell.label,
        })
    except Exception as e:  # noqa: BLE001 - recorded, and the sweep goes on
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
    record["total_s"] = round(time.time() - t0, 2)
    if own:
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        with open(out_path + ".tmp", "w") as f:
            json.dump(record, f, indent=1)
        os.replace(out_path + ".tmp", out_path)
    return record


def iter_cells(multi_pod: bool, weight_mode: str):
    for arch in configs.ARCH_IDS:
        for shape in configs.cells(arch):
            yield arch, shape.name, multi_pod, weight_mode


def summary_line(rec: dict) -> str:
    """One line: status, per-rank bytes by group, FLOPs, collective bytes
    by kind and the LSCD launches with their predicted time; or the
    error."""
    head = (f"[{rec['status']:5s}] {rec['arch']:20s} {rec['shape']:12s} "
            f"{rec['mesh']:8s} {rec['weight_mode']:10s}")
    if rec["status"] != "ok":
        return f"{head} {rec.get('error', '')[:200]}"
    b = rec["memory"]["argument_bytes"]
    groups = " ".join(f"{g}={b[g]}" for g in specs_mod.GROUPS if g in b)
    coll = " ".join(f"{k}={int(v)}"
                    for k, v in sorted(rec["collective_bytes"].items()))
    n = sum(r["count"] for r in rec["lscd"])
    lscd = (f"lscd {len(rec['lscd'])} shapes x {n} launches, predicted "
            f"{rec['cost']['lscd_predicted_s'] * 1e3:.3f} ms" if n else
            "lscd none")
    return (f"{head} bytes total={b['total']} {groups} "
            f"flops={rec['cost']['flops']:.4g} coll[{coll}] {lscd}")


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, int]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--weight-mode", default="dense",
                    choices=list(specs_mod.WEIGHT_MODES))
    ap.add_argument("--sparsity", type=float, default=0.8)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--tag", default="")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        meshes = [False, True] if args.both_meshes else [args.multi_pod]
        jobs = [job for mp in meshes
                for job in iter_cells(mp, args.weight_mode)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        jobs = [(args.arch, args.shape, args.multi_pod, args.weight_mode)]

    ok = failed = 0
    for arch, shape, mp, wm in jobs:
        rec = run_cell(arch, shape, multi_pod=mp, weight_mode=wm,
                       sparsity=args.sparsity, remat=args.remat,
                       microbatches=args.microbatches, tag=args.tag,
                       force=args.force)
        ok += rec["status"] == "ok"
        failed += rec["status"] != "ok"
        print(summary_line(rec), flush=True)
    print(f"\n{ok} ok / {failed} failed")
    if failed:
        raise SystemExit(1)
    return {"ok": ok, "failed": failed}


if __name__ == "__main__":
    main()
