"""Training launcher (CLI) of the port.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch tinyllama_1_1b --smoke --steps 200 --batch 8 --seq 128 \\
        --ckpt-dir /tmp/ckpt --resume

The flags are those of ``repro.launch.train``, with ``--layers N``
besides: the arch's first N layers at its published widths, a run at cut
depth. Atomic asynchronous
checkpoints every ``--ckpt-every`` steps (``distributed.fault_tolerance``);
SIGTERM writes a final checkpoint at the step reached and exits;
``--resume`` restores params, optimizer state, step and the data
iterator's state from the newest checkpoint. ``--sparsity`` enables
mask-preserving sparse training, the paper's retraining-based pruning
loop: the masks follow the reference launcher's rule exactly
(:func:`reference_masks`), and the checkpoint's manifest records the
sparsity, so ``launch.serve --ckpt`` encodes the trained weights with
exactly their masks.

``--mesh DxM`` trains data-parallel over D and tensor-parallel over M
ranks (``launch.mesh``, ``fsdp`` off as in the reference's ``train.py``;
ZeRO-3 runs through ``launch.specs.build_cell``'s train cells, as in the
reference): every rank
draws the whole model from the seed, computes the masks on the whole
leaves by the launcher's rule, keeps its shard
(``distributed.sharding``) and takes its slice of each global batch.
Checkpoints hold whole arrays (``distributed.fault_tolerance``), so
``--resume`` continues on another mesh, or on none. ``main`` starts its
own world of D x M ranks unless it runs inside one already (``torchrun``:
``WORLD_SIZE`` set).

It runs on the card (``device="cuda"``) unless ``main`` is asked for
another device; the tests call ``main([...], device="cpu")``.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.core import pruning
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.training import data as data_mod
from repro_torch.training import optimizer as opt_mod
from repro_torch.training import train_loop


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--sparsity", type=float, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help='"DxM": D data-parallel by M tensor-parallel ranks')
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--layers", type=int, default=None,
                    help="train the arch's first N layers only")
    args = ap.parse_args(argv)
    if args.layers is not None and args.layers < 1:
        ap.error(f"--layers {args.layers}: at least one layer")
    if args.mesh:
        try:
            mesh_mod.parse_mesh(args.mesh)
        except ValueError as e:
            ap.error(str(e))
    return args


def masked_leaf(cfg: ModelConfig, path: str, layer_ndim: int) -> bool:
    """The reference launcher's rule for one leaf under ``['layers']``:
    it masks leaves of ``ndim == 3`` whose path holds ``'w'``. Its scan
    configs (``transformer.uses_scan``) stack every layer leaf ``[L,
    ...]``, so a 2-D weight of a layer qualifies; an unrolled
    ``layer_pattern`` stack keeps its leaves per layer, where only a 3-D
    one would. MoE's 4-D stacked expert stacks never qualify."""
    ndim = layer_ndim + (1 if transformer.uses_scan(cfg) else 0)
    return ndim == 3 and "'w'" in path


def reference_masks(params: Any, cfg: ModelConfig, sparsity: float) -> Any:
    """Bool masks by the reference launcher's rule (``repro.launch.train``),
    bit for bit: for every leaf :func:`masked_leaf` picks, the top
    ``1 - sparsity`` by magnitude over the whole leaf as the reference
    holds it, so one threshold over a scan config's ``[L, in, out]``
    stack (``pruning.unstructured_mask`` thresholds each matrix, so the
    layers are concatenated first); ``None`` elsewhere."""
    masks: Dict[str, Any] = {k: opt_mod.tree_map(lambda _: None, v)
                             for k, v in params.items()}
    stack = params["layers"]
    scan = transformer.uses_scan(cfg)
    for path, _ in ft.flatten_with_paths(stack[0] if scan else {}):
        full = f"['layers']{path}"
        leaves = [_at(layer, path) for layer in stack]
        if leaves[0].dim() != 2 or not masked_leaf(cfg, full, 2):
            continue
        cat = torch.cat([w.abs() for w in leaves])      # [L * out, in]
        mask = pruning.unstructured_mask(cat, sparsity)
        del cat
        for i, m in enumerate(mask.split(leaves[0].shape[0])):
            _set(masks["layers"][i], path, m)
    if not scan:
        for i, layer in enumerate(stack):
            for path, w in ft.flatten_with_paths(layer):
                if masked_leaf(cfg, f"['layers'][{i}]{path}", w.dim()):
                    _set(masks["layers"][i], path,
                         pruning.unstructured_mask(
                             w.abs().reshape(1, -1), sparsity
                         ).reshape(w.shape))
    return masks


def _at(tree: Any, path: str) -> Any:
    for step in ft.split_path(path):
        tree = tree[step]
    return tree


def _set(tree: Any, path: str, value: Any) -> None:
    steps = ft.split_path(path)
    for step in steps[:-1]:
        tree = tree[step]
    tree[steps[-1]] = value


def mask_counts(masks: Any) -> Dict[str, int]:
    """Kept positions of every masked leaf, by path."""
    return {path: int(m.sum()) for path, m in ft.flatten_with_paths(masks)}


def run_config(args: argparse.Namespace):
    """The arch's config (``--smoke``: the reduced one), cut to its first
    ``--layers`` layers."""
    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    if args.layers is None:
        return cfg
    return dataclasses.replace(cfg, n_layers=args.layers)


def setup(args: argparse.Namespace, device: DeviceLike = None,
          mesh=None) -> dict:
    """The run's objects: config, optimizer, state (masked), masks, data
    stream, checkpoint manager, and the step to start from (after
    ``--resume``). Under ``mesh`` the state and masks are this rank's
    shards, and ``shardings`` the whole params' specs."""
    dev = resolve_device(device)
    cfg = run_config(args)
    opt = opt_mod.AdamW(lr=opt_mod.cosine_schedule(args.lr, args.warmup,
                                                   args.steps))
    if mesh is None:
        state = train_loop.init_train_state(cfg, opt, seed=args.seed,
                                            device=dev)
        params = state.params
    else:                   # the whole draw, then this rank's shard
        params = transformer.init_model(cfg, seed=args.seed, device=dev)
    masks = None
    if args.sparsity:
        masks = reference_masks(params, cfg, args.sparsity)
        params = opt_mod.apply_masks(params, masks)
    shardings = None
    if mesh is not None:
        shardings = sharding.params_shardings(params, mesh)
        params = sharding.shard_params(params, mesh)
        if masks is not None:
            masks = sharding.shard_params(masks, mesh)
        state = train_loop.TrainState(
            params, opt.init(params),
            torch.zeros((), dtype=torch.int32, device=dev))
    else:
        state = train_loop.TrainState(params, state.opt_state, state.step)
    stream = data_mod.SyntheticLM(cfg.vocab, args.seq, args.batch,
                                  seed=args.seed, n_codebooks=cfg.n_codebooks)
    mgr = (ft.CheckpointManager(args.ckpt_dir, keep=3, async_save=True)
           if args.ckpt_dir else None)
    start = 0
    if args.resume and mgr and mgr.latest_step() is not None:
        (state, data_state), meta = mgr.restore((state, stream.state_dict()),
                                                device=dev, mesh=mesh)
        stream.load_state_dict(data_state)
        start = meta["step"]
        _say(mesh, f"resumed from step {start}")
    return dict(cfg=cfg, opt=opt, state=state, masks=masks, stream=stream,
                mgr=mgr, start=start, device=dev, shardings=shardings)


def _say(mesh, line: str) -> None:
    """Print on one rank of a mesh (every rank logs the same lines)."""
    if mesh is None or dist.get_rank() == 0:
        print(line, flush=True)


def checkpoint_extra(args: argparse.Namespace) -> dict:
    """What the manifest records beside the state: the masks' sparsity."""
    return {"sparsity": args.sparsity} if args.sparsity else {}


def main(argv: Optional[Sequence[str]] = None, *,
         device: DeviceLike = None) -> dict:
    """Train; returns the final state, the masks and the logged lines.
    With ``--mesh DxM`` outside a running world, starts D x M ranks and
    returns rank 0's logged lines and step count."""
    args = parse_args(argv)
    if not args.mesh:
        return train(args, device)
    d, m = mesh_mod.parse_mesh(args.mesh)
    dev = resolve_device(device)
    cfg = run_config(args)
    transformer.check_tensor_parallel(cfg, m)
    if dist.is_initialized():                   # a rank of a running world
        if dist.get_world_size() != d * m:
            raise ValueError(f"--mesh {args.mesh} in a world of "
                             f"{dist.get_world_size()} ranks")
        mesh = mesh_mod.make_host_mesh(d * m, m, device_type=dev.type)
        return train(args, mesh_mod.rank_device(mesh), mesh)
    argv = list(sys.argv[1:] if argv is None else argv)
    return mesh_mod.run_world(_train_rank, (d, m), device=dev,
                              args=(argv,))[0]


def _train_rank(mesh, argv: Sequence[str]) -> dict:
    out = train(parse_args(argv), mesh_mod.rank_device(mesh), mesh)
    return {k: out[k] for k in ("log", "steps")}


def train(args: argparse.Namespace, device: DeviceLike = None,
          mesh=None) -> dict:
    """The training loop of :func:`main` on this process (a rank's share
    under ``mesh``)."""
    run = setup(args, device, mesh)
    state = run.pop("state")        # the loop's own: the first state goes
    stream, mgr, dev = (run[k] for k in ("stream", "mgr", "device"))
    step_fn = train_loop.make_train_step(run["cfg"], run["opt"],
                                         masks=run["masks"],
                                         microbatches=args.microbatches,
                                         mesh=mesh,
                                         shardings=run["shardings"])
    data_at = ((mesh.get_local_rank("data"), mesh.size(0))
               if mesh is not None else (0, 1))
    preempt = ft.PreemptionHandler()
    extra = checkpoint_extra(args)
    save_kw = dict(extra=extra, mesh=mesh, shardings=run["shardings"])
    log: List[dict] = []
    done = run["start"]
    try:
        t0 = time.perf_counter()
        for s in range(run["start"], args.steps):
            batch = data_mod.batch_slice(stream.next_batch(), *data_at)
            state, metrics = step_fn(state, train_loop.batch_to(batch, dev))
            done = s + 1
            if done % args.log_every == 0:
                loss, gnorm = float(metrics["loss"]), \
                    float(metrics["grad_norm"])    # waits for the step
                dt = (time.perf_counter() - t0) / args.log_every
                tok_s = args.batch * args.seq / dt
                _say(mesh, f"step {done:5d} loss {loss:.4f} gnorm "
                     f"{gnorm:.3f} {tok_s:,.0f} tok/s")
                log.append(dict(step=done, loss=loss, grad_norm=gnorm,
                                tok_s=tok_s))
                t0 = time.perf_counter()
            if _stop(preempt, mesh):
                _say(mesh, "preemption: writing the final checkpoint; "
                     "exiting")
                break
            if mgr and done % args.ckpt_every == 0:
                mgr.save(done, (state, stream.state_dict()), **save_kw)
        if mgr:             # the final checkpoint, at the step reached
            mgr.save(done, (state, stream.state_dict()), block=True,
                     **save_kw)
    finally:
        preempt.close()
    _say(mesh, "done")
    return dict(state=state, masks=run["masks"], log=log, steps=done,
                cfg=run["cfg"])


def _stop(preempt: ft.PreemptionHandler, mesh) -> bool:
    """Whether to stop now; under a mesh, as soon as any rank was told
    to (every rank leaves the loop at the same step)."""
    if mesh is None:
        return preempt.should_stop
    flag = torch.tensor([int(preempt.should_stop)],
                        device=mesh_mod.rank_device(mesh))
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())


if __name__ == "__main__":
    main()
