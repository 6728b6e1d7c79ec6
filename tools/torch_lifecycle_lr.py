"""Which peak learning rate lowers the lifecycle's loss at a model's
published widths.

Runs ``examples/torch_train_prune_serve.py``'s ``train`` for ``--steps``
steps at each ``--lr`` (batch 4 x 128 on ``SyntheticLM``, the reference
example's cosine schedule with 20 warm-up steps), then its masks and
``--finetune`` retraining steps, and prints one JSON line per rate: the
loss of one held-out batch under the params the run started from, after
the dense steps, pruned and retrained, with each step's loss.
``chip_smoke.py``'s lifecycle takes its rate from this.

Run:  PYTHONPATH=src python tools/torch_lifecycle_lr.py
      [--arch tinyllama_1_1b] [--layers 4] [--lr 1e-3 3e-4 1e-4]
      [--device cpu] [--smoke]
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import pathlib
from typing import List, Optional, Sequence

import torch

from repro_torch import configs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer
from repro_torch.training import optimizer as opt_mod
from repro_torch.training import train_loop

EXAMPLE = (pathlib.Path(__file__).resolve().parents[1] / "examples"
           / "torch_train_prune_serve.py")


def _example():
    spec = importlib.util.spec_from_file_location(EXAMPLE.stem, EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv: Optional[Sequence[str]] = None, *,
         device: DeviceLike = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="tinyllama_1_1b")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--finetune", type=int, default=10)
    ap.add_argument("--lr", type=float, nargs="+", default=[1e-3, 3e-4, 1e-4])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)
    ex = _example()
    cfg = (configs.smoke if args.smoke else configs.get)(args.arch)
    cfg = dataclasses.replace(cfg, n_layers=args.layers)
    rows = []
    for lr in args.lr:
        trained = ex.train(cfg, args.steps, lr=lr, device=dev,
                           log_every=args.steps + 1)
        params = trained["state"].params
        held_out = train_loop.batch_to(trained["stream"].next_batch(), dev)
        start = transformer.init_model(cfg, seed=0, device=dev,
                                       dtype=torch.float32)
        loss_start = ex.loss_of(start, held_out, cfg)
        del start
        masks = ex.make_masks(params, cfg)
        pruned = opt_mod.apply_masks(params, masks)
        ft = ex.finetune(pruned, masks, cfg, trained["stream"],
                         args.finetune)
        row = dict(lr=lr, start=loss_start,
                   dense=ex.loss_of(params, held_out, cfg),
                   pruned=ex.loss_of(pruned, held_out, cfg),
                   retrained=ex.loss_of(ft["state"].params, held_out, cfg),
                   losses=trained["losses"], retrain_losses=ft["losses"])
        print(json.dumps(row), flush=True)
        rows.append(row)
        del trained, params, pruned, ft, masks
    return rows


if __name__ == "__main__":
    main()
