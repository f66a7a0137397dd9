"""Training CLI of the port: the coarse, edge-denoise and refine stages.

    python -m hierdiff_torch.train.cli coarse  [--config c.yaml] [--init-seed S]
        [--weights w.pt] [--device D] [--find-lr] [k=v ...]
    python -m hierdiff_torch.train.cli denoise --config configs/denoise_geom.yaml ...
    python -m hierdiff_torch.train.cli refine  --config configs/refine_geom.yaml ...

Port of ``hierdiff_tpu/train/cli.py`` (reference endiffusion/train.py,
train_edge_denoise_pl.py and train_refine_pl.py). The configuration is the
GEOM default (``config.py``), a YAML file in the JAX package's format, and
dotted overrides such as ``train.max_steps=20``. Weights start from the JAX
package's initialisers with ``--init-seed`` (default ``train.seed``) or from
a state dict (``--weights``, ``.pt`` or ``.npz``). Runs on CUDA unless
``--device`` says otherwise; trains from the stream's second batch, as the
JAX CLI does (it spends the first on ``model.init``); resumes from the
workdir's latest checkpoint;
evaluates on ``EVAL_BATCHES`` batches drawn from ``train.seed + 1``; prints
steps/s and molecules/s (coarse) or trees/s (denoise, refine) at the end,
and for ``denoise`` the packer that made its batches. The ``ema.pt`` it
writes loads into ``sampling.cli`` (``--weights``, ``--denoise-weights``,
``--refine-weights``).
"""

from __future__ import annotations

import argparse
from collections import Counter
from typing import Dict, Optional, Tuple

import torch
from torch import Tensor, nn

from hierdiff_torch.config import load_config
from hierdiff_torch.sampling.cli import (build_coarse_from_cfg, build_denoise_from_cfg,
                                         build_refine_from_cfg, load_state)
from hierdiff_torch.train.data_iters import (coarse_iter, denoise_iter, finite, load_tree_pool,
                                             prefetch_to_device, refine_iter, to_device)
from hierdiff_torch.train.trainer import Trainer
from hierdiff_torch.utils.device import resolve_device
from hierdiff_torch.utils.weights import init_weights

EVAL_BATCHES = 4


def coarse_loss(model: nn.Module, batch: Dict[str, Tensor],
                generator: Optional[torch.Generator]) -> Tuple[Tensor, Dict[str, Tensor]]:
    """The coarse stage's training loss and the batch-mean eps error."""
    out = model(batch, generator, train=True)
    return out["loss"], {"error": out["error"].mean()}


def denoise_loss(model: nn.Module, batch: Dict[str, Tensor],
                 generator: Optional[torch.Generator]) -> Tuple[Tensor, Dict[str, Tensor]]:
    """``total_loss`` of ``EdgeDenoise.forward``; its three losses and three
    accuracies as metrics."""
    out = model(batch)
    return out["total_loss"], {k: v for k, v in out.items() if k != "total_loss"}


def refine_loss(model: nn.Module, batch: Dict[str, Tensor],
                generator: Optional[torch.Generator]) -> Tuple[Tensor, Dict[str, Tensor]]:
    """The refine model's masked-node CE and its accuracy."""
    out = model(batch)
    return out["loss"], {"accuracy": out["accuracy"]}


# stage -> (model builder (cfg, device), loss function, batch iterator,
# what a batch holds)
BUILDERS = {
    "coarse": (lambda cfg, device: build_coarse_from_cfg(cfg.coarse, device=device),
               coarse_loss, coarse_iter, "molecules"),
    "denoise": (lambda cfg, device: build_denoise_from_cfg(cfg.denoise, device),
                denoise_loss, denoise_iter, "trees"),
    "refine": (lambda cfg, device: build_refine_from_cfg(cfg.refine, device),
               refine_loss, refine_iter, "trees")}


def main(argv: Optional[list] = None) -> dict:
    parser = argparse.ArgumentParser(description="HierDiff training (PyTorch port)")
    parser.add_argument("stage", choices=list(BUILDERS))
    parser.add_argument("--config", default=None,
                        help="YAML in the JAX package's format (default: GEOM config)")
    parser.add_argument("--init-seed", type=int, default=None,
                        help="seed of the initial weights (default train.seed)")
    parser.add_argument("--weights", default="", help="initial .pt or .npz state dict")
    parser.add_argument("--device", default=None, help="torch device (default cuda)")
    parser.add_argument("--find-lr", action="store_true",
                        help="LR sweep instead of training (writes lr_find.csv)")
    parser.add_argument("overrides", nargs="*", help="dotted overrides: train.max_steps=100")
    args = parser.parse_intermixed_args(argv)   # overrides may follow options

    cfg = load_config(args.config, args.overrides)
    cfg.stage = args.stage
    device = resolve_device(args.device)
    build, loss_fn, make_iter, unit = BUILDERS[args.stage]
    model = build(cfg, device).train()
    if args.weights:
        model.load_state_dict(load_state(args.weights), strict=True)
    else:
        seed = cfg.train.seed if args.init_seed is None else args.init_seed
        init_weights(model, torch.Generator().manual_seed(seed))

    pool = load_tree_pool(cfg, seed=cfg.train.seed)
    # the batches each packer made (denoise: native C++ or the Python collator)
    packers: Counter = Counter()
    extra = {"packers": packers} if args.stage == "denoise" else {}
    train_it = prefetch_to_device(make_iter(cfg, pool, seed=cfg.train.seed, **extra), device)
    # the JAX CLI spends the stream's first batch on model.init; skip it, so
    # find_lr and fit see the same batches as there, from the second on
    next(train_it)
    trainer = Trainer(cfg, model, loss_fn, device, unit=unit)
    if args.find_lr:
        return {"lr": trainer.find_lr(train_it), "trainer": trainer}
    if trainer.try_resume():
        print(f"resumed from step {trainer.state.step}")

    def eval_iter():
        batches = finite(make_iter(cfg, pool, seed=cfg.train.seed + 1, **extra), EVAL_BATCHES)
        return (to_device(b, device) for b in batches)

    result = trainer.fit(train_it, eval_iter=eval_iter)
    rate = trainer.rate_key
    print(f"training complete: {args.stage}, {cfg.train.workdir}, {result['steps']} steps in "
          f"{result['seconds']:.3f} s; after the first step {result['steps_per_sec']:.4f} "
          f"steps/s, {result[rate]:.3f} {unit}/s (batch {cfg.train.batch_size}, device "
          f"{device})", flush=True)
    if args.stage == "denoise":
        # training and evaluation batches; the prefetcher runs a few ahead
        print(f"denoise batches by packer: {dict(packers)}", flush=True)
    return {**result, "trainer": trainer, "packers": dict(packers)}


if __name__ == "__main__":
    main()
