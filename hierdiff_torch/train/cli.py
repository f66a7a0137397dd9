"""Training CLI of the port: the coarse, edge-denoise and refine stages.

    python -m hierdiff_torch.train.cli coarse  [--config c.yaml] [--init-seed S]
        [--weights w.pt] [--device D] [--find-lr] [--no-data-parallel] [--wandb] [k=v ...]
    # data-parallel over D cards: one process per card
    torchrun --nproc-per-node D -m hierdiff_torch.train.cli coarse ...
    # the pocket-conditioned family, on synthetic pockets
    python -m hierdiff_torch.train.cli coarse --config configs/coarse_crossdock.yaml
    python -m hierdiff_torch.train.cli denoise --config configs/denoise_geom.yaml ...
    python -m hierdiff_torch.train.cli refine  --config configs/refine_geom.yaml ...

Port of ``hierdiff_tpu/train/cli.py`` (reference endiffusion/train.py,
train_edge_denoise_pl.py and train_refine_pl.py). The configuration is the
GEOM default (``config.py``), a YAML file in the JAX package's format, and
dotted overrides such as ``train.max_steps=20``. Weights start from the JAX
package's initialisers with ``--init-seed`` (default ``train.seed``) or from
a state dict (``--weights``, ``.pt`` or ``.npz``, or a reference Lightning
checkpoint of the stage's model). Runs on CUDA unless
``--device`` says otherwise; trains from the stream's second batch, as the
JAX CLI does (it spends the first on ``model.init``); prints the
configuration (``utils/log.print_config``) on rank 0; resumes from the
workdir's latest checkpoint;
evaluates on ``EVAL_BATCHES`` batches drawn from ``train.seed + 1``; prints
steps/s and molecules/s (coarse) or trees/s (denoise, refine) at the end,
and for ``denoise`` the packer that made its batches. The ``ema.pt`` it
writes loads into ``sampling.cli`` (``--weights``, ``--denoise-weights``,
``--refine-weights``).

``--data-parallel`` (the default, as the JAX ``Trainer``'s) trains over
every rank of a ``torch.distributed`` group (``parallel/mesh.py``): the
group this process is in, ``torchrun``'s, or on a machine with D > 1 visible
cards D NCCL ranks that the CLI spawns. Every rank draws the same global
batches of ``train.batch_size`` and keeps its rows; rank 0 alone writes the
workdir and prints. With one card, the CPU or ``--no-data-parallel`` the run
is one process. ``--wandb`` logs to Weights & Biases when the package is
installed; TensorBoard scalars go to ``<workdir>/tb`` when
``torch.utils.tensorboard`` imports.
"""

from __future__ import annotations

import argparse
from collections import Counter
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import Tensor, nn

from hierdiff_torch.config import load_config
from hierdiff_torch.parallel.mesh import in_group, run_cli_ranks, world
from hierdiff_torch.parallel.train_step import Metric, Ratio
from hierdiff_torch.sampling.cli import (build_coarse_from_cfg, build_denoise_from_cfg,
                                         build_refine_from_cfg)
from hierdiff_torch.train.data_iters import (coarse_iter, denoise_iter, finite, load_tree_pool,
                                             prefetch_to_device, refine_iter, shard_iter,
                                             to_device)
from hierdiff_torch.train.trainer import Trainer
from hierdiff_torch.utils.cache import enable_compilation_cache
from hierdiff_torch.utils.device import resolve_device
from hierdiff_torch.utils.log import print_config
from hierdiff_torch.utils.weights import init_weights, load_weights

EVAL_BATCHES = 4


def coarse_loss(model: nn.Module, batch: Dict[str, Tensor],
                generator: Optional[torch.Generator]) -> Tuple[Tensor, Dict[str, Tensor]]:
    """The coarse stage's training loss and the batch-mean eps error."""
    out = model(batch, generator, train=True)
    return out["loss"], {"error": out["error"].mean()}


def denoise_loss(model: nn.Module, batch: Dict[str, Tensor],
                 generator: Optional[torch.Generator]) -> Tuple[Tensor, Dict[str, Metric]]:
    """``total_loss`` of ``EdgeDenoise.forward``; its three losses and three
    accuracies as metrics, the focal and edge accuracies as ``Ratio``s of
    their hits and valid rows."""
    out, parts = model.loss_terms(batch)
    return out["total_loss"], {k: Ratio(*parts[k]) if k in parts else v
                               for k, v in out.items() if k != "total_loss"}


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


def initial_model(cfg, device, weights: str = "", init_seed: Optional[int] = None) -> nn.Module:
    """The model of ``cfg.stage`` on ``device``, in training mode: with the
    weights at ``weights`` (``utils/weights.load_weights``), else random
    weights from ``init_seed`` (default ``train.seed``)."""
    model = BUILDERS[cfg.stage][0](cfg, device).train()
    if weights:
        load_weights(model, weights, cfg.stage)
    else:
        init_weights(model, torch.Generator().manual_seed(
            cfg.train.seed if init_seed is None else init_seed))
    return model


def main(argv: Optional[list] = None) -> dict:
    enable_compilation_cache()
    parser = argparse.ArgumentParser(description="HierDiff training (PyTorch port)")
    parser.add_argument("stage", choices=list(BUILDERS))
    parser.add_argument("--config", default=None,
                        help="YAML in the JAX package's format (default: GEOM config)")
    parser.add_argument("--init-seed", type=int, default=None,
                        help="seed of the initial weights (default train.seed)")
    parser.add_argument("--weights", default="",
                        help="initial .pt or .npz state dict, or a reference Lightning checkpoint")
    parser.add_argument("--device", default=None, help="torch device (default cuda)")
    parser.add_argument("--find-lr", action="store_true",
                        help="LR sweep instead of training (writes lr_find.csv)")
    parser.add_argument("--data-parallel", action=argparse.BooleanOptionalAction, default=True,
                        help="train over every rank: the process group this runs in, "
                             "torchrun's, or one spawned rank per visible card")
    parser.add_argument("--wandb", action="store_true",
                        help="log to Weights & Biases when the package is installed")
    parser.add_argument("overrides", nargs="*", help="dotted overrides: train.max_steps=100")
    args = parser.parse_intermixed_args(argv)   # overrides may follow options

    device = resolve_device(args.device)
    if args.data_parallel:
        device, spawned = run_cli_ranks(main, argv, device)
        if spawned:
            return {"ranks": spawned}
    elif in_group():
        raise SystemExit("--no-data-parallel runs one process, not a rank of a process group")
    rank, size = world()
    cfg = load_config(args.config, args.overrides)
    cfg.stage = args.stage
    if rank == 0:
        print_config(cfg)
    if in_group() and rank == 0:
        print(f"data-parallel over {size} ranks ({dist.get_backend()}), global batch "
              f"{cfg.train.batch_size}", flush=True)
    _, loss_fn, make_iter, unit = BUILDERS[args.stage]
    model = initial_model(cfg, device, args.weights, args.init_seed)

    pool = load_tree_pool(cfg, seed=cfg.train.seed)
    # the batches each packer made (denoise: native C++ or the Python collator)
    packers: Counter = Counter()
    extra = {"packers": packers} if args.stage == "denoise" else {}
    # every rank draws the same global batches and keeps its rows
    train_it = prefetch_to_device(
        shard_iter(make_iter(cfg, pool, seed=cfg.train.seed, **extra), rank, size), device)
    # the JAX CLI spends the stream's first batch on model.init; skip it, so
    # find_lr and fit see the same batches as there, from the second on
    next(train_it)
    trainer = Trainer(cfg, model, loss_fn, device, unit=unit, wandb=args.wandb)
    if args.find_lr:
        return {"lr": trainer.find_lr(train_it), "trainer": trainer}
    if trainer.try_resume():
        trainer.print(f"resumed from step {trainer.state.step}")

    def eval_iter():
        batches = finite(make_iter(cfg, pool, seed=cfg.train.seed + 1, **extra), EVAL_BATCHES)
        return (to_device(b, device) for b in shard_iter(batches, rank, size))

    result = trainer.fit(train_it, eval_iter=eval_iter)
    rate = trainer.rate_key
    trainer.print(f"training complete: {args.stage}, {cfg.train.workdir}, {result['steps']} steps "
                  f"in {result['seconds']:.3f} s; after the first step "
                  f"{result['steps_per_sec']:.4f} steps/s, {result[rate]:.3f} {unit}/s (batch "
                  f"{cfg.train.batch_size}, device {device}, {size} ranks)")
    if args.stage == "denoise":
        # training and evaluation batches; the prefetcher runs a few ahead
        trainer.print(f"denoise batches by packer: {dict(packers)}")
    return {**result, "trainer": trainer, "packers": dict(packers)}


if __name__ == "__main__":
    main()
