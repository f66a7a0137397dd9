"""Training CLI of the port: the coarse stage.

    python -m hierdiff_torch.train.cli coarse [--config c.yaml] [--init-seed S]
        [--weights w.pt] [--device D] [--find-lr] [k=v ...]

Port of ``hierdiff_tpu/train/cli.py coarse`` (reference endiffusion/train.py).
The configuration is the GEOM default (``config.py``), a YAML file in the
JAX package's format, and dotted overrides such as ``train.max_steps=20``.
Weights start from the JAX package's initialisers with ``--init-seed``
(default ``train.seed``) or from a state dict (``--weights``, ``.pt`` or
``.npz``). Runs on CUDA unless ``--device`` says otherwise; resumes from the
workdir's latest checkpoint; prints steps/s and molecules/s at the end.
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch

from hierdiff_torch.config import load_config
from hierdiff_torch.sampling.cli import build_coarse_from_cfg, load_state
from hierdiff_torch.train.data_iters import (coarse_iter, finite, load_tree_pool,
                                             prefetch_to_device, to_device)
from hierdiff_torch.train.trainer import Trainer
from hierdiff_torch.utils.device import resolve_device
from hierdiff_torch.utils.weights import init_weights

EVAL_BATCHES = 4


def main(argv: Optional[list] = None) -> dict:
    parser = argparse.ArgumentParser(description="HierDiff training (PyTorch port)")
    parser.add_argument("stage", choices=["coarse"])
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
    model = build_coarse_from_cfg(cfg.coarse, device=device).train()
    if args.weights:
        model.load_state_dict(load_state(args.weights), strict=True)
    else:
        seed = cfg.train.seed if args.init_seed is None else args.init_seed
        init_weights(model, torch.Generator().manual_seed(seed))

    pool = load_tree_pool(cfg, seed=cfg.train.seed)
    train_it = prefetch_to_device(coarse_iter(cfg, pool, seed=cfg.train.seed), device)
    trainer = Trainer(cfg, model, device)
    if args.find_lr:
        return {"lr": trainer.find_lr(train_it), "trainer": trainer}
    if trainer.try_resume():
        print(f"resumed from step {trainer.state.step}")

    def eval_iter():
        batches = finite(coarse_iter(cfg, pool, seed=cfg.train.seed + 1), EVAL_BATCHES)
        return (to_device(b, device) for b in batches)

    result = trainer.fit(train_it, eval_iter=eval_iter)
    print(f"training complete: {cfg.train.workdir}, {result['steps']} steps in "
          f"{result['seconds']:.3f} s; after the first step {result['steps_per_sec']:.4f} "
          f"steps/s, {result['molecules_per_sec']:.3f} molecules/s (batch "
          f"{cfg.train.batch_size}, device {device})", flush=True)
    return {**result, "trainer": trainer}


if __name__ == "__main__":
    main()
