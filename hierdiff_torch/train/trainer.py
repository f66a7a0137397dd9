"""Training loop of the three stages: steps, evaluation, checkpoints, metrics.

Port of ``hierdiff_tpu/train/trainer.py`` (``Trainer``), over a loss function
``loss_fn(model, batch, generator) -> (loss, metrics)`` (``train/cli.py``
has one per stage): ``fit`` runs
``train.max_steps`` steps, evaluates on the EMA weights every
``train.eval_every`` steps (under ``torch.no_grad()``), keeps the last 3
checkpoints under ``checkpoints/`` and the best-eval one under
``checkpoints_best/`` (the reference's save_last + top-1 policy), writes the
EMA weights to ``ema.pt`` at every save (a state dict that the sampling
CLI's ``--weights``, ``--denoise-weights`` or ``--refine-weights`` loads with
``strict=True``), appends every logged row to ``metrics.csv`` (its header
from the first row's keys, as the JAX package writes it) and prints it with
``steps_per_sec`` and the rate of the stage's unit (``molecules_per_sec``
for the coarse stage, ``trees_per_sec`` for the fine stage's two models).
``try_resume`` continues from the latest checkpoint; ``find_lr`` is the
exponential learning-rate sweep. Checkpoints are ``torch.save`` files.
Every logged row also goes to TensorBoard (``<workdir>/tb``, scalars
``"{split}/{key}"``) when ``torch.utils.tensorboard`` imports, and to W&B
when ``wandb=True`` and the package imports; a missing one is named in one
printed line (``hierdiff_tpu/train/trainer.py:96-115``).

Inside a ``torch.distributed`` group (``parallel/mesh.py``) the model is
broadcast from rank 0, each step all-reduces its gradients and metrics
(``parallel/train_step.py``), and rank 0 alone writes ``config.json``,
``metrics.csv``, the event files, checkpoints and ``ema.pt`` and prints,
with a barrier after each write. A checkpoint holds every rank's generator
state, so a resumed run repeats; every rank loads it. The rates count the
global batch, ``train.batch_size``.
"""

from __future__ import annotations

import copy
import csv
import dataclasses
import json
import math
import os
import time
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from hierdiff_torch.config import Config
from hierdiff_torch.ops.egnn import drop_kernel_caches
from hierdiff_torch.parallel import mesh
from hierdiff_torch.parallel.train_step import LossFn, TrainState, eval_step, train_step

KEEP_LAST = 3


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    """Loop over ``model`` trained on ``loss_fn``; ``unit`` names what a
    batch holds ('molecules' or 'trees') in the rates."""

    def __init__(self, cfg: Config, model: nn.Module, loss_fn: LossFn, device: torch.device,
                 unit: str = "molecules", monitor: str = "loss", wandb: bool = False):
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.device = device
        self.rank, self.size = mesh.world()
        self.rate_key = f"{unit}_per_sec"
        self.workdir = Path(cfg.train.workdir)
        if self.rank == 0:
            self.workdir.mkdir(parents=True, exist_ok=True)
            (self.workdir / "config.json").write_text(
                json.dumps(dataclasses.asdict(cfg), indent=2))
        mesh.barrier()
        self.state = TrainState(mesh.replicate(model), cfg.optim)
        self.generator = torch.Generator(device=device).manual_seed(
            mesh.rank_seed(cfg.train.seed, self.rank))
        self.monitor = monitor
        self.best = float("inf")
        self.ckpt_dir = self.workdir / "checkpoints"
        self.best_dir = self.workdir / "checkpoints_best"
        self.metrics_file = self.workdir / "metrics.csv"
        self._fields: Optional[List[str]] = None
        self._tb = self._wandb = None
        if self.rank == 0:
            self._tb = _tensorboard_writer(self.workdir / "tb")
        if self.rank == 0 and wandb:
            self._wandb = _wandb_run(self.workdir, cfg)

    def print(self, msg: str) -> None:
        """Print on rank 0 only."""
        if self.rank == 0:
            print(msg, flush=True)

    # --- checkpointing -----------------------------------------------------

    def save(self, best: bool = False) -> Path:
        """A checkpoint of model, optimizer, EMA, step and every rank's
        generator (``generators``, by rank; ``generator`` is rank 0's); the
        periodic ones also refresh ``ema.pt``. Every rank takes part, rank 0
        writes."""
        directory = self.best_dir if best else self.ckpt_dir
        path = directory / f"step_{self.state.step:08d}.pt"
        generators = [self.generator.get_state()]
        if mesh.in_group():
            generators = [None] * self.size
            dist.all_gather_object(generators, self.generator.get_state())
        if self.rank == 0:
            directory.mkdir(parents=True, exist_ok=True)
            payload = self.state.state_dict()
            payload["generator"] = generators[0]
            payload["generators"] = generators
            payload["best"] = self.best
            tmp = path.with_suffix(".tmp")
            torch.save(payload, tmp)
            os.replace(tmp, path)
            for old in sorted(directory.glob("step_*.pt"))[:-(1 if best else KEEP_LAST)]:
                old.unlink()
            if not best:
                weights = self.state.ema if self.state.ema is not None else self.state.model
                torch.save(weights.state_dict(), self.workdir / "ema.tmp")
                os.replace(self.workdir / "ema.tmp", self.workdir / "ema.pt")
        mesh.barrier()
        return path

    def try_resume(self) -> bool:
        """Continue from the latest checkpoint under ``checkpoints/``, if any
        (the reference's try_resume, endiffusion/train.py:35-85), on every
        rank, each with its own generator state; a checkpoint of another
        world size raises."""
        ckpts = sorted(self.ckpt_dir.glob("step_*.pt"))
        if not ckpts:
            return False
        payload = torch.load(ckpts[-1], map_location="cpu", weights_only=True)
        generators = payload.get("generators", [payload["generator"]])
        if len(generators) != self.size:
            raise ValueError(f"{ckpts[-1]} holds the generators of {len(generators)} ranks; "
                             f"this run has {self.size}")
        self.state.load_state_dict(payload)
        self.generator.set_state(generators[self.rank])
        self.best = float(payload["best"])
        return True

    # --- logging -----------------------------------------------------------

    def log(self, step: int, metrics: Dict[str, float], split: str = "train") -> None:
        """On rank 0: append a row to ``metrics.csv``, print it, and write
        it to TensorBoard and W&B when they are on. The CSV's columns are
        the first row's keys (a resumed run keeps the file's header); a
        later row leaves out what they lack and leaves blank what it lacks."""
        if self.rank == 0:
            row = {"step": step, "split": split, **metrics}
            if self._fields is None and self.metrics_file.exists():
                with open(self.metrics_file, newline="") as f:
                    self._fields = next(csv.reader(f), None)
            new = self._fields is None
            if new:
                self._fields = list(row)
            with open(self.metrics_file, "a", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=self._fields, extrasaction="ignore")
                if new:
                    writer.writeheader()
                writer.writerow(row)
            msg = " ".join(f"{k}={v:.6g}" for k, v in metrics.items())
            print(f"[{split}] step {step}: {msg}", flush=True)
            if self._tb is not None:   # queued; written by the writer's thread and close()
                for k, v in metrics.items():
                    self._tb.add_scalar(f"{split}/{k}", v, step)
            if self._wandb is not None:
                self._wandb.log({f"{split}/{k}": v for k, v in metrics.items()}, step=step)
        mesh.barrier()

    def close(self) -> None:
        """Close the TensorBoard writer and finish the W&B run."""
        if self._tb is not None:
            self._tb.close()
            self._tb = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None

    # --- loop --------------------------------------------------------------

    def fit(self, train_iter: Iterator[Dict[str, torch.Tensor]],
            eval_iter: Optional[Callable[[], Iterator]] = None) -> Dict[str, float]:
        """Train to ``train.max_steps``. Returns the run's step count, wall
        seconds, and steps/s and the unit's rate over the training steps after
        the first (which pays for the kernel build and first-use set-up);
        evaluations and checkpoint writes are left out of those rates."""
        cfg = self.cfg.train
        start = self.state.step
        t_start = t_log = time.perf_counter()
        t_after_first, side = None, 0.0
        for step in range(start, cfg.max_steps):
            batch = next(train_iter)
            metrics = train_step(self.state, self.loss_fn, batch, self.generator)
            if step == start:
                _sync(self.device)
                t_after_first = time.perf_counter()
            if (step + 1) % cfg.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                now = time.perf_counter()
                m["steps_per_sec"] = cfg.log_every / max(now - t_log, 1e-9)
                m[self.rate_key] = m["steps_per_sec"] * cfg.batch_size
                t_log = now
                self.log(step + 1, m)
            evaluate = eval_iter is not None and (step + 1) % cfg.eval_every == 0
            if evaluate or (step + 1) % cfg.checkpoint_every == 0:
                _sync(self.device)
                t_side = time.perf_counter()
                if evaluate:
                    ev = self.evaluate(eval_iter())
                    self.log(step + 1, ev, split="val")
                    if ev[self.monitor] < self.best:
                        self.best = ev[self.monitor]
                        self.save(best=True)
                if (step + 1) % cfg.checkpoint_every == 0:
                    self.save()
                _sync(self.device)
                side += time.perf_counter() - t_side
                t_log += time.perf_counter() - t_side
        _sync(self.device)
        end = time.perf_counter()
        self.save()
        self.close()
        steps = cfg.max_steps - start
        timed = steps - 1 if steps > 1 else 0
        busy = end - t_after_first - side if t_after_first is not None else 0.0
        rate = timed / busy if timed and busy > 0 else float("nan")
        return {"steps": steps, "seconds": end - t_start, "steps_per_sec": rate,
                self.rate_key: rate * cfg.batch_size}

    def evaluate(self, it: Iterator) -> Dict[str, float]:
        """Mean loss and metrics on the EMA weights (the weights sampling
        uses), or on the model's own when EMA is off."""
        model = self.state.ema if self.state.ema is not None else self.state.model
        acc: Dict[str, list] = {}
        for batch in it:
            for k, v in eval_step(model, self.loss_fn, batch, self.generator).items():
                acc.setdefault(k, []).append(float(v))
        return {k: float(np.mean(v)) for k, v in acc.items()}

    # --- LR finder -----------------------------------------------------------

    def find_lr(self, train_iter: Iterator, min_lr: float = 1e-6, max_lr: float = 1.0,
                n_steps: int = 100) -> float:
        """Exponential LR sweep (the reference's find_lr mode,
        endiffusion/train.py:93-125) on a copy of the model: writes
        ``lr_find.csv`` and returns the rate a tenth of the sweep below the
        lowest loss."""
        lrs = np.exp(np.linspace(np.log(min_lr), np.log(max_lr), n_steps))
        optim = dataclasses.replace(self.cfg.optim, ema_decay=0.0)
        state = TrainState(drop_kernel_caches(copy.deepcopy(self.state.model)), optim)
        state.schedule = lambda count: float(lrs[count])
        losses = []
        best = float("inf")
        for _ in range(n_steps):
            loss = float(train_step(state, self.loss_fn, next(train_iter), self.generator)["loss"])
            losses.append(loss)
            best = min(best, loss)
            if not math.isfinite(loss) or loss > 10 * abs(best) + 1e3:
                break   # diverged
        if self.rank == 0:
            with open(self.workdir / "lr_find.csv", "w", newline="") as f:
                writer = csv.writer(f)
                writer.writerow(["lr", "loss"])
                writer.writerows(zip(lrs[: len(losses)], losses))
        mesh.barrier()
        self.close()
        suggestion = float(lrs[max(int(np.nanargmin(losses)) - n_steps // 10, 0)])
        self.print(f"find_lr: {len(losses)} steps, min loss {min(losses):.4g}, "
                   f"suggested lr {suggestion:.3g}")
        return suggestion


def _tensorboard_writer(logdir: Path):
    """A ``torch.utils.tensorboard.SummaryWriter`` on ``logdir``, or None
    with one printed line when it does not import (where TensorFlow is
    installed, TensorBoard imports it, which takes seconds)."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as exc:
        print(f"[log] tensorboard unavailable ({exc}); CSV only", flush=True)
        return None
    return SummaryWriter(str(logdir))


def _wandb_run(workdir: Path, cfg: Config):
    """A W&B run logging to ``workdir``, or None with one printed line when
    the package does not import."""
    try:
        import wandb
    except ImportError as exc:
        print(f"[log] wandb unavailable ({exc}); CSV and TensorBoard only", flush=True)
        return None
    return wandb.init(project="hierdiff-torch", dir=str(workdir), config=dataclasses.asdict(cfg))
