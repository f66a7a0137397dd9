"""One training step on one device: loss, optimizer, clipping, EMA.

Port of ``hierdiff_tpu/parallel/train_step.py`` (``TrainState``,
``make_train_step``, ``make_eval_step``) and of
``hierdiff_tpu/train/trainer.py:build_optimizer``, for any of the three
stages' loss functions: gradients from ``loss.backward()``; ``grad_norm``
is the global L2 norm before clipping; clipping follows
``optax.clip_by_global_norm`` exactly (``g / norm * max_norm`` only when
``norm >= max_norm``; torch's ``clip_grad_norm_`` would add 1e-6 to the
norm); then AdamW with optax's defaults and decoupled weight decay on every
parameter (or Adam, or SGD with momentum 0.9), the learning rate taken from
optax's schedules at the update's count; then the EMA, in the model's own ``deepcopy``, after the update.

Inside a ``torch.distributed`` group (``parallel/mesh.py``) each rank holds
its rows of the global batch, and the step all-reduces the gradients in one
flattened call (the JAX step's single all-reduce) right after the missing
ones are filled with zeros: ``grad_norm``, clipping, the optimizer and the
EMA see the global mean gradient, and the parameters stay bitwise equal on
every rank. The metrics are reduced too: the mean over ranks (the losses
are means over molecules or sums over the batch size, so the mean of equal
shards' values is the global one), and a ``Ratio`` by its numerator and
denominator, so that it is the global ratio.
"""

from __future__ import annotations

import copy
import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch import Tensor, nn

from hierdiff_torch.config import OptimConfig
from hierdiff_torch.ops.egnn import drop_kernel_caches
from hierdiff_torch.parallel.mesh import in_group


def _cosine(init_value: float, decay_steps: int, alpha: float = 0.0) -> Callable[[int], float]:
    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)
    return schedule


def learning_rate_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """The learning rate at update ``count`` (0 for the first update), as
    ``build_optimizer``'s optax schedules compute it: constant, cosine
    decay, staircase exponential decay (``step``), or, with
    ``warmup_steps``, linear warmup from 0 joined to cosine decay."""
    if cfg.warmup_steps > 0:
        warm, cos = cfg.warmup_steps, _cosine(cfg.lr, cfg.decay_steps - cfg.warmup_steps)
        return lambda count: (cfg.lr * min(count, warm) / warm if count < warm
                              else cos(count - warm))
    if cfg.schedule == "cosine":
        return _cosine(cfg.lr, cfg.decay_steps)
    if cfg.schedule == "step":
        return lambda count: cfg.lr * cfg.step_gamma ** (count // cfg.step_size)
    return lambda count: cfg.lr


def build_optimizer(cfg: OptimConfig, params: List[nn.Parameter]) -> torch.optim.Optimizer:
    """The update rule of ``hierdiff_tpu/train/trainer.py:build_optimizer``
    (:53-58), with optax's defaults: ``adamw`` = optax.adamw(lr,
    weight_decay), ``adam`` = optax.adam(lr), ``sgd`` = optax.sgd(lr,
    momentum=0.9) (torch's SGD with dampening 0 keeps optax's trace
    g + 0.9 t). The learning rate is set per update by ``TrainState``."""
    lr = learning_rate_schedule(cfg)(0)
    if cfg.optimizer == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=cfg.weight_decay)
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=0.9, dampening=0.0)
    raise ValueError(cfg.optimizer)


def global_norm(tensors: List[Tensor]) -> Tensor:
    """The L2 norm of all elements together (optax.global_norm), from the
    per-tensor norms of one foreach launch."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class TrainState:
    """Model, optimizer, EMA copy and update count.

    The EMA model is a ``deepcopy`` of the model with its own kernel-weight
    caches (dropped at the copy, so the two never share bf16 weights); its
    parameters are updated in place after every step, which rebuilds its
    caches when it next runs."""

    def __init__(self, model: nn.Module, cfg: OptimConfig):
        self.model = model
        self.params = list(model.parameters())
        self.schedule = learning_rate_schedule(cfg)
        self.optimizer = build_optimizer(cfg, self.params)
        self.grad_clip = cfg.grad_clip
        self.ema_decay = cfg.ema_decay
        self.ema = None
        if cfg.ema_decay > 0:
            self.ema = drop_kernel_caches(copy.deepcopy(model)).requires_grad_(False)
        self.step = 0

    def apply_gradients(self) -> Tensor:
        """Clip, step the optimizer and the EMA; returns the gradient's
        global norm before clipping."""
        norm = self.update()
        self.update_ema()
        return norm

    def update(self) -> Tensor:
        """Clip and step the optimizer; returns the norm before clipping."""
        for p in self.params:   # every parameter takes part, as in optax
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if in_group():
            all_reduce_mean(grads)
        norm = global_norm(grads)
        if self.grad_clip:
            # g if norm < max_norm else g / norm * max_norm, on the device
            # (no host sync): each branch is multiplied by an exact 1 or 0
            keep = (norm < self.grad_clip).to(norm.dtype)
            clipped = torch._foreach_div(grads, norm)
            torch._foreach_mul_(clipped, self.grad_clip)
            torch._foreach_mul_(clipped, 1.0 - keep)
            torch._foreach_mul_(grads, keep)
            torch._foreach_add_(grads, clipped)
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step)
        self.optimizer.step()
        drop_kernel_caches(self.model)   # a fused step leaves version counters as they were
        self.step += 1
        return norm.detach()

    def update_ema(self) -> None:
        """ema = ema * decay + (1 - decay) * params, after the update."""
        if self.ema is not None:
            with torch.no_grad():
                ema_params = list(self.ema.parameters())
                torch._foreach_mul_(ema_params, self.ema_decay)
                torch._foreach_add_(ema_params, self.params, alpha=1.0 - self.ema_decay)

    def state_dict(self) -> dict:
        out = {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
               "step": self.step}
        if self.ema is not None:
            out["ema"] = self.ema.state_dict()
        return out

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        if self.ema is not None:
            self.ema.load_state_dict(state["ema"], strict=True)


def all_reduce_mean(tensors: List[Tensor]) -> None:
    """Each tensor replaced, in place, by its mean over the group's ranks:
    one all-reduce of their flattened concatenation."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    torch._foreach_copy_(tensors, [v.view_as(t) for v, t in
                                   zip(flat.split([t.numel() for t in tensors]), tensors)])


class Ratio(NamedTuple):
    """A metric num / max(den, 1e-8) of two sums over the batch (an
    accuracy over the valid rows): reduced over ranks by its parts, so that
    it is the global batch's ratio."""
    num: Tensor
    den: Tensor

    def value(self) -> Tensor:
        return self.num / torch.clamp(self.den, min=1e-8)


Metric = Union[Tensor, Ratio]


def reduce_metrics(metrics: Dict[str, Metric]) -> Dict[str, Tensor]:
    """Detached metric tensors; inside a group the global batch's (one
    all-reduce): plain metrics averaged over ranks, a ``Ratio`` from its
    parts summed over ranks."""
    metrics = {k: (Ratio(v.num.detach(), v.den.detach()) if isinstance(v, Ratio) else v.detach())
               for k, v in metrics.items()}
    if in_group():
        size = dist.get_world_size()
        parts = [p for v in metrics.values() for p in (v if isinstance(v, Ratio) else (v,))]
        flat = torch.stack([p.to(torch.float32).reshape(()) for p in parts])
        dist.all_reduce(flat)
        it = iter(flat)
        metrics = {k: (Ratio(next(it), next(it)) if isinstance(v, Ratio) else next(it) / size)
                   for k, v in metrics.items()}
    return {k: v.value() if isinstance(v, Ratio) else v for k, v in metrics.items()}


# loss_fn(model, batch, generator) -> (loss, metrics): a scalar to minimise
# and device scalars (or ``Ratio``s) to report, as the JAX package's
# loss_fn(params, batch, rng) (hierdiff_tpu/parallel/train_step.py:66)
LossFn = Callable[[nn.Module, Dict[str, Tensor], Optional[torch.Generator]],
                  Tuple[Tensor, Dict[str, Metric]]]


def train_step(state: TrainState, loss_fn: LossFn, batch: Dict[str, Tensor],
               generator: Optional[torch.Generator]) -> Dict[str, Tensor]:
    """Loss, gradients and one update (``make_train_step``). Returns device
    scalars, not synchronised: ``loss``, the loss function's metrics and
    ``grad_norm``; inside a group, the global batch's."""
    loss, metrics = loss_fn(state.model, batch, generator)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    grad_norm = state.apply_gradients()
    return {**reduce_metrics({"loss": loss, **metrics}), "grad_norm": grad_norm}


def eval_step(model: nn.Module, loss_fn: LossFn, batch: Dict[str, Tensor],
              generator: Optional[torch.Generator]) -> Dict[str, Tensor]:
    """``loss`` and the metrics of ``model`` on a batch, without gradients
    (``make_eval_step``; the coarse loss runs with train=True there too);
    inside a group, the global batch's."""
    with torch.no_grad():
        loss, metrics = loss_fn(model, batch, generator)
    return reduce_metrics({"loss": loss, **metrics})
