"""Seeded weights for a model, made by the benchmark on the device.

The benchmark, not the program, makes the weights, and hands the same
tensors to the program (``load_state_dict``) and to the plain reference.
Two large draws on a generator of the device, one uniform and one normal,
are cut into the state dict's tensors and scaled by name, after the
initialisers of the reference architecture: a linear weight and its bias
U(+-1/sqrt(fan_in)); the coordinate heads (``coord_mlp.4``) xavier-uniform
scaled by 0.001; the learned schedule's positive linears shifted by -2 and
its end points gamma_0 = -5, gamma_1 = 10; embeddings N(0, 1/width).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

GAMMA_ENDS = {"gamma.gamma_0": -5.0, "gamma.gamma_1": 10.0}
POSITIVE = ("gamma.l1.", "gamma.l2.", "gamma.l3.")


def _fan_in(shapes: Dict[str, Tuple[int, ...]], name: str) -> int:
    weight = name[: -len("bias")] + "weight" if name.endswith("bias") else name
    shape = shapes[weight]
    return int(shape[1]) if len(shape) > 1 else 1


def make_weights(shapes: Dict[str, Tuple[int, ...]], seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """float32 tensors of ``shapes`` (name -> shape), from ``seed``."""
    sizes = {k: math.prod(s) for k, s in shapes.items()}
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    uniform = torch.rand(sum(sizes.values()), generator=gen, device=device) * 2.0 - 1.0
    normal = torch.randn(sum(sizes.values()), generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = sizes[name]
        u, g = uniform[at: at + n].view(shape), normal[at: at + n].view(shape)
        at += n
        if name in GAMMA_ENDS:
            t = torch.full(shape, GAMMA_ENDS[name], device=device)
        elif name.endswith("embed.weight"):
            t = g / math.sqrt(shape[1])
        elif name.startswith(POSITIVE) and name.endswith("weight"):
            t = u * math.sqrt(3.0 / shape[1]) - 2.0
        elif name.endswith("coord_mlp.4.weight"):
            t = u * 0.001 * math.sqrt(6.0 / (shape[0] + shape[1]))
        else:
            t = u / math.sqrt(_fan_in(shapes, name))
        out[name] = t.contiguous()
    return out


def shapes_of(module: torch.nn.Module) -> Dict[str, Tuple[int, ...]]:
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}
