"""Gaussian KL / entropy losses for the masked diffusion VLB.

Port of ``hierdiff_tpu/ops/losses.py`` (reference: endiffusion/loss/criterion.py).
"""

from __future__ import annotations

import math

import torch
from torch import Tensor

from hierdiff_torch.ops.masked import sum_except_batch


def gaussian_entropy(mu: Tensor, sigma: Tensor) -> Tensor:
    """Entropy of N(mu, sigma^2), summed over non-batch dims.
    (reference: criterion.py:9-14)"""
    zeros = torch.zeros_like(mu)
    return sum_except_batch(zeros + 0.5 * torch.log(2 * math.pi * sigma ** 2) + 0.5)


def gaussian_kl(q_mu: Tensor, q_sigma: Tensor, p_mu: Tensor, p_sigma: Tensor,
                node_mask: Tensor) -> Tensor:
    """KL(q || p) between diagonal Gaussians, masked and summed per batch.
    (reference: criterion.py:16-33)"""
    kl = torch.log(p_sigma / q_sigma) + 0.5 * (q_sigma ** 2 + (q_mu - p_mu) ** 2) / (p_sigma ** 2) - 0.5
    return sum_except_batch(kl * node_mask.to(kl.dtype))


def gaussian_kl_for_dimension(q_mu: Tensor, q_sigma: Tensor, p_mu: Tensor, p_sigma: Tensor,
                              d: Tensor) -> Tensor:
    """KL between isotropic Gaussians on a d-dimensional subspace; ``q_sigma``
    and ``p_sigma`` are per-batch scalars (B,), ``d`` the subspace dimension
    per batch element. (reference: criterion.py:36-50)"""
    mu_norm2 = sum_except_batch((q_mu - p_mu) ** 2)
    return d * torch.log(p_sigma / q_sigma) + 0.5 * (d * q_sigma ** 2 + mu_norm2) / (p_sigma ** 2) - 0.5 * d
