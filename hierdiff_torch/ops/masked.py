"""Masked-tensor primitives for padded point-cloud batches.

Batches are dense padded tensors ``x`` (B, N, D) with a node mask (B, N, 1).
Coordinates live on the centre-of-mass-free subspace.
(reference: endiffusion/models/utils.py:43-167)
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import Tensor


def sum_except_batch(x: Tensor) -> Tensor:
    """Sum over all axes but the first. (reference: models/utils.py:33-34)"""
    return x.reshape(x.shape[0], -1).sum(dim=-1)


def remove_mean_with_mask(x: Tensor, node_mask: Tensor,
                          fix_size: Optional[int] = None) -> Tensor:
    """Subtract the masked mean over nodes; the result is CoM-free on real
    nodes. ``fix_size`` restricts the mean to the first ``fix_size`` nodes.
    (reference: endiffusion/models/utils.py:43-57)"""
    node_mask = node_mask.to(x.dtype)
    if fix_size is None:
        fix_size = x.shape[1]
    n = node_mask[:, :fix_size].sum(dim=1, keepdim=True)
    mean = (x[:, :fix_size] * node_mask[:, :fix_size]).sum(dim=1, keepdim=True) \
        / torch.clamp(n, min=1.0)
    return (x - mean) * node_mask


def mean_zero_max_violation(x: Tensor, node_mask: Tensor) -> Tensor:
    """Relative deviation of the masked per-batch sum from zero.
    (reference: models/utils.py:65-70, as a value instead of an assert)"""
    x = x * node_mask.to(x.dtype)
    largest = x.abs().max()
    err = x.sum(dim=1).abs().max()
    return err / (largest + 1e-10)


def masking_violation(x: Tensor, node_mask: Tensor) -> Tensor:
    """Max |x| outside the mask. (reference: models/utils.py:73-75)"""
    return (x * (1.0 - node_mask.to(x.dtype))).abs().max()


def combine_noise(raw: Tensor, node_mask: Tensor, n_dims: int) -> Tensor:
    """Standard-normal draws (B, N, n_dims + h_nf) -> CoM-free masked noise
    for the x block and masked iid noise for the h block. Injected draws
    (tests) and the port's own draws go through this same map."""
    node_mask = node_mask.to(raw.dtype)
    z_x = remove_mean_with_mask(raw[:, :, :n_dims] * node_mask, node_mask)
    z_h = raw[:, :, n_dims:] * node_mask
    return torch.cat([z_x, z_h], dim=2)


def sample_combined_noise(generator: torch.Generator, node_mask: Tensor,
                          n_dims: int, h_nf: int) -> Tensor:
    """CoM-free noise for the x block, iid noise for the h block.
    (reference: endiffusion/train_module/diffusion_qm9.py:445-456)"""
    b, n = node_mask.shape[:2]
    raw = torch.randn((b, n, n_dims + h_nf), generator=generator,
                      device=node_mask.device, dtype=torch.float32)
    return combine_noise(raw, node_mask, n_dims)


def cdf_standard_gaussian(x: Tensor) -> Tensor:
    """Phi(x). (reference: models/utils.py:161-162)"""
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def subspace_dimensionality(node_mask: Tensor, n_dims: int) -> Tensor:
    """(N-1)*n_dims per batch element: dims of the CoM-free x subspace.
    (reference: diffusion_qm9.py:160-163)"""
    n = node_mask.to(torch.float32).squeeze(2).sum(dim=1)
    return (n - 1.0) * n_dims


# Log-probability of entries outside a support: finite, so that a row
# selection or a sum over such entries never meets 0 * inf.
NEG_INF = -1e9


def masked_log_softmax(logits: Tensor, support: Tensor, dim: int = -1) -> Tensor:
    """log-softmax restricted to ``support`` (1 = allowed); entries outside
    it get ~NEG_INF. (hierdiff_tpu/ops/masked.py:113)"""
    logits = torch.where(support > 0, logits, torch.full_like(logits, NEG_INF))
    return torch.log_softmax(logits, dim=dim)


def take_rows(t: Tensor, idx: Tensor) -> Tensor:
    """Row selection t[b, idx[b]] for t (B, N, ...) and idx (B,) -> (B, ...),
    with idx clamped into [0, N). A gather, exact like the JAX package's
    one-hot contraction (``onehot_take``)."""
    b, n = t.shape[:2]
    return t[torch.arange(b, device=t.device), idx.clamp(0, n - 1)]


def masked_cross_entropy(logits: Tensor, target: Tensor, support: Tensor) -> Tensor:
    """CE over a restricted support: -log softmax(logits | support)[target].
    logits (B, K), target (B,) int, support (B, K). A row whose support is
    empty gives a finite value (every entry NEG_INF), which callers weight
    by 0. (hierdiff_tpu/ops/masked.py:139; reference: the per-sample
    CrossEntropyLoss over a candidate list, edge_denoise.py:176-224)"""
    return -take_rows(masked_log_softmax(logits, support), target)


def binary_cross_entropy(p: Tensor, label: Tensor, eps: float = 1e-7) -> Tensor:
    """Elementwise BCE on probabilities (the reference's nn.BCELoss on a
    sigmoid head, edge_denoise.py:132). The clip is jnp.clip's
    maximum-then-minimum, whose gradient is halved at an exact tie with a
    bound, as JAX's is; ``torch.clamp`` would pass all of it.
    (hierdiff_tpu/ops/masked.py:150)"""
    lo = torch.full_like(p, eps)
    hi = torch.full_like(p, 1.0 - eps)
    p = torch.minimum(torch.maximum(p, lo), hi)
    return -(label * torch.log(p) + (1.0 - label) * torch.log(1.0 - p))
