"""Coarse-stage E(3)-equivariant denoising diffusion, sampling half.

Port of ``hierdiff_tpu/models/diffusion.py:CoarseDiffusion`` (reference
endiffusion/train_module/diffusion_qm9.py): the schedule, the network, the
normalization and the two reverse-process kernels the sampler needs. The loss
side (``compute_loss``, ``kl_prior``, ``nll``) belongs to the training slice.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import Tensor, nn

from hierdiff_torch.models.dynamics import EGNNDynamics
from hierdiff_torch.ops.masked import remove_mean_with_mask, subspace_dimensionality
from hierdiff_torch.ops.schedules import (
    GammaNetwork,
    PredefinedNoiseSchedule,
    alpha_from_gamma,
    inflate,
    sigma_and_alpha_t_given_s,
    sigma_from_gamma,
    snr,
)


class CoarseDiffusion(nn.Module):
    """EDM over fragment centres: x in R^3 (CoM-free) + h blur features.

    Module names follow the reference DiffusionQM9 (``gamma.*``,
    ``dynamics.egnn.*``), so its state dict loads with ``strict=True``."""

    def __init__(self, in_node_nf: int = 8, n_dims: int = 3, timesteps: int = 1000,
                 noise_schedule: str = "learned", noise_precision: float = 1e-4,
                 norm_values: Tuple[float, float, float] = (1.0, 1.0, 1.0),
                 norm_biases: Tuple[float, float, float] = (0.0, 0.0, 0.0),
                 hidden_nf: int = 256, n_layers: int = 6, inv_sublayers: int = 2,
                 attention: bool = True, tanh: bool = True, coords_range: float = 30.0,
                 norm_constant: float = 0.0, normalization_factor: float = 10.0,
                 aggregation_method: str = "sum", condition_time: bool = True,
                 context_node_nf: int = 0, compute_dtype=None,
                 mode: str = "egnn_dynamics", sin_embedding: bool = False):
        super().__init__()
        self.in_node_nf = in_node_nf
        self.n_dims = n_dims
        self.timesteps = timesteps
        self.norm_values = tuple(norm_values)
        self.norm_biases = tuple(norm_biases)
        if noise_schedule == "learned":
            self.gamma = GammaNetwork()
        else:
            self.gamma = PredefinedNoiseSchedule(noise_schedule, timesteps, noise_precision)
        self.dynamics = EGNNDynamics(
            in_node_nf=in_node_nf, context_node_nf=context_node_nf, n_dims=n_dims,
            hidden_nf=hidden_nf, n_layers=n_layers, inv_sublayers=inv_sublayers,
            attention=attention, tanh=tanh, coords_range=coords_range,
            norm_constant=norm_constant, normalization_factor=normalization_factor,
            aggregation_method=aggregation_method, condition_time=condition_time,
            compute_dtype=compute_dtype, mode=mode, sin_embedding=sin_embedding)

    # --- schedule access ---------------------------------------------------

    def gamma_of(self, t: Tensor) -> Tensor:
        """gamma at normalized times t in [0, 1]; output shape = t.shape."""
        return self.gamma(t)

    def gamma_grid(self) -> Tensor:
        """gamma at the T+1 grid points t = i/T, computed once per chain."""
        device = next(self.dynamics.parameters()).device
        ts = torch.arange(self.timesteps + 1, dtype=torch.float32, device=device) / self.timesteps
        return self.gamma(ts[:, None])[:, 0]

    # --- network -----------------------------------------------------------

    def phi(self, xh: Tensor, t: Tensor, node_mask: Tensor, edge_mask: Tensor,
            context: Optional[Tensor] = None, mol_shape: Optional[int] = None) -> Tensor:
        return self.dynamics(t, xh, node_mask, edge_mask, context, mol_shape)

    # --- normalization -----------------------------------------------------

    def normalize(self, x: Tensor, h: Tensor, node_mask: Tensor):
        """(reference: diffusion_qm9.py:165-172)"""
        x = x / self.norm_values[0]
        delta_log_px = -subspace_dimensionality(node_mask, self.n_dims) * math.log(self.norm_values[0])
        h = (h - self.norm_biases[1]) / self.norm_values[1] * node_mask.to(h.dtype)
        return x, h, delta_log_px

    def unnormalize(self, x: Tensor, h: Tensor, node_mask: Tensor):
        """(reference: diffusion_qm9.py:174-179)"""
        x = x * self.norm_values[0]
        h = (h * self.norm_values[1] + self.norm_biases[1]) * node_mask.to(h.dtype)
        return x, h

    # --- reverse-process kernels -------------------------------------------

    def sample_zs_stats(self, z_t: Tensor, gamma_s: Tensor, gamma_t: Tensor,
                        node_mask: Tensor, edge_mask: Tensor, t: Tensor,
                        context: Optional[Tensor] = None, mol_shape: Optional[int] = None):
        """mu and sigma of p(z_s | z_t). (reference: diffusion_qm9.py:312-337)"""
        sigma2_ts, sigma_ts, alpha_ts = sigma_and_alpha_t_given_s(gamma_t, gamma_s)
        sigma2_ts = inflate(sigma2_ts, z_t.ndim)
        sigma_ts = inflate(sigma_ts, z_t.ndim)
        alpha_ts = inflate(alpha_ts, z_t.ndim)
        sigma_s = inflate(sigma_from_gamma(gamma_s), z_t.ndim)
        sigma_t = inflate(sigma_from_gamma(gamma_t), z_t.ndim)

        eps_t = self.phi(z_t, t, node_mask, edge_mask, context, mol_shape)
        if mol_shape is not None:
            # slice to molecule rows BEFORE the CoM projection
            # (reference: diffusion_qm9.py:324-331)
            eps_t = eps_t[:, :mol_shape]
            z_t = z_t[:, :mol_shape]
            node_mask = node_mask[:, :mol_shape]
        eps_x = remove_mean_with_mask(eps_t[:, :, : self.n_dims], node_mask)
        eps_t = torch.cat([eps_x, eps_t[:, :, self.n_dims:]], dim=2)
        mu = z_t / alpha_ts - (sigma2_ts / alpha_ts / sigma_t) * eps_t
        sigma = sigma_ts * sigma_s / sigma_t
        return mu, sigma

    def sample_x_given_z0_stats(self, z0: Tensor, node_mask: Tensor, edge_mask: Tensor,
                                context: Optional[Tensor] = None):
        """mu and sigma of p(x | z_0). (reference: diffusion_qm9.py:294-310)"""
        zeros = z0.new_zeros((z0.shape[0], 1))
        gamma_0 = self.gamma_of(zeros)
        sigma_x = inflate(snr(-0.5 * gamma_0), z0.ndim)
        net_out = self.phi(z0, zeros, node_mask, edge_mask, context)
        sigma_0 = inflate(sigma_from_gamma(gamma_0), z0.ndim)
        alpha_0 = inflate(alpha_from_gamma(gamma_0), z0.ndim)
        mu_x = (z0 - sigma_0 * net_out) / alpha_0
        return mu_x, sigma_x
