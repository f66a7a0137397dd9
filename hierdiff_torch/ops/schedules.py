"""Noise schedules: closed-form gamma tables and the learned VDM GammaNetwork.

gamma(t) is the negated VDM log-SNR: sigma^2 = sigmoid(gamma), alpha^2 =
sigmoid(-gamma). (reference: endiffusion/models/noise_model.py)
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor, nn


def clip_noise_schedule(alphas2: np.ndarray, clip_value: float = 0.001) -> np.ndarray:
    """Clip per-step alpha ratios for sampling stability.
    (reference: noise_model.py:21-33)"""
    alphas2 = np.concatenate([np.ones(1), alphas2], axis=0)
    alphas_step = alphas2[1:] / alphas2[:-1]
    alphas_step = np.clip(alphas_step, a_min=clip_value, a_max=1.0)
    return np.cumprod(alphas_step, axis=0)


def polynomial_schedule(timesteps: int, s: float = 1e-4, power: float = 3.0) -> np.ndarray:
    """alpha^2 schedule (1 - x^power)^2 with precision floor.
    (reference: noise_model.py:36-50)"""
    steps = timesteps + 1
    x = np.linspace(0, steps, steps)
    alphas2 = (1 - np.power(x / steps, power)) ** 2
    alphas2 = clip_noise_schedule(alphas2, clip_value=0.001)
    precision = 1 - 2 * s
    return precision * alphas2 + s


def cosine_beta_schedule(timesteps: int, s: float = 0.008, raise_to_power: float = 1.0) -> np.ndarray:
    """Nichol-Dhariwal cosine cumulative alpha^2. (reference: noise_model.py:53-68)"""
    steps = timesteps + 2
    x = np.linspace(0, steps, steps)
    alphas_cumprod = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    betas = np.clip(betas, a_min=0, a_max=0.999)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    if raise_to_power != 1:
        alphas_cumprod = np.power(alphas_cumprod, raise_to_power)
    return alphas_cumprod


def gamma_table(noise_schedule: str, timesteps: int, precision: float = 1e-4) -> np.ndarray:
    """gamma = -(log alpha^2 - log sigma^2) over the T+1 grid points.
    (reference: noise_model.py:125-156)"""
    if noise_schedule == "cosine":
        alphas2 = cosine_beta_schedule(timesteps)
    elif "polynomial" in noise_schedule:
        splits = noise_schedule.split("_")
        if len(splits) != 2:
            raise ValueError(noise_schedule)
        alphas2 = polynomial_schedule(timesteps, s=precision, power=float(splits[1]))
    else:
        raise ValueError(noise_schedule)
    sigmas2 = 1 - alphas2
    return -(np.log(alphas2) - np.log(sigmas2)).astype(np.float32)


class PredefinedNoiseSchedule(nn.Module):
    """Table lookup gamma(t) for t in [0, 1], rounded to the T grid.
    (reference: noise_model.py:125-160)

    The table is a non-persistent buffer: it is rebuilt from the schedule
    name, so state dicts carry only learned weights."""

    def __init__(self, noise_schedule: str, timesteps: int, precision: float = 1e-4):
        super().__init__()
        self.timesteps = timesteps
        self.register_buffer(
            "table", torch.from_numpy(gamma_table(noise_schedule, timesteps, precision)),
            persistent=False)

    def forward(self, t: Tensor) -> Tensor:
        t_int = torch.round(t * self.timesteps).long()
        return self.table[t_int]


class PositiveLinear(nn.Module):
    """Linear layer with softplus-constrained positive weights.
    (reference: noise_model.py:75-105)"""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def forward(self, x: Tensor) -> Tensor:
        return x @ F.softplus(self.weight).t() + self.bias


class GammaNetwork(nn.Module):
    """Learned monotone gamma(t) (VDM), normalized to [gamma_0, gamma_1].
    (reference: noise_model.py:163-200)"""

    def __init__(self):
        super().__init__()
        self.l1 = PositiveLinear(1, 1)
        self.l2 = PositiveLinear(1, 1024)
        self.l3 = PositiveLinear(1024, 1)
        self.gamma_0 = nn.Parameter(torch.tensor([-5.0]))
        self.gamma_1 = nn.Parameter(torch.tensor([10.0]))

    def gamma_tilde(self, t: Tensor) -> Tensor:
        l1_t = self.l1(t)
        return l1_t + self.l3(torch.sigmoid(self.l2(l1_t)))

    def forward(self, t: Tensor) -> Tensor:
        squeeze_out = t.ndim == 1
        if squeeze_out:
            t = t[:, None]
        g0 = self.gamma_tilde(torch.zeros_like(t))
        g1 = self.gamma_tilde(torch.ones_like(t))
        gt = self.gamma_tilde(t)
        normalized = (gt - g0) / (g1 - g0)
        gamma = self.gamma_0 + (self.gamma_1 - self.gamma_0) * normalized
        return gamma[:, 0] if squeeze_out else gamma


# --- gamma-derived algebra (pure functions of gamma values) ---------------


def sigma_from_gamma(gamma: Tensor) -> Tensor:
    """sigma = sqrt(sigmoid(gamma)). (reference: diffusion_qm9.py:148-150)"""
    return torch.sqrt(torch.sigmoid(gamma))


def alpha_from_gamma(gamma: Tensor) -> Tensor:
    """alpha = sqrt(sigmoid(-gamma)). (reference: diffusion_qm9.py:152-154)"""
    return torch.sqrt(torch.sigmoid(-gamma))


def snr(gamma: Tensor) -> Tensor:
    """SNR = alpha^2 / sigma^2 = exp(-gamma). (reference: diffusion_qm9.py:156-158)"""
    return torch.exp(-gamma)


def sigma_and_alpha_t_given_s(gamma_t: Tensor, gamma_s: Tensor):
    """Transition coefficients for q(z_t | z_s), numerically stable form.

    sigma^2_{t|s} = -expm1(softplus(gamma_s) - softplus(gamma_t))
    alpha_{t|s}   = exp(0.5*(logsigmoid(-gamma_t) - logsigmoid(-gamma_s)))
    (reference: diffusion_qm9.py:181-204)"""
    sigma2_t_given_s = -torch.expm1(F.softplus(gamma_s) - F.softplus(gamma_t))
    log_alpha2_t = F.logsigmoid(-gamma_t)
    log_alpha2_s = F.logsigmoid(-gamma_s)
    alpha_t_given_s = torch.exp(0.5 * (log_alpha2_t - log_alpha2_s))
    return sigma2_t_given_s, torch.sqrt(sigma2_t_given_s), alpha_t_given_s


def inflate(array: Tensor, target_ndim: int) -> Tensor:
    """Reshape (B,) or (B,1,...) to broadcast against a (B, ...) target.
    (reference: diffusion_qm9.py:140-146)"""
    return array.reshape(array.shape[0], *([1] * (target_ndim - 1)))
