"""Coarse-stage E(3)-equivariant denoising diffusion (VDM-style EDM).

Port of ``hierdiff_tpu/models/diffusion.py:CoarseDiffusion`` (reference
endiffusion/train_module/diffusion_qm9.py): the schedule, the network, the
normalization, the training loss (KL prior, SNR-weighted eps error, the t=0
discretized likelihood; the sampled-t estimator and the two-pass
``t0_always`` one) and the two reverse-process kernels the sampler needs.

Like the JAX package it keeps one deliberate fix against the reference
(PARITY.md divergence #1): the continuous-h slice of the t=0 likelihood is
``net_out[..., n_dims+int_nf : n_dims+int_nf+cont_nf]``, the intended term,
not the stray-colon ``net_out[..., 0:8:11]`` of ``diffusion_qm9.py:477``.

Randomness comes from an explicit ``torch.Generator``; ``t_int``, ``eps`` and
``eps0`` can be injected instead (tests hold the loss to the JAX model on the
same draws, since JAX's threefry stream cannot be reproduced here).

The pocket-conditioned (CrossDocked) variant (``pocket=True``) appends frozen
pocket rows after the molecule rows: residue tokens embedded by
``pocket_embed``, C-alpha positions, and an edge mask of the molecule block,
the pocket block and, with ``pocket_cross_edges``, the molecule<->pocket
blocks (the reference's block-diagonal mask leaves the conditioning inert;
``pocket_cross_edges=False`` reproduces it). Noise and loss cover the
molecule rows only (``mol_shape``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import Tensor, nn

from hierdiff_torch.models.dynamics import EGNNDynamics
from hierdiff_torch.ops.losses import gaussian_kl, gaussian_kl_for_dimension
from hierdiff_torch.ops.masked import (
    cdf_standard_gaussian,
    remove_mean_with_mask,
    sample_combined_noise,
    subspace_dimensionality,
    sum_except_batch,
)
from hierdiff_torch.ops.schedules import (
    GammaNetwork,
    PredefinedNoiseSchedule,
    alpha_from_gamma,
    inflate,
    sigma_and_alpha_t_given_s,
    sigma_from_gamma,
    snr,
)


def pocket_edge_mask(node_mask: Tensor, edge_mask: Tensor, pocket_mask: Tensor,
                     protein_edge_mask: Tensor, cross_edges: bool) -> Tensor:
    """The (B, n_mol+K, n_mol+K) edge mask of molecule rows followed by the
    pocket's: the molecule block, the pocket block and, with
    ``cross_edges``, every molecule node to every pocket node and back.
    (reference: diffusion_qm9.py:369-371, 714-719;
    hierdiff_tpu/models/diffusion.py:382-400)"""
    b, n_mol = node_mask.shape[:2]
    n_tot = n_mol + pocket_mask.shape[1]
    if edge_mask.ndim == 4:
        edge_mask = edge_mask[..., 0]
    em = node_mask.new_zeros((b, n_tot, n_tot))
    em[:, :n_mol, :n_mol] = edge_mask
    em[:, n_mol:, n_mol:] = protein_edge_mask
    if cross_edges:
        cross = node_mask[:, :, 0, None] * pocket_mask[:, None, :, 0]
        em[:, :n_mol, n_mol:] = cross
        em[:, n_mol:, :n_mol] = cross.transpose(1, 2)
    return em


class CoarseDiffusion(nn.Module):
    """EDM over fragment centres: x in R^3 (CoM-free) + h blur features.

    Module names follow the reference DiffusionQM9 (``gamma.*``,
    ``dynamics.egnn.*``), so its state dict loads with ``strict=True``.
    ``remat`` / ``remat_edges`` are the EGNN's memory switches of training
    (``ops/egnn.py``); ``gnn_dynamics`` ignores them, as the JAX package does."""

    def __init__(self, in_node_nf: int = 8, n_dims: int = 3, timesteps: int = 1000,
                 loss_type: str = "vlb", noise_schedule: str = "learned",
                 noise_precision: float = 1e-4,
                 norm_values: Tuple[float, float, float] = (1.0, 1.0, 1.0),
                 norm_biases: Tuple[float, float, float] = (0.0, 0.0, 0.0),
                 hidden_nf: int = 256, n_layers: int = 6, inv_sublayers: int = 2,
                 attention: bool = True, tanh: bool = True, coords_range: float = 30.0,
                 norm_constant: float = 0.0, normalization_factor: float = 10.0,
                 aggregation_method: str = "sum", condition_time: bool = True,
                 context_node_nf: int = 0, compute_dtype=None,
                 mode: str = "egnn_dynamics", sin_embedding: bool = False,
                 int_nf: int = 5, cont_nf: int = 3, pocket: bool = False,
                 pocket_cross_edges: bool = True, remat: bool = False,
                 remat_edges: bool = False):
        super().__init__()
        self.in_node_nf = in_node_nf
        self.n_dims = n_dims
        self.timesteps = timesteps
        self.loss_type = loss_type
        self.int_nf = int_nf
        self.cont_nf = cont_nf
        self.context_node_nf = context_node_nf
        self.norm_values = tuple(norm_values)
        self.norm_biases = tuple(norm_biases)
        self.pocket = pocket
        self.pocket_cross_edges = pocket_cross_edges
        if pocket:
            # 21 tokens: padding 0 + 20 residue types (reference: diffusion_qm9.py:55-56)
            self.pocket_embed = nn.Embedding(21, in_node_nf)
        if noise_schedule == "learned":
            if loss_type != "vlb":
                raise ValueError("the learned noise schedule needs loss_type='vlb'")
            self.gamma = GammaNetwork()
        else:
            self.gamma = PredefinedNoiseSchedule(noise_schedule, timesteps, noise_precision)
        self.dynamics = EGNNDynamics(
            in_node_nf=in_node_nf, context_node_nf=context_node_nf, n_dims=n_dims,
            hidden_nf=hidden_nf, n_layers=n_layers, inv_sublayers=inv_sublayers,
            attention=attention, tanh=tanh, coords_range=coords_range,
            norm_constant=norm_constant, normalization_factor=normalization_factor,
            aggregation_method=aggregation_method, condition_time=condition_time,
            compute_dtype=compute_dtype, mode=mode, sin_embedding=sin_embedding,
            remat=remat, remat_edges=remat_edges)

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

    # --- loss terms --------------------------------------------------------

    def kl_prior(self, xh: Tensor, node_mask: Tensor) -> Tensor:
        """KL(q(z_T|x) || N(0,I)); near zero for a sane schedule.
        (reference: diffusion_qm9.py:206-234)"""
        b = xh.shape[0]
        gamma_T = self.gamma_of(xh.new_ones((b, 1)))
        alpha_T = inflate(alpha_from_gamma(gamma_T), xh.ndim)
        mu_T = alpha_T * xh
        mu_T_x, mu_T_h = mu_T[:, :, : self.n_dims], mu_T[:, :, self.n_dims:]
        sigma_T = sigma_from_gamma(gamma_T)          # (B, 1)
        sigma_T_x = sigma_T.reshape(b)               # per-batch scalar for x
        sigma_T_h = inflate(sigma_T, mu_T_h.ndim)
        kl_h = gaussian_kl(mu_T_h, sigma_T_h.expand_as(mu_T_h), torch.zeros_like(mu_T_h),
                           torch.ones_like(mu_T_h), node_mask)
        d = subspace_dimensionality(node_mask, self.n_dims)
        kl_x = gaussian_kl_for_dimension(mu_T_x, sigma_T_x, torch.zeros_like(mu_T_x),
                                         xh.new_ones(b), d=d)
        return kl_x + kl_h

    def compute_error(self, net_out: Tensor, eps: Tensor, train: bool) -> Tensor:
        """Sum-of-squares eps error; l2 training divides by dims.
        (reference: diffusion_qm9.py:250-258)"""
        error = sum_except_batch((eps - net_out) ** 2)
        if train and self.loss_type == "l2":
            error = error / ((self.n_dims + self.in_node_nf) * net_out.shape[1])
        return error

    def _gamma_0(self, node_mask: Tensor) -> Tensor:
        return self.gamma_of(node_mask.new_zeros((node_mask.shape[0], 1), dtype=torch.float32))

    def log_constants_p_x_given_z0(self, node_mask: Tensor) -> Tensor:
        """(reference: diffusion_qm9.py:260-274)"""
        n = node_mask.to(torch.float32).squeeze(2).sum(dim=1)
        log_sigma_x = 0.5 * self._gamma_0(node_mask).reshape(-1)
        return (n - 1.0) * self.n_dims * (-log_sigma_x - 0.5 * math.log(2 * math.pi))

    def log_constants_p_h_given_z0(self, node_mask: Tensor) -> Tensor:
        """(reference: diffusion_qm9.py:276-290)"""
        n = node_mask.to(torch.float32).squeeze(2).sum(dim=1)
        log_sigma_h = 0.5 * self._gamma_0(node_mask).reshape(-1)
        return n * self.in_node_nf * (-log_sigma_h - 0.5 * math.log(2 * math.pi))

    def log_pxh_given_z0_without_constants(
        self, h: Tensor, z_t: Tensor, gamma_0: Tensor, eps: Tensor, net_out: Tensor,
        node_mask: Tensor, epsilon: float = 1e-10, train: bool = False,
    ) -> Tensor:
        """t=0 reconstruction term: Gaussian on x and continuous h, discretized
        Gaussian CDF on integer h dims. (reference: diffusion_qm9.py:460-525,
        with the continuous-h slice fixed, PARITY.md #1)"""
        nd, inf, cnf = self.n_dims, self.int_nf, self.cont_nf
        z_h_int = z_t[:, :, nd: nd + inf]
        eps_x, net_x = eps[:, :, :nd], net_out[:, :, :nd]
        eps_h = eps[:, :, nd + inf: nd + inf + cnf]
        net_h = net_out[:, :, nd + inf: nd + inf + cnf]

        sigma_0 = inflate(sigma_from_gamma(gamma_0), z_t.ndim)
        sigma_0_int = sigma_0 * self.norm_values[2]

        log_p_x = -0.5 * self.compute_error(net_x, eps_x, train)
        log_p_h_cont = -0.5 * self.compute_error(net_h, eps_h, train)

        h_integer = torch.round(h[:, :, :inf] * self.norm_values[2] + self.norm_biases[2])
        estimated = z_h_int * self.norm_values[2] + self.norm_biases[2]
        centered = h_integer - estimated
        log_ph_integer = torch.log(
            cdf_standard_gaussian((centered + 0.5) / sigma_0_int)
            - cdf_standard_gaussian((centered - 0.5) / sigma_0_int)
            + epsilon)
        log_ph_integer = sum_except_batch(log_ph_integer * node_mask.to(log_ph_integer.dtype))
        return log_p_x + log_p_h_cont + log_ph_integer

    # --- main estimators ---------------------------------------------------

    def compute_loss(self, generator: Optional[torch.Generator], x: Tensor, h: Tensor,
                     node_mask: Tensor, edge_mask: Tensor, context: Optional[Tensor],
                     t0_always: bool, train: bool, mol_shape: Optional[int] = None,
                     t_int: Optional[Tensor] = None, eps: Optional[Tensor] = None,
                     eps0: Optional[Tensor] = None) -> Tuple[Tensor, Dict[str, Tensor]]:
        """VLB / l2 estimator; ``mol_shape`` freezes the rows past it (the
        pocket): they enter the network as they are, and noise and loss
        cover the first ``mol_shape`` rows. ``t_int`` (B, 1), ``eps`` and
        ``eps0`` (B, mol rows, n_dims + in_node_nf, already CoM-free and
        masked) override the draws from ``generator``: t first, then eps,
        then eps0. (reference: diffusion_qm9.py:530-673)"""
        b = x.shape[0]
        lowest_t = 1 if t0_always else 0
        if t_int is None:
            t_int = torch.randint(lowest_t, self.timesteps + 1, (b, 1), generator=generator,
                                  device=x.device)
        t_int = t_int.to(device=x.device, dtype=torch.float32)
        s_int = t_int - 1
        t_is_zero = (t_int == 0).to(torch.float32)
        s = s_int / self.timesteps
        t = t_int / self.timesteps

        # split off the frozen pocket rows (reference: diffusion_qm9.py:553-557)
        full_node_mask, full_edge_mask = node_mask, edge_mask
        xh_fix = None
        if mol_shape is not None:
            xh_fix = torch.cat([x[:, mol_shape:], h[:, mol_shape:]], dim=2)
            x, h = x[:, :mol_shape], h[:, :mol_shape]
            node_mask = full_node_mask[:, :mol_shape]

        def phi(z: Tensor, t_: Tensor) -> Tensor:
            if xh_fix is None:
                return self.phi(z, t_, node_mask, edge_mask, context)
            out = self.phi(torch.cat([z, xh_fix], dim=1), t_, full_node_mask, full_edge_mask,
                           context, mol_shape=mol_shape)
            return out[:, :mol_shape]

        gamma_s = self.gamma_of(s)
        gamma_t = self.gamma_of(t)
        alpha_t = inflate(alpha_from_gamma(gamma_t), x.ndim)
        sigma_t = inflate(sigma_from_gamma(gamma_t), x.ndim)

        if eps is None:
            eps = sample_combined_noise(generator, node_mask, self.n_dims, self.in_node_nf)
        xh = torch.cat([x, h], dim=2)
        z_t = alpha_t * xh + sigma_t * eps
        net_out = phi(z_t, t)
        error = self.compute_error(net_out, eps, train)

        l2 = train and self.loss_type == "l2"
        snr_weight = torch.ones_like(error) if l2 else (snr(gamma_s - gamma_t) - 1.0).reshape(b)
        loss_t_larger_than_zero = 0.5 * snr_weight * error

        neg_log_constants = -self.log_constants_p_x_given_z0(node_mask)
        neg_log_constants = neg_log_constants - self.log_constants_p_h_given_z0(node_mask)
        if l2:
            neg_log_constants = torch.zeros_like(neg_log_constants)

        kl_prior = self.kl_prior(xh, node_mask)

        if t0_always:
            estimator_loss_terms = self.timesteps * loss_t_larger_than_zero
            t_zeros = torch.zeros_like(s)
            gamma_0 = self.gamma_of(t_zeros)
            alpha_0 = inflate(alpha_from_gamma(gamma_0), x.ndim)
            sigma_0 = inflate(sigma_from_gamma(gamma_0), x.ndim)
            if eps0 is None:
                eps0 = sample_combined_noise(generator, node_mask, self.n_dims, self.in_node_nf)
            z_0 = alpha_0 * xh + sigma_0 * eps0
            net_out0 = phi(z_0, t_zeros)
            loss_term_0 = -self.log_pxh_given_z0_without_constants(
                h, z_0, gamma_0, eps0, net_out0, node_mask, train=train)
            loss = kl_prior + estimator_loss_terms + neg_log_constants + loss_term_0
        else:
            loss_term_0 = -self.log_pxh_given_z0_without_constants(
                h, z_t, gamma_t, eps, net_out, node_mask, train=train)
            t_is_not_zero = 1.0 - t_is_zero
            loss_t = (loss_term_0 * t_is_zero.squeeze(-1)
                      + t_is_not_zero.squeeze(-1) * loss_t_larger_than_zero)
            estimator_loss_terms = loss_t if l2 else (self.timesteps + 1) * loss_t
            loss = kl_prior + estimator_loss_terms + neg_log_constants
        return loss, {"t": t_int.squeeze(-1), "error": error}

    def nll(self, generator: Optional[torch.Generator], x: Tensor, h: Tensor,
            node_mask: Tensor, edge_mask: Tensor, context: Optional[Tensor] = None,
            train: bool = True, mol_shape: Optional[int] = None,
            **draws) -> Tuple[Tensor, Dict[str, Tensor]]:
        """Normalized NLL (training: 1-pass estimator; eval: t0_always); only
        the molecule rows are normalized. ``draws`` are ``compute_loss``'s
        injectable t_int / eps / eps0. (reference: diffusion_qm9.py:675-699)"""
        if mol_shape is None:
            x, h, delta_log_px = self.normalize(x, h, node_mask)
        else:
            x_n, h_n, delta_log_px = self.normalize(x[:, :mol_shape], h[:, :mol_shape],
                                                    node_mask[:, :mol_shape])
            x = torch.cat([x_n, x[:, mol_shape:]], dim=1)
            h = torch.cat([h_n, h[:, mol_shape:]], dim=1)
        if train and self.loss_type == "l2":
            delta_log_px = torch.zeros_like(delta_log_px)
        loss, info = self.compute_loss(generator, x, h, node_mask, edge_mask, context,
                                       t0_always=not train, train=train, mol_shape=mol_shape,
                                       **draws)
        return loss - delta_log_px, info

    def forward(self, batch: Dict[str, Any], generator: Optional[torch.Generator] = None,
                train: bool = True, **draws) -> Dict[str, Tensor]:
        """Batch loss, mirroring the reference forward: positions (B,N,3),
        node_feature (B,N,h_nf), atom_mask (B,N,1), edge_mask (B,N,N) or
        (B,N,N,1), optional context; with ``pocket`` also protein_pos (B,K,3),
        protein_feat (B,K) tokens, protein_feat_mask (B,K,1) and
        protein_edge_mask (B,K,K). Returns loss (the batch mean), nll (B,),
        t (B,) and error (B,). (reference: diffusion_qm9.py:701-751)"""
        x = batch["positions"]
        node_mask = batch["atom_mask"].to(x.dtype)
        edge_mask = batch["edge_mask"]
        h = batch["node_feature"]
        if h.shape[-1] != self.in_node_nf:
            raise ValueError(f"node_feature has {h.shape[-1]} channels but model was built "
                             f"with in_node_nf={self.in_node_nf}")
        context = batch.get("context") if self.context_node_nf > 0 else None
        mol_shape = None
        if self.pocket:
            # frozen pocket rows after the molecule rows (reference: diffusion_qm9.py:701-726)
            mol_shape = x.shape[1]
            pmask = batch["protein_feat_mask"].to(x.dtype)
            edge_mask = pocket_edge_mask(node_mask, edge_mask, pmask,
                                         batch["protein_edge_mask"], self.pocket_cross_edges)
            x = torch.cat([x, batch["protein_pos"].to(x.dtype)], dim=1)
            h = torch.cat([h, self.pocket_embed(batch["protein_feat"].long())], dim=1)
            node_mask = torch.cat([node_mask, pmask], dim=1)
        # the molecule's mean is taken off the pocket rows too
        x = remove_mean_with_mask(x, node_mask, fix_size=mol_shape)
        nll, info = self.nll(generator, x, h, node_mask, edge_mask, context,
                             train=train, mol_shape=mol_shape, **draws)
        return {"loss": nll.mean(), "nll": nll, **info}

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
