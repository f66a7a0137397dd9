"""Coarse-stage ancestral sampler.

Port of ``hierdiff_tpu/sampling/coarse.py:sample_coarse`` and
``sample_coarse_pocket``: gamma is tabulated on the T+1 grid once per chain,
then the reverse steps run as a plain Python loop of
``CoarseDiffusion.sample_zs_stats`` calls, and a final draw from p(x | z_0).
Batches of different molecule sizes run in lockstep through node masks.

Under a profiler (``utils/profiling.py``) a chain records a
``coarse.request`` span around all of it (attrs ``batch``, ``rows`` with
the pocket rows, ``steps``, ``pocket_rows``) and a ``coarse.step`` span
around each reverse step, from its gammas to the CoM projection (attr
``k``, 1-based), holding the step's ``egnn.*`` kernel-wrapper spans.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from hierdiff_torch.models.diffusion import CoarseDiffusion, pocket_edge_mask
from hierdiff_torch.ops.masked import combine_noise, remove_mean_with_mask
from hierdiff_torch.utils.profiling import request_span, span


def make_masks_for_counts(counts: np.ndarray, max_n: Optional[int] = None
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Node mask (B, N, 1) and fully connected, self-loop-free edge mask
    (B, N, N) for a batch of molecule sizes. (reference: diffusion_qm9.py:349-359)"""
    b = len(counts)
    n = int(max_n if max_n is not None else max(counts))
    node_mask = np.zeros((b, n, 1), np.float32)
    edge_mask = np.zeros((b, n, n), np.float32)
    for i, c in enumerate(counts):
        c = int(c)
        node_mask[i, :c] = 1.0
        edge_mask[i, :c, :c] = 1.0 - np.eye(c)
    return node_mask, edge_mask


def coarse_ladder(timesteps: int, steps: Optional[int] = None) -> Tensor:
    """Integer time ladder T = t_0 > t_1 > ... > t_steps = 0 (int64, CPU).

    Reproduces ``jnp.round(jnp.linspace(T, 0, steps + 1))`` of the JAX
    sampler (``hierdiff_tpu/sampling/coarse.py:77``) op for op in float32:
    XLA compiles the linspace to ``T * (1 - i * fl32(1 / steps))`` with the
    endpoint appended, and a correctly rounded ``i / steps`` (or numpy's
    float64 linspace) lands on the other side of a .5 tie at strides such as
    208. Rounding is half to even in both frameworks."""
    T = int(timesteps)
    steps = T if steps is None else min(int(steps), T)
    recip = torch.tensor(1.0, dtype=torch.float32) / steps
    i = torch.arange(steps, dtype=torch.float32)
    values = torch.tensor(float(T), dtype=torch.float32) * (1.0 - i * recip)
    values = torch.cat([values, torch.zeros(1, dtype=torch.float32)])
    return torch.round(values).to(torch.int64)


def sample_coarse(model: CoarseDiffusion, node_mask: Tensor, edge_mask: Tensor,
                  generator: Optional[torch.Generator] = None,
                  steps: Optional[int] = None, packed: bool = False,
                  context: Optional[Tensor] = None,
                  noise: Optional[Union[Tensor, Sequence[Tensor]]] = None):
    """Draw (x, h) ~ p(x, h) for a batch of masked point clouds.

    node_mask (B, N, 1) and edge_mask (B, N, N) lie on the model's device.
    Returns x (B, N, 3) CoM-free coordinates and h (B, N, h_nf) blur
    features, unnormalized and zero outside the mask, or one (B, N, 3 + h_nf)
    tensor with ``packed``. ``steps`` strides the reverse chain along
    ``coarse_ladder``. (reference: diffusion_qm9.py:348-395)

    Noise: standard-normal draws of shape (B, N, 3 + h_nf) from
    ``generator``, or, if ``noise`` is given, ``noise[0]`` for z_T,
    ``noise[k]`` for reverse step k (1-based) and ``noise[steps + 1]`` for
    the final x draw. Each draw is masked and its x block made CoM-free.
    """
    node_mask = node_mask.to(torch.float32)
    edge_mask = edge_mask.to(torch.float32)

    def step_stats(z, gamma_s, gamma_t, t_b):
        return model.sample_zs_stats(z, gamma_s, gamma_t, node_mask, edge_mask, t_b, context)

    return _chain(model, node_mask, edge_mask, step_stats, generator, steps, packed, context,
                  noise, "sample_coarse")


def sample_coarse_pocket(model: CoarseDiffusion, node_mask: Tensor, edge_mask: Tensor,
                         protein_feat: Tensor, protein_pos: Tensor, protein_node_mask: Tensor,
                         protein_edge_mask: Tensor, generator: Optional[torch.Generator] = None,
                         steps: Optional[int] = None, packed: bool = False,
                         noise: Optional[Union[Tensor, Sequence[Tensor]]] = None):
    """Pocket-conditioned sampling: the molecule rows diffuse, the pocket
    rows (tokens ``protein_feat`` (B, K), positions ``protein_pos`` (B, K,
    3), masks (B, K, 1) and (B, K, K)) are frozen context appended after
    them at every reverse step, embedded once per call. Returns the
    molecule rows only, as ``sample_coarse`` does, with the same noise
    contract over the molecule rows ((B, n_mol, 3 + h_nf) draws). The final
    p(x | z_0) runs on the molecule rows alone, with the molecule-only mask
    and no pocket, as in the JAX package. (reference: diffusion_qm9.py:361-384;
    hierdiff_tpu/sampling/coarse.py:268-336)"""
    node_mask = node_mask.to(torch.float32)
    edge_mask = edge_mask.to(torch.float32)
    n_mol = node_mask.shape[1]
    pmask = protein_node_mask.to(torch.float32)
    with torch.no_grad():
        pocket_xh = torch.cat([protein_pos.to(torch.float32),
                               model.pocket_embed(protein_feat.long())], dim=2)
    nm_cat = torch.cat([node_mask, pmask], dim=1)
    em_cat = pocket_edge_mask(node_mask, edge_mask, pmask, protein_edge_mask.to(torch.float32),
                              model.pocket_cross_edges)

    def step_stats(z, gamma_s, gamma_t, t_b):
        return model.sample_zs_stats(torch.cat([z, pocket_xh], dim=1), gamma_s, gamma_t,
                                     nm_cat, em_cat, t_b, None, mol_shape=n_mol)

    return _chain(model, node_mask, edge_mask, step_stats, generator, steps, packed, None,
                  noise, "sample_coarse_pocket", pocket_rows=protein_pos.shape[1])


def _chain(model: CoarseDiffusion, node_mask: Tensor, edge_mask: Tensor, step_stats,
           generator: Optional[torch.Generator], steps: Optional[int], packed: bool,
           context: Optional[Tensor], noise, name: str, pocket_rows: int = 0):
    """The reverse chain over the molecule rows: ``step_stats(z, gamma_s,
    gamma_t, t)`` gives mu and sigma of p(z_s | z_t) for each step of
    ``coarse_ladder``; then the draw from p(x | z_0) on the molecule rows.
    ``pocket_rows``, the frozen rows ``step_stats`` appends, only describes
    the request's span."""
    if noise is None and generator is None:
        raise ValueError(f"{name} needs a generator or injected noise")
    b, n = node_mask.shape[:2]
    nd, nf = model.n_dims, model.in_node_nf
    T = model.timesteps
    ladder = coarse_ladder(T, steps)
    n_steps = len(ladder) - 1

    def draw(k: int) -> Tensor:
        if noise is not None:
            raw = torch.as_tensor(noise[k], dtype=torch.float32, device=node_mask.device)
        else:
            raw = torch.randn((b, n, nd + nf), generator=generator,
                              device=node_mask.device, dtype=torch.float32)
        return combine_noise(raw, node_mask, nd)

    with request_span("coarse.request", batch=b, rows=n + pocket_rows, steps=n_steps,
                      pocket_rows=pocket_rows), torch.no_grad():
        gamma_grid = model.gamma_grid()
        t_norm = (ladder.to(torch.float32) / T).to(node_mask.device)
        z = draw(0)
        for k, (t_int, s_int) in enumerate(zip(ladder[:-1].tolist(), ladder[1:].tolist()), 1):
            with span("coarse.step", k=k):
                gamma_s = gamma_grid[s_int].expand(b, 1)
                gamma_t = gamma_grid[t_int].expand(b, 1)
                t_b = t_norm[k - 1].expand(b, 1)
                mu, sigma = step_stats(z, gamma_s, gamma_t, t_b)
                z_new = mu + sigma * draw(k)
                # re-project x to the CoM-free subspace every step
                # (reference: diffusion_qm9.py:340-344)
                zx = remove_mean_with_mask(z_new[:, :, :nd], node_mask)
                z = torch.cat([zx, z_new[:, :, nd:]], dim=2)

        mu_x, sigma_x = model.sample_x_given_z0_stats(z, node_mask, edge_mask, context)
        xh = mu_x + sigma_x * draw(n_steps + 1)
        x = xh[:, :, :nd]
        h = z[:, :, nd:]    # h taken from z_0 (reference: diffusion_qm9.py:308)
        x, h = model.unnormalize(x, h, node_mask)
    if packed:
        return torch.cat([x, h], dim=-1)
    return x, h
