"""Plain PyTorch reference of HierDiff's coarse model (EDM over fragment
centres with an EGNN, VDM's learned noise schedule).

Written from the published model (HierDiff, ICML 2023: endiffusion's
``diffusion_qm9.py``, ``en_dynamics.py``, ``egnn_new.py`` and
``noise_model.py``) as dense masked tensors: every pair linear is the
concatenation ``[h_i, h_j, e_ij] @ W^T`` over all (i, j), every sum a plain
masked sum. It imports nothing of the program under test and takes only a
state dict (name -> tensor, the reference's names) that the benchmark made.

The arithmetic is float32, with TF32 off (the caller turns it off). With
``bf16_products`` the products of the EGNN's edge, attention, node and
coordinate MLPs take operands rounded to bfloat16, accumulated in float32:
the configuration's float32 as the card runs it, and as the JAX package
ran it at the TPU's default matmul precision. The schedule and the
reverse step take a ``dtype`` for the control of their arithmetic.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import Tensor

def _bf16(t: Tensor) -> Tensor:
    """``t`` rounded to bfloat16, back in float32."""
    return t.to(torch.bfloat16).float()


class Params:
    """The state dict in float32: ``w(name)`` casts once, ``w(name, True)``
    rounds to bfloat16 once."""

    def __init__(self, sd: Dict[str, Tensor], bf16_products: bool = False):
        self.sd = sd
        self.bf16_products = bf16_products
        self.dtype = torch.float32
        self._cache: Dict[tuple, Tensor] = {}

    def w(self, name: str, rounded: bool = False) -> Tensor:
        t = self._cache.get((name, rounded))
        if t is None:
            t = self.sd[name].float()
            t = _bf16(t) if rounded else t
            self._cache[(name, rounded)] = t
        return t

    def linear(self, x: Tensor, name: str, bias: bool = True, block: bool = False) -> Tensor:
        """x W^T + b; in an EGNN block (``block``) with ``bf16_products``,
        x and W rounded to bfloat16 first."""
        rounded = block and self.bf16_products
        out = (_bf16(x) if rounded else x) @ self.w(name + ".weight", rounded).t()
        return out + self.w(name + ".bias") if bias else out


# --- the learned noise schedule (noise_model.py GammaNetwork) ---------------


def gamma(sd: Dict[str, Tensor], t: Tensor, dtype: torch.dtype = torch.float32) -> Tensor:
    """gamma(t) for normalized times ``t`` (any shape): a monotone network
    of softplus-positive linears, rescaled so that gamma(0) and gamma(1) are
    the learned end points. Computed in ``dtype``, returned in float32."""
    def pos(x, name):
        return x @ F.softplus(sd[name + ".weight"].to(dtype)).t() + sd[name + ".bias"].to(dtype)

    def tilde(x):
        l1 = pos(x, "gamma.l1")
        return l1 + pos(torch.sigmoid(pos(l1, "gamma.l2")), "gamma.l3")

    flat = t.reshape(-1, 1).to(dtype)
    g0 = tilde(torch.zeros_like(flat))
    g1 = tilde(torch.ones_like(flat))
    frac = (tilde(flat) - g0) / (g1 - g0)
    lo, hi = sd["gamma.gamma_0"].to(dtype), sd["gamma.gamma_1"].to(dtype)
    return (lo + (hi - lo) * frac).reshape(t.shape).float()


# --- masked helpers ----------------------------------------------------------


def center(x: Tensor, node_mask: Tensor) -> Tensor:
    """x minus its mean over the real rows, zero on padded rows."""
    n = node_mask.sum(dim=1, keepdim=True).clamp(min=1.0)
    return (x - (x * node_mask).sum(dim=1, keepdim=True) / n) * node_mask


def project_noise(raw: Tensor, node_mask: Tensor) -> Tensor:
    """Standard-normal draws (B, N, 3 + F) -> the model's noise: the x block
    masked and centred, the feature block masked."""
    return torch.cat([center(raw[..., :3] * node_mask, node_mask), raw[..., 3:] * node_mask], -1)


# --- the EGNN (egnn_new.py) and the dynamics (en_dynamics.py) ---------------


def egnn(p: Params, cfg: dict, h: Tensor, x: Tensor, node_mask: Tensor,
         edge_mask: Tensor, first_gcl: bool = False):
    """h (B, N, F_in), x (B, N, 3), node_mask (B, N, 1), edge_mask (B, N, N)
    -> (h_out, x_out), in ``p``'s arithmetic; with ``first_gcl``, the hidden
    h after the first block's first GCL alone."""
    dt = p.dtype
    h, x = h.to(dt), x.to(dt)
    nm, em = node_mask.to(dt), edge_mask.to(dt)[..., None]
    n_rows = h.shape[1]
    pre = "dynamics.egnn."
    d0 = ((x[:, :, None] - x[:, None]) ** 2).sum(-1, keepdim=True)
    h = p.linear(h, pre + "embedding")
    for i in range(cfg["n_layers"]):
        blk = f"{pre}e_block_{i}."
        diff = x[:, :, None] - x[:, None]
        radial = (diff ** 2).sum(-1, keepdim=True)
        coord_diff = diff / (torch.sqrt(radial + 1e-8) + cfg["norm_constant"])
        e = torch.cat([radial, d0], -1)

        def pair(hh):
            return torch.cat([hh[:, :, None].expand(-1, -1, n_rows, -1),
                              hh[:, None].expand(-1, n_rows, -1, -1), e], -1)

        for j in range(cfg["inv_sublayers"]):
            g = f"{blk}gcl_{j}."
            m = F.silu(p.linear(pair(h), g + "edge_mlp.0", block=True))
            m = F.silu(p.linear(m, g + "edge_mlp.2", block=True))
            if cfg["attention"]:
                m = m * torch.sigmoid(p.linear(m, g + "att_mlp.0", block=True))
            agg = (m * em).sum(2) / cfg["normalization_factor"]
            out = F.silu(p.linear(torch.cat([h, agg], -1), g + "node_mlp.0", block=True))
            h = (h + p.linear(out, g + "node_mlp.2", block=True)) * nm
            if first_gcl:
                return h
        c = blk + "gcl_equiv.coord_mlp."
        m = F.silu(p.linear(pair(h), c + "0", block=True))
        m = F.silu(p.linear(m, c + "2", block=True))
        s = p.linear(m, c + "4", bias=False, block=True)
        if cfg["tanh"]:
            s = torch.tanh(s) * (cfg["coords_range"] / cfg["n_layers"])
        x = (x + (coord_diff * s * em).sum(2) / cfg["normalization_factor"]) * nm
        h = h * nm
    h = p.linear(h, pre + "embedding_out") * nm
    return h, x


def dynamics(p: Params, cfg: dict, xh: Tensor, t: Tensor, node_mask: Tensor,
             edge_mask: Tensor, mol_rows: Optional[int] = None, first_gcl: bool = False):
    """eps_theta(z_t, t) (B, N, 3 + F) in ``p``'s arithmetic. Rows past
    ``mol_rows`` (a pocket) keep their coordinates: their velocity is zero.
    With ``first_gcl``: the EGNN's h after its first GCL, all rows."""
    dt = p.dtype
    nm = node_mask.to(dt)
    xh = xh.to(dt) * nm
    x, h = xh[..., :3], xh[..., 3:]
    b, n = xh.shape[:2]
    h = torch.cat([h, t.reshape(b, 1, 1).expand(b, n, 1).to(dt)], -1)
    if first_gcl:
        return egnn(p, cfg, h, x, node_mask, edge_mask, first_gcl=True)
    h_out, x_out = egnn(p, cfg, h, x, node_mask, edge_mask)
    if mol_rows is not None:
        x_out = torch.cat([x_out[:, :mol_rows], x[:, mol_rows:]], 1)
    vel = center((x_out - x) * nm, nm)
    return torch.cat([vel, h_out[..., :-1]], -1)


# --- the reverse process (diffusion_qm9.py sample_p_zs_given_zt, sample_p_xh_given_z0)


def step_coefficients(g_s: Tensor, g_t: Tensor) -> dict:
    """The transition's coefficients from gamma at s < t, each (B, 1, 1),
    in the type of ``g_s``."""
    sigma2_ts = -torch.expm1(F.softplus(g_s) - F.softplus(g_t))
    alpha_ts = torch.exp(0.5 * (F.logsigmoid(-g_t) - F.logsigmoid(-g_s)))
    shape = (-1, 1, 1)
    return {"sigma2_ts": sigma2_ts.reshape(shape), "alpha_ts": alpha_ts.reshape(shape),
            "sigma_s": torch.sqrt(torch.sigmoid(g_s)).reshape(shape),
            "sigma_t": torch.sqrt(torch.sigmoid(g_t)).reshape(shape)}


def grid_gammas(sd: Dict[str, Tensor], t_int: int, timesteps: int, device,
                dtype: torch.dtype = torch.float32) -> tuple:
    """gamma at s = t - 1 and at t on the grid of T steps, the times as
    float32 quotients t_int / T."""
    ts = torch.tensor([t_int - 1, t_int], dtype=torch.float32, device=device) / timesteps
    g = gamma(sd, ts, dtype)
    return g[0], g[1]


def eps_prediction(p: Params, cfg: dict, z: Tensor, t_int: int, node_mask: Tensor,
                   edge_mask: Tensor, pocket: Optional[Tensor] = None,
                   pocket_node_mask: Optional[Tensor] = None,
                   full_edge_mask: Optional[Tensor] = None) -> Tensor:
    """eps_theta(z_t, t) on the molecule rows, float32 out. ``pocket``
    (B, K, 3 + F) rows ride after the molecule rows, with
    ``full_edge_mask`` over all rows."""
    rows = z.shape[1]
    return dynamics(p, cfg, *_inputs(cfg, z, t_int, node_mask, edge_mask, pocket,
                                     pocket_node_mask, full_edge_mask),
                    mol_rows=None if pocket is None else rows)[:, :rows].float()


def first_gcl(p: Params, cfg: dict, z: Tensor, t_int: int, node_mask: Tensor,
              edge_mask: Tensor, pocket: Optional[Tensor] = None,
              pocket_node_mask: Optional[Tensor] = None,
              full_edge_mask: Optional[Tensor] = None) -> Tensor:
    """The EGNN's h after its first GCL, over all rows (the pocket's after
    the molecule's), for the same inputs as ``eps_prediction``."""
    return dynamics(p, cfg, *_inputs(cfg, z, t_int, node_mask, edge_mask, pocket,
                                     pocket_node_mask, full_edge_mask), first_gcl=True)


def _inputs(cfg, z, t_int, node_mask, edge_mask, pocket, pocket_node_mask, full_edge_mask):
    t = (torch.tensor(float(t_int), device=z.device) / cfg["timesteps"]).expand(z.shape[0])
    if pocket is None:
        return z, t, node_mask, edge_mask
    return (torch.cat([z, pocket], 1), t, torch.cat([node_mask, pocket_node_mask], 1),
            full_edge_mask)


def step_from(z: Tensor, eps: Tensor, g_s: Tensor, g_t: Tensor, raw: Tensor, node_mask: Tensor,
              dtype: torch.dtype = torch.float32) -> Tensor:
    """z_s ~ p(z_s | z_t) from the noise prediction ``eps`` and gamma at s
    and t (scalars or (B, 1)), with the draws ``raw``: mu + sigma * noise,
    the x block re-centred; in ``dtype``, float32 out."""
    b = z.shape[0]
    nm = node_mask.to(dtype)
    c = step_coefficients(g_s.to(dtype).reshape(-1).expand(b), g_t.to(dtype).reshape(-1).expand(b))
    eps = eps.to(dtype)
    eps = torch.cat([center(eps[..., :3], nm), eps[..., 3:]], -1)
    mu = z.to(dtype) / c["alpha_ts"] - (c["sigma2_ts"] / c["alpha_ts"] / c["sigma_t"]) * eps
    sigma = torch.sqrt(c["sigma2_ts"]) * c["sigma_s"] / c["sigma_t"]
    zs = mu + sigma * project_noise(raw.to(dtype), nm)
    return torch.cat([center(zs[..., :3], nm), zs[..., 3:]], -1).float()


def final_from(z0: Tensor, eps: Tensor, g0: Tensor, raw_noise: Tensor, node_mask: Tensor,
               dtype: torch.dtype = torch.float32) -> Tensor:
    """(x, h) packed (B, N, 3 + F): x drawn from p(x | z_0) given the noise
    prediction ``eps`` at t = 0 and gamma(0) ``g0``, with the draws
    ``raw_noise``; h read from z_0; both unnormalised (norm values 1,
    biases 0 in every configuration here: checked by ``check_config``).
    In ``dtype``, float32 out."""
    g0 = g0.to(dtype).reshape(-1, 1, 1)
    nm = node_mask.to(dtype)
    zz = z0.to(dtype)
    mu = (zz - torch.sqrt(torch.sigmoid(g0)) * eps.to(dtype)) / torch.sqrt(torch.sigmoid(-g0))
    xh = mu + torch.exp(0.5 * g0) * project_noise(raw_noise.to(dtype), nm)
    return torch.cat([xh[..., :3], zz[..., 3:] * nm], -1).float()


def check_config(cfg: dict) -> None:
    """The reference covers the configurations' choices only."""
    want = {"mode": "egnn_dynamics", "aggregation_method": "sum", "condition_time": True,
            "sin_embedding": False, "context_node_nf": 0, "noise_schedule": "learned",
            "norm_values": [1.0, 1.0, 1.0], "norm_biases": [0.0, 0.0, 0.0]}
    for k, v in want.items():
        if cfg.get(k, v) != v:
            raise ValueError(f"reference: {k}={cfg[k]!r} is not covered")


def complete_edges(node_mask: Tensor) -> Tensor:
    """Every pair of distinct real rows, (B, N, N)."""
    m = node_mask[..., 0]
    eye = torch.eye(m.shape[1], device=m.device, dtype=m.dtype)
    return m[:, :, None] * m[:, None, :] * (1 - eye)


def pocket_edges(mol_mask: Tensor, pocket_mask: Tensor, cross: bool) -> Tensor:
    """Edges over molecule rows then pocket rows: within the molecule, within
    the pocket and, with ``cross``, between the two."""
    full = torch.cat([mol_mask, pocket_mask], 1)
    em = complete_edges(full)
    if not cross:
        n = mol_mask.shape[1]
        em[:, :n, n:] = 0
        em[:, n:, :n] = 0
    return em
