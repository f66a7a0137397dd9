"""EGNN dynamics: the eps-prediction network of the coarse diffusion model.

Port of ``hierdiff_tpu/models/dynamics.py`` (reference
endiffusion/models/module/en_dynamics.py): appends the diffusion time (and
optional global context) as extra node channels, runs the EGNN, turns the
coordinate output into a CoM-free velocity, and returns cat([vel, h_out]).
With ``mode="gnn_dynamics"`` a plain GNN (``DenseGNN``) over [x, h] predicts
[vel, h_out] directly; its output is sized to the whole input width, as the
JAX package does (PARITY.md #14).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor, nn

from hierdiff_torch.ops.egnn import DenseEGNN, DenseGNN
from hierdiff_torch.ops.masked import remove_mean_with_mask


class EGNNDynamics(nn.Module):
    """eps_theta(z_t, t): (B, N, 3 + h_nf) -> (B, N, 3 + h_nf).
    (reference: en_dynamics.py:49-122)"""

    def __init__(self, in_node_nf: int, context_node_nf: int = 0, n_dims: int = 3,
                 hidden_nf: int = 256, n_layers: int = 6, inv_sublayers: int = 2,
                 attention: bool = True, tanh: bool = True, coords_range: float = 30.0,
                 norm_constant: float = 0.0, normalization_factor: float = 10.0,
                 aggregation_method: str = "sum", condition_time: bool = True,
                 compute_dtype=None, mode: str = "egnn_dynamics",
                 sin_embedding: bool = False, remat: bool = False, remat_edges: bool = False):
        super().__init__()
        self.in_node_nf = in_node_nf
        self.context_node_nf = context_node_nf
        self.n_dims = n_dims
        self.condition_time = condition_time
        self.mode = mode
        egnn_in = in_node_nf + context_node_nf + (1 if condition_time else 0)
        if mode == "gnn_dynamics":
            # (reference: en_dynamics.py:25-30); out = in, PARITY.md #14
            self.gnn = DenseGNN(
                n_dims + egnn_in, hidden_nf=hidden_nf, out_node_nf=n_dims + egnn_in,
                n_layers=n_layers, attention=attention,
                normalization_factor=normalization_factor,
                aggregation_method=aggregation_method, compute_dtype=compute_dtype)
        elif mode == "egnn_dynamics":
            self.egnn = DenseEGNN(
                egnn_in, hidden_nf=hidden_nf, out_node_nf=egnn_in, n_layers=n_layers,
                inv_sublayers=inv_sublayers, attention=attention, tanh=tanh,
                coords_range=coords_range, norm_constant=norm_constant,
                normalization_factor=normalization_factor,
                aggregation_method=aggregation_method, compute_dtype=compute_dtype,
                sin_embedding=sin_embedding, remat=remat, remat_edges=remat_edges)
        else:
            raise ValueError(f"Wrong mode {mode}")

    def forward(self, t: Tensor, xh: Tensor, node_mask: Tensor, edge_mask: Tensor,
                context: Optional[Tensor] = None, mol_shape: Optional[int] = None) -> Tensor:
        b, n, dims = xh.shape
        h_dims = dims - self.n_dims
        node_mask = node_mask.to(xh.dtype)
        if edge_mask.ndim == 3:
            edge_mask = edge_mask[..., None]
        edge_mask = edge_mask.to(xh.dtype).contiguous()

        xh = xh * node_mask
        x = xh[:, :, : self.n_dims]
        h = xh.new_ones((b, n, 1)) if h_dims == 0 else xh[:, :, self.n_dims:]
        if self.condition_time:
            # t: scalar, (B,) or (B, 1) -> (B, N, 1)
            t_b = torch.as_tensor(t, dtype=h.dtype, device=h.device).reshape(-1, 1, 1)
            h = torch.cat([h, t_b.expand(b, n, 1)], dim=-1)
        if context is not None and self.context_node_nf > 0:
            h = torch.cat([h, context.reshape(b, n, self.context_node_nf)], dim=-1)

        if self.mode == "gnn_dynamics":
            # coordinates ride in the node features; no mol_shape freeze on
            # this branch (the reference has it only on the egnn one)
            out = self.gnn(torch.cat([x, h], dim=-1), node_mask)
            vel = out[:, :, : self.n_dims] * node_mask
            h_final = out[:, :, self.n_dims:]
        else:
            h_final, x_final = self.egnn(h, x, node_mask, edge_mask)
            if mol_shape is not None:
                # freeze pocket coordinates beyond the molecule rows
                # (reference: en_dynamics.py:83-88)
                x_final = torch.cat([x_final[:, :mol_shape], x[:, mol_shape:]], dim=1)
            vel = (x_final - x) * node_mask

        if context is not None and self.context_node_nf > 0:
            h_final = h_final[:, :, : -self.context_node_nf]
        if self.condition_time:
            h_final = h_final[:, :, :-1]

        # NaN guard per sample (hierdiff_tpu/models/dynamics.py:124-133): only
        # the offending molecule's velocity is zeroed
        bad = torch.isnan(vel).any(dim=2, keepdim=True).any(dim=1, keepdim=True)
        vel = torch.where(bad, torch.zeros_like(vel), vel)
        vel = remove_mean_with_mask(vel, node_mask)

        if h_dims == 0:
            return vel
        return torch.cat([vel, h_final], dim=2)
