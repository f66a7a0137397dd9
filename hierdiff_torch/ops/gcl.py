"""Dense masked E_GCL: the fine stage's message-passing layer.

Port of ``hierdiff_tpu/ops/gcl.py`` in the reference's module layout
(models/egnn/gcl.py:30-66, as ``hierdiff_tpu/utils/torch_import.py:_fine_egcl``
reads it), so a reference ``Edge_denoise`` state dict loads with
``strict=True``: ``mes_mlp.0`` is one (H, 2H + 1 + e) weight over
[h_src | h_dst | radial | e]. ``forward`` splits its columns and adds
``h_src W_src`` and ``h_dst W_dst`` by broadcasting, so the (B, N, N, 2H + 1 + e)
concatenation is never formed; ``edge_mlp.0`` is split the same way.

Messages flow along the edge direction i -> j and are summed at the target j
(reference: gcl.py:118-129). Two passes share the parameters:

- ``forward``: the dense (B, N, N) masked pass (fully connected and
  discovered-subgraph passes);
- ``tree_pass``: one BFS depth layer of a tree through parent pointers. The
  parent gather is ``torch.gather``; the sum of children into their parent is
  a batched product with the (B, N, N) parent one-hot, whose order is fixed
  (a float ``index_add_`` on CUDA sums in atomics' order, run to run
  different). The gather's backward is that sum too (``parent_gather``):
  autograd's own is a ``scatter_add``, atomics again.

``compute_dtype='bfloat16'`` runs the (B, N, N, H) message, coordinate and
edge MLPs in bf16 as the JAX layer does (``nn.Dense(dtype=bf16)``): each
linear casts its input and weight to bf16, rounds its product to bf16 and
then adds the bias in bf16 (two roundings, ``_dense``); the message is
masked in bf16, its row sum accumulates in f32, the coordinate scalar
returns to f32 (after tanh) before it multiplies the differences, and the
edge update concatenates [m, radial, e] in bf16 and returns bf16. The node
MLP and the residual state stay f32; parameters stay f32 and are cast per
call.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from hierdiff_torch.ops.egnn import resolve_compute_dtype


def coord2radial_dense(x: Tensor) -> Tuple[Tensor, Tensor]:
    """radial (B, N, N, 1) = |x_i - x_j|^2 and the difference normalised by
    (|.| + 1). (reference: gcl.py:203-210)"""
    diff = x[:, :, None, :] - x[:, None, :, :]
    radial = (diff ** 2).sum(-1, keepdim=True)
    norm = torch.sqrt(radial + 1e-8)
    return radial, diff / (norm + 1.0)


def compute_parents(adj: Tensor, depth: Tensor) -> Tensor:
    """Parent pointer toward the BFS source: for each node i the first
    neighbour j with depth[j] == depth[i] - 1, or i itself when there is none
    (source, unreachable and padded nodes). adj (B, N, N), depth (B, N) ->
    (B, N) int64."""
    n = adj.shape[1]
    ok = adj * ((depth[:, None, :] == depth[:, :, None] - 1)
                & (depth[:, :, None] >= 1)).to(adj.dtype)
    has = ok.sum(2) > 0
    parent = torch.argmax(ok, dim=2)     # the first maximum, as jnp.argmax
    self_idx = torch.arange(n, device=adj.device).expand_as(parent)
    return torch.where(has, parent, self_idx)


def _dense(x: Tensor, weight: Tensor, bias: Optional[Tensor], dt: Optional[torch.dtype]) -> Tensor:
    """x W^T + b, or with ``dt`` a flax ``Dense(dtype=dt)``: operands cast
    to ``dt``, the product rounded to ``dt``, then the bias added in ``dt``
    (F.linear's bias would join the product before its one rounding)."""
    if dt is None:
        return F.linear(x, weight, bias)
    y = F.linear(x.to(dt), weight.to(dt))
    return y if bias is None else y + bias.to(dt)


def parent_onehot(parent: Tensor, n: int, dtype: torch.dtype) -> Tensor:
    """(B, N, N) one-hot of the parent pointers: [b, i, j] = (parent[b, i] == j).
    F.one_hot would check its input's range on the host."""
    return (parent[..., None] == torch.arange(n, device=parent.device)).to(dtype)


class _ParentGather(torch.autograd.Function):
    """out[b, i] = t[b, parent[b, i]], whose backward sums each parent's
    children by a batched product with the parent one-hot: a fixed order,
    so a gradient repeats bit for bit on CUDA, where the backward of
    ``torch.gather`` (a ``scatter_add``) sums in the order of its atomics."""

    @staticmethod
    def forward(ctx, t: Tensor, parent: Tensor) -> Tensor:
        ctx.save_for_backward(parent)
        ctx.n = t.shape[1]
        return torch.gather(t, 1, parent[..., None].expand(-1, -1, t.shape[-1]))

    @staticmethod
    def backward(ctx, grad: Tensor):
        (parent,) = ctx.saved_tensors
        from_child = parent_onehot(parent, ctx.n, grad.dtype).transpose(1, 2)
        return torch.bmm(from_child, grad), None


def parent_gather(t: Tensor, parent: Tensor) -> Tensor:
    """Rows of t (B, N, F) at the parent pointers (B, N) -> (B, N, F); the
    backward sums in a fixed order (``_ParentGather``)."""
    return _ParentGather.apply(t, parent)


class DenseEGCL(nn.Module):
    """One fine-stage E_GCL pass, dense or along a tree.

    Dense inputs: h (B, N, H), x (B, N, 3), dir_mask (B, N, N[, 1]), 1 where
    the directed edge i -> j is active; edge_attr None or (B, N, N, E).

    ``gated`` (default, the JAX package's choice) updates h only at nodes
    with an incoming active edge, so a depth layer without edges is an exact
    no-op; the reference updates every node on every depth step.
    """

    def __init__(self, hidden_nf: int, edges_in_d: int = 0, attention: bool = False,
                 tanh: bool = True, coords_range: float = 30.0, coord_update: bool = True,
                 edge_update: bool = False, recurrent: bool = True, gated: bool = True,
                 compute_dtype: Optional[str] = None):
        super().__init__()
        resolve_compute_dtype(compute_dtype)
        self.compute_dtype = compute_dtype
        h = hidden_nf
        self.hidden_nf, self.edges_in_d = h, edges_in_d
        self.attention, self.tanh, self.coords_range = attention, tanh, coords_range
        self.coord_update, self.edge_update = coord_update, edge_update
        self.recurrent, self.gated = recurrent, gated
        self.mes_mlp = nn.Sequential(nn.Linear(2 * h + 1 + edges_in_d, h), nn.SiLU(),
                                     nn.Linear(h, h), nn.SiLU())
        self.node_mlp = nn.Sequential(nn.Linear(2 * h, h), nn.SiLU(), nn.Linear(h, h))
        if coord_update:
            self.coord_mlp = nn.Sequential(nn.Linear(h, h), nn.SiLU(),
                                           nn.Linear(h, 1, bias=False))
        if attention:
            self.att_mlp = nn.Sequential(nn.Linear(h, 1), nn.Sigmoid())
        if edge_update:
            self.edge_mlp = nn.Sequential(nn.Linear(h + 1 + edges_in_d, h), nn.SiLU(),
                                          nn.Linear(h, h))

    @property
    def _dt(self) -> Optional[torch.dtype]:
        return resolve_compute_dtype(self.compute_dtype)

    # --- shared pieces (any aligned leading shape) ---------------------------

    def _pre(self, h_src: Tensor, h_dst: Tensor) -> Tuple[Tensor, Tensor]:
        """h_src W_src + b and h_dst W_dst: the message's node terms."""
        w, h = self.mes_mlp[0].weight, self.hidden_nf
        return (_dense(h_src, w[:, :h], self.mes_mlp[0].bias, self._dt),
                _dense(h_dst, w[:, h:2 * h], None, self._dt))

    def message(self, pre_src: Tensor, pre_dst: Tensor, radial: Tensor,
                edge_attr: Optional[Tensor]) -> Tensor:
        """m = MLP([h_src, h_dst, radial, e]) from the node terms of ``_pre``.
        (reference: gcl.py:91-107)"""
        dt = self._dt
        w, h = self.mes_mlp[0].weight, self.hidden_nf
        w_rad = w[:, 2 * h]
        rad = radial * w_rad if dt is None else radial.to(dt) * w_rad.to(dt)
        pre = pre_src + pre_dst + rad
        if self.edges_in_d > 0 and edge_attr is not None:
            pre = pre + _dense(edge_attr, w[:, 2 * h + 1:], None, dt)
        out = self.mes_mlp[2]
        m = F.silu(_dense(F.silu(pre), out.weight, out.bias, dt))
        if self.attention:
            att = self.att_mlp[0]
            m = m * torch.sigmoid(_dense(m, att.weight, att.bias, dt))
        return m

    def coord_scalar(self, m: Tensor) -> Tensor:
        dt = self._dt
        c_in, c_head = self.coord_mlp[0], self.coord_mlp[2]
        s = _dense(F.silu(_dense(m, c_in.weight, c_in.bias, dt)), c_head.weight, None, dt)
        return torch.tanh(s) * self.coords_range if self.tanh else s

    def node_update(self, h: Tensor, agg: Tensor, recv: Optional[Tensor]) -> Tensor:
        """h += node_mlp([h, agg]), gated to receivers. (reference: gcl.py:118-129)"""
        out = self.node_mlp(torch.cat([h, agg], dim=-1))
        if self.gated and recv is not None:
            out = out * recv
        return h + out if self.recurrent else out

    # --- dense pass ----------------------------------------------------------

    def forward(self, h: Tensor, x: Tensor, dir_mask: Tensor,
                edge_attr: Optional[Tensor] = None, node_mask: Optional[Tensor] = None):
        if dir_mask.dim() == 3:
            dir_mask = dir_mask[..., None]
        dt = self._dt
        radial, coord_diff = coord2radial_dense(x)
        pre_src, pre_dst = self._pre(h, h)
        m = self.message(pre_src[:, :, None], pre_dst[:, None], radial, edge_attr)
        # in bf16 the mask is bf16 too, so the product does not promote
        m = m * (dir_mask if dt is None else dir_mask.to(dt))

        if self.coord_update:
            # x_j += sum_i (x_i - x_j) / (d + 1) * phi(m_ij) (reference: gcl.py:131-155)
            scal = self.coord_scalar(m).to(x.dtype)
            x = x + (coord_diff * scal * dir_mask).sum(1)
        # bf16 messages are summed in f32, the node state's type
        agg = m.sum(1) if dt is None else m.sum(1, dtype=h.dtype)
        recv = (dir_mask.sum(1) > 0).to(h.dtype) if self.gated else None
        h = self.node_update(h, agg, recv)
        if node_mask is not None:
            h = h * node_mask
            x = x * node_mask

        if self.edge_update:
            # e' = edge_mlp([m, radial, e]) (reference: gcl.py:109-115)
            w, hd = self.edge_mlp[0].weight, self.hidden_nf
            e_out = self.edge_mlp[2]
            if dt is None:
                # edge_mlp.0 split by columns: no (B, N, N, H + 1 + E) concat
                eu = F.linear(m, w[:, :hd], self.edge_mlp[0].bias) + radial * w[:, hd]
                if edge_attr is not None:
                    eu = eu + F.linear(edge_attr, w[:, hd + 1:])
                return h, x, e_out(F.silu(eu)) * dir_mask
            # bf16: one product over the concatenation, as the JAX layer
            cat = torch.cat([m, radial.to(dt)] + ([edge_attr.to(dt)] if edge_attr is not None
                                                   else []), dim=-1)
            eu = F.silu(_dense(cat, w[:, :cat.shape[-1]], self.edge_mlp[0].bias, dt))
            return h, x, _dense(eu, e_out.weight, e_out.bias, dt) * dir_mask.to(dt)
        return h, x

    # --- tree pass -----------------------------------------------------------

    def tree_pass(self, h: Tensor, x: Tensor, parent: Tensor, active: Tensor,
                  node_mask: Optional[Tensor] = None, reverse: bool = False):
        """One BFS depth layer over a tree via parent pointers.

        parent (B, N) int64: each node's neighbour one step closer to the BFS
        source (itself if none); active (B, N): the nodes whose edge is in
        this layer. ``reverse=False`` sends active -> parent, ``reverse=True``
        parent -> active. The math is the dense pass's restricted to those
        edges; with edges_in_d = 1 the squared distance is also the edge
        attribute (reference: edge_denoise.py:155)."""
        act = active.to(h.dtype)[..., None]                        # (B, N, 1)
        h_par = parent_gather(h, parent)
        x_par = parent_gather(x, parent)
        if reverse:
            src_h, dst_h, diff = h_par, h, x_par - x
        else:
            src_h, dst_h, diff = h, h_par, x - x_par
        radial = (diff ** 2).sum(-1, keepdim=True)
        coord_diff = diff / (torch.sqrt(radial + 1e-8) + 1.0)
        pre_src, pre_dst = self._pre(src_h, dst_h)
        m = self.message(pre_src, pre_dst, radial, radial if self.edges_in_d > 0 else None) * act

        if reverse:
            # the receivers are the active nodes themselves
            if self.coord_update:
                x = x + coord_diff * self.coord_scalar(m) * act
            h = self.node_update(h, m, act if self.gated else None)
        else:
            # the receivers are the parents: children summed in a fixed order
            to_parent = parent_onehot(parent, h.shape[1], h.dtype) * act
            from_child = to_parent.transpose(1, 2)
            if self.coord_update:
                x = x + torch.bmm(from_child, coord_diff * self.coord_scalar(m) * act)
            agg = torch.bmm(from_child, m)
            recv = (to_parent.sum(1) > 0).to(h.dtype)[..., None] if self.gated else None
            h = self.node_update(h, agg, recv)

        if node_mask is not None:
            h = h * node_mask
            x = x * node_mask
        return h, x
