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
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn


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
        if compute_dtype not in (None, "float32"):
            raise NotImplementedError(
                "the fine stage runs in float32 only: its bf16 pipeline is queued in "
                "ROADMAP.md, Queue 1 (fine-stage bf16, --fine-bf16)")
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

    # --- shared pieces (any aligned leading shape) ---------------------------

    def _pre(self, h_src: Tensor, h_dst: Tensor) -> Tuple[Tensor, Tensor]:
        """h_src W_src + b and h_dst W_dst: the message's node terms."""
        w, h = self.mes_mlp[0].weight, self.hidden_nf
        return F.linear(h_src, w[:, :h], self.mes_mlp[0].bias), F.linear(h_dst, w[:, h:2 * h])

    def message(self, pre_src: Tensor, pre_dst: Tensor, radial: Tensor,
                edge_attr: Optional[Tensor]) -> Tensor:
        """m = MLP([h_src, h_dst, radial, e]) from the node terms of ``_pre``.
        (reference: gcl.py:91-107)"""
        w, h = self.mes_mlp[0].weight, self.hidden_nf
        pre = pre_src + pre_dst + radial * w[:, 2 * h]
        if self.edges_in_d > 0 and edge_attr is not None:
            pre = pre + F.linear(edge_attr, w[:, 2 * h + 1:])
        m = F.silu(self.mes_mlp[2](F.silu(pre)))
        if self.attention:
            m = m * self.att_mlp(m)
        return m

    def coord_scalar(self, m: Tensor) -> Tensor:
        s = self.coord_mlp(m)
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
        radial, coord_diff = coord2radial_dense(x)
        pre_src, pre_dst = self._pre(h, h)
        m = self.message(pre_src[:, :, None], pre_dst[:, None], radial, edge_attr) * dir_mask

        if self.coord_update:
            # x_j += sum_i (x_i - x_j) / (d + 1) * phi(m_ij) (reference: gcl.py:131-155)
            x = x + (coord_diff * self.coord_scalar(m) * dir_mask).sum(1)
        agg = m.sum(1)
        recv = (dir_mask.sum(1) > 0).to(h.dtype) if self.gated else None
        h = self.node_update(h, agg, recv)
        if node_mask is not None:
            h = h * node_mask
            x = x * node_mask

        if self.edge_update:
            # e' = edge_mlp([m, radial, e]) with edge_mlp.0 split by columns
            # (reference: gcl.py:109-115)
            w, hd = self.edge_mlp[0].weight, self.hidden_nf
            eu = F.linear(m, w[:, :hd], self.edge_mlp[0].bias) + radial * w[:, hd]
            if edge_attr is not None:
                eu = eu + F.linear(edge_attr, w[:, hd + 1:])
            return h, x, self.edge_mlp[2](F.silu(eu)) * dir_mask
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
