"""Dense masked E(3)-equivariant GNN for padded fragment point clouds.

Port of ``hierdiff_tpu/ops/egnn.py``: every tensor is dense (B, N, N, ...)
with an edge mask, the pair linear ``cat([h_i, h_j, e_ij]) @ W`` is computed
as ``h W_src (+bcast) h W_dst (+) e W_e``, and the module names and weight
shapes follow the reference EGNN (endiffusion/models/layers/egnn_new.py), so
a reference state dict loads with ``strict=True``.

``DenseGCL`` and ``DenseEquivariantUpdate`` run through the fused kernels of
``ops/egnn_kernels.py``: on CUDA tensors the hand-written kernels, on CPU
tensors their plain versions. Under autograd the GCL's CUDA path is
``FusedGCLFunction`` (forward and backward kernels), and the coordinate
update takes its plain, differentiable version: the JAX package trains that
layer through XLA too, since no Pallas backward exists for it. Mean
aggregation is plain PyTorch on every device, chosen by the configuration:
the JAX package takes its Pallas kernels for ``"sum"`` only
(``hierdiff_tpu/ops/egnn.py:199,205,296``), and so do the kernels here.

Memory switches of training (``hierdiff_tpu/ops/egnn.py:160-168, 411``):
``remat_edges`` recomputes each layer's (B, N, N, H) edge chain in the
backward instead of saving it (``egnn_kernels.checkpointed``; it changes the
plain routes, which on the card are the coordinate update under autograd and
mean aggregation: ``FusedGCLFunction`` saves no edge tensor anyway), and
``remat`` recomputes each whole block, ``fused_gcl`` launches included.
Both act only while a gradient is recorded; a no-grad call runs as without
them. The block keeps its name (``e_block_{i}``), so weights map as before.

``DenseGNN`` is the plain (non-equivariant) backbone of
``mode="gnn_dynamics"``: DenseGCLs with no edge features over an all-ones
edge mask.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import Tensor, nn

from hierdiff_torch.ops import egnn_kernels
from hierdiff_torch.ops.egnn_kernels import (checkpointed, coord_update_plain,
                                             fused_coord_update, fused_gcl, gcl_plain)


def resolve_compute_dtype(compute_dtype) -> Optional[torch.dtype]:
    """'bfloat16' -> torch.bfloat16; None / 'float32' -> None (f32)."""
    if compute_dtype in (None, "float32", torch.float32):
        return None
    if compute_dtype in ("bfloat16", torch.bfloat16):
        return torch.bfloat16
    raise ValueError(f"unsupported compute_dtype {compute_dtype!r}")


def _aggregation(aggregation_method: str) -> str:
    if aggregation_method not in ("sum", "mean"):
        raise ValueError(f"aggregation_method={aggregation_method!r}: 'sum' or 'mean'")
    return aggregation_method


class _KernelLayer(nn.Module):
    """Holds the fused kernel's cached bf16 weights (``egnn_kernels``
    rebuilds them when a parameter's version changes); drops them whenever
    the parameters may be replaced (``load_state_dict``) or moved
    (``.to()``)."""

    def __init__(self):
        super().__init__()
        self._kernel_weights = None

    def _load_from_state_dict(self, *args, **kwargs):
        self._kernel_weights = None
        super()._load_from_state_dict(*args, **kwargs)

    def _apply(self, fn, *args, **kwargs):
        self._kernel_weights = None
        return super()._apply(fn, *args, **kwargs)


def drop_kernel_caches(module: nn.Module) -> nn.Module:
    """Forget every kernel-weight cache under ``module``, e.g. in a
    ``copy.deepcopy`` that must build its own."""
    for sub in module.modules():
        if isinstance(sub, _KernelLayer):
            sub._kernel_weights = None
    return module


def sinusoids_embedding(radial: Tensor, max_res: float = 30.0,
                        min_res: float = 30.0 / 2000.0, div_factor: int = 4) -> Tensor:
    """Sinusoidal embedding of squared distances: (..., 1) -> (..., 2n).
    (reference: egnn_new.py:245-258 SinusoidsEmbeddingNew)"""
    n_freq = int(math.log(max_res / min_res, div_factor)) + 1
    freqs = 2.0 * math.pi * (float(div_factor) ** torch.arange(
        n_freq, dtype=radial.dtype, device=radial.device)) / max_res
    x = torch.sqrt(radial + 1e-8)
    emb = x * freqs
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1).detach()


def coord2diff_dense(x: Tensor, norm_constant: float = 1.0):
    """x (B, N, 3) -> radial (B, N, N, 1) squared distances and diff
    (B, N, N, 3) = (x_i - x_j) / (|x_i - x_j| + norm_constant).
    (reference: egnn_new.py:260-266)"""
    diff = x[:, :, None, :] - x[:, None, :, :]
    radial = (diff ** 2).sum(dim=-1, keepdim=True)
    norm = torch.sqrt(radial + 1e-8)
    return radial, diff / (norm + norm_constant)


class DenseGCL(_KernelLayer):
    """Invariant graph conv layer over dense masked edges.

    m_ij = silu(Linear(silu(PairLinear(h_i, h_j, e_ij))))      # edge MLP
    m_ij *= sigmoid(att(m_ij))                                 # optional gate
    agg_i = sum_j m_ij * edge_mask / normalization_factor      # masked row-sum
    h_i  += Linear(silu(Linear(cat[h_i, agg_i])))              # node MLP
    (reference: egnn_new.py:8-70)"""

    def __init__(self, hidden_nf: int, in_edge_nf: int,
                 normalization_factor: float = 100.0, aggregation_method: str = "sum",
                 attention: bool = False, compute_dtype=None, remat_edges: bool = False):
        super().__init__()
        self.aggregation_method = _aggregation(aggregation_method)
        self.normalization_factor = normalization_factor
        self.attention = attention
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        self.remat_edges = remat_edges
        h = hidden_nf
        self.edge_mlp = nn.Sequential(nn.Linear(2 * h + in_edge_nf, h), nn.SiLU(),
                                      nn.Linear(h, h), nn.SiLU())
        self.node_mlp = nn.Sequential(nn.Linear(2 * h, h), nn.SiLU(), nn.Linear(h, h))
        if attention:
            self.att_mlp = nn.Sequential(nn.Linear(h, 1), nn.Sigmoid())

    def forward(self, h: Tensor, edge_attr: Tensor, node_mask: Tensor,
                edge_mask: Tensor) -> Tensor:
        if self.aggregation_method == "mean":   # no kernel path, by design
            return gcl_plain(self, h, edge_attr, edge_mask, node_mask)
        return fused_gcl(self, h, edge_attr, edge_mask, node_mask)


class DenseEquivariantUpdate(_KernelLayer):
    """x_i += sum_j (x_i - x_j)/(d + c) * phi(h_i, h_j, e_ij), phi ending in
    a near-zero scalar head, tanh-bounded by ``coords_range``.
    (reference: egnn_new.py:73-110)"""

    def __init__(self, hidden_nf: int, in_edge_nf: int,
                 normalization_factor: float = 100.0, aggregation_method: str = "sum",
                 tanh: bool = False, coords_range: float = 10.0, compute_dtype=None,
                 remat_edges: bool = False):
        super().__init__()
        self.aggregation_method = _aggregation(aggregation_method)
        self.normalization_factor = normalization_factor
        self.tanh = tanh
        self.coords_range = coords_range
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        self.remat_edges = remat_edges
        h = hidden_nf
        self.coord_mlp = nn.Sequential(nn.Linear(2 * h + in_edge_nf, h), nn.SiLU(),
                                       nn.Linear(h, h), nn.SiLU(),
                                       nn.Linear(h, 1, bias=False))

    def forward(self, h: Tensor, x: Tensor, coord_diff: Tensor, edge_attr: Tensor,
                node_mask: Tensor, edge_mask: Tensor) -> Tensor:
        if self.aggregation_method == "mean":   # no kernel path, by design
            return coord_update_plain(self, h, edge_attr, coord_diff, x, edge_mask, node_mask)
        # chosen by the autograd mode, never by a failure: the kernel has no
        # backward, so a recorded call takes the plain route and counts it
        if egnn_kernels.records_grad(self, h, x, coord_diff, edge_attr):
            egnn_kernels.launch_counts["coord_update_autograd"] += 1
            return coord_update_plain(self, h, edge_attr, coord_diff, x, edge_mask, node_mask)
        return fused_coord_update(self, h, edge_attr, coord_diff, x, edge_mask, node_mask)


class DenseEquivariantBlock(nn.Module):
    """``n_layers`` DenseGCLs and one coordinate update, with per-block
    distances appended to the block-input distance channel.
    (reference: egnn_new.py:113-152)"""

    def __init__(self, hidden_nf: int, in_edge_nf: int, n_layers: int = 2,
                 attention: bool = True, tanh: bool = False, coords_range: float = 15.0,
                 norm_constant: float = 1.0, normalization_factor: float = 100.0,
                 aggregation_method: str = "sum", compute_dtype=None,
                 sin_embedding: bool = False, remat_edges: bool = False):
        super().__init__()
        self.n_layers = n_layers
        self.norm_constant = norm_constant
        self.sin_embedding = sin_embedding
        for i in range(n_layers):
            self.add_module(f"gcl_{i}", DenseGCL(
                hidden_nf, in_edge_nf, normalization_factor=normalization_factor,
                aggregation_method=aggregation_method, attention=attention,
                compute_dtype=compute_dtype, remat_edges=remat_edges))
        self.gcl_equiv = DenseEquivariantUpdate(
            hidden_nf, in_edge_nf, normalization_factor=normalization_factor,
            aggregation_method=aggregation_method, tanh=tanh,
            coords_range=coords_range, compute_dtype=compute_dtype, remat_edges=remat_edges)

    def forward(self, h: Tensor, x: Tensor, distances0: Tensor, node_mask: Tensor,
                edge_mask: Tensor):
        radial, coord_diff = coord2diff_dense(x, self.norm_constant)
        if self.sin_embedding:
            radial = sinusoids_embedding(radial)
        edge_attr = torch.cat([radial, distances0], dim=-1)
        for i in range(self.n_layers):
            h = getattr(self, f"gcl_{i}")(h, edge_attr, node_mask, edge_mask)
        x = self.gcl_equiv(h, x, coord_diff, edge_attr, node_mask, edge_mask)
        return h * node_mask, x


class DenseEGNN(nn.Module):
    """Embed -> ``n_layers`` equivariant blocks -> project out.

    h (B, N, in_node_nf), x (B, N, 3), node_mask (B, N, 1), edge_mask
    (B, N, N, 1), all float32. Returns (h, x). ``remat``: each block under a
    checkpoint while a gradient is recorded; ``remat_edges``: see the module
    docstring. (reference: egnn_new.py:155-205)"""

    def __init__(self, in_node_nf: int, hidden_nf: int = 256,
                 out_node_nf: Optional[int] = None, n_layers: int = 6,
                 inv_sublayers: int = 2, attention: bool = True, tanh: bool = True,
                 coords_range: float = 30.0, norm_constant: float = 1.0,
                 normalization_factor: float = 100.0, aggregation_method: str = "sum",
                 compute_dtype=None, sin_embedding: bool = False, remat: bool = False,
                 remat_edges: bool = False):
        super().__init__()
        out_node_nf = in_node_nf if out_node_nf is None else out_node_nf
        self.n_layers = n_layers
        self.sin_embedding = sin_embedding
        self.remat = remat
        # radial + distances0, each 12 sinusoid features with sin_embedding
        in_edge_nf = 2 * sinusoids_embedding(torch.zeros(1)).shape[-1] if sin_embedding else 2
        self.embedding = nn.Linear(in_node_nf, hidden_nf)
        for i in range(n_layers):
            self.add_module(f"e_block_{i}", DenseEquivariantBlock(
                hidden_nf, in_edge_nf, n_layers=inv_sublayers, attention=attention,
                tanh=tanh, coords_range=float(coords_range) / n_layers,
                norm_constant=norm_constant, normalization_factor=normalization_factor,
                aggregation_method=aggregation_method, compute_dtype=compute_dtype,
                sin_embedding=sin_embedding, remat_edges=remat_edges))
        self.embedding_out = nn.Linear(hidden_nf, out_node_nf)

    def forward(self, h: Tensor, x: Tensor, node_mask: Tensor, edge_mask: Tensor):
        x = x.contiguous()
        distances0, _ = coord2diff_dense(x, norm_constant=1.0)
        if self.sin_embedding:
            distances0 = sinusoids_embedding(distances0)
        h = self.embedding(h)
        for i in range(self.n_layers):
            h, x = checkpointed(self.remat, getattr(self, f"e_block_{i}"), h, x, distances0,
                                node_mask, edge_mask)
        h = self.embedding_out(h)
        return h * node_mask, x


class DenseGNN(nn.Module):
    """Plain (non-equivariant) GNN: embed -> ``n_layers`` DenseGCLs with no
    edge features -> project out; the ``gnn_dynamics`` backbone, whose
    coordinates ride in the node features. Like the reference GNN, called
    without an edge mask over an edge list with self-edges
    (en_dynamics.py:92,124-143), it aggregates over an all-ones mask that
    includes the diagonal and the padded pairs; the caller masks the node
    features. (reference: egnn_new.py:208-242; hierdiff_tpu/ops/egnn.py:452)"""

    def __init__(self, in_node_nf: int, hidden_nf: int = 256,
                 out_node_nf: Optional[int] = None, n_layers: int = 4,
                 attention: bool = False, normalization_factor: float = 100.0,
                 aggregation_method: str = "sum", compute_dtype=None):
        super().__init__()
        out_node_nf = in_node_nf if out_node_nf is None else out_node_nf
        self.n_layers = n_layers
        self.embedding = nn.Linear(in_node_nf, hidden_nf)
        for i in range(n_layers):
            self.add_module(f"gcl_{i}", DenseGCL(
                hidden_nf, 0, normalization_factor=normalization_factor,
                aggregation_method=aggregation_method, attention=attention,
                compute_dtype=compute_dtype))
        self.embedding_out = nn.Linear(hidden_nf, out_node_nf)

    def forward(self, h: Tensor, node_mask: Tensor) -> Tensor:
        b, n, _ = h.shape
        edge_attr = h.new_zeros((b, n, n, 0))
        ones = h.new_ones((b, n, n, 1))
        h = self.embedding(h)
        for i in range(self.n_layers):
            h = getattr(self, f"gcl_{i}")(h, edge_attr, node_mask, ones)
        return self.embedding_out(h) * node_mask
