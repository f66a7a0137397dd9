"""Refine model: masked-node fragment-type re-scoring over junction trees.

Port of ``hierdiff_tpu/models/refine.py`` (``NodeRefine``: ``encode``,
``message``, ``logits_at``, the training loss ``forward``, and for sampling
``check_logits`` and ``check_logp``), the reference's ``Node2Vec``
(models/model_refine.py). One
node's identity is masked (token 780, zeroed features) and predicted from a
tri-directional, depth-ordered message flow over the tree:

  collect:  leaves -> masked node (deepest layer first)
  reverse:  masked node -> leaves (shallowest first, edges flipped)
  back:     leaves -> masked node again

Each phase applies its own stack of ``n_layers`` E_GCL layers at every depth
(reference: model_refine.py:48-71), through ``DenseEGCL.tree_pass``. Module
names are the JAX package's, so ``utils/weights.refine_state_dict_from_flax``
(the layout of ``export_refine``) loads with ``strict=True``.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import torch
from torch import Tensor, nn

from hierdiff_torch.data.refine import MASK_TOKEN
from hierdiff_torch.ops.gcl import DenseEGCL, compute_parents
from hierdiff_torch.ops.graph import bfs_depths
from hierdiff_torch.ops.masked import masked_cross_entropy, masked_log_softmax, take_rows

__all__ = ["MASK_TOKEN", "NodeRefine"]

PHASES = ("gcl_collect", "gcl_reverse", "gcl_back")


class NodeRefine(nn.Module):
    """Defaults mirror conf/model/refine.yaml (``config.RefineConfig``)."""

    def __init__(self, vocab_size: int = 780, feature_size: int = 8, hidden_size: int = 256,
                 n_layers: int = 2, max_size: int = 26, gated: bool = True,
                 max_depth: Optional[int] = None, dynamic_depth: bool = False):
        super().__init__()
        h = hidden_size
        self.vocab_size, self.feature_size, self.hidden_size = vocab_size, feature_size, h
        self.n_layers, self.max_size, self.gated = n_layers, max_size, gated
        self.max_depth = max_depth       # iterations per phase; None: N - 1
        # inference: run only the iterations that can hold an active node,
        # bounded by the batch's largest BFS depth (one host read per
        # message); exact under gated=True, where the others are no-ops
        self.dynamic_depth = dynamic_depth
        self.v_embedding = nn.Embedding(vocab_size + 1, h)
        self.f_embedding = nn.Sequential(nn.Linear(feature_size, h), nn.SiLU(), nn.Linear(h, h))
        self.size_embedding = nn.Embedding(max_size, h)
        self.projection = nn.Sequential(nn.Linear(3 * h, 3 * h), nn.SiLU(), nn.Linear(3 * h, h),
                                        nn.SiLU(), nn.Linear(h, h))
        for phase in PHASES:
            for i in range(n_layers):
                setattr(self, f"{phase}{i}", DenseEGCL(
                    h, edges_in_d=1, attention=True, tanh=True, coords_range=30.0,
                    coord_update=True, edge_update=False, gated=gated))
        self.output = nn.Sequential(nn.Linear(h + 1, h), nn.SiLU(), nn.Linear(h, vocab_size))

    def clone(self, **changes) -> "NodeRefine":
        """A view of this model with other settings (``dynamic_depth``) that
        shares its parameters."""
        view = copy.copy(self)
        for name, value in changes.items():
            setattr(view, name, value)
        return view

    def _phase(self, phase: str, h: Tensor, x: Tensor, parent: Tensor, depth: Tensor,
               node_mask: Tensor, ds: Tensor, flip: bool, ks: range) -> Tuple[Tensor, Tensor]:
        """One directional phase: iteration k activates each sample's nodes at
        depth ds[k] (L, B), and every layer of the phase takes one
        parent-pointer tree pass over them. The static and the dynamic form
        differ only in ``ks``; the iterations the dynamic form leaves out
        have no active node, so under gated=True they change no bit."""
        layers = [getattr(self, f"{phase}{i}") for i in range(self.n_layers)]
        for k in ks:
            d = ds[k][:, None]
            active = (depth == d) & (d >= 1)
            for layer in layers:
                h, x = layer.tree_pass(h, x, parent, active, node_mask, reverse=flip)
        return h, x

    def message(self, h: Tensor, x: Tensor, adj: Tensor, center_onehot: Tensor,
                node_mask: Tensor) -> Tuple[Tensor, Tensor]:
        """Tri-directional depth flow. (reference: model_refine.py:48-71)

        Depth layers are aligned per sample by position from the deepest,
        like the reference's flat_add_and_concat (model_refine.py:322-343):
        collect and back run each sample's deepest layer in iteration 0; the
        reverse phase reverses the concatenated layer list, so sample i's
        shallowest layer runs at iteration L - maxdepth_i."""
        n = adj.shape[1]
        depth = bfs_depths(adj, center_onehot)
        parent = compute_parents(adj, depth)
        maxd = depth.max(dim=1).values                       # (B,)
        steps = self.max_depth or (n - 1)
        ks = torch.arange(steps, device=adj.device, dtype=maxd.dtype)
        down = maxd[None, :] - ks[:, None]                   # (L, B) deepest first
        up = maxd[None, :] - (steps - 1 - ks)[:, None]       # the reversed concatenation
        if self.dynamic_depth and self.gated:
            # down phases are active for k < max(maxd); the reversed phase's
            # active iterations sit at the end, k >= steps - max(maxd)
            kmax = min(int(maxd.max()), steps) if maxd.numel() else 0
            down_ks, up_ks = range(0, kmax), range(steps - kmax, steps)
        else:
            down_ks = up_ks = range(steps)
        h, x = self._phase("gcl_collect", h, x, parent, depth, node_mask, down, False, down_ks)
        h, x = self._phase("gcl_reverse", h, x, parent, depth, node_mask, up, True, up_ks)
        h, x = self._phase("gcl_back", h, x, parent, depth, node_mask, down, False, down_ks)
        return h, x

    def encode(self, feats: Tensor, vocab: Tensor, size: Tensor, node_mask: Tensor) -> Tensor:
        """(reference: model_refine.py:85-90). A vocab id of -1 (a node not
        typed yet) reads the last embedding row, MASK_TOKEN's, as the JAX
        package's ``jnp.take`` does with a negative index."""
        vocab = vocab.long()
        vocab = torch.where(vocab < 0, vocab + self.v_embedding.num_embeddings, vocab)
        emb = torch.cat([self.v_embedding(vocab), self.f_embedding(feats),
                         self.size_embedding(size.long().clamp(0, self.max_size - 1))], dim=-1)
        return self.projection(emb) * node_mask

    def logits_at(self, h: Tensor, idx: Tensor, val: Tensor) -> Tensor:
        """Vocab logits at node idx given its degree ``val``.
        (reference: model_refine.py:98-100)"""
        return self.output(torch.cat([take_rows(h, idx), val[:, None]], dim=-1))

    def forward(self, batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """Training loss: the masked node's type CE over its size-restricted
        support, averaged over the batch, its accuracy and the logits.
        Batch (``data/refine.make_refine_batch``): feats (B, N, F) with the
        masked node zeroed, vocab (B, N) with it MASK_TOKEN, size, pos, adj
        (B, N, N), node_mask (B, N, 1), predict_idx, label, val (B,),
        size_support (B, V). (hierdiff_tpu/models/refine.py:158-173;
        reference: model_refine.py:73-111)"""
        h = self.encode(batch["feats"], batch["vocab"], batch["size"], batch["node_mask"])
        predict_idx = batch["predict_idx"].long()
        label = batch["label"].long()
        center = torch.arange(h.shape[1], device=h.device)[None, :] == predict_idx[:, None]
        h, _ = self.message(h, batch["pos"], batch["adj"], center.to(h.dtype), batch["node_mask"])
        logits = self.logits_at(h, predict_idx, batch["val"])
        support = batch["size_support"]
        ce = masked_cross_entropy(logits, label, support)
        pred = torch.argmax(torch.where(support > 0, logits,
                                        torch.full_like(logits, -float("inf"))), dim=1)
        return {"loss": ce.mean(), "accuracy": (pred == label).to(logits.dtype).mean(),
                "logits": logits}

    @torch.no_grad()
    def check_logits(self, feats: Tensor, vocab: Tensor, size: Tensor, pos: Tensor, adj: Tensor,
                     node_mask: Tensor, pad_idx: Tensor, val: Tensor) -> Tensor:
        """Raw vocab logits (B, V) at a masked node: the device work behind
        check_node (reference: model_refine.py:115-173). The caller masks
        the node (vocab MASK_TOKEN at pad_idx) and restricts the support."""
        h = self.encode(feats, vocab, size, node_mask)
        center = (torch.arange(h.shape[1], device=h.device)[None, :] == pad_idx[:, None])
        h, _ = self.message(h, pos, adj, center.to(h.dtype), node_mask)
        return self.logits_at(h, pad_idx, val)

    @torch.no_grad()
    def check_logp(self, feats: Tensor, vocab: Tensor, size: Tensor, pos: Tensor, adj: Tensor,
                   node_mask: Tensor, pad_idx: Tensor, val: Tensor) -> Tensor:
        """(B, V) log-softmax over the full vocabulary at a masked node."""
        logits = self.check_logits(feats, vocab, size, pos, adj, node_mask, pad_idx, val)
        return masked_log_softmax(logits, torch.ones_like(logits))
