"""Edge-denoise model: the fine stage's autoregressive tree-assembly heads.

Port of ``hierdiff_tpu/models/edge_denoise.py`` (``EdgeDenoise``:
embeddings, the full and focal passes, the depth passes, the heads, the
training loss ``forward`` and, for sampling, ``_expand_core``, ``ar_step``
and ``ar_lattice``). Module names are the reference ``Edge_denoise``'s
(models/edge_denoise.py:28-56), so its state dict and the JAX package's
params (``utils/weights.denoise_state_dict_from_flax``) load with
``strict=True``.

Four computations share an E_GCL trunk: a fully connected pass with
evolving edge features, a focal score per discovered node after a pass over
the discovered edges, depth-sequential passes toward the focal node (which
undiscovered node attaches) and toward the new node (its fragment type).

As in the reference's live configuration, the token embedded per node is
its 0/1 discovered flag, not its fragment id (edge_denoise.py:88);
``vocab_conditioning=True`` embeds the ids.

The focal loss keeps the JAX package's fix of a reference bug (PARITY.md,
deliberate divergence #6): the reference's gate sums the focal BCE over
(usually) the first sample of a batch only (edge_denoise.py:124-126 with
split_edges :500-505); here it is summed over every sample that has
discovered edges.

``compute_dtype='bfloat16'`` runs the dense full and focal passes
(``gcl_full_*``, ``gcl_focal_*``) in bf16 (``ops/gcl.py``); the depth passes
(``gcl_edge``, ``gcl_denoise``), the embeddings and the heads stay f32, as
in the JAX package (hierdiff_tpu/models/edge_denoise.py:82-108).

``allowed_bucket`` (B, N) and ``allowed_table`` (K, V) restrict each new
node's type to a support: row ``allowed_bucket[b, target]`` of the table
(``sampling/lattice.build_allowed_arrays``), the size variant's restricted
softmax (reference ar_sampling.py:62-118). Types outside it get a
log-probability of ~NEG_INF, which the searches skip.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import torch
from torch import Tensor, nn

from hierdiff_torch.ops.egnn import resolve_compute_dtype
from hierdiff_torch.ops.gcl import DenseEGCL, coord2radial_dense, compute_parents
from hierdiff_torch.ops.graph import bfs_depths
from hierdiff_torch.ops.masked import (binary_cross_entropy, masked_cross_entropy,
                                       masked_log_softmax, take_rows)

# type candidates per expansion step that leave the device: the beam never
# needs more (the reference expands the top beam_size types,
# ar_sampling_nosize.py:159)
TOP_K = 16


def _margin(scores: Tensor, valid: Tensor) -> Tensor:
    """Best minus runner-up of ``scores`` over the ``valid`` entries of each
    row; inf where fewer than two are valid (no near-tie is possible)."""
    if scores.shape[1] < 2:
        return torch.full(scores.shape[:1], float("inf"), device=scores.device)
    top2 = torch.where(valid, scores, torch.full_like(scores, -float("inf"))).topk(2, dim=1).values
    return torch.where(valid.sum(1) >= 2, top2[:, 0] - top2[:, 1],
                       torch.full_like(top2[:, 0], float("inf")))


class EdgeDenoise(nn.Module):
    """Defaults mirror conf/model/edge_denoise.yaml (``config.EdgeDenoiseConfig``)."""

    def __init__(self, vocab_size: int = 781, out_node_nf: int = 780, in_node_nf: int = 8,
                 hidden_nf: int = 256, n_layers_full: int = 3, n_layers_focal: int = 3,
                 focal_weight: float = 5.0, edge_weight: float = 1.0, node_weight: float = 2.0,
                 vocab_conditioning: bool = False, gated: bool = True,
                 max_depth: Optional[int] = None, max_depth_node: Optional[int] = None,
                 dynamic_depth: bool = False, compute_dtype: Optional[str] = None):
        super().__init__()
        resolve_compute_dtype(compute_dtype)
        self.compute_dtype = compute_dtype
        h = hidden_nf
        self.vocab_size, self.out_node_nf, self.in_node_nf = vocab_size, out_node_nf, in_node_nf
        self.hidden_nf, self.n_layers_full, self.n_layers_focal = h, n_layers_full, n_layers_focal
        self.focal_weight, self.edge_weight = focal_weight, edge_weight
        self.node_weight = node_weight
        self.vocab_conditioning, self.gated = vocab_conditioning, gated
        # depth-loop lengths (None: N). The node pass runs one step more than
        # the edge pass in the reference (edge_denoise.py:227 against :151),
        # which only ungated layers can observe; None: max_depth
        self.max_depth, self.max_depth_node = max_depth, max_depth_node
        # inference: bound each depth loop by the batch's largest BFS depth
        # instead of N - 1 steps; exact under gated=True, where the steps past
        # a sample's depth are no-ops (no active node, so the gate is 0)
        self.dynamic_depth = dynamic_depth
        self.feature_embedding = nn.Linear(in_node_nf, h)
        self.vocab_embedding = nn.Embedding(vocab_size, h)
        self.edge_embedding = nn.Linear(2, h)
        self.node_embedding = nn.Linear(2 * h, h)
        for i in range(n_layers_full):
            setattr(self, f"gcl_full_{i}", DenseEGCL(h, edges_in_d=h, attention=True,
                                                     edge_update=True, gated=gated,
                                                     compute_dtype=compute_dtype))
        for i in range(n_layers_focal):
            setattr(self, f"gcl_focal_{i}", DenseEGCL(h, edges_in_d=h, attention=False,
                                                      edge_update=True, gated=gated,
                                                      compute_dtype=compute_dtype))
        self.gcl_edge = DenseEGCL(h, edges_in_d=1, gated=gated)
        self.gcl_denoise = DenseEGCL(h, edges_in_d=1, gated=gated)
        self.focal_predict = nn.Sequential(nn.Linear(h + 1, h), nn.SiLU(), nn.Linear(h, 1),
                                           nn.Sigmoid())
        self.edge_predict = nn.Sequential(nn.Linear(3 * h + 1, h), nn.SiLU(), nn.Linear(h, 1))
        self.node_predict = nn.Sequential(nn.Linear(h, h), nn.SiLU(), nn.Linear(h, out_node_nf))

    def clone(self, **changes) -> "EdgeDenoise":
        """A view of this model with other settings (``dynamic_depth``,
        ``compute_dtype``) that shares its parameters."""
        view = copy.copy(self)
        for name, value in changes.items():
            setattr(view, name, value)
        if "compute_dtype" in changes:
            resolve_compute_dtype(view.compute_dtype)
            # the dense layers as views too: their own dtype, the same parameters
            view._modules = dict(self._modules)
            for name in ([f"gcl_full_{i}" for i in range(self.n_layers_full)]
                         + [f"gcl_focal_{i}" for i in range(self.n_layers_focal)]):
                layer = copy.copy(self._modules[name])
                layer.compute_dtype = view.compute_dtype
                view._modules[name] = layer
        return view

    # --- shared trunk --------------------------------------------------------

    def embed_nodes(self, feats: Tensor, discovered: Tensor, vocab_idx: Tensor) -> Tensor:
        """h = node_embedding([feature_emb, token_emb]). (reference: edge_denoise.py:87-93)"""
        token = vocab_idx if self.vocab_conditioning else discovered
        h_f = self.feature_embedding(feats[..., :self.in_node_nf])
        h_v = self.vocab_embedding(token.long())
        return self.node_embedding(torch.cat([h_f, h_v], dim=-1))

    def full_mp(self, h: Tensor, x: Tensor, search_adj: Tensor, node_mask: Tensor,
                edge_mask: Tensor):
        """Fully connected pass with evolving edge features.
        (reference: edge_denoise.py:98-110)"""
        radial, _ = coord2radial_dense(x)
        ef = self.edge_embedding(torch.cat([radial, search_adj[..., None]], dim=-1))
        em = edge_mask[..., None]
        for i in range(self.n_layers_full):
            h, x, ef = getattr(self, f"gcl_full_{i}")(h, x, em, edge_attr=ef, node_mask=node_mask)
        return h, x, ef

    def focal_mp(self, h: Tensor, x: Tensor, ef_full: Tensor, search_adj: Tensor,
                 node_mask: Tensor):
        """Pass over the discovered edges, edge features from the full pass.
        (reference: edge_denoise.py:114-122)"""
        dm = search_adj[..., None]
        ef = ef_full * dm
        for i in range(self.n_layers_focal):
            h, x, ef = getattr(self, f"gcl_focal_{i}")(h, x, dm, edge_attr=ef,
                                                       node_mask=node_mask)
        return h, x

    def depth_mp(self, layer: DenseEGCL, h: Tensor, x: Tensor, adj: Tensor,
                 target_onehot: Tensor, node_mask: Tensor, n_steps: int):
        """Depth-sequential pass toward ``target``: the circle layer (a self
        loop on node 0), then the BFS layers deepest first, step k taking each
        sample's layer at depth maxdepth_i - k (the reference aligns the
        samples' layer lists by position, dataset_denoise.py:396-410).
        (reference: edge_denoise.py:151-156, 196-200)

        Static: n_steps - 1 steps after the circle layer. Dynamic (gated
        only): as many as the batch's largest depth, which costs one host read
        of that depth per call (two per lattice step); the steps it leaves out
        are exact no-ops, so both give the same bits."""
        b, n = adj.shape[:2]
        depth = bfs_depths(adj, target_onehot)
        parent = compute_parents(adj, depth)
        maxd = depth.max(dim=1).values                       # (B,)
        idx = torch.arange(n, device=adj.device)
        h, x = layer.tree_pass(h, x, idx.expand(b, n), (idx == 0).expand(b, n), node_mask)
        steps = n_steps - 1
        if self.dynamic_depth and self.gated:
            steps = min(int(maxd.max()), steps)
        for k in range(steps):
            d = (maxd - k)[:, None]
            active = (depth == d) & (d >= 1)
            h, x = layer.tree_pass(h, x, parent, active, node_mask)
        return h, x

    # --- heads ---------------------------------------------------------------

    def focal_scores(self, h: Tensor, val: Tensor) -> Tensor:
        """(B, N) sigmoid focal probability. (reference: edge_denoise.py:124)"""
        return self.focal_predict(torch.cat([h, val[..., None]], dim=-1))[..., 0]

    def edge_logits(self, h: Tensor, x: Tensor, ef_full: Tensor, focal_idx: Tensor) -> Tensor:
        """(B, N) attachment scores for (focal -> candidate).
        (reference: edge_denoise.py:157-169)"""
        b, n, hd = h.shape
        h_focal = take_rows(h, focal_idx)[:, None].expand(b, n, hd)
        x_focal = take_rows(x, focal_idx)[:, None]
        edge_focal = take_rows(ef_full, focal_idx)           # (B, N, H): ef[focal, :]
        d2 = ((x - x_focal) ** 2).sum(-1, keepdim=True)
        return self.edge_predict(torch.cat([h_focal, edge_focal, h, d2], dim=-1))[..., 0]

    def node_logits(self, h: Tensor, idx: Tensor) -> Tensor:
        """(B, V) fragment-type logits at node ``idx``. (reference: edge_denoise.py:203-205)"""
        return self.node_predict(take_rows(h, idx))

    # --- training loss -------------------------------------------------------

    def forward(self, batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """The three losses of one training batch (``data/denoise.py``) and
        their accuracies; ``total_loss`` is their weighted sum over the batch
        size. (hierdiff_tpu/models/edge_denoise.py:235-307; reference:
        edge_denoise.py:124-234)"""
        return self.loss_terms(batch)[0]

    def loss_terms(self, batch: Dict[str, Tensor]
                   ) -> Tuple[Dict[str, Tensor], Dict[str, Tuple[Tensor, Tensor]]]:
        """``forward``'s outputs, and the two accuracies that divide by a
        count of valid rows as (hits, valid rows): ``focal_accuracy`` over
        the samples with discovered edges, ``edge_accuracy`` over the steps
        past the root. A data-parallel step sums each part over ranks.

        focal: BCE of the focal score over the discovered nodes, averaged
        over them and summed over the samples with discovered edges; edge:
        CE of the attachment over the undiscovered nodes, at steps past the
        root; node: CE of the new node's type over the whole vocabulary or
        ``allowed_mask``. The depth passes run their static length."""
        feats, discovered, x = batch["feats"], batch["discovered"], batch["pos"]
        node_mask, edge_mask = batch["node_mask"], batch["edge_mask"]
        search_adj = batch["search_adj"]             # discovered edges only
        focal_label = batch["focal_label"]           # (B, N) 0/1
        undiscovered = batch["undiscovered"]         # (B, N) 0/1
        predict_idx = batch["predict_idx"].long()    # (B,)
        last_ind = batch["last_ind"].long()          # (B,), -1 at the root step
        label = batch["label"].long()                # (B,)
        allowed = batch.get("allowed_mask")          # (B, V) or None
        b, n = feats.shape[:2]
        idx = torch.arange(n, device=feats.device)
        neg_inf = torch.tensor(-float("inf"), device=feats.device)

        h = self.embed_nodes(feats, discovered, batch["vocab_idx"]) * node_mask
        val = search_adj.sum(-1)                     # degrees (B, N)
        h, x, ef_full = self.full_mp(h, x, search_adj, node_mask, edge_mask)

        # ---- focal
        has_edges = search_adj.sum((1, 2)) > 0
        hf, xf = self.focal_mp(h, x, ef_full, search_adj, node_mask)
        scores = self.focal_scores(hf, val)
        cand = discovered.to(scores.dtype)
        bce = binary_cross_entropy(scores, focal_label.to(scores.dtype)) * cand
        n_cand = torch.clamp(cand.sum(1), min=1.0)
        focal_valid = has_edges.to(scores.dtype)
        focal_loss = (bce.sum(1) / n_cand * focal_valid).sum()
        top = torch.argmax(torch.where(cand > 0, scores, neg_inf), dim=1)
        hit = torch.gather(focal_label, 1, top[:, None])[:, 0]
        focal_parts = ((hit * focal_valid).sum(), focal_valid.sum())
        focal_acc = focal_parts[0] / torch.clamp(focal_parts[1], min=1e-8)

        # ---- edge: which undiscovered node attaches to the last one
        last_onehot = (idx[None] == last_ind[:, None]).to(feats.dtype)
        he, xe = self.depth_mp(self.gcl_edge, hf, xf, search_adj, last_onehot, node_mask,
                               self.max_depth or n)
        e_logits = self.edge_logits(he, xe, ef_full, last_ind)
        edge_valid = ((predict_idx != 0) & (last_ind >= 0)).to(e_logits.dtype)
        edge_loss = (masked_cross_entropy(e_logits, predict_idx, undiscovered) * edge_valid).sum()
        e_pred = torch.argmax(torch.where(undiscovered > 0, e_logits, neg_inf), dim=1)
        edge_parts = (((e_pred == predict_idx).to(e_logits.dtype) * edge_valid).sum(),
                      edge_valid.sum())
        edge_acc = edge_parts[0] / torch.clamp(edge_parts[1], min=1e-8)

        # ---- node type: a pass over search_adj plus the (last, predict) edge
        add = last_onehot[:, :, None] * (idx[None, None, :] == predict_idx[:, None, None])
        search_adj_pad = (search_adj + add + add.transpose(1, 2)).clamp(0, 1)
        pred_onehot = (idx[None] == predict_idx[:, None]).to(feats.dtype)
        hn, _ = self.depth_mp(self.gcl_denoise, he, xe, search_adj_pad, pred_onehot, node_mask,
                              self.max_depth_node or self.max_depth or n)
        n_logits = self.node_logits(hn, predict_idx)
        support = allowed if allowed is not None else torch.ones_like(n_logits)
        node_loss = masked_cross_entropy(n_logits, label, support).sum()
        n_pred = torch.argmax(torch.where(support > 0, n_logits, neg_inf), dim=1)
        node_acc = (n_pred == label).to(n_logits.dtype).mean()

        total = (self.focal_weight * focal_loss + self.edge_weight * edge_loss
                 + self.node_weight * node_loss) / b
        return ({"total_loss": total,
                 "focal_loss": focal_loss / b, "focal_accuracy": focal_acc,
                 "edge_loss": edge_loss / b, "edge_accuracy": edge_acc,
                 "node_loss": node_loss / b, "node_accuracy": node_acc},
                {"focal_accuracy": focal_parts, "edge_accuracy": edge_parts})

    # --- autoregressive sampling ---------------------------------------------

    def _expand_core(self, feats: Tensor, disc_flag: Tensor, vocab_idx: Tensor, pos: Tensor,
                     adj_clean: Tensor, node_mask: Tensor,
                     allowed_bucket: Optional[Tensor] = None,
                     allowed_table: Optional[Tensor] = None):
        """One expansion of B padded tree states: the focal node (argmax over
        the discovered), the attached node (argmax over the undiscovered) and
        the top-k types of the new node. (reference: edge_denoise.py:250-419)

        disc_flag (B, N) int 0/1. allowed_bucket (B, N) int and allowed_table
        (K, V): the new node's type support is the table's row at its bucket
        (None: the whole vocabulary). Returns (outputs, new_adj, new_disc). Besides
        the JAX package's outputs, ``focal_margin`` and ``target_margin`` hold
        the gap between the best and the runner-up candidate of each choice,
        which says how near a tie the argmax was."""
        b, n = feats.shape[:2]
        dev = feats.device
        idx = torch.arange(n, device=dev)
        nm = node_mask[:, :, 0]
        edge_mask_fc = (1.0 - torch.eye(n, device=dev))[None] * (nm[:, :, None] * nm[:, None, :])
        is_disc = (disc_flag > 0) & (nm > 0)
        is_undisc = (disc_flag == 0) & (nm > 0)
        val = adj_clean.sum(-1)
        neg_inf = torch.tensor(-float("inf"), device=dev)

        h = self.embed_nodes(feats, disc_flag, vocab_idx) * node_mask
        h, x, ef_full = self.full_mp(h, pos, adj_clean, node_mask, edge_mask_fc)
        any_disc = is_disc.any(1)

        # focal: argmax of the sigmoid score over the discovered (reference: :300-323)
        hf, xf = self.focal_mp(h, x, ef_full, adj_clean, node_mask)
        scores = self.focal_scores(hf, val)
        focal = torch.argmax(torch.where(is_disc, scores, neg_inf), dim=1)
        focal = torch.where(any_disc, focal, torch.full_like(focal, -1))   # root step: none

        # attach: depth pass toward the focal node, then argmax over the undiscovered
        focal_onehot = ((idx[None] == focal[:, None]) & any_disc[:, None]).to(feats.dtype)
        he, xe = self.depth_mp(self.gcl_edge, hf, xf, adj_clean, focal_onehot, node_mask,
                               self.max_depth or n)
        e_logits = self.edge_logits(he, xe, ef_full, focal.clamp(min=0))
        target = torch.argmax(torch.where(is_undisc, e_logits, neg_inf), dim=1)
        do_attach = any_disc & is_undisc.any(1)
        target = torch.where(do_attach, target, torch.zeros_like(target))   # root: node 0

        att = (focal_onehot[:, :, None] * (idx[None, None, :] == target[:, None, None])
               * do_attach[:, None, None])
        new_adj = (adj_clean + att + att.transpose(1, 2)).clamp(0, 1)
        t_onehot = idx[None] == target[:, None]
        new_disc = (disc_flag + t_onehot).clamp(0, 1).to(disc_flag.dtype)

        # type: depth pass toward the new node over the grown graph
        hn, _ = self.depth_mp(self.gcl_denoise, he, xe, new_adj, t_onehot.to(feats.dtype),
                              node_mask, self.max_depth or n)
        logits = self.node_logits(hn, target)
        if allowed_bucket is not None and allowed_table is not None:
            # the restricted, renormalised softmax over the new node's support
            # (ar_sampling.py:158-159, LogSoftmax over array_inds)
            bkt = torch.gather(allowed_bucket.long(), 1, target[:, None])[:, 0]
            support = allowed_table[bkt]
        else:
            support = torch.ones_like(logits)
        logp = masked_log_softmax(logits, support)
        # the k best, ties in index order as jax.lax.top_k (torch.topk does
        # not order ties)
        k = min(TOP_K, logp.shape[-1])
        top_logp, top_wid = torch.sort(logp, dim=-1, descending=True, stable=True)
        out = {"focal": focal, "target": target, "top_logp": top_logp[..., :k],
               "top_wid": top_wid[..., :k], "did_attach": do_attach,
               "focal_margin": _margin(scores, is_disc),
               "target_margin": _margin(e_logits, is_undisc)}
        return out, new_adj, new_disc

    @torch.no_grad()
    def ar_step(self, feats: Tensor, discovered: Tensor, vocab_idx: Tensor, pos: Tensor,
                adj: Tensor, node_mask: Tensor, allowed_bucket: Optional[Tensor] = None,
                allowed_table: Optional[Tensor] = None) -> Dict[str, Tensor]:
        """One batched expansion of B tree states. adj may carry the root
        marker self-loop at (0, 0); discovery is read from its row sums before
        the diagonal is stripped. ``discovered`` is unused, as in the JAX
        package. The support as ``_expand_core``'s.
        (reference: ar_sampling_nosize.py:196-202)"""
        n = feats.shape[1]
        disc_flag = (adj.sum(-1) > 0).to(torch.int32)
        adj_clean = adj * (1.0 - torch.eye(n, device=adj.device))[None]
        return self._expand_core(feats, disc_flag, vocab_idx, pos, adj_clean, node_mask,
                                 allowed_bucket, allowed_table)[0]

    @torch.no_grad()
    def ar_lattice(self, feats: Tensor, pos: Tensor, node_mask: Tensor,
                   allowed_bucket: Optional[Tensor] = None,
                   allowed_table: Optional[Tensor] = None) -> Dict[str, Tensor]:
        """All N expansion steps of a batch, from the empty tree.

        Without vocab conditioning the focal and attach choices, so the whole
        growth trajectory, do not depend on the types the beam picks: one
        run yields every step's choices and top-k types for the host search.
        The support as ``_expand_core``'s. Returns each output stacked as
        (B, N_steps, ...)."""
        if self.vocab_conditioning:
            raise ValueError("ar_lattice needs a type-independent trajectory; "
                             "vocab_conditioning=True needs the round-based sampler")
        b, n = feats.shape[:2]
        adj = torch.zeros((b, n, n), dtype=feats.dtype, device=feats.device)
        disc = torch.zeros((b, n), dtype=torch.int32, device=feats.device)
        steps = []
        for _ in range(n):
            out, adj, disc = self._expand_core(feats, disc, disc, pos, adj, node_mask,
                                               allowed_bucket, allowed_table)
            steps.append(out)
        return {k: torch.stack([s[k] for s in steps], dim=1) for k in steps[0]}
