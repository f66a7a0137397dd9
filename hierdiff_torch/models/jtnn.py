"""JT-VAE neural stack: tree-GRU encoder and decoder, atom-level MPN and JTMPN.

Port of ``hierdiff_tpu/models/jtnn.py`` (reference generation/jtnn/
jtnn_enc.py:8, jtnn_dec.py:13, mpn.py:85, jtmpn.py:30, nnutils.py:25). In
the HierDiff pipeline these modules are built but not used at sample time:
the geometry-scored decode of ``chem/reconstruct.py`` replaces the neural
scoring. They are here so that the JT-VAE surface exists as trainable
modules.

- ``TreeGRUCell``: nnutils.GRU over per-node aggregates. It holds the GRU's
  four linears; ``JTNNEncoder`` and ``JTNNDecoder`` are tree-GRUs, so their
  state dicts carry ``W_z`` / ``W_r`` / ``U_r`` / ``W_h`` at the top level,
  as the reference's modules do.
- ``JTNNEncoder``: junction trees are trees, so the directed messages
  h[(x, parent x)] ("up") and h[(parent y, y)] ("down") are per-node
  tensors. The leaf-to-root and root-to-leaf phases run N steps each (no
  host read of the tree's depth), every sample aligned to its own depth.
  Parent rows are gathered with ``ops/gcl.parent_gather`` and children are
  summed onto their parents by a batched product with the parent one-hot:
  both sum in a fixed order forward and backward, so a gradient repeats bit
  for bit on CUDA (a ``scatter_add`` / ``index_add_`` would sum in the order
  of its atomics).
- ``JTNNDecoder``: teacher-forced forward over a host-built DFS trace
  (``build_trace`` == jtnn_dec.dfs), one step per trace edge. Each step reads
  and writes one message slot per tree through indices, never through an
  atomic scatter.
- ``MPN`` / ``JTMPN``: dense masked directed-bond message passing
  (B, A, A, H) with the exclude-reverse-edge subtraction; the featurisation
  (RDKit at call time) is mpn.py's atom / bond one-hots.

Every module takes ``device`` (default CUDA, ``utils/device.py``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor, nn

from hierdiff_torch.ops.gcl import compute_parents, parent_gather, parent_onehot
from hierdiff_torch.ops.graph import bfs_depths
from hierdiff_torch.utils.device import resolve_device


def _to_parents(onehot_parent: Tensor, t: Tensor) -> Tensor:
    """out[b, j] = sum of t[b, n] over the nodes n whose parent is j: a
    batched product with the (B, N, N) parent one-hot, in a fixed order."""
    return torch.bmm(onehot_parent.transpose(1, 2), t)


class TreeGRUCell(nn.Module):
    """nnutils.GRU with per-node aggregate inputs (nnutils.py:25-40):
    z = sigma(W_z [x, sum_h]); r_i = sigma(W_r x + U_r h_i);
    pre = tanh(W_h [x, sum_i r_i h_i]); new_h = (1 - z) sum_h + z pre.
    Callers supply sum_h and the gate-weighted sum, aggregated with the
    subtract-the-target exclusion, which is exactly equivalent."""

    def __init__(self, hidden_size: int, device=None):
        super().__init__()
        h = self.hidden_size = hidden_size
        dev = resolve_device(device)
        self.W_z = nn.Linear(2 * h, h, device=dev)
        self.W_r = nn.Linear(h, h, bias=False, device=dev)
        self.U_r = nn.Linear(h, h, device=dev)
        self.W_h = nn.Linear(2 * h, h, device=dev)

    def gate_term(self, x_emb: Tensor, h_i: Tensor) -> Tensor:
        """sigma(W_r x + U_r h_i) * h_i for one neighbour message."""
        return torch.sigmoid(self.W_r(x_emb) + self.U_r(h_i)) * h_i

    def gru(self, x_emb: Tensor, sum_h: Tensor, sum_gated: Tensor) -> Tensor:
        z = torch.sigmoid(self.W_z(torch.cat([x_emb, sum_h], -1)))
        pre = torch.tanh(self.W_h(torch.cat([x_emb, sum_gated], -1)))
        return (1.0 - z) * sum_h + z * pre

    def forward(self, x_emb: Tensor, sum_h: Tensor, sum_gated: Tensor) -> Tensor:
        return self.gru(x_emb, sum_h, sum_gated)


class JTNNEncoder(TreeGRUCell):
    """Tree-GRU encoder (reference: jtnn_enc.py:8-72).

    Inputs: wids (B, N) vocab ids, adj (B, N, N) 0/1 tree adjacency,
    node_mask (B, N, 1); node 0 is the root (MolTree convention). Returns
    (up, down, root_vecs): up[b, x] = h[(x, parent x)], down[b, y] =
    h[(parent y, y)] (together the 2(N - 1) directed messages of the
    reference's h dict) and root_vecs (B, H)."""

    def __init__(self, vocab_size: int = 780, hidden_size: int = 450, device=None):
        super().__init__(hidden_size, device)
        dev = resolve_device(device)
        self.vocab_size = vocab_size
        self.embedding = nn.Embedding(vocab_size, hidden_size, device=dev)
        self.W = nn.Linear(2 * hidden_size, hidden_size, device=dev)

    def forward(self, wids: Tensor, adj: Tensor, node_mask: Tensor):
        b, n = wids.shape
        mask = node_mask[..., 0]
        adj = adj * (1.0 - torch.eye(n, dtype=adj.dtype, device=adj.device))
        root = torch.zeros((b, n), dtype=adj.dtype, device=adj.device)
        root[:, 0] = 1.0
        depth = bfs_depths(adj, root)                       # (B, N), root 0
        parent = compute_parents(adj, depth)
        onehot = parent_onehot(parent, n, adj.dtype)
        hp = ((depth >= 1) & (mask > 0)).to(adj.dtype)[..., None]   # has a parent
        maxd = torch.where(mask > 0, depth, 0).amax(1)      # (B,)

        emb = self.embedding(wids.clamp(0, self.vocab_size - 1).long()) * node_mask
        emb_parent = parent_gather(emb, parent)

        # up (leaf -> root): up[x] = GRU(emb_x, {up[c]: c a child of x}); step
        # k updates the nodes at depth maxd - k of each sample
        up = torch.zeros((b, n, self.hidden_size), dtype=emb.dtype, device=emb.device)
        for k in range(n):
            am = (depth == (maxd[:, None] - k)).to(adj.dtype)[..., None] * hp
            sum_h = _to_parents(onehot, up * hp)
            sum_g = _to_parents(onehot, self.gate_term(emb_parent, up) * hp)
            up = up * (1 - am) + self.gru(emb, sum_h, sum_g) * am

        # down (root -> leaf): down[y] = GRU(emb_x, nei(x) \ {y}) with
        # x = parent(y) and nei(x) = children(x) + parent(x); step k updates
        # the nodes at depth k + 1
        g_up = self.gate_term(emb_parent, up)
        child_sum = _to_parents(onehot, up * hp)
        gsum_children = parent_gather(_to_parents(onehot, g_up * hp), parent)
        down = torch.zeros_like(up)
        for k in range(n):
            am = (depth == k + 1).to(adj.dtype)[..., None] * hp
            # the aggregates at x = parent(y), without y's own up message and
            # with x's down message (zero for the root)
            sum_at_x = parent_gather(child_sum + down * hp, parent)
            gsum_at_x = gsum_children + parent_gather(self.gate_term(emb, down) * hp, parent)
            new = self.gru(emb_parent, sum_at_x - up, gsum_at_x - g_up)
            down = down * (1 - am) + new * am

        up = up * hp
        down = down * hp
        # the root's aggregate (jtnn_enc.py node_aggregate): its children's up
        sum_root = _to_parents(onehot, up)[:, 0]
        root_vecs = F.relu(self.W(torch.cat([emb[:, 0], sum_root], -1)))
        return up, down, root_vecs


def build_trace(adj: np.ndarray) -> List[Tuple[int, int, int]]:
    """DFS edge trace from node 0: [(x, y, direction)] with each tree edge
    visited forward (1) then backward (0). (reference: jtnn_dec.py:283-289)
    """
    n = adj.shape[0]
    trace: List[Tuple[int, int, int]] = []

    def dfs(x: int, fa: int):
        for y in range(n):
            if adj[x, y] > 0 and y != fa:
                trace.append((x, y, 1))
                dfs(y, x)
                trace.append((y, x, 0))

    dfs(0, -1)
    return trace


def collate_traces(adjs: List[np.ndarray], max_n: int) -> Dict[str, np.ndarray]:
    """Pad per-tree DFS traces into (T, B) step arrays for JTNNDecoder."""
    b = len(adjs)
    traces = [build_trace(a) for a in adjs]
    t_max = max((len(t) for t in traces), default=1)
    x_idx = np.zeros((t_max, b), np.int32)
    y_idx = np.zeros((t_max, b), np.int32)
    direction = np.zeros((t_max, b), np.float32)
    active = np.zeros((t_max, b), np.float32)
    for i, tr in enumerate(traces):
        for t, (x, y, d) in enumerate(tr):
            x_idx[t, i], y_idx[t, i], direction[t, i], active[t, i] = x, y, d, 1.0
    return {"x_idx": x_idx, "y_idx": y_idx, "direction": direction,
            "active": active}


class JTNNDecoder(TreeGRUCell):
    """Teacher-forced tree decoder (reference: jtnn_dec.py:13-188).

    forward(wids, node_mask, trace, mol_vec) -> dict with pred_loss,
    stop_loss, pred_acc, stop_acc (the reference's four outputs) and their
    loss sum. ``trace`` holds ``collate_traces``'s arrays as tensors. The
    greedy neural decode is not built: HierDiff decodes a given tree with
    geometry scoring (jtnn_vae.py:210, the spec_tree path)."""

    def __init__(self, vocab_size: int = 780, hidden_size: int = 450, latent_size: int = 56,
                 device=None):
        super().__init__(hidden_size, device)
        dev = resolve_device(device)
        h = hidden_size
        self.vocab_size, self.latent_size = vocab_size, latent_size
        self.embedding = nn.Embedding(vocab_size, h, device=dev)
        self.W = nn.Linear(h + latent_size, h, device=dev)
        self.U = nn.Linear(2 * h + latent_size, h, device=dev)
        self.W_o = nn.Linear(h, vocab_size, device=dev)
        self.U_s = nn.Linear(h, 1, device=dev)

    def forward(self, wids: Tensor, node_mask: Tensor, trace: Dict[str, Tensor],
                mol_vec: Tensor) -> Dict[str, Tensor]:
        b, n = wids.shape
        h = self.hidden_size
        wids = wids.long()
        emb_all = self.embedding(wids.clamp(0, self.vocab_size - 1)) * node_mask
        x_idx, y_idx = trace["x_idx"].long(), trace["y_idx"].long()
        direction, active = trace["direction"], trace["active"]
        t_max = active.shape[0]
        rows = torch.arange(b, device=wids.device)

        # M[b, z, x] = message z -> x, zero until sent; every directed edge
        # is sent once, so a step writes one slot per tree
        M = torch.zeros((b, n, n, h), dtype=emb_all.dtype, device=emb_all.device)
        new_hs, stop_hiddens = [], []
        for t in range(t_max):
            x, y = x_idx[t], y_idx[t]
            emb_x = emb_all[rows, x]
            # messages into x by source row; unsent ones are zero, so the sum
            # over all N is the sum over the reference's neighbour list
            inc = M[rows, :, x]                              # (B, N, H)
            m_yx = inc[rows, y]                              # message y -> x
            inc_sum = inc.sum(1)
            wr_x = self.W_r(emb_x)
            gated = torch.sigmoid(wr_x[:, None] + self.U_r(inc)) * inc
            sum_g = gated.sum(1) - torch.sigmoid(wr_x + self.U_r(m_yx)) * m_yx
            new_h = self.gru(emb_x, inc_sum - m_yx, sum_g)
            # the stop head sees every neighbour of x, y's message included
            stop_hiddens.append(torch.cat([emb_x, inc_sum, mol_vec], -1))
            new_hs.append(new_h)
            M[rows, x, y] = torch.where(active[t][:, None] > 0, new_h, M[rows, x, y])

        # clique (pred) loss: the root prediction and every forward step
        wid_y = wids.gather(1, y_idx.t()).t()                   # (T, B)
        root_hidden = torch.cat([mol_vec.new_zeros((b, h)), mol_vec], -1)
        step_hidden = torch.cat([torch.stack(new_hs),
                                 mol_vec.expand(t_max, b, mol_vec.shape[-1])], -1)
        pred_hidden = torch.cat([root_hidden[None], step_hidden], 0)
        pred_scores = self.W_o(F.relu(self.W(pred_hidden)))     # (T + 1, B, V)
        pred_targets = torch.cat([wids[None, :, 0], wid_y], 0)
        pred_w = torch.cat([active.new_ones((1, b)), direction * active], 0)
        logp = F.log_softmax(pred_scores, -1)
        pred_loss = -(logp.gather(-1, pred_targets[..., None])[..., 0] * pred_w).sum() / b
        pred_hit = (pred_scores.argmax(-1) == pred_targets).to(pred_w.dtype)
        pred_acc = (pred_hit * pred_w).sum() / pred_w.sum().clamp(min=1.0)

        # stop loss: every trace step and the final stop at the root, with
        # all its incoming messages, target 0
        root_stop = torch.cat([emb_all[:, 0], M[:, :, 0].sum(1), mol_vec], -1)
        stop_hidden = torch.cat([torch.stack(stop_hiddens), root_stop[None]], 0)
        stop_scores = self.U_s(F.relu(self.U(stop_hidden)))[..., 0]   # (T + 1, B)
        stop_targets = torch.cat([direction, direction.new_zeros((1, b))], 0)
        stop_w = torch.cat([active, active.new_ones((1, b))], 0)
        bce = (stop_scores.clamp(min=0) - stop_scores * stop_targets
               + torch.log1p(torch.exp(-stop_scores.abs())))
        stop_loss = (bce * stop_w).sum() / b
        stop_hit = ((stop_scores >= 0).to(stop_w.dtype) == stop_targets).to(stop_w.dtype)
        stop_acc = (stop_hit * stop_w).sum() / stop_w.sum().clamp(min=1.0)
        return {"pred_loss": pred_loss, "stop_loss": stop_loss,
                "pred_acc": pred_acc, "stop_acc": stop_acc,
                "loss": pred_loss + stop_loss}


# --------------------------------------------------------------------------
# atom-level message passing (MPN / JTMPN)
# --------------------------------------------------------------------------

ELEM_LIST = ["C", "N", "O", "S", "F", "Si", "P", "Cl", "Br", "Mg", "Na",
             "Ca", "Fe", "Al", "I", "B", "K", "Se", "Zn", "H", "Cu", "Mn",
             "unknown"]
ATOM_FDIM = len(ELEM_LIST) + 6 + 5 + 4 + 1
BOND_FDIM = 5 + 6


def _onek(x, allowed) -> List[float]:
    if x not in allowed:
        x = allowed[-1]
    return [1.0 if x == s else 0.0 for s in allowed]


def atom_features(atom) -> np.ndarray:
    """(mpn.py:20-25)"""
    aromatic = atom.GetIsAromatic() if hasattr(atom, "GetIsAromatic") else False
    return np.asarray(
        _onek(atom.GetSymbol(), ELEM_LIST)
        + _onek(atom.GetDegree(), [0, 1, 2, 3, 4, 5])
        + _onek(atom.GetFormalCharge(), [-1, -2, 1, 2, 0])
        + _onek(int(atom.GetChiralTag()), [0, 1, 2, 3])
        + [1.0 if aromatic else 0.0], np.float32)


def bond_features(bond) -> np.ndarray:
    """(mpn.py:27-32)"""
    bt = float(bond.GetBondTypeAsDouble())
    stereo = int(bond.GetStereo()) if hasattr(bond, "GetStereo") else 0
    ring = bond.IsInRing()
    return np.asarray(
        [bt == 1.0, bt == 2.0, bt == 3.0, bt == 1.5, bool(ring)]
        + _onek(stereo, [0, 1, 2, 3, 4, 5]), np.float32)


def mol2graph_dense(mols, max_atoms: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Dense padded batch graphs from RDKit mols (or SMILES), as numpy:
    fatoms (B, A, FA), fbonds (B, A, A, FB), bond_mask (B, A, A), atom_mask
    (B, A); mpn.py:34-79's flat 1-indexed bond lists made dense."""
    from hierdiff_torch.chem import require_rdkit
    require_rdkit("MPN featurization")
    from rdkit import Chem

    mols = [Chem.MolFromSmiles(m) if isinstance(m, str) else m for m in mols]
    b = len(mols)
    a_max = max_atoms or max(m.GetNumAtoms() for m in mols)
    fatoms = np.zeros((b, a_max, ATOM_FDIM), np.float32)
    fbonds = np.zeros((b, a_max, a_max, BOND_FDIM), np.float32)
    bond_mask = np.zeros((b, a_max, a_max), np.float32)
    atom_mask = np.zeros((b, a_max), np.float32)
    for i, mol in enumerate(mols):
        na = mol.GetNumAtoms()
        atom_mask[i, :na] = 1.0
        for atom in mol.GetAtoms():
            fatoms[i, atom.GetIdx()] = atom_features(atom)
        for bond in mol.GetBonds():
            x = bond.GetBeginAtom().GetIdx()
            y = bond.GetEndAtom().GetIdx()
            f = bond_features(bond)
            fbonds[i, x, y] = f
            fbonds[i, y, x] = f
            bond_mask[i, x, y] = bond_mask[i, y, x] = 1.0
    return {"fatoms": fatoms, "fbonds": fbonds, "bond_mask": bond_mask,
            "atom_mask": atom_mask}


class MPN(nn.Module):
    """Dense masked directed-bond MPN (reference: mpn.py:85-124).

    The message m[x -> y] lives at [b, x, y]; the depth loop's neighbour sum
    leaves out the reverse edge: sum_z m[z -> x] - m[y -> x]. ``graph``
    holds ``mol2graph_dense``'s arrays as tensors; returns (B, H)."""

    def __init__(self, hidden_size: int = 450, depth: int = 3, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.hidden_size, self.depth = hidden_size, depth
        self.W_i = nn.Linear(ATOM_FDIM + BOND_FDIM, hidden_size, bias=False, device=dev)
        self.W_h = nn.Linear(hidden_size, hidden_size, bias=False, device=dev)
        self.W_o = nn.Linear(ATOM_FDIM + hidden_size, hidden_size, device=dev)

    def _messages(self, graph: Dict[str, Tensor], seed: Optional[Tensor] = None) -> Tensor:
        fatoms, fbonds = graph["fatoms"], graph["fbonds"]
        bm = graph["bond_mask"][..., None]
        # the bond row x -> y carries the source atom's features (mpn.py:56)
        binput = self.W_i(torch.cat(
            [fatoms[:, :, None, :].expand(*fbonds.shape[:3], fatoms.shape[-1]), fbonds], -1))
        message = F.relu(binput) * bm
        seed_in = None if seed is None else seed.sum(1)
        for _ in range(self.depth - 1):
            inc = message.sum(1)                            # (B, A, H) into each atom
            if seed_in is not None:
                inc = inc + seed_in
            # nei[x -> y] = inc[x] - m[y -> x]
            nei = inc[:, :, None, :] - message.transpose(1, 2)
            message = F.relu(binput + self.W_h(nei)) * bm
        return message

    def _readout(self, graph: Dict[str, Tensor], inc: Tensor) -> Tensor:
        atom_h = F.relu(self.W_o(torch.cat([graph["fatoms"], inc], -1)))
        am = graph["atom_mask"][..., None]
        return (atom_h * am).sum(1) / am.sum(1).clamp(min=1.0)

    def forward(self, graph: Dict[str, Tensor]) -> Tensor:
        return self._readout(graph, self._messages(graph).sum(1))


class JTMPN(MPN):
    """Candidate-scoring MPN seeded with junction-tree messages (reference:
    jtmpn.py:30-139: the encoder's tree messages enter the neighbour sums of
    bonds that cross clique boundaries).

    ``tree_seed`` (B, A, A, H): a tree message per atom pair, zero where none
    applies; the caller maps the encoder's messages onto atom pairs through
    the candidate's atom map, in place of the reference's mess_dict
    (jtmpn.py:44-100)."""

    def forward(self, graph: Dict[str, Tensor], tree_seed: Optional[Tensor] = None) -> Tensor:
        inc = self._messages(graph, seed=tree_seed).sum(1)
        if tree_seed is not None:
            inc = inc + tree_seed.sum(1)
        return self._readout(graph, inc)
