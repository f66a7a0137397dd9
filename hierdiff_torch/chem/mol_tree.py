"""Junction-tree data model: Vocab, MolTreeNode, MolTree.

Rebuild of data_utils/mol_tree.py. The Vocab works WITHOUT RDKit for
everything the device pipeline needs (indices, fingerprints, heavy-atom
sizes come from the bundled fingerprint table whose column 3 is the atom
count); RDKit unlocks slots/mols/decomposition.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from hierdiff_torch.chem import has_rdkit, require_rdkit
from hierdiff_torch.data.assets import load_vocab_fps, load_vocab_smiles


class Vocab:
    """Fragment vocabulary. (reference: data_utils/mol_tree.py:76-109)"""

    def __init__(self, smiles_list: Optional[Sequence[str]] = None,
                 fp_table: Optional[Dict[str, np.ndarray]] = None, mode: str = "prop"):
        self.vocab = list(smiles_list) if smiles_list is not None else list(load_vocab_smiles())
        self.vmap = {s: i for i, s in enumerate(self.vocab)}
        fps = fp_table if fp_table is not None else load_vocab_fps(mode)
        self.fps = [np.asarray(fps[s]) for s in self.vocab]
        # prop-mode column 3 is the heavy-atom count; recompute via RDKit
        # when a custom table lacks it
        if mode == "prop" and self.fps[0].shape[0] >= 4:
            self.mol_sizes = [int(round(fp[3])) for fp in self.fps]
        elif has_rdkit():
            from rdkit import Chem
            self.mol_sizes = [Chem.MolFromSmiles(s).GetNumHeavyAtoms() for s in self.vocab]
        else:
            self.mol_sizes = [int(round(fp.sum())) for fp in self.fps]  # elem bag sum
        self._slots = None

    def get_index(self, smiles: str) -> int:
        return self.vmap[smiles]

    def get_smiles(self, idx: int) -> str:
        return self.vocab[idx]

    def get_fp(self, smiles: str) -> np.ndarray:
        return self.fps[self.vmap[smiles]]

    def get_size(self, size: int) -> List[int]:
        return [i for i, s in enumerate(self.mol_sizes) if s == size]

    def get_array(self, array: np.ndarray) -> List[int]:
        return [i for i, fp in enumerate(self.fps) if np.array_equal(fp, array)]

    def get_slots(self, idx: int):
        """(symbol, charge, numHs) per atom — RDKit-backed, cached."""
        require_rdkit("vocabulary slots")
        from rdkit import Chem
        if self._slots is None:
            self._slots = [None] * len(self.vocab)
        if self._slots[idx] is None:
            mol = Chem.MolFromSmiles(self.vocab[idx])
            self._slots[idx] = [(a.GetSymbol(), a.GetFormalCharge(), a.GetTotalNumHs())
                                for a in mol.GetAtoms()]
        return list(self._slots[idx])

    def size(self) -> int:
        return len(self.vocab)


class MolTreeNode:
    """(reference: data_utils/mol_tree.py:111-155)"""

    def __init__(self, smiles: str, pos, clique=(), vocab: Optional[Vocab] = None,
                 hbd: Optional[float] = None):
        self.smiles = smiles
        self.mol = None
        if has_rdkit():
            from hierdiff_torch.chem.chemutils import get_mol
            self.mol = get_mol(smiles)
        self.wid = None
        self.fp = None
        if vocab is not None:
            self.fp = vocab.get_fp(smiles)
            self.wid = vocab.get_index(smiles)
        self.clique = list(clique)
        self.neighbors: List = []
        self.pos = pos
        self.hbd = hbd
        self.nid = None
        self.idx = None
        self.is_leaf = False

    def add_neighbor(self, nei):
        self.neighbors.append(nei)


class BlurNode:
    """Unexpanded blur node: features + position only; wid=None marks it.
    (reference: data_utils/mol_tree.py:157-167 MolTreeNode_blur)"""

    def __init__(self, fp, pos, size: int = 0):
        self.fp = fp
        self.wid = None
        self.neighbors: List = []
        self.pos = pos
        self.size = size

    def add_neighbor(self, nei):
        self.neighbors.append(nei)


class MolTree:
    """Junction tree: from an RDKit mol (preprocessing) or from explicit
    nodes + edges (reconstruction). (reference: data_utils/mol_tree.py:170-269)
    """

    def __init__(self, mol=None, nodes: Optional[List] = None, edge_index=None,
                 vocab: Optional[Vocab] = None):
        if mol is not None:
            self._from_mol(mol, vocab)
        elif nodes is not None:
            self._from_nodes(nodes, edge_index)
        else:
            raise ValueError("MolTree needs a mol or a node list")

    def _from_mol(self, mol, vocab):
        require_rdkit("tree decomposition")
        from rdkit import Chem

        from hierdiff_torch.chem.chemutils import get_clique_mol, get_smiles, set_atommap, tree_decomp

        self.smiles = Chem.MolToSmiles(mol)
        self.mol3D = Chem.RemoveHs(mol)
        Chem.Kekulize(self.mol3D)

        cliques, edges = tree_decomp(self.mol3D)
        self.adj_matrix = np.zeros((len(cliques), len(cliques)))
        self.nodes = []
        root = 0
        hydro_start = ("O", "N", "S", "P")
        for i, c in enumerate(cliques):
            # H-bond-donor count of the clique (mol_tree.py:186-192)
            node_hbd = 0
            for atom_idx in c:
                atom = self.mol3D.GetAtomWithIdx(atom_idx)
                if atom.GetSymbol() in hydro_start:
                    node_hbd += atom.GetTotalNumHs()
            cmol = get_clique_mol(self.mol3D, c)
            try:
                node_pos = np.mean([np.array(self.mol3D.GetConformer().GetAtomPosition(x))
                                    for x in c], axis=0)
            except Exception:
                node_pos = np.zeros(3)
            node = MolTreeNode(get_smiles(cmol), node_pos, c, vocab=vocab, hbd=node_hbd)
            self.nodes.append(node)
            if min(c) == 0:
                root = i

        for x, y in edges:
            self.nodes[x].add_neighbor(self.nodes[y])
            self.nodes[y].add_neighbor(self.nodes[x])
            self.adj_matrix[x, y] = self.adj_matrix[y, x] = 1

        # root = clique containing atom 0, swapped to index 0
        if root > 0:
            self.nodes[0], self.nodes[root] = self.nodes[root], self.nodes[0]
            self.adj_matrix[[0, root], :] = self.adj_matrix[[root, 0], :]
            self.adj_matrix[:, [0, root]] = self.adj_matrix[:, [root, 0]]

        for i, node in enumerate(self.nodes):
            node.nid = i + 1
            if len(node.neighbors) > 1:
                set_atommap(node.mol, node.nid)
            node.is_leaf = len(node.neighbors) == 1

    def _from_nodes(self, nodes, edge_index):
        self.nodes = nodes
        for i, n in enumerate(self.nodes):
            n.idx = i
        n = len(nodes)
        self.adj_matrix = np.zeros((n, n))
        self.decode_adj_matrix = np.zeros((n, n))
        if edge_index is not None:
            seen = set()
            for ind in range(len(edge_index[0])):
                i, j = int(edge_index[0][ind]), int(edge_index[1][ind])
                self.adj_matrix[i, j] = self.adj_matrix[j, i] = 1
                if (i, j) not in seen:
                    self.nodes[i].add_neighbor(self.nodes[j])
                    seen.add((i, j))
                if (j, i) not in seen:
                    self.nodes[j].add_neighbor(self.nodes[i])
                    seen.add((j, i))

    def add_node(self, node, link_index=None):
        """(reference: mol_tree.py:243-259)"""
        if link_index is not None:
            for i in link_index:
                self.nodes[i].add_neighbor(node)
                node.add_neighbor(self.nodes[i])
            k = len(self.nodes)
            new_adj = np.zeros((k + 1, k + 1))
            new_adj[:k, :k] = self.adj_matrix
            new_dec = np.zeros((k + 1, k + 1))
            new_dec[:k, :k] = self.decode_adj_matrix
            for i in link_index:
                new_adj[-1, i] = new_adj[i, -1] = 1
                new_dec[i, -1] = 1
            self.adj_matrix = new_adj
            self.decode_adj_matrix = new_dec
        self.nodes.append(node)

    def add_edge(self, i, j):
        self.adj_matrix[i, j] = self.adj_matrix[j, i] = 1
        self.nodes[i].add_neighbor(self.nodes[j])
        self.nodes[j].add_neighbor(self.nodes[i])
        self.decode_adj_matrix[i, j] = 1

    def size(self) -> int:
        return len(self.nodes)
