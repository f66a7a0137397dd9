"""Geometry-scored junction-tree reconstruction (stage 3).

Rebuild of the reference's modified JT-VAE decode path
(generation/jtnn/jtnn_vae.py:200-372): given a fully assigned junction tree
with 3D fragment centers, recursively enumerate chemically valid attachments
(enum_assemble) and pick, at every tree node, the candidate whose embedded
(ETKDG + MMFF) fragment-center geometry best matches the generated centers
(negative Kabsch RMSD), with best-first backtracking and the reference's
'max9' embedding-failure sentinel. Entirely host-side RDKit; intended to run
under a process pool overlapping device compute.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence, Tuple

import numpy as np

from hierdiff_torch.chem import require_rdkit
from hierdiff_torch.chem.geometry import kabsch_rmsd


def get_pos_from_cand(mol3d, node_mol, map_num: int) -> Optional[np.ndarray]:
    """Mean 3D position of ``node_mol``'s match inside the embedded candidate
    (bond orders flattened to single for substructure matching).
    (reference: jtnn_vae.py:30-46)"""
    require_rdkit("candidate geometry scoring")
    from rdkit import Chem

    mol_blank = copy.deepcopy(mol3d)
    node_blank = copy.deepcopy(node_mol)
    for b in mol_blank.GetBonds():
        b.SetBondType(Chem.BondType.SINGLE)
    for b in node_blank.GetBonds():
        b.SetBondType(Chem.BondType.SINGLE)
    matches = mol_blank.GetSubstructMatches(node_blank)
    if len(matches) == 1:
        return np.mean([np.array(mol3d.GetConformer().GetAtomPosition(i)) for i in matches[0]], axis=0)
    for m in matches:
        for atom_idx in m:
            if mol3d.GetAtoms()[atom_idx].GetAtomMapNum() == map_num:
                return np.mean([np.array(mol3d.GetConformer().GetAtomPosition(i)) for i in m], axis=0)
    return None


def search_mcs(mol, smi_list: Sequence[str]) -> List[int]:
    """Indices of most-MCS-similar vocabulary SMILES. (jtnn_vae.py:374-381)"""
    require_rdkit("MCS search")
    from rdkit import Chem
    from rdkit.Chem import rdFMCS

    Chem.Kekulize(mol)
    orig = Chem.MolToSmiles(mol, kekuleSmiles=True)
    sims = [rdFMCS.FindMCS([mol, Chem.MolFromSmiles(s)]).numAtoms for s in smi_list]
    best = max(sims)
    return [i for i, s in enumerate(sims) if s == best and smi_list[i] != orig]


def get_similar(smiles: str, vocab, mode: str = "all") -> List[str]:
    """Vocabulary fragments with the same heavy-atom count.
    (jtnn_vae.py:384-395)"""
    require_rdkit("similar-fragment lookup")
    from rdkit import Chem

    n = Chem.MolFromSmiles(smiles).GetNumAtoms()
    remain = [s for i, s in enumerate(vocab.vocab) if vocab.mol_sizes[i] == n]
    if mode == "substructure":
        idx = search_mcs(Chem.MolFromSmiles(smiles), remain)
        return [remain[i] for i in idx]
    return remain


class TreeReconstructor:
    """Assemble an RDKit molecule from a decoded junction tree.

    Usage: ``reconstruct(tree)`` where tree.nodes are MolTreeNode with
    .smiles/.mol/.pos/.neighbors. Returns (mol, amap, canonical_smiles),
    'max9' on embedding failure, or None when no assembly is valid.
    """

    def __init__(self, vocab, embed_seed: int = -1, max_nodes: int = 100,
                 memoize: bool = False, memo_cap: int = 200_000):
        """memoize=True caches (a) ``enum_assemble`` candidate lists and (b)
        embedded fragment-center geometries across reconstructions, keyed by
        the atom-mapped candidate SMILES + the involved (nid, smiles) pairs.
        The geometry cache changes behavior only through ETKDG's embedding
        randomness (one embedding reused where the reference would redraw) —
        a distribution-level shortcut, so it is OPT-IN and defaults to the
        reference-exact path (cf. the project's inference-shortcut rule).
        Deterministic backends (fixed seed / the CI fake-RDKit stub) are
        bit-identical with the memo on (tests/test_fake_chem.py)."""
        require_rdkit("tree reconstruction")
        self.vocab = vocab
        self.embed_seed = embed_seed
        self.max_nodes = max_nodes
        self.memoize = memoize
        self.memo_cap = memo_cap
        self._enum_cache: dict = {}
        self._geom_cache: dict = {}
        self.memo_stats = {"enum_hits": 0, "enum_misses": 0,
                           "geom_hits": 0, "geom_misses": 0}

    def reconstruct(self, tree):
        """(reference: jtnn_vae.py:200-245 sample_tree/decode)"""
        from rdkit import Chem

        from hierdiff_torch.chem.chemutils import copy_edit_mol, set_atommap

        nodes = list(tree.nodes)
        if len(nodes) >= self.max_nodes:
            return "max9"
        for i, node in enumerate(nodes):
            node.nid = i + 1
            node.idx = i
            node.is_leaf = len(node.neighbors) == 1
            node.wid = self.vocab.get_index(node.smiles)
            set_atommap(node.mol, node.nid)
        root = nodes[0]

        cur_mol = copy_edit_mol(Chem.MolFromSmiles(root.smiles))
        global_amap = [{}] + [{} for _ in nodes]
        global_amap[1] = {atom.GetIdx(): atom.GetIdx() for atom in cur_mol.GetAtoms()}

        result = self._dfs_assemble(nodes, cur_mol, global_amap, [], root, None)
        if result is None:
            return None
        if result == "max9":
            return "max9"
        cur_mol, amap = result
        set_atommap(cur_mol)
        smi_mol = Chem.MolFromSmiles(Chem.MolToSmiles(cur_mol))
        return cur_mol.GetMol(), amap, smi_mol

    def _fragment_centers(self, cand_mol, involved) -> Optional[dict]:
        """Embed the candidate (ETKDG + MMFF) and extract the per-nid
        fragment centers — the geometry-only, generated-position-independent
        half of the score. (jtnn_vae.py:308-322)"""
        from rdkit import Chem
        from rdkit.Chem import AllChem

        if self.memoize:
            key = (Chem.MolToSmiles(cand_mol),
                   tuple((n.nid, n.smiles) for n in involved))
            if key in self._geom_cache:
                self.memo_stats["geom_hits"] += 1
                return self._geom_cache[key]
            self.memo_stats["geom_misses"] += 1

        node_pos: Optional[dict] = None
        cand3d = Chem.AddHs(cand_mol)
        try:
            AllChem.EmbedMolecule(cand3d, AllChem.ETKDG())
            AllChem.MMFFOptimizeMolecule(cand3d)
        except Exception:
            cand3d = None
        if cand3d is not None and cand3d.GetNumConformers() > 0:
            cand3d = Chem.RemoveHs(cand3d)
            node_pos = {}
            for node in involved:
                p = get_pos_from_cand(cand3d, node.mol, node.nid)
                if p is None:
                    node_pos = None
                    break
                node_pos[node.nid] = p
        if self.memoize and len(self._geom_cache) < self.memo_cap:
            self._geom_cache[key] = node_pos
        return node_pos

    def _embed_score(self, cand_mol, cur_node, neighbors) -> Optional[float]:
        """-kabsch_rmsd(candidate fragment centers, generated centers), or
        None if embedding/matching fails. (jtnn_vae.py:308-327)"""
        involved = [cur_node] + list(neighbors)
        node_pos = self._fragment_centers(cand_mol, involved)
        if node_pos is None:
            return None
        truth = {n.idx: np.asarray(n.pos).reshape(3) for n in involved}
        cand_xyz = np.stack([p for _, p in sorted(node_pos.items())])
        true_xyz = np.stack([p for _, p in sorted(truth.items())])
        return -kabsch_rmsd(cand_xyz, true_xyz, translate=True)

    def _dfs_assemble(self, all_nodes, cur_mol, global_amap, fa_amap, cur_node, fa_node):
        """(reference: jtnn_vae.py:266-372)"""
        from rdkit import Chem

        from hierdiff_torch.chem.chemutils import attach_mols, enum_assemble

        fa_nid = fa_node.nid if fa_node is not None else -1
        prev_nodes = [fa_node] if fa_node is not None else []

        children = [nei for nei in cur_node.neighbors if nei.nid != fa_nid]
        neighbors = sorted([n for n in children if n.mol.GetNumAtoms() > 1],
                           key=lambda x: x.mol.GetNumAtoms(), reverse=True)
        neighbors = [n for n in children if n.mol.GetNumAtoms() == 1] + neighbors

        cur_amap = [(fa_nid, a2, a1) for nid, a1, a2 in fa_amap if nid == cur_node.nid]
        if self.memoize:
            ekey = ((cur_node.nid, cur_node.smiles),
                    tuple((n.nid, n.smiles) for n in neighbors),
                    tuple((p.nid, p.smiles) for p in prev_nodes),
                    tuple(cur_amap))
            cands = self._enum_cache.get(ekey)
            if cands is None:
                self.memo_stats["enum_misses"] += 1
                cands = enum_assemble(cur_node, neighbors, prev_nodes, cur_amap)
                if len(self._enum_cache) < self.memo_cap:
                    self._enum_cache[ekey] = cands
            else:
                self.memo_stats["enum_hits"] += 1
        else:
            cands = enum_assemble(cur_node, neighbors, prev_nodes, cur_amap)
        if len(cands) == 0:
            # dead branch tolerated like the reference (jtnn_vae.py:296-297)
            return cur_mol, global_amap
        cand_smiles, cand_mols, cand_amap = zip(*cands)

        scores = np.zeros(len(cand_mols))
        for i, cm in enumerate(cand_mols):
            s = self._embed_score(cm, cur_node, neighbors)
            if s is not None:
                scores[i] = s
        if scores.sum() == 0:
            return "max9"
        order = np.argsort(-scores)

        backup = Chem.RWMol(cur_mol)
        for ci in order:
            cur_mol = Chem.RWMol(backup)
            pred_amap = cand_amap[int(ci)]
            new_amap = copy.deepcopy(global_amap)
            for nei_id, ctr_atom, nei_atom in pred_amap:
                if nei_id == fa_nid:
                    continue
                new_amap[nei_id][nei_atom] = new_amap[cur_node.nid][ctr_atom]
            cur_mol = attach_mols(cur_mol, children, [], new_amap)
            check = Chem.MolFromSmiles(Chem.MolToSmiles(cur_mol.GetMol()))
            if check is None:
                continue
            ok = True
            for nei in children:
                if nei.is_leaf:
                    continue
                result = self._dfs_assemble(all_nodes, cur_mol, new_amap, pred_amap, nei, cur_node)
                if result is None:
                    return None
                if result == "max9":
                    return "max9"
                cur_mol, new_amap = result
                if cur_mol is None:
                    ok = False
                    break
            if ok:
                return cur_mol, new_amap
        return None


# module-level worker state: multiprocessing pickles the function by
# qualified name, so the worker must be importable (a local closure raises
# PicklingError with n_workers>1); the reconstructor is rebuilt once per
# worker process via the initializer instead of being shipped per task
_WORKER_REC = None


def _pool_init(vocab, memoize: bool = False):
    global _WORKER_REC
    _WORKER_REC = TreeReconstructor(vocab, memoize=memoize)


def _pool_one(tree):
    try:
        return _WORKER_REC.reconstruct(tree)
    except Exception:
        return None


def summarize_outputs(outputs):
    """Fold raw per-tree reconstruct outputs (mol tuples / 'max9' / None)
    into (results, stats) — the reference's printed validity/uniqueness/
    avg-atoms (generation/reconstruct.py:101-104)."""
    from rdkit import Chem

    results, smiles = [], []
    attempted = 0
    for out in outputs:
        if out == "max9":
            continue
        attempted += 1
        if out is None:
            continue
        mol, amap, smi_mol = out
        results.append((mol, amap, smi_mol))
        smiles.append(Chem.MolToSmiles(smi_mol))
    stats = {
        "valid": len(results) / max(attempted, 1),
        "unique": len(set(smiles)) / max(len(smiles), 1),
        "avg_atoms": (sum(m.GetNumAtoms() for m, _, _ in results) / max(len(results), 1)),
    }
    return results, stats


def reconstruct_batch(trees, vocab, n_workers: int = 0, memoize: bool = False):
    """Reconstruct many trees, optionally with a process pool (the RDKit
    assembly is GIL-bound C++, cf. the reference's pathos pool,
    ar_sampling_nosize.py:13,273); returns (results, stats) where results
    are (mol, amap, smiles) tuples and stats mirrors the reference's printed
    validity/uniqueness/avg-atoms (generation/reconstruct.py:101-104).
    ``memoize`` enables the opt-in candidate/geometry caches (see
    TreeReconstructor; per-worker caches under the pool)."""
    require_rdkit("tree reconstruction")

    if n_workers > 1:
        import multiprocessing as mp
        # fork: the workers inherit sys.modules (an RDKit stand-in included)
        # and touch no device
        with mp.get_context("fork").Pool(n_workers, initializer=_pool_init,
                                         initargs=(vocab, memoize)) as pool:
            outputs = pool.map(_pool_one, trees)
    else:
        rec = TreeReconstructor(vocab, memoize=memoize)

        def one(tree):
            try:
                return rec.reconstruct(tree)
            except Exception:
                return None

        outputs = [one(t) for t in trees]

    return summarize_outputs(outputs)
