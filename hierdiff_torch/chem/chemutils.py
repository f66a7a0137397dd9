"""Junction-tree chemistry: decomposition, attachment enumeration, assembly.

Implementation of the JT-VAE tree-decomposition / assembly algorithms (Jin et
al. 2018) that define HierDiff's fragment data semantics. Behavior matches
the reference (data_utils/chemutils.py, generation/jtnn/chemutils.py):

- ``tree_decomp``: non-ring bonds + SSSR rings as cliques; rings sharing >2
  atoms merged; singleton cliques at high-degree atoms; maximum spanning
  tree over shared-atom weights (chemutils.py:76-151).
- ``enum_attach`` / ``enum_assemble``: enumerate chemically valid attachment
  atom maps between a center fragment and its tree neighbors
  (chemutils.py:238-338).
- ``attach_mols`` / ``local_attach``: graft neighbor fragments onto a center
  molecule via an atom map (chemutils.py:202-235).

All functions import RDKit lazily and raise ``RDKitUnavailable`` otherwise.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

from hierdiff_torch.chem import require_rdkit

MST_MAX_WEIGHT = 100
MAX_NCAND = 2000


def _rd():
    require_rdkit("junction-tree chemistry")
    from rdkit import Chem
    return Chem


# --- SMILES / mol helpers -------------------------------------------------


def get_mol(smiles: str):
    """Kekulized mol from SMILES, None on failure. (chemutils.py:17-22)"""
    Chem = _rd()
    mol = Chem.MolFromSmiles(smiles)
    if mol is None:
        return None
    Chem.Kekulize(mol)
    return mol


def get_smiles(mol) -> str:
    Chem = _rd()
    return Chem.MolToSmiles(mol, kekuleSmiles=True)


def sanitize(mol):
    """Round-trip through SMILES; None when chemistry is invalid.
    (chemutils.py:43-49)"""
    try:
        return get_mol(get_smiles(mol))
    except Exception:
        return None


def set_atommap(mol, num: int = 0):
    for atom in mol.GetAtoms():
        atom.SetAtomMapNum(num)


def copy_atom(atom):
    Chem = _rd()
    new = Chem.Atom(atom.GetSymbol())
    new.SetFormalCharge(atom.GetFormalCharge())
    new.SetAtomMapNum(atom.GetAtomMapNum())
    return new


def copy_edit_mol(mol):
    """Editable deep copy preserving charges and atom maps.
    (chemutils.py:57-67)"""
    Chem = _rd()
    new_mol = Chem.RWMol(Chem.MolFromSmiles(""))
    for atom in mol.GetAtoms():
        new_mol.AddAtom(copy_atom(atom))
    for bond in mol.GetBonds():
        new_mol.AddBond(bond.GetBeginAtom().GetIdx(), bond.GetEndAtom().GetIdx(),
                        bond.GetBondType())
    return new_mol


def get_clique_mol(mol, atoms: Sequence[int]):
    """Fragment mol induced by an atom clique. (chemutils.py:69-74)"""
    Chem = _rd()
    smiles = Chem.MolFragmentToSmiles(mol, atoms, kekuleSmiles=True)
    new_mol = Chem.MolFromSmiles(smiles, sanitize=False)
    new_mol = copy_edit_mol(new_mol).GetMol()
    return sanitize(new_mol)


def decode_stereo(smiles2d: str) -> List[str]:
    """Enumerate stereoisomer SMILES (+ chiral-N-neutralized variants).
    (chemutils.py:27-41)"""
    Chem = _rd()
    from rdkit.Chem.EnumerateStereoisomers import EnumerateStereoisomers

    mol = Chem.MolFromSmiles(smiles2d)
    isomers = [Chem.MolFromSmiles(Chem.MolToSmiles(m, isomericSmiles=True))
               for m in EnumerateStereoisomers(mol)]
    smiles3d = [Chem.MolToSmiles(m, isomericSmiles=True) for m in isomers]
    chiral_n = [a.GetIdx() for a in isomers[0].GetAtoms()
                if int(a.GetChiralTag()) > 0 and a.GetSymbol() == "N"]
    if chiral_n:
        for m in isomers:
            for idx in chiral_n:
                m.GetAtomWithIdx(idx).SetChiralTag(Chem.rdchem.ChiralType.CHI_UNSPECIFIED)
            smiles3d.append(Chem.MolToSmiles(m, isomericSmiles=True))
    return smiles3d


def atom_equal(a1, a2) -> bool:
    return a1.GetSymbol() == a2.GetSymbol() and a1.GetFormalCharge() == a2.GetFormalCharge()


def ring_bond_equal(b1, b2, reverse: bool = False) -> bool:
    """Aromatic-ring bond match by endpoint atoms only. (chemutils.py:157-163)"""
    pair1 = (b1.GetBeginAtom(), b1.GetEndAtom())
    pair2 = (b2.GetEndAtom(), b2.GetBeginAtom()) if reverse else (b2.GetBeginAtom(), b2.GetEndAtom())
    return atom_equal(pair1[0], pair2[0]) and atom_equal(pair1[1], pair2[1])


def mol_equal(mol1, mol2) -> bool:
    """Canonical-SMILES equality + atom-map consistency. (chemutils.py:165-200)"""
    Chem = _rd()
    m1 = Chem.RemoveHs(mol1)
    m2 = Chem.RemoveHs(mol2)
    for a in m1.GetAtoms():
        a.SetAtomMapNum(0)
    for a in m2.GetAtoms():
        a.SetAtomMapNum(0)
    if Chem.MolToSmiles(m1) != Chem.MolToSmiles(m2):
        return False
    for a2 in mol2.GetAtoms():
        if a2.GetAtomMapNum() == 0:
            continue
        if not any(a1.GetAtomMapNum() == a2.GetAtomMapNum() and atom_equal(a1, a2)
                   for a1 in mol1.GetAtoms()):
            return False
    return True


# --- tree decomposition ---------------------------------------------------


def tree_decomp(mol) -> Tuple[List[List[int]], List[Tuple[int, int]]]:
    """Junction-tree decomposition: (cliques, tree edges).
    (chemutils.py:76-151; algorithm of Jin et al., JT-VAE)
    """
    import numpy as np
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import minimum_spanning_tree

    Chem = _rd()
    n_atoms = mol.GetNumAtoms()
    if n_atoms == 1:
        return [[0]], []

    cliques: List[List[int]] = []
    for bond in mol.GetBonds():
        if not bond.IsInRing():
            cliques.append([bond.GetBeginAtom().GetIdx(), bond.GetEndAtom().GetIdx()])
    cliques.extend([list(ring) for ring in Chem.GetSymmSSSR(mol)])

    def build_nei_list():
        nei = [[] for _ in range(n_atoms)]
        for ci, c in enumerate(cliques):
            for a in c:
                nei[a].append(ci)
        return nei

    nei_list = build_nei_list()
    # merge rings sharing more than two atoms (bridged/fused systems)
    for i in range(len(cliques)):
        if len(cliques[i]) <= 2:
            continue
        for atom in cliques[i]:
            for j in nei_list[atom]:
                if i >= j or len(cliques[j]) <= 2:
                    continue
                if len(set(cliques[i]) & set(cliques[j])) > 2:
                    cliques[i] = list(set(cliques[i]) | set(cliques[j]))
                    cliques[j] = []
    cliques = [c for c in cliques if c]
    nei_list = build_nei_list()

    edges: Dict[Tuple[int, int], int] = defaultdict(int)
    for atom in range(n_atoms):
        cnei = nei_list[atom]
        if len(cnei) <= 1:
            continue
        bonds = [c for c in cnei if len(cliques[c]) == 2]
        rings = [c for c in cnei if len(cliques[c]) > 4]
        if len(bonds) > 2 or (len(bonds) == 2 and len(cnei) > 2):
            # high-degree atom: bridge via a singleton clique
            cliques.append([atom])
            c2 = len(cliques) - 1
            for c1 in cnei:
                edges[(c1, c2)] = 1
        elif len(rings) > 2:
            # spiro-crowded atom in >2 complex rings
            cliques.append([atom])
            c2 = len(cliques) - 1
            for c1 in cnei:
                edges[(c1, c2)] = MST_MAX_WEIGHT - 1
        else:
            for i in range(len(cnei)):
                for j in range(i + 1, len(cnei)):
                    c1, c2 = cnei[i], cnei[j]
                    inter = len(set(cliques[c1]) & set(cliques[c2]))
                    if edges[(c1, c2)] < inter:
                        edges[(c1, c2)] = inter

    edge_list = [(u, v, MST_MAX_WEIGHT - w) for (u, v), w in edges.items()]
    if not edge_list:
        return cliques, []

    row, col, data = zip(*edge_list)
    graph = csr_matrix((data, (row, col)), shape=(len(cliques), len(cliques)))
    mst = minimum_spanning_tree(graph)
    row, col = mst.nonzero()
    return cliques, [(int(r), int(c)) for r, c in zip(row, col)]


# --- attachment enumeration / grafting ------------------------------------


def attach_mols(ctr_mol, neighbors, prev_nodes, nei_amap):
    """Graft neighbor fragment mols onto the center editable mol.
    (chemutils.py:202-225)"""
    prev_nids = [node.nid for node in prev_nodes]
    for nei_node in prev_nodes + neighbors:
        nei_id, nei_mol = nei_node.nid, nei_node.mol
        amap = nei_amap[nei_id]
        for atom in nei_mol.GetAtoms():
            if atom.GetIdx() not in amap:
                amap[atom.GetIdx()] = ctr_mol.AddAtom(copy_atom(atom))
        if nei_mol.GetNumBonds() == 0:
            nei_atom = nei_mol.GetAtomWithIdx(0)
            ctr_mol.GetAtomWithIdx(amap[0]).SetAtomMapNum(nei_atom.GetAtomMapNum())
        else:
            for bond in nei_mol.GetBonds():
                a1 = amap[bond.GetBeginAtom().GetIdx()]
                a2 = amap[bond.GetEndAtom().GetIdx()]
                if ctr_mol.GetBondBetweenAtoms(a1, a2) is None:
                    ctr_mol.AddBond(a1, a2, bond.GetBondType())
                elif nei_id in prev_nids:  # father's bond order wins
                    ctr_mol.RemoveBond(a1, a2)
                    ctr_mol.AddBond(a1, a2, bond.GetBondType())
    return ctr_mol


def local_attach(ctr_mol, neighbors, prev_nodes, amap_list):
    """(chemutils.py:227-235)"""
    ctr_mol = copy_edit_mol(ctr_mol)
    nei_amap = {nei.nid: {} for nei in prev_nodes + neighbors}
    for nei_id, ctr_atom, nei_atom in amap_list:
        nei_amap[nei_id][nei_atom] = ctr_atom
    return attach_mols(ctr_mol, neighbors, prev_nodes, nei_amap).GetMol()


def enum_attach(ctr_mol, nei_node, amap, singletons):
    """All candidate atom maps attaching one neighbor. (chemutils.py:238-290)"""
    nei_mol, nei_idx = nei_node.mol, nei_node.nid
    att_confs = []
    black_list = [atom_idx for nei_id, atom_idx, _ in amap if nei_id in singletons]
    ctr_atoms = [a for a in ctr_mol.GetAtoms() if a.GetIdx() not in black_list]
    ctr_bonds = list(ctr_mol.GetBonds())

    if nei_mol.GetNumBonds() == 0:  # singleton neighbor
        nei_atom = nei_mol.GetAtomWithIdx(0)
        used = [atom_idx for _, atom_idx, _ in amap]
        for atom in ctr_atoms:
            if atom_equal(atom, nei_atom) and atom.GetIdx() not in used:
                att_confs.append(amap + [(nei_idx, atom.GetIdx(), 0)])
    elif nei_mol.GetNumBonds() == 1:  # bond neighbor
        bond = nei_mol.GetBondWithIdx(0)
        bond_val = int(bond.GetBondTypeAsDouble())
        b1, b2 = bond.GetBeginAtom(), bond.GetEndAtom()
        for atom in ctr_atoms:
            # carbon can't change valence: needs enough free H
            if atom.GetAtomicNum() == 6 and atom.GetTotalNumHs() < bond_val:
                continue
            if atom_equal(atom, b1):
                att_confs.append(amap + [(nei_idx, atom.GetIdx(), b1.GetIdx())])
            elif atom_equal(atom, b2):
                att_confs.append(amap + [(nei_idx, atom.GetIdx(), b2.GetIdx())])
    else:  # ring neighbor: share an atom or a bond
        for a1 in ctr_atoms:
            for a2 in nei_mol.GetAtoms():
                if atom_equal(a1, a2):
                    if a1.GetAtomicNum() == 6 and a1.GetTotalNumHs() + a2.GetTotalNumHs() < 4:
                        continue
                    att_confs.append(amap + [(nei_idx, a1.GetIdx(), a2.GetIdx())])
        if ctr_mol.GetNumBonds() > 1:
            for b1 in ctr_bonds:
                for b2 in nei_mol.GetBonds():
                    if ring_bond_equal(b1, b2):
                        att_confs.append(amap + [
                            (nei_idx, b1.GetBeginAtom().GetIdx(), b2.GetBeginAtom().GetIdx()),
                            (nei_idx, b1.GetEndAtom().GetIdx(), b2.GetEndAtom().GetIdx())])
                    if ring_bond_equal(b1, b2, reverse=True):
                        att_confs.append(amap + [
                            (nei_idx, b1.GetBeginAtom().GetIdx(), b2.GetEndAtom().GetIdx()),
                            (nei_idx, b1.GetEndAtom().GetIdx(), b2.GetBeginAtom().GetIdx())])
    return att_confs


def enum_assemble(node, neighbors, prev_nodes=(), prev_amap=(), max_ncand: int = MAX_NCAND):
    """Enumerate all valid assemblies of ``node`` with its neighbors,
    depth-first with SMILES dedup per level. Returns
    [(smiles, kekulized mol, amap)]. (chemutils.py:293-338)

    The search stops once it holds more than ``max_ncand`` complete
    attachments (the reference's ``MAX_NCAND``). Each level's candidates
    are sanitized and deduplicated in the reference's order, one at a time,
    and a candidate is searched as soon as it passes, so the attachments
    found, and their order, are the reference's, whatever the bound; a
    small bound saves the rest of the tree. ``max_ncand=0`` gives the first
    attachment only: ``can_assemble``'s verdict."""
    Chem = _rd()
    prev_nodes = list(prev_nodes)
    all_attach_confs: List[list] = []
    singletons = [n.nid for n in list(neighbors) + prev_nodes if n.mol.GetNumAtoms() == 1]

    def search(cur_amap, depth):
        if depth == len(neighbors):
            all_attach_confs.append(cur_amap)
            return
        seen = set()
        for amap in enum_attach(node.mol, neighbors[depth], cur_amap, singletons):
            if len(all_attach_confs) > max_ncand:
                return
            cand_mol = local_attach(node.mol, list(neighbors[: depth + 1]), prev_nodes, amap)
            cand_mol = sanitize(cand_mol)
            if cand_mol is None:
                continue
            smiles = get_smiles(cand_mol)
            if smiles in seen:
                continue
            seen.add(smiles)
            search(amap, depth + 1)

    search(list(prev_amap), 0)
    seen = set()
    out = []
    for amap in all_attach_confs:
        cand_mol = local_attach(node.mol, list(neighbors), prev_nodes, amap)
        cand_mol = Chem.MolFromSmiles(Chem.MolToSmiles(cand_mol))
        smiles = Chem.MolToSmiles(cand_mol)
        if smiles in seen:
            continue
        seen.add(smiles)
        Chem.Kekulize(cand_mol)
        out.append((smiles, cand_mol, amap))
    return out


def can_assemble(node_x, node_y=None) -> bool:
    """Is there at least one valid assembly of a node with its neighbors?
    (generation/jtnn/jtnn_dec.py:312-326 — the beam-search validity gate)

    The reference enumerates up to ``MAX_NCAND`` attachments and asks
    whether any survives; this stops at the first (``max_ncand=0``), which
    survives unless its re-parse or ``Kekulize`` raises. So the verdict is
    the reference's, except where the reference would raise on a later
    attachment: there this answers True. A negative verdict still exhausts
    the search, whose size is the product of the levels' candidate
    counts."""
    neis = node_x.neighbors
    if node_y is not None and node_y not in neis:
        neis.append(node_y)
    for i, nei in enumerate(neis):
        nei.nid = i
    neighbors = [nei for nei in neis if nei.mol.GetNumAtoms() > 1]
    neighbors = sorted(neighbors, key=lambda x: x.mol.GetNumAtoms(), reverse=True)
    singletons = [nei for nei in neis if nei.mol.GetNumAtoms() == 1]
    neighbors = singletons + neighbors
    return len(enum_assemble(node_x, neighbors, max_ncand=0)) > 0
