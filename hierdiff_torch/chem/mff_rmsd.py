"""Atom-resolution conformer lift: align an embedded conformer to the
generated fragment centers (MFF-RMSD pipeline).

The port's copy of ``hierdiff_tpu/chem/mff_rmsd.py`` (a rebuild of
eval/MFF_RMSD.py): ETKDG-embed the reconstructed molecule, globally
Kabsch-align its fragment centers to the tree's generated centers, then move
each fragment rigidly in BFS order with short UFF relaxations. Host
chemistry: RDKit is imported at call time.
"""

from __future__ import annotations

import copy
from collections import deque
from typing import List, Optional, Sequence

import numpy as np

from hierdiff_torch.chem import require_rdkit
from hierdiff_torch.chem.geometry import (apply_rigid, flexible_transform_3d,
                                          kabsch_rmsd, rigid_transform_3d)


def bfs_order_from_edges(edges, n_nodes: int) -> List[int]:
    """Visit order from node 0 over undirected edges.
    (reference: MFF_RMSD.py:90-122)"""
    links = [[] for _ in range(n_nodes)]
    for a, b in zip(*edges):
        links[a].append(int(b))
        links[b].append(int(a))
    order = [0]
    visited = {0}
    queue = deque([0])
    while queue:
        cur = queue.popleft()
        for nxt in links[cur]:
            if nxt not in visited:
                visited.add(nxt)
                order.append(nxt)
                queue.append(nxt)
    return order


def move_leaf(mol, clique, reference_mol, attached_pos, attached_clique):
    """Rigidly move one fragment to fit anchor points.
    (reference: MFF_RMSD.py:62-71)"""
    require_rdkit("conformer lift")
    from rdkit.Geometry import Point3D

    r, t = rigid_transform_3d(np.asarray(attached_pos[0], float), np.asarray(attached_pos[1], float))
    new_xyz = np.stack([np.array(reference_mol.GetConformer().GetAtomPosition(i)) for i in clique])
    new_xyz = apply_rigid(new_xyz, r, t)
    for ind, i in enumerate(clique):
        if i not in attached_clique:
            mol.GetConformer().SetAtomPosition(int(i), Point3D(*new_xyz[ind]))
    return mol


def set_rmsd(mol, amap: Sequence[dict], tree):
    """Lift tree+amap to an atom-resolution conformer.
    (reference: MFF_RMSD.py:131-178)"""
    require_rdkit("conformer lift")
    from rdkit import Chem
    from rdkit.Chem import AllChem
    from rdkit.Geometry import Point3D

    m3d = Chem.AddHs(mol)
    AllChem.EmbedMolecule(m3d, randomSeed=1)
    reference_mol = Chem.RemoveHs(m3d)
    m3d = Chem.RemoveHs(m3d)
    if m3d.GetNumConformers() == 0:
        return None

    xyz = np.stack([np.array(m3d.GetConformer().GetAtomPosition(i))
                    for i in range(m3d.GetNumAtoms())])
    node_atom_map = [list(a.values()) for a in amap]
    frag_centers = np.stack([np.mean(xyz[idx], axis=0) for idx in node_atom_map])
    tree_xyz = np.stack([np.asarray(n.pos).reshape(3) for n in tree.nodes])
    rot, (ca, cb) = flexible_transform_3d(frag_centers, tree_xyz)

    mol_xyz = (xyz - ca) @ rot + cb
    for i in range(m3d.GetNumAtoms()):
        m3d.GetConformer().SetAtomPosition(i, Point3D(*mol_xyz[i]))

    # per-fragment rigid placement in BFS order with short UFF relaxations
    visited: set = set()
    nodes = list(tree.nodes)
    order = bfs_order_from_edges(np.nonzero(tree.adj_matrix), len(nodes))
    nodes = [nodes[i] for i in order]
    for i, n in enumerate(nodes):
        n.clique = amap[i]  # reference reassigns cliques in BFS order (:157)
    nbr_idx = lambda n: [nodes.index(x) for x in n.neighbors if x in nodes]

    for n in nodes[:1]:
        overlap = [c for c in n.clique if c in visited]
        if not overlap:
            nb = nbr_idx(n)
            ref_pos = np.stack([np.asarray(nodes[i].pos).reshape(3) for i in nb])
            rk_pos = np.stack([
                np.mean([np.array(reference_mol.GetConformer().GetAtomPosition(c))
                         for c in nodes[i].clique], axis=0) for i in nb])
            m3d = move_leaf(m3d, list(n.clique), reference_mol, [rk_pos, ref_pos], [])
            visited.update(n.clique)
    for n in nodes[1:]:
        attach = [c for c in n.clique if c in visited]
        nb = nbr_idx(n)
        ref_pos = [np.asarray(nodes[i].pos).reshape(3) for i in nb]
        ref_pos = np.stack(ref_pos + [np.array(m3d.GetConformer().GetAtomPosition(c)) for c in attach])
        rk_pos = [np.mean([np.array(reference_mol.GetConformer().GetAtomPosition(c))
                           for c in nodes[i].clique], axis=0) for i in nb]
        rk_pos = np.stack(rk_pos + [np.array(reference_mol.GetConformer().GetAtomPosition(c)) for c in attach])
        m3d = move_leaf(m3d, list(n.clique), reference_mol, [rk_pos, ref_pos], attach)
        visited.update(n.clique)
        try:
            AllChem.UFFOptimizeMoleculeConfs(m3d, maxIters=5)
        except Exception:
            pass
    return m3d


def tree_center_rmsd(mol3d_1, mol3d_2, vocab=None) -> float:
    """Kabsch RMSD between two molecules' fragment-center point sets.
    (reference: MFF_RMSD.py:121-124)"""
    require_rdkit("tree RMSD")
    from hierdiff_torch.chem.mol_tree import MolTree

    t1, t2 = MolTree(mol3d_1, vocab=vocab), MolTree(mol3d_2, vocab=vocab)
    xyz1 = np.stack([n.pos for n in t1.nodes])
    xyz2 = np.stack([n.pos for n in t2.nodes])
    return kabsch_rmsd(xyz1, xyz2, translate=True)


def mol_rmsd(mol3d_1, mol3d_2) -> float:
    """(reference: MFF_RMSD.py:126-128)"""
    require_rdkit("mol RMSD")
    xyz1 = np.stack([np.array(mol3d_1.GetConformer().GetAtomPosition(i))
                     for i in range(mol3d_1.GetNumAtoms())])
    xyz2 = np.stack([np.array(mol3d_2.GetConformer().GetAtomPosition(i))
                     for i in range(mol3d_2.GetNumAtoms())])
    return kabsch_rmsd(xyz1, xyz2, translate=True)


def base_rmsd(mol, vocab=None) -> Optional[dict]:
    """Baseline drift after UFF relaxation. (reference: MFF_RMSD.py:179-187)"""
    require_rdkit("base RMSD")
    from rdkit.Chem import AllChem

    mol1 = copy.deepcopy(mol)
    mol2 = copy.deepcopy(mol)
    try:
        AllChem.UFFOptimizeMoleculeConfs(mol2)
    except Exception:
        return None
    return {"tree": tree_center_rmsd(mol1, mol2, vocab), "mol": mol_rmsd(mol1, mol2)}
