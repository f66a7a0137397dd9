"""Protein pocket extraction for pocket-conditioned generation (CrossDocked).

The port's own copy of ``hierdiff_tpu/chem/pocket.py``, a rebuild of the
reference's ``read_pdb`` (data_utils/mol_tree.py:25-54) without biopandas:
PDB ATOM records are fixed-width text, so a small pure-Python parser
suffices. Residues with any atom within ``radius`` (6 A) of any ligand atom
form the pocket; the conditioning tokens are the C-alpha residue types and
positions. Numpy only; the card never sees it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

RESIDUE_LIST = [
    "ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS", "ILE",
    "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL",
]  # (reference: diffusion_qm9.py:34)


@dataclass
class PocketCA:
    residue_type: List[str]       # 3-letter codes of pocket CA residues
    coord: np.ndarray             # (K, 3)
    ligand_name: str = ""
    pocket_name: str = ""

    def residue_tokens(self) -> np.ndarray:
        """1-based residue-type tokens (0 = padding), matching the
        reference's pocket embedding indexing (diffusion_qm9.py:405)."""
        return np.array([RESIDUE_LIST.index(r) + 1 if r in RESIDUE_LIST else 0
                         for r in self.residue_type], np.int32)


def parse_pdb_atoms(text: str):
    """ATOM records -> (atom_names, residue_keys, residue_types, coords)."""
    names, res_keys, res_types, coords = [], [], [], []
    for line in text.splitlines():
        if not line.startswith("ATOM"):
            continue
        # PDB fixed columns: name 13-16, resName 18-20, chainID 22,
        # resSeq 23-26, x/y/z 31-54
        names.append(line[12:16].strip())
        res_types.append(line[17:20].strip())
        res_keys.append(line[21] + line[22:26].strip())
        coords.append([float(line[30:38]), float(line[38:46]), float(line[46:54])])
    return names, res_keys, res_types, np.asarray(coords, np.float64).reshape(-1, 3)


def pocket_from_pdb(pdb_path: str, ligand_coords: np.ndarray,
                    radius: float = 6.0) -> PocketCA:
    """(reference: mol_tree.py:25-54)"""
    with open(pdb_path) as f:
        text = f.read()
    return pocket_from_text(text, ligand_coords, radius,
                            ligand_name=pdb_path.split("/")[-1].split(".")[0],
                            pocket_name=pdb_path.split("/")[-2] if "/" in pdb_path else "")


def pocket_from_text(text: str, ligand_coords: np.ndarray, radius: float = 6.0,
                     ligand_name: str = "", pocket_name: str = "") -> PocketCA:
    names, res_keys, res_types, coords = parse_pdb_atoms(text)
    ligand_coords = np.asarray(ligand_coords, np.float64).reshape(-1, 3)
    if len(coords) == 0 or len(ligand_coords) == 0:
        return PocketCA([], np.zeros((0, 3)), ligand_name, pocket_name)
    # residues with any atom within `radius` of any ligand atom
    d2 = ((coords[:, None, :] - ligand_coords[None, :, :]) ** 2).sum(-1)
    close = (d2 < radius * radius).any(axis=1)
    pocket_res = {res_keys[i] for i in np.nonzero(close)[0]}
    ca_types, ca_coords = [], []
    for i, name in enumerate(names):
        if name == "CA" and res_keys[i] in pocket_res:
            ca_types.append(res_types[i])
            ca_coords.append(coords[i])
    return PocketCA(ca_types, np.asarray(ca_coords, np.float64).reshape(-1, 3),
                    ligand_name, pocket_name)


def collate_pockets(pockets: Sequence[PocketCA]) -> Dict[str, np.ndarray]:
    """Pad pockets into dense conditioning tensors.
    (reference: diffusion_qm9.py:397-418 sample_batches)"""
    b = len(pockets)
    k = max((len(p.residue_type) for p in pockets), default=1)
    k = max(k, 1)
    feat = np.zeros((b, k), np.int32)
    pos = np.zeros((b, k, 3), np.float32)
    node_mask = np.zeros((b, k, 1), np.float32)
    edge_mask = np.zeros((b, k, k), np.float32)
    for i, p in enumerate(pockets):
        m = len(p.residue_type)
        if m == 0:
            continue
        feat[i, :m] = p.residue_tokens()
        pos[i, :m] = p.coord
        node_mask[i, :m] = 1.0
        edge_mask[i, :m, :m] = 1.0 - np.eye(m)
    return {"protein_feat": feat, "protein_pos": pos,
            "protein_feat_mask": node_mask, "protein_edge_mask": edge_mask}
