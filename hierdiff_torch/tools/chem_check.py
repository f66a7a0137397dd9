"""A small fixed chemistry workload: six drug-like molecules, their junction
trees over a vocabulary of their own fragments, and the molecules that
``TreeReconstructor`` assembles back from those trees.

``reconstructed_smiles()`` returns the canonical SMILES of the six
reconstructions. ``RECONSTRUCTED_FAKE`` pins what they are under the
fake-RDKit harness (``tests/fake_rdkit.py``), whose embedding and
canonicalisation are deterministic stand-ins: the port's tests hold the
port and the JAX package to it on the CPU, and ``chip_smoke.py`` holds the
card machine's host to it, so both machines run the same host chemistry.
Under real RDKit the embedding is random and the list is not pinned.

Needs RDKit (or the harness) when called; imports nothing of it before.
"""

from __future__ import annotations

from typing import List

import numpy as np

TEST_SMILES = (
    "CC(=O)NC1=CC=C(O)C=C1",
    "C1=CC=CC=C1CCNC(=O)C1CCCCC1",
    "OC1=CC=C(CN2CCOCC2)C=C1",
    "CC1=CC(=O)NC(C)=C1",
    "NC(=O)C1CCCN1CC1=CC=CS1",
    "ClC1=CC=C(C=C1)C(=O)NCCO",
)

RECONSTRUCTED_FAKE = (
    "C(=C(C=CC=1)O)(C1)NC(C)=O",
    "C(C(C)(N)N)(C=CC=C1)=C1",
    "C(C(COCC1)(N1)N)(=CC(=CC=2)O)C2",
    "C(C(=CNC1=O)C)(=C1)C",
    "C(C(CCC1C(N)=O)(N1)N)(C=CS2)=C2",
    "C(C(NC(C)O)=O)(=CC(=CC=1)Cl)C1",
)


def mini_world(smiles=TEST_SMILES) -> dict:
    """The molecules of ``smiles`` (default the six; embedded), the sorted
    fragments of their decompositions, a ``Vocab`` over those fragments
    (property rows [1, 2, 0.5, heavy atoms, 0.3]) and each molecule's
    ``MolTree``."""
    from rdkit import Chem
    from rdkit.Chem import AllChem

    from hierdiff_torch.chem.chemutils import get_clique_mol, get_mol, get_smiles, tree_decomp
    from hierdiff_torch.chem.mol_tree import MolTree, Vocab

    mols = []
    for s in smiles:
        m = get_mol(s)
        AllChem.EmbedMolecule(m)
        mols.append(m)
    frag = sorted({get_smiles(get_clique_mol(m, c)) for m in mols for c in tree_decomp(m)[0]})
    fp_table = {s: np.array([1.0, 2.0, 0.5, float(Chem.MolFromSmiles(s).GetNumAtoms()), 0.3])
                for s in frag}
    vocab = Vocab(frag, fp_table, mode="prop")
    return {"mols": mols, "frag": frag, "vocab": vocab,
            "trees": [MolTree(m, vocab=vocab) for m in mols]}


def reconstructed_smiles(memoize: bool = False) -> List[str]:
    """Canonical SMILES of each tree's reconstruction ('max9' or 'None'
    where it gives no molecule)."""
    from rdkit import Chem

    from hierdiff_torch.chem.reconstruct import TreeReconstructor

    world = mini_world()
    rec = TreeReconstructor(world["vocab"], memoize=memoize)
    out = []
    for tree in world["trees"]:
        r = rec.reconstruct(tree)
        out.append(Chem.MolToSmiles(r[2]) if isinstance(r, tuple) else str(r))
    return out
