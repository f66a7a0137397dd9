"""Dataset preprocessing CLI: RDKit mols -> junction-tree .npz files.

The port's copy of ``hierdiff_tpu/chem/preprocess.py``, a rebuild of the
reference preprocessing (data_utils/mol_tree.py __main__ and
endiffusion/dataset/mol_tree.py __main__): decompose conformer-bearing mols
into blurred junction trees and write one .npz per molecule with the exact
fields the training iterators consume (feats/pos/adj/wids/sizes).

    python -m hierdiff_torch.chem.preprocess --sdf mols.sdf --out data/trees
    python -m hierdiff_torch.chem.preprocess --geom-dir rdkit_folder/drugs --out data/trees

The trees feed ``train.cli`` through ``train.data=data/trees``
(``train/data_iters.load_tree_pool``). ``process_geom`` shuffles each
molecule's conformers with the module ``random``, unseeded, as the JAX
package does.

The 8-dim 'prop' blur features are [hbd, fp0..fp4, TPSA/10, LabuteASA/10]
per clique (reference: endiffusion/dataset/blur_utils.py:80-86).
"""

from __future__ import annotations

import argparse
import pickle
import random
from pathlib import Path
from typing import Optional

import numpy as np

from hierdiff_torch.chem import require_rdkit
from hierdiff_torch.chem.mol_tree import MolTree, Vocab


def featurize_tree(tree: MolTree, vocab: Vocab, mode: str = "prop"):
    """Per-node blur features. (reference: blur_utils.py:79-88)"""
    require_rdkit("tree featurization")
    from rdkit.Chem import rdMolDescriptors

    n = len(tree.nodes)
    if mode == "prop":
        tpsa_contrib = rdMolDescriptors._CalcTPSAContribs(tree.mol3D)
        asa_contrib = rdMolDescriptors._CalcLabuteASAContribs(tree.mol3D)
        feats = np.zeros((n, 8), np.float32)
        for i, node in enumerate(tree.nodes):
            fp = np.asarray(vocab.get_fp(node.smiles))
            tpsa = sum(tpsa_contrib[a] for a in node.clique) / 10.0
            asa = (sum(list(asa_contrib[0])[a] for a in node.clique) + asa_contrib[1]) / 10.0
            feats[i] = np.concatenate([[node.hbd], fp, [tpsa], [asa]])
    else:
        feats = np.stack([np.asarray(vocab.get_fp(nd.smiles), np.float32) for nd in tree.nodes])
    pos = np.stack([np.asarray(nd.pos, np.float32).reshape(3) for nd in tree.nodes])
    wids = np.array([nd.wid for nd in tree.nodes], np.int64)
    sizes = np.array([vocab.mol_sizes[w] for w in wids], np.int64)
    return feats, pos, tree.adj_matrix.astype(np.float64), wids, sizes


def mol_to_npz(mol, vocab: Vocab, out_path: Path, mode: str = "prop") -> bool:
    try:
        tree = MolTree(mol, vocab=vocab)
        feats, pos, adj, wids, sizes = featurize_tree(tree, vocab, mode)
        np.savez_compressed(out_path, feats=feats, pos=pos, adj=adj, wids=wids, sizes=sizes)
        return True
    except Exception:
        return False  # mols outside the vocabulary are skipped (mol_tree.py:296-303)


def process_sdf(sdf_path: str, out_dir: str, mode: str = "prop"):
    require_rdkit("SDF preprocessing")
    from rdkit import Chem

    vocab = Vocab()
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    ok = 0
    for i, mol in enumerate(Chem.SDMolSupplier(sdf_path)):
        if mol is None:
            continue
        if mol_to_npz(mol, vocab, out / f"{i:07d}.npz", mode):
            ok += 1
    print(f"{ok} trees written to {out}")


def process_geom(geom_dir: str, out_dir: str, mode: str = "prop",
                 max_confs: int = 4, limit: Optional[int] = None):
    """GEOM rdkit_folder layout: one pickle per molecule with conformers.
    (reference: data_utils/mol_tree.py:308-333)"""
    require_rdkit("GEOM preprocessing")
    vocab = Vocab()
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths = sorted(Path(geom_dir).iterdir())
    if limit:
        paths = paths[:limit]
    ok = 0
    for i, p in enumerate(paths):
        try:
            with open(p, "rb") as f:
                entry = pickle.load(f)
            mols = [c["rd_mol"] for c in entry["conformers"]]
        except Exception:
            continue
        random.shuffle(mols)
        for j, mol in enumerate(mols[:max_confs]):
            if mol_to_npz(mol, vocab, out / f"{i:07d}_{j}.npz", mode):
                ok += 1
    print(f"{ok} trees written to {out}")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Preprocess molecules into junction trees")
    parser.add_argument("--sdf")
    parser.add_argument("--geom-dir")
    parser.add_argument("--out", required=True)
    parser.add_argument("--mode", default="prop", choices=["prop", "elem"])
    parser.add_argument("--limit", type=int, default=None)
    args = parser.parse_args(argv)
    if args.sdf:
        process_sdf(args.sdf, args.out, args.mode)
    elif args.geom_dir:
        process_geom(args.geom_dir, args.out, args.mode, limit=args.limit)
    else:
        parser.error("provide --sdf or --geom-dir")


if __name__ == "__main__":
    main()
