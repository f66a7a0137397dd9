"""Evaluation-panel CLI: MOSES-style metrics over a generated.pkl.

    python -m hierdiff_torch.eval.cli generated.pkl [--ref reference.pkl]
        [--mcf mcf.csv] [--pains wehi_pains.csv] [--out metrics.json]

Computes the reference's evaluation_method panel (filter pass rate,
MW/logP/rotatable bonds, scaffold entropy, SAS, QED, Ro5, ring stats,
heteroatom ratio, optional Morgan max-similarity vs a reference set) over
the molecules produced by ``sampling.cli generate``.
(reference: eval/evaluation_method.py:40-217 — library-only there, with no
driver script; this CLI is the missing runner.)
"""

from __future__ import annotations

import argparse
import json
import pickle

import numpy as np

from hierdiff_torch.chem import require_rdkit


def _mols_from_payload(payload):
    if isinstance(payload, dict) and "molecules" in payload:
        return [m for m, _amap, _smi in payload["molecules"] or []]
    return list(payload)


def evaluate(mols, ref_mols=None) -> dict:
    import hierdiff_torch.eval.metrics as M

    # clean ONCE for the whole panel (the metric functions re-clean by
    # default, reference-exact; 8+ sanitize/canonicalize passes at 10k mols)
    mols = M.clean_mols(mols)
    ac = dict(assume_clean=True)
    out = {
        "n_molecules": len(mols),
        "filter_pass_rate": float(M.filter_rate(mols, **ac)),
        "mw_mean": float(np.mean(M.cal_mw(mols, **ac))),
        "logp_mean": float(np.mean(M.cal_logp(mols, **ac))),
        "rot_bonds_mean": float(np.mean(M.cal_num_rotatable_bonds(mols, **ac))),
        "scaffold_entropy": float(M.scaffold_entropy(mols, **ac)),
        "sas_mean": float(np.mean(M.cal_sas(mols))),
        "qed_mean": float(np.mean(M.cal_qed(mols))),
        "ro5_mean": float(np.mean(M.ro5(mols))),
        "hetero_ratio_mean": float(np.mean(M.hetero_atom_ratio(mols))),
    }
    sizes, counts = M.cal_rings(mols)
    out["ring_size_mean"] = float(np.mean(sizes))
    out["ring_count_mean"] = float(np.mean(counts))
    if ref_mols:
        ref_mols = M.clean_mols(ref_mols)
        sim, _ = M.max_sim_fp(mols, ref_mols, **ac)
        out["max_fp_similarity_mean"] = float(np.mean(sim))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="HierDiff evaluation panel (PyTorch port)")
    p.add_argument("generated", help="pickle from sampling.cli generate "
                                     "(or a bare list of RDKit mols)")
    p.add_argument("--ref", default="", help="reference molecule pickle for "
                                             "Morgan max-similarity")
    p.add_argument("--mcf", default="", help="MOSES mcf.csv SMARTS screens")
    p.add_argument("--pains", default="", help="MOSES wehi_pains.csv screens")
    p.add_argument("--out", default="", help="write metrics JSON here")
    args = p.parse_args(argv)
    require_rdkit("the evaluation panel")

    with open(args.generated, "rb") as f:
        mols = _mols_from_payload(pickle.load(f))
    if not mols:
        raise SystemExit("no molecules in the payload (reconstruction "
                         "requires RDKit at generation time)")
    ref_mols = None
    if args.ref:
        with open(args.ref, "rb") as f:
            ref_mols = _mols_from_payload(pickle.load(f))
    if args.mcf or args.pains:
        import hierdiff_torch.eval.metrics as M
        M.set_filter_tables(args.mcf or None, args.pains or None)

    metrics = evaluate(mols, ref_mols)
    print(json.dumps(metrics, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(metrics, f, indent=2)


if __name__ == "__main__":
    main()
