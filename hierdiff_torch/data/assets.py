"""Bundled data artifacts: node-count histograms, the fragment vocabulary,
its fingerprint tables, the heavy-atom size table and the feature-bucket
supports of the edge-denoise node head (the port's own copies of
``hierdiff_tpu/assets/``: ``*_histogram.json``, ``vocab.txt``,
``vocab_prop_fps.csv``, ``vocab_elem_fps.csv``, ``size_dict.json``,
``array_dict.json``)."""

from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

ASSET_DIR = Path(__file__).resolve().parent.parent / "assets"


@lru_cache(maxsize=None)
def load_histogram(name: str = "geom") -> Dict[int, int]:
    """Named fragment-count histogram: 'geom' | 'crossdock' | 'qm9'."""
    with open(ASSET_DIR / f"{name}_histogram.json") as f:
        raw = json.load(f)
    return {int(k): int(v) for k, v in raw.items()}


@lru_cache(maxsize=None)
def load_vocab_smiles() -> Tuple[str, ...]:
    """The fragment vocabulary's SMILES strings, in file order."""
    with open(ASSET_DIR / "vocab.txt") as f:
        return tuple(line.strip() for line in f if line.strip())


@lru_cache(maxsize=None)
def load_vocab_fps(mode: str = "prop") -> Dict[str, np.ndarray]:
    """Per-fragment fingerprint rows, smiles -> float64 vector: mode 'prop'
    has 5 property columns (col 3 = heavy-atom count), 'elem' a 3-column
    element bag."""
    fname = "vocab_prop_fps.csv" if mode == "prop" else "vocab_elem_fps.csv"
    out: Dict[str, np.ndarray] = {}
    with open(ASSET_DIR / fname) as f:
        f.readline()   # header
        for line in f:
            parts = line.rstrip("\n").split(",")
            out[parts[0]] = np.array([float(v) for v in parts[1:]], dtype=np.float64)
    return out


@lru_cache(maxsize=None)
def load_size_dict() -> Dict[int, List[int]]:
    """heavy-atom count -> allowed vocab indices (refine head support)."""
    with open(ASSET_DIR / "size_dict.json") as f:
        raw = json.load(f)
    return {int(k): v for k, v in raw.items()}


@lru_cache(maxsize=None)
def load_array_dict() -> Tuple[List[np.ndarray], List[List[int]]]:
    """(bucket feature arrays, allowed vocab indices per bucket): the
    softmax-support restriction of the edge-denoise node head when
    ``full_softmax`` is off. (hierdiff_tpu/data/assets.py:55)"""
    with open(ASSET_DIR / "array_dict.json") as f:
        raw = json.load(f)
    arrays = [np.asarray(a, dtype=np.float64) for a in raw["arrays"]]
    return arrays, raw["indices"]


@lru_cache(maxsize=None)
def vocab_mol_sizes() -> Tuple[int, ...]:
    """Heavy-atom count per vocab index: column 3 of the 'prop' fingerprint
    table, rounded. This is what the JAX package's ``Vocab().mol_sizes``
    gives without RDKit (``hierdiff_tpu/chem/mol_tree.py:27-36``)."""
    fps = load_vocab_fps("prop")
    return tuple(int(round(fps[s][3])) for s in load_vocab_smiles())
