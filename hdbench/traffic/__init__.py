"""The benchmark's traffic: node counts and seeded C-alpha pockets, all
numpy on the host and all drawn from a seed.

Frozen copies (see README.md for the commit): ``pocket`` follows
``chip_smoke.py`` ``write_pocket_pdb``'s geometry (C-alpha residues 3-9 A
from the site centre, residue types uniform), with the tokens
``chem/pocket.py`` gives them (1 + index in the 20-letter residue list);
``histogram`` reads copies of the package's assets under ``traffic/data``.

Every request of a mix has the same multiset of node counts: the
histogram's stratified quantiles, shuffled by the seed. So seeds change the
order and the content of the work, never its amount.
"""

from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path
from typing import Dict

import numpy as np

DATA = Path(__file__).resolve().parent / "data"
MIXES = Path(__file__).resolve().parent / "mixes"


def load_mix(name: str) -> dict:
    """The traffic mix ``traffic/mixes/<name>.json``."""
    path = MIXES / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} at {path}")
    return json.loads(path.read_text())


@lru_cache(maxsize=None)
def histogram(name: str) -> Dict[int, int]:
    """Fragment-count histogram 'geom' or 'crossdock'."""
    raw = json.loads((DATA / f"{name}_histogram.json").read_text())
    return {int(k): int(v) for k, v in raw.items()}


def stratified_counts(name: str, n: int) -> np.ndarray:
    """The ``n`` stratified quantiles of histogram ``name``: count i is the
    smallest c with CDF(c) >= (i + 0.5) / n. Sorted ascending."""
    hist = histogram(name)
    ks = np.array(sorted(hist), np.int64)
    p = np.array([hist[int(k)] for k in ks], np.float64)
    cdf = np.cumsum(p / p.sum())
    return ks[np.minimum(np.searchsorted(cdf, (np.arange(n) + 0.5) / n), len(ks) - 1)]


def shuffled_counts(name: str, n: int, rng: np.random.Generator) -> np.ndarray:
    return rng.permutation(stratified_counts(name, n))


def complete_masks(counts: np.ndarray, n: int):
    """Node mask (B, n, 1) and the self-loop-free complete edge mask (B, n, n)."""
    b = len(counts)
    node = np.zeros((b, n, 1), np.float32)
    edge = np.zeros((b, n, n), np.float32)
    for i, c in enumerate(counts):
        c = int(c)
        node[i, :c] = 1.0
        edge[i, :c, :c] = 1.0 - np.eye(c, dtype=np.float32)
    return node, edge


# --- pockets ----------------------------------------------------------------

POCKET_MIN_A, POCKET_SPAN_A = 3.0, 6.0
RESIDUE_TYPES = 20


def pocket(rng: np.random.Generator, k: int) -> Dict[str, np.ndarray]:
    """One pocket of ``k`` C-alpha residues, 3-9 A from the origin (the
    molecule's centre of mass), as (1, K) tokens 1..20, (1, K, 3) positions
    and the masks of a pocket with every residue real."""
    pos = np.zeros((k, 3), np.float64)
    tok = np.zeros(k, np.int64)
    for i in range(k):
        d = rng.standard_normal(3)
        r = POCKET_MIN_A + POCKET_SPAN_A * rng.random()
        pos[i] = d / np.linalg.norm(d) * r
        tok[i] = 1 + int(rng.integers(RESIDUE_TYPES))
    pos = pos.astype(np.float32)    # the PDB's fixed-width columns round to 1e-3 A
    pos = np.round(pos, 3)
    return {"protein_feat": tok[None].astype(np.int32), "protein_pos": pos[None],
            "protein_feat_mask": np.ones((1, k, 1), np.float32),
            "protein_edge_mask": (1.0 - np.eye(k, dtype=np.float32))[None]}
