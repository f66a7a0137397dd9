"""Synthetic GEOM-like fragment trees for training without the dataset.

Port of ``hierdiff_tpu/data/synthetic.py`` (numpy only): random junction trees
with node counts from a dataset's histogram, fragment features from the
vocabulary's fingerprint table and 3D fragment centres laid out along the
tree. With the same seed the trees are bit-identical to the JAX package's.
"""

from __future__ import annotations

import warnings
from collections import Counter
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from hierdiff_torch.data.assets import load_histogram, load_vocab_fps, load_vocab_smiles


@dataclass
class SyntheticTree:
    """A blurred junction tree: features, positions, adjacency, vocab ids."""

    feats: np.ndarray       # (n, 8) prop features [hbd, fp0..4, tpsa, asa] | (n, 3) elem
    pos: np.ndarray         # (n, 3) fragment centres
    adj: np.ndarray         # (n, n) 0/1 symmetric tree adjacency
    wids: np.ndarray        # (n,) vocab indices
    sizes: np.ndarray       # (n,) heavy-atom counts


class SyntheticTreeGenerator:
    """Random trees of a dataset's node-count histogram (``dataset``) in the
    coarse feature ``mode`` ('prop' or 'elem').

    ``planted=True`` plants a learnable feature -> type signal: every tree
    takes ONE vocab id, drawn from the first ``planted_k`` fragments whose
    fingerprint row is unique, so the denoise node head can read the new
    node's type from its visible fingerprint and the refine head a masked
    node's type from its neighbours'. Accuracy far above chance then shows
    that the heads, losses and gradients are wired."""

    def __init__(self, seed: int = 0, mode: str = "prop", dataset: str = "geom",
                 planted: bool = False, planted_k: int = 32):
        self.rng = np.random.default_rng(seed)
        hist = load_histogram(dataset)
        self.counts = np.array(sorted(hist.keys()))
        p = np.array([hist[int(c)] for c in self.counts], dtype=np.float64)
        self.count_probs = p / p.sum()
        self.smiles = load_vocab_smiles()
        fps = load_vocab_fps(mode)
        self.fp_table = np.stack([fps[s] for s in self.smiles])  # (V, 5) prop | (V, 3) elem
        self.mode = mode
        self.planted = planted
        if planted:
            rows = [tuple(r) for r in self.fp_table]
            counts_by_row = Counter(rows)
            uniq = [i for i, r in enumerate(rows) if counts_by_row[r] == 1]
            if not uniq:
                raise ValueError("planted mode needs at least one unique fingerprint row "
                                 f"(mode={mode!r} table has none)")
            if len(uniq) < planted_k:
                # 'elem' has 15 unique rows of 780: deliver what exists, and say so
                warnings.warn(f"planted_k={planted_k} requested but only {len(uniq)} unique "
                              f"fingerprint rows exist in mode={mode!r}; using {len(uniq)}")
            self.planted_wids = np.array(uniq[:planted_k], np.int64)

    def sample_count(self) -> int:
        return int(self.rng.choice(self.counts, p=self.count_probs))

    def sample_tree(self, n: Optional[int] = None) -> SyntheticTree:
        if n is None:
            n = self.sample_count()
        rng = self.rng
        # random tree: node i attaches to a uniform earlier node
        adj = np.zeros((n, n), np.float64)
        pos = np.zeros((n, 3))
        for i in range(1, n):
            p = int(rng.integers(0, i))
            adj[i, p] = adj[p, i] = 1.0
            direction = rng.normal(size=3)
            direction /= np.linalg.norm(direction) + 1e-9
            dist = 2.4 + rng.random() * 2.2  # fragment-centre spacing ~2.4-4.6 A
            pos[i] = pos[p] + direction * dist
        pos -= pos.mean(axis=0, keepdims=True)

        if self.planted:
            wids = np.full(n, rng.choice(self.planted_wids), np.int64)
        else:
            wids = rng.integers(0, len(self.smiles), size=n)
        fp = self.fp_table[wids]
        if self.mode == "elem":
            # elem coarse features are the bare element-count fingerprint
            feats = fp
            sizes = fp.sum(axis=1).astype(np.int64)
        else:
            hbd = rng.poisson(0.8, size=n).clip(0, 6).astype(np.float64)
            tpsa = rng.gamma(2.0, 1.0, size=n)             # /10-scaled TPSA-like
            asa = 2.0 + rng.gamma(2.0, 1.5, size=n)        # /10-scaled ASA-like
            feats = np.concatenate([hbd[:, None], fp, tpsa[:, None], asa[:, None]], axis=1)
            sizes = fp[:, 3].astype(np.int64)              # col 3 = heavy-atom count
        return SyntheticTree(feats=feats.astype(np.float32), pos=pos.astype(np.float32),
                             adj=adj, wids=wids, sizes=sizes)

    def sample_trees(self, k: int, n: Optional[int] = None) -> List[SyntheticTree]:
        return [self.sample_tree(n) for _ in range(k)]
