"""Bucketed dense collation of padded fragment-tree batches.

Port of ``hierdiff_tpu/data/collate.py`` (``DEFAULT_BUCKETS``, ``bucket_for``,
``collate_coarse``): node counts are padded to a small set of buckets, and a
batch is node features, positions, a node mask and a fully connected,
self-loop-free edge mask (the reference's ``PadCollate``,
endiffusion/dataset/blur_utils.py:110-155). numpy only.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

import numpy as np

DEFAULT_BUCKETS = (8, 16, 24, 32, 48, 64, 96)


def bucket_for(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """The smallest bucket that holds ``n`` nodes."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"tree with {n} nodes exceeds the largest bucket {buckets[-1]}")


def collate_coarse(trees: Iterable, max_n: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Dense batch for the coarse diffusion stage from trees with ``.feats``
    (n, F) and ``.pos`` (n, 3), padded to ``max_n`` (default: the bucket of
    the largest tree)."""
    trees = list(trees)
    ns = [t.feats.shape[0] for t in trees]
    n = max_n if max_n is not None else bucket_for(max(ns))
    b = len(trees)
    f = trees[0].feats.shape[1]
    feats = np.zeros((b, n, f), np.float32)
    pos = np.zeros((b, n, 3), np.float32)
    node_mask = np.zeros((b, n, 1), np.float32)
    edge_mask = np.zeros((b, n, n), np.float32)
    for i, t in enumerate(trees):
        k = t.feats.shape[0]
        feats[i, :k] = t.feats
        pos[i, :k] = t.pos
        node_mask[i, :k] = 1.0
        edge_mask[i, :k, :k] = 1.0 - np.eye(k)
    return {"node_feature": feats, "positions": pos, "atom_mask": node_mask,
            "edge_mask": edge_mask}
