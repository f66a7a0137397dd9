"""Training batches and the vocabulary restriction of the refine stage.

Port of ``hierdiff_tpu/data/refine.py`` (numpy only; the host side of the
reference's data_utils/dataset_refine.py): ``make_refine_batch`` masks one
random node per tree (token 780, zeroed features) and emits dense tensors;
the model builds the BFS depth program on the device. With the same trees
and ``random.Random`` state the batches are the JAX package's, bit for bit.
"""

from __future__ import annotations

import random
from typing import Dict, Iterable, List, Optional

import numpy as np

from hierdiff_torch.data.assets import load_size_dict
from hierdiff_torch.data.collate import bucket_for

# vocab id of a masked node: one past the 780 fragment types
# (hierdiff_tpu/models/refine.py:35)
MASK_TOKEN = 780


def size_support_indices(size: int, vocab_size: int = 780) -> List[int]:
    """Allowed vocab indices for a heavy-atom count, with the reference's
    +-1/+-2 fallback for unseen sizes (ar_sampling_nosize.py:115-122)."""
    sd = load_size_dict()
    if size in sd and sd[size]:
        return sd[size]
    best: List[int] = []
    for perm in (-1, 1, -2, 2):
        cand = sd.get(size + perm, [])
        if len(cand) > len(best):
            best = cand
    return best or list(range(vocab_size))


def make_refine_batch(trees: Iterable, rng: random.Random, max_n: Optional[int] = None,
                      vocab_size: int = 780) -> Dict[str, np.ndarray]:
    """One masked node per tree (``rng.randint``), padded to ``max_n``
    (default: the bucket of the largest tree). ``size_support`` is the
    vocab support of the masked node's heavy-atom count, with its true type
    forced in so that the label is always scorable."""
    trees = list(trees)
    ns = [t.adj.shape[0] for t in trees]
    n = max_n if max_n is not None else bucket_for(max(ns))
    b = len(trees)
    f = trees[0].feats.shape[1]
    out = {
        "feats": np.zeros((b, n, f), np.float32),
        "vocab": np.zeros((b, n), np.int32),
        "size": np.zeros((b, n), np.int32),
        "pos": np.zeros((b, n, 3), np.float32),
        "adj": np.zeros((b, n, n), np.float32),
        "node_mask": np.zeros((b, n, 1), np.float32),
        "predict_idx": np.zeros((b,), np.int32),
        "label": np.zeros((b,), np.int32),
        "val": np.zeros((b,), np.float32),
        "size_support": np.zeros((b, vocab_size), np.float32),
    }
    for i, t in enumerate(trees):
        k = t.adj.shape[0]
        chosen = rng.randint(0, k - 1)
        out["feats"][i, :k] = t.feats
        out["feats"][i, chosen] = 0.0
        out["vocab"][i, :k] = t.wids
        out["vocab"][i, chosen] = MASK_TOKEN
        out["size"][i, :k] = t.sizes
        out["pos"][i, :k] = t.pos
        out["adj"][i, :k, :k] = t.adj
        out["node_mask"][i, :k] = 1.0
        out["predict_idx"][i] = chosen
        out["label"][i] = t.wids[chosen]
        out["val"][i] = t.adj[chosen].sum()
        out["size_support"][i, size_support_indices(int(t.sizes[chosen]), vocab_size)] = 1.0
        out["size_support"][i, t.wids[chosen]] = 1.0
    return out
