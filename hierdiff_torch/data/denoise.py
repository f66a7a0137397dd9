"""Training batches of the edge-denoise stage.

Port of ``hierdiff_tpu/data/denoise.py`` (numpy only; the host side of the
reference's dataset_denoise.mol_Tree_pos + PadCollate_onehot): one random
DFS step per tree, the search adjacency of the discovered subgraph and
dense padded tensors; the model builds the depth programs on the device.
With the same trees and ``random.Random`` state the batches are the JAX
package's, bit for bit, and the stream is left in the same state.

Two packers, as in the JAX package: the native one (``runtime/treekit.cpp``,
one ``rng.getrandbits(63)`` per batch seeding a mt19937_64 stream per tree)
when the library is available and the full softmax is used, else the
Python collator (one ``rng.randint`` per tree). Their padding is each
packer's own and is kept as it is.
"""

from __future__ import annotations

import random
from collections import Counter
from typing import Dict, Iterable, List, Optional

import numpy as np

from hierdiff_torch import runtime
from hierdiff_torch.data.assets import load_array_dict
from hierdiff_torch.data.collate import bucket_for
from hierdiff_torch.data.orders import dfs_bidirection, make_search_adjacencies

# the vocabulary's size as the token of a node not discovered yet: 780
# fragment types, so token 780 (MPNN_pattern.py:68-73)
UNDISCOVERED_TOKEN = 780


def find_array_bucket(feat: np.ndarray, arrays: List[np.ndarray]) -> int:
    """The nearest feature-array bucket (edge_denoise.py:535-544)."""
    diffs = [float(((feat - ref) ** 2).sum()) for ref in arrays]
    return int(np.argmin(diffs))


def array_dict_allowed_fn():
    """The size variant's per-node vocab restriction at sampling time, an
    ``allowed_fn`` for the fine samplers: each node's support is the array
    dict's bucket nearest its feature prefix, as ``make_denoise_example``
    restricts the node head in training (reference ar_sampling.py:62-118)."""
    arrays, indices = load_array_dict()
    width = arrays[0].shape[0]

    def allowed_fn(feats: np.ndarray) -> List[List[int]]:
        return [indices[find_array_bucket(f[:width], arrays)] for f in feats]

    return allowed_fn


def make_denoise_example(tree, rng: random.Random, vocab_size: int = 780,
                         use_array_dict: bool = False,
                         sampling: Optional[int] = None) -> Dict[str, np.ndarray]:
    """One autoregressive training step of one tree. ``tree`` has .feats
    (n, 8), .pos (n, 3), .adj (n, n) and .wids (n,); ``sampling`` pins the
    DFS step."""
    n = tree.adj.shape[0]
    undiscovered, search_ind, last_ind = dfs_bidirection(tree.adj, rng, sampling=sampling)
    org, _ = make_search_adjacencies(tree.adj, undiscovered, search_ind, last_ind)

    # nodes with a discovered edge (dataset_denoise.py:134); focal: those of
    # them still missing an edge of the full tree (:131-135)
    discover = org.sum(1) > 0
    val_miss = (tree.adj - org).sum(1) != 0
    focal = discover & val_miss

    undisc_mask = np.zeros(n, np.float32)
    for u in undiscovered:
        undisc_mask[u] = 1.0
    undisc_mask[search_ind] = 1.0
    vocab_idx = np.where(undisc_mask > 0, UNDISCOVERED_TOKEN,
                         np.array(tree.wids, dtype=np.int64))

    ex = {
        "feats": tree.feats.astype(np.float32),
        "pos": tree.pos.astype(np.float32),
        "discovered": discover.astype(np.int32),
        "vocab_idx": vocab_idx.astype(np.int32),
        "search_adj": org.astype(np.float32),
        "focal_label": focal.astype(np.float32),
        "undiscovered": undisc_mask,
        "predict_idx": np.int32(search_ind),
        "last_ind": np.int32(last_ind),
        "label": np.int32(tree.wids[search_ind]),
    }
    if use_array_dict:
        # the buckets are defined over the feature prefix the arrays span
        # (dataset_denoise.py:115-123); the nearest when none matches
        arrays, indices = load_array_dict()
        bucket = find_array_bucket(tree.feats[search_ind][: arrays[0].shape[0]], arrays)
        ex["allowed_idx"] = indices[bucket]
    return ex


def collate_denoise(examples: List[Dict], max_n: Optional[int] = None,
                    vocab_out: int = 780) -> Dict[str, np.ndarray]:
    """Dense padded batch of ``make_denoise_example`` outputs, padded to
    ``max_n`` (default: the bucket of the largest tree)."""
    ns = [e["feats"].shape[0] for e in examples]
    n = max_n if max_n is not None else bucket_for(max(ns))
    b = len(examples)
    f = examples[0]["feats"].shape[1]

    out = {
        "feats": np.zeros((b, n, f), np.float32),
        "pos": np.zeros((b, n, 3), np.float32),
        "discovered": np.zeros((b, n), np.int32),
        "vocab_idx": np.full((b, n), UNDISCOVERED_TOKEN, np.int32),
        "node_mask": np.zeros((b, n, 1), np.float32),
        "edge_mask": np.zeros((b, n, n), np.float32),
        "search_adj": np.zeros((b, n, n), np.float32),
        "focal_label": np.zeros((b, n), np.float32),
        "undiscovered": np.zeros((b, n), np.float32),
        "predict_idx": np.zeros((b,), np.int32),
        "last_ind": np.zeros((b,), np.int32),
        "label": np.zeros((b,), np.int32),
    }
    has_allowed = "allowed_idx" in examples[0]
    if has_allowed:
        out["allowed_mask"] = np.zeros((b, vocab_out), np.float32)
    for i, e in enumerate(examples):
        k = e["feats"].shape[0]
        out["feats"][i, :k] = e["feats"]
        out["pos"][i, :k] = e["pos"]
        out["discovered"][i, :k] = e["discovered"]
        out["vocab_idx"][i, :k] = e["vocab_idx"]
        out["node_mask"][i, :k] = 1.0
        out["edge_mask"][i, :k, :k] = 1.0 - np.eye(k)
        out["search_adj"][i, :k, :k] = e["search_adj"]
        out["focal_label"][i, :k] = e["focal_label"]
        out["undiscovered"][i, :k] = e["undiscovered"]
        out["predict_idx"][i] = e["predict_idx"]
        out["last_ind"][i] = e["last_ind"]
        out["label"][i] = e["label"]
        if has_allowed:
            out["allowed_mask"][i, e["allowed_idx"]] = 1.0
    return out


def make_denoise_batch(trees: Iterable, rng: random.Random, max_n: Optional[int] = None,
                       use_array_dict: bool = False, allow_native: bool = True,
                       packers: Optional[Counter] = None) -> Dict[str, np.ndarray]:
    """A training batch of ``trees``: the native packer when it is available
    (and ``allow_native``, and no array-dict support is asked for), else the
    Python collator. ``packers``, when given, counts the batches each packer
    made ('native' / 'python')."""
    trees = list(trees)
    if allow_native and not use_array_dict and runtime.treekit_available():
        n = max_n if max_n is not None else bucket_for(max(t.feats.shape[0] for t in trees))
        batch = runtime.pack_denoise_batch_native(
            trees, max_n=n, seed=rng.getrandbits(63), undiscovered_token=UNDISCOVERED_TOKEN)
        kind = "native"
    else:
        exs = [make_denoise_example(t, rng, use_array_dict=use_array_dict) for t in trees]
        batch = collate_denoise(exs, max_n=max_n)
        kind = "python"
    if packers is not None:
        packers[kind] += 1
    return batch
