"""Batch iterators of the three training stages.

Port of ``hierdiff_tpu/train/data_iters.py``: the synthetic GEOM-like pool or a directory of preprocessed ``.npz`` trees
(``load_tree_pool``), batches of one bucket each, the bucket drawn in
proportion to its population and the trees within it with replacement
(``_sample_bucket_batch``), collated for the coarse stage (``coarse_iter``),
the edge-denoise stage (``denoise_iter``) or the refine stage
(``refine_iter``); the pocket family's coarse batches carry synthetic
pockets (``synthetic_pockets``). They take the JAX package's Python and numpy draws in its
order, so the same seed gives the same batches. Under data parallelism every
rank draws the same global batches and keeps its rows after collation, before
the copy to the device (``shard_iter``). A prefetcher collates on a
thread and copies pinned host tensors to the device with
``non_blocking=True``; it issues no collective.
"""

from __future__ import annotations

import json
import queue
import random
import threading
from collections import Counter
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from hierdiff_torch.config import Config
from hierdiff_torch.data.collate import bucket_for, collate_coarse
from hierdiff_torch.data.denoise import make_denoise_batch
from hierdiff_torch.data.refine import make_refine_batch
from hierdiff_torch.data.synthetic import SyntheticTree, SyntheticTreeGenerator
from hierdiff_torch.parallel.mesh import shard_batch


def load_tree_pool(cfg: Config, seed: int = 0) -> List[SyntheticTree]:
    """Synthetic pool of ``train.num_train_trees`` trees, or the ``.npz``
    tree files under ``train.data`` (optionally those named by the JSON list
    ``train.data_split``)."""
    src = cfg.train.data
    if src == "synthetic":
        gen = SyntheticTreeGenerator(seed=seed, mode=cfg.coarse.node_coarse_type,
                                     dataset=cfg.coarse.dataset)
        return gen.sample_trees(cfg.train.num_train_trees)
    names = None
    if cfg.train.data_split:
        names = set(json.loads(Path(cfg.train.data_split).read_text()))
    pool = []
    for p in sorted(Path(src).glob("*.npz")):
        if names is not None and p.name not in names:
            continue
        with np.load(p) as z:
            pool.append(SyntheticTree(feats=z["feats"], pos=z["pos"], adj=z["adj"],
                                      wids=z["wids"], sizes=z["sizes"]))
    if not pool:
        raise FileNotFoundError(f"no .npz trees under {src}")
    return pool


def _group_by_bucket(pool, buckets) -> Dict[int, List]:
    groups: Dict[int, List] = {}
    dropped = 0
    for t in pool:
        if t.feats.shape[0] > max(buckets):
            dropped += 1
            continue
        groups.setdefault(bucket_for(t.feats.shape[0], buckets), []).append(t)
    if dropped:
        print(f"[data] dropped {dropped} trees larger than bucket {max(buckets)}")
    return groups


def _sample_bucket_batch(groups: Dict[int, List], rng: random.Random, batch_size: int):
    """A bucket drawn in proportion to its trees, then ``batch_size`` of
    its trees with replacement."""
    keys = list(groups.keys())
    weights = [len(groups[k]) for k in keys]
    bkt = rng.choices(keys, weights=weights)[0]
    return bkt, rng.choices(groups[bkt], k=batch_size)


POCKET_RESIDUES = 16   # K of the synthetic pockets


def synthetic_pockets(rng: np.random.Generator, positions: np.ndarray,
                      node_mask: np.ndarray, k: int = POCKET_RESIDUES) -> Dict[str, np.ndarray]:
    """Random C-alpha shells around each molecule: residue tokens 1..20 at
    pocket-like distances (4-8 A from a random molecule node), in the tensor
    schema of ``chem.pocket.collate_pockets``. They stand in for CrossDocked
    pocket data so the pocket family trains without the dataset; the draws
    are the JAX package's, in its order."""
    b = positions.shape[0]
    counts = node_mask[..., 0].sum(axis=1).astype(np.int64)
    feat = rng.integers(1, 21, (b, k)).astype(np.int32)
    anchor_idx = rng.integers(0, np.maximum(counts, 1))[:, None]           # (B,1)
    anchors = np.take_along_axis(positions, anchor_idx[..., None], axis=1)  # (B,1,3)
    direction = rng.standard_normal((b, k, 3))
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True) + 1e-9
    radius = 4.0 + 4.0 * rng.random((b, k, 1))
    pos = (anchors + direction * radius).astype(np.float32)
    nm = np.ones((b, k, 1), np.float32)
    em = np.broadcast_to((1.0 - np.eye(k))[None], (b, k, k)).astype(np.float32)
    return {"protein_feat": feat, "protein_pos": pos,
            "protein_feat_mask": nm, "protein_edge_mask": em}


def coarse_iter(cfg: Config, pool, seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Endless numpy batches of the coarse stage; with ``coarse.pocket``
    each carries synthetic pockets drawn from ``np.random.default_rng(seed)``."""
    rng = random.Random(seed)
    np_rng = np.random.default_rng(seed)
    groups = _group_by_bucket(pool, cfg.train.buckets)
    while True:
        bkt, trees = _sample_bucket_batch(groups, rng, cfg.train.batch_size)
        batch = collate_coarse(trees, max_n=bkt)
        if cfg.coarse.pocket and "protein_pos" not in batch:
            batch.update(synthetic_pockets(np_rng, batch["positions"], batch["atom_mask"]))
        yield batch


def denoise_iter(cfg: Config, pool, seed: int = 0,
                 packers: Optional[Counter] = None) -> Iterator[Dict[str, np.ndarray]]:
    """Endless numpy batches of the edge-denoise stage; the node head's
    support is restricted by the array dict when ``denoise.full_softmax``
    is off. ``packers`` counts the batches each packer made."""
    rng = random.Random(seed)
    groups = _group_by_bucket(pool, cfg.train.buckets)
    use_array = not cfg.denoise.full_softmax
    while True:
        bkt, trees = _sample_bucket_batch(groups, rng, cfg.train.batch_size)
        yield make_denoise_batch(trees, rng, max_n=bkt, use_array_dict=use_array,
                                 packers=packers)


def refine_iter(cfg: Config, pool, seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Endless numpy batches of the refine stage."""
    rng = random.Random(seed)
    groups = _group_by_bucket(pool, cfg.train.buckets)
    while True:
        bkt, trees = _sample_bucket_batch(groups, rng, cfg.train.batch_size)
        yield make_refine_batch(trees, rng, max_n=bkt, vocab_size=cfg.refine.vocab_size)


def shard_iter(it: Iterator[Dict[str, np.ndarray]], rank: int,
               size: int) -> Iterator[Dict[str, np.ndarray]]:
    """Rank ``rank``'s rows of each global numpy batch of ``it``
    (``parallel/mesh.shard_batch``); at size 1 every row."""
    for batch in it:
        yield shard_batch(batch, rank, size)


def finite(it: Iterator, n: int) -> Iterator:
    for _ in range(n):
        yield next(it)


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device``; for CUDA through pinned host
    memory with ``non_blocking=True`` copies."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out


def prefetch_to_device(it: Iterator[Dict[str, np.ndarray]], device: torch.device,
                       size: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Collate and copy the next ``size`` batches on a background thread
    while the current step runs. The copies are issued on the device's
    current stream, so a step that uses a batch is ordered after its copy."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    end = object()

    def worker():
        try:
            for batch in it:
                q.put(to_device(batch, device))
        except BaseException as exc:   # re-raised in the consumer
            q.put(exc)
        finally:
            q.put(end)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, BaseException):
            raise item
        yield item
