"""Host-side tree-order builders: DFS/BFS programs as dense depth masks.

The port's own copy of ``hierdiff_tpu/data/orders.py`` (pure Python and
numpy): the same functions consume the same ``random.Random`` draws, so a
seed gives the JAX package's DFS steps and walks. The reference drives its
depth-sequential message passing with ragged Python edge lists
(data_utils/data_diffuse.py, MPNN_pattern.py); here the programs are dense
per-depth directed masks (D, N, N).

Conventions (the reference's):
- BFS-toward-`end` layers (get_bfs_order_new, data_diffuse.py:60-79): edges
  directed FROM the node farther from `end` TO the nearer node; layers
  ordered deepest-first so information flows leaves -> end.
- The "circle" layer: a single self-loop on node 0 of each sample, prepended
  as depth 0 (edge_denoise.py:151-152).
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def get_dfs_order(graph: List[List[int]], start: int) -> Dict[str, list]:
    """Preorder DFS with explicit forward/backtrack path.
    (reference: data_diffuse.py:83-96)
    """
    visited = set()
    result = {"order": [], "path": []}

    def rec(node):
        result["order"].append((node, len(result["path"])))
        visited.add(node)
        for nxt in graph[node]:
            if nxt not in visited:
                visited.add(nxt)
                result["path"].append((node, nxt))
                rec(nxt)
                result["path"].append((nxt, node))

    rec(start)
    return result


def adj_to_graph(adj: np.ndarray) -> List[List[int]]:
    n = adj.shape[0]
    graph: List[List[int]] = [[] for _ in range(n)]
    for i, j in zip(*np.nonzero(adj)):
        if j not in graph[i]:
            graph[i].append(int(j))
        if i not in graph[j]:
            graph[j].append(int(i))
    return graph


def dfs_bidirection(adj: np.ndarray, rng: Optional[random.Random] = None,
                    sampling: Optional[int] = None):
    """Pick a random DFS step: (undiscovered, search_ind, last_ind).
    (reference: MPNN_pattern.py:15-42)
    """
    rng = rng or random
    graph = adj_to_graph(adj)
    dfs_result = get_dfs_order(graph, 0)
    dfs_order, dfs_paths = dfs_result["order"], dfs_result["path"]
    idx = sampling if sampling is not None else rng.randint(0, len(dfs_order) - 1)
    if idx == 0:
        return [i for i in range(adj.shape[0])], 0, -1
    search_ind = dfs_order[idx][0]
    search_depth = dfs_order[idx][1]
    dfs_depth = [d[1] for d in dfs_order]
    last_ind = dfs_order[dfs_depth.index(search_depth) - 1][0]
    undiscovered = [dfs_order[i][0] for i in range(len(dfs_order)) if dfs_order[i][1] > search_depth]
    return undiscovered, search_ind, last_ind


def make_search_adjacencies(adj: np.ndarray, undiscovered: Sequence[int],
                            search_ind: int, last_ind: int):
    """(search_adj_org, search_adj): zero rows/cols of undiscovered+search
    node; search_adj additionally contains the last->search edge.
    (reference: MPNN_pattern.py:52-60)
    """
    search = np.array(adj, dtype=np.float64)
    kill = list(undiscovered) + [search_ind]
    search[kill, :] = 0
    search[:, kill] = 0
    org = search.copy()
    if last_ind >= 0:
        search[last_ind, search_ind] = 1
        search[search_ind, last_ind] = 1
    return org, search


def bfs_layers_toward(adj: np.ndarray, end: int) -> List[List[Tuple[int, int]]]:
    """Depth layers of directed edges (far -> near) toward ``end``,
    deepest layer first. Only nodes connected to ``end`` through the given
    adjacency participate. (reference: data_diffuse.py:60-79)
    """
    if adj.sum() == 0:
        return []
    edges = list(zip(*np.nonzero(adj)))
    n_involved = len({v for e in edges for v in e})
    visited = {end}
    layers: List[List[Tuple[int, int]]] = []
    while len(visited) < n_involved:
        depth_edges = []
        cache = []
        for e0, e1 in edges:
            if e0 in visited and e1 not in visited:
                cache.append(e1)
                depth_edges.append((int(e1), int(e0)))  # far -> near
        if not cache:
            break  # disconnected remainder
        visited.update(cache)
        layers.append(depth_edges)
    layers.reverse()
    return layers


def bfs_depth_edges_center(adj: np.ndarray, center: int,
                           rng: Optional[random.Random] = None,
                           walk_len: Optional[int] = None) -> List[List[Tuple[int, int]]]:
    """Refine-model variant: BFS depth layers toward ``center``, optional
    random-walk subsampling. (reference: dataset_refine.py:122-147)
    """
    n = adj.shape[0]
    edges = list(zip(*np.nonzero(adj)))
    depth = [0] * n
    depth[center] = 1
    queue = [center]
    while queue:
        cur = queue.pop(0)
        for e0, e1 in edges:
            if e0 == cur and depth[e1] == 0:
                depth[e1] = depth[e0] + 1
                queue.append(e1)
    max_d = max(depth) if depth else 0
    layers: List[List[Tuple[int, int]]] = [[] for _ in range(max(max_d - 1, 0))]
    for e0, e1 in edges:
        if depth[e0] < depth[e1]:
            layers[depth[e1] - 2].append((int(e1), int(e0)))
    layers.reverse()
    if walk_len is not None and rng is not None:
        walk = random_walk(edges, center, walk_len, rng)
        layers = [[(a, b) for (a, b) in layer if a in walk and b in walk] for layer in layers]
        layers = [l for l in layers if l]
    return layers


def random_walk(edges, start: int, length: int, rng: random.Random) -> List[int]:
    """(reference: dataset_refine.py:152-166)"""
    walk = [start]
    stop = set()
    while len(walk) < length:
        cur = rng.choice(walk)
        nxt = [e1 for (e0, e1) in edges if e0 == cur and e1 not in walk]
        if not nxt:
            stop.add(cur)
            if len(stop) == len(walk):
                break
            continue
        walk.append(rng.choice(nxt))
    return walk


def layers_to_dense(layers: List[List[Tuple[int, int]]], n: int,
                    d_max: int, circle: bool = True) -> np.ndarray:
    """Stack depth layers into (D, N, N) directed masks; depth 0 = the
    node-0 self-loop "circle" when requested. Layers beyond d_max-? are
    clipped; unused depths are all-zero (a no-op in the scan)."""
    offset = 1 if circle else 0
    out = np.zeros((d_max, n, n), np.float32)
    if circle:
        out[0, 0, 0] = 1.0
    for d, layer in enumerate(layers):
        if d + offset >= d_max:
            break
        for (src, dst) in layer:
            out[d + offset, src, dst] = 1.0
    return out
