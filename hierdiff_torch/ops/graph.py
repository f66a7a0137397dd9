"""Graph utilities of the fine stage: BFS depths and depth-layer masks.

Port of ``hierdiff_tpu/ops/graph.py``. BFS distances come from frontier
expansion over the dense adjacency, one batched product per step, so a
depth program never leaves the device and never waits on the host.
"""

from __future__ import annotations

import torch
from torch import Tensor


def bfs_depths(adj: Tensor, start_onehot: Tensor) -> Tensor:
    """BFS distance from ``start`` over a symmetric dense adjacency.

    adj (B, N, N) 0/1, start_onehot (B, N). Returns (B, N) int32 depths, -1
    for unreachable nodes, and -1 everywhere when start_onehot is all zero
    (the root step). N - 1 frontier steps run whatever the depth, so the
    loop needs no host read."""
    n = adj.shape[1]
    depth = torch.where(start_onehot > 0, 0, -1).to(torch.int32)
    frontier = start_onehot.to(adj.dtype)
    for d in range(1, n):
        reached = torch.bmm(adj, frontier[..., None])[..., 0] > 0
        new = reached & (depth < 0)
        depth = torch.where(new, torch.full_like(depth, d), depth)
        frontier = new.to(adj.dtype)
    return depth


def depth_layer_mask(adj: Tensor, depth: Tensor, d) -> Tensor:
    """Directed mask (B, N, N) of the BFS layer at distance ``d``: edges from
    nodes at depth d to their depth-(d-1) neighbours (far -> near)."""
    di = depth[:, :, None]
    dj = depth[:, None, :]
    return adj * ((di == d) & (dj == d - 1) & (dj >= 0)).to(adj.dtype)


def circle_mask(b: int, n: int, dtype=torch.float32, device=None) -> Tensor:
    """The reference's "circle" layer: a self-loop on node 0 of each sample.
    (reference: edge_denoise.py:151-152)"""
    m = torch.zeros((b, n, n), dtype=dtype, device=device)
    m[:, 0, 0] = 1.0
    return m
