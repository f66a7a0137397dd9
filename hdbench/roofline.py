"""The yardstick: the H100's peaks, each kernel's least work, the least time
for it, and the coarse model's matmul FLOPs.

``coord_work``, ``gcl_work``, ``bwd_work`` and ``bound`` are frozen copies of
``chip_smoke.py``'s (see README.md for the commit), with the hidden width
``h`` and the edge features ``e`` as arguments where the copies read the
module constants H = 256 and E = 2. ``tests/test_hdbench_roofline.py`` pins
them to the originals and to hand counts.

A kernel's work is counted over the real edges and nodes of its call: each
input byte read once, each output byte written once, each bf16 product and
each exp / reciprocal once.
"""

from __future__ import annotations

# H100 SXM, NVIDIA's data sheet, dense: bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
SFU_PER_CLOCK_PER_SM = 16     # exp2 / reciprocal results per clock (cc 9.0)


def pair_weight_bytes(h: int, e: int) -> int:
    """bf16 W_src, W_dst, W_e and W2 with f32 b1 and b2."""
    return (2 * h * h + e * h + h * h) * 2 + 2 * h * 4


def coord_work(n_edges: float, n_nodes: float, b: int, n: int, h: int = 256, e: int = 2):
    """fused_coord_update's least work for a batch: bf16 FLOPs, SFU
    operations and bytes."""
    flops = n_edges * (2 * h * h + 2 * e * h + 2 * h) + n_nodes * 4 * h * h
    sfu = n_edges * (4 * h + 1)
    nbytes = (b * n * h * 4 + b * n * n * e * 4 + b * n * n * 3 * 4 + b * n * n * 4 + b * n * 4
              + b * n * 3 * 4 * 2 + pair_weight_bytes(h, e) + h * 2)
    return flops, sfu, nbytes


def gcl_work(n_edges: float, n_nodes: float, b: int, n: int, h: int = 256, e: int = 2):
    """fused_gcl's least work for a batch: bf16 FLOPs, SFU operations and
    bytes."""
    flops = n_edges * (2 * h * h + 2 * e * h + 2 * h) + n_nodes * 10 * h * h
    sfu = n_edges * (4 * h + 2) + n_nodes * 2 * h
    nbytes = (b * n * h * 4 * 2 + b * n * n * e * 4 + b * n * n * 4 + b * n * 4
              + pair_weight_bytes(h, e) + (h + 3 * h * h) * 2 + 3 * h * 4)
    return flops, sfu, nbytes


def bwd_work(n_edges: float, n_nodes: float, b: int, n: int, h: int = 256, e: int = 2):
    """fused_gcl_bwd's least work for a batch: per real edge the
    rematerialised u W2, du = dv W2^T and dW2 (6 H^2), the pair and edge
    terms (6 E H) and the gate (6 H); per node the node-MLP backward with its
    rematerialised forward and the node-level products (28 H^2)."""
    flops = n_edges * (6 * h * h + 6 * e * h + 6 * h) + n_nodes * 28 * h * h
    sfu = n_edges * (4 * h + 2) + n_nodes * 2 * h
    nbytes = (b * n * h * 4 * 4 + b * n * n * e * 4 * 2 + b * n * n * 4 + b * n * 4
              + (10 * h * h + e * h) * 2 + 6 * h * 4 + (6 * h * h + e * h + 5 * h + 1) * 4)
    return flops, sfu, nbytes


WORK = {"fused_gcl": gcl_work, "fused_coord_update": coord_work, "fused_gcl_bwd": bwd_work}


def bound(flops: float, sfu_ops: float, nbytes: float, sm_clock_hz: float, n_sms: int):
    """Least time (ms) for the work: the larger of bytes over HBM rate and
    operations over their unit's rate (bf16 tensor cores, SFU)."""
    t_bytes = nbytes / PEAK_BYTES
    t_tensor = flops / PEAK_BF16_FLOPS
    t_sfu = sfu_ops / (SFU_PER_CLOCK_PER_SM * n_sms * sm_clock_hz)
    by = "bytes" if t_bytes >= max(t_tensor, t_sfu) else "operations"
    return max(t_bytes, t_tensor, t_sfu) * 1e3, by, {
        "bytes_ms": t_bytes * 1e3, "tensor_ms": t_tensor * 1e3, "sfu_ms": t_sfu * 1e3}


def egnn_forward_flops(n_edges: float, n_nodes: float, h: int = 256, e: int = 2,
                       blocks: int = 6, gcls: int = 2, f_in: int = 9) -> float:
    """Matmul FLOPs of one EGNN forward over the real edges and nodes: per
    GCL the edge MLP (pair linear factored into per-node projections, the
    second linear, the gate) and the node MLP; per block one coordinate
    update (its pair linear factored likewise, the middle linear, the
    scalar head); the input and output embeddings. The kernels' own counts,
    so that no kernel's share can exceed the step's."""
    gcl = n_edges * (2 * h * h + 2 * e * h + 2 * h) + n_nodes * 10 * h * h
    coord = n_edges * (2 * h * h + 2 * e * h + 2 * h) + n_nodes * 4 * h * h
    embed = n_nodes * 2 * 2 * f_in * h
    return blocks * (gcls * gcl + coord) + embed


def complete_graph_work(counts) -> tuple:
    """(real edges, real nodes) of molecules of ``counts`` nodes, each fully
    connected without self-loops."""
    edges = sum(int(c) * (int(c) - 1) for c in counts)
    return float(edges), float(sum(int(c) for c in counts))
