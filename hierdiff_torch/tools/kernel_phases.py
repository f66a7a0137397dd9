"""Where the time goes in the fused EGNN kernels, the coarse sampler and the
coarse training step.

    python -m hierdiff_torch.tools.kernel_phases [--only-gcl]

Needs a CUDA GPU. Four measurements, JSON lines (``--only-gcl``: the first
two, for ``fused_gcl`` alone):
  1. per-phase SM cycles inside ``fused_gcl`` (its edge kernel),
     ``fused_coord_update`` (its edge kernel) and ``fused_gcl_bwd`` (its
     edge kernel) at the GEOM layer shapes (B=64, N=32, H=256, E=2, ragged
     node counts), and ``fused_gcl`` also at the two sampling cells' shapes
     (``cell_inputs``), launched with ``phase_clocks=True``: their
     ``-DHD_PHASE_CLOCKS`` build (separate libraries). ``fused_gcl``'s
     warp-specialised edge kernel reports per role (thread 0 of each
     warpgroup): the producer's build and its waits on a free stage, the
     consumers' waits on a built stage, W2 product, epilogue and row sums,
     and the share of tiles whose stage was already built when its consumer
     reached it; the other two edge kernels' thread 0 of every warpgroup
     reads ``clock64`` after each barrier. The same build counts the edge
     slots each edge kernel computes per call and the real edges among
     them, printed beside nnz(edge_mask);
  2. torch.profiler's device time per CUDA kernel for the same calls, and
     also at the sampler's shape (B=64,
     GEOM-histogram counts with seed 0, N = their maximum), where a call's
     host time can exceed its device time, so that CUDA events around
     back-to-back calls measure the host;
  3. the sampler's main path (GEOM config, random weights, batch 64, a few
     reverse steps) under torch.profiler: device time by kernel and the
     device's busy share of the wall time;
  4. the training step (GEOM config, bf16 elementwise as
     configs/coarse_geom.yaml trains, batch 64 from the synthetic GEOM pool's
     bucket mix): CUDA-event times of the forward, the backward, the
     optimizer update and the EMA, the host wall per step, and under
     torch.profiler the device time of the forward kernels, of the
     backward kernel's launches and of everything else (the plain
     coordinate-update autograd, the loss, the optimizer), and the device's
     busy share.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import time
from functools import partial

import numpy as np
import torch

B, N, H, E = 64, 32, 256, 2
# the counters of fused_gcl's edge kernel (csrc/fused_gcl.cu hd_ring_counters):
# cycles of the setup (W2, b2, w_att, barriers) and of 1-6 below, then tiles
# whose stage was built when the consumer reached it, then tiles consumed
GCL_PRODUCER_PHASES = ("build (gathers, silu(pre), stores)", "wait for a free stage")
GCL_CONSUMER_PHASES = ("wait for a built stage", "W2 product (wgmma) and tile edges",
                       "bias, silu, gate and mask (registers)", "row sums (staged halves)")
GCL_RING_COUNTERS = 9
# counters 5-7 of the fused_gcl build: its node kernel (thread 0 of each block)
GCL_NODE_PHASES = ("agg finish, A build, first weight load",
                   "layer-1 product, second weight load, silu", "layer-2 product and output")
# CUDA kernels of csrc/fused_gcl.cu
GCL_KERNELS = ("edge_count_kernel", "edge_fill_kernel", "proj_sm90_kernel", "gcl_edge_kernel",
               "gcl_node_kernel")
COORD_PHASES = ("W2 load and tile setup", "pre-activation build", "W2 product (wgmma)",
                "bias, silu, head, tanh and coordinate terms (registers)",
                "row sums (fixed order)", "grid barrier (waiting for the last block)",
                "output (x + agg / norm) * nmask")
BWD_PHASES = ("W2 load and tile setup", "pre-activation build", "W2 product (wgmma), u out",
              "gate and silu backward (registers), dv sums", "du product (wgmma), sums and dv out",
              "dpre rebuilt (registers), dpre out", "dpre and e^T dpre sums, de")
# CUDA kernels of csrc/fused_gcl_bwd.cu besides proj_kernel and the work list's
# two kernels (those share their names with the forward's)
BACKWARD_KERNELS = ("gcl_bwd_edge_kernel", "gemm_kernel", "node_prep_kernel", "node_act_kernel",
                    "node_dz_kernel", "node_split_kernel", "reduce_kernel", "colsum_kernel",
                    "posmap_kernel", "node_edge_sums_kernel")


def layer_inputs(rng: np.random.Generator, device, b: int = B, n: int = N, h: int = H,
                 counts=None):
    """Masked layer inputs with ragged node counts (uniform in [n // 4, n],
    the first molecule full, unless ``counts`` are given): h, x, edge_attr =
    [radial, distances0] (E=2), coord_diff, edge_mask (b,n,n,1), node_mask
    (b,n,1), counts."""
    from hierdiff_torch.sampling.coarse import make_masks_for_counts

    if counts is None:
        counts = rng.integers(n // 4, n + 1, size=b)
        counts[0] = n
    nm, em = make_masks_for_counts(counts, n)
    return (*_inputs_for_masks(rng, device, nm, em, h), counts)


def _inputs_for_masks(rng: np.random.Generator, device, nm: np.ndarray, em: np.ndarray,
                      h: int = H):
    """h, x, edge_attr = [radial, distances0], coord_diff, edge_mask
    (b,n,n,1) and node_mask (b,n,1) for the given masks."""
    from hierdiff_torch.ops.egnn import coord2diff_dense

    b, n = nm.shape[:2]
    node_mask = torch.from_numpy(nm).to(device)
    edge_mask = torch.from_numpy(em).to(device)[..., None].contiguous()
    hh = torch.from_numpy(rng.standard_normal((b, n, h)).astype(np.float32)).to(device) * node_mask
    x = torch.from_numpy(rng.standard_normal((b, n, 3)).astype(np.float32) * 2).to(device) * node_mask
    radial, coord_diff = coord2diff_dense(x, 0.0)
    d0, _ = coord2diff_dense(x, 1.0)
    edge_attr = torch.cat([radial, d0], dim=-1).contiguous()
    return hh, x, edge_attr, coord_diff.contiguous(), edge_mask, node_mask


def stratified_counts(name: str, n: int) -> np.ndarray:
    """The ``n`` stratified quantiles of the named fragment-count histogram,
    sorted: count i is the smallest c with CDF(c) >= (i + 0.5) / n. Every
    request of the sampling cells holds this multiset of node counts."""
    from hierdiff_torch.data.assets import load_histogram

    hist = load_histogram(name)
    ks = np.array(sorted(hist), np.int64)
    p = np.array([hist[int(k)] for k in ks], np.float64)
    cdf = np.cumsum(p / p.sum())
    return ks[np.minimum(np.searchsorted(cdf, (np.arange(n) + 0.5) / n), len(ks) - 1)]


# the two sampling cells: (histogram, molecules, pocket residues)
CELLS = {"geom": ("geom", 256, 0), "pocket": ("crossdock", 64, 32)}


def cell_inputs(rng: np.random.Generator, device, cell: str, h: int = H):
    """Layer inputs at a sampling cell's shape, node counts in the rng's
    order: ``geom``, 256 GEOM-histogram molecules padded to their largest
    (35 rows); ``pocket``, 64 CrossDocked-histogram molecules padded to
    their largest (35), then a 32-residue pocket with its own edges and the
    molecule <-> pocket cross edges (67 rows), as ``sample_coarse_pocket``
    lays them out. Returns ``layer_inputs``' tuple; counts are the
    molecules'."""
    from hierdiff_torch.models.diffusion import pocket_edge_mask
    from hierdiff_torch.sampling.coarse import make_masks_for_counts

    name, b, k = CELLS[cell]
    counts = rng.permutation(stratified_counts(name, b))
    nm, em = make_masks_for_counts(counts)
    if k:
        pm = np.ones((b, k, 1), np.float32)
        pem = np.broadcast_to(1.0 - np.eye(k, dtype=np.float32), (b, k, k))
        em = pocket_edge_mask(torch.from_numpy(nm), torch.from_numpy(em), torch.from_numpy(pm),
                              torch.from_numpy(np.ascontiguousarray(pem)), True).numpy()
        nm = np.concatenate([nm, pm], axis=1)
    return (*_inputs_for_masks(rng, device, nm, np.ascontiguousarray(em), h), counts)


def cell_shape(cell: str) -> str:
    """The name of a cell's shape in this tool's and gcl_ab's output."""
    name, b, k = CELLS[cell]
    return f"{cell} cell B={b} N={int(stratified_counts(name, b).max()) + k}"


def sampler_counts(b: int = B, seed: int = 0) -> np.ndarray:
    """Node counts of one sampler batch: b draws from the GEOM histogram
    (the sampler's own shape is then N = their maximum)."""
    from hierdiff_torch.data.assets import load_histogram
    from hierdiff_torch.ops.distributions import DistributionNodes

    return DistributionNodes(load_histogram("geom")).sample_np(np.random.default_rng(seed), b)


def _device_us(prof, calls: int) -> dict:
    """Device time per call of each CUDA kernel. Only device-side events
    count: the CPU operators that launched them report the same time."""
    from torch.autograd import DeviceType

    out = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA or evt.key.startswith("Optimizer."):
            continue   # the optimizer's range annotation repeats its kernels' time
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = evt.self_cuda_time_total
        if t > 0:
            out[evt.key[:80]] = t / calls
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _counters(lib, reader: str, n: int, fn, reps: int) -> list:
    """The counters ``reader`` of ``lib`` over ``reps`` calls of ``fn``
    (phase-clock build), after three warm-up calls."""
    read = getattr(lib, reader)
    read.argtypes = [ctypes.c_void_p]
    read.restype = ctypes.c_int
    counters = (ctypes.c_ulonglong * n)()
    for _ in range(3):
        fn(phase_clocks=True)
    torch.cuda.synchronize()
    read(counters)          # drop the warm-up
    for _ in range(reps):
        fn(phase_clocks=True)
    torch.cuda.synchronize()
    if read(counters) != 0:
        raise RuntimeError(f"reading {reader} failed")
    return list(counters)


def gcl_ring_split(c: list, reps: int) -> dict:
    """fused_gcl's edge-kernel counters (``hd_ring_counters``, summed over
    ``reps`` calls) as each role's share of its cycles, per call."""
    prod, cons = c[1:3], c[3:7]
    share = lambda names, v: {p: x / max(sum(v), 1) for p, x in zip(names, v)}  # noqa: E731
    return {"producer_cycle_share": share(GCL_PRODUCER_PHASES, prod),
            "consumer_cycle_share": share(GCL_CONSUMER_PHASES, cons),
            "producer_cycles_per_call_summed_over_warpgroups": sum(prod) / reps,
            "consumer_cycles_per_call_summed_over_warpgroups": sum(cons) / reps,
            "setup_cycles_per_call_summed_over_warpgroups": c[0] / reps,
            "tiles_per_call": c[8] / reps,
            "stage_already_built_share": c[7] / max(c[8], 1)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only-gcl", action="store_true",
                    help="measurements 1 and 2 for fused_gcl alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_phases: needs a CUDA GPU")
    from torch.profiler import ProfilerActivity, profile

    from hierdiff_torch.ops import _build, egnn_kernels as ek
    from hierdiff_torch.ops.egnn import DenseEquivariantUpdate, DenseGCL
    from hierdiff_torch.utils.weights import init_weights

    device = torch.device("cuda")
    torch.set_grad_enabled(False)
    rng = np.random.default_rng(0)
    hh, x, e, cdiff, em, nm, _ = layer_inputs(rng, device)
    gcl = init_weights(DenseGCL(H, E, normalization_factor=10.0, attention=True).to(device),
                       torch.Generator().manual_seed(0))
    g = torch.from_numpy(rng.standard_normal(hh.shape).astype(np.float32)).to(device)
    agg = torch.empty_like(hh)
    ek._launch_gcl(gcl, hh, e, em, nm, hh.device, agg_out=agg)
    equ = init_weights(DenseEquivariantUpdate(H, E, normalization_factor=10.0, tanh=True,
                                              coords_range=5.0).to(device),
                       torch.Generator().manual_seed(0))
    cells = {cell_shape(c): cell_inputs(np.random.default_rng(0), device, c) for c in CELLS}
    # (wrapper, shape, call, library, edge mask)
    calls = [("fused_gcl", "kernel", partial(ek.fused_gcl, gcl, hh, e, em, nm), "fused_gcl", em)]
    calls += [("fused_gcl", shape, partial(ek.fused_gcl, gcl, c_[0], c_[2], c_[4], c_[5]), "fused_gcl",
               c_[4]) for shape, c_ in cells.items()]
    if not args.only_gcl:
        calls += [("fused_coord_update", "kernel",
                   partial(ek.fused_coord_update, equ, hh, e, cdiff, x, em, nm), "fused_coord", em),
                  ("fused_gcl_bwd", "kernel", partial(ek.fused_gcl_bwd, gcl, hh, e, em, nm, g, agg),
                   "fused_gcl_bwd", em)]
    phases = {"fused_coord_update": COORD_PHASES, "fused_gcl_bwd": BWD_PHASES}
    reps = 10

    # 1. phase clocks (instrumented build)
    _build.build_all(phase_clocks=True)
    for name, shape, fn, lib_name, mask in calls:
        lib = _build.load_library(lib_name, phase_clocks=True)
        counters = _counters(lib, "hd_read_phase_cycles", 8, fn, reps)
        line = {"kernel": name, "shape": shape}
        if name == "fused_gcl":   # the edge kernel's roles, then the node kernel
            line.update(gcl_ring_split(_counters(lib, "hd_read_ring_counters", GCL_RING_COUNTERS,
                                                 fn, reps), reps))
            node = [counters[5 + i] for i in range(len(GCL_NODE_PHASES))]
            line["node_kernel_phase_cycle_share"] = {
                p: c / max(sum(node), 1) for p, c in zip(GCL_NODE_PHASES, node)}
            line["node_kernel_cycles_per_call_summed_over_blocks"] = sum(node) / reps
        else:
            total = sum(counters[i] for i in range(len(phases[name])))
            line.update({"phase_cycle_share": {p: counters[i] / total
                                               for i, p in enumerate(phases[name])},
                         "cycles_per_call_summed_over_blocks": total / reps})
        # edges computed against the mask's real edges
        edges = (ctypes.c_ulonglong * 2)()
        lib.hd_read_edge_counts.argtypes = [ctypes.c_void_p]
        lib.hd_read_edge_counts(edges)   # the warm-up and the calls above
        fn(phase_clocks=True)
        torch.cuda.synchronize()
        if lib.hd_read_edge_counts(edges) != 0:
            raise RuntimeError("reading the edge counts failed")
        line.update({"edge_slots_computed_per_call": edges[0],
                     "real_edges_computed_per_call": edges[1],
                     "nnz_edge_mask": int((mask != 0).sum().item()),
                     "dense_edges": mask.numel()})
        print(json.dumps(line))

    # 2. device time per CUDA kernel, uninstrumented build
    s_counts = sampler_counts(B, 0)
    s_h, s_x, s_e, s_cdiff, s_em, s_nm, _ = layer_inputs(np.random.default_rng(0), device,
                                                         n=int(s_counts.max()), counts=s_counts)
    s_g = torch.from_numpy(rng.standard_normal(s_h.shape).astype(np.float32)).to(device)
    s_agg = torch.empty_like(s_h)
    ek._launch_gcl(gcl, s_h, s_e, s_em, s_nm, s_h.device, agg_out=s_agg)
    sampler = f"sampler N={int(s_counts.max())}"
    shaped = [(shape, name, fn) for name, shape, fn, _, _ in calls]
    shaped.append((sampler, "fused_gcl", partial(ek.fused_gcl, gcl, s_h, s_e, s_em, s_nm)))
    if not args.only_gcl:
        shaped += [(sampler, "fused_coord_update",
                    partial(ek.fused_coord_update, equ, s_h, s_e, s_cdiff, s_x, s_em, s_nm)),
                   (sampler, "fused_gcl_bwd",
                    partial(ek.fused_gcl_bwd, gcl, s_h, s_e, s_em, s_nm, s_g, s_agg))]
    for shape, name, fn in shaped:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        per_kernel = _device_us(prof, reps)
        print(json.dumps({"wrapper": name, "shape": shape, "device_us_per_call": per_kernel,
                          "device_us_per_call_total": sum(per_kernel.values())}))
    if args.only_gcl:
        return

    # 3. the sampler's main path
    from hierdiff_torch.config import CoarseModelConfig
    from hierdiff_torch.sampling.cli import build_coarse_from_cfg
    from hierdiff_torch.sampling.coarse import make_masks_for_counts, sample_coarse

    model = init_weights(build_coarse_from_cfg(CoarseModelConfig(), device=device),
                         torch.Generator().manual_seed(0))
    counts = sampler_counts(B, 0)
    node_mask, edge_mask = (torch.from_numpy(a).to(device) for a in make_masks_for_counts(counts))
    gen = torch.Generator(device=device).manual_seed(0)
    steps = 10
    sample_coarse(model, node_mask, edge_mask, gen, steps=2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        sample_coarse(model, node_mask, edge_mask, gen, steps=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    per_kernel = _device_us(prof, steps + 1)
    busy_us = sum(per_kernel.values())
    print(json.dumps({"main_path": {"batch": B, "max_nodes": int(counts.max()),
                                    "steps": steps, "wall_ms_per_forward": wall * 1e3 / (steps + 1),
                                    "device_busy_share": busy_us * (steps + 1) / (wall * 1e6),
                                    "device_us_per_forward": per_kernel}}))

    # 4. the training step
    torch.set_grad_enabled(True)
    print(json.dumps({"train_step": train_step_breakdown(device)}))


def train_step_breakdown(device: torch.device, steps: int = 8) -> dict:
    """Per-step times of the GEOM training step (see the module docstring)."""
    from torch.profiler import ProfilerActivity, profile

    from hierdiff_torch.config import load_config
    from hierdiff_torch.parallel.train_step import TrainState
    from hierdiff_torch.sampling.cli import build_coarse_from_cfg
    from hierdiff_torch.train.data_iters import coarse_iter, load_tree_pool, to_device
    from hierdiff_torch.utils.weights import init_weights

    cfg = load_config(None, ["coarse.compute_dtype=bfloat16", f"train.batch_size={B}",
                             "train.num_train_trees=512"])
    model = init_weights(build_coarse_from_cfg(cfg.coarse, device=device).train(),
                         torch.Generator().manual_seed(0))
    state = TrainState(model, cfg.optim)
    gen = torch.Generator(device=device).manual_seed(0)
    it = coarse_iter(cfg, load_tree_pool(cfg, seed=0), seed=0)
    batches = [to_device(next(it), device) for _ in range(steps + 2)]

    def step(batch, events=None):
        mark = (lambda i: events[i].record()) if events else (lambda i: None)
        mark(0)
        out = model(batch, gen, train=True)
        mark(1)
        state.optimizer.zero_grad(set_to_none=True)
        out["loss"].backward()
        mark(2)
        state.update()
        mark(3)
        state.update_ema()
        mark(4)

    for batch in batches[:2]:   # warm-up: kernel build, caches, allocator
        step(batch)
    torch.cuda.synchronize()
    parts = np.zeros(4)
    start = time.perf_counter()
    for batch in batches[2:]:
        events = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        step(batch, events)
        torch.cuda.synchronize()
        parts += [events[i].elapsed_time(events[i + 1]) for i in range(4)]
    wall_ms = (time.perf_counter() - start) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        p_start = time.perf_counter()
        for batch in batches[2:]:
            step(batch)
        torch.cuda.synchronize()
        p_wall = time.perf_counter() - p_start
    per_kernel = _device_us(prof, steps)
    group = lambda names: sum(v for k, v in per_kernel.items()   # noqa: E731
                              if any(f"hd::{n}" in k for n in names))
    busy_us = sum(per_kernel.values())
    # the coordinate update takes its plain route here; proj_kernel
    # (edge_mlp.cuh) runs in the backward, the forward has proj_sm90_kernel;
    # the backward's work list shares its kernels' names with the forward's,
    # so its two launches per call count as forward kernels
    fwd_us = group(GCL_KERNELS)
    bwd_us = group(BACKWARD_KERNELS) + group(("proj_kernel",))
    return {"batch": B, "steps": steps, "bucket_mix": [int(b["positions"].shape[1]) for b in batches[2:]],
            "wall_ms_per_step": wall_ms,
            "event_ms_per_step": dict(zip(("forward", "backward", "optimizer", "ema"),
                                          (parts / steps).tolist())),
            "device_us_per_step": {"forward_kernels": fwd_us, "backward_kernel": bwd_us,
                                   "other": busy_us - fwd_us - bwd_us},
            "device_busy_share": busy_us / (wall_ms * 1e3),
            "device_busy_share_under_profiler": busy_us * steps / (p_wall * 1e6),
            "top_kernels_us_per_step": dict(list(per_kernel.items())[:25])}


if __name__ == "__main__":
    main()
