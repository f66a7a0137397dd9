#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``hierdiff_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one output line each, any failure exits non-zero:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions, then the nvcc build of ``hierdiff_torch/csrc`` (and, beside
     it, the phase-clock build of fused_gcl_bwd, which counts the edges its
     edge kernel computes) and its time, and the number of HGMMA (wgmma)
     instructions in each built library (``cuobjdump --dump-sass``), none
     of which may be 0;
  2. each kernel against its plain PyTorch version at the kernel shape
     (B=64, N=32, H=256, E=2, ragged node counts), on what the layer adds
     to its input (out - h for fused_gcl, out - x for fused_coord_update):
     the max error over the largest reference value must stay below 2e-2
     (the bar the Pallas kernels meet against XLA in
     tests/test_pallas_interpret.py). fused_gcl runs once more with a node
     MLP that passes the aggregated messages through, so the edge path is
     not hidden behind the node MLP's h term, and fused_coord_update with a
     coordinate head large enough to saturate tanh, in all four variants
     (attention or tanh on/off x f32/bf16 elementwise). Both kernels compute
     only the edges their edge mask holds, so both also run (fused_gcl with
     the pass-through node MLP), in all four variants, at the sampler's
     shape (GEOM-histogram counts, N = their maximum), on a batch with
     83-node molecules (rows longer than a 64-edge tile), on node masks that
     do not start at node 0 with ~20% of the real edges masked out and
     nonzero h in padded rows, and on molecules of 0 and 1 nodes; two runs
     of each must be bitwise equal. Planted faults (fused_gcl: gate skipped,
     a W2 output channel zeroed, edge mask ignored, the edge mask without
     its holes given to the kernel only; fused_coord_update: tanh skipped, a
     W2 output channel zeroed and the same two edge-mask faults), each run
     through the kernel, must fail that check. Kernel, plain and bound
     times at the kernel and the sampler's shapes (device times: the timed
     calls queued behind a sleeping kernel), and with ``--parent DIR`` (an
     unpacked earlier tree of this repository) the time of that tree's
     kernel beside this one's, each run by its own wrapper in turns
     (tools/gcl_ab.py), for the backward kernel too;
  2b. the backward kernel ``fused_gcl_bwd`` against autograd of the plain
     version (``gcl_plain_vjp``) with a random upstream gradient, at the
     kernel shape and on every case of phase 2 (the sampler's shape, 83-node
     rows with 0- and 1-node molecules, holey masks, molecules of 0 and 1
     nodes), attention on and off x f32 and bf16 elementwise, plus the
     pass-through node MLP: every gradient (dh, de, each weight and bias)
     scored as max error over the plain gradient's largest value, bar 2e-2
     (f32) / 4e-2 (bf16), the bars gcl_vjp meets against XLA
     (tests/test_pallas_interpret.py:151); two runs of each bitwise equal;
     five planted faults (edge mask ignored, gate skipped, W2 transposed,
     node mask ignored on g, the edge mask without its holes given to the
     kernel only) must each push a gradient over its bar; the edge slots
     its edge kernel computes (phase-clock build) must equal nnz(edge_mask)
     rounded up to the last tile, at the kernel and the sampler's shapes;
     the C entry's workspace size must equal the wrapper's Python mirror;
     kernel, plain and bound times at both shapes;
  3. E(3) equivariance of the full-width DenseEGNN forward on the card;
  4. the sampling path: the ``coarse`` CLI at the GEOM configuration (H=256,
     6 blocks, random weights from --init-seed 0), 2 batches of 64 with
     node counts from the GEOM histogram, 100 strided steps, f32
     elementwise; the samples must be finite, masked and CoM-free, and the
     kernels' launch counts must be exactly those of the path;
  4b. the training path: ``train.cli coarse --init-seed 0`` at the GEOM
     configuration with bf16 elementwise (as configs/coarse_geom.yaml
     trains), batch 64, a synthetic pool of 512 trees, 20 steps, evaluation
     on the EMA weights every 10 steps: loss and grad_norm finite on every
     step, the parameters changed, launch counts exact (12 fused_gcl + 12
     fused_gcl_bwd + 6 plain coordinate updates per step, and the
     evaluations' no-grad kernels); a kernel forward after one AdamW step
     (foreach and fused) equals the plain forward with the stepped weights;
  4c. the gradient of a whole training loss at GEOM width (f32 elementwise,
     B=8, injected t and noise), card (kernels) against CPU (plain): global
     relative L2 error below 2e-2, and a non-zero gradient on every
     parameter whose CPU gradient is above rounding: nonzero, and moved by
     less than half its size when the batch order is reversed (a sum of
     terms that cancel, as in the learned gamma's biases, moves by all of
     it). Those at rounding level are printed with their readings;
  4d. 64 samples at 100 steps from the ``ema.pt`` that 4b wrote, through
     ``sampling.cli coarse --weights``: finite, masked and CoM-free;
  4e. the fine stage: ``sampling.cli assemble --denoise-init-seed 0`` at the
     GEOM denoise width (H=256, 3 full and 3 focal layers, 781 tokens, 780
     types) on the 128 point sets of phase 4: a spanning tree for every
     molecule (n-1 symmetric edges, connected; the root marker at n=1), wids
     in [0, 780), finite logps. On 8 molecules of each of the two fullest pad
     buckets: the card's lattice against the CPU's under the margin rule of
     ``tools/lattice_check.py`` (a differing choice only where the CPU's best
     two candidates are within 1e-4, and top_logp within 1e-3 of the step's
     largest |top_logp|; the CPU's f32 lattice against its f64 one is
     printed beside it, the scale of f32 rounding at these magnitudes), the
     dynamic-depth lattice bitwise equal to the static one, two card runs
     bitwise equal. The lattice's wall and device
     ms per chunk, by bucket (device: torch.profiler), the host search's
     seconds and trees/s;
  4f. ``sampling.cli generate --init-seed 0 --denoise-init-seed 0``: 64
     molecules, 100 coarse steps, beam 5: a spanning tree for every molecule,
     the coarse kernels' launches exactly 12 fused_gcl and 6
     fused_coord_update per model call (100 reverse steps and the final one)
     per coarse chunk; molecules/s, t_coarse and t_fine;
  5. the kernel list as JSON, then the result JSON as the last line.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import copy
import csv
import ctypes
import json
import math
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

B, N, H, E = 64, 32, 256, 2
TOL = 2e-2
GRAD_TOL = {None: 2e-2, "bfloat16": 4e-2}   # gcl_vjp against XLA, f32 / bf16
SEED = 0
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores and HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
SFU_PER_CLOCK_PER_SM = 16     # exp2 / reciprocal results (CUDA guide, cc 9.0)
# bf16 W_src, W_dst, W_e and W2 with f32 b1 and b2: the edge MLP's weights
PAIR_WEIGHT_BYTES = (2 * H * H + E * H + H * H) * 2 + 2 * H * 4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def nvidia_smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device ms per call (see hierdiff_torch/tools/gcl_ab.py device_ms)."""
    from hierdiff_torch.tools.gcl_ab import device_ms

    return device_ms(fn, reps, warmup)[0]


def rel_err(out: torch.Tensor, ref: torch.Tensor):
    diff = (out - ref).abs().max().item()
    return diff, diff / (ref.abs().max().item() + 1e-9)


def bound(flops: float, sfu_ops: float, nbytes: float, sm_clock_hz: float, n_sms: int):
    """Least time (ms) for the work: the larger of bytes over HBM rate and
    operations over their unit's rate (bf16 tensor cores, SFU)."""
    t_bytes = nbytes / PEAK_BYTES
    t_tensor = flops / PEAK_BF16_FLOPS
    t_sfu = sfu_ops / (SFU_PER_CLOCK_PER_SM * n_sms * sm_clock_hz)
    by = "bytes" if t_bytes >= max(t_tensor, t_sfu) else "operations"
    return max(t_bytes, t_tensor, t_sfu) * 1e3, by, {
        "bytes_ms": t_bytes * 1e3, "tensor_ms": t_tensor * 1e3, "sfu_ms": t_sfu * 1e3}


# the learned gamma's l3 bias cancels in its normalisation (gt - g0) / (g1 - g0),
# so its gradient is zero up to rounding and training may leave it unchanged
ZERO_GRAD_PARAMS = {"gamma.l3.bias"}
# a CPU gradient that reversing the batch order moves by this share of its
# size or more is at the rounding level of the loss
ROUNDING_SHARE = 0.5


def cache_after_step(ek, DenseGCL, init_weights, gen, device, h, e, em, nm, g) -> dict:
    """After one AdamW step (foreach and fused), the next training forward
    of a GCL (FusedGCLFunction, which rebuilds its bf16 weights) equals the
    plain forward with the stepped weights; so does a no-grad forward after
    the foreach step, whose in-place ops advance the version counters that
    key the kernels' weight cache. The fused step does not advance them: its
    no-grad forward is printed, not required (TrainState drops the caches
    after every step)."""
    out = {}
    for kind in ("foreach", "fused"):
        layer = init_weights(DenseGCL(H, E, normalization_factor=10.0, attention=True).to(device),
                             gen())
        opt = torch.optim.AdamW(layer.parameters(), lr=1e-2, foreach=kind == "foreach",
                                fused=kind == "fused")
        (ek.fused_gcl(layer, h, e, em, nm) * g).sum().backward()   # FusedGCLFunction
        with torch.no_grad():
            before = ek.fused_gcl(layer, h, e, em, nm)
        opt.step()
        with torch.no_grad():
            no_grad_after = ek.fused_gcl(layer, h, e, em, nm)
        train_after = ek.fused_gcl(layer, h, e, em, nm).detach()
        with torch.no_grad():
            ref = ek.gcl_plain(layer, h, e, em, nm)
        torch.cuda.synchronize()
        out[kind] = {"train_forward_rel_err": rel_err(train_after - h, ref - h)[1],
                     "no_grad_forward_rel_err": rel_err(no_grad_after - h, ref - h)[1],
                     "pre_step_rel_err": rel_err(before - h, ref - h)[1]}
        print(f"weight cache after one AdamW ({kind}) step, kernel vs plain with the stepped "
              f"weights: next training forward {out[kind]['train_forward_rel_err']:.3e}, "
              f"no-grad forward {out[kind]['no_grad_forward_rel_err']:.3e}; the pre-step "
              f"output scores {out[kind]['pre_step_rel_err']:.3e}")
    out["ok"] = (all(out[k]["train_forward_rel_err"] < TOL < out[k]["pre_step_rel_err"]
                     for k in ("foreach", "fused"))
                 and out["foreach"]["no_grad_forward_rel_err"] < TOL)
    return out


def card_against_cpu(cli, ek, CoarseModelConfig, init_weights, gen, device) -> dict:
    """The gradient of one training loss at GEOM width (f32 elementwise, B=8,
    injected t and noise) on the card (kernels) and on the CPU (plain). The
    CPU runs the batch a second time in reverse order: the same loss, summed
    in another order, so a parameter's gradient that moves by
    ``ROUNDING_SHARE`` of its size or more is at rounding level, and neither
    its card value nor its being nonzero is held to the CPU's."""
    from hierdiff_torch.data.collate import collate_coarse
    from hierdiff_torch.data.synthetic import SyntheticTreeGenerator
    from hierdiff_torch.ops.masked import combine_noise

    batch = collate_coarse(SyntheticTreeGenerator(seed=SEED).sample_trees(8))
    rng = np.random.default_rng(SEED + 1)
    b, n = batch["atom_mask"].shape[:2]
    t_int = torch.from_numpy(rng.integers(0, 1001, size=(b, 1)))
    eps = combine_noise(torch.from_numpy(rng.standard_normal((b, n, 11)).astype(np.float32)),
                        torch.from_numpy(batch["atom_mask"]), 3)
    model = init_weights(cli.build_coarse_from_cfg(CoarseModelConfig(), "float32", device),
                         gen()).train()

    def grads_on(m, dev, order=slice(None)):
        m.zero_grad(set_to_none=True)
        out = m({k: torch.from_numpy(np.ascontiguousarray(v[order])).to(dev)
                 for k, v in batch.items()}, None, train=True,
                t_int=t_int[order].to(dev), eps=eps[order].contiguous().to(dev))
        out["loss"].backward()
        return {k: p.grad.detach().double().cpu() for k, p in m.named_parameters()}

    ek.reset_launch_counts()
    card = grads_on(model, device)
    torch.cuda.synchronize()
    launches = dict(ek.launch_counts)
    cpu_model = copy.deepcopy(model).cpu()
    cpu = grads_on(cpu_model, torch.device("cpu"))
    cpu_rev = grads_on(cpu_model, torch.device("cpu"), np.arange(b)[::-1].copy())
    diff2 = {k: float(((card[k] - cpu[k]) ** 2).sum()) for k in cpu}
    ref2 = {k: float((cpu[k] ** 2).sum()) for k in cpu}
    moved = {k: math.sqrt(float(((cpu_rev[k] - cpu[k]) ** 2).sum()) / ref2[k]) if ref2[k] > 0
             else math.inf for k in cpu}
    rounding = {k: {"cpu_l2": math.sqrt(ref2[k]), "moved_by_reversal": moved[k],
                    "card_l2": float(card[k].norm())}
                for k in cpu if not moved[k] < ROUNDING_SHARE}
    per = {k: math.sqrt(diff2[k] / ref2[k]) for k in cpu if k not in rounding}
    worst = max(per, key=per.get)
    egnn = {k: v for k, v in per.items() if not k.startswith("gamma.")}
    worst_egnn = max(egnn, key=egnn.get)
    glob = math.sqrt(sum(diff2.values()) / sum(ref2.values()))
    missing = sorted(k for k, v in card.items() if not torch.isfinite(v).all()
                     or (k not in rounding and not v.abs().max() > 0))
    ok = glob < 2e-2 and not missing and launches["fused_gcl_bwd"] == 12
    print(f"step gradients, card against CPU: GEOM H={H} f32 elementwise, B={b} N={n}: global "
          f"relative L2 error {glob:.3e} (bar 2e-2), worst tensor above rounding {worst} "
          f"{per[worst]:.3e}, worst outside the gamma network {worst_egnn} "
          f"{egnn[worst_egnn]:.3e}; launches on the card {launches}; parameters without a "
          f"gradient {missing}; at rounding level on the CPU (L2 norms, and the share by which "
          f"reversing the batch order moves the CPU gradient): "
          + ", ".join(f"{k} cpu {r['cpu_l2']:.4g} moved {r['moved_by_reversal']:.3g} card "
                      f"{r['card_l2']:.4g}" for k, r in rounding.items()))
    return {"global_rel_l2": glob, "worst_tensor": worst, "worst_rel_l2": per[worst],
            "worst_egnn_tensor": worst_egnn, "worst_egnn_rel_l2": egnn[worst_egnn],
            "launches": launches, "missing": missing, "rounding_level": rounding, "ok": ok}


def holey_inputs(rng: np.random.Generator, device, b: int, n: int):
    """Layer inputs that prefix masks never give: node masks with random
    members (node 0 absent in every other molecule), an edge mask with ~20%
    of the real edges zeroed, nonzero h in padded rows. Returns h, x,
    edge_attr, coord_diff, the holey edge mask, node_mask and the edge mask
    without the holes."""
    from hierdiff_torch.ops.egnn import coord2diff_dense

    nm = (rng.random((b, n, 1)) < 0.7).astype(np.float32)
    nm[::2, 0] = 0.0
    full = nm * np.transpose(nm, (0, 2, 1)) * (1.0 - np.eye(n, dtype=np.float32))
    holey = full * (rng.random((b, n, n)) >= 0.2)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)  # noqa: E731
    x = dev(rng.standard_normal((b, n, 3)) * 2 * nm)
    radial, cdiff = coord2diff_dense(x, 0.0)
    d0, _ = coord2diff_dense(x, 1.0)
    return (dev(rng.standard_normal((b, n, H))), x, torch.cat([radial, d0], dim=-1).contiguous(),
            cdiff.contiguous(), dev(holey[..., None]), dev(nm), dev(full[..., None]))


def coord_work(counts: np.ndarray, b: int, n: int):
    """fused_coord_update's least work for a batch: bf16 FLOPs (edge MLP,
    head and the node projections), SFU operations and bytes over the real
    edges and nodes (each input read once, out written)."""
    c = counts.astype(np.int64)
    n_edges, n_nodes = float((c * (c - 1)).sum()), float(c.sum())
    flops = n_edges * (2 * H * H + 2 * E * H + 2 * H) + n_nodes * 4 * H * H
    sfu = n_edges * (4 * H + 1)
    nbytes = (b * n * H * 4 + b * n * n * E * 4 + b * n * n * 3 * 4 + b * n * n * 4 + b * n * 4
              + b * n * 3 * 4 * 2 + PAIR_WEIGHT_BYTES + H * 2)
    return flops, sfu, nbytes


def gcl_work(counts: np.ndarray, b: int, n: int):
    """fused_gcl's least work for a batch: bf16 FLOPs, SFU operations and
    bytes over the real edges and nodes (each input read once, out written)."""
    c = counts.astype(np.int64)
    n_edges, n_nodes = float((c * (c - 1)).sum()), float(c.sum())
    flops = n_edges * (2 * H * H + 2 * E * H + 2 * H) + n_nodes * 10 * H * H
    sfu = n_edges * (4 * H + 2) + n_nodes * 2 * H
    nbytes = (b * n * H * 4 * 2 + b * n * n * E * 4 + b * n * n * 4 + b * n * 4
              + PAIR_WEIGHT_BYTES + (H + 3 * H * H) * 2 + 3 * H * 4)
    return flops, sfu, nbytes


def bwd_work(counts: np.ndarray, b: int, n: int):
    """fused_gcl_bwd's least work for a batch: bf16 FLOPs, SFU operations and
    bytes over the real edges and nodes (each input read once, each output
    written once)."""
    c = counts.astype(np.int64)
    n_edges, n_nodes = float((c * (c - 1)).sum()), float(c.sum())
    # per real edge: the rematerialised u W2, du = dv W2^T and dW2 += u^T dv
    # (6 H^2), the pair/edge terms (e W_e, de, dW_e: 6 E H) and the gate
    # (forward dot, datt, dw_att: 6 H); per node the node-MLP backward with
    # its rematerialised forward and the node-level products (proj 4, z1 4,
    # do1 2, dcat 4, dWn1 4, dWn2 2, dh 4, dW_src/dst 4: 28 H^2)
    flops = n_edges * (6 * H * H + 6 * E * H + 6 * H) + n_nodes * 28 * H * H
    sfu = n_edges * (4 * H + 2) + n_nodes * 2 * H   # sigmoid(pre), sigmoid(v), gate; sigmoid(z1)
    # g, h, agg in and dh out; e in and de out; the masks; the weights in bf16
    # and their gradients in f32
    nbytes = (b * n * H * 4 * 4 + b * n * n * E * 4 * 2 + b * n * n * 4 + b * n * 4
              + (10 * H * H + E * H) * 2 + 6 * H * 4 + (6 * H * H + E * H + 5 * H + 1) * 4)
    return flops, sfu, nbytes


def edge_slots(call) -> tuple:
    """(edge slots, real edges) that fused_gcl_bwd's edge kernel computes in
    one call of its phase-clock build: ``call(phase_clocks=True)``."""
    from hierdiff_torch.ops import _build

    lib = _build.load_library("fused_gcl_bwd", phase_clocks=True)
    lib.hd_read_edge_counts.argtypes = [ctypes.c_void_p]
    lib.hd_read_edge_counts.restype = ctypes.c_int
    counts = (ctypes.c_ulonglong * 2)()
    torch.cuda.synchronize()
    lib.hd_read_edge_counts(counts)   # zeroes them
    call(phase_clocks=True)
    torch.cuda.synchronize()
    if lib.hd_read_edge_counts(counts) != 0:
        fail("reading fused_gcl_bwd's edge counts failed")
    return int(counts[0]), int(counts[1])


def spanning_tree_faults(trees, sizes) -> list:
    """(molecule, fault) for each tree of a trees pickle that is missing, not
    a spanning tree of its n nodes (n-1 symmetric edges, connected; n=1 keeps
    the root marker), or has a wid outside [0, 780) or a non-finite logp."""
    faults = []
    for i, (d, n) in enumerate(zip(trees, sizes)):
        if d is None:
            faults.append((i, "missing"))
            continue
        adj = np.asarray(d["adj"])
        off = adj * (1.0 - np.eye(n))
        seen, frontier = {0}, [0]
        while frontier:
            for j in np.flatnonzero(off[frontier.pop()]):
                if int(j) not in seen:
                    seen.add(int(j))
                    frontier.append(int(j))
        if (off.sum() != 2 * (n - 1) or not np.array_equal(off, off.T) or len(seen) != n
                or (n == 1 and adj[0, 0] != 1.0)):
            faults.append((i, "not a spanning tree"))
        if d["wids"].shape != (n,) or not ((d["wids"] >= 0) & (d["wids"] < 780)).all():
            faults.append((i, "wid out of range"))
        if not math.isfinite(d["logp"]):
            faults.append((i, "logp not finite"))
    return faults


def profiled_device_ms(prof) -> float:
    """Device time of every CUDA activity (kernels, copies) under ``prof``."""
    from torch.autograd import DeviceType

    total = 0.0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            t = getattr(evt, "self_device_time_total", None)
            total += evt.self_cuda_time_total if t is None else t
    return total / 1e3


def assemble_phase(cli, coarse_pkl: bytes, device) -> dict:
    """Phase 4e: ``sampling.cli assemble`` at GEOM width on phase 4's point
    sets; the card's lattice against the CPU's on 16 molecules of two
    buckets, dynamic against static depth and a repeat, bitwise; the
    lattice's times per chunk."""
    from torch.profiler import ProfilerActivity, profile

    from hierdiff_torch.config import EdgeDenoiseConfig
    from hierdiff_torch.data.collate import bucket_for
    from hierdiff_torch.sampling.lattice import _next_pow2, pad_blur, pow2_chunks
    from hierdiff_torch.tools.lattice_check import compare_lattices
    from hierdiff_torch.utils.weights import init_weights

    with tempfile.TemporaryDirectory() as tmp:
        src, out = Path(tmp) / "coarse.pkl", Path(tmp) / "trees.pkl"
        src.write_bytes(coarse_pkl)
        run = cli.main(["assemble", "--coarse-pkl", str(src), "--denoise-init-seed", "0",
                        "--out", str(out)])
        with open(out, "rb") as f:
            trees = pickle.load(f)["trees"]
    blur, sampler = run["blur"], run["sampler"]
    sizes = [b["h"].shape[0] for b in blur]
    faults = spanning_tree_faults(trees, sizes)
    seconds = run["lattice_s"] + run["search_s"]
    print(f"assemble: GEOM denoise H={sampler.model.hidden_nf}, {len(blur)} molecules of "
          f"{min(sizes)}-{max(sizes)} nodes: lattices {run['lattice_s']:.3f} s, host search "
          f"{run['search_s']:.3f} s, {len(blur) / seconds:.3f} trees/s; faults {faults}")
    if faults:
        fail(f"assemble gave trees that are missing or invalid: {faults}")

    by_bucket = {}
    for i, n in enumerate(sizes):
        by_bucket.setdefault(bucket_for(n, sampler.buckets), []).append(i)
    chunks = []
    for nb, idxs in sorted(by_bucket.items()):
        c0 = 0
        for take in pow2_chunks(len(idxs), sampler._max_batch(nb)):
            chunk = idxs[c0: c0 + take]
            c0 += take

            def lattice():
                lattices = {}
                for c, o in sampler._dispatch_lattices(blur, chunk):
                    sampler._collect_lattice(c, o, blur, lattices)

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lattice()
            wall_ms = (time.perf_counter() - t0) * 1e3
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                lattice()
                torch.cuda.synchronize()
            row = {"bucket": nb, "molecules": len(chunk), "batch": _next_pow2(len(chunk)),
                   "wall_ms": wall_ms, "device_ms": profiled_device_ms(prof)}
            row["device_share"] = row["device_ms"] / wall_ms
            chunks.append(row)
            print(f"lattice chunk: bucket {nb}, {len(chunk)} molecules padded to "
                  f"{row['batch']}: wall {wall_ms:.1f} ms, device {row['device_ms']:.1f} ms "
                  f"(torch.profiler; {row['device_share']:.3f} of the wall)")

    cpu_model = init_weights(cli.build_denoise_from_cfg(EdgeDenoiseConfig(), "cpu"),
                             torch.Generator().manual_seed(0)).clone(dynamic_depth=True)
    cpu64_model = copy.deepcopy(cpu_model).double()
    card_model = sampler.model
    checks = {}
    for nb in sorted(by_bucket, key=lambda k: -len(by_bucket[k]))[:2]:
        chunk = by_bucket[nb][:8]
        arrays = pad_blur(blur, chunk, len(chunk), nb)
        on_card = [torch.from_numpy(a).to(device) for a in arrays]
        card, again = card_model.ar_lattice(*on_card), card_model.ar_lattice(*on_card)
        static = card_model.clone(dynamic_depth=False).ar_lattice(*on_card)
        cpu = cpu_model.ar_lattice(*(torch.from_numpy(a) for a in arrays))
        cpu_np = {k: v.numpy() for k, v in cpu.items()}
        n_steps = [sizes[i] for i in chunk]
        report = compare_lattices(cpu_np, {k: v.cpu().numpy() for k, v in card.items()},
                                  n_steps, margin=1e-4, logp_tol=1e-3, relative=True)
        # the scale of f32 rounding itself: the CPU's f32 lattice against its f64 one
        f64 = compare_lattices({k: v.numpy() for k, v in cpu64_model.ar_lattice(
            *(torch.from_numpy(a).double() for a in arrays)).items()}, cpu_np, n_steps,
            margin=1e-4, logp_tol=1e-3, relative=True)
        check = {"molecules": len(chunk), "steps_compared": report["steps_compared"],
                 "cut": report["cut"], "failures": report["failures"][:5],
                 "max_logp_err": report["max_logp_err"],
                 "max_logp_rel_err": report["max_logp_rel_err"],
                 "bitwise_repeat": all(torch.equal(card[k], again[k]) for k in card),
                 "bitwise_static_depth": all(torch.equal(card[k], static[k]) for k in card),
                 "cpu_f32_against_f64": {k: f64[k] for k in (
                     "steps_compared", "cut", "max_logp_err", "max_logp_rel_err")}}
        checks[f"bucket {nb}"] = check
        print(f"lattice card against CPU, bucket {nb}, {len(chunk)} molecules: "
              f"{json.dumps(check)}")
        if not (report["ok"] and check["bitwise_repeat"] and check["bitwise_static_depth"]):
            fail(f"the card's lattice disagrees with the CPU's or is not repeatable: {check}")
    return {"molecules": len(blur), "lattice_s": run["lattice_s"], "search_s": run["search_s"],
            "trees_per_s": len(blur) / seconds, "chunks": chunks, "card_against_cpu": checks}


def generate_phase(cli, ek, num: int = 64, steps: int = 100):
    """Phase 4f: ``sampling.cli generate`` from the GEOM histogram to trees;
    the coarse kernels' launches must be exact for the chunk plan."""
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "generated.pkl"
        ek.reset_launch_counts()
        run = cli.main(["generate", "--init-seed", "0", "--denoise-init-seed", "0",
                        "--num", str(num), "--sample-steps", str(steps), "--beam", "5",
                        "--seed", str(SEED), "--out", str(out)])
        torch.cuda.synchronize()
        launches = dict(ek.launch_counts)
        with open(out, "rb") as f:
            trees = pickle.load(f)["trees"]
    result, pipe = run["result"], run["pipeline"]
    sizes = [b["h"].shape[0] for b in result.blur]
    n_chunks = len(pipe._plan_chunks(np.asarray(sizes)))
    expect = {"fused_gcl": n_chunks * (steps + 1) * 12,
              "fused_coord_update": n_chunks * (steps + 1) * 6,
              "fused_gcl_bwd": 0, "coord_update_autograd": 0}
    faults = spanning_tree_faults(trees, sizes)
    stats = {"molecules": num, "seconds": run["seconds"],
             "molecules_per_s": num / run["seconds"], **result.stats,
             "coarse_chunks": n_chunks, "launches": launches, "faults": faults}
    print(f"generate: {num} molecules, {steps} coarse steps, beam 5, {n_chunks} coarse chunks: "
          f"{run['seconds']:.3f} s, {stats['molecules_per_s']:.3f} molecules/s, t_coarse "
          f"{result.stats['t_coarse']:.3f} s, t_fine {result.stats['t_fine']:.3f} s; launches "
          f"{launches} (expected {expect}); faults {faults}")
    if launches != expect:
        fail(f"generate's kernel launch counts {launches} != {expect}")
    if faults:
        fail(f"generate gave trees that are missing or invalid: {faults}")
    return stats, launches


def main() -> None:
    ap = argparse.ArgumentParser(description="Smoke test of the port on one GPU.")
    ap.add_argument("--parent", type=Path, default=None,
                    help="an unpacked earlier tree of this repository, whose fused_gcl is "
                         "timed beside this one's (tools/gcl_ab.py)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA GPU")
    from hierdiff_torch.config import CoarseModelConfig
    from hierdiff_torch.ops import _build, egnn_kernels as ek
    from hierdiff_torch.ops.egnn import DenseEGNN, DenseEquivariantUpdate, DenseGCL
    from hierdiff_torch.ops.masked import mean_zero_max_violation, masking_violation
    from hierdiff_torch.sampling import cli
    from hierdiff_torch.tools.kernel_phases import layer_inputs, sampler_counts
    from hierdiff_torch.train import cli as train_cli
    from hierdiff_torch.utils.weights import init_weights

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    gen = lambda: torch.Generator().manual_seed(SEED)  # noqa: E731

    # ---- 1. device and build
    card = nvidia_smi("name,power.limit").splitlines()[0]
    sm_clock_hz = float(nvidia_smi("clocks.max.sm").splitlines()[0].split()[0]) * 1e6
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(card)
    print(f"device: {torch.cuda.get_device_name(0)} | torch {torch.__version__} | "
          f"cuda {torch.version.cuda} | {n_sms} SMs, max SM clock {sm_clock_hz / 1e6:.0f} MHz")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:   # nvcc processes all start together
        clocked = pool.submit(_build.build_all, ("fused_gcl_bwd",), True)
        logs = _build.build_all()
        clocked.result()
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{name}]: {line.strip()}")
    print(f"build: {sorted(logs)} compiled in {build_s:.2f} s")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    hgmma = {}
    for lib in _build.SOURCES:
        sass = subprocess.run([cuobjdump, "--dump-sass", str(_build.library_path(lib))],
                              check=True, capture_output=True, text=True).stdout
        hgmma[lib] = sum("HGMMA" in line for line in sass.splitlines())
        print(f"{lib} SASS: {hgmma[lib]} HGMMA instructions (cuobjdump --dump-sass)")
        if hgmma[lib] == 0:
            fail(f"the {lib} library has no HGMMA instruction: its W2 products are not on wgmma")

    # ---- 2. kernels against their plain versions (forward: no autograd)
    torch.set_grad_enabled(False)
    rng = np.random.default_rng(SEED)
    h, x, e, cdiff, em, nm, counts = layer_inputs(rng, device, B, N, H)
    results = {}
    gcl_extra = {}

    def check(name, variant, kernel_fn, plain_fn, base, timed=True):
        """What the kernel adds to ``base`` against what the plain version adds."""
        out, ref = kernel_fn() - base, plain_fn() - base
        torch.cuda.synchronize()
        abs_err, rel = rel_err(out, ref)
        ok = bool(torch.isfinite(out).all().item()) and rel < TOL
        k_ms = p_ms = None
        times = ""
        if timed:
            k_ms, p_ms = time_ms(kernel_fn), time_ms(plain_fn, reps=5, warmup=1)
            times = f" kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f}"
        print(f"kernel {name} [{variant}]: max_abs_err {abs_err:.3e} rel_err {rel:.3e} "
              f"(bar {TOL}){times} {'ok' if ok else 'FAIL'}")
        results.setdefault(name, []).append(
            {"variant": variant, "max_abs_err": abs_err, "rel_err": rel, "ms": k_ms,
             "plain_ms": p_ms, "ok": ok})

    def plant(name, fault, faulty_kernel_fn, plain_fn, base):
        """A deliberately wrong kernel run must fail the check above."""
        out, ref = faulty_kernel_fn() - base, plain_fn() - base
        _, rel = rel_err(out, ref)
        seen = not rel < TOL
        print(f"planted fault {name} [{fault}]: rel_err {rel:.3e} "
              f"{'rejected' if seen else 'NOT SEEN'}")
        faults.setdefault(name, []).append({"fault": fault, "rel_err": rel})
        if not seen:
            fail(f"the {name} check cannot see the planted fault: {fault}")

    def pass_through(layer):
        """Node MLP [h, agg] -> agg -> identity: out - h = silu(agg) per channel."""
        n_in, n_out = layer.node_mlp[0], layer.node_mlp[2]
        with torch.no_grad():
            n_in.weight.copy_(torch.cat([torch.zeros(H, H), torch.eye(H)], dim=1))
            n_out.weight.copy_(torch.eye(H))
            n_in.bias.zero_()
            n_out.bias.zero_()
        return layer

    faults = {}
    for node_mlp in ("random", "pass-through"):
        for attention in (True, False):
            for cd in (None, "bfloat16"):
                layer = init_weights(DenseGCL(H, E, normalization_factor=10.0, attention=attention,
                                              compute_dtype=cd).to(device), gen())
                if node_mlp == "pass-through":
                    pass_through(layer)
                check("fused_gcl", f"node_mlp={node_mlp} attention={attention} "
                      f"elementwise={cd or 'float32'}",
                      lambda: ek.fused_gcl(layer, h, e, em, nm),
                      lambda: ek.gcl_plain(layer, h, e, em, nm), h)
    gcl_flops, gcl_sfu, gcl_bytes = gcl_work(counts, B, N)

    # fused_gcl on shapes and masks that the prefix masks above never give
    s_counts = sampler_counts(B, SEED)
    s_n = int(s_counts.max())
    sampler_in = layer_inputs(np.random.default_rng(SEED), device, B, s_n, H, counts=s_counts)
    big_counts = np.array([83, 40, 12, 1, 0, 64, 83, 25, 70, 2, 33, 9, 65, 17, 80, 5])
    big_in = layer_inputs(np.random.default_rng(SEED), device, len(big_counts), 83, H,
                          counts=big_counts)
    tiny_counts = np.array([0, 1, 0, 1, 5, 16, 1, 0])
    tiny_in = layer_inputs(np.random.default_rng(SEED), device, len(tiny_counts), 16, H,
                           counts=tiny_counts)
    hh_h, x_h, e_h, cd_h, em_h, nm_h, em_full = holey_inputs(np.random.default_rng(SEED + 2),
                                                             device, B, N)
    cases = {f"sampler shape B={B} N={s_n}": (sampler_in[0], sampler_in[2], sampler_in[4], sampler_in[5]),
             f"83-node rows B={len(big_counts)} N=83": (big_in[0], big_in[2], big_in[4], big_in[5]),
             f"holey masks B={B} N={N}": (hh_h, e_h, em_h, nm_h),
             f"0- and 1-node molecules B={len(tiny_counts)} N=16": (
                 tiny_in[0], tiny_in[2], tiny_in[4], tiny_in[5])}
    for case, (h_, e_, em_, nm_) in cases.items():
        print(f"fused_gcl case {case}: real edges {int(em_.sum().item())} of {em_.numel()} "
              f"({em_.sum().item() / em_.numel():.3f})")
        for attention in (True, False):
            for cd in (None, "bfloat16"):
                layer = pass_through(init_weights(DenseGCL(
                    H, E, normalization_factor=10.0, attention=attention,
                    compute_dtype=cd).to(device), gen()))
                check("fused_gcl", f"{case} node_mlp=pass-through attention={attention} "
                      f"elementwise={cd or 'float32'}",
                      lambda: ek.fused_gcl(layer, h_, e_, em_, nm_),
                      lambda: ek.gcl_plain(layer, h_, e_, em_, nm_), h_ * nm_, timed=False)
    def sampler_and_repeat(name, variant, kernel_fn, plain_fn, work, sampler_args, repeat_cases):
        """The kernel's and its plain version's time at the sampler's shape
        with its bound; two runs on each of ``repeat_cases`` bitwise equal."""
        k_ms = time_ms(lambda: kernel_fn(*sampler_args))
        p_ms = time_ms(lambda: plain_fn(*sampler_args), reps=5, warmup=1)
        b_ms, by, _ = bound(*work, sm_clock_hz, n_sms)
        print(f"kernel {name} [sampler shape B={B} N={s_n}, {variant}]: kernel_ms {k_ms:.4f} "
              f"plain_ms {p_ms:.4f} bound_ms {b_ms:.5f} ({by})")
        bitwise = {case: torch.equal(kernel_fn(*a_), kernel_fn(*a_)) for case, a_ in repeat_cases.items()}
        print(f"{name} two runs bitwise equal: {bitwise}")
        if not all(bitwise.values()):
            fail(f"{name} is not deterministic: {bitwise}")
        return {"sampler_shape": {"B": B, "N": s_n, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                                  "bound_by": by}, "bitwise_repeat": bitwise}

    def parent_rows(kernel, flag):
        """With --parent: the parent tree's kernel timed beside this one's."""
        rows = {"kernel_shape": None, "sampler_shape": None}
        if args.parent is not None:
            from hierdiff_torch.tools import gcl_ab

            for row in gcl_ab.compare(args.parent, kernel=kernel):
                print(f"{kernel} against the parent tree's: {json.dumps(row)}")
                if row[flag] and row["elementwise"] == "float32":
                    rows["kernel_shape" if row["shape"].startswith("kernel") else "sampler_shape"] = row
        return rows

    main_gcl = init_weights(DenseGCL(H, E, normalization_factor=10.0, attention=True).to(device),
                            gen())
    gcl_extra["fused_gcl"] = {
        **sampler_and_repeat(
            "fused_gcl", "node_mlp=random attention=True elementwise=float32",
            lambda *a_: ek.fused_gcl(main_gcl, *a_), lambda *a_: ek.gcl_plain(main_gcl, *a_),
            gcl_work(s_counts, B, s_n), cases[f"sampler shape B={B} N={s_n}"],
            {"kernel shape": (h, e, em, nm), "holey masks": cases[f"holey masks B={B} N={N}"]}),
        "parent": parent_rows("fused_gcl", "attention")}

    probe = pass_through(init_weights(DenseGCL(H, E, normalization_factor=10.0,
                                               attention=True).to(device), gen()))
    no_gate, no_w2_row = copy.deepcopy(probe), copy.deepcopy(probe)
    no_gate.attention = False
    with torch.no_grad():
        no_w2_row.edge_mlp[2].weight[0].zero_()
    plain_gcl = lambda: ek.gcl_plain(probe, h, e, em, nm)  # noqa: E731
    plant("fused_gcl", "gate skipped", lambda: ek.fused_gcl(no_gate, h, e, em, nm), plain_gcl, h)
    plant("fused_gcl", "W2 output channel 0 zeroed",
          lambda: ek.fused_gcl(no_w2_row, h, e, em, nm), plain_gcl, h)
    plant("fused_gcl", "edge mask ignored",
          lambda: ek.fused_gcl(probe, h, e, torch.ones_like(em), nm), plain_gcl, h)
    plant("fused_gcl", "edge mask without its holes fed to the kernel only",
          lambda: ek.fused_gcl(probe, hh_h, e_h, em_full, nm_h),
          lambda: ek.gcl_plain(probe, hh_h, e_h, em_h, nm_h), hh_h * nm_h)

    def coord_layer(tanh, cd):
        """A coordinate update with its head at 1e4 x its init scale, so that
        tanh saturates."""
        layer = init_weights(DenseEquivariantUpdate(
            H, E, normalization_factor=10.0, tanh=tanh, coords_range=30.0 / 6,
            compute_dtype=cd).to(device), gen())
        with torch.no_grad():
            layer.coord_mlp[4].weight.mul_(1e4)
        return layer

    equ = coord_layer(True, None)
    with torch.no_grad():
        scalar = ek.coord_scalar(equ, h, e)[..., 0][em[..., 0] > 0].abs()
    saturated = (scalar > 2.0).float().mean().item()
    print(f"fused_coord_update input: |head scalar| > 2 (tanh saturated) on {saturated:.3f} "
          f"of the valid edges, median |scalar| {scalar.median().item():.3f}")
    if not saturated > 0.25:
        fail("the coordinate head does not drive tanh into saturation")
    # (h, e, coord_diff, x, edge_mask, node_mask) in the wrapper's order
    coord_cases = {f"kernel shape B={B} N={N}": (h, e, cdiff, x, em, nm)}
    coord_cases.update({case: (in_[0], in_[2], in_[3], in_[1], in_[4], in_[5]) for case, in_ in (
        (f"sampler shape B={B} N={s_n}", sampler_in),
        (f"83-node rows B={len(big_counts)} N=83", big_in),
        (f"0- and 1-node molecules B={len(tiny_counts)} N=16", tiny_in))})
    coord_cases[f"holey masks B={B} N={N}"] = (hh_h, e_h, cd_h, x_h, em_h, nm_h)
    for case, c_args in coord_cases.items():
        at_kernel_shape = case.startswith("kernel shape")
        for tanh in (True, False):
            for cd in (None, "bfloat16"):
                layer = equ if tanh and cd is None else coord_layer(tanh, cd)
                variant = f"tanh={tanh} coords_range=5 elementwise={cd or 'float32'}"
                check("fused_coord_update", variant if at_kernel_shape else f"{case} {variant}",
                      lambda: ek.fused_coord_update(layer, *c_args),
                      lambda: ek.coord_update_plain(layer, *c_args), c_args[3],
                      timed=at_kernel_shape)
    coord_flops, coord_sfu, coord_bytes = coord_work(counts, B, N)
    gcl_extra["fused_coord_update"] = {
        **sampler_and_repeat(
            "fused_coord_update", "tanh=True elementwise=float32",
            lambda *a_: ek.fused_coord_update(equ, *a_),
            lambda *a_: ek.coord_update_plain(equ, *a_), coord_work(s_counts, B, s_n),
            coord_cases[f"sampler shape B={B} N={s_n}"],
            {"kernel shape": coord_cases[f"kernel shape B={B} N={N}"],
             "holey masks": coord_cases[f"holey masks B={B} N={N}"]}),
        "parent": parent_rows("fused_coord_update", "tanh")}

    no_tanh, no_w2_row = copy.deepcopy(equ), copy.deepcopy(equ)
    no_tanh.tanh = False    # computes coords_range * scalar
    with torch.no_grad():
        no_tanh.coord_mlp[4].weight.mul_(no_tanh.coords_range)
        no_w2_row.coord_mlp[2].weight[0].zero_()
    plain_coord = lambda: ek.coord_update_plain(equ, h, e, cdiff, x, em, nm)  # noqa: E731
    plant("fused_coord_update", "tanh skipped",
          lambda: ek.fused_coord_update(no_tanh, h, e, cdiff, x, em, nm), plain_coord, x)
    plant("fused_coord_update", "W2 output channel 0 zeroed",
          lambda: ek.fused_coord_update(no_w2_row, h, e, cdiff, x, em, nm), plain_coord, x)
    plant("fused_coord_update", "edge mask ignored",
          lambda: ek.fused_coord_update(equ, h, e, cdiff, x, torch.ones_like(em), nm),
          plain_coord, x)
    plant("fused_coord_update", "edge mask without its holes fed to the kernel only",
          lambda: ek.fused_coord_update(equ, hh_h, e_h, cd_h, x_h, em_full, nm_h),
          lambda: ek.coord_update_plain(equ, hh_h, e_h, cd_h, x_h, em_h, nm_h), x_h)

    a_bf = torch.randn((B * N * N, H), device=device, dtype=torch.bfloat16)
    w_bf = torch.randn((H, H), device=device, dtype=torch.bfloat16)
    w2_matmul_ms = time_ms(lambda: a_bf @ w_bf)
    print(f"reference: (B*N*N, H) x (H, H) bf16 torch.matmul alone {w2_matmul_ms:.4f} ms "
          f"(tensor-core share of the edge MLP; not used by the port)")
    failed = [r["variant"] for rs in results.values() for r in rs if not r["ok"]]
    if failed:
        fail(f"kernel disagrees with its plain version: {failed}")

    # ---- 2b. the backward kernel against autograd of the plain version
    def forward_agg(layer, h_, e_, em_, nm_):
        """The forward's residual, as FusedGCLFunction saves it."""
        agg = torch.empty_like(h_)
        ek._launch_gcl(layer, h_, e_, em_, nm_, h_.device, agg_out=agg)
        return agg

    def grad_errors(got, ref):
        """Per gradient: (max abs error, max abs error over the largest plain value)."""
        return {f: rel_err(a, r) for f, a, r in zip(ek.GclGrads._fields, got, ref)
                if a is not None and r is not None}

    def upstream(h_):
        return torch.from_numpy(np.random.default_rng(SEED + 5).standard_normal(
            tuple(h_.shape)).astype(np.float32)).to(device)

    bwd_cases = {f"kernel shape B={B} N={N}": (h, e, em, nm), **cases}
    g = upstream(h)
    bwd_runs = []
    for case, (h_, e_, em_, nm_) in bwd_cases.items():
        at_kernel_shape = case.startswith("kernel shape")
        g_ = g if at_kernel_shape else upstream(h_)
        for attention, cd, node_mlp in [(True, None, "random"), (True, "bfloat16", "random"),
                                        (False, None, "random"), (False, "bfloat16", "random"),
                                        (True, None, "pass-through")]:
            layer = init_weights(DenseGCL(H, E, normalization_factor=10.0, attention=attention,
                                          compute_dtype=cd).to(device), gen())
            if node_mlp == "pass-through":
                pass_through(layer)
            agg = forward_agg(layer, h_, e_, em_, nm_)
            kernel_fn = lambda: ek.fused_gcl_bwd(layer, h_, e_, em_, nm_, g_, agg)  # noqa: E731
            plain_fn = lambda: ek.gcl_plain_vjp(layer, h_, e_, em_, nm_, g_)  # noqa: E731
            got, again, ref = kernel_fn(), kernel_fn(), plain_fn()
            torch.cuda.synchronize()
            errs = grad_errors(got, ref)
            worst = max(errs, key=lambda f: errs[f][1])
            bitwise = all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)
            finite = all(bool(torch.isfinite(a).all()) for a in got if a is not None)
            bar = GRAD_TOL[cd]
            ok = finite and bitwise and errs[worst][1] < bar
            k_ms = p_ms = None
            times = ""
            if at_kernel_shape:
                k_ms, p_ms = time_ms(kernel_fn), time_ms(plain_fn, reps=5, warmup=1)
                times = f" kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f}"
            variant = f"node_mlp={node_mlp} attention={attention} elementwise={cd or 'float32'}"
            variant = variant if at_kernel_shape else f"{case} {variant}"
            print(f"kernel fused_gcl_bwd [{variant}]: worst {worst} rel_err {errs[worst][1]:.3e} "
                  f"(bar {bar}); " + " ".join(f"{f}={r:.1e}" for f, (_, r) in errs.items())
                  + f"; bitwise_repeat={bitwise}{times} {'ok' if ok else 'FAIL'}")
            bwd_runs.append({"variant": variant, "max_abs_err": max(a for a, _ in errs.values()),
                             "rel_err": errs[worst][1], "worst": worst,
                             "rel_err_by_grad": {f: r for f, (_, r) in errs.items()},
                             "bitwise_repeat": bitwise, "ms": k_ms, "plain_ms": p_ms, "ok": ok})
    results["fused_gcl_bwd"] = bwd_runs
    failed = [r["variant"] for r in bwd_runs if not r["ok"]]
    if failed:
        fail(f"fused_gcl_bwd disagrees with its plain version or is not deterministic: {failed}")

    probe = init_weights(DenseGCL(H, E, normalization_factor=10.0, attention=True).to(device), gen())
    agg, ref = forward_agg(probe, h, e, em, nm), ek.gcl_plain_vjp(probe, h, e, em, nm, g)
    no_gate, w2_t = copy.deepcopy(probe), copy.deepcopy(probe)
    no_gate.attention = False
    w2_t.edge_mlp[2].weight.copy_(w2_t.edge_mlp[2].weight.t().clone())
    g_h = upstream(hh_h)
    agg_h = forward_agg(probe, hh_h, e_h, em_h, nm_h)
    for fault, fn, ref_ in [
            ("edge mask ignored",
             lambda: ek.fused_gcl_bwd(probe, h, e, torch.ones_like(em), nm, g, agg), ref),
            ("gate skipped", lambda: ek.fused_gcl_bwd(no_gate, h, e, em, nm, g, agg), ref),
            ("W2 transposed", lambda: ek.fused_gcl_bwd(w2_t, h, e, em, nm, g, agg), ref),
            ("node mask ignored on g",
             lambda: ek.fused_gcl_bwd(probe, h, e, em, torch.ones_like(nm), g, agg), ref),
            ("edge mask without its holes fed to the kernel only",
             lambda: ek.fused_gcl_bwd(probe, hh_h, e_h, em_full, nm_h, g_h, agg_h),
             ek.gcl_plain_vjp(probe, hh_h, e_h, em_h, nm_h, g_h))]:
        errs = grad_errors(fn(), ref_)
        worst = max(errs, key=lambda f: errs[f][1])
        seen = not errs[worst][1] < GRAD_TOL[None]
        print(f"planted fault fused_gcl_bwd [{fault}]: caught by {worst} rel_err "
              f"{errs[worst][1]:.3e} {'rejected' if seen else 'NOT SEEN'}")
        faults.setdefault("fused_gcl_bwd", []).append(
            {"fault": fault, "rel_err": errs[worst][1], "caught_by": worst})
        if not seen:
            fail(f"the fused_gcl_bwd check cannot see the planted fault: {fault}")

    # the workspace: the C entry's size against the wrapper's Python mirror
    ws_size = ek._entry("fused_gcl_bwd_workspace", False)
    ws_sizes = {f"B={b_} N={n_}": (int(ws_size(b_, n_, H, E)), ek.gcl_bwd_workspace_floats(b_, n_, H, E))
                for b_, n_ in ((B, N), (B, s_n), (len(big_counts), 83), (len(tiny_counts), 16), (B, 1))}
    print(f"fused_gcl_bwd workspace floats, C entry against the Python mirror: {ws_sizes}")
    if any(c_ != py_ for c_, py_ in ws_sizes.values()):
        fail(f"fused_gcl_bwd's workspace size differs between C and Python: {ws_sizes}")

    # edge slots computed against nnz(edge_mask), device times at the sampler's shape
    s_args = cases[f"sampler shape B={B} N={s_n}"]
    s_g, s_agg = upstream(s_args[0]), forward_agg(probe, *s_args)
    slots = {}
    for case, (h_, e_, em_, nm_, g_, agg_) in {
            f"kernel shape B={B} N={N}": (h, e, em, nm, g, agg),
            f"sampler shape B={B} N={s_n}": (*s_args, s_g, s_agg)}.items():
        computed, real = edge_slots(lambda **kw: ek.fused_gcl_bwd(probe, h_, e_, em_, nm_, g_, agg_, **kw))
        nnz = int((em_ != 0).sum().item())
        want = -(-nnz // ek.BWD_TILE_EDGES) * ek.BWD_TILE_EDGES
        slots[case] = {"edge_slots": computed, "real_edges": real, "nnz_edge_mask": nnz,
                       "dense_edges": em_.numel()}
        print(f"fused_gcl_bwd edge kernel, {case}: {computed} edge slots for {real} real edges; "
              f"nnz(edge_mask) {nnz} of {em_.numel()} dense (want {want} slots)")
        if computed != want or real != nnz:
            fail(f"fused_gcl_bwd's edge kernel computes {computed} slots ({real} real) for "
                 f"nnz(edge_mask) = {nnz}: want {want}")
    s_ms = time_ms(lambda: ek.fused_gcl_bwd(probe, *s_args, s_g, s_agg))
    s_plain_ms = time_ms(lambda: ek.gcl_plain_vjp(probe, *s_args, s_g), reps=5, warmup=1)
    s_bound = bound(*bwd_work(s_counts, B, s_n), sm_clock_hz, n_sms)
    print(f"kernel fused_gcl_bwd [sampler shape B={B} N={s_n}, node_mlp=random attention=True "
          f"elementwise=float32]: kernel_ms {s_ms:.4f} plain_ms {s_plain_ms:.4f} bound_ms "
          f"{s_bound[0]:.5f} ({s_bound[1]})")
    bwd_bound = bound(*bwd_work(counts, B, N), sm_clock_hz, n_sms)
    gcl_extra["fused_gcl_bwd"] = {
        "sampler_shape": {"B": B, "N": s_n, "ms": s_ms, "plain_ms": s_plain_ms,
                          "bound_ms": s_bound[0], "bound_by": s_bound[1]},
        "edge_slots": slots, "hgmma_instructions": hgmma["fused_gcl_bwd"],
        "parent": parent_rows("fused_gcl_bwd", "attention")}
    print(f"kernel fused_gcl_bwd: kernel_ms {bwd_runs[0]['ms']:.4f} plain_ms "
          f"{bwd_runs[0]['plain_ms']:.4f} bound_ms {bwd_bound[0]:.5f} ({bwd_bound[1]}: "
          + ", ".join(f"{k} {v:.5f}" for k, v in bwd_bound[2].items()) + ")")

    # ---- 3. equivariance of the full-width EGNN on the card
    egnn = DenseEGNN(9, hidden_nf=H, n_layers=6, inv_sublayers=2, attention=True, tanh=True,
                     coords_range=30.0, norm_constant=0.0, normalization_factor=10.0).to(device)
    init_weights(egnn, gen())
    nb = 8
    hin = torch.from_numpy(rng.standard_normal((nb, N, 9)).astype(np.float32)).to(device)
    hin = hin * nm[:nb]
    xin = x[:nb] - (x[:nb].sum(1, keepdim=True) / nm[:nb].sum(1, keepdim=True)) * nm[:nb]
    q, _ = torch.linalg.qr(torch.from_numpy(rng.standard_normal((3, 3))).float())
    q = (q * torch.sign(torch.linalg.det(q))).to(device)
    shift = torch.from_numpy(rng.standard_normal(3).astype(np.float32)).to(device)
    with torch.no_grad():
        h1, x1 = egnn(hin, xin, nm[:nb], em[:nb])
        h2, x2 = egnn(hin, (xin @ q.T + shift) * nm[:nb], nm[:nb], em[:nb])
    torch.cuda.synchronize()
    _, h_err = rel_err(h2, h1)
    _, x_err = rel_err(x2, (x1 @ q.T + shift) * nm[:nb])
    print(f"equivariance: DenseEGNN H={H} 6 blocks, rotation+translation: h rel_err "
          f"{h_err:.3e}, x rel_err {x_err:.3e} (bar {TOL}: bf16 operands round the "
          f"rotated distances differently)")
    if not (h_err < TOL and x_err < TOL):
        fail("DenseEGNN is not E(3)-equivariant on the card")

    # ---- 4. main path: the coarse CLI at the GEOM configuration
    n_batches, batch, steps = 2, 64, 100
    with tempfile.TemporaryDirectory() as tmp:
        ek.reset_launch_counts()
        run = cli.main(["coarse", "--init-seed", "0", "--num", str(n_batches * batch),
                        "--batch-size", str(batch), "--steps", str(steps), "--seed", str(SEED),
                        "--out", str(Path(tmp) / "coarse.pkl")])
        torch.cuda.synchronize()
        launches = dict(ek.launch_counts)
        coarse_pkl = (Path(tmp) / "coarse.pkl").read_bytes()   # phase 4e's input
    expect = {"fused_gcl": n_batches * (steps + 1) * 12,
              "fused_coord_update": n_batches * (steps + 1) * 6,
              "fused_gcl_bwd": 0, "coord_update_autograd": 0}
    worst_mask = max(max(masking_violation(x_, m_).item(), masking_violation(h_, m_).item())
                     for x_, h_, m_ in run["batches"])
    worst_com = max(mean_zero_max_violation(x_, m_).item() for x_, _, m_ in run["batches"])
    finite = all(bool(torch.isfinite(x_).all() and torch.isfinite(h_).all())
                 for x_, h_, _ in run["batches"])
    print(f"main path: coarse CLI GEOM H={H} 6x2 layers, {run['molecules']} molecules in "
          f"{n_batches} batches of {batch}, steps={steps}: {run['seconds']:.3f} s wall, "
          f"{run['molecules'] / run['seconds']:.3f} molecules/s; launches {launches} "
          f"(expected {expect}); finite={finite} masking_violation={worst_mask} "
          f"mean_zero_max_violation={worst_com:.3e}")
    if launches != expect:
        fail(f"kernel launch counts {launches} != {expect}")
    if not finite or worst_mask != 0.0 or not worst_com < 1e-2:
        fail("samples are not finite, masked and CoM-free")

    # ---- 4b. the training path: the train CLI at the GEOM configuration
    torch.set_grad_enabled(True)
    cache = cache_after_step(ek, DenseGCL, init_weights, gen, device, h, e, em, nm, g)
    train_steps, evals, train_batch = 20, 2, 64
    with tempfile.TemporaryDirectory() as tmp:
        workdir = Path(tmp) / "run"
        ek.reset_launch_counts()
        train = train_cli.main(["coarse", "--init-seed", "0", f"train.workdir={workdir}",
                                "coarse.compute_dtype=bfloat16", f"train.batch_size={train_batch}",
                                "train.num_train_trees=512", f"train.max_steps={train_steps}",
                                "train.log_every=1", f"train.eval_every={train_steps // evals}",
                                "train.checkpoint_every=1000", f"train.seed={SEED}"])
        torch.cuda.synchronize()
        train_launches = dict(ek.launch_counts)
        eval_forwards = evals * train_cli.EVAL_BATCHES
        train_expect = {"fused_gcl": train_steps * 12 + eval_forwards * 12,
                        "fused_gcl_bwd": train_steps * 12,
                        "coord_update_autograd": train_steps * 6,
                        "fused_coord_update": eval_forwards * 6}
        with open(workdir / "metrics.csv") as f:
            rows = [r for r in csv.DictReader(f) if r["split"] == "train"]
        losses = [float(r["loss"]) for r in rows]
        norms = [float(r["grad_norm"]) for r in rows]
        trained = train["trainer"].state.model.state_dict()
        start = init_weights(cli.build_coarse_from_cfg(CoarseModelConfig(), device=device),
                             torch.Generator().manual_seed(0)).state_dict()
        unchanged = sorted(k for k, v in trained.items() if torch.equal(v, start[k]))
        print(f"training path: train CLI GEOM H={H} 6x2 layers, bf16 elementwise, batch "
              f"{train_batch}, {train_steps} steps: {train['seconds']:.3f} s wall, "
              f"{train['steps_per_sec']:.4f} steps/s and {train['molecules_per_sec']:.3f} "
              f"molecules/s after the first step; losses {losses[0]:.4g} .. {losses[-1]:.4g}, "
              f"grad_norm {min(norms):.4g} .. {max(norms):.4g}; launches {train_launches} "
              f"(expected {train_expect}); unchanged parameters {unchanged}")
        if len(rows) != train_steps or not all(map(math.isfinite, losses + norms)):
            fail("a training step gave a non-finite loss or grad_norm")
        if train_launches != train_expect:
            fail(f"training launch counts {train_launches} != {train_expect}")
        if set(unchanged) - ZERO_GRAD_PARAMS:
            fail(f"parameters not trained: {unchanged}")
        if not cache["ok"]:
            fail(f"kernel forward after an optimizer step disagrees with the plain forward: {cache}")

        # ---- 4c. a whole step's gradient, card against CPU
        step_grads = card_against_cpu(cli, ek, CoarseModelConfig, init_weights, gen, device)
        if not step_grads["ok"]:
            fail(f"card and CPU gradients disagree or miss parameters: {step_grads}")

        # ---- 4d. samples from the trained EMA weights
        ek.reset_launch_counts()
        run_ema = cli.main(["coarse", "--weights", str(workdir / "ema.pt"), "--num", "64",
                            "--batch-size", "64", "--steps", "100", "--seed", str(SEED),
                            "--out", str(Path(tmp) / "ema.pkl")])
        torch.cuda.synchronize()
    x_, h_, m_ = run_ema["batches"][0]
    ema_ok = (bool(torch.isfinite(x_).all() and torch.isfinite(h_).all())
              and max(masking_violation(x_, m_).item(), masking_violation(h_, m_).item()) == 0.0
              and mean_zero_max_violation(x_, m_).item() < 1e-2)
    print(f"EMA samples: 64 molecules at 100 steps from the trained ema.pt: "
          f"{run_ema['seconds']:.3f} s; finite, masked and CoM-free: {ema_ok}; "
          f"mean_zero_max_violation={mean_zero_max_violation(x_, m_).item():.3e}")
    if not ema_ok:
        fail("samples from the trained EMA weights are not finite, masked and CoM-free")

    # ---- 4e. the fine stage on phase 4's point sets
    assembled = assemble_phase(cli, coarse_pkl, device)

    # ---- 4f. the pipeline from the histogram to junction trees
    generated, generate_launches = generate_phase(cli, ek)

    # ---- 5. kernel list
    bounds = {"fused_gcl": bound(gcl_flops, gcl_sfu, gcl_bytes, sm_clock_hz, n_sms),
              "fused_coord_update": bound(coord_flops, coord_sfu, coord_bytes, sm_clock_hz, n_sms),
              "fused_gcl_bwd": bwd_bound}
    meta = {"fused_gcl": ("hierdiff_torch/csrc/fused_gcl.cu",
                          "hierdiff_tpu/ops/egnn_pallas.py:141"),
            "fused_coord_update": ("hierdiff_torch/csrc/fused_coord.cu",
                                   "hierdiff_tpu/ops/egnn_pallas.py:492"),
            "fused_gcl_bwd": ("hierdiff_torch/csrc/fused_gcl_bwd.cu",
                              "hierdiff_tpu/ops/egnn_pallas.py:346")}
    paths = {"sample": launches, "train": train_launches, "generate": generate_launches}
    kernels = []
    for name, runs in results.items():
        main_run = runs[0]   # random weights, attention on, f32: the main path's variant
        bound_ms, bound_by, parts = bounds[name]
        kernels.append({
            "name": name, "route": "cuda", "source": meta[name][0], "replaces": meta[name][1],
            "launches": sum(counts_[name] for counts_ in paths.values()),
            "launches_by_path": {p_: counts_[name] for p_, counts_ in paths.items()},
            "max_abs_err": max(r["max_abs_err"] for r in runs),
            "rel_err": max(r["rel_err"] for r in runs), "ms": main_run["ms"],
            "plain_ms": main_run["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_parts_ms": parts, "library_ms": None, "w2_matmul_ms": w2_matmul_ms,
            "variants": runs, "planted_faults": faults[name],
            "ok": all(r["ok"] for r in runs), **gcl_extra.get(name, {})})
    print(json.dumps({"kernels": kernels, "train": {
        k: train[k] for k in ("steps", "seconds", "steps_per_sec", "molecules_per_sec")},
        "cache_after_step": cache, "step_gradients": step_grads, "assemble": assembled,
        "generate": generated}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
