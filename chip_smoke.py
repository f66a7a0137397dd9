#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``hierdiff_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one output line each, any failure exits non-zero:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions, then the nvcc build of ``hierdiff_torch/csrc`` and its time;
  2. each kernel against its plain PyTorch version at the sampler's shapes
     (B=64, N=32, H=256, E=2, ragged node counts), on what the layer adds
     to its input (out - h for fused_gcl, out - x for fused_coord_update):
     the max error over the largest reference value must stay below 2e-2
     (the bar the Pallas kernels meet against XLA in
     tests/test_pallas_interpret.py). fused_gcl runs once more with a node
     MLP that passes the aggregated messages through, so the edge path is
     not hidden behind the node MLP's h term, and fused_coord_update with a
     coordinate head large enough to saturate tanh. Planted faults
     (gate skipped, a W2 output channel zeroed, edge mask ignored, tanh
     skipped), each run through the kernel, must fail that check. Kernel,
     plain and bound times;
  3. E(3) equivariance of the full-width DenseEGNN forward on the card;
  4. the main path: the ``coarse`` CLI at the GEOM configuration (H=256,
     6 blocks, random weights from --init-seed 0), 2 batches of 64 with
     node counts from the GEOM histogram, 100 strided steps, f32
     elementwise; the samples must be finite, masked and CoM-free, and the
     kernels' launch counts must be exactly those of the path;
  5. the kernel list as JSON, then the result JSON as the last line.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

B, N, H, E = 64, 32, 256, 2
TOL = 2e-2
SEED = 0
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores and HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
SFU_PER_CLOCK_PER_SM = 16     # exp2 / reciprocal results (CUDA guide, cc 9.0)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def nvidia_smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA GPU")
    from hierdiff_torch.ops import _build, egnn_kernels as ek
    from hierdiff_torch.ops.egnn import DenseEGNN, DenseEquivariantUpdate, DenseGCL
    from hierdiff_torch.ops.masked import mean_zero_max_violation, masking_violation
    from hierdiff_torch.sampling import cli
    from hierdiff_torch.tools.kernel_phases import layer_inputs
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
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{name}]: {line.strip()}")
    print(f"build: {sorted(logs)} compiled in {build_s:.2f} s")

    # ---- 2. kernels against their plain versions
    rng = np.random.default_rng(SEED)
    h, x, e, cdiff, em, nm, counts = layer_inputs(rng, device, B, N, H)
    c = counts.astype(np.int64)
    n_edges, n_nodes = float((c * (c - 1)).sum()), float(c.sum())
    w_bytes_pair = (2 * H * H + E * H + H * H) * 2 + 2 * H * 4
    results = {}

    def check(name, variant, kernel_fn, plain_fn, base):
        """What the kernel adds to ``base`` against what the plain version adds."""
        out, ref = kernel_fn() - base, plain_fn() - base
        torch.cuda.synchronize()
        abs_err, rel = rel_err(out, ref)
        ok = bool(torch.isfinite(out).all().item()) and rel < TOL
        k_ms, p_ms = time_ms(kernel_fn), time_ms(plain_fn, reps=5, warmup=1)
        print(f"kernel {name} [{variant}]: max_abs_err {abs_err:.3e} rel_err {rel:.3e} "
              f"(bar {TOL}) kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} {'ok' if ok else 'FAIL'}")
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
    gcl_flops = n_edges * (2 * H * H + 2 * E * H + 2 * H) + n_nodes * 10 * H * H
    gcl_sfu = n_edges * (4 * H + 2) + n_nodes * 2 * H
    gcl_bytes = (h.numel() * 4 * 2 + e.numel() * 4 + em.numel() * 4 + nm.numel() * 4
                 + w_bytes_pair + (H + 3 * H * H) * 2 + 3 * H * 4)

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

    equ = init_weights(DenseEquivariantUpdate(H, E, normalization_factor=10.0, tanh=True,
                                              coords_range=30.0 / 6).to(device), gen())
    with torch.no_grad():   # the head at 1e4 x its init scale, so tanh saturates
        equ.coord_mlp[4].weight.mul_(1e4)
        scalar = ek.coord_scalar(equ, h, e)[..., 0][em[..., 0] > 0].abs()
    saturated = (scalar > 2.0).float().mean().item()
    print(f"fused_coord_update input: |head scalar| > 2 (tanh saturated) on {saturated:.3f} "
          f"of the valid edges, median |scalar| {scalar.median().item():.3f}")
    if not saturated > 0.25:
        fail("the coordinate head does not drive tanh into saturation")
    check("fused_coord_update", "tanh coords_range=5 elementwise=float32",
          lambda: ek.fused_coord_update(equ, h, e, cdiff, x, em, nm),
          lambda: ek.coord_update_plain(equ, h, e, cdiff, x, em, nm), x)
    coord_flops = n_edges * (2 * H * H + 2 * E * H + 2 * H) + n_nodes * 4 * H * H
    coord_sfu = n_edges * (4 * H + 1)
    coord_bytes = (h.numel() * 4 + e.numel() * 4 + cdiff.numel() * 4 + em.numel() * 4
                   + nm.numel() * 4 + x.numel() * 4 * 2 + w_bytes_pair + H * 2)

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

    a_bf = torch.randn((B * N * N, H), device=device, dtype=torch.bfloat16)
    w_bf = torch.randn((H, H), device=device, dtype=torch.bfloat16)
    w2_matmul_ms = time_ms(lambda: a_bf @ w_bf)
    print(f"reference: (B*N*N, H) x (H, H) bf16 torch.matmul alone {w2_matmul_ms:.4f} ms "
          f"(tensor-core share of the edge MLP; not used by the port)")
    failed = [r["variant"] for rs in results.values() for r in rs if not r["ok"]]
    if failed:
        fail(f"kernel disagrees with its plain version: {failed}")

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
    expect = {"fused_gcl": n_batches * (steps + 1) * 12,
              "fused_coord_update": n_batches * (steps + 1) * 6}
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

    # ---- 5. kernel list
    bounds = {"fused_gcl": bound(gcl_flops, gcl_sfu, gcl_bytes, sm_clock_hz, n_sms),
              "fused_coord_update": bound(coord_flops, coord_sfu, coord_bytes, sm_clock_hz, n_sms)}
    meta = {"fused_gcl": ("hierdiff_torch/csrc/fused_gcl.cu",
                          "hierdiff_tpu/ops/egnn_pallas.py:141"),
            "fused_coord_update": ("hierdiff_torch/csrc/fused_coord.cu",
                                   "hierdiff_tpu/ops/egnn_pallas.py:492")}
    kernels = []
    for name, runs in results.items():
        main_run = runs[0]   # random weights, attention on, f32: the main path's variant
        bound_ms, bound_by, parts = bounds[name]
        kernels.append({
            "name": name, "route": "cuda", "source": meta[name][0], "replaces": meta[name][1],
            "launches": launches[name], "max_abs_err": max(r["max_abs_err"] for r in runs),
            "rel_err": max(r["rel_err"] for r in runs), "ms": main_run["ms"],
            "plain_ms": main_run["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_parts_ms": parts, "library_ms": None, "w2_matmul_ms": w2_matmul_ms,
            "variants": runs, "planted_faults": faults[name],
            "ok": all(r["ok"] for r in runs)})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
