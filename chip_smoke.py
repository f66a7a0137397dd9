#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``hierdiff_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one output line each, any failure exits non-zero:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions, then the nvcc build of ``hierdiff_torch/csrc`` (and, beside
     it, the phase-clock build of fused_gcl_bwd, which counts the edges its
     edge kernel computes) and its time, and the number of HGMMA (wgmma)
     instructions in each built library (``cuobjdump --dump-sass``), none
     of which may be 0; the run fails if the treekit library (the native
     searches and packers, ``hierdiff_torch/runtime``) does not build;
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
     bitwise equal. The CLI's native search against the Python search
     (``native_search=False``) on the card's lattices from the same seed:
     bitwise equal trees and tiebreak streams, both times printed. The
     lattice's wall and device ms per chunk, by bucket (device:
     torch.profiler), the host search's seconds and trees/s;
  4f. ``sampling.cli generate --init-seed 0 --denoise-init-seed 0``: 64
     molecules, 100 coarse steps, beam 5: a spanning tree for every molecule,
     the coarse kernels' launches exactly 12 fused_gcl and 6
     fused_coord_update per model call (100 reverse steps and the final one)
     per coarse chunk; molecules/s, t_coarse and t_fine; overlapped (the
     default: coarse chunks stream into the fine stage), then with its
     stages one after the other (``tools/overlap_ab.serial_stages``): the
     point sets and the trees bitwise equal (every
     bucket arrives in one coarse chunk), launches exact in both;
  4g. the refine stage: ``sampling.cli assemble --denoise-init-seed 0
     --refine-init-seed 0`` at the GEOM refine width (H=256, 2 layers per
     phase, 780 types, max_size 26) on phase 4's 128 point sets, beam 5: a
     spanning tree for every molecule, through the native refine-on search
     (its group rounds, fleet rows and lanes counted); the pipelined Python
     search on the same lattices gives the same trees bit for bit, runs at
     least one fused check and commits at least one swap (counted around
     its hook); native and Python search, dispatch, collect and walk
     seconds. On the Python search's first checked fleet of
     the two fullest buckets: the card's fused check against the CPU's
     under ``tools/refine_check.py`` (total and new_total within 1e-3 of the
     fleet's largest |total|; a differing node, type or valid slot only
     where the CPU's competing log-probabilities are within 1e-4 of the
     row's largest |log-probability|; the CPU's f32 against its f64 printed
     beside it), the dynamic depth against the static one and a repeat,
     bitwise. Wall, device ms (torch.profiler) and peak memory of one
     fused check per bucket. On the fullest bucket's molecules, card
     against card, bitwise: the pipelined search against the native one,
     the sequential group searches with the same seeds, a second pipelined
     run, and merge 4 against merge 1 (16 one-molecule groups). trees/s, lattice and
     search seconds, the hook's dispatch / collect / walk seconds;
  4h. ``sampling.cli generate`` as 4f with ``--refine-init-seed 0``, on and
     off overlap as 4f: a tree per molecule, the native search's counters,
     the coarse launches exact per chunk, the overlapped run bitwise the
     serial one; molecules/s, t_coarse, t_fine and the hook's counters;
  4r. ``sampling.cli assemble --denoise-init-seed 0
     denoise.vocab_conditioning=true`` (the round-based ``ARSampler``) at
     GEOM width, beam 5, on phase 4's first 16 point sets of bucket 16: a
     spanning tree per molecule, every round's fleet from the native packer
     bitwise the Python packer's, the first two rounds' expansions card
     against CPU under the margin rule of 4e, two runs bitwise equal, no
     coarse kernel; model steps, seconds and trees/s;
  4i. ``train.cli denoise --config configs/denoise_geom.yaml --init-seed 0``
     (H=256, 3 + 3 layers, 780 types, batch 32, f32), a synthetic pool of
     512 trees, 20 steps, two evaluations: every batch from the native
     packer, every logged loss, term, accuracy and grad_norm finite, every
     parameter moved but those of ``FINE_ZERO_GRAD`` (each with its reason),
     no coarse kernel launched; steps/s and trees/s after the first step,
     the first and last losses and accuracies, peak memory, and one step
     per bucket profiled (wall and device ms, busy share, kernels, and a
     synchronised split: forward, its depth passes, backward, update);
  4j. the same for ``train.cli refine --config configs/refine_geom.yaml``
     (H=256, 2 layers per phase, batch 16);
  4k. one step's gradient of each model at GEOM width (8 trees of bucket
     24), card against CPU, TF32 off: every parameter's gradient within
     1e-3 of its largest |value| (floored at 1e-3 of the model's largest),
     the loss terms within 1e-4; the CPU's f32 against its f64 printed
     beside them; three card runs must repeat bitwise (a gate for both
     models), and the ops that deterministic-algorithms mode names are
     printed, with and without the fixed-order backward of the parent
     gathers;
  4l. the planted-signal check (tests/test_planted_learning.py's): hidden
     64, one layer, planted_k=16, 250 AdamW steps at 2e-3: the denoise node
     accuracy and the refine accuracy each above 0.6;
  4m. the ema.pt files of 4i and 4j through ``sampling.cli assemble
     --denoise-weights --refine-weights`` on phase 4's point sets: strict
     loads and a spanning tree per molecule;
  4n-4q run under the fake-RDKit harness (``tests/fake_rdkit.py``, numpy
     only, installed after 4m; the run first checks that the machine has no
     RDKit, so that 4e-4m run ungated; every line these phases print, the
     CLIs' own too, is marked as the harness's): its chemistry is a
     deterministic stand-in, so valid, unique and the panel's numbers are
     not chemistry. Its pure-Python sanitization makes one reference gate
     verdict on a GEOM-width random tree cost up to minutes, so here one
     verdict may sanitize at most 50 candidates: a verdict over that is
     refused and counted (the port's gate has no bound), and every node of
     every returned tree is re-checked by an uncapped gate, which must
     accept it. Each run of 4n, 4o and 4q fails past 240 s;
  4n. ``sampling.cli assemble --denoise-init-seed 0`` with the assembly
     gate, refine off, on phase 4's point sets of at most 8 nodes, and the
     same sets ungated beside it: every returned tree a spanning tree whose
     every node passes the uncapped gate, the gate queried; the Python
     gated search second on the same lattices (its verdicts from the gate's
     cache) bitwise the native one; trees/s gated,
     ungated and 4e's, the gate's hits, misses, hit rate and refusals at
     the cap;
  4o. ``sampling.cli generate --num 16 --sample-steps 100 --max-nodes 3
     --refine-init-seed 0`` with 0 and then 2 reconstruction workers: the
     coarse launches exact, every assembled tree reconstructed (attempts =
     trees - max9, valid = molecules / attempts), the same molecules and
     stats from both worker counts, molecules and stats in the pickle, every
     node passes the uncapped gate; t_coarse, t_fine, t_reconstruct and its
     share of the wall, valid, unique, avg_atoms, the gate's counters; then
     ``--chunk-size 8 --workers 2`` (``run_streamed``: each chunk
     reconstructed by the pool while the next samples): 16 trees, the
     molecules, the panel's stats and t_device, the coarse launches exact
     per macro-chunk;
  4p. ``sampling.cli reconstruct`` on 4o's pickle (2 workers) gives 4o's
     molecules and stats; ``eval.cli`` on them writes every key of the JAX
     panel; the six test molecules of ``hierdiff_torch/tools/chem_check.py``
     reconstruct to the SMILES that the CPU tests pin against the JAX
     package;
  4q. ``sampling.cli assemble --denoise-init-seed 1 --refine-init-seed 0``
     with the gate on phase 4's 6 smallest point sets of at least 12 nodes
     (a fused check needs an unfinished tree of more than 10 typed nodes;
     seed 0's random types, rings of up to 16 atoms, end every such gated
     search before that, seed 1's are mostly single atoms), through the
     native search: the hook's fused checks ran; the pipelined Python
     search second on the same lattices (verdicts from the cache), its
     trees repaired by ``finalize``, bitwise the CLI's, and in it a swap
     passed the gate and was committed (counted around its hook); every
     returned tree a spanning tree whose every node passes the uncapped
     gate; trees/s, checks, swaps and the gate's counters;
  4u. ``sampling.cli assemble --fine-bf16 --denoise-init-seed 0`` (bf16
     in the full and focal layers only) on phase 4's point sets: spanning
     trees, trees/s beside 4e's f32 rate; every bucket's bf16 lattice
     against the f32 lattice of the same weights on the card (a focal or
     attach choice may differ only where the f32 margin is below 5e-2;
     top_logp within 5e-2 of the step's largest |top_logp|; top-1 types
     agree at 0.8 of the compared steps or more, the JAX package's bar);
     4 sets of the fullest bucket card against CPU in bf16 under the same
     rule; wall and device ms (torch.profiler) of a lattice chunk at
     buckets 16 and 32, bf16 and f32; ``generate --fine-bf16``, 16
     molecules, refine off: spanning trees, coarse launches exact;
  4v. the size variant's per-node vocab restriction
     (``data/denoise.array_dict_allowed_fn``) on phase 4's point sets,
     beam 5: every type inside its node's support, the Python search on
     the same lattices bitwise the native one, the whole vocabulary as
     support bitwise the unrestricted trees; the ``ARSampler`` at 4r's
     configuration restricted the same way; trees/s restricted and not;
  4w. one coarse training step at 4b's configuration (bf16, batch 64, a
     fixed pool batch, injected t and noise) with ``remat`` /
     ``remat_edges`` off, each and both: losses bitwise, gradients within
     1e-6 of their largest value, launches per step exact (12 fused_gcl +
     12 fused_gcl_bwd + 6 plain coordinate updates; with remat 24 + 12 +
     12: the recompute), peak memory and the median ms of 5 steps; a
     no-grad forward in each setting the plain one with the sampler's
     launches; peak memory off and with remat_edges at 4s's pocket shapes;
     ``train.cli
     coarse`` 5 steps with both flags, its parameters bitwise those with
     both off;
 4x. data parallelism on the one card: ``train.cli coarse --data-parallel``
     for those 5 steps in a world-1 NCCL group, its parameters bitwise 4w's
     plain run and its launches exact; one bf16 step of 4b's model at
     world 2 over gloo (two spawned ranks, both on the card: NCCL refuses
     two ranks on one device) on 64 molecules with injected t and noise,
     the gradient the update took within 4c's bar (global relative L2 <
     2e-2) of the single-process step's, the ranks' parameters bitwise
     equal, 12 fused_gcl + 12 fused_gcl_bwd + 6 plain coordinate updates
     per rank;
 4y. ``generate`` of 16 molecules at 100 steps at world 2 over gloo: point
     sets and trees bitwise those of a world-1 run in a spawned process of
     its own (serial), each rank's coarse launches exact for its share of
     the chunks, molecules/s beside world 1's;
 4z. ``entry.dryrun_multichip(2, backend="gloo")`` on the card: one DP
     step, sharded generation, refine + gate + reconstruction, every rank
     with a share of both generation checks and its launches exact for it;
  5a. reference checkpoints: GEOM-width coarse, denoise and refine weights
     (seeded random) saved raw and in the reference's PyTorch-Lightning
     layout (``state_dict`` with the ``model.`` prefix, a config object in
     ``hyper_parameters``, which the weights-only unpickler refuses, and
     the non-parameter buffers the loader skips); ``sampling.cli coarse
     --weights`` (16 point sets of <= 12 nodes, 20 steps), ``assemble
     --denoise-weights --refine-weights`` (refine checks on) and ``train.cli
     coarse --weights`` (3 steps) from each: point sets, trees and trained
     parameters bitwise equal, the coarse launches exact;
  5b. the JT-VAE stack (``models/jtnn.py``) at the JAX package's defaults
     (vocab 780, hidden 450, latent 56): the encoder and the teacher-forced
     decoder on 32 synthetic GEOM trees of <= 32 nodes, MPN and JTMPN on
     ``mol2graph_dense`` of 12 harness molecules (the harness installed for
     the featurisation alone), each forward and backward card against CPU
     under 4c's margin rule, the gradients bitwise on a second backward, the
     device and wall ms of a forward+backward;
  5c. under the harness, after 4n-4q: ``chem/mff_rmsd`` on 16 molecules
     (base_rmsd finite, each at RMSD 0 from itself, a lifted conformer
     finite), ``chem/preprocess.process_sdf`` on their SDF read back by
     ``load_tree_pool``, and one ``train.cli denoise`` step on those trees;
  6. the kernel list as JSON (``launches_by_path`` counts every path above:
     the two fine-stage training paths, both gated generate runs, the
     serial generate runs, run_streamed, the ARSampler, 4u's and 4w's
     runs, 4x-4z's ranks (``train_dp``, ``generate_dp``, ``dryrun_dp``),
     5a's six runs and 5c's denoise step included), then the result JSON
     as the last line.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import copy
import csv
import ctypes
import json
import math
import pickle
import random
import shutil
import signal
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


def card_against_cpu(ek, model, batch: dict, what: str, show=()) -> dict:
    """The gradient of one training loss of ``model`` (on the card, in
    training mode) on the numpy ``batch`` with injected t and noise, on the
    card (kernels) and on the CPU (plain). The CPU runs the batch a second
    time in reverse order: the same loss, summed in another order, so a
    parameter's gradient that moves by ``ROUNDING_SHARE`` of its size or more
    is at rounding level, and neither its card value nor its being nonzero
    is held to the CPU's. The errors of the parameters whose names start
    with one of ``show`` are printed and returned by name."""
    from hierdiff_torch.ops.masked import combine_noise

    rng = np.random.default_rng(SEED + 1)
    b, n = batch["atom_mask"].shape[:2]
    t_int = torch.from_numpy(rng.integers(0, model.timesteps + 1, size=(b, 1)))
    eps = combine_noise(torch.from_numpy(rng.standard_normal((b, n, 11)).astype(np.float32)),
                        torch.from_numpy(batch["atom_mask"]), 3)
    device = next(model.parameters()).device

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
    margin = grad_margin(card, cpu, cpu_rev)
    per, rounding, glob, missing = (margin[k] for k in ("per", "rounding", "global", "missing"))
    worst = max(per, key=per.get)
    egnn = {k: v for k, v in per.items() if not k.startswith("gamma.")}
    worst_egnn = max(egnn, key=egnn.get)
    ok = (glob < 2e-2 and not missing and launches["fused_gcl_bwd"] == 12
          and all(v is not None and v < 2e-2 for v in ({k: per.get(k) for k in cpu
                                                         if k.startswith(tuple(show))}.values()
                                                        if show else ())))
    print(f"step gradients, card against CPU: {what}, B={b} N={n}: global "
          f"relative L2 error {glob:.3e} (bar 2e-2), worst tensor above rounding {worst} "
          f"{per[worst]:.3e}, worst outside the gamma network {worst_egnn} "
          f"{egnn[worst_egnn]:.3e}; launches on the card {launches}; parameters without a "
          f"gradient {missing}; at rounding level on the CPU (L2 norms, and the share by which "
          f"reversing the batch order moves the CPU gradient): "
          + ", ".join(f"{k} cpu {r['cpu_l2']:.4g} moved {r['moved_by_reversal']:.3g} card "
                      f"{r['card_l2']:.4g}" for k, r in rounding.items()))
    shown = {k: per.get(k) for k in cpu if k.startswith(tuple(show))} if show else {}
    if shown:
        print(f"  of them: {shown} (None: at rounding level)")
    return {"global_rel_l2": glob, "worst_tensor": worst, "worst_rel_l2": per[worst], **shown,
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


def complete_graphs(counts: np.ndarray):
    """(real edges, real nodes) of molecules of ``counts`` nodes, each fully
    connected without self-loops."""
    c = counts.astype(np.int64)
    return float((c * (c - 1)).sum()), float(c.sum())


def mask_edges_nodes(edge_mask: torch.Tensor, node_mask: torch.Tensor):
    """(real edges, real nodes): nonzeros of the masks, any pattern."""
    return float((edge_mask != 0).sum().item()), float((node_mask != 0).sum().item())


def coord_work(n_edges: float, n_nodes: float, b: int, n: int):
    """fused_coord_update's least work for a batch: bf16 FLOPs (edge MLP,
    head and the node projections), SFU operations and bytes over the real
    edges and nodes (each input read once, out written)."""
    flops = n_edges * (2 * H * H + 2 * E * H + 2 * H) + n_nodes * 4 * H * H
    sfu = n_edges * (4 * H + 1)
    nbytes = (b * n * H * 4 + b * n * n * E * 4 + b * n * n * 3 * 4 + b * n * n * 4 + b * n * 4
              + b * n * 3 * 4 * 2 + PAIR_WEIGHT_BYTES + H * 2)
    return flops, sfu, nbytes


def gcl_work(n_edges: float, n_nodes: float, b: int, n: int):
    """fused_gcl's least work for a batch: bf16 FLOPs, SFU operations and
    bytes over the real edges and nodes (each input read once, out written)."""
    flops = n_edges * (2 * H * H + 2 * E * H + 2 * H) + n_nodes * 10 * H * H
    sfu = n_edges * (4 * H + 2) + n_nodes * 2 * H
    nbytes = (b * n * H * 4 * 2 + b * n * n * E * 4 + b * n * n * 4 + b * n * 4
              + PAIR_WEIGHT_BYTES + (H + 3 * H * H) * 2 + 3 * H * 4)
    return flops, sfu, nbytes


def bwd_work(n_edges: float, n_nodes: float, b: int, n: int):
    """fused_gcl_bwd's least work for a batch: bf16 FLOPs, SFU operations and
    bytes over the real edges and nodes (each input read once, each output
    written once)."""
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
    return device_ms_of(prof.key_averages())


def device_ms_of(averages) -> float:
    """Device time of every CUDA activity in a profile's ``key_averages()``."""
    from torch.autograd import DeviceType

    total = 0.0
    for evt in averages:
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
    from hierdiff_torch.sampling.lattice import LatticeSampler, _next_pow2, pad_blur, pow2_chunks
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

    # the CLI's native search against the Python one on the same card
    # lattices, each from a tiebreak stream seeded as the CLI's (2022)
    search_s, streams, found = {}, {}, {}
    for native in (True, False):
        rng = random.Random(2022)
        s_ = LatticeSampler(sampler.model, beam_size=sampler.beam_size, buckets=sampler.buckets,
                            rng=rng, native_search=native)
        t0 = time.perf_counter()
        found[native] = s_._search(blur, run["lattices"])
        search_s[native] = time.perf_counter() - t0
        streams[native] = rng.getstate()
    native_check = {"cli_search_s": run["search_s"], "native_s": search_s[True],
                    "python_s": search_s[False],
                    "bitwise": same_trees(found[True], found[False])
                    and same_trees(found[True], run["trees"]),
                    "same_stream_after": streams[True] == streams[False]}
    print(f"assemble search, native against Python on the card's lattices: "
          f"{json.dumps(native_check)}")
    if not (native_check["bitwise"] and native_check["same_stream_after"]):
        fail(f"the native search differs from the Python search: {native_check}")

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
                for c, o in sampler._dispatch_lattices(blur, [(nb, chunk)]):
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
            "trees_per_s": len(blur) / seconds, "chunks": chunks, "card_against_cpu": checks,
            "native_against_python": native_check}


def generate_phase(cli, ek, num: int = 64, steps: int = 100, refine: bool = False,
                   overlap: bool = True):
    """Phase 4f (4h with ``refine``: the refine model's checks in the
    search): ``sampling.cli generate`` from the GEOM histogram to trees,
    overlapped (the default) or under ``serial_stages``; the coarse kernels'
    launches must be exact for the chunk plan. Returns (stats, launches,
    the pipeline's result, the pipeline)."""
    from hierdiff_torch.tools.overlap_ab import serial_stages

    name = ("generate, refine on" if refine else "generate") + (
        "" if overlap else ", overlap off")
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "generated.pkl"
        ek.reset_launch_counts()
        with contextlib.nullcontext() if overlap else serial_stages():
            run = cli.main(["generate", "--init-seed", "0", "--denoise-init-seed", "0",
                            *(["--refine-init-seed", "0"] if refine else []),
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
    hook = pipe.sampler.refine_hook
    stats = {"molecules": num, "overlap": overlap, "seconds": run["seconds"],
             "molecules_per_s": num / run["seconds"], **result.stats,
             "coarse_chunks": n_chunks, "launches": launches, "faults": faults,
             "refine": None if hook is None else dict(hook.stats)}
    print(f"{name}: {num} molecules, {steps} coarse steps, beam 5, {n_chunks} coarse chunks: "
          f"{run['seconds']:.3f} s, {stats['molecules_per_s']:.3f} molecules/s, t_coarse "
          f"{result.stats['t_coarse']:.3f} s, t_fine {result.stats['t_fine']:.3f} s; launches "
          f"{launches} (expected {expect}); faults {faults}; refine {stats['refine']}")
    if launches != expect:
        fail(f"{name}: kernel launch counts {launches} != {expect}")
    if faults:
        fail(f"{name} gave trees that are missing or invalid: {faults}")
    if refine and not (hook.stats["rounds"] > 0 and hook.stats["lanes"] > 0):
        fail(f"{name}: the native refine search did not run: {hook.stats}")
    return stats, launches, result, pipe


def overlap_check(name: str, on, off, pipe) -> dict:
    """4f / 4h: the overlapped run against the serial one. The point sets
    bitwise (one chunk plan, one seed per chunk). The trees bitwise: every
    bucket's molecules arrive in one coarse chunk at these sizes (64
    molecules, chunks of up to 64 per bucket), so the streamed lattices run
    at the serial batch shapes; the check fails if that does not hold."""
    sizes = np.asarray([b["h"].shape[0] for b in on.blur])
    plan = pipe._plan_chunks(sizes)
    whole = len({nb for nb, _ in plan}) == len(plan)
    res = {"same_blur": all(np.array_equal(a["x"], b["x"]) and np.array_equal(a["h"], b["h"])
                            for a, b in zip(on.blur, off.blur)),
           "every_bucket_whole": whole, "same_trees": same_trees(on.trees, off.trees)}
    print(f"{name}, overlap on against off: {json.dumps(res)}")
    if not (res["same_blur"] and whole and res["same_trees"]):
        fail(f"{name}: the overlapped run differs from the serial one: {res}")
    return res


def same_trees(a, b) -> bool:
    """Two searches' trees equal bit for bit (wids, adjacency and logp)."""
    return len(a) == len(b) and all(
        (x is None) == (y is None) and (x is None or (
            np.array_equal(x.wids, y.wids) and np.array_equal(x.adj, y.adj) and x.logp == y.logp))
        for x, y in zip(a, b))


def refine_assemble_phase(cli, coarse_pkl: bytes, device) -> dict:
    """Phase 4g: ``sampling.cli assemble`` with the refine model at GEOM
    width on phase 4's point sets, through the native refine-on search:
    trees, fused checks and the native counters. The pipelined Python
    search on the same lattices must give the same trees bit for bit, and
    commit at least one swap (counted around its hook). On the Python
    search's first checked fleets of the two fullest buckets the card's
    fused check against the CPU's (``tools/refine_check.py``), the dynamic
    against the static depth and a repeat, bitwise; device ms and peak
    memory of a fused check by bucket; on one bucket's molecules the
    pipelined search against the native one, the sequential group searches,
    a second pipelined run, and merge 4 against merge 1, bitwise."""
    from torch.profiler import ProfilerActivity, profile

    from hierdiff_torch.config import RefineConfig
    from hierdiff_torch.data.collate import bucket_for
    from hierdiff_torch.sampling import lattice as lat
    from hierdiff_torch.sampling.beam import PQBeamSearch
    from hierdiff_torch.sampling.refine_hook import RefineHook
    from hierdiff_torch.tools.refine_check import compare_fused
    from hierdiff_torch.utils.weights import init_weights

    with tempfile.TemporaryDirectory() as tmp:
        src, out = Path(tmp) / "coarse.pkl", Path(tmp) / "trees.pkl"
        src.write_bytes(coarse_pkl)
        run = cli.main(["assemble", "--coarse-pkl", str(src), "--denoise-init-seed", "0",
                        "--refine-init-seed", "0", "--out", str(out)])
        with open(out, "rb") as f:
            trees = pickle.load(f)["trees"]
    blur, sampler, lattices = run["blur"], run["sampler"], run["lattices"]
    hook = sampler.refine_hook
    sizes = [b["h"].shape[0] for b in blur]
    faults = spanning_tree_faults(trees, sizes)
    seconds = run["lattice_s"] + run["search_s"]
    st = dict(hook.stats)

    # the pipelined Python search on the same lattices, counted around its
    # hook: the first checked fleet of each bucket and the swaps it commits
    seen = {"fleets": {}, "swaps": 0}
    py_hook = RefineHook(hook.model, hook.vocab_sizes, buckets=hook.buckets)
    real_dispatch, real_collect = py_hook.dispatch_batch, py_hook.collect_batch

    def dispatch(states):
        act = [s for s in states if np.sum(s.wids >= 0) * py_hook.check_frac > 1]
        if act:
            nb = bucket_for(max(s.n for s in act), py_hook.buckets)
            seen["fleets"].setdefault(nb, [s.clone() for s in act])
        return real_dispatch(states)

    def collect(token, states):
        res = real_collect(token, states)
        seen["swaps"] += sum(changed for _, _, changed in res)
        return res

    py_hook.dispatch_batch, py_hook.collect_batch = dispatch, collect
    py_sampler = lat.LatticeSampler(sampler.model, beam_size=sampler.beam_size,
                                    buckets=sampler.buckets, refine_hook=py_hook,
                                    native_search=False)
    t0 = time.perf_counter()
    py_trees = py_sampler._search(blur, lattices)
    py_search_s = time.perf_counter() - t0
    pst = dict(py_hook.stats)
    native_is_python = same_trees(run["trees"], py_trees)
    print(f"assemble, refine on: GEOM refine H={hook.model.hidden_size} x {hook.model.n_layers} "
          f"layers per phase, {len(blur)} molecules: lattices {run['lattice_s']:.3f} s, native "
          f"search {run['search_s']:.3f} s, {len(blur) / seconds:.3f} trees/s; {st['score_calls']} "
          f"fused checks (dispatch {st['dispatch_s']:.3f} s, collect {st['collect_s']:.3f} s, "
          f"walk {st['walk_s']:.3f} s; {st['rounds']} group rounds, {st['fleet_rows']} fleet "
          f"rows, {st['lanes']} lanes); the pipelined Python search on the same lattices "
          f"{py_search_s:.3f} s, {pst['score_calls']} fused checks (dispatch "
          f"{pst['dispatch_s']:.3f} s, collect {pst['collect_s']:.3f} s, walk "
          f"{pst['walk_s']:.3f} s), {seen['swaps']} swaps committed; native trees bitwise the "
          f"Python ones: {native_is_python}; faults {faults}")
    if faults:
        fail(f"refine-on assemble gave trees that are missing or invalid: {faults}")
    if st["score_calls"] < 1 or seen["swaps"] < 1:
        fail("refine-on assemble ran no fused check or committed no swap")
    if not (st["rounds"] > 0 and st["fleet_rows"] > 0 and st["lanes"] > 0):
        fail(f"the native refine search did not count its rounds, rows and lanes: {st}")
    if not native_is_python:
        fail("the native refine-on search differs from the pipelined Python search")

    def fused(h, fleet, nb, sp, margins=False, dtype=torch.float32):
        base = [t.to(dtype) for t in h._pack_states(fleet, nb, sp)]
        wids = torch.full((sp, nb), -1, dtype=torch.int64)
        for i, s_ in enumerate(fleet):
            wids[i, :s_.n] = torch.from_numpy(s_.wids)
        return h._fused_check(base[0], wids.to(h.device), *base[1:], nb, margins)

    by_bucket = {}
    for i, n in enumerate(sizes):
        by_bucket.setdefault(bucket_for(n, sampler.buckets), []).append(i)
    cpu_model = init_weights(cli.build_refine_from_cfg(RefineConfig(), "cpu"),
                             torch.Generator().manual_seed(0))
    cpu_hook = RefineHook(cpu_model, hook.vocab_sizes, buckets=hook.buckets)
    cpu64_hook = RefineHook(copy.deepcopy(cpu_model).double(), hook.vocab_sizes,
                            buckets=hook.buckets)
    static_hook = RefineHook(hook.model, hook.vocab_sizes, buckets=hook.buckets)
    static_hook.model = hook.model.clone(dynamic_depth=False)
    per_bucket, checks = [], {}
    for nb, fleet in sorted(seen["fleets"].items()):
        fleet = fleet[:hook.fleet_chunk_rows(nb)]
        sp = hook.fleet_pad_rows(nb)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        card = fused(hook, fleet, nb, sp)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fused(hook, fleet, nb, sp)
            torch.cuda.synchronize()
        row = {"bucket": nb, "rows": len(fleet), "padded_rows": sp,
               "K": max(1, int(nb * hook.check_frac)), "wall_ms": wall_ms,
               "device_ms": profiled_device_ms(prof),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        per_bucket.append(row)
        print(f"fused check, bucket {nb}: {len(fleet)} rows padded to {sp}, K={row['K']}: wall "
              f"{wall_ms:.1f} ms, device {row['device_ms']:.1f} ms (torch.profiler), peak "
              f"{row['peak_gib']:.2f} GiB")
    fullest = sorted(seen["fleets"], key=lambda b: -len(by_bucket.get(b, [])))[:2]
    for nb in fullest:
        fleet = seen["fleets"][nb][:hook.fleet_chunk_rows(nb)]
        sp, K, rows = hook.fleet_pad_rows(nb), max(1, int(nb * hook.check_frac)), len(fleet)
        card = fused(hook, fleet, nb, sp).cpu().numpy()[:rows]
        again = fused(hook, fleet, nb, sp).cpu().numpy()[:rows]
        static = fused(static_hook, fleet, nb, sp)
        cpu = fused(cpu_hook, fleet, nb, rows, margins=True).numpy()
        cpu64 = fused(cpu64_hook, fleet, nb, rows, margins=True, dtype=torch.float64).numpy()
        report = compare_fused(cpu, card, K, margin=1e-4, tol=1e-3, relative=True)
        f64 = compare_fused(cpu64, cpu[:, :1 + 4 * K], K, margin=1e-4, tol=1e-3, relative=True)
        check = {"rows": rows, "K": K, "slots_compared": report["slots_compared"],
                 "cut": report["cut"], "failures": report["failures"][:5],
                 "max_total_rel_err": report["max_total_rel_err"],
                 "max_new_total_rel_err": report["max_new_total_rel_err"],
                 "close_calls": report["close_calls"],
                 "largest_total": float(np.abs(cpu[:, 0]).max()),
                 "bitwise_repeat": bool(np.array_equal(card, again)),
                 "bitwise_static_depth": bool(np.array_equal(card, static.cpu().numpy()[:rows])),
                 "cpu_f32_against_f64": {k: f64[k] for k in (
                     "slots_compared", "cut", "max_total_rel_err", "max_new_total_rel_err")}}
        checks[f"bucket {nb}"] = check
        print(f"fused check card against CPU, bucket {nb}: {json.dumps(check)}")
        if not (report["ok"] and check["bitwise_repeat"] and check["bitwise_static_depth"]):
            fail(f"the card's fused check disagrees with the CPU's or is not repeatable: {check}")

    # the searches on one bucket's molecules, card against card
    nb = fullest[0]
    sub = [blur[i] for i in by_bucket[nb]]
    sub_lat = {j: lattices[i] for j, i in enumerate(by_bucket[nb])}

    def search(cap, merge=1, members=None, native=False):
        h = RefineHook(hook.model, hook.vocab_sizes, buckets=hook.buckets)
        blur_, lat_ = (sub, sub_lat) if members is None else (
            [sub[j] for j in members], {k: sub_lat[j] for k, j in enumerate(members)})
        s_ = lat.LatticeSampler(sampler.model, beam_size=sampler.beam_size,
                                buckets=sampler.buckets, refine_hook=h,
                                refine_group_cap=cap, refine_merge=merge, native_search=native)
        t0 = time.perf_counter()
        out_ = s_._search(blur_, lat_)
        return out_, s_, h, time.perf_counter() - t0

    pipelined, s_pipe, h_pipe, t_pipe = search(32)
    second = search(32)[0]
    native, _, h_nat, t_nat = search(32, native=True)
    seed_base = random.Random(2022).getrandbits(64)
    h_seq = RefineHook(hook.model, hook.vocab_sizes, buckets=hook.buckets)
    sequential = [None] * len(sub)
    t0 = time.perf_counter()
    for members, _ in s_pipe._refine_groups(sub):
        res = PQBeamSearch(lat.LatticeExpander(sub_lat), beam_size=sampler.beam_size,
                           refine_hook=h_seq,
                           rng=random.Random(lat._group_seed(seed_base, members))).run(
            lat.LatticeSampler._init_states(sub, members))
        for i, r in zip(members, res):
            sequential[i] = r
    t_seq = time.perf_counter() - t0
    lanes = list(range(min(16, len(sub))))
    merged = {m: search(1, m, lanes) for m in (1, 4)}
    searches = {"bucket": nb, "molecules": len(sub),
                "groups": len(s_pipe._refine_groups(sub)),
                "pipelined_s": t_pipe, "sequential_s": t_seq, "native_s": t_nat,
                "checks_pipelined": h_pipe.stats["score_calls"],
                "checks_native": h_nat.stats["score_calls"],
                "native_is_pipelined": same_trees(native, pipelined),
                "checks_sequential": h_seq.stats["score_calls"],
                "pipelined_is_sequential": same_trees(pipelined, sequential),
                "bitwise_second_run": same_trees(pipelined, second),
                "merge_groups": len(lanes),
                "merge_checks": {m: merged[m][2].stats["score_calls"] for m in merged},
                "merge_s": {m: merged[m][3] for m in merged},
                "merge4_is_merge1": same_trees(merged[4][0], merged[1][0])}
    print(f"refine-on searches, card against card: {json.dumps(searches)}")
    if not (searches["pipelined_is_sequential"] and searches["bitwise_second_run"]
            and searches["merge4_is_merge1"] and searches["native_is_pipelined"]):
        fail(f"refine-on searches are not bitwise equal: {searches}")
    return {"molecules": len(blur), "lattice_s": run["lattice_s"], "search_s": run["search_s"],
            "trees_per_s": len(blur) / seconds, "refine": st, "swaps": seen["swaps"],
            "python_search_s": py_search_s, "python_refine": pst,
            "native_is_python": native_is_python,
            "fused_check_by_bucket": per_bucket, "card_against_cpu": checks,
            "searches": searches}


# parameters of the fine stage's models whose gradient is zero by structure,
# so that training may leave them unchanged (phases 4i, 4j)
FINE_ZERO_GRAD = {
    "denoise": {
        **{f"gcl_focal_2.edge_mlp.{i}.{p}": "the last focal layer's edge update feeds nothing"
           for i in (0, 2) for p in ("weight", "bias")},
        "edge_predict.2.bias": "it shifts every candidate's logit, which the softmax cancels"},
    "refine": {}}
# 4k: a gradient tensor's error, card against CPU, over its largest |CPU value|
# floored at 1e-3 of the model's largest (a structurally zero gradient is
# rounding noise on both); loss terms over their |CPU value|
FINE_GRAD_TOL, FINE_TERM_TOL, GRAD_FLOOR = 1e-3, 1e-4, 1e-3
# 4k: card runs of one step that must give the same gradients bit for bit
REPEATS = 3


def fine_config(stage: str) -> str:
    return str(Path(__file__).resolve().parent / "configs" / f"{stage}_geom.yaml")


def step_split(state, loss_fn, batch, inner: str) -> dict:
    """One training step with a synchronise between its parts: wall ms of
    the forward, of the model's ``inner`` method within it (the depth
    passes, or the refine flow), of the backward and of the update."""
    model = state.model
    spent = [0.0]
    method = getattr(model, inner)

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = method(*args, **kwargs)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t
        return out

    setattr(model, inner, timed)        # an instance attribute shadows the method
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = loss_fn(model, batch, None)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        state.apply_gradients()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    finally:
        delattr(model, inner)
    return {"forward_ms": (t1 - t0) * 1e3, f"forward_{inner}_ms": spent[0] * 1e3,
            "backward_ms": (t2 - t1) * 1e3, "update_ms": (t3 - t2) * 1e3}


def profile_fine_steps(train_cli, stage: str, trainer, device) -> list:
    """One training step per bucket of the GEOM pool, after training: wall
    ms (median of three), device ms of a profiled step and the device's
    busy share of the wall (torch.profiler), the kernels the step ran, and
    the step's split (``step_split``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hierdiff_torch.config import load_config
    from hierdiff_torch.data.collate import bucket_for
    from hierdiff_torch.parallel.train_step import train_step
    from hierdiff_torch.train.data_iters import load_tree_pool, to_device

    cfg = load_config(fine_config(stage), ["train.num_train_trees=512", f"train.seed={SEED}"])
    _, loss_fn, make_iter, _ = train_cli.BUILDERS[stage]
    pool = load_tree_pool(cfg, seed=SEED)
    present = {bucket_for(t.feats.shape[0], cfg.train.buckets) for t in pool}
    it = make_iter(cfg, pool, seed=SEED + 2)
    by_bucket = {}
    for _ in range(400):
        batch = next(it)
        by_bucket.setdefault(batch["feats"].shape[1], batch)
        if set(by_bucket) == present:
            break
    inner = "depth_mp" if stage == "denoise" else "message"
    rows = []
    for nb, batch in sorted(by_bucket.items()):
        batch = to_device(batch, device)
        train_step(trainer.state, loss_fn, batch, None)   # first use of this shape
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(trainer.state, loss_fn, batch, None)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall_ms = float(np.median(walls))
        # the card's activity alone: the host's op events, several a kernel,
        # made most of this phase's wall at 20k-44k kernels a step
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            train_step(trainer.state, loss_fn, batch, None)
            torch.cuda.synchronize()
        averages = prof.key_averages()
        kernels = sum(e.count for e in averages
                      if e.device_type == DeviceType.CUDA and not e.key.startswith("Memcpy")
                      and not e.key.startswith("Memset"))
        row = {"bucket": nb, "batch": int(batch["feats"].shape[0]), "wall_ms": wall_ms,
               "device_ms": device_ms_of(averages), "kernels": kernels,
               **step_split(trainer.state, loss_fn, batch, inner)}
        row["device_share"] = row["device_ms"] / wall_ms
        rows.append(row)
        print(f"{stage} training step, bucket {nb}, batch {row['batch']}: wall {wall_ms:.1f} ms "
              f"(median of 3), "
              f"device {row['device_ms']:.1f} ms (torch.profiler; {row['device_share']:.3f} of "
              f"the wall), {kernels} kernels; synchronised split: forward "
              f"{row['forward_ms']:.1f} ms ({inner} {row[f'forward_{inner}_ms']:.1f}), backward "
              f"{row['backward_ms']:.1f}, update {row['update_ms']:.1f}")
    return rows


def fine_train_phase(train_cli, ek, stage: str, workdir: Path, device) -> dict:
    """Phase 4i (denoise) / 4j (refine): ``train.cli <stage>`` at its GEOM
    configuration from ``--init-seed 0``, a synthetic pool of 512 trees, 20
    steps, two evaluations on the EMA weights: every logged loss, term,
    accuracy and grad_norm finite, every parameter moved but the named
    structurally-zero ones, no kernel of the coarse stage launched, and for
    denoise every batch from the native packer. Then one step per bucket
    profiled."""
    from hierdiff_torch.config import load_config
    from hierdiff_torch.utils.weights import init_weights

    steps, evals = 20, 2
    t_phase = time.perf_counter()
    ek.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    run = train_cli.main([stage, "--config", fine_config(stage), "--init-seed", "0",
                          f"train.workdir={workdir}", "train.num_train_trees=512",
                          f"train.max_steps={steps}", "train.log_every=1",
                          f"train.eval_every={steps // evals}", "train.checkpoint_every=1000",
                          f"train.seed={SEED}"])
    torch.cuda.synchronize()
    launches = dict(ek.launch_counts)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    with open(workdir / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    train_rows = [r for r in rows if r["split"] == "train"]
    logged = [k for k in train_rows[0] if k not in ("step", "split")]
    values = {k: [float(r[k]) for r in train_rows] for k in logged}
    trainer = run["trainer"]
    cfg = load_config(fine_config(stage))
    start = init_weights(train_cli.BUILDERS[stage][0](cfg, device),
                         torch.Generator().manual_seed(0)).state_dict()
    unchanged = sorted(k for k, v in trainer.state.model.state_dict().items()
                       if torch.equal(v, start[k]))
    ends = {k: (v[0], v[-1]) for k, v in values.items() if "loss" in k or "accuracy" in k}
    out = {"steps": run["steps"], "seconds": run["seconds"],
           "steps_per_sec": run["steps_per_sec"], "trees_per_sec": run["trees_per_sec"],
           "batch": cfg.train.batch_size, "first_last": ends, "grad_norm": values["grad_norm"],
           "peak_gib": peak_gib, "launches": launches, "unchanged": unchanged,
           "packers": run["packers"]}
    print(f"{stage} training: train CLI {Path(fine_config(stage)).name}, batch "
          f"{cfg.train.batch_size}, {steps} steps: {run['seconds']:.3f} s wall, "
          f"{run['steps_per_sec']:.4f} steps/s and {run['trees_per_sec']:.3f} trees/s after the "
          f"first step; first and last {ends}; grad_norm {min(values['grad_norm']):.4g} .. "
          f"{max(values['grad_norm']):.4g}; peak {peak_gib:.2f} GiB; launches {launches}; "
          f"unchanged parameters {unchanged}; packers {run['packers']}")
    if len(train_rows) != steps or not all(math.isfinite(v) for vs in values.values() for v in vs):
        fail(f"{stage} training logged a non-finite value or missed a step")
    if any(launches.values()):
        fail(f"{stage} training launched a coarse-stage kernel: {launches}")
    untrained = sorted(set(unchanged) - set(FINE_ZERO_GRAD[stage]))
    if untrained:
        fail(f"{stage} parameters not trained: {untrained}")
    if stage == "denoise" and not (run["packers"].get("native", 0) > 0
                                   and set(run["packers"]) == {"native"}):
        fail(f"denoise batches were not all packed natively: {run['packers']}")
    out["by_bucket"] = profile_fine_steps(train_cli, stage, trainer, device)
    if stage == "denoise":
        out["packer_ms"] = packer_ms(cfg)
    out["phase_seconds"] = time.perf_counter() - t_phase
    return out


def packer_ms(cfg, batches: int = 20) -> dict:
    """Host ms per denoise batch of the GEOM pool (batch 32, the bucket
    drawn as training draws it), native packer against the Python
    collator, on the same trees."""
    import random

    from hierdiff_torch.data.denoise import make_denoise_batch
    from hierdiff_torch.train.data_iters import (_group_by_bucket, _sample_bucket_batch,
                                                 load_tree_pool)

    cfg.train.num_train_trees, cfg.train.seed = 512, SEED
    groups = _group_by_bucket(load_tree_pool(cfg, seed=SEED), cfg.train.buckets)
    rng = random.Random(SEED)
    draws = [_sample_bucket_batch(groups, rng, cfg.train.batch_size) for _ in range(batches)]
    out = {}
    for kind, native in (("native", True), ("python", False)):
        t0 = time.perf_counter()
        for bkt, trees in draws:
            make_denoise_batch(trees, rng, max_n=bkt, allow_native=native)
        out[kind] = (time.perf_counter() - t0) * 1e3 / batches
    print(f"denoise packer, batch {cfg.train.batch_size} of the GEOM pool: native "
          f"{out['native']:.3f} ms, Python {out['python']:.3f} ms per batch (host)")
    return out


def fine_grad_check(train_cli, stage: str, device) -> dict:
    """Phase 4k: one step's gradient of a GEOM-width model (seed-0 weights,
    8 trees of bucket 24), card against CPU, TF32 off: every parameter's
    gradient within FINE_GRAD_TOL of its (floored) largest |CPU value|, the
    loss terms within FINE_TERM_TOL; the CPU's f32 against its f64 printed
    beside them as the rounding scale; REPEATS card runs must repeat bit
    for bit. Beside it, the ops that deterministic-algorithms mode names in one
    run, and the same with autograd's own backward of the parent gathers
    (the suspect of unrepeatable refine gradients), with whether that
    repeats."""
    import random

    from hierdiff_torch.config import load_config
    from hierdiff_torch.data.collate import bucket_for
    from hierdiff_torch.data.denoise import make_denoise_batch
    from hierdiff_torch.data.refine import make_refine_batch
    from hierdiff_torch.data.synthetic import SyntheticTreeGenerator
    from hierdiff_torch.parallel.train_step import reduce_metrics
    from hierdiff_torch.utils.weights import init_weights

    cfg = load_config(fine_config(stage))
    build, loss_fn, _, _ = train_cli.BUILDERS[stage]
    model = init_weights(build(cfg, device), torch.Generator().manual_seed(0)).train()
    trees = [t for t in SyntheticTreeGenerator(seed=SEED).sample_trees(256)
             if bucket_for(t.feats.shape[0]) == 24][:8]
    make = make_denoise_batch if stage == "denoise" else make_refine_batch
    batch = make(trees, random.Random(SEED), max_n=24)

    def run(m, dev, dtype=torch.float32):
        m.zero_grad(set_to_none=True)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        b = {k: v.to(dtype) if v.is_floating_point() else v for k, v in b.items()}
        loss, metrics = loss_fn(m, b, None)
        loss.backward()
        terms = {"loss": loss.item(), **{k: v.item() for k, v in reduce_metrics(metrics).items()}}
        grads = {k: (p.grad.detach().double().cpu() if p.grad is not None
                     else torch.zeros(p.shape, dtype=torch.float64))
                 for k, p in m.named_parameters()}
        return terms, grads

    def warned_ops(m) -> dict:
        """The warnings of one card run under deterministic-algorithms mode
        (warn only): each names an op with no deterministic CUDA path. A
        ``torch.histc`` on the card (none) is the control that the warnings
        are caught at all."""
        import warnings

        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                run(m, device)
                torch.histc(torch.ones(4, device=device))
        finally:
            torch.use_deterministic_algorithms(False)
        msgs = sorted({str(w.message).split("\n")[0][:160] for w in caught})
        return {"ops": [w for w in msgs if "histc" not in w],
                "control_caught": any("histc" in w for w in msgs)}

    def differing(runs_) -> list:
        """The tensors whose gradient is not bitwise the same in every run."""
        return sorted(k for k in runs_[0] if any(not torch.equal(runs_[0][k], r[k])
                                                 for r in runs_[1:]))

    # the culprit: the same step with autograd's own backward of the parent
    # gathers (torch.gather's, a scatter_add) in place of the fixed-order one
    from hierdiff_torch.ops import gcl

    fixed_gather = gcl.parent_gather
    gcl.parent_gather = lambda t, parent: torch.gather(
        t, 1, parent[..., None].expand(-1, -1, t.shape[-1]))
    try:
        plain_ops = warned_ops(model)
        plain = [run(model, device)[1] for _ in range(REPEATS)]
    finally:
        gcl.parent_gather = fixed_gather
    ops = warned_ops(model)
    card_terms, card = run(model, device)
    again = [card] + [run(model, device)[1] for _ in range(REPEATS - 1)]
    cpu_model = copy.deepcopy(model).cpu()
    cpu_terms, cpu = run(cpu_model, torch.device("cpu"))
    f64_terms, f64 = run(copy.deepcopy(cpu_model).double(), torch.device("cpu"), torch.float64)

    def errors(got, ref):
        top = max(float(v.abs().max()) for v in ref.values())
        return {k: float((got[k] - ref[k]).abs().max()) / max(float(ref[k].abs().max()),
                                                               GRAD_FLOOR * top) for k in ref}

    card_err, rounding = errors(card, cpu), errors(cpu, f64)
    terms = [k for k in cpu_terms if "accuracy" not in k]
    term_err = {k: abs(card_terms[k] - cpu_terms[k]) / (abs(cpu_terms[k]) + 1e-30) for k in terms}
    term_rounding = {k: abs(cpu_terms[k] - f64_terms[k]) / (abs(f64_terms[k]) + 1e-30)
                     for k in terms}
    worst = max(card_err, key=card_err.get)
    worst_r = max(rounding, key=rounding.get)
    out = {"batch": 8, "bucket": 24, "worst_tensor": worst, "worst_err": card_err[worst],
           "worst_rounding_tensor": worst_r, "worst_rounding": rounding[worst_r],
           "rounding_of_worst": rounding[worst], "term_err": term_err,
           "term_rounding": term_rounding,
           "accuracies": {k: (card_terms[k], cpu_terms[k]) for k in cpu_terms if "accuracy" in k},
           "repeats": REPEATS, "card_repeats_bitwise": not differing(again),
           "tensors_differing": differing(again)[:8], "deterministic_mode": ops,
           "with_plain_gather": {"deterministic_mode": plain_ops,
                                 "repeats_bitwise": not differing(plain),
                                 "tensors_differing": differing(plain)[:8]}}
    out["ok"] = (card_err[worst] < FINE_GRAD_TOL and max(term_err.values()) < FINE_TERM_TOL
                 and out["card_repeats_bitwise"])
    print(f"{stage} step gradients, card against CPU (GEOM width, 8 trees of bucket 24, f32, TF32 "
          f"off): worst tensor {worst} {card_err[worst]:.3e} of its largest |value| (bar "
          f"{FINE_GRAD_TOL}; the CPU's f32 against f64 there {rounding[worst]:.3e}, worst "
          f"{worst_r} {rounding[worst_r]:.3e}); loss terms {json.dumps(term_err)} (bar "
          f"{FINE_TERM_TOL}; f32 against f64 {json.dumps(term_rounding)}); accuracies card/CPU "
          f"{out['accuracies']}; {REPEATS} card runs bitwise equal: "
          f"{out['card_repeats_bitwise']} (differing {out['tensors_differing']}; under "
          f"deterministic-algorithms mode {json.dumps(ops)}); with torch.gather's own backward "
          f"of the parent gathers: {json.dumps(out['with_plain_gather'])}")
    return out


def planted_phase(device, steps: int = 250) -> dict:
    """Phase 4l: the planted-signal learning check on the card
    (tests/test_planted_learning.py's): hidden 64, one layer of each kind,
    planted_k=16, 16 trees of 6 nodes padded to 8 per batch, 250 steps of
    AdamW at 2e-3 (optax's defaults, weight decay 1e-4; no clipping, no
    EMA). The last step's node accuracy and refine accuracy must each
    exceed 0.6."""
    import random

    from hierdiff_torch.config import OptimConfig
    from hierdiff_torch.data.denoise import make_denoise_batch
    from hierdiff_torch.data.refine import make_refine_batch
    from hierdiff_torch.data.synthetic import SyntheticTreeGenerator
    from hierdiff_torch.models.edge_denoise import EdgeDenoise
    from hierdiff_torch.models.refine import NodeRefine
    from hierdiff_torch.parallel.train_step import TrainState, train_step
    from hierdiff_torch.train.cli import denoise_loss, refine_loss
    from hierdiff_torch.train.data_iters import to_device
    from hierdiff_torch.utils.weights import init_weights

    optim = OptimConfig(lr=2e-3, weight_decay=1e-4, grad_clip=None, ema_decay=0.0)
    out = {}
    for name, model, make, loss_fn, key in (
            ("denoise", EdgeDenoise(hidden_nf=64, n_layers_full=1, n_layers_focal=1),
             make_denoise_batch, denoise_loss, "node_accuracy"),
            ("refine", NodeRefine(hidden_size=64, n_layers=1), make_refine_batch, refine_loss,
             "accuracy")):
        gen = SyntheticTreeGenerator(seed=0, planted=True, planted_k=16)
        rng = random.Random(0)
        batches = [make(gen.sample_trees(16, n=6), rng, max_n=8) for _ in range(steps)]
        state = TrainState(init_weights(model, torch.Generator().manual_seed(0)).to(device),
                           optim)
        t0 = time.perf_counter()
        accs = [train_step(state, loss_fn, to_device(b, device), None)[key] for b in batches]
        accs = [float(a) for a in accs]
        out[name] = {key: accs[-1], "every_25": accs[::25], "seconds": time.perf_counter() - t0}
        print(f"planted signal, {name}: {key} {accs[-1]:.4f} after {steps} steps (bar 0.6; "
              f"every 25th step {[round(a, 3) for a in accs[::25]]}), "
              f"{out[name]['seconds']:.2f} s")
        if not accs[-1] > 0.6:
            fail(f"the {name} head did not learn the planted signal: {key} {accs[-1]:.4f}")
    return out


def trained_assemble_phase(cli, coarse_pkl: bytes, ema: dict) -> dict:
    """Phase 4m: the ema.pt files of 4i and 4j through ``sampling.cli
    assemble --denoise-weights --refine-weights`` (strict loads) on phase
    4's point sets: a spanning tree per molecule."""
    with tempfile.TemporaryDirectory() as tmp:
        src, out = Path(tmp) / "coarse.pkl", Path(tmp) / "trees.pkl"
        src.write_bytes(coarse_pkl)
        run = cli.main(["assemble", "--coarse-pkl", str(src), "--denoise-weights",
                        str(ema["denoise"]), "--refine-weights", str(ema["refine"]),
                        "--out", str(out)])
        with open(out, "rb") as f:
            trees = pickle.load(f)["trees"]
    sizes = [b["h"].shape[0] for b in run["blur"]]
    faults = spanning_tree_faults(trees, sizes)
    seconds = run["lattice_s"] + run["search_s"]
    print(f"assemble from the trained ema.pt files: {len(sizes)} molecules, lattices "
          f"{run['lattice_s']:.3f} s, search {run['search_s']:.3f} s, "
          f"{len(sizes) / seconds:.3f} trees/s; faults {faults}")
    if faults:
        fail(f"assemble from the trained weights gave trees that are missing or invalid: {faults}")
    return {"molecules": len(sizes), "lattice_s": run["lattice_s"],
            "search_s": run["search_s"], "trees_per_s": len(sizes) / seconds}


# ---- 4n-4q: the assembly gate, reconstruction and evaluation under the harness

# The fake-RDKit harness sanitizes in pure Python (milliseconds a candidate
# on a GEOM-width random tree, whose random types include large rings), and
# the reference's gate enumerates attachments exponentially in a node's
# degree: one verdict can take minutes. So under the harness the smoke lets
# one verdict sanitize at most VERDICT_CAP candidates (``harness_cap``); a
# verdict that reaches the cap is refused and counted, a stand-in's refusal,
# not chemistry's. The port's gate has no such bound. A verdict under the cap
# is the reference's whenever it is positive, so every node of every
# returned tree is re-checked with an uncapped gate, which must accept it.
VERDICT_CAP = 50
GATED_MAX_NODES = 8                   # 4n: phase 4's point sets of at most 8 nodes
# 4q: phase 4's REFINE_SETS smallest point sets of at least 12 nodes: a fused
# check needs more than 10 typed nodes at check_frac 0.1, and a tree not yet
# finished. Its denoise weights come from seed 1, not 0: seed 0's random
# model types most nodes as rings of up to 16 atoms, and on these sets its
# gated search ends before any tree holds 11 typed nodes; seed 1's types
# are mostly single atoms, so the search reaches the hook's checks (PERF.md)
REFINE_MIN_NODES, REFINE_SETS, REFINE_DENOISE_SEED = 12, 6, 1
GEN_MAX_NODES, GEN_NUM = 3, 16        # 4o
STREAM_CHUNK = 8                      # 4o: run_streamed's macro-chunk
PHASE_CAP_S = 240.0                   # the wall of one run of 4n, 4o or 4q
HARNESS = "fake-RDKit harness"
# the keys of the JAX package's panel (hierdiff_tpu/eval/cli.py evaluate, with --ref)
PANEL_KEYS = {"n_molecules", "filter_pass_rate", "mw_mean", "logp_mean", "rot_bonds_mean",
              "scaffold_entropy", "sas_mean", "qed_mean", "ro5_mean", "hetero_ratio_mean",
              "ring_size_mean", "ring_count_mean", "max_fp_similarity_mean"}


def install_harness():
    """``tests/fake_rdkit.py`` (numpy only) as the ``rdkit`` modules: the
    stand-in chemistry of these phases, not chemistry."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import fake_rdkit

    fake_rdkit.install()
    return fake_rdkit


class HarnessLines:
    """A stdout that marks every line printed under the harness (the CLIs'
    own lines included) as the harness's, as it passes it on."""

    def __init__(self, out):
        self.out, self.pending = out, ""

    def write(self, text: str) -> int:
        self.pending += text
        while "\n" in self.pending:
            line, self.pending = self.pending.split("\n", 1)
            self.out.write(f"{line}\n" if HARNESS in line else f"[{HARNESS}] {line}\n")
        return len(text)

    def flush(self) -> None:
        if self.pending:
            self.write("\n")
        self.out.flush()


class CapReached(Exception):
    """One verdict sanitized VERDICT_CAP candidates."""


@contextlib.contextmanager
def harness_cap(refused: list):
    """While open, a ``can_assemble`` verdict that sanitizes more than
    VERDICT_CAP candidates is refused and its (fragment, neighbours) query
    appended to ``refused``. Gates built while it is open bind the capped
    verdict; other chemistry (reconstruction) is not bounded."""
    from hierdiff_torch.chem import chemutils

    real_can, real_sanitize = chemutils.can_assemble, chemutils.sanitize
    count = [None]    # candidates of the open verdict; None outside a verdict

    def sanitize(mol):
        if count[0] is not None:
            count[0] += 1
            if count[0] > VERDICT_CAP:
                raise CapReached()
        return real_sanitize(mol)

    def can_assemble(node, node_y=None):
        count[0] = 0
        try:
            return real_can(node, node_y)
        except CapReached:
            refused.append((node.smiles, tuple(n.smiles for n in node.neighbors)))
            return False
        finally:
            count[0] = None

    chemutils.can_assemble, chemutils.sanitize = can_assemble, sanitize
    try:
        yield
    finally:
        chemutils.can_assemble, chemutils.sanitize = real_can, real_sanitize


class OverCap(BaseException):
    """A run reached its wall cap. A BaseException, so that no ``except
    Exception`` on the way (the harness's sanitization has one) takes it."""


@contextlib.contextmanager
def wall_cap(seconds: float, what: str):
    """Fail the smoke if the block runs longer than ``seconds`` of wall."""
    def alarm(signum, frame):
        raise OverCap()

    old = signal.signal(signal.SIGALRM, alarm)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    except OverCap:
        fail(f"{what} ({HARNESS}) ran over its {seconds:.0f} s cap")
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def canonical(molecules) -> list:
    from rdkit import Chem

    return [Chem.MolToSmiles(m[2]) for m in molecules]


def type_atoms(lattices, beam: int = 5) -> float:
    """Mean heavy atoms of the fragments a lattice offers the search (its
    top ``beam`` types at every step)."""
    from hierdiff_torch.data.assets import vocab_mol_sizes

    wids = np.concatenate([lat.top_wid[:, :beam].ravel() for lat in lattices.values()])
    return float(np.asarray(vocab_mol_sizes())[wids].mean())


def nodes_refused(trees) -> list:
    """(tree, node) pairs of the returned trees that an uncapped gate, the
    reference's verdicts, refuses."""
    from hierdiff_torch.chem.assemble_gate import make_assembly_gate
    from hierdiff_torch.chem.mol_tree import Vocab

    gate = make_assembly_gate(Vocab())
    return [(i, j) for i, t in enumerate(trees) if t is not None
            for j in range(t.n) if not gate(t, j)]


def gated_assemble_phase(cli, coarse_pkl: bytes, ungated_rate: float) -> dict:
    """Phase 4n: ``sampling.cli assemble`` with the assembly gate (refine
    off) on phase 4's point sets of at most GATED_MAX_NODES nodes, and the
    same without the gate beside it. Every returned tree a spanning tree
    whose every node passes the uncapped gate; the gate fired."""
    from hierdiff_torch.chem import has_rdkit

    blur = [b for b in cli._flatten_blur_pkl(pickle.loads(coarse_pkl))
            if b["h"].shape[0] <= GATED_MAX_NODES]
    runs, refused = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "coarse.pkl"
        with open(src, "wb") as f:
            pickle.dump([blur], f)
        for gated in (False, True):
            if gated != has_rdkit():
                fail(f"4n: the harness is {'missing' if gated else 'installed'}")
            out = Path(tmp) / f"trees_{gated}.pkl"
            with harness_cap(refused), wall_cap(PHASE_CAP_S, "4n"):
                run = cli.main(["assemble", "--coarse-pkl", str(src), "--denoise-init-seed",
                                "0", "--out", str(out)])
            with open(out, "rb") as f:
                run["pickled"] = pickle.load(f)["trees"]
            runs[gated] = run
            if not gated:
                install_harness()
    run = runs[True]
    # the Python gated search second on the same lattices: its verdicts come
    # from the cache the native search filled, and its trees must be the
    # native ones bit for bit
    from hierdiff_torch.sampling.lattice import LatticeSampler

    sampler = run["sampler"]
    info = run["gate"].cache_info()      # the native search's queries
    py = LatticeSampler(sampler.model, beam_size=sampler.beam_size, buckets=sampler.buckets,
                        can_assemble=run["gate"], native_search=False)
    with wall_cap(PHASE_CAP_S, "4n, the Python search"):
        t0 = time.perf_counter()
        py_trees = py._search(run["blur"], run["lattices"])
        py_search_s = time.perf_counter() - t0
    py_check = {"python_search_s": py_search_s, "bitwise": same_trees(py_trees, run["trees"]),
                "new_misses": run["gate"].cache_info().misses - info.misses}
    sizes = [b["h"].shape[0] for b in blur]
    kept = [(d, n) for d, n in zip(run["pickled"], sizes) if d is not None]
    faults = spanning_tree_faults([d for d, _ in kept], [n for _, n in kept])
    refused_nodes = nodes_refused(run["trees"])
    rate = {g: len(blur) / (r["lattice_s"] + r["search_s"]) for g, r in runs.items()}
    atoms = type_atoms(run["lattices"])
    out = {"molecules": len(blur), "max_nodes": GATED_MAX_NODES, "verdict_cap": VERDICT_CAP,
           "type_atoms": atoms,
           "trees": len(kept), "trees_ungated": sum(t is not None for t in runs[False]["trees"]),
           "trees_per_s": rate[True], "trees_per_s_ungated": rate[False],
           "trees_per_s_4e": ungated_rate, "lattice_s": run["lattice_s"],
           "search_s": run["search_s"], "search_s_ungated": runs[False]["search_s"],
           "gate_hits": info.hits, "gate_misses": info.misses,
           "gate_hit_rate": info.hits / max(info.hits + info.misses, 1),
           "refused_at_cap": len(refused), "faults": faults,
           "nodes_refused": refused_nodes[:5], "python_search": py_check}
    print(f"gated assemble ({HARNESS}): the Python search second on the same lattices: "
          f"{json.dumps(py_check)}")
    print(f"gated assemble ({HARNESS}): GEOM denoise, phase 4's {len(blur)} point sets of at "
          f"most {GATED_MAX_NODES} nodes (the lattice's top types {atoms:.2f} heavy atoms on "
          f"average): {len(kept)}/{len(blur)} trees, {rate[True]:.3f} trees/s (search "
          f"{run['search_s']:.3f} s) against {rate[False]:.3f} trees/s ungated "
          f"on the same sets (search {runs[False]['search_s']:.3f} s) and {ungated_rate:.3f} "
          f"in 4e; gate {info.hits} hits, {info.misses} misses ({out['gate_hit_rate']:.3f} "
          f"hit rate), {len(refused)} refused at the harness's cap of {VERDICT_CAP} "
          f"candidates; faults {faults}; nodes the uncapped gate refuses {refused_nodes[:5]}")
    if faults or refused_nodes or info.misses == 0:
        fail(f"4n ({HARNESS}): gated trees invalid, a node refused, or the gate never fired")
    if not py_check["bitwise"]:
        fail(f"4n ({HARNESS}): the native gated search differs from the Python one: {py_check}")
    return out


def gated_refine_phase(cli, coarse_pkl: bytes) -> dict:
    """Phase 4q: ``sampling.cli assemble --denoise-init-seed
    REFINE_DENOISE_SEED --refine-init-seed 0`` with the assembly gate on
    phase 4's REFINE_SETS smallest point sets of at least REFINE_MIN_NODES
    nodes, through the native search. The hook's fused checks ran; the
    pipelined Python search second on the same lattices gives the same
    trees bit for bit, and in it a swap passed the gate and was committed
    (counted around its hook); every returned tree is a spanning tree whose
    every node passes the uncapped gate."""
    from hierdiff_torch.sampling import lattice as lat
    from hierdiff_torch.sampling.refine_hook import RefineHook

    blur = cli._flatten_blur_pkl(pickle.loads(coarse_pkl))
    order = sorted((i for i, b in enumerate(blur) if b["h"].shape[0] >= REFINE_MIN_NODES),
                   key=lambda i: (blur[i]["h"].shape[0], i))[:REFINE_SETS]
    blur = [blur[i] for i in order]
    refused = []
    with tempfile.TemporaryDirectory() as tmp:
        src, out = Path(tmp) / "coarse.pkl", Path(tmp) / "trees.pkl"
        with open(src, "wb") as f:
            pickle.dump([blur], f)
        with harness_cap(refused), wall_cap(PHASE_CAP_S, "4q"):
            run = cli.main(["assemble", "--coarse-pkl", str(src), "--denoise-init-seed",
                            str(REFINE_DENOISE_SEED), "--refine-init-seed", "0",
                            "--out", str(out)])
        with open(out, "rb") as f:
            pickled = pickle.load(f)["trees"]
    sampler, hook = run["sampler"], run["sampler"].refine_hook
    st = dict(hook.stats)
    info = run["gate"].cache_info()      # the native search's queries
    # the pipelined Python search second, on the same lattices and gates
    # (its verdicts from the cache), its swaps counted around its hook; its
    # trees, repaired by ``finalize``, must be the CLI's bit for bit
    swaps = [0]
    py_hook = RefineHook(hook.model, hook.vocab_sizes, can_assemble=hook.can_assemble,
                         buckets=hook.buckets)
    real_collect = py_hook.collect_batch

    def collect(token, states):
        res = real_collect(token, states)
        swaps[0] += sum(changed for _, _, changed in res)
        return res

    py_hook.collect_batch = collect
    py = lat.LatticeSampler(sampler.model, beam_size=sampler.beam_size, buckets=sampler.buckets,
                            can_assemble=sampler.can_assemble, refine_hook=py_hook,
                            native_search=False)
    with wall_cap(PHASE_CAP_S, "4q, the Python search"):
        t0 = time.perf_counter()
        py_trees = [py_hook.finalize(t) if t is not None else None
                    for t in py._search(run["blur"], run["lattices"])]
        py_search_s = time.perf_counter() - t0
    py_check = {"python_search_s": py_search_s, "bitwise": same_trees(py_trees, run["trees"]),
                "new_misses": run["gate"].cache_info().misses - info.misses}
    sizes = [b["h"].shape[0] for b in blur]
    kept = [(d, n) for d, n in zip(pickled, sizes) if d is not None]
    faults = spanning_tree_faults([d for d, _ in kept], [n for _, n in kept])
    refused_nodes = nodes_refused(run["trees"])
    seconds = run["lattice_s"] + run["search_s"]
    atoms = type_atoms(run["lattices"])
    out = {"molecules": len(blur), "point_sets": order, "nodes": sizes,
           "denoise_seed": REFINE_DENOISE_SEED, "type_atoms": atoms,
           "verdict_cap": VERDICT_CAP, "trees": len(kept), "trees_per_s": len(blur) / seconds,
           "lattice_s": run["lattice_s"], "search_s": run["search_s"],
           "fused_checks": st["score_calls"], "swaps_committed": swaps[0],
           "gate_hits": info.hits, "gate_misses": info.misses,
           "gate_hit_rate": info.hits / max(info.hits + info.misses, 1),
           "refused_at_cap": len(refused), "refine": st, "faults": faults,
           "nodes_refused": refused_nodes[:5], "python_search": py_check}
    print(f"gated assemble, refine on ({HARNESS}): GEOM denoise (seed "
          f"{REFINE_DENOISE_SEED}) and refine, phase 4's {len(blur)} smallest point sets of at "
          f"least {REFINE_MIN_NODES} nodes ({sizes} nodes; the lattice's top types {atoms:.2f} "
          f"heavy atoms on average): {len(kept)}/{len(blur)} trees, {out['trees_per_s']:.3f} "
          f"trees/s (lattices {run['lattice_s']:.3f} s, search {run['search_s']:.3f} s); "
          f"{st['score_calls']} "
          f"fused checks (dispatch {st['dispatch_s']:.3f} s, collect {st['collect_s']:.3f} s, "
          f"walk {st['walk_s']:.3f} s; native: {st['rounds']} group rounds, {st['lanes']} "
          f"lanes), {swaps[0]} swaps passed the gate and were committed (the Python search, "
          f"{json.dumps(py_check)}); "
          f"gate {info.hits} hits, {info.misses} misses ({out['gate_hit_rate']:.3f} hit rate), "
          f"{len(refused)} refused at the harness's cap; faults {faults}; nodes the uncapped "
          f"gate refuses {refused_nodes[:5]}")
    if st["score_calls"] == 0 or swaps[0] == 0:
        fail(f"4q ({HARNESS}): no gated fused check ran, or no swap passed the gate")
    if faults or refused_nodes:
        fail(f"4q ({HARNESS}): gated refine-on trees invalid, or a node refused")
    if not py_check["bitwise"]:
        fail(f"4q ({HARNESS}): the native gated refine-on search differs from the Python one")
    return out


def gated_generate_phase(cli, ek) -> dict:
    """Phase 4o: ``sampling.cli generate`` with the gate, refine on and
    reconstruction, GEN_NUM molecules of at most GEN_MAX_NODES fragments, 100
    coarse steps, with 0 and then 2 reconstruction workers: the coarse
    launches exact; every tree that was assembled reconstructed (its output
    counted as an attempt unless 'max9'); the same molecules and stats from
    both worker counts; molecules and stats in the pickle; every node of
    every tree passes the uncapped gate. Then ``generate --chunk-size
    STREAM_CHUNK --workers 2`` (``run_streamed``): trees, molecules, the
    panel's stats and ``t_device``, the coarse launches exact for each
    macro-chunk's plan."""
    from hierdiff_torch.chem import reconstruct as rec_mod

    steps, runs, refused = 100, {}, {0: [], 2: []}
    with tempfile.TemporaryDirectory() as tmp:
        for workers in (0, 2):
            out = Path(tmp) / f"generated_{workers}.pkl"
            seen = []
            summarize = rec_mod.summarize_outputs

            def spy(outputs):
                seen.append(list(outputs))
                return summarize(outputs)

            rec_mod.summarize_outputs = spy
            ek.reset_launch_counts()
            try:
                with harness_cap(refused[workers]), wall_cap(PHASE_CAP_S, "4o"):
                    run = cli.main(["generate", "--init-seed", "0", "--denoise-init-seed", "0",
                                    "--refine-init-seed", "0", "--num", str(GEN_NUM),
                                    "--sample-steps", str(steps), "--max-nodes",
                                    str(GEN_MAX_NODES), "--workers", str(workers),
                                    "--seed", str(SEED), "--out", str(out)])
            finally:
                rec_mod.summarize_outputs = summarize
            torch.cuda.synchronize()
            run["launches"] = dict(ek.launch_counts)
            run["outputs"] = seen[0]
            run["path"] = out
            with open(out, "rb") as f:
                run["payload"] = pickle.load(f)
            runs[workers] = run
        pkl = runs[0]["path"].read_bytes()
        # run_streamed: macro-chunks of STREAM_CHUNK, each reconstructed by
        # the pool while the next samples
        streamed_refused = []
        ek.reset_launch_counts()
        with harness_cap(streamed_refused), wall_cap(PHASE_CAP_S, "4o, run_streamed"):
            streamed = cli.main(["generate", "--init-seed", "0", "--denoise-init-seed", "0",
                                 "--refine-init-seed", "0", "--num", str(GEN_NUM),
                                 "--sample-steps", str(steps), "--max-nodes",
                                 str(GEN_MAX_NODES), "--workers", "2", "--chunk-size",
                                 str(STREAM_CHUNK), "--seed", str(SEED),
                                 "--out", str(Path(tmp) / "streamed.pkl")])
        torch.cuda.synchronize()
        streamed["launches"] = dict(ek.launch_counts)
    result, pipe = runs[0]["result"], runs[0]["pipeline"]
    sizes = [b["h"].shape[0] for b in result.blur]
    n_chunks = len(pipe._plan_chunks(np.asarray(sizes)))
    expect = {"fused_gcl": n_chunks * (steps + 1) * 12,
              "fused_coord_update": n_chunks * (steps + 1) * 6,
              "fused_gcl_bwd": 0, "coord_update_autograd": 0}
    done = [t for t in result.trees if t is not None]
    outputs = runs[0]["outputs"]
    max9 = sum(isinstance(o, str) and o == "max9" for o in outputs)
    attempted = len(outputs) - max9
    st = result.stats
    keys = ("valid", "unique", "avg_atoms")
    same = (canonical(runs[0]["result"].molecules) == canonical(runs[2]["result"].molecules)
            and {k: runs[0]["result"].stats[k] for k in keys}
            == {k: runs[2]["result"].stats[k] for k in keys})
    payload = runs[0]["payload"]
    sres = streamed["result"]
    s_sizes = [b["h"].shape[0] for b in sres.blur]
    s_chunks = sum(len(pipe._plan_chunks(np.asarray(s_sizes[c0: c0 + STREAM_CHUNK])))
                   for c0 in range(0, GEN_NUM, STREAM_CHUNK))
    s_expect = {"fused_gcl": s_chunks * (steps + 1) * 12,
                "fused_coord_update": s_chunks * (steps + 1) * 6,
                "fused_gcl_bwd": 0, "coord_update_autograd": 0}
    s_done = [t for t in sres.trees if t is not None]
    s_out = {"molecules": GEN_NUM, "chunk_size": STREAM_CHUNK, "workers": 2,
             "seconds": streamed["seconds"], "trees": len(s_done),
             "reconstructed": None if sres.molecules is None else len(sres.molecules),
             "stats": sres.stats, "coarse_chunks": s_chunks, "launches": streamed["launches"],
             "refused_at_cap": len(streamed_refused)}
    print(f"gated generate, run_streamed ({HARNESS}): {json.dumps(s_out)} (expected launches "
          f"{s_expect})")
    if (len(sres.trees) != GEN_NUM or not s_done or sres.molecules is None
            or not {"valid", "unique", "avg_atoms", "t_device"} <= set(sres.stats)):
        fail(f"4o ({HARNESS}): run_streamed lacks trees, molecules or the panel's stats: "
             f"{s_out}")
    if streamed["launches"] != s_expect:
        fail(f"4o ({HARNESS}): run_streamed launch counts {streamed['launches']} != {s_expect}")
    gate, hook = pipe.sampler.can_assemble, pipe.sampler.refine_hook
    info = gate.cache_info()
    refused_nodes = nodes_refused(result.trees)
    out = {"molecules": GEN_NUM, "max_nodes": GEN_MAX_NODES, "verdict_cap": VERDICT_CAP,
           "seconds": runs[0]["seconds"], "seconds_workers_2": runs[2]["seconds"],
           "trees": len(done), "reconstructed": len(result.molecules), "max9": max9,
           "attempted": attempted, **{k: st[k] for k in ("t_coarse", "t_fine", "t_reconstruct",
                                                          *keys)},
           "t_reconstruct_workers_2": runs[2]["result"].stats["t_reconstruct"],
           "reconstruct_share": st["t_reconstruct"] / runs[0]["seconds"],
           "gate_hits": info.hits, "gate_misses": info.misses,
           "gate_hit_rate": info.hits / max(info.hits + info.misses, 1),
           "refused_at_cap": len(refused[0]), "nodes_refused": refused_nodes[:5],
           "refine": dict(hook.stats),
           "coarse_chunks": n_chunks, "launches": runs[0]["launches"],
           "launches_workers_2": runs[2]["launches"], "same_across_workers": same}
    print(f"gated generate ({HARNESS}): {GEN_NUM} molecules of at most {GEN_MAX_NODES} "
          f"fragments, {steps} coarse steps, refine on: "
          f"{runs[0]['seconds']:.3f} s (workers 0; workers 2: {runs[2]['seconds']:.3f} s), "
          f"t_coarse {st['t_coarse']:.3f} s, t_fine {st['t_fine']:.3f} s, t_reconstruct "
          f"{st['t_reconstruct']:.3f} s ({out['reconstruct_share']:.3f} of the wall; workers 2: "
          f"{out['t_reconstruct_workers_2']:.3f} s); {len(done)} trees, {attempted} attempted, "
          f"{max9} max9, {len(result.molecules)} molecules; valid {st['valid']:.4f}, unique "
          f"{st['unique']:.4f}, avg_atoms {st['avg_atoms']:.4f}; gate {info.hits} hits, "
          f"{info.misses} misses ({out['gate_hit_rate']:.3f}), {len(refused[0])} refused at "
          f"the harness's cap; nodes the uncapped gate refuses {refused_nodes[:5]}; refine "
          f"{hook.stats['score_calls']} fused checks; launches "
          f"{runs[0]['launches']} (expected {expect}); workers 0 and 2 equal: {same}")
    if runs[0]["launches"] != expect or runs[2]["launches"] != expect:
        fail(f"4o ({HARNESS}): kernel launch counts {runs[0]['launches']}, "
             f"{runs[2]['launches']} != {expect}")
    if refused_nodes:
        fail(f"4o ({HARNESS}): the uncapped gate refuses nodes of the trees: {refused_nodes}")
    if len(outputs) != len(done) or not same:
        fail(f"4o ({HARNESS}): {len(outputs)} reconstructions of {len(done)} trees, or the "
             f"worker counts disagree")
    if attempted and abs(st["valid"] - len(result.molecules) / attempted) > 1e-12:
        fail(f"4o ({HARNESS}): valid {st['valid']} is not molecules / attempts")
    if (set(payload) != {"trees", "molecules", "stats"} or payload["molecules"] is None
            or not set(keys) <= set(payload["stats"])):
        fail(f"4o ({HARNESS}): the pickle lacks molecules or stats: {sorted(payload)}")
    out["run_streamed"] = s_out
    return {"stats": out, "pickle": pkl, "molecules": runs[0]["result"].molecules}


def reconstruct_eval_phase(cli, generated: dict) -> dict:
    """Phase 4p: ``sampling.cli reconstruct`` on 4o's pickle gives 4o's
    molecules and stats; ``eval.cli`` on them writes every key of the JAX
    panel; the six test molecules of ``tools/chem_check.py`` reconstruct to
    the SMILES the CPU tests pin against the JAX package."""
    from hierdiff_torch.eval import cli as eval_cli
    from hierdiff_torch.tools import chem_check

    keys = ("valid", "unique", "avg_atoms")
    with tempfile.TemporaryDirectory() as tmp:
        src, out, js = Path(tmp) / "gen.pkl", Path(tmp) / "rec.pkl", Path(tmp) / "m.json"
        src.write_bytes(generated["pickle"])
        with wall_cap(PHASE_CAP_S, "4p"):
            rec = cli.main(["reconstruct", "--trees-pkl", str(src), "--workers", "2",
                            "--out", str(out)])
        same = (canonical(rec["molecules"]) == canonical(generated["molecules"])
                and {k: rec["stats"][k] for k in keys}
                == {k: generated["stats"][k] for k in keys})
        metrics = None
        if rec["molecules"]:
            eval_cli.main([str(out), "--ref", str(out), "--out", str(js)])
            metrics = json.loads(js.read_text())
    t0 = time.perf_counter()
    smiles = chem_check.reconstructed_smiles()
    pinned = smiles == list(chem_check.RECONSTRUCTED_FAKE)
    res = {"reconstruct_seconds": rec["seconds"], "same_as_generate": same, "panel": metrics,
           "test_smiles": smiles, "test_smiles_pinned": pinned,
           "test_smiles_seconds": time.perf_counter() - t0}
    print(f"reconstruct and eval ({HARNESS}): reconstruct on 4o's pickle {rec['seconds']:.3f} s "
          f"(2 workers), {len(rec['molecules'])} molecules, same as generate: {same}; panel "
          f"{json.dumps(metrics)}; the six test molecules reconstruct to the pinned SMILES: "
          f"{pinned} ({res['test_smiles_seconds']:.3f} s)")
    if not same or not pinned:
        fail(f"4p ({HARNESS}): reconstruct differs from generate, or the test molecules do not "
             f"reconstruct to the pinned SMILES: {smiles}")
    if metrics is None or set(metrics) != PANEL_KEYS:
        fail(f"4p ({HARNESS}): no molecules to evaluate, or the panel's keys "
             f"{None if metrics is None else sorted(metrics)} are not the JAX panel's")
    return res


AR_MOLECULES, AR_BUCKET = 16, 16       # 4r: phase 4's first 16 point sets of bucket 16


def ar_phase(cli, ek, coarse_pkl: bytes, device) -> dict:
    """Phase 4r: ``sampling.cli assemble --denoise-init-seed 0
    denoise.vocab_conditioning=true`` (the round-based ``ARSampler``: one
    ``ar_step`` per search round) at GEOM width, beam 5, on phase 4's first
    AR_MOLECULES point sets of bucket AR_BUCKET: a spanning tree per
    molecule; every round's fleet packed by the native packer equal bit for
    bit to the Python packer's; the first two rounds' expansions, card
    against CPU, under ``tools/lattice_check.py``'s margin rule (top_logp
    within 1e-3 of the step's largest |top_logp|); two card runs bitwise
    equal; no coarse kernel launched."""
    from hierdiff_torch.config import EdgeDenoiseConfig
    from hierdiff_torch.data.collate import SAMPLING_BUCKETS, bucket_for
    from hierdiff_torch.sampling import ar
    from hierdiff_torch.tools.lattice_check import compare_lattices
    from hierdiff_torch.utils.weights import init_weights

    blur = [b for b in cli._flatten_blur_pkl(pickle.loads(coarse_pkl))
            if bucket_for(b["h"].shape[0], SAMPLING_BUCKETS) == AR_BUCKET][:AR_MOLECULES]
    packs = {"calls": 0, "bitwise": True}
    fleets = []
    real_native = ar.pack_fleet_native

    def spy(states, nb, bp):
        out = real_native(states, nb, bp)
        py = ar.pack_fleet_python(states, nb, bp)
        packs["calls"] += 1
        packs["bitwise"] &= all(a.dtype == b.dtype and np.array_equal(a, b)
                                for a, b in zip(out, py))
        if len(fleets) < 2:
            fleets.append((len(states), tuple(a.copy() for a in out)))
        return out

    runs = []
    ar.pack_fleet_native = spy
    try:
        with tempfile.TemporaryDirectory() as tmp:
            src = Path(tmp) / "coarse.pkl"
            with open(src, "wb") as f:
                pickle.dump([blur], f)
            for k in range(2):
                out = Path(tmp) / f"trees_{k}.pkl"
                ek.reset_launch_counts()
                run = cli.main(["assemble", "--coarse-pkl", str(src), "--denoise-init-seed", "0",
                                "--out", str(out), "denoise.vocab_conditioning=true"])
                torch.cuda.synchronize()
                run["launches"] = dict(ek.launch_counts)
                with open(out, "rb") as f:
                    run["pickled"] = pickle.load(f)["trees"]
                runs.append(run)
    finally:
        ar.pack_fleet_native = real_native
    run = runs[0]
    sampler = run["sampler"]
    if not isinstance(sampler, ar.ARSampler):
        fail(f"4r: vocab_conditioning built {type(sampler).__name__}, not the ARSampler")
    sizes = [b["h"].shape[0] for b in blur]
    faults = spanning_tree_faults(run["pickled"], sizes)
    steps = sampler.expander.stats["steps"]
    seconds = run["search_s"]

    card_model = sampler.expander.model
    cpu_model = init_weights(cli.build_denoise_from_cfg(
        EdgeDenoiseConfig(vocab_conditioning=True), "cpu"),
        torch.Generator().manual_seed(0)).clone(dynamic_depth=True)
    checks = []
    for b, arrays in fleets:
        feats, pos, adj, vocab, disc, nmask = arrays
        args = (feats, disc, vocab.astype(np.int64), pos, adj, nmask)
        card = card_model.ar_step(*(torch.from_numpy(a).to(device) for a in args))
        cpu = cpu_model.ar_step(*(torch.from_numpy(a) for a in args))
        one = lambda out: {k: v.cpu().numpy()[:b, None] for k, v in out.items()}  # noqa: E731
        report = compare_lattices(one(cpu), one(card), [1] * b, margin=1e-4, logp_tol=1e-3,
                                  relative=True)
        checks.append({"rows": b, "cut": report["cut"], "failures": report["failures"][:5],
                       "max_logp_rel_err": report["max_logp_rel_err"], "ok": report["ok"]})
    res = {"molecules": len(blur), "bucket": AR_BUCKET, "beam": 5, "steps": steps,
           "pack_calls": packs["calls"], "packers_bitwise": packs["bitwise"],
           "seconds": seconds, "trees_per_s": len(blur) / seconds,
           "seconds_second_run": runs[1]["search_s"],
           "bitwise_second_run": same_trees(run["trees"], runs[1]["trees"]),
           "launches": run["launches"], "faults": faults, "card_against_cpu": checks}
    print(f"assemble, ARSampler (vocab_conditioning): GEOM denoise H="
          f"{card_model.hidden_nf}, {len(blur)} molecules of bucket {AR_BUCKET}, beam 5: "
          f"{steps} model steps in {seconds:.3f} s ({res['trees_per_s']:.3f} trees/s; second "
          f"run {runs[1]['search_s']:.3f} s); {json.dumps(res)}")
    if faults:
        fail(f"4r: ARSampler trees missing or invalid: {faults}")
    if not (packs["bitwise"] and packs["calls"] > 0):
        fail("4r: the native fleet packer differs from the Python packer")
    if not all(c["ok"] for c in checks) or len(checks) < 2:
        fail(f"4r: the card's expansion disagrees with the CPU's: {checks}")
    if not res["bitwise_second_run"]:
        fail("4r: two card runs of the ARSampler differ")
    if any(run["launches"].values()):
        fail(f"4r: the round-based sampler launched a coarse kernel: {run['launches']}")
    return res


# ---- 4u-4w: --fine-bf16, the per-node vocab restriction, remat / remat_edges

# 4u: a bf16 lattice's focal or attach choice may differ from the
# reference's only where the reference's best two candidates (focal
# probabilities, attach logits) are closer than this share of the step's
# largest |candidate score|: untrained GEOM-width weights give attach logits
# of ~1e3, where bf16's ~1% rounding moves a margin by tens. top_logp is
# printed, not gated: the rule holds the choices and the top-1 types
BF16_MARGIN = 5e-2
BF16_TOP1 = 0.8                       # tests/test_fine_stage.py:553
BF16_CPU_SETS = 4                     # card against CPU, bf16: sets of the fullest bucket
LATTICE_TIMED_BUCKETS = (16, 32)
GENERATE_BF16 = 16
REMAT_SETTINGS = {"off": (False, False), "remat_edges": (False, True), "remat": (True, False),
                  "both": (True, True)}
REMAT_STEPS = 5                       # 4w: timed steps per setting, and train CLI steps
# 4b's training configuration at the widest batches of 4w and 4x
TRAIN_OVER = ["coarse.compute_dtype=bfloat16", "train.batch_size=64", "train.num_train_trees=512",
              f"train.seed={SEED}"]


def _lattice_run(model, blur, chunk, nb, device):
    """``ar_lattice`` on the molecules ``chunk`` padded to bucket nb and a
    pow2 batch: its outputs (margins included) as numpy, and
    ``focal_scale`` / ``target_scale``: each step's largest |score| of
    that head over the molecule's nodes (its outputs, caught by hooks),
    with the margins divided by them in ``*_margin_rel``."""
    from hierdiff_torch.sampling.lattice import _next_pow2, pad_blur

    arrays = pad_blur(blur, chunk, _next_pow2(len(chunk)), nb)
    caught = {"focal": [], "target": []}
    hooks = [model.focal_predict.register_forward_hook(
                 lambda _m, _i, o: caught["focal"].append(o[..., 0].abs())),
             model.edge_predict.register_forward_hook(
                 lambda _m, _i, o: caught["target"].append(o[..., 0].abs()))]
    try:
        out = model.ar_lattice(*(torch.from_numpy(a).to(device) for a in arrays))
    finally:
        for h_ in hooks:
            h_.remove()
    res = {k: v[:len(chunk)].cpu().numpy() for k, v in out.items()}
    nmask = torch.from_numpy(arrays[2][..., 0]).to(device) > 0
    for c in ("focal", "target"):
        scale = torch.stack([torch.where(nmask, a.float(), torch.zeros_like(a.float())).amax(1)
                             for a in caught[c]], dim=1)
        res[f"{c}_scale"] = scale[:len(chunk)].cpu().numpy()
        res[f"{c}_margin_rel"] = res[f"{c}_margin"] / np.maximum(res[f"{c}_scale"], 1e-30)
    return res


def _relative(lattice: dict) -> dict:
    """A lattice whose margins are the relative ones, for compare_lattices."""
    out = dict(lattice)
    for c in ("focal", "target"):
        out[f"{c}_margin"] = lattice[f"{c}_margin_rel"]
    return out


def lattice_device_ms(model, blur, chunk, nb, device) -> dict:
    """Wall and device ms (torch.profiler) of one lattice chunk, after a warm run."""
    from torch.profiler import ProfilerActivity, profile

    _lattice_run(model, blur, chunk, nb, device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _lattice_run(model, blur, chunk, nb, device)
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _lattice_run(model, blur, chunk, nb, device)
        torch.cuda.synchronize()
    return {"wall_ms": wall_ms, "device_ms": profiled_device_ms(prof)}


def fine_bf16_phase(cli, ek, coarse_pkl: bytes, device, f32_rate: float) -> dict:
    """Phase 4u: ``sampling.cli assemble --fine-bf16 --denoise-init-seed 0``
    on phase 4's point sets: spanning trees and trees/s beside 4e's f32
    rate; every bucket's bf16 lattice against the f32 lattice of the same
    weights on the card (a choice may differ only where the f32 margin is
    under BF16_MARGIN; top-1 types agree at BF16_TOP1 of the compared steps
    or more); BF16_CPU_SETS sets of the fullest bucket, card against CPU in
    bf16 under the same rule; wall and device ms of one lattice chunk at
    buckets 16 and 32, bf16 and f32; ``generate --fine-bf16`` on
    GENERATE_BF16 molecules, refine off: spanning trees, exact coarse
    launches."""
    from hierdiff_torch.config import EdgeDenoiseConfig
    from hierdiff_torch.data.collate import bucket_for
    from hierdiff_torch.tools.lattice_check import compare_lattices
    from hierdiff_torch.utils.weights import init_weights

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        src, out = Path(tmp) / "coarse.pkl", Path(tmp) / "trees.pkl"
        src.write_bytes(coarse_pkl)
        run = cli.main(["assemble", "--coarse-pkl", str(src), "--denoise-init-seed", "0",
                        "--fine-bf16", "--out", str(out)])
        with open(out, "rb") as f:
            trees = pickle.load(f)["trees"]
    blur, sampler = run["blur"], run["sampler"]
    model16 = sampler.model
    dtypes = {name: getattr(model16, name).compute_dtype
              for name in ("gcl_full_0", "gcl_focal_0", "gcl_edge", "gcl_denoise")}
    sizes = [b["h"].shape[0] for b in blur]
    faults = spanning_tree_faults(trees, sizes)
    rate = len(blur) / (run["lattice_s"] + run["search_s"])
    print(f"assemble --fine-bf16 (4u): GEOM denoise H={model16.hidden_nf}, {len(blur)} "
          f"molecules: lattices {run['lattice_s']:.3f} s, search {run['search_s']:.3f} s, "
          f"{rate:.3f} trees/s (4e's f32 {f32_rate:.3f}); layer dtypes {dtypes}; faults {faults}")
    if faults:
        fail(f"4u: assemble --fine-bf16 gave trees that are missing or invalid: {faults}")
    if dtypes != {"gcl_full_0": "bfloat16", "gcl_focal_0": "bfloat16", "gcl_edge": None,
                  "gcl_denoise": None}:
        fail(f"4u: --fine-bf16 set the wrong layers to bf16: {dtypes}")

    # every bucket's bf16 lattice against the f32 one of the same weights
    model32 = model16.clone(compute_dtype=None)
    by_bucket = {}
    for i, n in enumerate(sizes):
        by_bucket.setdefault(bucket_for(n, sampler.buckets), []).append(i)
    cuts, fails, steps, agree, total, worst, margin_moves = [], [], 0, 0, 0, 0.0, []
    for nb, idxs in sorted(by_bucket.items()):
        f32 = _lattice_run(model32, blur, idxs, nb, device)
        b16 = _lattice_run(model16, blur, idxs, nb, device)
        n_steps = [sizes[i] for i in idxs]
        # logp_tol 1: top_logp and top_wid are not gated, the choices are
        rep = compare_lattices(_relative(f32), b16, n_steps, margin=BF16_MARGIN, logp_tol=1.0,
                               relative=True)
        cuts += [(idxs[r], t, c, m) for r, t, c, m in rep["cut"]]
        fails += [(idxs[f[0]],) + tuple(f[1:]) for f in rep["failures"]]
        steps += rep["steps_compared"]
        worst = max(worst, rep["max_logp_rel_err"])
        cut_at = {r: t for r, t, _c, _m in rep["cut"]}
        for r, n in enumerate(n_steps):
            for t in range(min(n, cut_at.get(r, n))):
                total += 1
                agree += int(f32["top_wid"][r, t, 0] == b16["top_wid"][r, t, 0])
                for c in ("focal", "target"):
                    if math.isfinite(f32[f"{c}_margin"][r, t]):
                        margin_moves.append(abs(float(b16[f"{c}_margin"][r, t]
                                                      - f32[f"{c}_margin"][r, t]))
                                            / max(float(f32[f"{c}_scale"][r, t]), 1e-30))
    top1 = agree / max(total, 1)
    moves = np.quantile(margin_moves, [0.5, 0.99, 1.0]).tolist() if margin_moves else []
    against_f32 = {"steps_compared": steps, "cut": cuts, "molecules_cut": len({c[0] for c in cuts}),
                   "failures": fails[:5], "top1_agreement": top1, "max_logp_rel_err": worst,
                   "relative_margin_change_q50_q99_max": moves}
    print(f"bf16 against f32 lattices on the card (4u), margin bar {BF16_MARGIN} of the step's "
          f"largest |score|: {json.dumps(against_f32)}")
    if fails or top1 < BF16_TOP1:
        fail(f"4u: the bf16 lattices disagree with the f32 ones: {against_f32}")

    # bf16, card against CPU, on BF16_CPU_SETS sets of the fullest bucket
    nb = max(by_bucket, key=lambda k: len(by_bucket[k]))
    chunk = by_bucket[nb][:BF16_CPU_SETS]
    cpu16 = init_weights(cli.build_denoise_from_cfg(EdgeDenoiseConfig(), "cpu", "bfloat16"),
                         torch.Generator().manual_seed(0)).clone(dynamic_depth=True)
    cpu = _lattice_run(cpu16, blur, chunk, nb, torch.device("cpu"))
    card = _lattice_run(model16, blur, chunk, nb, device)
    rep = compare_lattices(_relative(cpu), card, [sizes[i] for i in chunk], margin=BF16_MARGIN,
                           logp_tol=1.0, relative=True)
    against_cpu = {"bucket": nb, "molecules": len(chunk), "steps_compared": rep["steps_compared"],
                   "cut": rep["cut"], "failures": rep["failures"][:5],
                   "max_logp_rel_err": rep["max_logp_rel_err"]}
    print(f"bf16 lattice, card against CPU (4u): {json.dumps(against_cpu)}")
    if not rep["ok"]:
        fail(f"4u: the card's bf16 lattice disagrees with the CPU's: {against_cpu}")

    # one lattice chunk's times at buckets 16 and 32, bf16 and f32
    timed = []
    for nb in LATTICE_TIMED_BUCKETS:
        chunk = [i for i in range(len(blur)) if sizes[i] <= nb][-16:]
        for name, model in (("bf16", model16), ("f32", model32)):
            row = {"bucket": nb, "molecules": len(chunk), "dtype": name,
                   **lattice_device_ms(model, blur, chunk, nb, device)}
            timed.append(row)
            print(f"lattice chunk (4u): bucket {nb}, {len(chunk)} molecules, {name}: wall "
                  f"{row['wall_ms']:.1f} ms, device {row['device_ms']:.1f} ms (torch.profiler)")

    # generate --fine-bf16, refine off
    steps = 100
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "generated.pkl"
        ek.reset_launch_counts()
        gen = cli.main(["generate", "--init-seed", "0", "--denoise-init-seed", "0",
                        "--fine-bf16", "--num", str(GENERATE_BF16), "--sample-steps", str(steps),
                        "--seed", str(SEED), "--out", str(out)])
        torch.cuda.synchronize()
        launches = dict(ek.launch_counts)
        with open(out, "rb") as f:
            gen_trees = pickle.load(f)["trees"]
    result, pipe = gen["result"], gen["pipeline"]
    gen_sizes = [b["h"].shape[0] for b in result.blur]
    n_chunks = len(pipe._plan_chunks(np.asarray(gen_sizes)))
    expect = {"fused_gcl": n_chunks * (steps + 1) * 12,
              "fused_coord_update": n_chunks * (steps + 1) * 6,
              "fused_gcl_bwd": 0, "coord_update_autograd": 0}
    gen_faults = spanning_tree_faults(gen_trees, gen_sizes)
    generated = {"molecules": GENERATE_BF16, "seconds": gen["seconds"],
                 "molecules_per_s": GENERATE_BF16 / gen["seconds"], "coarse_chunks": n_chunks,
                 "t_coarse": result.stats["t_coarse"], "t_fine": result.stats["t_fine"],
                 "launches": launches, "faults": gen_faults,
                 "bf16": pipe.sampler.model.gcl_full_0.compute_dtype == "bfloat16"}
    print(f"generate --fine-bf16 (4u): {json.dumps(generated)} (expected launches {expect})")
    if launches != expect or gen_faults or not generated["bf16"]:
        fail(f"4u: generate --fine-bf16: launches {launches} != {expect}, or faults "
             f"{gen_faults}, or not bf16")
    return {"molecules": len(blur), "lattice_s": run["lattice_s"], "search_s": run["search_s"],
            "trees_per_s": rate, "f32_trees_per_s": f32_rate, "against_f32": against_f32,
            "against_cpu": against_cpu, "chunks": timed, "generate": generated,
            "phase_seconds": time.perf_counter() - t_phase}


def allowed_phase(cli, coarse_pkl: bytes, device) -> dict:
    """Phase 4v: the size variant's per-node vocab restriction
    (``data/denoise.array_dict_allowed_fn``: each node's support is the
    array dict's bucket nearest its feature prefix) on phase 4's point sets
    at GEOM width, beam 5: every type inside its node's support; the Python
    search on the same lattices bitwise the native one; an allowed_fn of the
    whole vocabulary bitwise the unrestricted trees; the ``ARSampler`` at
    4r's configuration under the same restriction (spanning trees, types in
    their supports); trees/s restricted and unrestricted."""
    from hierdiff_torch.config import EdgeDenoiseConfig
    from hierdiff_torch.data.collate import SAMPLING_BUCKETS, bucket_for
    from hierdiff_torch.data.denoise import array_dict_allowed_fn
    from hierdiff_torch.sampling.ar import ARSampler
    from hierdiff_torch.sampling.lattice import LatticeSampler
    from hierdiff_torch.sampling.pipeline import round_int_features
    from hierdiff_torch.utils.weights import init_weights

    t_phase = time.perf_counter()
    blur = [{"x": np.asarray(b["x"], np.float32),
             "h": round_int_features(np.asarray(b["h"], np.float32), 5)}
            for b in cli._flatten_blur_pkl(pickle.loads(coarse_pkl))]
    sizes = [b["h"].shape[0] for b in blur]
    model = init_weights(cli.build_denoise_from_cfg(EdgeDenoiseConfig(), device),
                         torch.Generator().manual_seed(0))
    fn = array_dict_allowed_fn()
    supports = [fn(b["h"]) for b in blur]
    every = np.arange(780)

    def run(allowed_fn, native=True):
        s_ = LatticeSampler(model, beam_size=5, buckets=SAMPLING_BUCKETS, rng=random.Random(2022),
                            native_search=native, allowed_fn=allowed_fn)
        t0 = time.perf_counter()
        lattices = s_.compute_lattices(blur)
        t1 = time.perf_counter()
        trees = s_._search(blur, lattices)
        return {"sampler": s_, "lattices": lattices, "trees": trees, "lattice_s": t1 - t0,
                "search_s": time.perf_counter() - t1,
                "trees_per_s": len(blur) / (time.perf_counter() - t0)}

    restricted = run(fn)
    python = LatticeSampler(model, beam_size=5, buckets=SAMPLING_BUCKETS, rng=random.Random(2022),
                            native_search=False, allowed_fn=fn)._search(blur,
                                                                        restricted["lattices"])
    plain = run(None)
    full = run(lambda feats: [every] * feats.shape[0])
    outside = [(i, node, int(w)) for i, t in enumerate(restricted["trees"]) if t is not None
               for node, w in enumerate(t.wids) if int(w) not in supports[i][node]]
    faults = spanning_tree_faults([None if t is None else {"wids": t.wids, "adj": t.adj,
                                                           "logp": t.logp}
                                   for t in restricted["trees"]], sizes)
    res = {"molecules": len(blur), "restricted_trees_per_s": restricted["trees_per_s"],
           "restricted_lattice_s": restricted["lattice_s"],
           "restricted_search_s": restricted["search_s"],
           "unrestricted_trees_per_s": plain["trees_per_s"],
           "unrestricted_lattice_s": plain["lattice_s"],
           "support_sizes": [min(len(s) for m in supports for s in m),
                             max(len(s) for m in supports for s in m)],
           "outside_support": outside[:5], "faults": faults,
           "native_equals_python": same_trees(restricted["trees"], python),
           "full_vocab_equals_unrestricted": same_trees(full["trees"], plain["trees"]),
           "restriction_changed_trees": not same_trees(restricted["trees"], plain["trees"])}

    # the round-based sampler at 4r's configuration, restricted
    ar_blur = [b for b in blur if bucket_for(b["h"].shape[0], SAMPLING_BUCKETS)
               == AR_BUCKET][:AR_MOLECULES]
    ar_model = init_weights(cli.build_denoise_from_cfg(
        EdgeDenoiseConfig(vocab_conditioning=True), device), torch.Generator().manual_seed(0))
    ar_sampler = ARSampler(ar_model, beam_size=5, buckets=SAMPLING_BUCKETS,
                           rng=random.Random(2022), allowed_fn=fn)
    t0 = time.perf_counter()
    ar_trees = ar_sampler.sample(ar_blur)
    ar_s = time.perf_counter() - t0
    ar_sup = [fn(b["h"]) for b in ar_blur]
    ar_outside = [(i, node, int(w)) for i, t in enumerate(ar_trees) if t is not None
                  for node, w in enumerate(t.wids) if int(w) not in ar_sup[i][node]]
    ar_faults = spanning_tree_faults([None if t is None else {"wids": t.wids, "adj": t.adj,
                                                              "logp": t.logp} for t in ar_trees],
                                     [b["h"].shape[0] for b in ar_blur])
    res["ar"] = {"molecules": len(ar_blur), "steps": ar_sampler.expander.stats["steps"],
                 "seconds": ar_s, "trees_per_s": len(ar_blur) / ar_s,
                 "outside_support": ar_outside[:5], "faults": ar_faults}
    res["phase_seconds"] = time.perf_counter() - t_phase
    print(f"allowed_fn (4v): array-dict restriction, GEOM denoise, {len(blur)} molecules, beam "
          f"5: {json.dumps(res)}")
    if outside or faults or ar_outside or ar_faults:
        fail(f"4v: a type outside its support or a bad tree: {outside[:5]} {faults} "
             f"{ar_outside[:5]} {ar_faults}")
    if not (res["native_equals_python"] and res["full_vocab_equals_unrestricted"]):
        fail(f"4v: native != Python under the restriction, or the full vocabulary changed the "
             f"trees: {res}")
    return res


def _remat_step(model, batch, t_int, eps):
    """One forward and backward of the coarse loss with injected draws."""
    model.zero_grad(set_to_none=True)
    out = model(batch, None, train=True, t_int=t_int, eps=eps)
    out["loss"].backward()
    return out["loss"].detach()


def _peak_step(ek, model, batch, t_int, eps, device):
    """Launches and peak memory of one step, from a clean peak."""
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    ek.reset_launch_counts()
    loss = _remat_step(model, batch, t_int, eps)
    torch.cuda.synchronize()
    return loss, dict(ek.launch_counts), (torch.cuda.max_memory_allocated(device) - base) / 2**30


def remat_phase(train_cli, cli, ek, device) -> tuple:
    """Phase 4w: one coarse training step at 4b's configuration (GEOM,
    bf16 elementwise, batch 64, a fixed pool batch, injected t and noise)
    with ``remat`` / ``remat_edges`` off, each, and both: losses bitwise
    equal, every gradient within 1e-6 of its largest value, launches per
    step exact (off and remat_edges 12 fused_gcl + 12 fused_gcl_bwd + 6
    plain coordinate updates; remat 24 + 12 + 12), peak memory above the
    step's start and the median ms of REMAT_STEPS steps (forward and
    backward); the same loss under no_grad with the sampler's launches (12
    fused_gcl + 6 fused_coord_update) in every setting; peak memory off and
    with remat_edges at 4s's pocket shapes;
    ``train.cli coarse`` for REMAT_STEPS steps with both flags on, its
    parameters bitwise those of the same steps with both off. Returns the
    report and the parameters of that plain run (4x holds its run to them)."""
    from hierdiff_torch.config import load_config
    from hierdiff_torch.ops.masked import combine_noise
    from hierdiff_torch.train.data_iters import coarse_iter, finite, load_tree_pool, to_device
    from hierdiff_torch.utils.weights import init_weights

    t_phase = time.perf_counter()
    over = TRAIN_OVER
    cfg = load_config(None, over)
    pool = load_tree_pool(cfg, seed=SEED)
    # the widest of the stream's first 8 batches (buckets 8-32)
    np_batch = max(finite(coarse_iter(cfg, pool, seed=SEED + 5), 8),
                   key=lambda b_: b_["atom_mask"].shape[1])
    batch = to_device(np_batch, device)
    b, n = np_batch["atom_mask"].shape[:2]
    rng = np.random.default_rng(SEED + 1)
    t_int = torch.from_numpy(rng.integers(0, cfg.coarse.timesteps + 1, size=(b, 1))).to(device)
    eps = combine_noise(torch.from_numpy(rng.standard_normal((b, n, 11)).astype(np.float32)),
                        torch.from_numpy(np_batch["atom_mask"]), 3).to(device)
    settings = {}
    for name, (remat, remat_edges) in REMAT_SETTINGS.items():
        c = copy.deepcopy(cfg.coarse)
        c.remat, c.remat_edges = remat, remat_edges
        model = init_weights(cli.build_coarse_from_cfg(c, device=device),
                             torch.Generator().manual_seed(SEED)).train()
        loss, launches, peak = _peak_step(ek, model, batch, t_int, eps, device)
        grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
        times = []
        for _ in range(REMAT_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _remat_step(model, batch, t_int, eps)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        settings[name] = {"loss": loss, "grads": grads, "launches": launches, "peak_gib": peak,
                          "step_ms": float(np.median(times))}
        # no gradient recorded: the checkpoints are plain calls, the kernels as in sampling
        ek.reset_launch_counts()
        with torch.no_grad():
            nograd_loss = model(batch, None, train=True, t_int=t_int, eps=eps)["loss"]
        torch.cuda.synchronize()
        settings[name]["no_grad_launches"] = dict(ek.launch_counts)
        settings[name]["no_grad_loss"] = nograd_loss
        del model
    base = settings["off"]
    per_step = {name: {"fused_gcl": 24 if REMAT_SETTINGS[name][0] else 12, "fused_gcl_bwd": 12,
                       "coord_update_autograd": 12 if REMAT_SETTINGS[name][0] else 6,
                       "fused_coord_update": 0} for name in REMAT_SETTINGS}
    no_grad_expect = {"fused_gcl": 12, "fused_coord_update": 6, "fused_gcl_bwd": 0,
                      "coord_update_autograd": 0}
    report = {}
    for name, s in settings.items():
        dev = max(float((s["grads"][k] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
                  for k, g in base["grads"].items())
        report[name] = {"loss": float(s["loss"]), "loss_bitwise": torch.equal(s["loss"], base["loss"]),
                        "grad_max_rel_dev": dev, "launches": s["launches"],
                        "launches_ok": s["launches"] == per_step[name],
                        "no_grad_launches": s["no_grad_launches"],
                        "no_grad_ok": (s["no_grad_launches"] == no_grad_expect
                                       and torch.equal(s["no_grad_loss"], base["no_grad_loss"])),
                        "peak_gib": s["peak_gib"], "step_ms": s["step_ms"]}
    print(f"remat (4w): GEOM H={H} bf16, batch {b}, N={n}, one step, injected t and noise: "
          f"{json.dumps(report)}")
    bad = {k: r for k, r in report.items()
           if not (r["loss_bitwise"] and r["grad_max_rel_dev"] <= 1e-6 and r["launches_ok"]
                   and r["no_grad_ok"])}
    if bad:
        fail(f"4w: remat changed the step, or its launches are not exact: {bad}")

    # peak memory at 4s's pocket shapes, off and with remat_edges
    pcfg = load_config(CROSSDOCK, [f"train.seed={SEED}"])
    ppool = load_tree_pool(pcfg, seed=SEED)
    pbatch = to_device(next(coarse_iter(pcfg, ppool, seed=SEED + 7)), device)
    pocket = {}
    for name in ("off", "remat_edges"):
        c = copy.deepcopy(pcfg.coarse)
        c.remat_edges = name == "remat_edges"
        model = init_weights(cli.build_coarse_from_cfg(c, device=device),
                             torch.Generator().manual_seed(SEED)).train()
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        start = torch.cuda.memory_allocated(device)
        loss, _ = train_cli.coarse_loss(model, pbatch,
                                        torch.Generator(device=device).manual_seed(SEED))
        loss.backward()
        torch.cuda.synchronize()
        pocket[name] = {"peak_gib": (torch.cuda.max_memory_allocated(device) - start) / 2**30,
                        "loss": loss.item()}
        del model
    n_tot = int(pbatch["atom_mask"].shape[1] + pbatch["protein_feat_mask"].shape[1])
    print(f"remat_edges at 4s's pocket shapes (4w): B={pbatch['atom_mask'].shape[0]} "
          f"n_mol+K={n_tot}: {json.dumps(pocket)}")
    if pocket["off"]["loss"] != pocket["remat_edges"]["loss"]:
        fail(f"4w: remat_edges changed the pocket loss: {pocket}")

    # the train CLI with both flags, against both off
    params, runs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, flags in (("off", []), ("both", ["coarse.remat=true",
                                                   "coarse.remat_edges=true"])):
            ek.reset_launch_counts()
            run = train_cli.main(["coarse", "--init-seed", "0", f"train.workdir={tmp}/{name}",
                                  *over, f"train.max_steps={REMAT_STEPS}", "train.log_every=1",
                                  "train.eval_every=1000", "train.checkpoint_every=1000",
                                  *flags])
            torch.cuda.synchronize()
            params[name] = {k: v.cpu() for k, v in run["trainer"].state.model.state_dict().items()}
            runs[name] = {"steps_per_sec": run["steps_per_sec"], "launches": dict(ek.launch_counts)}
    differ = sorted(k for k, v in params["off"].items() if not torch.equal(v, params["both"][k]))
    egnn = runs["both"]
    print(f"train.cli coarse, {REMAT_STEPS} steps, remat and remat_edges on against off (4w): "
          f"{json.dumps(runs)}; parameters that differ {differ}")
    if differ:
        fail(f"4w: training with remat gave other parameters: {differ}")
    if egnn["launches"]["fused_gcl"] != 24 * REMAT_STEPS:
        fail(f"4w: the train CLI did not recompute the blocks: {egnn['launches']}")
    return {"batch": b, "n": n, "settings": report, "pocket": pocket, "pocket_n_tot": n_tot,
            "train_cli": runs, "phase_seconds": time.perf_counter() - t_phase,
            "launches": settings["both"]["launches"]}, params["off"]


# ---- 4s, 4t: the pocket-conditioned (CrossDocked) family
#
# configs/coarse_crossdock.yaml at its published width (H=256, 6 blocks of 2
# GCLs + 1 coordinate update, f32 elementwise, cross edges on). Training runs
# on synthetic pockets of K=16 residues (train/data_iters.synthetic_pockets);
# sampling conditions on a pocket read from a PDB file the smoke writes from
# a seed: POCKET_CA residues within POCKET_RADIUS of the site centre (the
# origin) and POCKET_FAR residues outside it.

CROSSDOCK = "configs/coarse_crossdock.yaml"
POCKET_STEPS = 20          # 4s training steps, batch 32 (the config's)
POCKET_CA, POCKET_FAR, POCKET_RADIUS = 32, 8, 10.0
POCKET_SAMPLES, POCKET_SAMPLE_STEPS = 64, 100


def write_pocket_pdb(path: Path, seed: int) -> None:
    """C-alpha ATOM records in the fixed-width PDB layout: POCKET_CA residues
    3-9 A from the origin, POCKET_FAR at 15-25 A, random residue types."""
    from hierdiff_torch.chem.pocket import RESIDUE_LIST

    rng = np.random.default_rng(seed)
    rows = []
    for i in range(POCKET_CA + POCKET_FAR):
        d = rng.standard_normal(3)
        r = (3.0 + 6.0 * rng.random()) if i < POCKET_CA else (15.0 + 10.0 * rng.random())
        x, y, z = d / np.linalg.norm(d) * r
        res = RESIDUE_LIST[int(rng.integers(len(RESIDUE_LIST)))]
        rows.append(f"ATOM  {i + 1:5d}  CA  {res} A{i + 1:4d}    {x:8.3f}{y:8.3f}{z:8.3f}"
                    "  1.00  0.00           C")
    path.write_text("\n".join(rows) + "\n")


def pocket_layer_inputs(batch: dict, device, seed: int):
    """A DenseGCL's inputs at a pocket batch's shape: random h (B, n_mol+K,
    H) on the real rows, the edge features of the molecule's and pocket's
    positions, the pocket edge mask with cross edges, the node mask."""
    from hierdiff_torch.models.diffusion import pocket_edge_mask
    from hierdiff_torch.ops.egnn import coord2diff_dense

    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}
    nm = torch.cat([t["atom_mask"], t["protein_feat_mask"]], dim=1).float().contiguous()
    em = pocket_edge_mask(t["atom_mask"].float(), t["edge_mask"].float(), t["protein_feat_mask"].float(),
                          t["protein_edge_mask"].float(), True)[..., None].contiguous()
    x = torch.cat([t["positions"], t["protein_pos"]], dim=1).float() * nm
    radial, _ = coord2diff_dense(x, 0.0)
    d0, _ = coord2diff_dense(x, 1.0)
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.standard_normal(tuple(nm.shape[:2]) + (H,)).astype(np.float32))
    return h.to(device) * nm, torch.cat([radial, d0], dim=-1).contiguous(), em, nm


def pocket_kernel_check(ek, name: str, kernel_fn, plain_fn, base, work, sm_clock_hz, n_sms,
                        bar: float = TOL) -> dict:
    """What a forward kernel adds to ``base`` against what its plain version
    adds, with device times and the bound of ``work`` (bytes, operations)."""
    out, ref = kernel_fn() - base, plain_fn() - base
    torch.cuda.synchronize()
    err, rel = rel_err(out, ref)
    ms, plain_ms = time_ms(kernel_fn), time_ms(plain_fn, reps=5, warmup=1)
    bound_ms, bound_by, parts = bound(*work, sm_clock_hz, n_sms)
    ok = bool(torch.isfinite(out).all()) and rel < bar
    print(f"kernel {name}: rel_err {rel:.3e} (bar {bar}), kernel_ms {ms:.4f} plain_ms "
          f"{plain_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}) {'ok' if ok else 'FAIL'}")
    return {"max_abs_err": err, "rel_err": rel, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_parts_ms": parts, "ok": ok}


def pocket_bwd_check(ek, layer, h, e, em, nm, sm_clock_hz, n_sms, what: str) -> dict:
    """fused_gcl_bwd against autograd of the plain version on pocket-shaped
    inputs (every gradient under the f32 bar), its device time, bound and
    edge slots against nnz(edge_mask)."""
    g = torch.from_numpy(np.random.default_rng(SEED + 5).standard_normal(
        tuple(h.shape)).astype(np.float32)).to(h.device)
    agg = torch.empty_like(h)
    ek._launch_gcl(layer, h, e, em, nm, h.device, agg_out=agg)
    kernel_fn = lambda: ek.fused_gcl_bwd(layer, h, e, em, nm, g, agg)  # noqa: E731
    plain_fn = lambda: ek.gcl_plain_vjp(layer, h, e, em, nm, g)  # noqa: E731
    got, ref = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    errs = {f: rel_err(a, r) for f, a, r in zip(ek.GclGrads._fields, got, ref)
            if a is not None and r is not None and r.numel()}   # E = 0: de, w_e empty
    worst = max(errs, key=lambda f: errs[f][1])
    computed, real = edge_slots(lambda **kw: ek.fused_gcl_bwd(layer, h, e, em, nm, g, agg, **kw))
    nnz = int((em != 0).sum().item())
    want = -(-nnz // ek.BWD_TILE_EDGES) * ek.BWD_TILE_EDGES
    ms, plain_ms = time_ms(kernel_fn), time_ms(plain_fn, reps=5, warmup=1)
    b, n = h.shape[:2]
    bound_ms, bound_by, parts = bound(*bwd_work(*mask_edges_nodes(em, nm), b, n), sm_clock_hz, n_sms)
    ok = (errs[worst][1] < GRAD_TOL[None] and computed == want and real == nnz
          and all(bool(torch.isfinite(a).all()) for a in got if a is not None))
    print(f"kernel fused_gcl_bwd [{what}]: worst {worst} rel_err {errs[worst][1]:.3e} (bar "
          f"{GRAD_TOL[None]}); edge slots {computed} for {real} real edges, nnz(edge_mask) {nnz} of "
          f"{em.numel()} dense (want {want}); kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms "
          f"{bound_ms:.4f} ({bound_by}) {'ok' if ok else 'FAIL'}")
    return {"max_abs_err": max(a for a, _ in errs.values()), "rel_err": errs[worst][1],
            "worst": worst, "edge_slots": computed, "real_edges": real, "nnz_edge_mask": nnz,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_parts_ms": parts, "ok": ok}


def pocket_train_phase(train_cli, cli, ek, device, workdir: Path, sm_clock_hz, n_sms) -> dict:
    """Phase 4s: ``train.cli coarse --config configs/coarse_crossdock.yaml``
    for POCKET_STEPS steps at batch 32, f32, synthetic pockets of K=16:
    rates after the first step, exact launches (12 fused_gcl and 12
    fused_gcl_bwd a step), the device busy share over three more steps
    (torch.profiler), both GCL kernels against their plain versions at a
    training batch's shape with its pocket mask, a step's gradient card vs
    CPU (pocket_embed included), and one gnn_dynamics and one
    mean-aggregation forward card vs CPU."""
    from hierdiff_torch.config import load_config
    from hierdiff_torch.models.diffusion import CoarseDiffusion
    from hierdiff_torch.ops.egnn import DenseGCL
    from hierdiff_torch.parallel.train_step import train_step
    from hierdiff_torch.train.data_iters import (POCKET_RESIDUES, coarse_iter, finite,
                                                 load_tree_pool, to_device)
    from hierdiff_torch.utils.weights import init_weights

    t_phase = time.perf_counter()
    cfg = load_config(CROSSDOCK, [f"train.seed={SEED}"])
    ek.reset_launch_counts()
    train = train_cli.main(["coarse", "--config", CROSSDOCK, "--init-seed", "0",
                            f"train.workdir={workdir}", f"train.max_steps={POCKET_STEPS}",
                            "train.log_every=1", "train.eval_every=1000",
                            "train.checkpoint_every=1000", f"train.seed={SEED}"])
    torch.cuda.synchronize()
    launches = dict(ek.launch_counts)
    gcls, coords = cfg.coarse.n_layers * cfg.coarse.inv_sublayers, cfg.coarse.n_layers
    expect = {"fused_gcl": gcls * POCKET_STEPS, "fused_gcl_bwd": gcls * POCKET_STEPS,
              "coord_update_autograd": coords * POCKET_STEPS, "fused_coord_update": 0}
    with open(workdir / "metrics.csv") as f:
        rows = [r for r in csv.DictReader(f) if r["split"] == "train"]
    losses = [float(r["loss"]) for r in rows]
    batch_size = cfg.train.batch_size

    # the device's busy share over three more steps of the same trainer
    pool = load_tree_pool(cfg, seed=cfg.train.seed)
    batches = [to_device(b, device) for b in finite(coarse_iter(cfg, pool, seed=SEED + 7), 4)]
    state, gen = train["trainer"].state, torch.Generator(device=device).manual_seed(SEED)
    train_step(state, train_cli.coarse_loss, batches[0], gen)   # warm
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[1:]:
            train_step(state, train_cli.coarse_loss, b, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = profiled_device_ms(prof) / wall_ms
    n_tots = [int(b["atom_mask"].shape[1] + b["protein_feat_mask"].shape[1]) for b in batches]
    print(f"pocket training (4s): train CLI {CROSSDOCK} H={cfg.coarse.hidden_nf} "
          f"{cfg.coarse.n_layers}x{cfg.coarse.inv_sublayers} layers, f32 elementwise, "
          f"batch {batch_size}, K={POCKET_RESIDUES} synthetic pocket residues, {POCKET_STEPS} "
          f"steps: {train['seconds']:.3f} s wall, {train['steps_per_sec']:.4f} steps/s and "
          f"{train['molecules_per_sec']:.3f} molecules/s after the first step; losses "
          f"{losses[0]:.4g} .. {losses[-1]:.4g}; launches {launches} (expected {expect}); device "
          f"busy {busy:.3f} of {wall_ms:.1f} ms over 3 steps at n_mol+K = {n_tots[1:]}")
    if len(rows) != POCKET_STEPS or not all(map(math.isfinite, losses)):
        fail("a pocket training step gave a non-finite loss")
    if launches != expect:
        fail(f"pocket training launch counts {launches} != {expect}")

    # both GCL kernels at a training batch's shape, with its pocket mask
    big = max(batches, key=lambda b: b["atom_mask"].shape[1])
    np_big = {k: v.cpu().numpy() for k, v in big.items()}
    h, e, em, nm = pocket_layer_inputs(np_big, device, SEED + 11)
    b_, n_ = h.shape[:2]
    layer = init_weights(DenseGCL(H, E, normalization_factor=cfg.coarse.normalization_factor,
                                  attention=True).to(device), torch.Generator().manual_seed(SEED))
    shape = f"B={b_} n_mol+K={n_} fill {float((em != 0).float().mean()):.3f}"
    with torch.no_grad():
        fwd = pocket_kernel_check(
            ek, f"fused_gcl [4s training shape {shape}]",
            lambda: ek.fused_gcl(layer, h, e, em, nm), lambda: ek.gcl_plain(layer, h, e, em, nm),
            h, gcl_work(*mask_edges_nodes(em, nm), b_, n_), sm_clock_hz, n_sms)
    bwd = pocket_bwd_check(ek, layer, h, e, em, nm, sm_clock_hz, n_sms, f"4s training shape {shape}")
    int32_margin = 2 ** 31 / max(b["atom_mask"].shape[0] * (b["atom_mask"].shape[1]
                                                             + POCKET_RESIDUES) ** 2
                                 for b in batches)
    print(f"int32 edge index guard: the largest training batch's b*n*n is 1/{int32_margin:.0f} "
          "of 2^31")

    # a step's gradient, card against CPU, pocket_embed included
    small = load_config(CROSSDOCK, [f"train.seed={SEED}", "train.batch_size=8"])
    grads = card_against_cpu(
        ek, init_weights(cli.build_coarse_from_cfg(small.coarse, device=device),
                         torch.Generator().manual_seed(SEED)).train(),
        next(coarse_iter(small, pool, seed=SEED + 3)),
        f"crossdock H={H} f32 elementwise, K={POCKET_RESIDUES} pocket rows", show=("pocket_embed",))

    # gnn_dynamics and mean aggregation: one forward each, card against CPU
    options = {}
    xb = big
    nm_mol, em_mol = xb["atom_mask"].float(), xb["edge_mask"].float()
    rng = np.random.default_rng(SEED + 13)
    xh = torch.from_numpy(rng.standard_normal(tuple(nm_mol.shape[:2]) + (11,)).astype(
        np.float32)).to(device) * nm_mol
    t = torch.from_numpy(rng.random((nm_mol.shape[0], 1)).astype(np.float32)).to(device)
    for label, kw, want in [("gnn_dynamics", {"mode": "gnn_dynamics"}, 2),
                            ("mean aggregation", {"aggregation_method": "mean"}, 0)]:
        model = init_weights(CoarseDiffusion(in_node_nf=8, hidden_nf=H, n_layers=2, **kw).to(device),
                             torch.Generator().manual_seed(SEED)).eval()
        ek.reset_launch_counts()
        with torch.no_grad():
            card = model.phi(xh, t, nm_mol, em_mol)
            torch.cuda.synchronize()
            got = dict(ek.launch_counts)
            cpu = copy.deepcopy(model).cpu().phi(xh.cpu(), t.cpu(), nm_mol.cpu(), em_mol.cpu())
        _, rel = rel_err(card.cpu(), cpu)
        ok = rel < TOL and got["fused_gcl"] == want and got["fused_coord_update"] == 0
        print(f"{label} (4s): H={H}, 2 layers, B={nm_mol.shape[0]} N={nm_mol.shape[1]}: card "
              f"against CPU rel_err {rel:.3e} (bar {TOL}); launches {got} (fused_gcl expected "
              f"{want}) {'ok' if ok else 'FAIL'}")
        options[label] = {"rel_err": rel, "launches": got, "ok": ok}
    # gnn_dynamics trains through the backward kernel with no edge features
    # over the all-ones mask; the kernels refuse mean aggregation
    gnn_layer = init_weights(
        DenseGCL(H, 0, normalization_factor=cfg.coarse.normalization_factor,
                 attention=True).to(device), torch.Generator().manual_seed(SEED))
    hg = h[:, :nm_mol.shape[1]].contiguous()
    ones = torch.ones(hg.shape[:2] + (hg.shape[1], 1), device=device)
    options["gnn_dynamics backward"] = pocket_bwd_check(
        ek, gnn_layer, hg, hg.new_zeros(hg.shape[:2] + (hg.shape[1], 0)), ones,
        torch.ones_like(hg[..., :1]), sm_clock_hz, n_sms, "gnn_dynamics, E=0, all-ones mask")
    mean = init_weights(DenseGCL(H, E, aggregation_method="mean").to(device),
                        torch.Generator().manual_seed(SEED))
    try:
        with torch.no_grad():
            ek.fused_gcl(mean, h, e, em, nm)
        refused = False
    except ValueError:
        refused = True
    print(f"fused_gcl refuses a mean-aggregation layer: {refused}")
    options["mean refused by the kernel"] = {"ok": refused}
    if not (fwd["ok"] and bwd["ok"] and grads["ok"] and all(o["ok"] for o in options.values())):
        fail(f"pocket training: a kernel or a gradient disagrees: fused_gcl {fwd}, "
             f"fused_gcl_bwd {bwd}, gradients {grads}, options {options}")
    return {"steps": POCKET_STEPS, "seconds": train["seconds"],
            "steps_per_sec": train["steps_per_sec"],
            "molecules_per_sec": train["molecules_per_sec"], "device_busy": busy,
            "launches": launches, "fused_gcl": fwd, "fused_gcl_bwd": bwd,
            "step_gradients": grads, "options": options, "int32_margin": int32_margin,
            "phase_seconds": time.perf_counter() - t_phase}


class PocketProbe:
    """Hooks on every module's forward while a pocket chain runs: counts the
    GCL and coordinate-update calls by row count, keeps the first call's
    inputs (and module) at each row count, and accumulates on the device
    whether the pocket rows of the network's input ever changed and whether
    the velocity of a pocket row, before the CoM projection, was ever
    nonzero (``models/dynamics.remove_mean_with_mask``, wrapped)."""

    def __init__(self):
        from hierdiff_torch.models import dynamics as dyn
        from hierdiff_torch.models.dynamics import EGNNDynamics
        from hierdiff_torch.ops.egnn import DenseEquivariantUpdate, DenseGCL

        self.calls, self.first, self.edge_masks = {}, {}, []
        self.pocket_first = None
        self.pocket_changed = None
        self.pocket_vel = None
        self.mol_shape = None
        self.kinds = {DenseGCL: "gcl", DenseEquivariantUpdate: "coord"}
        self.dyn, self.dyn_cls = dyn, EGNNDynamics
        self._center = dyn.remove_mean_with_mask

    def pre(self, module, args):
        kind = self.kinds.get(type(module))
        if kind is not None:
            n = args[0].shape[1]
            self.calls[(kind, n)] = self.calls.get((kind, n), 0) + 1
            if (kind, n) not in self.first:
                self.first[(kind, n)] = (module, tuple(a.detach().clone() for a in args))
        elif isinstance(module, self.dyn_cls):
            self.mol_shape = args[5] if len(args) > 5 else None
            if self.mol_shape is not None:
                pocket = args[1][:, self.mol_shape:]
                if self.pocket_first is None:
                    self.pocket_first = pocket.clone()
                    self.pocket_changed = torch.zeros((), device=pocket.device)
                    em = args[3]
                    self.edge_masks.append((em[..., 0] if em.ndim == 4 else em).clone())
                self.pocket_changed += (pocket != self.pocket_first).sum()

    def center(self, vel, node_mask, *a, **kw):
        if self.mol_shape is not None:
            moved = vel[:, self.mol_shape:].abs().sum()
            self.pocket_vel = moved if self.pocket_vel is None else self.pocket_vel + moved
        return self._center(vel, node_mask, *a, **kw)

    def __enter__(self):
        self.handle = torch.nn.modules.module.register_module_forward_pre_hook(self.pre)
        self.dyn.remove_mean_with_mask = self.center
        return self

    def __exit__(self, *exc):
        self.handle.remove()
        self.dyn.remove_mean_with_mask = self._center


def pocket_sample_phase(cli, ek, device, ema: Path, tmp: Path, sm_clock_hz, n_sms) -> dict:
    """Phase 4t: ``sampling.cli coarse --pocket-pdb`` with 4s's ema.pt on a
    PDB written from a seed (POCKET_CA residues inside POCKET_RADIUS),
    POCKET_SAMPLES molecules at POCKET_SAMPLE_STEPS strided steps,
    crossdock-histogram counts: molecules/s of a plain run; then the same
    run under ``PocketProbe`` (equal to the first bit for bit): exact
    launches and their row counts, the pocket rows unchanged at every step,
    zero pocket velocity; samples finite, masked and CoM-free; a second
    pocket changes the samples; the mask without cross edges is block
    diagonal; both forward kernels against their plain versions on the
    chain's own inputs at n_mol+K, with edge slots against nnz; the samples
    through ``assemble``."""
    from hierdiff_torch.config import load_config
    from hierdiff_torch.ops.masked import mean_zero_max_violation, masking_violation

    t_phase = time.perf_counter()
    pdbs = [tmp / "site_a.pdb", tmp / "site_b.pdb"]
    for i, pdb in enumerate(pdbs):
        write_pocket_pdb(pdb, SEED + 20 + i)
    k = cli.load_pocket(str(pdbs[0]), "0,0,0", POCKET_RADIUS)["protein_feat"].shape[1]
    if k != POCKET_CA:
        fail(f"the written pocket has {k} residues within {POCKET_RADIUS} A, not {POCKET_CA}")

    def sample(pdb: Path, out: Path, config: str = CROSSDOCK, num: int = POCKET_SAMPLES,
               steps: int = POCKET_SAMPLE_STEPS):
        return cli.main(["coarse", "--config", config, "--weights", str(ema), "--num", str(num),
                         "--batch-size", str(num), "--steps", str(steps), "--seed", str(SEED),
                         "--pocket-pdb", str(pdb), "--pocket-center", "0,0,0", "--pocket-radius",
                         str(POCKET_RADIUS), "--out", str(out)])

    ek.reset_launch_counts()
    run = sample(pdbs[0], tmp / "pocket_a.pkl")
    torch.cuda.synchronize()
    launches = dict(ek.launch_counts)
    x, h, nm = run["batches"][0]
    n_mol = nm.shape[1]
    n_tot = n_mol + k
    cfg = load_config(CROSSDOCK).coarse
    gcls, coords, per_chain = cfg.n_layers * cfg.inv_sublayers, cfg.n_layers, POCKET_SAMPLE_STEPS + 1
    expect = {"fused_gcl": gcls * per_chain, "fused_coord_update": coords * per_chain,
              "fused_gcl_bwd": 0, "coord_update_autograd": 0}
    rate = run["molecules"] / run["seconds"]
    with PocketProbe() as probe:
        again = sample(pdbs[0], tmp / "pocket_a2.pkl")
        torch.cuda.synchronize()
    repeat = torch.equal(again["batches"][0][0], x) and torch.equal(again["batches"][0][1], h)
    calls_expect = {("gcl", n_tot): gcls * POCKET_SAMPLE_STEPS, ("gcl", n_mol): gcls,
                    ("coord", n_tot): coords * POCKET_SAMPLE_STEPS, ("coord", n_mol): coords}
    pocket_changed = int(probe.pocket_changed.item())
    pocket_vel = float(probe.pocket_vel.item())
    finite = bool(torch.isfinite(x).all() and torch.isfinite(h).all())
    masked = max(masking_violation(x, nm).item(), masking_violation(h, nm).item())
    com = mean_zero_max_violation(x, nm).item()
    other = sample(pdbs[1], tmp / "pocket_b.pkl")
    changed = not torch.equal(other["batches"][0][0], x)
    em_cross = probe.edge_masks[0]
    nm_p = torch.ones((nm.shape[0], k), device=device)
    cross_ok = (torch.equal(em_cross[:, :n_mol, n_mol:], nm[:, :, 0, None] * nm_p[:, None, :])
                and torch.equal(em_cross[:, n_mol:, :n_mol], em_cross[:, :n_mol, n_mol:].transpose(1, 2)))
    fill = float((em_cross != 0).float().mean())
    print(f"pocket sampling (4t): sampling CLI {CROSSDOCK} with 4s's ema.pt, "
          f"{run['molecules']} molecules, steps={POCKET_SAMPLE_STEPS}, K={k} pocket residues "
          f"(of {POCKET_CA + POCKET_FAR} in the PDB), n_mol={n_mol}: {run['seconds']:.3f} s wall, "
          f"{rate:.3f} molecules/s; launches {launches} (expected {expect}); calls by rows "
          f"{probe.calls} (expected {calls_expect}); repeat bitwise {repeat}; pocket input rows "
          f"changed {pocket_changed} times, pocket velocity before the CoM projection "
          f"{pocket_vel}; finite={finite} masking_violation={masked} "
          f"mean_zero_max_violation={com:.3e}; a second pocket changes the samples: {changed}; "
          f"cross edges are nm_mol x pocket: {cross_ok}; edge fill {fill:.3f} of "
          f"(B, {n_tot}, {n_tot})")

    # pocket_cross_edges: false gives the block-diagonal mask
    no_cross = tmp / "crossdock_no_cross.yaml"
    no_cross.write_text((Path(CROSSDOCK).read_text()).replace("pocket_cross_edges: true",
                                                               "pocket_cross_edges: false"))
    assert not load_config(str(no_cross)).coarse.pocket_cross_edges
    with PocketProbe() as probe_nc:
        nc = sample(pdbs[0], tmp / "pocket_nc.pkl", str(no_cross), num=8, steps=2)
    em_nc = probe_nc.edge_masks[0]
    n_nc = nc["batches"][0][2].shape[1]
    block_ok = (not em_nc[:, :n_nc, n_nc:].any() and not em_nc[:, n_nc:, :n_nc].any()
                and bool(em_nc[:, n_nc:, n_nc:].any()) and bool(em_nc[:, :n_nc, :n_nc].any()))
    print(f"pocket_cross_edges=false: the edge mask is block diagonal: {block_ok}")

    # both forward kernels on the chain's own inputs at n_mol+K
    gcl_layer, gcl_args = probe.first[("gcl", n_tot)]
    coord_layer, coord_args = probe.first[("coord", n_tot)]
    hh, ee, nn_, em_ = gcl_args
    shape = f"B={hh.shape[0]} n_mol+K={n_tot} fill {fill:.3f}"
    ch, cx, cd, ce, cn, cm = coord_args
    with torch.no_grad():
        fwd = pocket_kernel_check(
            ek, f"fused_gcl [4t sampling shape {shape}]",
            lambda: ek.fused_gcl(gcl_layer, hh, ee, em_, nn_),
            lambda: ek.gcl_plain(gcl_layer, hh, ee, em_, nn_), hh,
            gcl_work(*mask_edges_nodes(em_, nn_), hh.shape[0], n_tot), sm_clock_hz, n_sms)
        coord = pocket_kernel_check(
            ek, f"fused_coord_update [4t sampling shape {shape}]",
            lambda: ek.fused_coord_update(coord_layer, ch, ce, cd, cx, cm, cn),
            lambda: ek.coord_update_plain(coord_layer, ch, ce, cd, cx, cm, cn), cx,
            coord_work(*mask_edges_nodes(cm, cn), ch.shape[0], n_tot), sm_clock_hz, n_sms)
        slots = pocket_bwd_check(ek, gcl_layer, hh, ee, em_, nn_, sm_clock_hz, n_sms,
                                 f"4t sampling shape {shape}")

    # the samples feed the fine stage
    run_asm = cli.main(["assemble", "--coarse-pkl", str(tmp / "pocket_a.pkl"),
                        "--denoise-init-seed", "0", "--out", str(tmp / "pocket_trees.pkl")])
    n_trees = sum(t_ is not None for t_ in run_asm["trees"])
    asm_s = run_asm["lattice_s"] + run_asm["search_s"]
    print(f"pocket samples through assemble: {n_trees}/{len(run_asm['blur'])} junction trees in "
          f"{asm_s:.3f} s ({len(run_asm['blur']) / asm_s:.3f} trees/s)")
    ok = (launches == expect and probe.calls == calls_expect and repeat and pocket_changed == 0
          and pocket_vel == 0.0 and finite and masked == 0.0 and com < 1e-2 and changed
          and cross_ok and block_ok and fwd["ok"] and coord["ok"] and slots["ok"]
          and n_trees == len(run_asm["blur"]))
    if not ok:
        fail("pocket sampling: a check failed (see the lines above)")
    return {"molecules": run["molecules"], "seconds": run["seconds"], "molecules_per_sec": rate,
            "n_mol": n_mol, "pocket_residues": k, "edge_fill": fill, "launches": launches,
            "calls_by_rows": {f"{kind}@{n}": c for (kind, n), c in probe.calls.items()},
            "fused_gcl": fwd, "fused_coord_update": coord, "fused_gcl_bwd_edge_slots": slots,
            "trees_per_s": len(run_asm["blur"]) / asm_s,
            "phase_seconds": time.perf_counter() - t_phase}


# ---- 4x, 4y, 4z: data parallelism
#
# The card is one, so the data-parallel paths run in a world-1 NCCL group
# (the train CLI, in this process) and in world-2 gloo groups whose two
# ranks share the card (NCCL refuses two ranks on one device). Each rank is
# a spawned process (parallel/mesh.spawn) that loads the libraries built
# above and returns its own launch counts.

DP_MOLECULES, DP_STEPS = 16, 100       # 4y: generate at world 2 and at world 1


def _dp_step_inputs():
    """4x: the world-2 step's global batch (the first of 4b's training
    stream, 64 molecules) and its injected t and noise, as numpy."""
    from hierdiff_torch.config import load_config
    from hierdiff_torch.ops.masked import combine_noise
    from hierdiff_torch.train.data_iters import coarse_iter, load_tree_pool

    cfg = load_config(None, TRAIN_OVER)
    batch = next(coarse_iter(cfg, load_tree_pool(cfg, seed=SEED), seed=SEED + 9))
    b, n = batch["atom_mask"].shape[:2]
    rng = np.random.default_rng(SEED + 9)
    t_int = rng.integers(0, cfg.coarse.timesteps + 1, size=(b, 1))
    eps = combine_noise(torch.from_numpy(rng.standard_normal((b, n, 11)).astype(np.float32)),
                        torch.from_numpy(batch["atom_mask"]), 3).numpy()
    return batch, {"t_int": t_int, "eps": eps}


def _dp_step(batch: dict, draws: dict, device) -> tuple:
    """One step of 4b's model (GEOM, bf16 elementwise, weights from SEED,
    AdamW unclipped) on ``batch`` with ``draws``: (the gradient the update
    took, by name, on the host; the model; launches)."""
    from hierdiff_torch.config import load_config
    from hierdiff_torch.ops import egnn_kernels as ek
    from hierdiff_torch.parallel import mesh
    from hierdiff_torch.parallel.train_step import TrainState, train_step
    from hierdiff_torch.sampling import cli
    from hierdiff_torch.utils.weights import init_weights

    cfg = load_config(None, TRAIN_OVER + ["optim.grad_clip=null"])
    model = init_weights(cli.build_coarse_from_cfg(cfg.coarse, device=device),
                         torch.Generator().manual_seed(SEED)).train()
    state = TrainState(mesh.replicate(model), cfg.optim)
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}
    draws = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in draws.items()}

    def loss_fn(m, b, _):
        out = m(b, None, train=True, **draws)
        return out["loss"], {"error": out["error"].mean()}

    ek.reset_launch_counts()
    metrics = train_step(state, loss_fn, tensors, None)   # unclipped: p.grad is what it took
    torch.cuda.synchronize()
    launches = dict(ek.launch_counts)
    grads = {k: p.grad.detach().double().cpu() for k, p in model.named_parameters()}
    return grads, model, launches, float(metrics["loss"])


def dp_rank(batch: dict, draws: dict, tmp: str) -> dict:
    """One rank of 4x's step and 4y's generate, at world 2 or, for 4y's
    reference, at world 1 (a fresh process too, so that the two rates have
    the same history)."""
    from hierdiff_torch.ops import egnn_kernels as ek
    from hierdiff_torch.parallel import mesh
    from hierdiff_torch.sampling import cli

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, size = mesh.world()
    device = torch.device("cuda")
    grads, model, step_launches, loss = _dp_step(mesh.shard_batch(batch, rank, size),
                                                 mesh.shard_batch(draws, rank, size), device)
    params = torch.cat([p.detach().reshape(-1) for p in model.parameters()]).cpu().numpy()
    del model
    ek.reset_launch_counts()
    run = cli.main(["generate", "--init-seed", "0", "--denoise-init-seed", "0",
                    "--num", str(DP_MOLECULES), "--sample-steps", str(DP_STEPS), "--beam", "5",
                    "--seed", str(SEED), "--out", str(Path(tmp) / "generate_dp.pkl")])
    torch.cuda.synchronize()
    out = {"step_launches": step_launches, "params": params, "loss": loss,
           "generate_launches": dict(ek.launch_counts)}
    if rank == 0:
        out["grads"] = {k: v.numpy() for k, v in grads.items()}
        out["generate"] = {"blur": run["result"].blur, "trees": run["result"].trees,
                           "seconds": run["seconds"],
                           "chunks": len(run["pipeline"]._plan_chunks(np.asarray(
                               [b_["h"].shape[0] for b_ in run["result"].blur])))}
    return out


def dp_phases(train_cli, cli, ek, device, off_params: dict) -> dict:
    """Phases 4x-4z. 4x: ``train.cli coarse --data-parallel`` for
    REMAT_STEPS steps at 4w's configuration in a world-1 NCCL group: its
    parameters bitwise 4w's plain run, its launches exact; one step of 4b's
    model at world 2 over gloo, both ranks on this card, on 64 molecules
    with injected t and noise: the gradient the update took against the
    single-process step's under 4c's bar (global relative L2 < 2e-2), the
    two ranks' parameters bitwise equal, 12 fused_gcl + 12 fused_gcl_bwd per
    rank. 4y: ``generate`` of DP_MOLECULES molecules at DP_STEPS steps at
    world 2 over gloo: point sets and trees bitwise those of a world-1 run
    in a spawned process of its own (serial, as in any group), each rank's
    coarse launches exact for its chunks, molecules/s beside world 1's. 4z:
    ``entry.dryrun_multichip(2, backend="gloo")``, every rank with a share of
    both generation checks and its launches exact for it."""
    import torch.distributed as dist

    from hierdiff_torch import entry
    from hierdiff_torch.parallel import mesh

    t_phase = time.perf_counter()
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        # 4x (a): the train CLI in a world-1 NCCL group
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl_rendezvous", rank=0,
                                world_size=1)
        try:
            ek.reset_launch_counts()
            run = train_cli.main(["coarse", "--data-parallel", "--init-seed", "0",
                                  f"train.workdir={tmp}/dp", *TRAIN_OVER,
                                  f"train.max_steps={REMAT_STEPS}", "train.log_every=1",
                                  "train.eval_every=1000", "train.checkpoint_every=1000"])
            torch.cuda.synchronize()
            cli_launches = dict(ek.launch_counts)
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
        params = run["trainer"].state.model.state_dict()
        differ = sorted(k for k, v in off_params.items() if not torch.equal(v, params[k].cpu()))
        expect = {"fused_gcl": 12 * REMAT_STEPS, "fused_gcl_bwd": 12 * REMAT_STEPS,
                  "coord_update_autograd": 6 * REMAT_STEPS, "fused_coord_update": 0}
        report["train_cli_world1"] = {"backend": backend, "steps": run["steps"],
                                      "steps_per_sec": run["steps_per_sec"],
                                      "launches": cli_launches, "parameters_that_differ": differ}
        print(f"4x: train.cli coarse --data-parallel in a world-1 {backend} group, {REMAT_STEPS} "
              f"steps at 4w's configuration: {run['steps_per_sec']:.4f} steps/s after the first; "
              f"launches {cli_launches} (expected {expect}); parameters that differ from 4w's "
              f"plain run {differ}")
        if backend != "nccl" or differ or cli_launches != expect:
            fail(f"4x: the world-1 NCCL run is not the plain run: {report['train_cli_world1']}")
        del run, params

        # 4x (b) and 4y: the world-2 ranks, then the single-process references
        batch, draws = _dp_step_inputs()
        t0 = time.perf_counter()
        ranks = mesh.spawn(dp_rank, 2, "gloo", init_file=f"{tmp}/gloo_rendezvous",
                           args=(batch, draws, tmp), timeout=600)
        spawn_s = time.perf_counter() - t0
        ref_grads, ref_model, ref_launches, ref_loss = _dp_step(batch, draws, device)
        del ref_model
        diff2 = sum(float(((torch.from_numpy(ranks[0]["grads"][k]) - g) ** 2).sum())
                    for k, g in ref_grads.items())
        glob = math.sqrt(diff2 / sum(float((g ** 2).sum()) for g in ref_grads.values()))
        in_sync = bool(np.array_equal(ranks[0]["params"], ranks[1]["params"]))
        step_expect = {"fused_gcl": 12, "fused_gcl_bwd": 12, "coord_update_autograd": 6,
                       "fused_coord_update": 0}
        step_ok = (glob < 2e-2 and in_sync and ref_launches == step_expect
                   and all(r["step_launches"] == step_expect for r in ranks))
        report["step_world2"] = {
            "batch": int(batch["atom_mask"].shape[0]), "n": int(batch["atom_mask"].shape[1]),
            "global_rel_l2": glob, "ranks_bitwise_equal": in_sync,
            "loss_by_rank": [r["loss"] for r in ranks], "single_process_loss": ref_loss,
            "launches_by_rank": [r["step_launches"] for r in ranks], "ok": step_ok}
        print(f"4x: one step of 4b's model at world 2 (gloo, both ranks on this card), "
              f"B={batch['atom_mask'].shape[0]} N={batch['atom_mask'].shape[1]}: the gradient "
              f"against the single-process step's, global relative L2 {glob:.3e} (bar 2e-2); "
              f"ranks bitwise equal {in_sync}; launches by rank "
              f"{[r['step_launches'] for r in ranks]} (expected {step_expect} each)")
        if not step_ok:
            fail(f"4x: the world-2 step is not the single-process step: {report['step_world2']}")

        world1 = Path(tmp) / "world1"
        world1.mkdir()
        solo = mesh.spawn(dp_rank, 1, "gloo", init_file=f"{tmp}/gloo1_rendezvous",
                          args=(batch, draws, str(world1)), timeout=600)[0]
        one, two = solo["generate"], ranks[0]["generate"]
        chunks = two["chunks"]

        def gen_expect(chunks_):
            return {"fused_gcl": chunks_ * (DP_STEPS + 1) * 12,
                    "fused_coord_update": chunks_ * (DP_STEPS + 1) * 6,
                    "fused_gcl_bwd": 0, "coord_update_autograd": 0}

        expect_2 = [gen_expect(len(range(r, chunks, 2))) for r in range(2)]
        same_blur = all(np.array_equal(a["x"], b_["x"]) and np.array_equal(a["h"], b_["h"])
                        for a, b_ in zip(one["blur"], two["blur"]))
        same = same_trees(one["trees"], two["trees"])
        rates = {"world_1": DP_MOLECULES / one["seconds"], "world_2": DP_MOLECULES / two["seconds"]}
        gen_launches = [r["generate_launches"] for r in ranks]
        report["generate_world2"] = {
            "molecules": DP_MOLECULES, "steps": DP_STEPS, "coarse_chunks": chunks,
            "same_blur": same_blur, "same_trees": same, "molecules_per_s": rates,
            "launches_by_rank": gen_launches, "spawn_and_ranks_s": spawn_s,
            "trees": sum(t is not None for t in two["trees"])}
        print(f"4y: generate, {DP_MOLECULES} molecules at {DP_STEPS} steps, {chunks} coarse "
              f"chunks, at world 2 (gloo, both ranks on this card) against world 1 (a spawned "
              f"process, serial): point sets bitwise {same_blur}, trees bitwise {same}; "
              f"molecules/s {rates}; launches by rank {gen_launches} (expected {expect_2}), "
              f"at world 1 {solo['generate_launches']}; the spawn and both ranks' work "
              f"{spawn_s:.1f} s")
        if not (same_blur and same and gen_launches == expect_2
                and solo["generate_launches"] == gen_expect(chunks)
                and one["chunks"] == chunks):
            fail(f"4y: data-parallel generate is not the world-1 run: {report['generate_world2']}")

    # 4z: the dry run's three checks at world 2 over gloo on this card
    t0 = time.perf_counter()
    dry = entry.dryrun_multichip(2, backend="gloo")
    dry_expect = [entry.expected_launches(c) for c in dry["coarse_chunks"]]
    report["dryrun"] = {"lines": dry["lines"], "launches_by_rank": dry["launches"],
                        "coarse_chunks_by_rank": dry["coarse_chunks"],
                        "seconds": time.perf_counter() - t0}
    print(f"4z: dryrun_multichip(2, backend='gloo') on this card in {report['dryrun']['seconds']:.1f}"
          f" s; coarse chunks by rank {dry['coarse_chunks']}; launches by rank {dry['launches']} "
          f"(expected {dry_expect})")
    if min(dry["coarse_chunks"]) == 0 or dry["launches"] != dry_expect:
        fail(f"4z: a dry-run rank's launches are not its share's: {report['dryrun']}")
    report["phase_seconds"] = time.perf_counter() - t_phase

    def total(counts):
        return {k: sum(c[k] for c in counts) for k in counts[0]}

    return {"report": report,
            "train_dp_launches": total([cli_launches] + [r["step_launches"] for r in ranks]),
            "generate_dp_launches": total(gen_launches),
            "dryrun_dp_launches": total(dry["launches"])}


# ---- 5a-5c: reference checkpoints, the JT-VAE stack, the chemistry tools

CKPT_NUM, CKPT_STEPS, CKPT_MAX_NODES, CKPT_TRAIN_STEPS = 16, 20, 12, 3   # 5a
JT_TREES, JT_MAX_NODES = 32, 32           # 5b: synthetic GEOM trees of at most 32 nodes
JT_VOCAB, JT_HIDDEN, JT_LATENT = 780, 450, 56   # the JAX package's JT-VAE defaults
# 5b (MPN / JTMPN: the first 12) and 5c (the SDF: all 16): chem_check's six
# molecules and ten more, in the Kekule forms the fake-RDKit harness parses
HARNESS_SMILES = (
    "CC(=O)NC1=CC=C(O)C=C1", "C1=CC=CC=C1CCNC(=O)C1CCCCC1", "OC1=CC=C(CN2CCOCC2)C=C1",
    "CC1=CC(=O)NC(C)=C1", "NC(=O)C1CCCN1CC1=CC=CS1", "ClC1=CC=C(C=C1)C(=O)NCCO",
    "CC1=CC=CC=C1O", "OCCN1CCOCC1", "CC(=O)OC1=CC=CC=C1C(=O)O", "NC1=CC=C(C=C1)S(N)(=O)=O",
    "CN1C=NC2=C1C(=O)N(C)C(=O)N2C", "CC(C)CC1=CC=C(C=C1)C(C)C(=O)O", "OC(=O)C1=CC=CN=C1",
    "CCOC(=O)C1=CC=CC=C1N", "C1CCC(CC1)NC(=O)C2=CC=CS2", "COC1=CC=C(CCN)C=C1")
MPN_MOLECULES = 12


def lightning_checkpoint(sd: dict, stage: str) -> dict:
    """``sd`` in the reference's PyTorch-Lightning layout: under
    ``state_dict`` with the ``model.`` prefix, beside the reference's
    non-parameter buffers (one key of each of ``weights.SKIPPED_KEYS``), and
    a config object in ``hyper_parameters``, which the weights-only
    unpickler refuses."""
    extra = {"gamma.gamma": torch.linspace(-10.0, 10.0, 1001), "buffer": torch.zeros(1),
             "dynamics.egnn.sin_embedding.frequencies": torch.arange(6.0)}
    return {"state_dict": {"model." + k: v for k, v in {**sd, **extra}.items()},
            "hyper_parameters": argparse.Namespace(stage=stage, lr=4e-4, batch_size=64),
            "epoch": 1, "global_step": 100}


def checkpoint_phase(cli, train_cli, ek, device) -> dict:
    """Phase 5a: GEOM-width coarse, denoise and refine weights (seeded
    random) saved as raw state dicts and as reference Lightning checkpoints;
    ``sampling.cli coarse --weights``, ``assemble --denoise-weights
    --refine-weights`` (refine checks on) and ``train.cli coarse --weights``
    from each kind: the point sets, the trees and the trained parameters
    bitwise equal, the coarse launches exact."""
    from hierdiff_torch.config import load_config

    t_phase = time.perf_counter()
    launches, runs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        files = {}
        for stage in ("coarse", "denoise", "refine"):
            cfg = load_config(None)
            cfg.stage = stage
            sd = {k: v.cpu() for k, v in
                  train_cli.initial_model(cfg, device, init_seed=SEED).state_dict().items()}
            files[stage] = {"raw": tmp / f"{stage}.pt", "lightning": tmp / f"{stage}.ckpt"}
            torch.save(sd, files[stage]["raw"])
            torch.save(lightning_checkpoint(sd, stage), files[stage]["lightning"])
        try:
            torch.load(files["coarse"]["lightning"], map_location="cpu", weights_only=True)
            fail("5a: the weights-only unpickler took the Lightning checkpoint's "
                 "hyper_parameters: the loader's fallback is not exercised")
        except pickle.UnpicklingError:
            pass
        for kind in ("raw", "lightning"):
            run = {}
            ek.reset_launch_counts()
            cli.main(["coarse", "--weights", str(files["coarse"][kind]), "--num", str(CKPT_NUM),
                      "--batch-size", str(CKPT_NUM), "--steps", str(CKPT_STEPS),
                      "--max-nodes", str(CKPT_MAX_NODES), "--seed", str(SEED),
                      "--out", str(tmp / f"coarse-{kind}.pkl")])
            torch.cuda.synchronize()
            launches[f"ckpt_sample_{kind}"] = dict(ek.launch_counts)
            with open(tmp / f"coarse-{kind}.pkl", "rb") as f:
                run["samples"] = pickle.load(f)[0]
            ek.reset_launch_counts()
            asm = cli.main(["assemble", "--coarse-pkl", str(tmp / "coarse-raw.pkl"),
                            "--denoise-weights", str(files["denoise"][kind]),
                            "--refine-weights", str(files["refine"][kind]),
                            "--out", str(tmp / f"trees-{kind}.pkl")])
            torch.cuda.synchronize()
            launches[f"ckpt_assemble_{kind}"] = dict(ek.launch_counts)
            run["trees"] = asm["trees"]
            run["checks"] = asm["sampler"].refine_hook.stats["score_calls"]
            ek.reset_launch_counts()
            tr = train_cli.main(["coarse", "--weights", str(files["coarse"][kind]),
                                 f"train.workdir={tmp}/train-{kind}", "train.batch_size=32",
                                 "train.num_train_trees=128", f"train.max_steps={CKPT_TRAIN_STEPS}",
                                 "train.log_every=1", "train.eval_every=1000",
                                 "train.checkpoint_every=1000", f"train.seed={SEED}"])
            torch.cuda.synchronize()
            launches[f"ckpt_train_{kind}"] = dict(ek.launch_counts)
            run["params"] = {k: v.cpu() for k, v in tr["trainer"].state.model.state_dict().items()}
            run["steps_per_sec"] = tr["steps_per_sec"]
            runs[kind] = run
    raw, pl = runs["raw"], runs["lightning"]
    samples_equal = len(raw["samples"]) == CKPT_NUM and all(
        np.array_equal(a["x"], b["x"]) and np.array_equal(a["h"], b["h"])
        for a, b in zip(raw["samples"], pl["samples"]))
    trees_equal = same_trees(raw["trees"], pl["trees"])
    params_differ = sorted(k for k, v in raw["params"].items()
                           if not torch.equal(v, pl["params"][k]))
    sample_expect = {"fused_gcl": (CKPT_STEPS + 1) * 12, "fused_coord_update": (CKPT_STEPS + 1) * 6,
                     "fused_gcl_bwd": 0, "coord_update_autograd": 0}
    train_expect = {"fused_gcl": CKPT_TRAIN_STEPS * 12, "fused_gcl_bwd": CKPT_TRAIN_STEPS * 12,
                    "coord_update_autograd": CKPT_TRAIN_STEPS * 6, "fused_coord_update": 0}
    zero = dict.fromkeys(sample_expect, 0)
    expect = {f"ckpt_{path}_{kind}": want for kind in ("raw", "lightning")
              for path, want in (("sample", sample_expect), ("assemble", zero),
                                 ("train", train_expect))}
    out = {"samples_equal": samples_equal, "trees_equal": trees_equal,
           "params_differ": params_differ, "refine_checks": [raw["checks"], pl["checks"]],
           "train_steps_per_sec": [raw["steps_per_sec"], pl["steps_per_sec"]],
           "launches": launches, "phase_seconds": time.perf_counter() - t_phase}
    print(f"5a: reference Lightning checkpoints (state_dict, model. prefix, hyper_parameters, "
          f"skipped buffers) against raw state dicts, GEOM width: coarse --weights {CKPT_NUM} "
          f"point sets of <= {CKPT_MAX_NODES} nodes at {CKPT_STEPS} steps bitwise {samples_equal}; "
          f"assemble --denoise-weights --refine-weights trees bitwise {trees_equal} (refine checks "
          f"{out['refine_checks']}); train.cli coarse --weights, {CKPT_TRAIN_STEPS} steps: "
          f"parameters that differ {params_differ}; launches {launches}; "
          f"{out['phase_seconds']:.1f} s")
    if not (samples_equal and trees_equal) or params_differ:
        fail(f"5a: a Lightning checkpoint gave other results than its raw state dict: {out}")
    if raw["checks"] == 0 or raw["checks"] != pl["checks"]:
        fail(f"5a: the refine model checked no tree, or not the same ones: {out['refine_checks']}")
    if launches != expect:
        fail(f"5a: launch counts {launches} != {expect}")
    return out


def grad_margin(card: dict, cpu: dict, cpu_rev: dict) -> dict:
    """``card_against_cpu``'s margin rule on gradients by name (double CPU
    tensors): the card's, the CPU's, and the CPU's with the batch in reverse
    order. A parameter that the reversal moves by ``ROUNDING_SHARE`` of its
    size or more is at rounding level and not held to the CPU; the others
    get a relative L2 error each; the global one covers all."""
    diff2 = {k: float(((card[k] - cpu[k]) ** 2).sum()) for k in cpu}
    ref2 = {k: float((cpu[k] ** 2).sum()) for k in cpu}
    moved = {k: math.sqrt(float(((cpu_rev[k] - cpu[k]) ** 2).sum()) / ref2[k]) if ref2[k] > 0
             else math.inf for k in cpu}
    rounding = {k: {"cpu_l2": math.sqrt(ref2[k]), "moved_by_reversal": moved[k],
                    "card_l2": float(card[k].norm())}
                for k in cpu if not moved[k] < ROUNDING_SHARE}
    per = {k: math.sqrt(diff2[k] / ref2[k]) for k in cpu if k not in rounding}
    glob = math.sqrt(sum(diff2.values()) / sum(ref2.values()))
    missing = sorted(k for k, v in card.items() if not torch.isfinite(v).all()
                     or (k not in rounding and not v.abs().max() > 0))
    return {"per": per, "rounding": rounding, "global": glob, "missing": missing}


def margin_check(what: str, card_fn, cpu_fn, rev_fn, out_err: float, device_ms: float,
                 wall_ms: float, f64_fn=None) -> dict:
    """Gradients of the card run (twice, bitwise) against the CPU's under
    ``grad_margin``, and with ``f64_fn`` both against the CPU's in float64;
    prints one line and returns the report."""
    first, second = card_fn(), card_fn()
    repeat = [k for k in first if not torch.equal(first[k], second[k])]
    cpu = cpu_fn()
    m = grad_margin(first, cpu, rev_fn())
    worst = max(m["per"], key=m["per"].get)
    report = {"global_rel_l2": m["global"], "worst_tensor": worst,
              "worst_rel_l2": m["per"][worst], "rounding_level": m["rounding"],
              "missing": m["missing"], "not_repeated": repeat, "output_rel_err": out_err,
              "device_ms": device_ms, "wall_ms": wall_ms}
    exact = ""
    if f64_fn is not None:
        ref = f64_fn()
        for name, got in (("card_vs_f64", first), ("cpu_vs_f64", cpu)):
            report[name] = grad_margin(got, ref, ref)["global"]
        exact = (f"; against the CPU in float64: card {report['card_vs_f64']:.3e}, CPU f32 "
                 f"{report['cpu_vs_f64']:.3e}")
    report["ok"] = (m["global"] < 2e-2 and m["per"][worst] < 2e-2 and not m["missing"]
                    and not repeat and out_err < 2e-2 and report.get("card_vs_f64", 0.0) < 2e-2)
    print(f"5b: {what}: output relative error card vs CPU {out_err:.3e}; gradients: global "
          f"relative L2 {m['global']:.3e} (bar 2e-2), worst tensor {worst} {m['per'][worst]:.3e}, "
          f"at rounding level {sorted(m['rounding'])}, without a gradient {m['missing']}, not "
          f"bitwise on a second backward {repeat}{exact}; forward+backward {device_ms:.3f} device "
          f"ms (torch.profiler, CUDA activity), {wall_ms:.3f} ms wall")
    return report


def fwd_bwd_ms(step, reps: int = 3) -> tuple:
    """(device ms, wall ms) per forward+backward ``step()``: the device's
    CUDA activity under torch.profiler, and the host clock around
    synchronised reps."""
    step()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    return profiled_device_ms(prof) / reps, wall


def jtnn_phase(device) -> dict:
    """Phase 5b: the JT-VAE stack at the JAX package's defaults (vocab 780,
    hidden 450, latent 56, MPN depth 3). The encoder and the teacher-forced
    decoder on JT_TREES synthetic GEOM trees of at most JT_MAX_NODES nodes
    (the root vectors feed the decoder through a fixed random projection,
    the reference's T_mean linear), forward and backward of the decoder's
    loss plus the mean squared messages; MPN and JTMPN (with a seeded tree
    message on every bond) on ``mol2graph_dense`` of MPN_MOLECULES harness
    molecules, featurised with the harness in place for that call only.
    Each is held card against CPU under 4c's margin rule (the tree model's
    gradients also against the CPU's in float64), its gradients repeat
    bitwise, and its forward+backward time is printed."""
    from hierdiff_torch.chem import has_rdkit
    from hierdiff_torch.data.synthetic import SyntheticTreeGenerator
    from hierdiff_torch.models import jtnn
    from hierdiff_torch.utils.weights import init_weights

    t_phase = time.perf_counter()
    torch.set_grad_enabled(True)
    gen = SyntheticTreeGenerator(seed=SEED)
    trees = [gen.sample_tree(min(gen.sample_count(), JT_MAX_NODES)) for _ in range(JT_TREES)]
    n = max(t.adj.shape[0] for t in trees)
    adj = np.zeros((JT_TREES, n, n), np.float32)
    wids = np.zeros((JT_TREES, n), np.int64)
    nm = np.zeros((JT_TREES, n, 1), np.float32)
    for i, t in enumerate(trees):
        k = t.adj.shape[0]
        adj[i, :k, :k], wids[i, :k], nm[i, :k] = t.adj, t.wids, 1.0
    trace = jtnn.collate_traces([t.adj for t in trees], n)
    g = torch.Generator().manual_seed(SEED)
    proj = torch.randn(JT_HIDDEN, JT_LATENT, generator=g) / math.sqrt(JT_HIDDEN)
    cpu = torch.device("cpu")
    enc = init_weights(jtnn.JTNNEncoder(JT_VOCAB, JT_HIDDEN, device=cpu), g)
    dec = init_weights(jtnn.JTNNDecoder(JT_VOCAB, JT_HIDDEN, JT_LATENT, device=cpu), g)
    # where -> (encoder, decoder, device, float type)
    models = {"card": (copy.deepcopy(enc).to(device), copy.deepcopy(dec).to(device), device,
                       torch.float32),
              "cpu": (enc, dec, cpu, torch.float32),
              "cpu_f64": (copy.deepcopy(enc).double(), copy.deepcopy(dec).double(), cpu,
                          torch.float64)}

    def put(a, dev, dt=torch.float32):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return t.to(dt) if t.is_floating_point() else t

    def tree_loss(where, order=slice(None)):
        e, d, dev, dt = models[where]
        w, m = put(wids[order], dev), put(nm[order], dev, dt)
        up, down, root = e(w, put(adj[order], dev, dt), m)
        out = d(w, m, {k: put(v[:, order], dev, dt) for k, v in trace.items()},
                root @ proj.to(dev, dt))
        return out["loss"] + up.square().mean() + down.square().mean(), out

    def grads(where, fn, params, order=slice(None)):
        for p in params[where].values():
            p.grad = None
        fn(where, order)[0].backward()
        return {k: p.grad.detach().double().cpu() for k, p in params[where].items()}

    tree_params = {where: {f"enc.{k}": p for k, p in models[where][0].named_parameters()}
                   | {f"dec.{k}": p for k, p in models[where][1].named_parameters()}
                   for where in models}
    rev = np.arange(JT_TREES)[::-1].copy()
    with torch.no_grad():
        loss_card, out_card = tree_loss("card")
        loss_cpu, out_cpu = tree_loss("cpu")
    out_err = abs(float(loss_card) - float(loss_cpu)) / abs(float(loss_cpu))
    dev_ms, wall_ms = fwd_bwd_ms(lambda: tree_loss("card")[0].backward())
    report = {"trees": JT_TREES, "max_nodes": n, "trace_steps": int(trace["active"].shape[0]),
              "losses_card": {k: float(v) for k, v in out_card.items()},
              "losses_cpu": {k: float(v) for k, v in out_cpu.items()}}
    report["tree"] = margin_check(
        f"JTNNEncoder + JTNNDecoder (vocab {JT_VOCAB}, hidden {JT_HIDDEN}, latent {JT_LATENT}) "
        f"on {JT_TREES} trees of <= {n} nodes, {report['trace_steps']} trace steps; losses card "
        f"{report['losses_card']}",
        lambda: grads("card", tree_loss, tree_params),
        lambda: grads("cpu", tree_loss, tree_params),
        lambda: grads("cpu", tree_loss, tree_params, rev), out_err, dev_ms, wall_ms,
        f64_fn=lambda: grads("cpu_f64", tree_loss, tree_params))

    fake = install_harness()
    try:
        graph = jtnn.mol2graph_dense(list(HARNESS_SMILES[:MPN_MOLECULES]))
    finally:
        fake.uninstall()
    if has_rdkit():
        fail("5b: the fake-RDKit harness stayed installed after the featurisation")
    a = graph["fatoms"].shape[1]
    seed = (torch.randn(MPN_MOLECULES, a, a, JT_HIDDEN, generator=g) * 0.1
            * torch.from_numpy(graph["bond_mask"])[..., None])
    for name, cls, extra in (("MPN", jtnn.MPN, None), ("JTMPN", jtnn.JTMPN, seed)):
        base = init_weights(cls(JT_HIDDEN, 3, device=cpu), g)
        mods = {"card": (copy.deepcopy(base).to(device), device), "cpu": (base, cpu)}

        def mpn_out(where, order=slice(None)):
            mod, dev = mods[where]
            rows = order if isinstance(order, slice) else torch.from_numpy(order)
            args = () if extra is None else (extra[rows].contiguous().to(dev),)
            vec = mod({k: put(v[order], dev) for k, v in graph.items()}, *args)
            return vec.square().sum(), vec

        params = {where: dict(mods[where][0].named_parameters()) for where in mods}
        with torch.no_grad():
            vec_card, vec_cpu = mpn_out("card")[1].cpu(), mpn_out("cpu")[1]
        out_err = rel_err(vec_card, vec_cpu)[1]
        dev_ms, wall_ms = fwd_bwd_ms(lambda: mpn_out("card")[0].backward())
        report[name] = margin_check(
            f"{name} (hidden {JT_HIDDEN}, depth 3) on {MPN_MOLECULES} harness molecules of <= {a} "
            "atoms" + (", a tree message on every bond" if extra is not None else ""),
            lambda: grads("card", mpn_out, params),
            lambda: grads("cpu", mpn_out, params),
            lambda: grads("cpu", mpn_out, params, np.arange(MPN_MOLECULES)[::-1].copy()),
            out_err, dev_ms, wall_ms)
    report["phase_seconds"] = time.perf_counter() - t_phase
    bad = [k for k in ("tree", "MPN", "JTMPN") if not report[k]["ok"]]
    if bad:
        fail(f"5b: the JT-VAE stack on the card: {bad} over the bar or not repeatable: "
             f"{ {k: report[k] for k in bad} }")
    return report


def chem_tools_phase(train_cli, ek, device) -> dict:
    """Phase 5c, under the fake-RDKit harness: ``mff_rmsd`` on the
    HARNESS_SMILES molecules (each ``base_rmsd`` finite, each molecule at
    RMSD 0 from itself, the first tree's reconstruction lifted to a finite
    conformer); ``preprocess.process_sdf`` on an SDF of them (over the
    vocabulary of their own fragments: the harness's canonical SMILES are
    not the real vocabulary's), every tree written, read back by
    ``load_tree_pool`` equal to ``featurize_tree``'s arrays, and one
    ``train.cli denoise`` step at GEOM width on those trees."""
    from hierdiff_torch.chem import mff_rmsd, preprocess
    from hierdiff_torch.chem.mol_tree import MolTree
    from hierdiff_torch.chem.reconstruct import TreeReconstructor
    from hierdiff_torch.config import load_config
    from hierdiff_torch.tools import chem_check
    from hierdiff_torch.train.data_iters import load_tree_pool

    t_phase = time.perf_counter()
    install_harness()
    from rdkit import Chem

    world = chem_check.mini_world(HARNESS_SMILES)
    vocab, mols = world["vocab"], world["mols"]
    rmsd = [mff_rmsd.base_rmsd(m, vocab) for m in mols]
    self_rmsd = max(max(mff_rmsd.tree_center_rmsd(m, m, vocab), mff_rmsd.mol_rmsd(m, m))
                    for m in mols)
    tree = MolTree(mols[0], vocab=vocab)
    mol, amap, _ = TreeReconstructor(vocab).reconstruct(tree)
    lifted = mff_rmsd.set_rmsd(mol, amap[1: len(tree.nodes) + 1], tree)
    lift_ok = lifted is not None and bool(np.isfinite(lifted.GetConformer().GetPositions()).all())
    rmsd_ok = all(r is not None and math.isfinite(r["tree"]) and math.isfinite(r["mol"])
                  for r in rmsd)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        sdf = tmp / "mols.sdf"
        sdf.write_text("".join(Chem.MolToMolBlock(m) + "$$$$\n" for m in mols))
        real_vocab = preprocess.Vocab
        preprocess.Vocab = lambda: vocab
        try:
            preprocess.process_sdf(str(sdf), str(tmp / "trees"))
        finally:
            preprocess.Vocab = real_vocab
        pool = load_tree_pool(load_config(None, [f"train.data={tmp / 'trees'}"]))
        # the SDF holds coordinates to 4 decimals: positions within 1e-4, the rest exact
        want = [preprocess.featurize_tree(t, vocab) for t in world["trees"]]
        read_back = len(pool) == len(mols) and all(
            np.array_equal(t.feats, w[0]) and float(np.abs(t.pos - w[1]).max()) < 1e-4
            and np.array_equal(t.adj, w[2]) and np.array_equal(t.wids, w[3])
            and np.array_equal(t.sizes, w[4]) for t, w in zip(pool, want))
        ek.reset_launch_counts()
        run = train_cli.main(["denoise", "--config", fine_config("denoise"), "--init-seed", "0",
                              f"train.workdir={tmp / 'run'}", f"train.data={tmp / 'trees'}",
                              "train.batch_size=8", "train.max_steps=1", "train.log_every=1",
                              "train.eval_every=1000", "train.checkpoint_every=1000",
                              f"train.seed={SEED}"])
        torch.cuda.synchronize()
        launches = dict(ek.launch_counts)
        with open(tmp / "run" / "metrics.csv") as f:
            rows = [r for r in csv.DictReader(f) if r["split"] == "train"]
    values = [float(v) for r in rows for k, v in r.items() if k not in ("step", "split")]
    out = {"molecules": len(mols), "base_rmsd": rmsd, "self_rmsd_max": self_rmsd,
           "lift_finite": lift_ok, "trees_written": len(pool), "read_back_equal": read_back,
           "denoise_step": {"steps": run["steps"], "first_row": rows[0] if rows else None},
           "launches": launches, "phase_seconds": time.perf_counter() - t_phase}
    print(f"5c ({HARNESS}): mff_rmsd on {len(mols)} molecules, base_rmsd finite {rmsd_ok} "
          f"(tree {min(r['tree'] for r in rmsd):.4g} .. {max(r['tree'] for r in rmsd):.4g}, mol "
          f"{min(r['mol'] for r in rmsd):.4g} .. {max(r['mol'] for r in rmsd):.4g}), largest "
          f"RMSD of a molecule to itself {self_rmsd:.3g}, set_rmsd lift finite {lift_ok}; "
          f"process_sdf wrote {len(pool)} trees, read back by load_tree_pool equal {read_back}; "
          f"train.cli denoise 1 step on them: {rows[0] if rows else None}, coarse launches "
          f"{launches}; {out['phase_seconds']:.1f} s")
    if not (rmsd_ok and lift_ok and self_rmsd < 1e-9 and read_back):
        fail(f"5c: the chemistry tools under the harness: {out}")
    if len(rows) != 1 or not all(map(math.isfinite, values)) or any(launches.values()):
        fail(f"5c: the denoise step on the preprocessed trees: {out}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description="Smoke test of the port on one GPU.")
    ap.add_argument("--parent", type=Path, default=None,
                    help="an unpacked earlier tree of this repository, whose fused_gcl is "
                         "timed beside this one's (tools/gcl_ab.py)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA GPU")
    from hierdiff_torch.chem import has_rdkit
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
    if has_rdkit():
        fail("an rdkit module is installed: this run assumes none, so that phases 4e-4m run "
             "ungated and 4n-4q put the fake-RDKit harness in its place")
    print("RDKit: absent, as this run assumes (4e-4m ungated; 4n-4q under the fake-RDKit "
          "harness)")
    from hierdiff_torch import runtime
    t0 = time.perf_counter()
    if not runtime.treekit_available():
        fail("the treekit library did not build: the native searches and packers this run "
             "measures would fall back to Python")
    print(f"treekit: {runtime.library_path().name} built and loaded in "
          f"{time.perf_counter() - t0:.2f} s (native searches, packers)")
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
    gcl_flops, gcl_sfu, gcl_bytes = gcl_work(*complete_graphs(counts), B, N)

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
        rows = {"kernel_shape": None, "sampler_shape": None, "geom_shape": None, "pocket_shape": None}
        if args.parent is not None:
            from hierdiff_torch.tools import gcl_ab

            for row in gcl_ab.compare(args.parent, kernel=kernel):
                print(f"{kernel} against the parent tree's: {json.dumps(row)}")
                if row[flag] and row["elementwise"] == "float32":
                    rows[row["shape"].split()[0] + "_shape"] = row
        return rows

    main_gcl = init_weights(DenseGCL(H, E, normalization_factor=10.0, attention=True).to(device),
                            gen())
    gcl_extra["fused_gcl"] = {
        **sampler_and_repeat(
            "fused_gcl", "node_mlp=random attention=True elementwise=float32",
            lambda *a_: ek.fused_gcl(main_gcl, *a_), lambda *a_: ek.gcl_plain(main_gcl, *a_),
            gcl_work(*complete_graphs(s_counts), B, s_n), cases[f"sampler shape B={B} N={s_n}"],
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
    coord_flops, coord_sfu, coord_bytes = coord_work(*complete_graphs(counts), B, N)
    gcl_extra["fused_coord_update"] = {
        **sampler_and_repeat(
            "fused_coord_update", "tanh=True elementwise=float32",
            lambda *a_: ek.fused_coord_update(equ, *a_),
            lambda *a_: ek.coord_update_plain(equ, *a_), coord_work(*complete_graphs(s_counts), B, s_n),
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
    s_bound = bound(*bwd_work(*complete_graphs(s_counts), B, s_n), sm_clock_hz, n_sms)
    print(f"kernel fused_gcl_bwd [sampler shape B={B} N={s_n}, node_mlp=random attention=True "
          f"elementwise=float32]: kernel_ms {s_ms:.4f} plain_ms {s_plain_ms:.4f} bound_ms "
          f"{s_bound[0]:.5f} ({s_bound[1]})")
    bwd_bound = bound(*bwd_work(*complete_graphs(counts), B, N), sm_clock_hz, n_sms)
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
        from hierdiff_torch.data.collate import collate_coarse
        from hierdiff_torch.data.synthetic import SyntheticTreeGenerator

        step_grads = card_against_cpu(
            ek, init_weights(cli.build_coarse_from_cfg(CoarseModelConfig(), "float32", device),
                             gen()).train(),
            collate_coarse(SyntheticTreeGenerator(seed=SEED).sample_trees(8)),
            f"GEOM H={H} f32 elementwise")
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

    # ---- 4f. the pipeline from the histogram to junction trees, overlapped and not
    generated, generate_launches, gen_on, gen_pipe = generate_phase(cli, ek)
    generated_off, generate_off_launches, gen_off, _ = generate_phase(cli, ek, overlap=False)
    generated["overlap_check"] = overlap_check("generate", gen_on, gen_off, gen_pipe)

    # ---- 4g. the fine stage with the refine model's checks, on phase 4's point sets
    refined = refine_assemble_phase(cli, coarse_pkl, device)

    # ---- 4h. the pipeline with the refine model's checks, overlapped and not
    generated_refine, generate_refine_launches, ref_on, ref_pipe = generate_phase(
        cli, ek, refine=True)
    generated_refine_off, generate_refine_off_launches, ref_off, _ = generate_phase(
        cli, ek, refine=True, overlap=False)
    generated_refine["overlap_check"] = overlap_check("generate, refine on", ref_on, ref_off,
                                                      ref_pipe)

    # ---- 4r. the round-based sampler (vocab_conditioning)
    assembled_ar = ar_phase(cli, ek, coarse_pkl, device)

    # ---- 4u, 4v, 4w. --fine-bf16, the per-node vocab restriction, remat / remat_edges
    fine_bf16 = fine_bf16_phase(cli, ek, coarse_pkl, device, assembled["trees_per_s"])
    allowed = allowed_phase(cli, coarse_pkl, device)
    remat, remat_off_params = remat_phase(train_cli, cli, ek, device)

    # ---- 4x, 4y, 4z. data parallelism: the train CLI in a world-1 NCCL group,
    # a world-2 step and generate over gloo (both ranks on this card), the dry
    # run; before 4n-4q install the fake-RDKit harness in this process
    dp = dp_phases(train_cli, cli, ek, device, remat_off_params)

    # ---- 4s, 4t. the pocket-conditioned (CrossDocked) family: training, then
    # sampling with the trained ema.pt
    with tempfile.TemporaryDirectory() as pocket_tmp:
        pocket_tmp = Path(pocket_tmp)
        pocket_train = pocket_train_phase(train_cli, cli, ek, device, pocket_tmp / "run",
                                          sm_clock_hz, n_sms)
        pocket_sample = pocket_sample_phase(cli, ek, device, pocket_tmp / "run" / "ema.pt",
                                            pocket_tmp, sm_clock_hz, n_sms)
    for name, shape, check in [
            ("fused_gcl", "4s training", pocket_train["fused_gcl"]),
            ("fused_gcl_bwd", "4s training", pocket_train["fused_gcl_bwd"]),
            ("fused_gcl", "4t sampling", pocket_sample["fused_gcl"]),
            ("fused_coord_update", "4t sampling", pocket_sample["fused_coord_update"]),
            ("fused_gcl_bwd", "4t sampling", pocket_sample["fused_gcl_bwd_edge_slots"])]:
        results[name].append({"variant": f"pocket, {shape} shape", **check})

    with tempfile.TemporaryDirectory() as fine_tmp:
        # ---- 4i, 4j. training of the fine stage's two models at GEOM width
        fine_train = {stage: fine_train_phase(train_cli, ek, stage, Path(fine_tmp) / stage,
                                              device) for stage in ("denoise", "refine")}
        # ---- 4k. one step's gradient, card against CPU
        fine_grads = {stage: fine_grad_check(train_cli, stage, device)
                      for stage in ("denoise", "refine")}
        if not all(g["ok"] for g in fine_grads.values()):
            fail(f"fine-stage gradients, card against CPU, over the bar or not repeatable: "
                 f"{fine_grads}")
        # ---- 4l. the planted-signal learning check
        planted = planted_phase(device)
        # ---- 4m. the trained weights feed the sampler
        trained_assemble = trained_assemble_phase(
            cli, coarse_pkl, {stage: Path(fine_tmp) / stage / "ema.pt" for stage in fine_train})

    # ---- 5a. reference Lightning checkpoints through the weight flags
    checkpoints = checkpoint_phase(cli, train_cli, ek, device)
    # ---- 5b. the JT-VAE stack on the card
    jtnn_report = jtnn_phase(device)

    # ---- 4n-4q. the assembly gate, reconstruction and evaluation (fake-RDKit
    # harness), then 5c: the chemistry tools under it; the harness stays
    # installed, so these run last
    tagged = HarnessLines(sys.stdout)
    try:
        with contextlib.redirect_stdout(tagged):
            gated = gated_assemble_phase(cli, coarse_pkl, assembled["trees_per_s"])
            generated_gated = gated_generate_phase(cli, ek)
            reconstructed = reconstruct_eval_phase(cli, generated_gated)
            gated_refine = gated_refine_phase(cli, coarse_pkl)
            chem_tools = chem_tools_phase(train_cli, ek, device)
    finally:
        tagged.flush()

    # ---- 6. kernel list
    bounds = {"fused_gcl": bound(gcl_flops, gcl_sfu, gcl_bytes, sm_clock_hz, n_sms),
              "fused_coord_update": bound(coord_flops, coord_sfu, coord_bytes, sm_clock_hz, n_sms),
              "fused_gcl_bwd": bwd_bound}
    meta = {"fused_gcl": ("hierdiff_torch/csrc/fused_gcl.cu",
                          "hierdiff_tpu/ops/egnn_pallas.py:141"),
            "fused_coord_update": ("hierdiff_torch/csrc/fused_coord.cu",
                                   "hierdiff_tpu/ops/egnn_pallas.py:492"),
            "fused_gcl_bwd": ("hierdiff_torch/csrc/fused_gcl_bwd.cu",
                              "hierdiff_tpu/ops/egnn_pallas.py:346")}
    paths = {"sample": launches, "train": train_launches, "generate": generate_launches,
             "generate_overlap_off": generate_off_launches,
             "generate_refine": generate_refine_launches,
             "generate_refine_overlap_off": generate_refine_off_launches,
             "assemble_ar": assembled_ar["launches"],
             "generate_streamed": generated_gated["stats"]["run_streamed"]["launches"],
             "train_denoise": fine_train["denoise"]["launches"],
             "train_refine": fine_train["refine"]["launches"],
             "generate_gated": generated_gated["stats"]["launches"],
             "generate_gated_workers_2": generated_gated["stats"]["launches_workers_2"],
             "train_pocket": pocket_train["launches"], "sample_pocket": pocket_sample["launches"],
             "generate_fine_bf16": fine_bf16["generate"]["launches"],
             "train_step_remat": remat["launches"],
             "train_remat": remat["train_cli"]["both"]["launches"],
             "train_remat_off": remat["train_cli"]["off"]["launches"],
             "train_dp": dp["train_dp_launches"], "generate_dp": dp["generate_dp_launches"],
             "dryrun_dp": dp["dryrun_dp_launches"], **checkpoints["launches"],
             "train_denoise_preprocessed": chem_tools["launches"]}
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
        "generate": generated, "generate_overlap_off": generated_off,
        "assemble_refine": refined, "generate_refine": generated_refine,
        "generate_refine_overlap_off": generated_refine_off, "assemble_ar": assembled_ar, "train_denoise": fine_train["denoise"],
        "train_refine": fine_train["refine"], "fine_step_gradients": fine_grads,
        "planted": planted, "assemble_trained": trained_assemble, "assemble_gated": gated,
        "generate_gated": generated_gated["stats"], "reconstruct_eval": reconstructed,
        "assemble_gated_refine": gated_refine, "train_pocket": pocket_train,
        "sample_pocket": pocket_sample, "assemble_fine_bf16": fine_bf16, "allowed": allowed,
        "remat": remat, "data_parallel": dp["report"], "checkpoints": checkpoints,
        "jtnn": jtnn_report, "chem_tools": chem_tools}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
