"""``fused_gcl`` of an earlier tree of this repository against this tree's, on one
card, in turns.

    python -m hierdiff_torch.tools.gcl_ab --parent DIR [--reps 20]

DIR is an unpacked earlier tree (``git archive <commit> | tar -x -C DIR``). The
inputs and weights are made once, here, and saved to a temporary file. Each
tree then runs this file with ``--time`` in a process of its own, with that
tree first on the path: it builds its own kernels and calls its own public
wrapper (``ops.egnn_kernels.fused_gcl``), so every tree keeps its own C entry
point and weight layout. The trees take turns: change, parent, parent, change.

Shapes: the kernel shape (B=64, N=32, H=256, E=2, counts uniform in [8, 32])
and the sampler's shape (B=64, GEOM-histogram counts with seed 0, N = their
maximum), each in all four variants (attention on/off x f32/bf16
elementwise). Per tree and case: device ms per call (CUDA events over
``--reps`` calls), host us per call (the wall time to enqueue ``--reps`` calls
with no synchronisation between them: the wrapper's Python, its allocations
and its launches) and the error of out - h against the tree's own plain
version. Prints one JSON line per shape and variant. Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[2]
HIDDEN, EDGE_FEATURES, NORM = 256, 2, 10.0


def make_cases(device: torch.device) -> list:
    """Inputs and weights of every shape and variant, on the CPU."""
    from hierdiff_torch.ops.egnn import DenseGCL
    from hierdiff_torch.tools.kernel_phases import layer_inputs, sampler_counts
    from hierdiff_torch.utils.weights import init_weights

    counts = sampler_counts()
    shapes = {"kernel B=64 N=32": layer_inputs(np.random.default_rng(0), device),
              f"sampler B=64 N={int(counts.max())}": layer_inputs(
                  np.random.default_rng(0), device, n=int(counts.max()), counts=counts)}
    cases = []
    for shape, (h, _, e, _, em, nm, _) in shapes.items():
        for attention in (True, False):
            for cd in (None, "bfloat16"):
                layer = init_weights(DenseGCL(HIDDEN, EDGE_FEATURES, normalization_factor=NORM,
                                              attention=attention, compute_dtype=cd),
                                     torch.Generator().manual_seed(0))
                cases.append({"shape": shape, "attention": attention, "compute_dtype": cd,
                              "state": layer.state_dict(),
                              **{k: v.cpu() for k, v in (("h", h), ("e", e), ("em", em), ("nm", nm))}})
    return cases


def time_cases(path: Path, reps: int) -> list:
    """Run by each tree: its own fused_gcl on the saved cases."""
    from hierdiff_torch.ops import egnn_kernels as ek
    from hierdiff_torch.ops.egnn import DenseGCL

    torch.set_grad_enabled(False)
    device = torch.device("cuda")
    out = []
    for c in torch.load(path):
        layer = DenseGCL(HIDDEN, EDGE_FEATURES, normalization_factor=NORM,
                         attention=c["attention"], compute_dtype=c["compute_dtype"]).to(device)
        layer.load_state_dict(c["state"])
        h, e, em, nm = (c[k].to(device) for k in ("h", "e", "em", "nm"))
        call = lambda: ek.fused_gcl(layer, h, e, em, nm)  # noqa: E731
        ref = ek.gcl_plain(layer, h, e, em, nm) - h
        rel = ((call() - h) - ref).abs().max().item() / (ref.abs().max().item() + 1e-9)
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        host_us = (time.perf_counter() - t0) / reps * 1e6
        end.record()
        torch.cuda.synchronize()
        out.append({"ms": start.elapsed_time(end) / reps, "host_us": host_us, "rel_err": rel})
    return out


def _run_tree(tree: Path, path: Path, reps: int) -> list:
    env = {**os.environ, "PYTHONPATH": str(tree)}
    run = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--time", str(path),
                          "--reps", str(reps)], cwd=tree, env=env, capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"gcl_ab --time failed in {tree}:\n{run.stdout[-2000:]}\n{run.stderr[-2000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def compare(parent: Path, reps: int = 20) -> list:
    """One dict per shape and variant: each tree's ms and host us per call
    (the mean of its two turns), the turns and each tree's error."""
    trees = {"change": HERE, "parent": Path(parent).resolve()}
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "cases.pt"
        cases = make_cases(torch.device("cpu"))
        torch.save(cases, path)
        turns = {"change": [], "parent": []}
        for name in ("change", "parent", "parent", "change"):
            turns[name].append(_run_tree(trees[name], path, reps))
    rows = []
    for i, c in enumerate(cases):
        row = {"shape": c["shape"], "attention": c["attention"],
               "elementwise": c["compute_dtype"] or "float32"}
        for name, runs in turns.items():
            row[f"{name}_ms"] = sum(r[i]["ms"] for r in runs) / len(runs)
            row[f"{name}_host_us"] = sum(r[i]["host_us"] for r in runs) / len(runs)
            row[f"{name}_turns_ms"] = [r[i]["ms"] for r in runs]
            row[f"{name}_rel_err"] = max(r[i]["rel_err"] for r in runs)
        rows.append(row)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, help="unpacked earlier tree")
    ap.add_argument("--time", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gcl_ab: needs a CUDA GPU")
    if args.time is not None:
        print(json.dumps(time_cases(args.time, args.reps)))
        return
    if args.parent is None:
        ap.error("--parent DIR is required")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.splitlines()[0]
    print(card)
    for row in compare(args.parent, args.reps):
        print(json.dumps(row))


if __name__ == "__main__":
    main()
