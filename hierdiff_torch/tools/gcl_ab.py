"""A kernel of an earlier tree of this repository against this tree's, on one
card, in turns.

    python -m hierdiff_torch.tools.gcl_ab --parent DIR [--kernel fused_gcl] [--reps 20]

``--kernel`` is ``fused_gcl`` (the default), ``fused_coord_update`` or
``fused_gcl_bwd``. DIR is an unpacked earlier tree (``git archive <commit> |
tar -x -C DIR``). The inputs and weights are made once, here, and saved to a
temporary file. Each tree then runs this file with ``--time`` in a process of
its own, with that tree first on the path: it builds its own kernels and calls
its own public wrapper (``ops.egnn_kernels.fused_gcl``, ``.fused_coord_update``
or ``.fused_gcl_bwd`` after its own forward's residual, whose signatures every
tree shares), so every tree keeps its own C entry point and weight layout. The
trees take turns: change, parent, parent, change.

Shapes: the kernel shape (B=64, N=32, H=256, E=2, counts uniform in [8, 32]),
the sampler's shape (B=64, GEOM-histogram counts with seed 0, N = their
maximum) and the two sampling cells' shapes (``kernel_phases.cell_inputs``:
256 GEOM molecules in 35 rows; 64 CrossDocked molecules and a 32-residue
pocket with cross edges in 67 rows), each in all four variants (attention
on/off for ``fused_gcl``, tanh on/off for ``fused_coord_update``, x f32/bf16
elementwise). Per tree and case: device ms per call (CUDA events over
``--reps`` calls queued behind a sleeping kernel, ``device_ms``), host us per
call (the wall time to enqueue them: the wrapper's Python, its allocations
and its launches) and the error against the tree's own plain version: of
what the layer adds to its input (out - h, out - x), or the worst over the
gradients of the backward (against a seeded upstream gradient). Each turn
saves its outputs beside the shared inputs (``fused_gcl``: out and the
aggregated messages agg; ``fused_coord_update``: out; the backward: its
gradients), and each case reports whether the change's equal the parent's
bit for bit (``bitwise_parent``) and each tree's two turns each other's
(``bitwise_repeat``). Prints one JSON line per shape and variant. Needs a
CUDA GPU.
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
from typing import Optional

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[2]
HIDDEN, EDGE_FEATURES, NORM = 256, 2, 10.0
COORDS_RANGE = 5.0
KERNELS = ("fused_gcl", "fused_coord_update", "fused_gcl_bwd")
# the variant's flag: the gate of the GCL, tanh of the coordinate update
FLAG = {"fused_gcl": "attention", "fused_coord_update": "tanh", "fused_gcl_bwd": "attention"}


def _layer(kernel: str, flag: bool, compute_dtype):
    from hierdiff_torch.ops.egnn import DenseEquivariantUpdate, DenseGCL

    if kernel != "fused_coord_update":
        return DenseGCL(HIDDEN, EDGE_FEATURES, normalization_factor=NORM, attention=flag,
                        compute_dtype=compute_dtype)
    return DenseEquivariantUpdate(HIDDEN, EDGE_FEATURES, normalization_factor=NORM, tanh=flag,
                                  coords_range=COORDS_RANGE, compute_dtype=compute_dtype)


def make_cases(device: torch.device, kernel: str = "fused_gcl") -> list:
    """Inputs and weights of every shape and variant, on the CPU."""
    from hierdiff_torch.tools.kernel_phases import (CELLS, cell_inputs, cell_shape, layer_inputs,
                                                    sampler_counts)
    from hierdiff_torch.utils.weights import init_weights

    counts = sampler_counts()
    shapes = {"kernel B=64 N=32": layer_inputs(np.random.default_rng(0), device),
              f"sampler B=64 N={int(counts.max())}": layer_inputs(
                  np.random.default_rng(0), device, n=int(counts.max()), counts=counts)}
    shapes.update({cell_shape(c): cell_inputs(np.random.default_rng(0), device, c) for c in CELLS})
    cases = []
    for shape, (h, x, e, cdiff, em, nm, _) in shapes.items():
        g = torch.from_numpy(np.random.default_rng(1).standard_normal(
            tuple(h.shape)).astype(np.float32))
        for flag in (True, False):
            for cd in (None, "bfloat16"):
                layer = init_weights(_layer(kernel, flag, cd), torch.Generator().manual_seed(0))
                cases.append({"kernel": kernel, "shape": shape, FLAG[kernel]: flag,
                              "compute_dtype": cd, "state": layer.state_dict(),
                              **{k: v.cpu() for k, v in (("h", h), ("x", x), ("e", e),
                                                         ("cdiff", cdiff), ("em", em), ("nm", nm))},
                              "g": g})
    return cases


def _calls(ek, kernel: str, layer, c: dict):
    """The kernel's call, its plain version's and the input that both add to
    (None for the backward, whose outputs are gradients)."""
    h, x, e, cdiff, em, nm, g = (c[k] for k in ("h", "x", "e", "cdiff", "em", "nm", "g"))
    if kernel == "fused_gcl":
        return (lambda: ek.fused_gcl(layer, h, e, em, nm),
                lambda: ek.gcl_plain(layer, h, e, em, nm), h)
    if kernel == "fused_gcl_bwd":
        agg = torch.empty_like(h)   # the forward's residual, as FusedGCLFunction saves it
        ek._launch_gcl(layer, h, e, em, nm, h.device, agg_out=agg)
        return (lambda: ek.fused_gcl_bwd(layer, h, e, em, nm, g, agg),
                lambda: ek.gcl_plain_vjp(layer, h, e, em, nm, g), None)
    return (lambda: ek.fused_coord_update(layer, h, e, cdiff, x, em, nm),
            lambda: ek.coord_update_plain(layer, h, e, cdiff, x, em, nm), x)


def _rel_err(out, ref, base) -> float:
    """Max error over the largest plain value: of what the layer adds to
    ``base``, or (``base`` None) the worst over the gradients."""
    if base is None:
        return max(((a - r).abs().max() / (r.abs().max() + 1e-9)).item()
                   for a, r in zip(out, ref) if a is not None and r is not None)
    out, ref = out - base, ref - base
    return ((out - ref).abs().max() / (ref.abs().max() + 1e-9)).item()


def _outputs(ek, kernel: str, layer, c: dict, call) -> list:
    """What a case's call leaves, on the CPU: fused_gcl's out and agg (the
    aggregated messages, which the training forward keeps for the
    backward), the coordinate update's out, the backward's gradients."""
    if kernel == "fused_gcl":
        agg = torch.empty_like(c["h"])
        out = ek._launch_gcl(layer, c["h"], c["e"], c["em"], c["nm"], c["h"].device, agg_out=agg)
        return [out.cpu(), agg.cpu()]
    got = call()
    return [t.cpu() for t in (got if kernel == "fused_gcl_bwd" else [got]) if t is not None]


def time_cases(path: Path, reps: int, save: Optional[Path] = None) -> list:
    """Run by each tree: its own kernel wrapper on the saved cases; with
    ``save``, each case's outputs (``_outputs``) are saved there."""
    from hierdiff_torch.ops import egnn_kernels as ek

    torch.set_grad_enabled(False)
    device = torch.device("cuda")
    out, saved = [], []
    for c in torch.load(path):
        kernel = c["kernel"]
        layer = _layer(kernel, c[FLAG[kernel]], c["compute_dtype"]).to(device)
        layer.load_state_dict(c["state"])
        c_dev = {k: c[k].to(device) for k in ("h", "x", "e", "cdiff", "em", "nm", "g")}
        call, plain, base = _calls(ek, kernel, layer, c_dev)
        rel = _rel_err(call(), plain(), base)
        ms, host_s = device_ms(call, reps)
        out.append({"ms": ms, "host_us": host_s / reps * 1e6, "rel_err": rel})
        if save is not None:
            saved.append(_outputs(ek, kernel, layer, c_dev, call))
    if save is not None:
        torch.save(saved, save)
    return out


def bitwise_equal(a: list, b: list) -> bool:
    """Whether two cases' saved outputs are equal bit for bit (float32
    compared by bit pattern, so -0 differs from 0 and a NaN equals only the
    same NaN)."""
    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                        y.view(torch.int32) if y.dtype == torch.float32 else y)
        for x, y in zip(a, b))


# cycles of the sleeping kernel that holds the device while the timed calls
# are queued: 10^8 cycles is 50 ms at 1.98 GHz, far above the enqueue time of
# 20 calls, so the calls then run back to back with no host gaps between them
SLEEP_CYCLES = 10 ** 8


def device_ms(fn, reps: int = 20, warmup: int = 3):
    """(device ms per call, host seconds to enqueue the ``reps`` calls): CUDA
    events around ``reps`` calls queued behind a sleeping kernel. Without
    the sleep, a call whose host time exceeds its device time would be
    timed by its host. Raises if the enqueue outlasted the sleep."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sleep_start = torch.cuda.Event(enable_timing=True)
    sleep_start.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    if host_s * 1e3 > sleep_start.elapsed_time(start):
        raise RuntimeError(f"enqueueing {reps} calls took {host_s * 1e3:.1f} ms, longer than the "
                           f"{sleep_start.elapsed_time(start):.1f} ms sleep: raise SLEEP_CYCLES")
    return start.elapsed_time(end) / reps, host_s


def _run_tree(tree: Path, path: Path, reps: int, save: Path) -> list:
    env = {**os.environ, "PYTHONPATH": str(tree)}
    run = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--time", str(path),
                          "--reps", str(reps), "--save", str(save)], cwd=tree, env=env,
                         capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"gcl_ab --time failed in {tree}:\n{run.stdout[-2000:]}\n{run.stderr[-2000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def compare(parent: Path, reps: int = 20, kernel: str = "fused_gcl") -> list:
    """One dict per shape and variant: each tree's ms and host us per call
    (the mean of its two turns), the turns, each tree's error, and whether
    the outputs equal the parent's and repeat, bit for bit."""
    trees = {"change": HERE, "parent": Path(parent).resolve()}
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "cases.pt"
        cases = make_cases(torch.device("cpu"), kernel)
        torch.save(cases, path)
        turns = {"change": [], "parent": []}
        outputs = {"change": [], "parent": []}
        for turn, name in enumerate(("change", "parent", "parent", "change")):
            save = Path(tmp) / f"outputs-{name}-{turn}.pt"
            turns[name].append(_run_tree(trees[name], path, reps, save))
            outputs[name].append(torch.load(save))
    rows = []
    for i, c in enumerate(cases):
        row = {"kernel": kernel, "shape": c["shape"], FLAG[kernel]: c[FLAG[kernel]],
               "elementwise": c["compute_dtype"] or "float32"}
        for name, runs in turns.items():
            row[f"{name}_ms"] = sum(r[i]["ms"] for r in runs) / len(runs)
            row[f"{name}_host_us"] = sum(r[i]["host_us"] for r in runs) / len(runs)
            row[f"{name}_turns_ms"] = [r[i]["ms"] for r in runs]
            row[f"{name}_rel_err"] = max(r[i]["rel_err"] for r in runs)
        row["bitwise_parent"] = bitwise_equal(outputs["change"][0][i], outputs["parent"][0][i])
        row["bitwise_repeat"] = all(bitwise_equal(o[0][i], o[1][i]) for o in outputs.values())
        rows.append(row)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, help="unpacked earlier tree")
    ap.add_argument("--kernel", choices=KERNELS, default="fused_gcl")
    ap.add_argument("--time", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--save", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gcl_ab: needs a CUDA GPU")
    if args.time is not None:
        print(json.dumps(time_cases(args.time, args.reps, args.save)))
        return
    if args.parent is None:
        ap.error("--parent DIR is required")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.splitlines()[0]
    print(card)
    for row in compare(args.parent, args.reps, args.kernel):
        print(json.dumps(row))


if __name__ == "__main__":
    main()
