"""The training phases of chip_smoke.py in an earlier tree against this one, in turns.

    python -m hierdiff_torch.tools.phase_ab --parent DIR [--pairs 2] [--csv-only-too]

DIR is an unpacked earlier tree of this repository (``git archive <commit> |
tar -x -C DIR``). Each run is a fresh process in one tree that runs that
tree's own code: 4b's ``train.cli coarse`` (GEOM, bf16 elementwise, batch
64, a synthetic pool of 512 trees, 20 steps, two evaluations), then phases
4i and 4j (``chip_smoke.fine_train_phase``: ``train.cli denoise`` /
``refine`` at their GEOM configurations for 20 steps, then one profiled step
per bucket and, for denoise, the packer's host times). Per run it prints one
JSON line: each phase's wall seconds, the train CLI's seconds and its
steps/s after the first step. Pairs alternate which tree goes first.
``--csv-only-too`` adds one run of this tree with ``torch.utils.tensorboard``
made unimportable, so that its trainers log to CSV alone. Needs a CUDA GPU;
each tree builds its own kernels.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[2]

RUN = r"""
import json, sys, tempfile, time
from pathlib import Path
if {csv_only}:
    sys.modules["torch.utils.tensorboard"] = None   # its import now raises
sys.path.insert(0, ".")
import torch
import chip_smoke
from hierdiff_torch.ops import egnn_kernels as ek
from hierdiff_torch.train import cli as train_cli

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
out = {{}}
with tempfile.TemporaryDirectory() as tmp:
    t0 = time.perf_counter()
    run = train_cli.main(["coarse", "--init-seed", "0", f"train.workdir={{tmp}}/coarse",
                          "coarse.compute_dtype=bfloat16", "train.batch_size=64",
                          "train.num_train_trees=512", "train.max_steps=20", "train.log_every=1",
                          "train.eval_every=10", "train.checkpoint_every=1000",
                          f"train.seed={{chip_smoke.SEED}}"])
    torch.cuda.synchronize()
    out["4b"] = {{"phase_seconds": time.perf_counter() - t0, "seconds": run["seconds"],
                 "steps_per_sec": run["steps_per_sec"]}}
    for name, stage in (("4i", "denoise"), ("4j", "refine")):
        r = chip_smoke.fine_train_phase(train_cli, ek, stage, Path(tmp) / stage,
                                        torch.device("cuda"))
        out[name] = {{k: r[k] for k in ("phase_seconds", "seconds", "steps_per_sec")}}
print("RESULT " + json.dumps(out))
"""


def run_tree(tree: Path, csv_only: bool = False) -> dict:
    """One fresh process of ``tree``: {phase: {phase_seconds, seconds, steps_per_sec}}."""
    out = subprocess.run([sys.executable, "-c", RUN.format(csv_only=csv_only)], cwd=tree,
                         capture_output=True, text=True)
    lines = [l for l in out.stdout.splitlines() if l.startswith("RESULT ")]
    if out.returncode != 0 or not lines:
        raise RuntimeError(f"run in {tree} failed:\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, type=Path, help="unpacked earlier tree")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--csv-only-too", action="store_true",
                    help="one more run of this tree with TensorBoard unimportable")
    args = ap.parse_args(argv)
    trees = {"parent": args.parent.resolve(), "change": HERE}
    runs = {name: [] for name in trees}
    for i in range(args.pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        for name in order:
            res = run_tree(trees[name])
            runs[name].append(res)
            print(json.dumps({"pair": i, "tree": name, **res}), flush=True)
    if args.csv_only_too:
        res = run_tree(HERE, csv_only=True)
        runs["change, CSV only"] = [res]
        print(json.dumps({"tree": "change, CSV only", **res}), flush=True)
    summary = {name: {phase: {k: float(np.median([r[phase][k] for r in rs])) for k in rs[0][phase]}
                      for phase in rs[0]}
               for name, rs in runs.items()}
    print(json.dumps({"medians": summary}))


if __name__ == "__main__":
    main()
