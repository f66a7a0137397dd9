"""The sampling and training CLIs of an earlier tree against this one, in turns.

    python -m hierdiff_torch.tools.cli_ab --parent DIR [--pairs 5]

DIR is an unpacked earlier tree of this repository (``git archive <commit> |
tar -x -C DIR``). Each pair runs the same command in both trees, alternating
which goes first: ``sampling.cli coarse`` at the GEOM configuration (random
weights from --init-seed 0, 2 batches of 64, 100 strided steps; molecules/s)
and ``train.cli coarse`` (bf16 elementwise, batch 64, a synthetic pool of 512
trees, 20 steps; steps/s after the first step), as ``chip_smoke.py`` phases 4
and 4b run them. Prints one JSON line per run, then the median and quartiles
of each metric per tree. Needs a CUDA GPU; each tree builds its own kernels.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[2]


def _run(tree: Path, args) -> str:
    out = subprocess.run([sys.executable, "-m", *args], cwd=tree, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{args[0]} failed in {tree}:\n{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
    return out.stdout


def sample_rate(tree: Path, tmp: Path) -> float:
    """molecules/s of one 2 x 64, 100-step sampling run."""
    out = _run(tree, ["hierdiff_torch.sampling.cli", "coarse", "--init-seed", "0", "--num", "128",
                      "--batch-size", "64", "--steps", "100", "--seed", "0",
                      "--out", str(tmp / "samples.pkl")])
    return float(re.search(r"\(([\d.]+) molecules/s", out).group(1))


def train_rate(tree: Path, tmp: Path) -> float:
    """steps/s after the first step of one 20-step training run (a fresh workdir)."""
    workdir = Path(tempfile.mkdtemp(dir=tmp))
    out = _run(tree, ["hierdiff_torch.train.cli", "coarse", "--init-seed", "0",
                      f"train.workdir={workdir}", "coarse.compute_dtype=bfloat16",
                      "train.batch_size=64", "train.num_train_trees=512", "train.max_steps=20",
                      "train.log_every=1", "train.eval_every=10", "train.checkpoint_every=1000",
                      "train.seed=0"])
    return float(re.search(r"after the first step ([\d.]+) steps/s", out).group(1))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, type=Path, help="unpacked earlier tree")
    ap.add_argument("--pairs", type=int, default=5)
    args = ap.parse_args(argv)
    trees = {"parent": args.parent.resolve(), "change": HERE}
    runs = {(t, m): [] for t in trees for m in ("molecules_per_s", "train_steps_per_s")}
    with tempfile.TemporaryDirectory() as tmp:
        for metric, fn in (("molecules_per_s", sample_rate), ("train_steps_per_s", train_rate)):
            for tree in trees.values():   # first runs build the kernels; not counted
                fn(tree, Path(tmp))
            for i in range(args.pairs):
                order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
                for name in order:
                    value = fn(trees[name], Path(tmp))
                    runs[(name, metric)].append(value)
                    print(json.dumps({"pair": i, "tree": name, metric: value}), flush=True)
    summary = {f"{name} {metric}": {"median": float(np.median(v)),
                                     "quartiles": [float(q) for q in np.percentile(v, [25, 75])],
                                     "runs": v}
               for (name, metric), v in runs.items()}
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
