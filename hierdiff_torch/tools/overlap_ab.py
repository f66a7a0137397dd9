"""``generate`` with its stages overlapped against one after the other, in turns.

    python -m hierdiff_torch.tools.overlap_ab [--pairs 3] [--num 64] [--refine]

Each pair runs ``sampling.cli generate`` at the GEOM configuration (random
weights from seed 0, 100 strided coarse steps, beam 5; with ``--refine``
the refine model's checks too) once as it is (overlapped) and once under
``serial_stages`` (one stage after the other), in one process after one
unrecorded warm-up run,
alternating which goes first. Prints the card's name and power limit, one
JSON line per run (molecules/s, ``t_coarse``, ``t_fine``, the refine hook's
counters) and the quartiles of each metric per mode, and fails if a pair's
point sets or trees differ. Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import subprocess
import tempfile
from pathlib import Path

import numpy as np


@contextlib.contextmanager
def serial_stages():
    """Within the block, ``GenerationPipeline.run`` runs its stages one
    after the other (``overlap=False``), so that ``sampling.cli generate``,
    which always overlaps, can be driven both ways."""
    from hierdiff_torch.sampling.pipeline import GenerationPipeline

    run = GenerationPipeline.run
    GenerationPipeline.run = functools.partialmethod(run, overlap=False)
    try:
        yield
    finally:
        GenerationPipeline.run = run


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--num", type=int, default=64)
    ap.add_argument("--refine", action="store_true", help="the refine model's checks too")
    args = ap.parse_args(argv)
    from hierdiff_torch.sampling import cli

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True
                         ).stdout.strip().splitlines()[0])
    rows = {"on": [], "off": []}
    with tempfile.TemporaryDirectory() as tmp:
        def generate(mode: str):
            with serial_stages() if mode == "off" else contextlib.nullcontext():
                return cli.main(["generate", "--init-seed", "0", "--denoise-init-seed", "0",
                                 *(["--refine-init-seed", "0"] if args.refine else []),
                                 "--num", str(args.num), "--sample-steps", "100", "--beam", "5",
                                 "--seed", "0", "--out", str(Path(tmp) / f"{mode}.pkl")])

        generate("off")   # warm-up, not recorded: the kernels' build and first calls
        for pair in range(args.pairs):
            order = ("on", "off") if pair % 2 == 0 else ("off", "on")
            runs = {}
            for mode in order:
                run = generate(mode)
                result = run["result"]
                hook = run["pipeline"].sampler.refine_hook
                row = {"pair": pair, "overlap": mode, "molecules_per_s": args.num / run["seconds"],
                       "seconds": run["seconds"], "t_coarse": result.stats["t_coarse"],
                       "t_fine": result.stats["t_fine"],
                       "refine": None if hook is None else dict(hook.stats)}
                print(json.dumps(row), flush=True)
                rows[mode].append(row)
                runs[mode] = result
            same = all(np.array_equal(a["x"], b["x"]) for a, b in
                       zip(runs["on"].blur, runs["off"].blur)) and all(
                (a is None) == (b is None) and (a is None or (
                    np.array_equal(a.wids, b.wids) and a.logp == b.logp))
                for a, b in zip(runs["on"].trees, runs["off"].trees))
            if not same:
                raise SystemExit(f"pair {pair}: the overlapped run differs from the serial one")
    summary = {}
    for mode, rs in rows.items():
        summary[mode] = {k: [float(np.percentile([r[k] for r in rs], q)) for q in (25, 50, 75)]
                         for k in ("molecules_per_s", "t_coarse", "t_fine")}
    print(json.dumps({"refine": args.refine, "num": args.num, "pairs": args.pairs,
                      "quartiles_25_50_75": summary}))


if __name__ == "__main__":
    main()
