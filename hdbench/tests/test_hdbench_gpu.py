"""On the card: one short run of each cell prints a correct result line,
and the control (the program's bfloat16 path) fails ``gcl_mol_gap`` at the
cell's own size on three seeds while the program passes. Skips where there
is no CUDA device."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["geom-coarse-sample", "crossdock-pocket-sample"])
def test_cell_runs_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    out = subprocess.run([sys.executable, "-m", "hdbench", "--workload", cell, "--seed",
                          "4294967371", "--seconds", "2", "--trace", "0"], cwd=ROOT,
                         env=dict(os.environ), capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["geom-coarse-sample", "crossdock-pocket-sample"])
def test_control_fails_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    out = subprocess.run([sys.executable, "-m", "hdbench", "--workload", cell, "--seed",
                          "4294967401", "--seconds", "1", "--readings", "3"], cwd=ROOT,
                         env=dict(os.environ), capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    limits = json.loads((ROOT / "hdbench" / "workloads" / f"{cell}.json").read_text())["limits"]
    for row in json.loads(out.stdout.strip().splitlines()[-1])["readings"]:
        assert all(v <= limits[k] for k, v in row["program"].items())
        assert not row["control"]["gcl_mol_gap"] <= limits["gcl_mol_gap"]
