"""A whole run of each cell on the CPU at a tiny size, past the harness's
look for a card: sound, it comes out correct; with the timed path broken
underneath it comes out not correct, once for each fault the cell can have
(a step that leaves its state unchanged; half of the batch left out, the
mean taken over the rest; an answer altered where it is produced; one chip,
so no exchange between chips). The control, the program with its bfloat16
path switched on, fails too."""

import copy
import json

import pytest
import torch

from hdbench import run
from hdbench.drivers import coarse_sample

CPU = torch.device("cpu")
TINY = {"hidden_nf": 32, "n_layers": 2, "timesteps": 12}


def tiny_bench(cell: str, seed: int = 2 ** 31 + 21):
    args = run.parse(["--workload", cell, "--seed", str(seed), "--seconds", "0.001"])
    loaded = copy.deepcopy(run.load_cell(cell))
    loaded["config"]["coarse"].update(TINY)
    mix = loaded["mix"]
    mix.update(batch=6, checked_steps=2)
    if "pocket_residues" in mix:
        mix["pocket_residues"] = 4
    return run.Bench(args, loaded, CPU)


def result(capsys, bench) -> dict:
    assert run.execute(bench, run.load_json(run.ROOT / "BENCHMARK.json")) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def sampling_fault(monkeypatch, fault: str):
    base = coarse_sample.CoarseSampling

    class Broken(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            tap, rows = self.tap, self.rows
            if fault == "unchanged":
                step = tap.step_fn

                def step_fn(z, *a, **k):
                    mu, sigma = step(z, *a, **k)
                    return z[:, :rows].clone(), torch.zeros_like(sigma)
                tap.step_fn = step_fn
            elif fault == "half_batch":
                phi = tap.phi_fn

                def phi_fn(*a, **k):
                    out = phi(*a, **k).clone()
                    out[out.shape[0] // 2:] = 0.0
                    return out
                tap.phi_fn = phi_fn
            elif fault == "altered":
                final = tap.final_fn

                def final_fn(*a, **k):
                    mu, sigma = final(*a, **k)
                    mu = mu.clone()
                    mu[0, 0, 0] += 0.5
                    return mu, sigma
                tap.final_fn = final_fn

    monkeypatch.setattr(coarse_sample, "CoarseSampling", Broken)


CELLS = ["geom-coarse-sample", "crossdock-pocket-sample"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, capsys):
    out = result(capsys, tiny_bench(cell))
    assert out["correct"] is True, out["checks"]
    assert list(out)[-1] == "checks" and out["attempted"] >= 1
    assert set(out["metrics"]) >= {"setup_s"}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_fault_is_not_correct(cell, fault, monkeypatch, capsys):
    sampling_fault(monkeypatch, fault)
    out = result(capsys, tiny_bench(cell))
    assert out["correct"] is False, (fault, out["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    bench = tiny_bench(cell)
    limits = bench.workload["limits"]
    row = coarse_sample.readings(bench, [bench.seed])[0]
    assert all(v <= limits[k] for k, v in row["program"].items() if k in limits)
    assert any(not v <= limits[k] for k, v in row["control"].items() if k in limits)
