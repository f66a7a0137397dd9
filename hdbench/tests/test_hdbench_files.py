"""Every cell, configuration, traffic mix and metric of BENCHMARK.json loads
by name from its own file, and the file keeps to the benchmark's format."""

import json
import re
from pathlib import Path

import pytest

from hdbench import run, traffic

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["hdbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    loaded = run.load_cell(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    for key in ("config", "traffic", "chips", "why"):
        assert loaded["workload"][key] == entry[key]
    assert loaded["config"]["name"] == entry["config"]
    assert (ROOT / "hdbench" / "drivers" / f"{loaded['mix']['kind']}.py").is_file()
    assert entry["chips"] == 1
    assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    assert set(loaded["workload"]["limits"]) == set(run.load_cell(cell)["workload"]["limits"])


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    path = ROOT / config["file"]
    data = json.loads(path.read_text())
    assert data["name"] == config["name"]
    assert data["reduced"] == config["reduced"] == []
    assert data["coarse"]["hidden_nf"] == 256 and data["coarse"]["n_layers"] == 6
    assert config["file"].startswith("hdbench/")
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_format(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if metric in BENCH["per_layer"]:
        assert (ROOT / "hdbench" / "metrics" / f"{metric['name']}.py").is_file()
        assert callable(run.load_reader(metric["name"]))
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    else:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    e2e = run.cell_metrics(BENCH, cell, False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert run.cell_metrics(BENCH, cell, True)


def test_names_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [g["name"] for g in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("mix", sorted(p.stem for p in traffic.MIXES.glob("*.json")))
def test_mixes_load(mix):
    assert traffic.load_mix(mix)["kind"]
