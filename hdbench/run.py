"""Run one benchmark cell once on this machine's card and print its result.

    python3 -m hdbench --workload NAME --seed N --seconds S --trace 0|1

The cell ``NAME`` is ``hdbench/workloads/NAME.json``: its configuration
(``hdbench/configs/<config>.json``), its traffic mix
(``hdbench/traffic/mixes/<traffic>.json``, whose ``kind`` names the driver
of its window, ``hdbench/drivers/<kind>.py``), the chips it needs and the
limits of the numbers that decide ``correct``. ``BENCHMARK.json`` names the
cell's metrics; each per-layer metric is read by
``hdbench/metrics/<metric>.py``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the end-to-end metrics with
``--trace 0``, the per-layer ones with ``--trace 1``), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each compared number
with its limit, also printed as the last lines of standard error.

No result is printed, and the exit code is not 0, when there is no CUDA
device or fewer than the cell needs, and when ``jax``, ``jaxlib``,
``flax`` or ``hierdiff_tpu`` is loaded once the window has closed.

``--readings K`` (no window) prints the program's and the control's
numbers on K seeds from ``--seed`` on: what the limits are set from.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "hierdiff_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is a
    forbidden one, compared whole."""
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    return json.loads(path.read_text())


def load_cell(name: str) -> dict:
    """The workload, its configuration and its traffic mix, by name."""
    from hdbench import traffic

    cell = load_json(HERE / "workloads" / f"{name}.json")
    return {"workload": cell, "config": load_json(HERE / "configs" / f"{cell['config']}.json"),
            "mix": traffic.load_mix(cell["traffic"])}


def cell_metrics(benchmark: dict, name: str, trace: bool) -> list:
    """The metrics a run of cell ``name`` reports: end-to-end ones without
    trace, per-layer ones with it."""
    e2e = [m for m in benchmark["end_to_end"] if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in benchmark["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in moved else [])]


def load_reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"hdbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def gpu_query(fields: str) -> list:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader,nounits"],
                         check=True, capture_output=True, text=True).stdout
    return [v.strip() for v in out.splitlines()[0].split(",")]


class Bench:
    """What a driver gets: the parsed cell, the run's arguments, the
    device, and the set-up clock."""

    def __init__(self, args, cell: dict, device):
        self.args = args
        self.seed, self.seconds, self.trace = args.seed, float(args.seconds), bool(args.trace)
        self.workload, self.config, self.mix = cell["workload"], cell["config"], cell["mix"]
        self.device = device
        self.setup_s = None
        self.sm_clock_hz = self.n_sms = None
        self.card = {}

    def probe_card(self) -> None:
        import torch

        name, limit, clock = gpu_query("name,power.limit,clocks.max.sm")
        self.sm_clock_hz = float(clock) * 1e6
        self.n_sms = torch.cuda.get_device_properties(self.device).multi_processor_count
        self.card = {"smi_name": name, "power_limit_w": float(limit), "max_sm_mhz": float(clock)}

    def card_state(self) -> dict:
        """The card's SM clock, power draw and temperature now: read as the
        window closes, beside its numbers."""
        if self.device.type != "cuda":
            return {}
        clock, power, temp = gpu_query("clocks.sm,power.draw,temperature.gpu")
        return {"sm_clock_mhz": float(clock), "power_w": float(power), "temperature_c": float(temp)}

    def setup_done(self) -> None:
        """Set-up ends: what it made is kept out of the collector's later
        passes, so the window pays no scans of the harness's own objects."""
        gc.collect()
        gc.freeze()
        self.setup_s = time.perf_counter() - T_PROCESS

    def memory_peak(self) -> int:
        import torch

        return int(torch.cuda.max_memory_allocated(self.device)) if self.device.type == "cuda" else 0


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m hdbench", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--readings", type=int, default=0,
                    help="print the program's and the control's numbers on this many seeds")
    return ap.parse_args(argv)


def finish(result: dict, checks: dict, limits: dict) -> int:
    """Print the checks on stderr and the result's line on stdout."""
    rows = {k: {"value": v, "limit": limits.get(k)} for k, v in checks.items()}
    for k, row in rows.items():
        print(f"check {k}: {row['value']!r} (limit {row['limit']!r})", file=sys.stderr)
    result["checks"] = rows
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    cell = load_cell(args.workload)
    benchmark = load_json(ROOT / "BENCHMARK.json")

    import torch

    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"hdbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)    # one process, few threads: the card does the work
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    bench = Bench(args, cell, device)
    bench.probe_card()
    return execute(bench, benchmark)


def execute(bench: Bench, benchmark: dict) -> int:
    """Everything after the look for the card: the driver's run, the check
    for forbidden modules, the metrics and the result's line."""
    import torch

    args = bench.args
    driver = importlib.import_module(f"hdbench.drivers.{bench.mix['kind']}")
    if args.readings:
        rows = driver.readings(bench, list(range(args.seed, args.seed + args.readings)))
        print(json.dumps({"readings": rows, "card": bench.card}), flush=True)
        return 0

    out = driver.run(bench)
    found = forbidden_modules()
    if found:
        print(f"hdbench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3

    limits = bench.workload["limits"]
    checks = out["checks"]
    correct = all(k in limits and v == v and v <= limits[k] for k, v in checks.items())
    metrics = {}
    if bench.trace:
        ctx = out["layer"]
        for m in cell_metrics(benchmark, args.workload, True):
            value = load_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["e2e"], setup_s=bench.setup_s)
        for m in cell_metrics(benchmark, args.workload, False):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    on_card = bench.device.type == "cuda"
    device = {"platform": "gpu" if on_card else bench.device.type,
              "kind": torch.cuda.get_device_name(bench.device) if on_card else "cpu",
              "count": int(bench.workload["chips"]),
              "memory_peak_bytes": out["memory_peak_bytes"],
              "power_limit_w": bench.card.get("power_limit_w"), **out["card_state"]}
    result = {"correct": bool(correct and out["failed"] == 0), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if bench.trace:
        tr = out["trace"]
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    return finish(result, checks, limits)


if __name__ == "__main__":
    sys.exit(main())
