"""Nothing the harness loads is JAX or the JAX package; the reference loads
nothing of the port; the harness fails without a card and without the
program."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HARNESS = ROOT / "hdbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "hierdiff_tpu")


def _python(code: str, cwd: Path = ROOT) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(cwd))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def _top_names(stdout: str) -> set:
    return set(json.loads(stdout.strip().splitlines()[-1]))


def test_harness_modules_load_no_jax():
    code = ("import sys, json, importlib\n"
            "from hdbench import run, trace, roofline, traffic, weights\n"
            "importlib.import_module('hdbench.drivers.coarse_sample')\n"
            "b = run.load_json(run.ROOT / 'BENCHMARK.json')\n"
            "for m in b['per_layer']:\n"
            "    run.load_reader(m['name'])\n"
            "import hierdiff_torch.sampling.cli, hierdiff_torch.sampling.coarse\n"
            "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert not _top_names(out.stdout) & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_port():
    code = ("import sys, json\n"
            "import hdbench.reference.coarse, hdbench.reference.sample_check\n"
            "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    names = _top_names(out.stdout)
    assert "hierdiff_torch" not in names and not names & set(FORBIDDEN)
    for path in (HARNESS / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module]
                for mod in mods:
                    assert mod.split(".")[0] in ("torch", "math", "typing", "__future__", "hdbench"), \
                        f"{path.name} imports {mod}"
                    if mod.startswith("hdbench"):
                        assert mod.startswith("hdbench.reference"), f"{path.name} imports {mod}"


def test_forbidden_check_compares_whole_names():
    from hdbench import run

    sys.modules["jaxlike_probe"] = sys
    try:
        assert "jaxlike_probe" not in run.forbidden_modules()
    finally:
        del sys.modules["jaxlike_probe"]


def _cli(cwd: Path) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH="", CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", "hdbench", "--workload", "geom-coarse-sample",
                           "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_fails_without_a_card():
    out = _cli(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_fails_beside_nothing_but_itself(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HARNESS, tmp_path / "hdbench",
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
