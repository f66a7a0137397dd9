"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes
``_build/lib<name>-<hash>.so``, where the hash covers the source, the shared
headers and the flags, so an edited source is never served from a stale
library. All missing libraries are built at once, one nvcc process per
source, started together. The build directory is listed in ``.gitignore``.

``phase_clocks=True`` selects a second build of each source (separate
libraries) with ``-DHD_PHASE_CLOCKS``, which compiles in per-phase cycle
counters; only ``tools/kernel_phases.py`` asks for it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("fused_gcl", "fused_coord", "fused_gcl_bwd")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[Tuple[str, bool], ctypes.CDLL] = {}


def nvcc_flags(phase_clocks: bool = False) -> List[str]:
    return NVCC_FLAGS + ["-DHD_PHASE_CLOCKS"] if phase_clocks else NVCC_FLAGS


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(path).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path(name: str, phase_clocks: bool = False) -> Path:
    digest = hashlib.sha256(" ".join(nvcc_flags(phase_clocks)).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names=SOURCES, phase_clocks: bool = False) -> Dict[str, str]:
    """Compile every library in ``names`` that is not built yet, in
    parallel. Returns nvcc's output (ptxas register and shared-memory
    report) per compiled source; raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n, phase_clocks).exists()]
    procs: List[tuple] = []
    for name in todo:
        out = library_path(name, phase_clocks)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *nvcc_flags(phase_clocks), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = {}, []
    for name, out, tmp, proc in procs:
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load_library(name: str, phase_clocks: bool = False) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if needed.
    Cached per process and build: the sources are hashed once."""
    key = (name, phase_clocks)
    if key not in _loaded:
        path = library_path(name, phase_clocks)
        if not path.exists():
            build_all(phase_clocks=phase_clocks)
        _loaded[key] = ctypes.CDLL(str(path))
    return _loaded[key]
