"""Native host runtime of the port: ctypes bindings over ``treekit.cpp``.

The port's copy of the parts of ``hierdiff_tpu/runtime/__init__.py`` that
training uses: ``treekit_available``, ``dfs_bidirection_native``,
``make_search_adj_native`` and ``pack_denoise_batch_native`` (the edge-denoise
batch packer). ``treekit.cpp`` is built at first use with the system's C++
compiler into ``hierdiff_torch/_build/libtreekit-<hash>.so``, the hash
covering the source and the flags; the library is written to a temporary
file and moved into place, so concurrent builds (test workers) never load a
half-written one. Without a compiler, or when the build fails (its output is
printed once), ``treekit_available()`` is False and callers take their
Python path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "treekit.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_i8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def compiler() -> Optional[str]:
    """The C++ compiler the library is built with, or None."""
    return shutil.which("c++") or shutil.which("g++")


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libtreekit-{digest.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    cxx = compiler()
    if cxx is None:
        print("[runtime] no C++ compiler (c++ / g++): treekit is not built, the Python "
              "packer is used", flush=True)
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        print(f"[runtime] building treekit failed ({cxx}, exit {proc.returncode}); the "
              f"Python packer is used:\n{proc.stdout}{proc.stderr}", flush=True)
        return False
    os.replace(tmp, out)
    return True


def _load() -> Optional[ctypes.CDLL]:
    """The library, built on first use; None when it cannot be built. The
    attempt is made once per process."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = library_path()
    if not path.exists() and not _build(path):
        return None
    lib = ctypes.CDLL(str(path))

    lib.tk_dfs_bidirection.restype = ctypes.c_int32
    lib.tk_dfs_bidirection.argtypes = [
        _f64p, ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64,
        _i8p, ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]

    lib.tk_make_search_adj.restype = None
    lib.tk_make_search_adj.argtypes = [
        _f64p, ctypes.c_int32, _i8p, ctypes.c_int32, ctypes.c_int32,
        _f32p, _f32p]

    lib.tk_pack_denoise_batch.restype = None
    lib.tk_pack_denoise_batch.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64,
        _i32p, _i64p, _i64p, _f32p, _f32p, _f64p, _i64p, ctypes.c_int32,
        _f32p, _f32p, _i32p, _i32p, _f32p, _f32p, _f32p, _f32p, _f32p,
        _i32p, _i32p, _i32p]
    _lib = lib
    return lib


def treekit_available() -> bool:
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("the treekit library is not available (see the build output above)")
    return lib


def dfs_bidirection_native(adj: np.ndarray, seed: int, sample_idx: int = -1):
    """Native ``data.orders.dfs_bidirection``: (undiscovered mask, search_ind,
    last_ind). The mask leaves out the search node, as the Python list does,
    except at the root step (idx 0), where it marks all n nodes."""
    lib = _require()
    n = adj.shape[0]
    adj = np.ascontiguousarray(adj, np.float64)
    umask = np.zeros(n, np.uint8)
    s = ctypes.c_int32()
    last = ctypes.c_int32()
    lib.tk_dfs_bidirection(adj, n, sample_idx, seed, umask, ctypes.byref(s), ctypes.byref(last))
    return umask, int(s.value), int(last.value)


def make_search_adj_native(adj: np.ndarray, umask: np.ndarray, search_ind: int, last_ind: int):
    """Native ``data.orders.make_search_adjacencies``: (org, search) as float32."""
    lib = _require()
    n = adj.shape[0]
    adj = np.ascontiguousarray(adj, np.float64)
    org = np.zeros((n, n), np.float32)
    search = np.zeros((n, n), np.float32)
    lib.tk_make_search_adj(adj, n, np.ascontiguousarray(umask, np.uint8),
                           search_ind, last_ind, org, search)
    return org, search


def pack_denoise_batch_native(trees, max_n: int, seed: int,
                              undiscovered_token: int = 780) -> Dict[str, np.ndarray]:
    """Native equivalent of ``data.denoise.make_denoise_batch`` (full
    softmax): one DFS step per tree from its own mt19937_64 stream, seeded
    from ``seed`` and the tree's index."""
    lib = _require()
    b = len(trees)
    f = trees[0].feats.shape[1]
    sizes = np.array([t.feats.shape[0] for t in trees], np.int32)
    node_offsets = np.zeros(b, np.int64)
    adj_offsets = np.zeros(b, np.int64)
    node_offsets[1:] = np.cumsum(sizes[:-1])
    adj_offsets[1:] = np.cumsum((sizes[:-1].astype(np.int64)) ** 2)
    feats_in = np.ascontiguousarray(np.concatenate([t.feats for t in trees]), np.float32)
    pos_in = np.ascontiguousarray(np.concatenate([t.pos for t in trees]), np.float32)
    adj_in = np.ascontiguousarray(np.concatenate([t.adj.ravel() for t in trees]), np.float64)
    wids_in = np.ascontiguousarray(np.concatenate([t.wids for t in trees]), np.int64)

    out = {
        "feats": np.zeros((b, max_n, f), np.float32),
        "pos": np.zeros((b, max_n, 3), np.float32),
        "discovered": np.zeros((b, max_n), np.int32),
        "vocab_idx": np.zeros((b, max_n), np.int32),
        "node_mask": np.zeros((b, max_n, 1), np.float32),
        "edge_mask": np.zeros((b, max_n, max_n), np.float32),
        "search_adj": np.zeros((b, max_n, max_n), np.float32),
        "focal_label": np.zeros((b, max_n), np.float32),
        "undiscovered": np.zeros((b, max_n), np.float32),
        "predict_idx": np.zeros(b, np.int32),
        "last_ind": np.zeros(b, np.int32),
        "label": np.zeros(b, np.int32),
    }
    lib.tk_pack_denoise_batch(
        b, max_n, f, seed, sizes, node_offsets, adj_offsets,
        feats_in, pos_in, adj_in, wids_in, undiscovered_token,
        out["feats"], out["pos"], out["discovered"], out["vocab_idx"],
        out["node_mask"].reshape(b, max_n), out["edge_mask"],
        out["search_adj"], out["focal_label"], out["undiscovered"],
        out["predict_idx"], out["last_ind"], out["label"])
    return out
