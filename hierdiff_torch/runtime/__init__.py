"""Native host runtime of the port: ctypes bindings over ``treekit.cpp``.

The port's copy of ``hierdiff_tpu/runtime/__init__.py``: the training
packers (``dfs_bidirection_native``, ``make_search_adj_native``,
``pack_denoise_batch_native``), the round-based sampler's fleet packer
(``pack_ar_fleet_native``) and the fine stage's native beam searches over
precomputed lattices (``beam_search_lattice_native``, refine off, ungated or
gated; ``NativeRefineSearch``, refine on). ``treekit.cpp`` is built at first use with the system's C++
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
_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
# verdict callback of the gated searches: (wid, neighbour-wid ptr, count) -> 0/1
_GATE_CB = ctypes.CFUNCTYPE(ctypes.c_int32, ctypes.c_int64,
                            ctypes.POINTER(ctypes.c_int64), ctypes.c_int32)

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
              "packers and searches are used", flush=True)
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        print(f"[runtime] building treekit failed ({cxx}, exit {proc.returncode}); the "
              f"Python packers and searches are used:\n{proc.stdout}{proc.stderr}", flush=True)
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

    lib.tk_pack_ar_fleet.restype = None
    lib.tk_pack_ar_fleet.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        _i32p, _i64p, _f32p, _f32p, _f32p, _i64p, _i64p, ctypes.c_int32,
        _f32p, _f32p, _f32p, _i32p, _i32p, _f32p]

    lib.tk_beam_search_lattice.restype = None
    lib.tk_beam_search_lattice.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        _i32p, _i64p, _i32p, _i32p, _i8p, _i64p, _f32p,
        _u32p, ctypes.POINTER(ctypes.c_int32), _i64p, _i8p, _f64p]

    lib.tk_beam_search_lattice_gated.restype = None
    lib.tk_beam_search_lattice_gated.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        _i32p, _i64p, _i32p, _i32p, _i8p, _i64p, _f32p,
        _u32p, ctypes.POINTER(ctypes.c_int32), _GATE_CB, ctypes.c_int32,
        _i64p, _i8p, _f64p]

    lib.tk_rsearch_create.restype = ctypes.c_void_p
    lib.tk_rsearch_create.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_double,
        _i32p, _i64p, _i32p, _i32p, _i8p, _i64p, _f32p,
        _u32p, ctypes.c_int32, _GATE_CB, _GATE_CB, ctypes.c_int32]

    lib.tk_rsearch_step.restype = ctypes.c_int32
    lib.tk_rsearch_step.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        _i32p, _i64p, _f32p]

    lib.tk_rsearch_finish.restype = None
    lib.tk_rsearch_finish.argtypes = [
        ctypes.c_void_p, _u32p, ctypes.POINTER(ctypes.c_int32),
        _i64p, _i8p, _f64p]

    lib.tk_rsearch_destroy.restype = None
    lib.tk_rsearch_destroy.argtypes = [ctypes.c_void_p]
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


def pack_ar_fleet_native(states, max_n: int, undiscovered_token: int = 780):
    """Native equivalent of the Python fleet packing of
    ``sampling.ar.DeviceExpander._batch_step``: (feats, pos, adj, vocab,
    discovered, node mask), each padded to ``max_n`` nodes."""
    lib = _require()
    b = len(states)
    f = states[0].feats.shape[1]
    sizes = np.array([s.n for s in states], np.int32)
    node_offsets = np.zeros(b, np.int64)
    adj_offsets = np.zeros(b, np.int64)
    node_offsets[1:] = np.cumsum(sizes[:-1])
    adj_offsets[1:] = np.cumsum((sizes[:-1].astype(np.int64)) ** 2)
    feats_in = np.ascontiguousarray(np.concatenate([s.feats for s in states]), np.float32)
    pos_in = np.ascontiguousarray(np.concatenate([s.pos for s in states]), np.float32)
    adj_in = np.ascontiguousarray(
        np.concatenate([s.adj.astype(np.float32).ravel() for s in states]), np.float32)
    wids_in = np.ascontiguousarray(np.concatenate([s.wids for s in states]), np.int64)

    feats = np.zeros((b, max_n, f), np.float32)
    pos = np.zeros((b, max_n, 3), np.float32)
    adj = np.zeros((b, max_n, max_n), np.float32)
    vocab = np.zeros((b, max_n), np.int32)
    disc = np.zeros((b, max_n), np.int32)
    nmask = np.zeros((b, max_n, 1), np.float32)
    lib.tk_pack_ar_fleet(b, max_n, f, sizes, node_offsets, feats_in, pos_in,
                         adj_in, adj_offsets, wids_in, undiscovered_token,
                         feats, pos, adj, vocab, disc, nmask.reshape(b, max_n))
    return feats, pos, adj, vocab, disc, nmask


def _flat_lattices(lattices, keys, sizes32):
    """The lattices of ``keys`` trimmed to their sizes and concatenated, as
    the C searches read them: focal, target, attach, top_wid, top_logp."""
    trim = [(lattices[i], int(n)) for i, n in zip(keys, sizes32)]
    return (np.ascontiguousarray(np.concatenate([l.focal[:n] for l, n in trim]), np.int32),
            np.ascontiguousarray(np.concatenate([l.target[:n] for l, n in trim]), np.int32),
            np.ascontiguousarray(np.concatenate([l.attach[:n] for l, n in trim]), np.uint8),
            np.ascontiguousarray(np.concatenate([l.top_wid[:n] for l, n in trim]), np.int64),
            np.ascontiguousarray(np.concatenate([l.top_logp[:n] for l, n in trim]),
                                 np.float32))


def _wrap_verdict(verdict, cb_error: list):
    """``verdict(wid, sorted neighbour wids) -> bool`` as the C searches'
    gate callback. ctypes swallows an exception raised in a callback and
    returns an undefined int, which would corrupt the search and poison the
    native memo: the first exception is stashed in ``cb_error`` (the gate
    then fails) and the caller re-raises it after the native call returns."""
    if verdict is None:
        return ctypes.cast(None, _GATE_CB)

    @_GATE_CB
    def _cb(wid, neis, n_nei):
        if cb_error:
            return 0
        try:
            return 1 if verdict(int(wid), tuple(neis[i] for i in range(n_nei))) else 0
        except BaseException as e:   # noqa: BLE001 -- re-raised by the caller
            cb_error.append(e)
            return 0

    return _cb


def beam_search_lattice_native(lattices, sizes, beam_size: int, rng,
                               max_expansions_factor: int = 40,
                               verdict=None, retry_final_gate: bool = True):
    """Native PQ beam search over precomputed lattices: the refine-off path
    of ``sampling.beam.PQBeamSearch`` with ``sampling.lattice.LatticeExpander``.

    Bitwise equal to the Python search: priorities are IEEE doubles summed
    in the same order, and the 1e-8 tiebreak draws continue the caller's
    ``random.Random``. Its Mersenne state goes in and is written back, so
    native and Python searches interleave on one stream.

    lattices: {index: MoleculeLattice} with keys 0..M-1; sizes: node counts
    in index order. Returns (wids: M int64 arrays of length n_i, -1-filled
    on failure; ok (M,) bool; logp (M,) float64).

    ``verdict(wid, sorted_neighbour_wids_tuple) -> bool`` turns on the gated
    search: the focal gate per candidate and the all-nodes gate at the end,
    as ``chem.assemble_gate``'s gate decides them. The C side gathers and
    sorts the typed neighbours and calls back for the verdict only, which
    stays memoized in Python."""
    lib = _require()
    m = len(sizes)
    sizes32 = np.asarray(sizes, np.int32)
    offsets = np.zeros(m, np.int64)
    offsets[1:] = np.cumsum(sizes32[:-1])
    k = lattices[0].top_wid.shape[1]
    focal, target, attach, top_wid, top_logp = _flat_lattices(lattices, range(m), sizes32)
    total = int(sizes32.sum())

    version, state, gauss = rng.getstate()
    mt = np.asarray(state[:624], np.uint32)
    pos = ctypes.c_int32(state[624])
    out_wids = np.full(total, -1, np.int64)
    ok = np.zeros(m, np.uint8)
    logp = np.zeros(m, np.float64)
    if verdict is None:
        lib.tk_beam_search_lattice(
            m, k, beam_size, max_expansions_factor, sizes32, offsets, focal, target, attach,
            top_wid, top_logp, mt, ctypes.byref(pos), out_wids, ok, logp)
    else:
        cb_error: list = []
        cb = _wrap_verdict(verdict, cb_error)
        lib.tk_beam_search_lattice_gated(
            m, k, beam_size, max_expansions_factor, sizes32, offsets, focal, target, attach,
            top_wid, top_logp, mt, ctypes.byref(pos), cb, 1 if retry_final_gate else 0,
            out_wids, ok, logp)
        if cb_error:
            raise cb_error[0]
    rng.setstate((version, tuple(int(v) for v in mt) + (int(pos.value),), gauss))
    return ([out_wids[int(offsets[i]): int(offsets[i]) + int(sizes32[i])] for i in range(m)],
            ok.astype(bool), logp)


class NativeRefineSearch:
    """One molecule group's refine-on PQ beam search in C++ (tk_rsearch_*).

    The C side owns the queues, walks and commits the fused check's results
    and expands; ``step`` returns the next active fleet, which the caller
    pads and checks through ``RefineHook.dispatch_arrays``. Bitwise equal
    to the Python group search of ``LatticeSampler._sample_refine_pipelined``
    for the same seed. The lattice arrays are flattened once here and kept
    alive, with the callbacks, for the handle's lifetime."""

    def __init__(self, lattices, members, sizes, beam_size: int, rng,
                 max_n: int, check_frac: float, verdict=None,
                 hook_verdict=None, retry_final_gate: bool = True,
                 max_expansions_factor: int = 40):
        """members: molecule indices (keys into ``lattices``); sizes: their
        node counts in member order. ``rng``'s Mersenne state seeds the
        tiebreak stream (the group's own rng in the pipelined search)."""
        lib = _require()
        # The native fleet_adj is rebuilt from the attach steps alone and
        # carries no root marker at adj[0, 0]; the Python packer clears the
        # diagonal, so both check the same adjacency. A state that still
        # has its marker (one node typed, no attach yet) can never pass the
        # active filter t * check_frac > 1 when check_frac <= 1: enforce
        # that invariant rather than assume it.
        assert check_frac <= 1.0, (
            "NativeRefineSearch requires check_frac <= 1 (root-marker rows "
            "would otherwise reach the fused check with a different adj "
            "than the Python packer)")
        self._lib = lib
        m = len(members)
        self.n_mol = m
        self.max_n = int(max_n)
        sizes32 = np.asarray(sizes, np.int32)
        offsets = np.zeros(m, np.int64)
        offsets[1:] = np.cumsum(sizes32[:-1])
        self.sizes = sizes32
        self.offsets = offsets
        k = lattices[members[0]].top_wid.shape[1]
        focal, target, attach, top_wid, top_logp = _flat_lattices(lattices, members, sizes32)
        # every borrowed array and callback stays alive with the handle
        self._keep = (focal, target, attach, top_wid, top_logp, sizes32, offsets)
        self.cb_error: list = []
        self._gate_cb = _wrap_verdict(verdict, self.cb_error)
        self._hook_cb = _wrap_verdict(hook_verdict, self.cb_error)
        _version, state, _gauss = rng.getstate()
        mt = np.asarray(state[:624], np.uint32)
        self.fleet_mol = np.zeros(m, np.int32)
        self.fleet_wids = np.zeros((m, self.max_n), np.int64)
        self.fleet_adj = np.zeros((m, self.max_n, self.max_n), np.float32)
        self._handle = lib.tk_rsearch_create(
            m, k, beam_size, max_expansions_factor, self.max_n, float(check_frac),
            sizes32, offsets, focal, target, attach, top_wid, top_logp, mt, int(state[624]),
            self._gate_cb, self._hook_cb, 1 if retry_final_gate else 0)

    def step(self, packed: Optional[np.ndarray], K: int) -> int:
        """Advance one round. ``packed``: the previous fleet's fused-check
        results, (S_prev, 1 + 4K) float32 in active-row order (None on the
        first call). Returns the next active fleet's row count S (0: done);
        its rows are ``fleet_mol`` / ``fleet_wids`` / ``fleet_adj`` [:S]."""
        if packed is None:
            buf = ctypes.c_void_p(None)
        else:
            packed = np.ascontiguousarray(packed, np.float32)
            buf = packed.ctypes.data_as(ctypes.c_void_p)
        s = self._lib.tk_rsearch_step(self._handle, buf, int(K), self.fleet_mol,
                                      self.fleet_wids, self.fleet_adj)
        if self.cb_error:
            self.close()
            raise self.cb_error[0]
        return int(s)

    def finish(self):
        """(wids per member, -1-filled on failure; ok (M,) bool; logp (M,)
        float64); destroys the handle."""
        mt = np.zeros(624, np.uint32)
        pos = ctypes.c_int32()
        total = int(self.offsets[-1]) + int(self.sizes[-1])
        out_wids = np.full(total, -1, np.int64)
        ok = np.zeros(self.n_mol, np.uint8)
        logp = np.zeros(self.n_mol, np.float64)
        self._lib.tk_rsearch_finish(self._handle, mt, ctypes.byref(pos), out_wids, ok, logp)
        self.close()
        return ([out_wids[int(self.offsets[i]): int(self.offsets[i]) + int(self.sizes[i])]
                 for i in range(self.n_mol)], ok.astype(bool), logp)

    def close(self) -> None:
        if self._handle:
            self._lib.tk_rsearch_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
