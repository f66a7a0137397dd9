"""Round-based fine-stage sampling: one ``EdgeDenoise.ar_step`` per round.

Port of ``hierdiff_tpu/sampling/ar.py``. One ``ar_step`` call expands the
whole fleet of beam candidates popped in a search round; the beam
bookkeeping runs on the host through the shared priority-queue search
(``sampling/beam.py``) with the reference's semantics (backtracking, the
per-candidate and final assembly gates, the refine hook's checks).

This path is needed when the fragment types the beam picks feed back into
the model's inputs (``vocab_conditioning=True``); otherwise the lattice
sampler (``sampling/lattice.py``) computes every expansion in one run per
chunk, and ``build_fine_sampler`` picks it.

The fleet is packed by ``runtime.pack_ar_fleet_native`` when the treekit
library is built, else by the Python packer (``pack_fleet_python``); both
give the same arrays bit for bit. ``allowed_fn`` restricts each node's type
to a support as in the lattice sampler; each fleet carries its own union
table (``build_allowed_arrays``), unpadded: the JAX package pads it to a
power of two only to keep its jit key stable. Not ported: the size
variant's fp replacement (``vocab_fps``), which no caller sets.
"""

from __future__ import annotations

import random
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from hierdiff_torch.data.collate import DEFAULT_BUCKETS, bucket_for
from hierdiff_torch.models.edge_denoise import EdgeDenoise
from hierdiff_torch.parallel import mesh
from hierdiff_torch.sampling.beam import Expansion, PQBeamSearch, TreeState
from hierdiff_torch.sampling.lattice import (LATTICE_KEYS, HostCopy, LatticeSampler, _next_pow2,
                                             build_allowed_arrays)

UNDISCOVERED_TOKEN = 780


def pack_fleet_python(states: Sequence[TreeState], nb: int, bp: int):
    """The fleet as (feats, pos, adj, vocab, discovered, node mask), padded
    to ``bp`` rows of ``nb`` nodes; unassigned and padding nodes carry
    ``UNDISCOVERED_TOKEN``."""
    f = states[0].feats.shape[1]
    feats = np.zeros((bp, nb, f), np.float32)
    pos = np.zeros((bp, nb, 3), np.float32)
    adj = np.zeros((bp, nb, nb), np.float32)
    vocab = np.full((bp, nb), UNDISCOVERED_TOKEN, np.int32)
    disc = np.zeros((bp, nb), np.int32)
    nmask = np.zeros((bp, nb, 1), np.float32)
    for i, s in enumerate(states):
        k = s.n
        feats[i, :k] = s.feats
        pos[i, :k] = s.pos
        adj[i, :k, :k] = s.adj
        assigned = s.wids >= 0
        vocab[i, :k] = np.where(assigned, s.wids, UNDISCOVERED_TOKEN)
        disc[i, :k] = assigned.astype(np.int32)
        nmask[i, :k] = 1.0
    return feats, pos, adj, vocab, disc, nmask


def pack_fleet_native(states: Sequence[TreeState], nb: int, bp: int):
    """``pack_fleet_python`` through ``runtime.pack_ar_fleet_native``, the
    rows past the fleet padded as the Python packer pads them."""
    from hierdiff_torch import runtime

    b = len(states)
    feats, pos, adj, vocab, disc, nmask = runtime.pack_ar_fleet_native(
        states, nb, undiscovered_token=UNDISCOVERED_TOKEN)
    if bp != b:
        pad = lambda a, v=0: np.concatenate(  # noqa: E731
            [a, np.full((bp - b,) + a.shape[1:], v, a.dtype)])
        feats, pos, adj, disc, nmask = map(pad, (feats, pos, adj, disc, nmask))
        vocab = pad(vocab, UNDISCOVERED_TOKEN)
    return feats, pos, adj, vocab, disc, nmask


class DeviceExpander:
    """``beam.PQBeamSearch`` expander: one ``ar_step`` per fleet, split into
    a small and a large batch only when the buckets differ by 2x or more (a
    dense pass costs the square of its bucket, but every extra call costs its
    launches)."""

    def __init__(self, model: EdgeDenoise, buckets: Optional[Sequence[int]] = None,
                 allowed_fn: Optional[Callable[[np.ndarray], List[np.ndarray]]] = None):
        if model.gated and not model.dynamic_depth:
            # inference: bound the depth loops by the trees' actual depth
            model = model.clone(dynamic_depth=True)
        self.model = model
        self.allowed_fn = allowed_fn
        self.buckets = tuple(buckets) if buckets else DEFAULT_BUCKETS
        self.stats = {"steps": 0, "native_packs": 0}

    def _batch_step(self, states: Sequence[TreeState]) -> Dict[str, np.ndarray]:
        """Pad the fleet to one bucket and a pow2 row count (the fleet size
        changes every round; pow2 keeps the shapes few) and run one
        ``ar_step``; its outputs come back in one host copy."""
        from hierdiff_torch import runtime

        nb = bucket_for(max(s.n for s in states), self.buckets)
        b = len(states)
        bp = _next_pow2(b)
        if runtime.treekit_available():
            arrays = pack_fleet_native(states, nb, bp)
            self.stats["native_packs"] += 1
        else:
            arrays = pack_fleet_python(states, nb, bp)
        feats, pos, adj, vocab, disc, nmask = arrays
        device = next(self.model.parameters()).device
        on = lambda a, dtype=None: torch.from_numpy(a).to(device, dtype)  # noqa: E731
        allowed = ()
        if self.allowed_fn is not None:
            allowed = tuple(map(on, build_allowed_arrays([s.feats for s in states],
                                                         self.allowed_fn, bp, nb,
                                                         self.model.out_node_nf)))
        out = self.model.ar_step(on(feats), on(disc), on(vocab, torch.int64), on(pos), on(adj),
                                 on(nmask), *allowed)
        host = HostCopy([out[k] for k in LATTICE_KEYS]).wait()
        self.stats["steps"] += 1
        return {k: v[:b] for k, v in zip(LATTICE_KEYS, host)}

    def __call__(self, states: List[TreeState]) -> List[Expansion]:
        max_bucket = bucket_for(max(s.n for s in states), self.buckets)
        small = [(i, s) for i, s in enumerate(states)
                 if bucket_for(s.n, self.buckets) * 2 <= max_bucket]
        large = [(i, s) for i, s in enumerate(states)
                 if bucket_for(s.n, self.buckets) * 2 > max_bucket]
        results: List[Optional[Expansion]] = [None] * len(states)
        for grp in (small, large):
            if not grp:
                continue
            out = self._batch_step([s for _, s in grp])
            for row, (i, _s) in enumerate(grp):
                results[i] = Expansion(
                    focal=int(out["focal"][row]), target=int(out["target"][row]),
                    attach=bool(out["did_attach"][row]),
                    cand_wids=out["top_wid"][row].astype(np.int64),
                    cand_logps=out["top_logp"][row])
        return results  # type: ignore[return-value]


class ARSampler:
    """Stage 2 with one model step per search round: blur point sets ->
    junction trees, on the model's device."""

    def __init__(self, model: EdgeDenoise, beam_size: int = 5,
                 can_assemble: Optional[Callable[[TreeState, int], bool]] = None,
                 refine_hook=None,
                 allowed_fn: Optional[Callable[[np.ndarray], List[np.ndarray]]] = None,
                 rng: Optional[random.Random] = None,
                 buckets: Optional[Sequence[int]] = None):
        """rng: the search's tiebreak stream (None: ``random.Random(2022)``).
        allowed_fn(feats (n, F)) -> each node's allowed vocab indices (None:
        the whole vocabulary)."""
        self.model = model
        self.beam_size = beam_size
        self.can_assemble = can_assemble
        self.refine_hook = refine_hook
        self.expander = DeviceExpander(model, buckets=buckets, allowed_fn=allowed_fn)
        self.rng = rng

    def sample(self, blur_sets: Sequence[Dict[str, np.ndarray]]) -> List[Optional[TreeState]]:
        """Assemble junction trees for a batch of coarse samples.

        blur_sets: per molecule {'x': (n, 3), 'h': (n, F)}, h integer-rounded
        (ar_sampling_nosize.py:388). Returns the best completed tree per
        molecule (None on failure). In a process group it runs on rank 0
        alone, as the JAX package's does on a mesh, and returns None on the
        other ranks."""
        if not blur_sets:
            return []
        if mesh.world()[0] != 0:
            return None
        init = LatticeSampler._init_states(blur_sets, range(len(blur_sets)))
        search = PQBeamSearch(self.expander, beam_size=self.beam_size,
                              can_assemble=self.can_assemble, refine_hook=self.refine_hook,
                              rng=self.rng)
        return search.run(init)
