"""Lattice sampler: the fine-stage assembly as one model run per chunk.

Port of ``hierdiff_tpu/sampling/lattice.py`` (``MoleculeLattice``,
``LatticeExpander``, ``pow2_chunks`` and the serial ``LatticeSampler`` with
the Python search). With the reference's live configuration the tree-growth
trajectory does not depend on the fragment types the beam picks (see
``EdgeDenoise.ar_lattice``), so the device computes every expansion step of
a chunk of molecules (focal node, attached node, top-k types) in one
``ar_lattice`` run, and the beam search then walks those lattices on the
host without calling the model.

Molecules are grouped by pad bucket and each bucket split into pow2 chunks;
each chunk's outputs are copied to the host once. Under ``gated=True`` a
molecule's lattice does not depend on its chunk or pad, so chunking changes
no result.

Not ported yet (ROADMAP.md, Queue 1): the streamed driver
(``sample_streamed``), the refine hook and its searches, the native search,
the data mesh and the per-node vocab restriction (``allowed_fn``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from hierdiff_torch.data.collate import DEFAULT_BUCKETS, bucket_for
from hierdiff_torch.models.edge_denoise import EdgeDenoise
from hierdiff_torch.sampling.beam import Expansion, PQBeamSearch, TreeState

LATTICE_KEYS = ("focal", "target", "did_attach", "top_wid", "top_logp")
CHUNK_BUDGET_BYTES = 2 << 30     # device memory one lattice chunk may take
MAX_CHUNK = 512                  # molecules per chunk at most


@dataclasses.dataclass
class MoleculeLattice:
    """Per-molecule expansion lattice: step t assigns the type of node
    target[t] (t=0 is the root-typing step, attach[0]=False)."""

    focal: np.ndarray      # (S,) int
    target: np.ndarray     # (S,) int
    attach: np.ndarray     # (S,) bool
    top_wid: np.ndarray    # (S, K) int
    top_logp: np.ndarray   # (S, K) float


class LatticeExpander:
    """beam.PQBeamSearch expander backed by precomputed lattices."""

    def __init__(self, lattices: Dict[int, MoleculeLattice]):
        self.lattices = lattices

    def __call__(self, states: Sequence[TreeState]) -> List[Expansion]:
        out = []
        for s in states:
            lat = self.lattices[s.index]
            t = s.n_assigned
            out.append(Expansion(
                focal=int(lat.focal[t]), target=int(lat.target[t]),
                attach=bool(lat.attach[t]),
                cand_wids=lat.top_wid[t], cand_logps=lat.top_logp[t]))
        return out


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def pow2_chunks(n: int, cap: int, min_chunk: int = 4):
    """Greedy pow2 decomposition of a bucket population into chunk sizes:
    full ``cap``-sized chunks first, then the remainder in descending pow2
    pieces (952 -> 512, 256, 128, 56) rather than one chunk padded to the
    next pow2. Padded rows cost full work; this wastes at most
    ``min_chunk - 1`` of them, and the chunk sizes stay few."""
    while n > 0:
        if n >= cap:
            yield cap
            n -= cap
            continue
        p = min_chunk
        while p * 2 <= n:
            p *= 2
        yield min(p, n)
        n -= min(p, n)


def pad_blur(blur_sets, chunk, b: int, nb: int):
    """feats (b, nb, F), pos (b, nb, 3) and node mask (b, nb, 1) of the
    molecules ``chunk``, zero-padded, as numpy float32."""
    f = blur_sets[chunk[0]]["h"].shape[1]
    feats = np.zeros((b, nb, f), np.float32)
    pos = np.zeros((b, nb, 3), np.float32)
    nmask = np.zeros((b, nb, 1), np.float32)
    for row, i in enumerate(chunk):
        n = blur_sets[i]["h"].shape[0]
        feats[row, :n] = blur_sets[i]["h"]
        pos[row, :n] = blur_sets[i]["x"]
        nmask[row, :n] = 1.0
    return feats, pos, nmask


class LatticeSampler:
    """Stage 2: blur point sets -> junction trees, on the model's device."""

    def __init__(self, model: EdgeDenoise, beam_size: int = 5,
                 buckets: Optional[Sequence[int]] = None):
        """buckets: pad buckets (None: ``DEFAULT_BUCKETS``); the lattice's
        work grows with the cube of the pad. The search's tiebreak stream is
        ``random.Random(2022)``, as the reference's."""
        if model.gated and not model.dynamic_depth:
            # inference: bound the depth loops by the trees' actual depth
            # (exact under gated=True; see EdgeDenoise.depth_mp)
            model = model.clone(dynamic_depth=True)
        self.model = model
        self.beam_size = beam_size
        self.buckets = tuple(buckets) if buckets else DEFAULT_BUCKETS

    # --- device side ---------------------------------------------------------

    def _max_batch(self, nb: int) -> int:
        # ~6 live (B, N, N, H) f32 tensors per expansion step. The budget and
        # the cap are the JAX package's, from a sweep on one TPU (256 -> 512
        # molecules per chunk helped, 1024 did not); on the H100 they are
        # defaults, not measured optima.
        per_item = nb * nb * self.model.hidden_nf * 4 * 6
        return int(min(MAX_CHUNK, max(4, CHUNK_BUDGET_BYTES // per_item)))

    def _dispatch_lattices(self, blur_sets, indices) -> List[tuple]:
        """Run ``ar_lattice`` on each (bucket, pow2 chunk) of ``indices``;
        returns [(chunk, outputs on the device), ...]. The device works
        through them in order; the dynamic depth loops read one number back
        per depth pass, so the host stays close behind."""
        by_bucket: Dict[int, List[int]] = {}
        for i in indices:
            by_bucket.setdefault(
                bucket_for(blur_sets[i]["h"].shape[0], self.buckets), []).append(i)
        device = next(self.model.parameters()).device
        pending = []
        for nb, idxs in sorted(by_bucket.items()):
            c0 = 0
            for take in pow2_chunks(len(idxs), self._max_batch(nb)):
                chunk = idxs[c0: c0 + take]
                c0 += take
                arrays = pad_blur(blur_sets, chunk, _next_pow2(len(chunk)), nb)
                out = self.model.ar_lattice(*(torch.from_numpy(a).to(device) for a in arrays))
                pending.append((chunk, {k: out[k] for k in LATTICE_KEYS}))
        return pending

    @staticmethod
    def _collect_lattice(chunk, out, blur_sets, lattices) -> None:
        """Copy one chunk's outputs to the host and split them into
        per-molecule MoleculeLattice entries."""
        out = {k: v.cpu().numpy() for k, v in out.items()}
        for row, i in enumerate(chunk):
            n = blur_sets[i]["h"].shape[0]
            lattices[i] = MoleculeLattice(
                focal=out["focal"][row, :n].astype(np.int32),
                target=out["target"][row, :n].astype(np.int32),
                attach=out["did_attach"][row, :n],
                top_wid=out["top_wid"][row, :n].astype(np.int64),
                top_logp=out["top_logp"][row, :n])

    def compute_lattices(self, blur_sets: Sequence[Dict[str, np.ndarray]]
                         ) -> Dict[int, MoleculeLattice]:
        """Group molecules by size bucket, pad, and run the lattice per chunk."""
        pending = self._dispatch_lattices(blur_sets, range(len(blur_sets)))
        lattices: Dict[int, MoleculeLattice] = {}
        for chunk, out in pending:
            self._collect_lattice(chunk, out, blur_sets, lattices)
        return lattices

    # --- host search ---------------------------------------------------------

    def sample(self, blur_sets: Sequence[Dict[str, np.ndarray]]) -> List[Optional[TreeState]]:
        """Assemble junction trees for a batch of coarse samples.

        blur_sets: per molecule {'x': (n, 3), 'h': (n, F)}, h integer-rounded
        (ar_sampling_nosize.py:388). Returns the best completed tree per
        molecule (None on failure)."""
        if not blur_sets:
            return []
        return self._search(blur_sets, self.compute_lattices(blur_sets))

    def _search(self, blur_sets, lattices) -> List[Optional[TreeState]]:
        """Host beam search over precomputed lattices."""
        search = PQBeamSearch(LatticeExpander(lattices), beam_size=self.beam_size)
        return search.run(self._init_states(blur_sets, range(len(blur_sets))))

    @staticmethod
    def _init_states(blur_sets, indices) -> List[TreeState]:
        init = []
        for idx in indices:
            jt = blur_sets[idx]
            n = jt["h"].shape[0]
            init.append(TreeState(
                feats=np.asarray(jt["h"], np.float32),
                pos=np.asarray(jt["x"], np.float32),
                adj=np.zeros((n, n), np.float32),
                wids=np.full(n, -1, np.int64),
                index=idx))
        return init
