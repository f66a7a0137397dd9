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

With a refine hook (``sampling/refine_hook.py``) the search checks each
fleet of beam candidates on the device every round. The molecules are then
searched in groups of at most ``refine_group_cap`` per pad bucket, each
group its own ``PQBeamSearch.run_rounds`` with its own tiebreak stream
(``_group_seed``), advanced round-robin with every live group's fused check
in flight (``_sample_refine_pipelined``); ``refine_group_cap=0`` keeps one
lockstep search.

Not ported yet (ROADMAP.md, Queue 1): the streamed driver
(``sample_streamed``), the native searches, the data mesh and the per-node
vocab restriction (``allowed_fn``).
"""

from __future__ import annotations

import dataclasses
import random
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

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


def _group_seed(base: int, members) -> int:
    """Tiebreak seed of one refine-on group search: one master draw
    (``base``) mixed with the group's first molecule index. Groups partition
    the molecules, so the seed depends on the group, not on the order the
    groups were made in (``hierdiff_tpu/sampling/lattice.py:78``)."""
    return (base ^ ((int(members[0]) + 1) * 0x9E3779B97F4A7C15)) & (2**64 - 1)


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
                 buckets: Optional[Sequence[int]] = None, refine_hook=None,
                 can_assemble: Optional[Callable[[TreeState, int], bool]] = None,
                 rng: Optional[random.Random] = None, refine_group_cap: int = 32,
                 refine_merge: int = 1):
        """buckets: pad buckets (None: ``DEFAULT_BUCKETS``); the lattice's
        work grows with the cube of the pad. refine_hook: a ``RefineHook``
        or None. can_assemble: the search's assembly gate or None. rng: the
        search's tiebreak stream (None: ``random.Random(2022)``, as the
        reference's); the refine-on group searches draw their seeds from it.

        refine_group_cap: molecules per refine-on group search (0: one
        lockstep search). refine_merge: same-bucket groups bundled into one
        fused check per round; the check is row-independent and a bundle
        never spans two buckets, so it changes no result, only the number
        of checks."""
        if model.gated and not model.dynamic_depth:
            # inference: bound the depth loops by the trees' actual depth
            # (exact under gated=True; see EdgeDenoise.depth_mp)
            model = model.clone(dynamic_depth=True)
        self.model = model
        self.beam_size = beam_size
        self.buckets = tuple(buckets) if buckets else DEFAULT_BUCKETS
        self.refine_hook = refine_hook
        self.can_assemble = can_assemble
        self.rng = rng
        self.refine_group_cap = refine_group_cap
        self.refine_merge = refine_merge

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
        """Host beam search over precomputed lattices: refine-on with groups
        goes to the pipelined group searches, anything else to one lockstep
        search (the JAX package's routing where no native library is
        built)."""
        if self.refine_hook is not None and self.refine_group_cap:
            return self._sample_refine_pipelined(blur_sets, lattices)
        search = PQBeamSearch(LatticeExpander(lattices), beam_size=self.beam_size,
                              can_assemble=self.can_assemble, refine_hook=self.refine_hook,
                              rng=self.rng)
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

    def _refine_groups(self, blur_sets) -> List[tuple]:
        """(members, bucket) of the refine-on group searches: molecules
        grouped by pad bucket, at most ``refine_group_cap`` per group."""
        by_bucket: Dict[int, List[int]] = {}
        for idx, jt in enumerate(blur_sets):
            by_bucket.setdefault(bucket_for(jt["h"].shape[0], self.buckets), []).append(idx)
        out: List[tuple] = []
        for nb, idxs in sorted(by_bucket.items()):
            for c0 in range(0, len(idxs), self.refine_group_cap):
                out.append((idxs[c0: c0 + self.refine_group_cap], nb))
        return out

    def _sample_refine_pipelined(self, blur_sets, lattices) -> List[Optional[TreeState]]:
        """Refine-on search as pipelined molecule-group searches.

        Each group (``_refine_groups``) runs its own ``PQBeamSearch`` as a
        generator (``run_rounds``), seeded by ``_group_seed``; every live
        lane's fused check is enqueued, and the lanes are collected
        round-robin, so one lane's check runs on the device while the host
        walks another's. Within a group the order of work is that of a
        search run alone, so the result equals the sequential group
        searches with the same seeds, bit for bit."""
        master = self.rng if self.rng is not None else random.Random(2022)
        seed_base = master.getrandbits(64)
        hook = self.refine_hook
        expander = LatticeExpander(lattices)
        results: List[Optional[TreeState]] = [None] * len(blur_sets)

        def finish(members, values):
            for i, r in zip(members, values):
                results[i] = r

        items = []   # live (bucket, generator, members, fleet) at their first yield
        for members, gbucket in self._refine_groups(blur_sets):
            search = PQBeamSearch(expander, beam_size=self.beam_size,
                                  can_assemble=self.can_assemble, refine_hook=hook,
                                  rng=random.Random(_group_seed(seed_base, members)))
            gen = search.run_rounds(self._init_states(blur_sets, members))
            try:
                fleet = next(gen)
            except StopIteration as e:
                finish(members, e.value)
                continue
            items.append((gbucket, gen, members, fleet))

        def dispatch_lane(lane):
            # the fused check is row-independent: one check for the lane's
            # concatenated same-bucket fleets gives each group its own result
            return hook.dispatch_batch([s for (_b, _g, _m, fleet) in lane for s in fleet])

        # keep at least 4 lanes in flight: a larger merge would collapse the
        # pipeline back into one lockstep chain
        merge = max(1, min(int(self.refine_merge or 1), len(items) // 4))
        queue = deque()
        lane: List[tuple] = []
        for it in items:
            if lane and (len(lane) >= merge or lane[0][0] != it[0]):
                queue.append((lane, dispatch_lane(lane)))
                lane = []
            lane.append(it)
        if lane:
            queue.append((lane, dispatch_lane(lane)))

        while queue:
            lane, token = queue.popleft()
            states = [s for (_b, _g, _m, fleet) in lane for s in fleet]
            checked = hook.collect_batch(token, states)
            nxt, off = [], 0
            for gbucket, gen, members, fleet in lane:
                part = checked[off: off + len(fleet)]
                off += len(fleet)
                try:
                    fleet = gen.send(part)
                except StopIteration as e:
                    finish(members, e.value)
                    continue
                nxt.append((gbucket, gen, members, fleet))
            if nxt:
                queue.append((nxt, dispatch_lane(nxt)))
        return results
