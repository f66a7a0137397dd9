"""Lattice sampler: the fine-stage assembly as one model run per chunk.

Port of ``hierdiff_tpu/sampling/lattice.py`` (``MoleculeLattice``,
``LatticeExpander``, ``pow2_chunks``, ``LatticeSampler`` with its Python and
native searches and the streamed driver). With the reference's live
configuration the tree-growth trajectory does not depend on the fragment
types the beam picks (see ``EdgeDenoise.ar_lattice``), so the device
computes every expansion step of a chunk of molecules (focal node, attached
node, top-k types) in one ``ar_lattice`` run, and the beam search then walks
those lattices on the host without calling the model.

Molecules are grouped by pad bucket and each bucket split into pow2 chunks;
each chunk's outputs are copied to pinned host memory behind one CUDA event
(``HostCopy``). Under ``gated=True`` a molecule's lattice does not depend on
its chunk or pad, so chunking changes no result.

The search runs in C++ (``runtime/treekit.cpp``) when the library is built
and the assembly gate is verdict-style (``gate.verdict``): refine off the
whole search (``_sample_native``), refine on each group's queues, walk and
expansions (``_NativeRefineLoop``), while Python pads each round's fleet and
enqueues its fused check. Both are bitwise equal to the Python searches,
the tiebreak stream included; ``native_search=False`` keeps the Python ones.

With a refine hook the search checks each fleet of beam candidates on the
device every round. The molecules are then searched in groups of at most
``refine_group_cap`` per pad bucket, each group its own search with its own
tiebreak stream (``_group_seed``), advanced round-robin with every live
group's fused check in flight; ``refine_group_cap=0`` keeps one lockstep
search.

``sample_streamed`` takes the coarse chunks as they land (the overlapped
``GenerationPipeline.run``): each chunk's lattices are enqueued at once, and
refine on, full groups join the native loop while later coarse chunks run.

``allowed_fn`` restricts each node's type to a per-node support (the size
variant's restriction, reference ar_sampling.py:62-118): every chunk carries
the union table of its supports (``build_allowed_arrays``) to the device, and
types outside a support get a log-probability of ~NEG_INF, which both
searches skip.

Inside a ``torch.distributed`` group (``parallel/mesh.py``) the lattices
are sharded over its ranks: every rank plans the chunks as one process
would, runs its share (chunks r, r + size, ...) and the lattices are
gathered on every rank; rank 0 alone searches (the refine hook's checks run
on its card), so the trees are bitwise those of one process. The JAX
package shards each chunk's rows over its mesh instead.
"""

from __future__ import annotations

import dataclasses
import random
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from hierdiff_torch.data.collate import DEFAULT_BUCKETS, bucket_for
from hierdiff_torch.models.edge_denoise import EdgeDenoise
from hierdiff_torch.parallel import mesh
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


class HostCopy:
    """Tensors copied to the host behind one event: on CUDA each goes to
    pinned memory without a sync and one ``torch.cuda.Event`` is recorded
    behind the copies; CPU tensors are ready as they are. ``is_ready`` asks
    without waiting, ``wait`` returns the numpy arrays in order: copies out
    of the pinned buffers, since a view would tie the buffer (whose release
    calls CUDA) to lattices, point sets and trees that a forked
    reconstruction worker inherits."""

    def __init__(self, tensors: Sequence[torch.Tensor]):
        self.host, self.event = list(tensors), None
        if any(t.is_cuda for t in self.host):
            pinned = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in self.host]
            for p, t in zip(pinned, self.host):
                p.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
            self.host = pinned

    def is_ready(self) -> bool:
        return self.event is None or self.event.query()

    def wait(self) -> List[np.ndarray]:
        if self.event is None:
            return [t.numpy() for t in self.host]
        self.event.synchronize()
        return [t.numpy().copy() for t in self.host]


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


def build_allowed_arrays(feats_list: Sequence[np.ndarray],
                         allowed_fn: Callable[[np.ndarray], List[np.ndarray]],
                         b: int, nb: int, v: int):
    """The union table of a batch's per-node supports and each node's row in
    it: (bucket (b, nb) int32, table (K, v) float32). ``allowed_fn(feats)``
    gives each node of one molecule its allowed vocab indices. Row 0 is the
    whole vocabulary, the row of padding nodes and rows; equal supports
    share a row (keyed by their bytes). (hierdiff_tpu/sampling/lattice.py:114)"""
    rows: List[np.ndarray] = [np.ones(v, np.float32)]
    row_key: Dict[bytes, int] = {}
    bucket = np.zeros((b, nb), np.int32)
    for row, feats in enumerate(feats_list):
        for node, allowed in enumerate(allowed_fn(feats)):
            mask = np.zeros(v, np.float32)
            mask[np.asarray(allowed, np.int64)] = 1.0
            key = mask.tobytes()
            if key not in row_key:
                row_key[key] = len(rows)
                rows.append(mask)
            bucket[row, node] = row_key[key]
    return bucket, np.stack(rows)


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
                 refine_merge: int = 1, native_search: bool = True,
                 retry_final_gate: bool = True,
                 allowed_fn: Optional[Callable[[np.ndarray], List[np.ndarray]]] = None,
                 max_chunk: Optional[int] = None):
        """buckets: pad buckets (None: ``DEFAULT_BUCKETS``); the lattice's
        work grows with the cube of the pad. refine_hook: a ``RefineHook``
        or None. can_assemble: the search's assembly gate or None. rng: the
        search's tiebreak stream (None: ``random.Random(2022)``, as the
        reference's); the refine-on group searches draw their seeds from it.

        refine_group_cap: molecules per refine-on group search (0: one
        lockstep search). refine_merge: same-bucket groups bundled into one
        fused check per round; the check is row-independent and a bundle
        never spans two buckets, so it changes no result, only the number
        of checks.

        native_search: search in C++ when the treekit library is built and
        the gate, if any, is verdict-style (bitwise the Python search).
        retry_final_gate: a completed tree that fails the final gate does
        not end its molecule's search (``beam.PQBeamSearch``).
        allowed_fn(blur feats (n, F)) -> each node's allowed vocab indices
        (the size variant's restriction); None: the whole vocabulary.
        max_chunk: molecules per lattice chunk at most (None: MAX_CHUNK;
        the device memory budget may set fewer)."""
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
        self.native_search = native_search
        self.retry_final_gate = retry_final_gate
        self.allowed_fn = allowed_fn
        self.max_chunk = max_chunk

    # --- device side ---------------------------------------------------------

    def _max_batch(self, nb: int) -> int:
        # ~6 live (B, N, N, H) f32 tensors per expansion step. The budget and
        # the cap are the JAX package's, from a sweep on one TPU (256 -> 512
        # molecules per chunk helped, 1024 did not); on the H100 they are
        # defaults, not measured optima.
        per_item = nb * nb * self.model.hidden_nf * 4 * 6
        return int(min(self.max_chunk or MAX_CHUNK, max(4, CHUNK_BUDGET_BYTES // per_item)))

    def _plan_lattices(self, blur_sets, indices) -> List[tuple]:
        """The lattice chunks of ``indices``: [(bucket, chunk), ...], each
        bucket's molecules split into pow2 chunks."""
        by_bucket: Dict[int, List[int]] = {}
        for i in indices:
            by_bucket.setdefault(
                bucket_for(blur_sets[i]["h"].shape[0], self.buckets), []).append(i)
        plan = []
        for nb, idxs in sorted(by_bucket.items()):
            c0 = 0
            for take in pow2_chunks(len(idxs), self._max_batch(nb)):
                plan.append((nb, idxs[c0: c0 + take]))
                c0 += take
        return plan

    def _dispatch_lattices(self, blur_sets, plan: List[tuple]) -> List[tuple]:
        """Run ``ar_lattice`` on each (bucket, chunk) of ``plan``
        (``_plan_lattices``); returns [(chunk, HostCopy of its outputs), ...].
        The device works through them in order; the dynamic depth loops read
        one number back per depth pass, so the host stays close behind."""
        device = next(self.model.parameters()).device
        pending = []
        for nb, chunk in plan:
            b = _next_pow2(len(chunk))
            arrays = pad_blur(blur_sets, chunk, b, nb)
            if self.allowed_fn is not None:
                arrays += build_allowed_arrays([blur_sets[i]["h"] for i in chunk],
                                               self.allowed_fn, b, nb, self.model.out_node_nf)
            out = self.model.ar_lattice(*(torch.from_numpy(a).to(device) for a in arrays))
            pending.append((chunk, HostCopy([out[k] for k in LATTICE_KEYS])))
        return pending

    @staticmethod
    def _collect_lattice(chunk, out, blur_sets, lattices) -> None:
        """Wait for one chunk's host copy and split it into per-molecule
        MoleculeLattice entries."""
        out = dict(zip(LATTICE_KEYS, out.wait()))
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
        """Group molecules by size bucket, pad, and run the lattice per
        chunk; in a process group, this rank's share of the chunks, the
        lattices gathered on every rank."""
        plan = mesh.my_share(self._plan_lattices(blur_sets, range(len(blur_sets))))
        lattices: Dict[int, MoleculeLattice] = {}
        for chunk, out in self._dispatch_lattices(blur_sets, plan):
            self._collect_lattice(chunk, out, blur_sets, lattices)
        return mesh.all_gather_dict(lattices)

    # --- host search ---------------------------------------------------------

    def sample(self, blur_sets: Sequence[Dict[str, np.ndarray]]) -> List[Optional[TreeState]]:
        """Assemble junction trees for a batch of coarse samples.

        blur_sets: per molecule {'x': (n, 3), 'h': (n, F)}, h integer-rounded
        (ar_sampling_nosize.py:388). Returns the best completed tree per
        molecule (None on failure); in a process group, None on ranks other
        than 0, which only compute their lattices."""
        if not blur_sets:
            return []
        lattices = self.compute_lattices(blur_sets)
        if mesh.world()[0] != 0:
            return None
        return self._search(blur_sets, lattices)

    def sample_streamed(self, feeder) -> List[Optional[TreeState]]:
        """The overlapped assembly: take coarse chunks from ``feeder`` as
        they land instead of after the whole coarse stage.

        feeder (``pipeline._BlurFeeder``): ``total`` (molecule count),
        ``blur`` (the per-molecule list it fills), ``pump()`` (no wait:
        absorbs the chunks whose copy has landed, keeps its coarse chunks in
        flight, returns the new chunks' index lists), ``collect_next()``
        (waits for the oldest chunk) and ``done``.

        Each arrived chunk's lattices are enqueued at once. Refine on and
        native, molecule groups join one ``_NativeRefineLoop`` as their
        lattices land: a group goes as soon as a bucket's pool holds
        ``refine_group_cap`` molecules, the remainders in sorted bucket
        order once every lattice has landed. That is the serial group
        partition for any feeder that delivers molecules in index order (the
        coarse chunk plan does), and ``_group_seed`` ties each group's
        stream to its members, so the trees equal ``sample``'s bit for bit
        when every bucket's lattices run at the serial batch shapes, and up
        to the rounding of another batch shape otherwise. The Python
        refine-on search has no incremental driver: it collects everything,
        then runs the serial search."""
        total = feeder.total
        blur_sets = feeder.blur
        if not total:
            return []
        use_loop = self._refine_native_eligible()
        if self.refine_hook is not None and not use_loop:
            while not feeder.done:
                feeder.collect_next()
            return self.sample(blur_sets)
        lattices: Dict[int, MoleculeLattice] = {}
        results: List[Optional[TreeState]] = [None] * total
        loop = _NativeRefineLoop(self, blur_sets, results) if use_loop else None
        pending_lat = deque()

        def on_chunks(chunks):
            for idxs in chunks:
                pending_lat.extend(self._dispatch_lattices(
                    blur_sets, self._plan_lattices(blur_sets, idxs)))

        # per-bucket pools: a group leaves when ``cap`` members are in; the
        # remainders wait until every lattice has landed (a group per
        # arrived chunk would split each bucket's tail into small groups)
        pools: Dict[int, List[int]] = {}
        flushed = False

        def absorb_lattice(item):
            chunk, out = item
            self._collect_lattice(chunk, out, blur_sets, lattices)
            if loop is not None:
                # a lattice chunk holds one bucket
                gbucket = bucket_for(blur_sets[chunk[0]]["h"].shape[0], self.buckets)
                pool = pools.setdefault(gbucket, [])
                pool.extend(chunk)
                cap = self.refine_group_cap
                while len(pool) >= cap:
                    loop.add_group(pool[:cap], gbucket, lattices)
                    del pool[:cap]

        while True:
            on_chunks(feeder.pump())
            while pending_lat and pending_lat[0][1].is_ready():
                absorb_lattice(pending_lat.popleft())
            if loop is not None and feeder.done and not pending_lat and not flushed:
                flushed = True
                for nb in sorted(pools):
                    if pools[nb]:
                        loop.add_group(pools[nb], nb, lattices)
                        pools[nb] = []
            if loop is not None and not loop.empty:
                loop.step_one()
            elif not feeder.done:
                on_chunks(feeder.collect_next())
            elif pending_lat:
                absorb_lattice(pending_lat.popleft())   # waits for its copy
            else:
                break
        if loop is not None:
            loop.drain()
            return results
        return self._search(blur_sets, lattices)

    def _native_gate(self, gate) -> bool:
        """A gate the C searches can call back: none, or one that carries
        its memoized ``verdict(wid, sorted neighbour wids)``."""
        return gate is None or hasattr(gate, "verdict")

    def _refine_native_eligible(self) -> bool:
        """The native refine-on search needs groups, verdict-style gates in
        the search and in the hook, the hook's pad buckets equal to the
        sampler's (a group's fleets must pad to the group's bucket), and the
        library."""
        if self.refine_hook is None or not self.refine_group_cap or not self.native_search:
            return False
        if not (tuple(self.refine_hook.buckets) == self.buckets
                and self._native_gate(self.can_assemble)
                and self._native_gate(self.refine_hook.can_assemble)):
            return False
        from hierdiff_torch import runtime
        return runtime.treekit_available()

    def _search(self, blur_sets, lattices) -> List[Optional[TreeState]]:
        """Host beam search over precomputed lattices, routed as the JAX
        package routes it: refine off, the native search when it is
        eligible; refine on with groups, the native group searches or the
        pipelined Python ones; anything else one lockstep Python search."""
        if (self.refine_hook is None and self.native_search
                and self._native_gate(self.can_assemble)):
            from hierdiff_torch import runtime
            if runtime.treekit_available():
                return self._sample_native(blur_sets, lattices)
        if self.refine_hook is not None and self.refine_group_cap:
            if self._refine_native_eligible():
                return self._sample_refine_native(blur_sets, lattices)
            return self._sample_refine_pipelined(blur_sets, lattices)
        search = PQBeamSearch(LatticeExpander(lattices), beam_size=self.beam_size,
                              can_assemble=self.can_assemble, refine_hook=self.refine_hook,
                              rng=self.rng, retry_final_gate=self.retry_final_gate)
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

    def _sample_native(self, blur_sets, lattices) -> List[Optional[TreeState]]:
        """Refine off: the whole search in C++ (tk_beam_search_lattice, its
        gated form with the gate's verdict), bitwise the Python search; the
        caller's tiebreak stream is continued and written back."""
        from hierdiff_torch import runtime

        sizes = [jt["h"].shape[0] for jt in blur_sets]
        rng = self.rng if self.rng is not None else random.Random(2022)
        verdict = getattr(self.can_assemble, "verdict", None)
        wids, ok, logp = runtime.beam_search_lattice_native(
            lattices, sizes, self.beam_size, rng, verdict=verdict,
            retry_final_gate=self.retry_final_gate)
        return [self._tree_from_lattice(blur_sets, lattices, i, wids[i], float(logp[i]))
                if ok[i] else None for i in range(len(blur_sets))]

    @staticmethod
    def _tree_from_lattice(blur_sets, lattices, i: int, wids: np.ndarray,
                           logp: float) -> TreeState:
        """The completed TreeState of a native search: the topology is the
        lattice's whole trajectory, wids and logp come from the search."""
        jt = blur_sets[i]
        n = jt["h"].shape[0]
        lat = lattices[i]
        adj = np.zeros((n, n), np.float32)
        last_edge = None
        for t in range(n):
            if lat.attach[t]:
                f, tg = int(lat.focal[t]), int(lat.target[t])
                adj[f, tg] = adj[tg, f] = 1.0
                last_edge = (f, tg)
        if last_edge is None and n > 0:
            adj[0, 0] = 1.0     # one node: the root marker is never cleared
        return TreeState(feats=np.asarray(jt["h"], np.float32),
                         pos=np.asarray(jt["x"], np.float32),
                         adj=adj, wids=wids, logp=logp, index=i, last_edge=last_edge)

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

    def _sample_refine_native(self, blur_sets, lattices) -> List[Optional[TreeState]]:
        """Refine on, the host side in C++: every group of
        ``_refine_groups`` a ``runtime.NativeRefineSearch`` in one
        ``_NativeRefineLoop``. Same groups, seeds and fleets as
        ``_sample_refine_pipelined``, and the fused check's inputs are the
        same, so the trees are bitwise equal."""
        results: List[Optional[TreeState]] = [None] * len(blur_sets)
        loop = _NativeRefineLoop(self, blur_sets, results)
        for members, gbucket in self._refine_groups(blur_sets):
            loop.add_group(members, gbucket, lattices)
        loop.drain()
        return results

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
                                  rng=random.Random(_group_seed(seed_base, members)),
                                  retry_final_gate=self.retry_final_gate)
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


class _NativeRefineLoop:
    """The event loop of the native refine-on group searches, to which
    groups can be added as they become ready: ``_sample_refine_native`` adds
    every group at once, ``LatticeSampler.sample_streamed`` adds them as
    their lattices land.

    A group's seed comes from ``_group_seed`` (the one master draw mixed
    with its first member), so it does not depend on when the group was
    added. Same-bucket groups' fleets are merged into one
    ``RefineHook.dispatch_arrays`` call of at most ``fleet_chunk_rows`` rows,
    so a lane is one fused check. While other lanes are in flight, a
    bucket's ready groups wait until they hold half that many rows; with
    nothing in flight everything goes. The check is row-independent and pads
    every chunk to ``fleet_pad_rows``, so lanes change no result."""

    def __init__(self, sampler: LatticeSampler, blur_sets, results):
        self.s = sampler
        self.blur_sets = blur_sets
        self.results = results
        self.hook = sampler.refine_hook
        master = sampler.rng if sampler.rng is not None else random.Random(2022)
        self.seed_base = master.getrandbits(64)   # one draw, as the pipelined search
        self.verdict = getattr(sampler.can_assemble, "verdict", None)
        self.hook_verdict = getattr(self.hook.can_assemble, "verdict", None)
        # queue: lanes in flight ([(group, rows at dispatch), ...], tokens);
        # ready: per bucket, the groups waiting for a dispatch
        self.queue = deque()
        self.ready: Dict[int, List[dict]] = {}

    @property
    def empty(self) -> bool:
        return not self.queue and not any(self.ready.values())

    def add_group(self, members, gbucket: int, lattices) -> None:
        from hierdiff_torch import runtime

        hook = self.hook
        grng = random.Random(_group_seed(self.seed_base, members))
        sizes = [self.blur_sets[i]["h"].shape[0] for i in members]
        feats, pos, nmask = pad_blur(self.blur_sets, members, len(members), gbucket)
        g = {"members": members, "bucket": gbucket, "lattices": lattices,
             "K": max(1, int(gbucket * hook.check_frac)),
             "feats": feats, "pos": pos, "nmask": nmask,
             "ns": runtime.NativeRefineSearch(
                 lattices, members, sizes, self.s.beam_size, grng, gbucket,
                 hook.check_frac, verdict=self.verdict, hook_verdict=self.hook_verdict,
                 retry_final_gate=self.s.retry_final_gate)}
        g["S"] = g["ns"].step(None, g["K"])
        if g["S"] == 0:
            self._finish(g)
            return
        self.ready.setdefault(gbucket, []).append(g)
        self._flush()

    def _finish(self, g) -> None:
        wids_list, ok, logp = g["ns"].finish()
        for r, i in enumerate(g["members"]):
            if ok[r]:
                self.results[i] = LatticeSampler._tree_from_lattice(
                    self.blur_sets, g["lattices"], i, wids_list[r], float(logp[r]))

    def _flush(self) -> None:
        """Form lanes from the ready groups and dispatch them (see the
        class docstring)."""
        for nb, gs in self.ready.items():
            cap = self.hook.fleet_chunk_rows(nb)
            while gs:
                if self.queue and sum(g["S"] for g in gs) < max(1, cap // 2):
                    break   # hold: partners land with the lanes in flight
                lane, rows = [], 0
                while gs and (not lane or rows + gs[0]["S"] <= cap):
                    g = gs.pop(0)
                    lane.append(g)
                    rows += g["S"]
                self.queue.append(([(g, g["S"]) for g in lane], self._dispatch_lane(lane, nb)))
                self.hook.stats["lanes"] += 1

    def _dispatch_lane(self, lane, nb: int):
        """The lane's fleets, concatenated, through the hook's chunk and pad
        policy (``RefineHook.dispatch_arrays``)."""
        parts = []
        for g in lane:
            ns, rows = g["ns"], g["S"]
            mol = ns.fleet_mol[:rows]
            parts.append((g["feats"][mol], g["pos"][mol], ns.fleet_adj[:rows],
                          g["nmask"][mol], ns.fleet_wids[:rows]))
        feats, pos, adj, nmask, wids = (np.concatenate([p[i] for p in parts]) for i in range(5))
        return self.hook.dispatch_arrays(nb, feats, pos, adj, nmask, wids)

    def step_one(self) -> None:
        """Advance the oldest lane in flight one round: wait for its checks,
        step every member group, queue the survivors again."""
        hook = self.hook
        if not self.queue:
            self._flush()
        lane, pending = self.queue.popleft()
        t0 = time.perf_counter()
        packed = np.concatenate([hook.wait_packed(token, cnt) for cnt, token in pending])
        t1 = time.perf_counter()
        hook.stats["collect_s"] += t1 - t0
        hook.stats["score_s"] += t1 - t0
        off = 0
        for g, cnt in lane:
            rows = packed[off: off + cnt]
            off += cnt
            g["S"] = g["ns"].step(rows, g["K"])
            hook.stats["rounds"] += 1
            hook.stats["fleet_rows"] += int(g["S"])
            if g["S"] == 0:
                self._finish(g)
            else:
                self.ready.setdefault(g["bucket"], []).append(g)
        hook.stats["walk_s"] += time.perf_counter() - t1
        self._flush()

    def drain(self) -> None:
        while not self.empty:
            self.step_one()
