"""Host-side beam search with the reference's priority-queue semantics.

The port's copy of ``hierdiff_tpu/sampling/beam.py`` (numpy, ``heapq`` and
``random`` only), code unchanged, so that over the same lattice both give
the same trees, tiebreak stream included. It rebuilds the search of
``generation/ar_sampling_nosize.py``:

- ONE priority queue per molecule keyed by cumulative -log p (the reference
  keeps one global queue but prunes per molecule index, which is equivalent;
  molecules are independent). Partial trees that were never expanded REMAIN
  in the queue, so when a branch dies (all children rejected by the assembly
  gate) the search backtracks to an older, cheaper partial tree
  (ar_sampling_nosize.py:284-296).
- Each expansion pushes at most ``beam_size`` children (the top-``beam_size``
  fresh candidates per molecule — remove_queue_dup, :233-264).
- A tiny random tiebreak is added to every pushed logp (:308).
- A completed tree is accepted only when it POPS as the molecule's cheapest
  entry, and only if EVERY node passes the assembly gate (:289-296,396-403).
  The reference gives up on the molecule when its first-popped completed
  tree fails that final gate; ``retry_final_gate=True`` (default) keeps
  searching instead — a strict improvement, flag off for bit-parity.

The expansion is pluggable: the port's lattice sampler
(``sampling/lattice.py``) drives it over precomputed lattices.
"""

from __future__ import annotations

import dataclasses
import heapq
import random
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class TreeState:
    """One beam candidate: a partially assembled junction tree.

    ``adj`` uses the reference's (0,0) root-marker convention: after the
    root-typing step, adj[0,0]=1 marks node 0 discovered until its first
    real edge arrives (ar_sampling_nosize.py:196-202).
    """

    feats: np.ndarray          # (n, F) blur features
    pos: np.ndarray            # (n, 3)
    adj: np.ndarray            # (n, n) with the (0,0) root marker convention
    wids: np.ndarray           # (n,) assigned vocab ids, -1 = blur/unassigned
    logp: float = 0.0
    index: int = 0             # source molecule id
    last_edge: Optional[tuple] = None
    # lazily cached np.sum(wids >= 0); apply_expansion maintains it
    # incrementally (the search calls n_assigned/done once per pop — a
    # profiled 15% of host beam time as per-access numpy reductions)
    _n_assigned: Optional[int] = dataclasses.field(default=None, repr=False)

    @property
    def n(self) -> int:
        return self.feats.shape[0]

    @property
    def n_assigned(self) -> int:
        if self._n_assigned is None:
            self._n_assigned = int(np.sum(self.wids >= 0))
        return self._n_assigned

    @property
    def done(self) -> bool:
        return self.n_assigned == self.n

    def clone(self) -> "TreeState":
        """Copy-on-write: ``feats``/``pos`` are SHARED (no search path writes
        them in place — apply_expansion copies feats before its one write,
        and the refine hook always assigns a fresh ``wids`` array);
        ``adj``/``wids`` are copied because apply_expansion mutates them."""
        return TreeState(self.feats, self.pos, self.adj.copy(),
                         self.wids.copy(), self.logp, self.index,
                         self.last_edge, self._n_assigned)


@dataclasses.dataclass
class Expansion:
    """Model output for one expansion of one state: where to grow and the
    type candidates (already top-k truncated, best first)."""

    focal: int
    target: int
    attach: bool               # False on the root-typing step
    cand_wids: np.ndarray      # (K,)
    cand_logps: np.ndarray     # (K,) log-probabilities (<= 0)


def apply_expansion(state: TreeState, exp: Expansion, wid: int, logp: float,
                    new_feats: Optional[np.ndarray] = None) -> TreeState:
    """Child state: commit the edge (or root marker) and the chosen type.
    ``new_feats`` optionally replaces the typed node's feature row (the size
    variant overwrites blur fps with the vocab fp, ar_sampling.py:170-182).
    """
    c = state.clone()
    if exp.attach:
        c.adj[exp.focal, exp.target] = c.adj[exp.target, exp.focal] = 1.0
        # the reference clears the root marker on every attach — safe since
        # node 0 is the only discovered node at the first attach, so it is
        # always an endpoint of a real edge from then on (update_trees:196)
        c.adj[0, 0] = 0.0
        c.last_edge = (exp.focal, exp.target)
    else:
        c.adj[0, 0] = 1.0          # root step: mark node 0 discovered
        c.last_edge = None
    was_unassigned = state.wids[exp.target] < 0
    c.wids[exp.target] = int(wid)
    c._n_assigned = state.n_assigned + (1 if was_unassigned else 0)
    if new_feats is not None:
        c.feats = c.feats.copy()   # feats are shared by clone() (CoW)
        c.feats[exp.target] = new_feats
    # reference accumulates -log p as the priority (ar_sampling_nosize.py:180,203)
    c.logp += float(-logp)
    return c


class PQBeamSearch:
    """Priority-queue beam search over per-molecule heaps (see module doc)."""

    def __init__(self,
                 expander: Callable[[List[TreeState]], List[Expansion]],
                 beam_size: int = 5,
                 can_assemble: Optional[Callable[[TreeState, int], bool]] = None,
                 refine_hook=None,
                 rng: Optional[random.Random] = None,
                 retry_final_gate: bool = True,
                 max_expansions_factor: int = 40,
                 feats_for_wid: Optional[Callable[[int], np.ndarray]] = None):
        self.expander = expander
        self.beam_size = beam_size
        self.can_assemble = can_assemble
        self.refine_hook = refine_hook
        self.rng = rng or random.Random(2022)   # reference seeds 2022 (:355)
        self.retry_final_gate = retry_final_gate
        self.max_expansions_factor = max_expansions_factor
        self.feats_for_wid = feats_for_wid
        self._push_count = 0

    # -- queue helpers -------------------------------------------------------

    def _push(self, heap, state: TreeState):
        self._push_count += 1
        heapq.heappush(heap, (state.logp, self._push_count, state))

    def _prune(self, heap) -> list:
        """remove_queue_dup (ar_sampling_nosize.py:233-264): after an
        expansion, the molecule's WHOLE queue keeps only the top
        ``beam_size`` attach-step trees by logp; root-step trees
        (``last_edge is None``) are exempt but count against the budget.
        This bounds the frontier — without it, cumulative-cost best-first
        degenerates into exponential uniform-cost search."""
        root_steps = [e for e in heap if e[2].last_edge is None]
        rest = sorted((e for e in heap if e[2].last_edge is not None),
                      key=lambda e: e[:2])
        keep = max(0, self.beam_size - len(root_steps))
        out = root_steps + rest[:keep]
        heapq.heapify(out)
        return out

    def _final_ok(self, state: TreeState) -> bool:
        """Every node assembles (ar_sampling_nosize.py:396-403)."""
        if self.can_assemble is None:
            return True
        return all(self.can_assemble(state, i) for i in range(state.n))

    # -- main loop ------------------------------------------------------------

    def run(self, init_states: Sequence[TreeState]) -> List[Optional[TreeState]]:
        gen = self.run_rounds(init_states)
        try:
            fleet = next(gen)
            while True:
                fleet = gen.send(self.refine_hook.check_batch(fleet))
        except StopIteration as e:
            return e.value

    def run_rounds(self, init_states: Sequence[TreeState]):
        """Generator form of ``run``: yields the fleet whenever a refine
        check is due and expects ``refine_hook.check_batch``-shaped results
        via ``send``. Identical semantics to ``run`` (which drives this
        generator synchronously); it lets an orchestrator keep many
        searches' refine checks in flight at once."""
        heaps: Dict[int, list] = {}
        budget: Dict[int, int] = {}
        finished: Dict[int, TreeState] = {}
        for s in init_states:
            heaps.setdefault(s.index, [])
            self._push(heaps[s.index], s)
            budget[s.index] = self.max_expansions_factor * s.n

        while True:
            # pop the cheapest unexpanded tree of every unfinished molecule;
            # molecules are independent, so stepping them in lockstep only
            # batches the device work — per-molecule order equals the
            # reference's global-queue order
            pops: List[TreeState] = []
            for idx, heap in heaps.items():
                if idx in finished or not heap or budget[idx] <= 0:
                    continue
                pops.append(heapq.heappop(heap)[2])
            if not pops:
                break

            # completed trees: accept on pop if the final gate passes
            to_expand: List[TreeState] = []
            for s in pops:
                if s.done:
                    if self._final_ok(s):
                        finished[s.index] = s
                        heaps[s.index] = []   # purge (remove_queue_dup keep=0)
                    elif not self.retry_final_gate:
                        budget[s.index] = 0   # reference: molecule yields nothing
                else:
                    to_expand.append(s)
            if not to_expand:
                continue

            # refine perturbation: refined trees are re-queued without
            # expanding this round (ar_sampling_nosize.py:138-143)
            if self.refine_hook is not None:
                checked = yield to_expand
                to_expand = []
                for state, dlogp, changed in checked:
                    if changed:
                        state.logp += dlogp + self.rng.uniform(0, 1e-8)
                        self._push(heaps[state.index], state)
                    else:
                        to_expand.append(state)
                if not to_expand:
                    continue

            expansions = self.expander(to_expand)
            for s, exp in zip(to_expand, expansions):
                budget[s.index] -= 1
                children: List[TreeState] = []
                for wid, lp in zip(exp.cand_wids[: self.beam_size],
                                   exp.cand_logps[: self.beam_size]):
                    if lp < -1e8:      # outside the restricted support
                        continue
                    nf = self.feats_for_wid(int(wid)) if self.feats_for_wid else None
                    c = apply_expansion(s, exp, int(wid), float(lp), nf)
                    # per-candidate assembly gate on the focal node
                    # (ar_sampling_nosize.py:199-200)
                    if exp.attach and self.can_assemble is not None:
                        if not self.can_assemble(c, exp.focal):
                            continue
                    c.logp += self.rng.uniform(0, 1e-8)
                    children.append(c)
                for c in children[: self.beam_size]:
                    self._push(heaps[s.index], c)
                heaps[s.index] = self._prune(heaps[s.index])

        return [finished.get(s.index) for s in init_states]
