"""Memoized beam-search assembly gate.

The reference gates every beam candidate and every finished tree with
``can_assemble`` (ar_sampling_nosize.py:199-200, 396-403), calling RDKit's
attachment enumeration each time. Assembly feasibility depends ONLY on the
fragment identity of the node and its typed neighbors (jtnn_dec.py:312-326
uses mols, never geometry), so the verdict is memoized per
(wid, sorted neighbor wids) — SURVEY §7's hard-part #4 names exactly this
caching as the lever that keeps the device from idling on host chemistry.
"""

from __future__ import annotations

from functools import lru_cache
import numpy as np

from hierdiff_torch.chem import require_rdkit


def make_assembly_gate(vocab, max_cache: int = 200_000):
    """Returns ``gate(state, i) -> bool`` for sampling.beam.PQBeamSearch.

    Untyped (blur) nodes pass trivially — the reference only checks a node
    once it and its neighborhood carry fragment ids.
    """
    require_rdkit("assembly gate")
    from hierdiff_torch.chem.chemutils import can_assemble
    from hierdiff_torch.chem.mol_tree import MolTreeNode

    @lru_cache(maxsize=max_cache)
    def _verdict(wid: int, nei_wids: tuple) -> bool:
        node = MolTreeNode(vocab.get_smiles(wid), None, vocab=vocab)
        node.neighbors = [MolTreeNode(vocab.get_smiles(w), None, vocab=vocab)
                          for w in nei_wids]
        return can_assemble(node)

    def gate(state, i: int) -> bool:
        wid = int(state.wids[i])
        if wid < 0:
            return True
        row = np.nonzero(state.adj[i])[0]
        neis = tuple(sorted(int(state.wids[j]) for j in row
                            if j != i and int(state.wids[j]) >= 0))
        if not neis:
            return True
        return _verdict(wid, neis)

    gate.cache_info = _verdict.cache_info  # type: ignore[attr-defined]
    # raw (wid, sorted_neighbor_wids) verdict: lets the native beam search
    # (runtime.beam_search_lattice_native) gather neighbors in C++ and call
    # back only for the lru-cached verdict
    gate.verdict = _verdict  # type: ignore[attr-defined]
    return gate
