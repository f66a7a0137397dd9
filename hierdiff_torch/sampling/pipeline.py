"""Generation pipeline: coarse point sets -> junction trees -> molecules.

Port of the serial path of ``hierdiff_tpu/sampling/pipeline.py``
(``GenerationPipeline.run`` without overlap, ``build_fine_sampler``'s
lattice branch, ``round_int_features``):

1. coarse: node counts from the histogram prior, grouped by pad bucket and
   chunked, each chunk a run of ``sample_coarse`` (the coarse kernels on the
   card);
2. fine: the lattice sampler assembles a junction tree per molecule, with
   the refine hook's checks and the assembly gate in its search when they
   are given, and the hook's ``finalize`` repair after it;
3. reconstruct: host RDKit assembly of each tree into a molecule
   (``chem/reconstruct.py``), when RDKit is present and a vocabulary is set.

Integer blur features are rounded at the hand-off between the stages, as in
the reference (ar_sampling_nosize.py:388). The streamed, overlapped driver
(``run_streamed``) is not ported yet.

Random numbers differ from the JAX pipeline by design. ``run(seed, n)``
draws the node counts from ``np.random.default_rng(seed)``, so a JAX run
handed the same numpy generator has the same counts and the same chunk plan
(the JAX ``run`` seeds that generator from its PRNG key). Each coarse chunk
draws its noise from a ``torch.Generator`` seeded from (seed, the chunk's
first molecule index), the counterpart of the JAX package's ``fold_in`` of
that index: a chunk's samples depend on the chunk alone, not on the order
the chunks run in.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from hierdiff_torch.chem import has_rdkit
from hierdiff_torch.data.collate import SAMPLING_BUCKETS, bucket_for
from hierdiff_torch.models.diffusion import CoarseDiffusion
from hierdiff_torch.models.edge_denoise import EdgeDenoise
from hierdiff_torch.ops.distributions import DistributionNodes
from hierdiff_torch.sampling.beam import TreeState
from hierdiff_torch.sampling.coarse import make_masks_for_counts, sample_coarse
from hierdiff_torch.sampling.lattice import LatticeSampler, _next_pow2, pow2_chunks


def build_fine_sampler(denoise_model: EdgeDenoise, *, beam_size: int = 5,
                       buckets: Optional[Sequence[int]] = None, can_assemble=None,
                       refine_hook=None) -> LatticeSampler:
    """Stage-2 sampler for a denoise model: the lattice sampler, with the
    assembly gate ``can_assemble`` and the refine hook's checks in its search
    when they are given."""
    if denoise_model.vocab_conditioning:
        raise NotImplementedError(
            "vocab_conditioning needs the round-based ARSampler (sampling/ar.py), which is "
            "not ported yet (ROADMAP.md, Queue 1)")
    return LatticeSampler(denoise_model, beam_size=beam_size, buckets=buckets,
                          can_assemble=can_assemble, refine_hook=refine_hook)


def round_int_features(h: np.ndarray, int_nf: int) -> np.ndarray:
    """Integer blur dims rounded at the stage-1/2 hand-off
    (reference: ar_sampling_nosize.py:388)."""
    return np.concatenate([np.round(h[:, :int_nf]), h[:, int_nf:]], axis=1)


def chunk_seed(seed: int, first: int) -> int:
    """Seed of the torch.Generator of the coarse chunk whose first molecule
    is ``first``."""
    return int(np.random.SeedSequence([seed, first]).generate_state(1, np.uint64)[0])


@dataclasses.dataclass
class PipelineResult:
    blur: List[Dict[str, np.ndarray]]
    trees: List[Optional[TreeState]]
    stats: Optional[dict] = None
    molecules: Optional[list] = None       # [(mol, amap, smiles)] with RDKit


class GenerationPipeline:
    def __init__(self, coarse_model: CoarseDiffusion, denoise_model: EdgeDenoise,
                 histogram: Mapping[int, float], beam_size: int = 5, int_nf: int = 5,
                 max_n_cap: Optional[int] = None, sample_steps: Optional[int] = None,
                 sample_buckets: Optional[Sequence[int]] = None, refine_hook=None,
                 vocab=None, can_assemble=None):
        """sample_steps: strided reverse-chain length (None: the model's T).
        sample_buckets: pad buckets of the coarse chunks, the lattices and
        the refine hook's fleets (None: ``SAMPLING_BUCKETS``, the JAX
        pipeline's default). refine_hook: a ``RefineHook`` or None. vocab: the
        ``chem.mol_tree.Vocab`` that reconstruction reads (None: no
        reconstruction). can_assemble: the search's assembly gate or None."""
        self.coarse_model = coarse_model
        self.nodes_dist = DistributionNodes(histogram)
        self.sample_buckets = tuple(sample_buckets or SAMPLING_BUCKETS)
        if refine_hook is not None:
            # a group's fleets must pad to the group's own bucket, or merged
            # lanes stop being equal to solo ones; align the hook's set
            refine_hook.buckets = self.sample_buckets
        self.sampler = build_fine_sampler(denoise_model, beam_size=beam_size,
                                          buckets=self.sample_buckets, can_assemble=can_assemble,
                                          refine_hook=refine_hook)
        self.vocab = vocab
        self.int_nf = int_nf
        self.max_n_cap = max_n_cap
        self.sample_steps = sample_steps

    def _sample_counts(self, rng_np: np.random.Generator, n_molecules: int) -> np.ndarray:
        counts = self.nodes_dist.sample_np(rng_np, n_molecules)
        if self.max_n_cap:
            counts = np.minimum(counts, self.max_n_cap)
        return counts

    def _plan_chunks(self, counts: np.ndarray, batch_size: Optional[int] = None) -> List[tuple]:
        """Coarse chunk plan [(bucket, idx_list), ...]: group by size bucket
        first, then chunk, so a chunk never pads beyond its own bucket; the
        remainder is split into pow2 pieces of at least 64."""
        bs = batch_size or 64
        by_bucket: Dict[int, list] = {}
        for i, c in enumerate(counts):
            by_bucket.setdefault(bucket_for(int(c), self.sample_buckets), []).append(i)
        chunks = []
        for nb, idxs in sorted(by_bucket.items()):
            c0 = 0
            for take in pow2_chunks(len(idxs), bs, 64):
                chunks.append((nb, idxs[c0: c0 + take]))
                c0 += take
        return chunks

    def _dispatch_coarse(self, seed: int, counts: np.ndarray, nb: int, chunk) -> torch.Tensor:
        """One coarse chunk, padded to a pow2 batch of 1-node molecules:
        the packed (B, N, 3 + F) samples on the device."""
        chunk = np.asarray(chunk)
        ck = counts[chunk]
        ck_pad = np.concatenate([ck, np.ones(_next_pow2(len(chunk)) - len(chunk), ck.dtype)])
        nm, em = make_masks_for_counts(ck_pad, nb)
        device = next(self.coarse_model.parameters()).device
        generator = torch.Generator(device=device).manual_seed(chunk_seed(seed, int(chunk[0])))
        return sample_coarse(self.coarse_model, torch.from_numpy(nm).to(device),
                             torch.from_numpy(em).to(device), generator,
                             steps=self.sample_steps, packed=True)

    def _absorb_coarse(self, chunk, xh: np.ndarray, counts: np.ndarray, out: list) -> None:
        """Split one chunk's samples into per-molecule blur dicts, integer
        dims rounded."""
        nd = self.coarse_model.n_dims
        for row, i in enumerate(chunk):
            c = int(counts[i])
            out[i] = {"x": xh[row, :c, :nd],
                      "h": round_int_features(xh[row, :c, nd:], self.int_nf)}

    def sample_blur(self, seed: int, n_molecules: int) -> List[Dict[str, np.ndarray]]:
        """Stage 1: coarse point sets, sizes from the histogram prior drawn
        with ``np.random.default_rng(seed)``. Every chunk is queued first,
        then each is copied to the host once."""
        counts = self._sample_counts(np.random.default_rng(seed), n_molecules)
        out: List[Optional[Dict[str, np.ndarray]]] = [None] * n_molecules
        pending = [(chunk, self._dispatch_coarse(seed, counts, nb, chunk))
                   for nb, chunk in self._plan_chunks(counts)]
        for chunk, xh in pending:
            self._absorb_coarse(chunk, xh.cpu().numpy(), counts, out)
        return out  # type: ignore[return-value]

    def run(self, seed: int, n_molecules: int, reconstruct: bool = True,
            n_workers: int = 0) -> PipelineResult:
        """Coarse, fine, then reconstruction, one after the other. ``stats``
        holds the wall seconds of each (``t_coarse``, ``t_fine``; the refine
        hook's ``finalize`` counts in ``t_fine``). With ``reconstruct``, RDKit
        present and a vocabulary set, the trees that were assembled become
        molecules (``n_workers`` > 1: a process pool), and ``stats`` gains
        the reconstruction's valid, unique, avg_atoms and ``t_reconstruct``."""
        t0 = time.perf_counter()
        blur = self.sample_blur(seed, n_molecules)
        t1 = time.perf_counter()
        trees = self.sampler.sample(blur)
        hook = self.sampler.refine_hook
        if hook is not None:
            # end-of-search repair of non-assemblable fragments
            # (reference: model_refine.py:252-299 check_final_tree)
            trees = [hook.finalize(t) if t is not None else None for t in trees]
        t2 = time.perf_counter()
        result = PipelineResult(blur=blur, trees=trees,
                                stats={"t_coarse": t1 - t0, "t_fine": t2 - t1})
        if reconstruct and has_rdkit() and self.vocab is not None:
            from hierdiff_torch.chem.reconstruct import reconstruct_batch
            jt = [tree_state_to_moltree(t, self.vocab) for t in trees if t is not None]
            result.molecules, stats = reconstruct_batch(jt, self.vocab, n_workers)
            result.stats.update(stats)
            result.stats["t_reconstruct"] = time.perf_counter() - t2
        return result


def tree_state_to_moltree(state: TreeState, vocab):
    """A beam-search TreeState -> a ``chem.mol_tree.MolTree`` for
    reconstruction."""
    return tree_dict_to_moltree({"wids": state.wids, "adj": state.adj, "pos": state.pos,
                                 "feats": state.feats}, vocab)


def tree_dict_to_moltree(d: Dict[str, np.ndarray], vocab):
    """The portable tree dict ({wids, adj, pos, feats}: the sampling CLI's
    pickle payload) -> a ``chem.mol_tree.MolTree`` for reconstruction."""
    from hierdiff_torch.chem.mol_tree import MolTree, MolTreeNode

    wids = np.asarray(d["wids"])
    pos = np.asarray(d["pos"])
    feats = np.asarray(d["feats"])
    nodes = [MolTreeNode(vocab.get_smiles(int(wids[i])), pos[i], vocab=vocab,
                         hbd=float(feats[i, 0])) for i in range(len(wids))]
    adj = np.asarray(d["adj"]).copy()
    np.fill_diagonal(adj, 0)
    return MolTree(nodes=nodes, edge_index=np.nonzero(adj))
