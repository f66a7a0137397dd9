"""Generation pipeline: coarse point sets -> junction trees -> molecules.

Port of ``hierdiff_tpu/sampling/pipeline.py`` (``GenerationPipeline.run``
serial and overlapped, ``run_streamed``, ``build_fine_sampler``,
``round_int_features``):

1. coarse: node counts from the histogram prior, grouped by pad bucket and
   chunked, each chunk a run of ``sample_coarse`` (the coarse kernels on the
   card);
2. fine: the lattice sampler (the round-based ``ARSampler`` under
   ``vocab_conditioning``) assembles a junction tree per molecule, with the
   refine hook's checks and the assembly gate in its search when they are
   given, and the hook's ``finalize`` repair after it;
3. reconstruct: host RDKit assembly of each tree into a molecule
   (``chem/reconstruct.py``), when RDKit is present and a vocabulary is set.

By default ``run`` overlaps stages 1 and 2 (``_BlurFeeder`` into
``LatticeSampler.sample_streamed``): the fine stage takes each coarse chunk
as its copy lands while the next chunks run. The chunk plan and the chunks'
seeds are those of the serial path, so the point sets are bitwise the same.
``run_streamed`` also overlaps stage 3, reconstructing each macro-chunk in
a process pool while the next one samples. The JAX package's segmented
coarse chain (a workaround for the TPU's queue) is not carried over.

Integer blur features are rounded at the hand-off between the stages, as in
the reference (ar_sampling_nosize.py:388).

Inside a ``torch.distributed`` group (``parallel/mesh.py``) the device
work is sharded over its ranks: every rank plans the coarse chunks as one
process would and runs its share (chunks r, r + size, ...), the point sets
are gathered on every rank in index order, the lattices are sharded the
same way (``LatticeSampler``), and rank 0 alone searches, repairs and
reconstructs. The stages then run one after the other, as the
JAX package runs them on a mesh. Since a chunk's samples depend on the chunk
alone, the point sets and trees are bitwise those of one process on the same
kind of device. Other ranks return None from ``run`` and ``run_streamed``.

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
from collections import deque
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from hierdiff_torch.chem import has_rdkit
from hierdiff_torch.data.collate import SAMPLING_BUCKETS, bucket_for
from hierdiff_torch.models.diffusion import CoarseDiffusion
from hierdiff_torch.models.edge_denoise import EdgeDenoise
from hierdiff_torch.ops.distributions import DistributionNodes
from hierdiff_torch.parallel import mesh
from hierdiff_torch.sampling.beam import TreeState
from hierdiff_torch.sampling.coarse import make_masks_for_counts, sample_coarse
from hierdiff_torch.sampling.ar import ARSampler
from hierdiff_torch.sampling.lattice import HostCopy, LatticeSampler, _next_pow2, pow2_chunks


def build_fine_sampler(denoise_model: EdgeDenoise, *, beam_size: int = 5,
                       buckets: Optional[Sequence[int]] = None, can_assemble=None,
                       refine_hook=None, allowed_fn=None):
    """Stage-2 sampler for a denoise model, with the assembly gate
    ``can_assemble``, the refine hook's checks and the per-node vocab
    restriction ``allowed_fn`` in its search when they are given: the
    lattice sampler (its lattices sharded over a process group's ranks), or
    the round-based ``ARSampler`` when type choices feed back into the
    trajectory (``vocab_conditioning``; it runs on rank 0 alone, as the JAX
    package's does on a mesh)."""
    if denoise_model.vocab_conditioning:
        return ARSampler(denoise_model, beam_size=beam_size, can_assemble=can_assemble,
                         refine_hook=refine_hook, allowed_fn=allowed_fn, buckets=buckets)
    return LatticeSampler(denoise_model, beam_size=beam_size, buckets=buckets,
                          can_assemble=can_assemble, refine_hook=refine_hook,
                          allowed_fn=allowed_fn)


def round_int_features(h: np.ndarray, int_nf: int) -> np.ndarray:
    """Integer blur dims rounded at the stage-1/2 hand-off
    (reference: ar_sampling_nosize.py:388)."""
    return np.concatenate([np.round(h[:, :int_nf]), h[:, int_nf:]], axis=1)


def chunk_seed(seed: int, first: int) -> int:
    """Seed of the torch.Generator of the coarse chunk whose first molecule
    is ``first``."""
    return int(np.random.SeedSequence([seed, first]).generate_state(1, np.uint64)[0])


COARSE_INFLIGHT = 2      # coarse chunks the feeder keeps launched


class _BlurFeeder:
    """Feeds the coarse chunks to ``LatticeSampler.sample_streamed``.

    Keeps COARSE_INFLIGHT coarse chunks launched, each with its packed
    samples copied to the host behind an event (``HostCopy``). ``pump()``
    does not wait: it takes in the chunks whose copy has landed and
    launches the next. ``collect_next()`` waits for the oldest. The chunk
    plan and the chunks' seeds are the serial path's, so the point sets are
    bitwise the same. In eager PyTorch a launch
    runs the chain's whole host loop, so the overlap is single-threaded:
    the fine stage works between launches."""

    def __init__(self, pipe: "GenerationPipeline", seed: int, counts: np.ndarray,
                 batch_size: Optional[int] = None):
        self.pipe = pipe
        self.seed = seed
        self.counts = counts
        self.chunks = pipe._plan_chunks(counts, batch_size)
        self.total = len(counts)
        self.blur: List[Optional[Dict[str, np.ndarray]]] = [None] * self.total
        self.inflight = deque()
        self.pos = 0
        self.t_last_coarse: Optional[float] = None
        self._top_up()

    def _top_up(self) -> None:
        while len(self.inflight) < COARSE_INFLIGHT and self.pos < len(self.chunks):
            nb, chunk = self.chunks[self.pos]
            self.pos += 1
            xh = self.pipe._dispatch_coarse(self.seed, self.counts, nb, chunk)
            self.inflight.append((chunk, HostCopy((xh,))))

    @property
    def done(self) -> bool:
        return not self.inflight and self.pos >= len(self.chunks)

    def _absorb(self, chunk, copy: HostCopy) -> list:
        self.pipe._absorb_coarse(chunk, copy.wait()[0], self.counts, self.blur)
        if self.done:
            self.t_last_coarse = time.perf_counter()
        return list(chunk)

    def pump(self) -> List[list]:
        out = []
        while self.inflight and self.inflight[0][1].is_ready():
            chunk, copy = self.inflight.popleft()
            self._top_up()               # keep the device fed before reading
            out.append(self._absorb(chunk, copy))
        self._top_up()
        return out

    def collect_next(self) -> List[list]:
        if not self.inflight:
            return []
        chunk, copy = self.inflight.popleft()
        self._top_up()                   # launch the next before waiting
        return [self._absorb(chunk, copy)]


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
                 vocab=None, can_assemble=None, allowed_fn=None):
        """sample_steps: strided reverse-chain length (None: the model's T).
        sample_buckets: pad buckets of the coarse chunks, the lattices and
        the refine hook's fleets (None: ``SAMPLING_BUCKETS``, the JAX
        pipeline's default). refine_hook: a ``RefineHook`` or None. vocab: the
        ``chem.mol_tree.Vocab`` that reconstruction reads (None: no
        reconstruction). can_assemble: the search's assembly gate or None.
        allowed_fn: the per-node vocab restriction of the fine sampler
        (``LatticeSampler``) or None."""
        self.coarse_model = coarse_model
        self.nodes_dist = DistributionNodes(histogram)
        self.sample_buckets = tuple(sample_buckets or SAMPLING_BUCKETS)
        if refine_hook is not None:
            # a group's fleets must pad to the group's own bucket, or merged
            # lanes stop being equal to solo ones; align the hook's set
            refine_hook.buckets = self.sample_buckets
        self.sampler = build_fine_sampler(denoise_model, beam_size=beam_size,
                                          buckets=self.sample_buckets, can_assemble=can_assemble,
                                          refine_hook=refine_hook, allowed_fn=allowed_fn)
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

    def _blur_for_counts(self, seed: int, counts: np.ndarray,
                         batch_size: Optional[int] = None) -> List[Dict[str, np.ndarray]]:
        """Stage 1 for given node counts: every chunk is queued first, then
        each is copied to the host once; in a process group, this rank's
        share of the chunks, gathered on every rank."""
        out: List[Optional[Dict[str, np.ndarray]]] = [None] * len(counts)
        plan = self._plan_chunks(counts, batch_size)
        pending = [(k, self._dispatch_coarse(seed, counts, nb, chunk))
                   for k, (nb, chunk) in mesh.my_share(list(enumerate(plan)))]
        samples = mesh.all_gather_dict({k: xh.cpu().numpy() for k, xh in pending})
        for k, (_, chunk) in enumerate(plan):
            self._absorb_coarse(chunk, samples[k], counts, out)
        return out  # type: ignore[return-value]

    def sample_blur(self, seed: int, n_molecules: int) -> List[Dict[str, np.ndarray]]:
        """Stage 1: coarse point sets, sizes from the histogram prior drawn
        with ``np.random.default_rng(seed)``."""
        counts = self._sample_counts(np.random.default_rng(seed), n_molecules)
        return self._blur_for_counts(seed, counts)

    def _blur_and_trees(self, seed: int, counts: np.ndarray, overlap: bool,
                        batch_size: Optional[int] = None):
        """Stages 1 and 2 for given node counts, the hook's ``finalize``
        included: (blur, trees, the wall when the last coarse chunk
        landed). ``overlap`` streams the coarse chunks into the fine stage
        when the fine sampler can take them (the round-based one cannot)
        and the process is in no group. In a group, trees is None on ranks
        other than 0."""
        if overlap and not mesh.in_group() and hasattr(self.sampler, "sample_streamed"):
            feeder = _BlurFeeder(self, seed, counts, batch_size)
            trees = self.sampler.sample_streamed(feeder)
            blur = feeder.blur
            t1 = feeder.t_last_coarse or time.perf_counter()
        else:
            blur = self._blur_for_counts(seed, counts, batch_size)
            t1 = time.perf_counter()
            trees = self.sampler.sample(blur)
            if trees is None:   # a rank other than 0
                return blur, None, t1
        hook = self.sampler.refine_hook
        if hook is not None:
            # end-of-search repair of non-assemblable fragments
            # (reference: model_refine.py:252-299 check_final_tree)
            trees = [hook.finalize(t) if t is not None else None for t in trees]
        return blur, trees, t1

    def run(self, seed: int, n_molecules: int, reconstruct: bool = True,
            n_workers: int = 0, overlap: bool = True,
            batch_size: Optional[int] = None) -> Optional[PipelineResult]:
        """Coarse, fine, then reconstruction. ``overlap`` streams the coarse
        chunks into the fine stage (off: one stage after the other, the
        reference the tests hold it to); the point sets are the same either
        way. ``stats`` holds ``t_coarse`` (overlapped: the wall until the
        last coarse chunk landed, with fine work already done under it) and
        ``t_fine`` (the rest, the hook's
        ``finalize`` included). With ``reconstruct``, RDKit present and a
        vocabulary set, the trees that were assembled become molecules
        (``n_workers`` > 1: a process pool), and ``stats`` gains the
        reconstruction's valid, unique, avg_atoms and ``t_reconstruct``.
        batch_size: molecules per coarse chunk at most (None: 64). In a
        process group, None on ranks other than 0."""
        t0 = time.perf_counter()
        counts = self._sample_counts(np.random.default_rng(seed), n_molecules)
        blur, trees, t1 = self._blur_and_trees(seed, counts, overlap, batch_size)
        if trees is None:
            return None
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

    def run_streamed(self, seed: int, n_molecules: int, chunk_size: int = 1024,
                     n_workers: int = 2) -> PipelineResult:
        """Generation in macro-chunks of ``chunk_size`` molecules with stage
        3 overlapped: each chunk's trees are reconstructed in a forked
        process pool (``map_async``; the workers touch no CUDA) while the
        next chunk samples on the card; within a chunk the stages overlap as
        in ``run``. Chunk k draws its counts from one
        ``np.random.default_rng(seed)`` stream, and its coarse chunks take
        ``chunk_seed(seed, 1000 + k)`` as their run's seed. Without RDKit or
        a vocabulary it is ``run`` without reconstruction. ``stats``: the
        reconstruction's panel, ``t_device`` (stages 1 and 2, summed over
        the chunks) and ``t_total``. In a process group, every rank samples
        its share of each chunk and rank 0 alone holds the pool; None on the
        other ranks."""
        if not (has_rdkit() and self.vocab is not None):
            return self.run(seed, n_molecules, reconstruct=False)
        import multiprocessing as mp

        from hierdiff_torch.chem.reconstruct import _pool_init, _pool_one, summarize_outputs

        rng_np = np.random.default_rng(seed)
        t0 = time.perf_counter()
        t_device = 0.0
        blur_all: List[Dict[str, np.ndarray]] = []
        trees_all: List[Optional[TreeState]] = []
        pending = []
        main = mesh.world()[0] == 0
        # fork: the workers inherit sys.modules (an RDKit stand-in included)
        pool = (mp.get_context("fork").Pool(max(n_workers, 1), initializer=_pool_init,
                                            initargs=(self.vocab,)) if main else None)
        try:
            for k, c0 in enumerate(range(0, n_molecules, chunk_size)):
                m = min(chunk_size, n_molecules - c0)
                td = time.perf_counter()
                counts = self._sample_counts(rng_np, m)
                blur, trees, _ = self._blur_and_trees(chunk_seed(seed, 1000 + k), counts, True)
                t_device += time.perf_counter() - td
                if trees is None:
                    continue
                blur_all.extend(blur)
                trees_all.extend(trees)
                jt = [tree_state_to_moltree(t, self.vocab) for t in trees if t is not None]
                pending.append(pool.map_async(_pool_one, jt))
            outputs = [o for p in pending for o in p.get()]
        finally:
            if pool is not None:
                pool.terminate()
                pool.join()
        if not main:
            return None
        results, stats = summarize_outputs(outputs)
        out = PipelineResult(blur=blur_all, trees=trees_all, molecules=results)
        out.stats = dict(stats, t_device=t_device, t_total=time.perf_counter() - t0)
        return out

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
