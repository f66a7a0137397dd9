"""Entry points of the port: a forward check and a multi-rank dry run.

Counterpart of the JAX package's ``__graft_entry__.py``.

``entry()`` returns a forward-loss function of the flagship model
(``CoarseDiffusion`` at the JAX dry run's size: 8 node features, hidden 64,
2 blocks, T = 10, a batch of 8 molecules of at most 8 nodes) and its example
arguments, on the card unless the CPU is asked for.

``dryrun_multichip(n)`` spawns n ranks (``parallel/mesh.spawn``) and runs, in
each, the three checks of the JAX dry run:

1. one data-parallel training step (AdamW 1e-4, EMA 0.999) on a global batch
   of 2n molecules: a finite loss and parameters bitwise equal on every rank;
2. sharded generation: 2n molecules in coarse and lattice chunks of 2, so
   that every rank samples a share (as the JAX dry run's one chunk of 2n
   rows puts 2 on each device), every tree assembled;
3. the refine hook, the assembly gate and reconstruction under the
   fake-RDKit harness (``tests/fake_rdkit.py``): the search restricted to
   the self-assemblable hub fragment C1CC1, the gate rejecting every other
   fragment the refine hook proposes, every tree assembled and
   reconstructed, validity 1; again every rank samples a share.

Rank 0's report names each rank's coarse chunks (``coarse_chunks``), from
which a rank's kernel launches on the card follow (``expected_launches``).

NCCL is the backend when n is at most the number of visible cards; past
that, the caller names another (``backend="gloo"``: then ranks share cards,
rank r on card r modulo their number). ``python -m hierdiff_torch.entry N
[--backend gloo] [--device cpu]`` runs it from the shell.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from hierdiff_torch.models.diffusion import CoarseDiffusion
from hierdiff_torch.sampling.coarse import make_masks_for_counts
from hierdiff_torch.utils.device import resolve_device
from hierdiff_torch.utils.weights import init_weights

TESTS = Path(__file__).resolve().parents[1] / "tests"   # the fake-RDKit harness


LAYERS, SUBLAYERS, TIMESTEPS = 2, 2, 10    # the dry run's CoarseDiffusion


def _tiny_model_and_batch(device: torch.device, b: int = 8, n: int = 8, hidden: int = 64):
    """The JAX dry run's model and batch (``_tiny_model_and_batch``), the
    weights from seed 0."""
    model = CoarseDiffusion(in_node_nf=8, timesteps=TIMESTEPS, hidden_nf=hidden,
                            n_layers=LAYERS, inv_sublayers=SUBLAYERS, noise_schedule="learned")
    model = init_weights(model, torch.Generator().manual_seed(0)).to(device)
    rng = np.random.default_rng(0)
    counts = rng.integers(3, n + 1, size=b)
    nm, em = make_masks_for_counts(counts, n)
    arrays = {"positions": rng.standard_normal((b, n, 3)).astype(np.float32) * nm,
              "node_feature": rng.standard_normal((b, n, 8)).astype(np.float32) * nm,
              "atom_mask": nm, "edge_mask": em}
    return model, {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def _loss(model: CoarseDiffusion, batch: Dict[str, torch.Tensor],
          generator: Optional[torch.Generator]):
    return model(batch, generator, train=True)["loss"]


def entry(device=None) -> Tuple[Callable, tuple]:
    """(fn, example_args): ``fn(model, batch, generator)`` is the training
    loss of the flagship model (a forward, no update)."""
    device = resolve_device(device)
    model, batch = _tiny_model_and_batch(device)
    return _loss, (model.train(), batch, torch.Generator(device=device).manual_seed(2))


def dryrun_multichip(n: int, backend: Optional[str] = None, device=None,
                     timeout: float = 900.0) -> dict:
    """Spawn ``n`` ranks and run the three checks (module docstring); returns
    rank 0's report (``lines``, ``loss``, every rank's coarse chunks,
    ``coarse_chunks``) with every rank's kernel launches (``launches``, by
    rank). Raises if a check fails on any rank."""
    device = resolve_device(device)
    if backend is None:
        cards = torch.cuda.device_count() if device.type == "cuda" else 0
        if n > cards:
            raise ValueError(f"{n} ranks need {n} visible cards for NCCL ({cards} here); "
                             f"pass backend='gloo' to share them")
        backend = "nccl"
    from hierdiff_torch.parallel.mesh import spawn

    reports = spawn(_dryrun_rank, n, backend, args=(device.type,), timeout=timeout)
    report = dict(reports[0], launches=[r["launches"] for r in reports])
    for line in report["lines"]:
        print(line, flush=True)
    return report


def expected_launches(coarse_chunks: int) -> Dict[str, int]:
    """The kernel launches of a dry-run rank on the card whose shares held
    ``coarse_chunks`` coarse chunks: the training step's GCLs forward and
    backward (and its coordinate updates through autograd), then per chunk
    one forward a reverse step, T + 1 of them."""
    gcls, steps = LAYERS * SUBLAYERS, TIMESTEPS + 1
    return {"fused_gcl": gcls + coarse_chunks * steps * gcls,
            "fused_coord_update": coarse_chunks * steps * LAYERS,
            "fused_gcl_bwd": gcls, "coord_update_autograd": LAYERS}


def _shares(pipe, result, batch_size: int, size: int) -> Dict[str, list]:
    """Every rank's number of coarse and lattice chunks in a run's plans
    (the plans every rank holds); raises if a rank's share is empty."""
    counts = np.asarray([b["x"].shape[0] for b in result.blur])
    plans = {"coarse": pipe._plan_chunks(counts, batch_size),
             "lattice": pipe.sampler._plan_lattices(result.blur, range(len(counts)))}
    shares = {k: [len(plan[r::size]) for r in range(size)] for k, plan in plans.items()}
    if min(min(v) for v in shares.values()) == 0:
        raise AssertionError(f"a rank has no share of the chunks: {shares}")
    return shares


def _dryrun_rank(device_type: str) -> dict:
    from hierdiff_torch.config import OptimConfig
    from hierdiff_torch.data.assets import load_histogram
    from hierdiff_torch.models.edge_denoise import EdgeDenoise
    from hierdiff_torch.ops import egnn_kernels
    from hierdiff_torch.parallel import mesh
    from hierdiff_torch.parallel.train_step import TrainState, train_step
    from hierdiff_torch.sampling.pipeline import GenerationPipeline

    rank, size = mesh.world()
    device = mesh.rank_device(torch.device(device_type))
    egnn_kernels.reset_launch_counts()
    lines = []
    coarse_chunks = [0] * size

    # 1. one data-parallel training step
    model, batch = _tiny_model_and_batch(device, b=2 * size)
    state = TrainState(mesh.replicate(model.train()),
                       OptimConfig(lr=1e-4, weight_decay=4e-8, grad_clip=None, ema_decay=0.999))
    generator = torch.Generator(device=device).manual_seed(mesh.rank_seed(0, rank))
    metrics = train_step(state, lambda m, b, g: (_loss(m, b, g), {}),
                         mesh.shard_batch(batch, rank, size), generator)
    loss = float(metrics["loss"])
    flat = torch.cat([p.detach().reshape(-1) for p in state.model.parameters()]).cpu().numpy()
    copies = [None] * size
    torch.distributed.all_gather_object(copies, flat)
    in_sync = [np.array_equal(c, flat) for c in copies]
    if loss != loss or not all(in_sync):
        raise AssertionError(f"DP train step: loss {loss}, parameters in sync {in_sync}")
    lines.append(f"dryrun_multichip({size}): one DP train step OK, loss={loss:.3f}, "
                 f"grad_norm={float(metrics['grad_norm']):.3f}, parameters bitwise equal on "
                 f"{size} ranks")
    coarse = state.model.eval()

    # 2. sharded generation: chunks of 2 molecules, one a rank
    denoise = init_weights(EdgeDenoise(hidden_nf=32, n_layers_full=1, n_layers_focal=1),
                           torch.Generator().manual_seed(2)).to(device).eval()
    pipe = GenerationPipeline(coarse, denoise, histogram=load_histogram("geom"), beam_size=3,
                              max_n_cap=6)
    pipe.sampler.max_chunk = 2
    n_mol = 2 * size
    result = pipe.run(7, n_mol, reconstruct=False, batch_size=2)
    if rank == 0:
        ok = sum(t is not None for t in result.trees)
        if ok != n_mol:
            raise AssertionError(f"sharded generation assembled {ok}/{n_mol} trees")
        shares = _shares(pipe, result, 2, size)
        coarse_chunks = shares["coarse"]
        lines.append(f"dryrun_multichip({size}): sharded coarse+lattice generation OK, "
                     f"{ok}/{n_mol} trees assembled; chunks by rank {shares}")

    # 3. refine hook + rejecting gate + reconstruction, under the harness
    sys.path.insert(0, str(TESTS))
    import fake_rdkit
    fake_rdkit.install()
    try:
        from hierdiff_torch.chem.assemble_gate import make_assembly_gate
        from hierdiff_torch.chem.mol_tree import Vocab
        from hierdiff_torch.models.refine import NodeRefine
        from hierdiff_torch.sampling.refine_hook import RefineHook

        vocab = Vocab()
        # seed 4: among its untrained refine model's proposals is a swap to
        # another fragment, which the gate must reject (seed 3's proposes
        # only the hub, so it would leave the gate's veto unexercised)
        refine = init_weights(NodeRefine(hidden_size=32, n_layers=1),
                              torch.Generator().manual_seed(4)).to(device).eval()
        # untrained models almost never pick mutually assemblable fragments,
        # so the search is restricted to one hub fragment that assembles
        # with 1-3 of itself (max_n_cap=4 bounds the degree at 3), while the
        # size-restricted refine hook proposes any fragment: the gate then
        # really rejects its swaps (ar_sampling_nosize.py:138-143, 199-200)
        real_gate = make_assembly_gate(vocab)
        hub = vocab.get_index("C1CC1")
        rejections = [0]

        def verdict(wid, neis):
            if wid != hub or any(n_ != hub for n_ in neis):
                rejections[0] += 1
                return False
            return real_gate.verdict(wid, neis)

        def gate(state_, i):
            wid = int(state_.wids[i])
            if wid < 0:
                return True
            row = np.nonzero(state_.adj[i])[0]
            neis = tuple(sorted(int(state_.wids[j]) for j in row
                                if j != i and int(state_.wids[j]) >= 0))
            return verdict(wid, neis) if neis else True

        gate.verdict = verdict
        gate.cache_info = real_gate.cache_info
        hook = RefineHook(refine, np.asarray(vocab.mol_sizes), check_frac=0.5,
                          can_assemble=gate)
        pipe2 = GenerationPipeline(coarse, denoise, histogram=load_histogram("geom"),
                                   beam_size=3, max_n_cap=4, refine_hook=hook,
                                   can_assemble=gate, vocab=vocab,
                                   allowed_fn=lambda feats: [[hub]] * feats.shape[0])
        n_mol2 = max(16, 2 * size)
        per_chunk = n_mol2 // size   # so that every rank has a chunk
        pipe2.sampler.max_chunk = per_chunk
        result2 = pipe2.run(9, n_mol2, reconstruct=True, batch_size=per_chunk)
        if rank == 0:
            assembled = sum(t is not None for t in result2.trees)
            recon = len(result2.molecules or [])
            if not (assembled == n_mol2 and rejections[0] > 0 and recon == assembled
                    and result2.stats["valid"] == 1.0):
                raise AssertionError(f"refine+gate+reconstruct: {assembled}/{n_mol2} assembled, "
                                     f"{rejections[0]} rejections, {recon} reconstructed, "
                                     f"stats {result2.stats}")
            shares2 = _shares(pipe2, result2, per_chunk, size)
            coarse_chunks = [a + b for a, b in zip(coarse_chunks, shares2["coarse"])]
            lines.append(f"dryrun_multichip({size}): refine+gate+reconstruct OK, "
                         f"{assembled}/{n_mol2} trees gated-assembled, {recon} molecules "
                         f"reconstructed (validity {result2.stats['valid']:.2f}), "
                         f"{rejections[0]} gate rejections; chunks by rank {shares2}")
    finally:
        fake_rdkit.uninstall()
    return {"lines": lines, "loss": loss, "launches": dict(egnn_kernels.launch_counts),
            "coarse_chunks": coarse_chunks}


def main(argv: Optional[list] = None) -> dict:
    parser = argparse.ArgumentParser(description="multi-rank dry run of the port")
    parser.add_argument("n", type=int, nargs="?", default=8, help="ranks")
    parser.add_argument("--backend", default=None,
                        help="process-group backend (default NCCL, which needs n cards)")
    parser.add_argument("--device", default=None, help="torch device (default cuda)")
    args = parser.parse_args(argv)
    return dryrun_multichip(args.n, backend=args.backend, device=args.device)


if __name__ == "__main__":
    main()
