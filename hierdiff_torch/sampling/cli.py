"""Sampling CLI of the port: coarse point sets, junction-tree assembly,
reconstruction to molecules and the pipeline from a histogram to molecules.

    # stage 1 (sampler.py equivalent): pickle blurred point sets
    python -m hierdiff_torch.sampling.cli coarse --weights coarse.pt \\
        --num 64 --out samples.pkl
    # random GEOM-width weights from a seed, 100 strided reverse steps
    python -m hierdiff_torch.sampling.cli coarse --init-seed 0 --steps 100
    # stage 2 (ar_sampling_nosize.py equivalent): point sets -> trees
    python -m hierdiff_torch.sampling.cli assemble --coarse-pkl samples.pkl \\
        --denoise-weights denoise.pt --out trees.pkl
    # all stages: histogram -> trees -> molecules (with RDKit)
    python -m hierdiff_torch.sampling.cli generate --init-seed 0 \\
        --denoise-init-seed 0 --num 64 --sample-steps 100 [--workers 4]
    # stage 3 (reconstruct.py equivalent): trees -> molecules, needs RDKit
    python -m hierdiff_torch.sampling.cli reconstruct --trees-pkl trees.pkl \\
        --out reconstructed.pkl
    # either, with the refine model checking the beam's trees
    python -m hierdiff_torch.sampling.cli assemble --coarse-pkl samples.pkl \\
        --denoise-init-seed 0 --refine-init-seed 0

Weights come from a ``.pt`` or ``.npz`` state dict in the reference layout
(``utils/weights.py``) or from a seed (``--init-seed`` for the coarse model,
``--denoise-init-seed`` for the edge-denoise model, ``--refine-init-seed``
for the refine model). The JAX package's Orbax workdirs need JAX to read;
convert them with ``state_dict_from_flax`` / ``denoise_state_dict_from_flax``
/ ``refine_state_dict_from_flax`` first. The models are the GEOM
configurations unless ``k=v`` overrides (``denoise.hidden_nf=32``) say
otherwise; ``generate``'s coarse model runs f32 elementwise, as ``coarse``
does by default. Runs on CUDA unless ``--device``
names another device.

With RDKit present, ``assemble`` and ``generate`` gate the search (and the
refine hook's swaps and its final repair) with ``chem.assemble_gate``, and
``generate`` reconstructs each tree into a molecule, as the JAX CLI does.
Without RDKit the search runs ungated and ``generate`` stops at junction
trees (``"molecules": None``); ``reconstruct`` raises ``RDKitUnavailable``.
"""

from __future__ import annotations

import argparse
import pickle
import time
from typing import Optional

import numpy as np
import torch

from hierdiff_torch.chem import has_rdkit, require_rdkit
from hierdiff_torch.config import (CoarseModelConfig, EdgeDenoiseConfig, RefineConfig,
                                   load_coarse_config, load_config)
from hierdiff_torch.data.assets import load_histogram, vocab_mol_sizes
from hierdiff_torch.data.collate import DEFAULT_BUCKETS, SAMPLING_BUCKETS
from hierdiff_torch.models.diffusion import CoarseDiffusion
from hierdiff_torch.models.edge_denoise import EdgeDenoise
from hierdiff_torch.models.refine import NodeRefine
from hierdiff_torch.ops.distributions import DistributionNodes
from hierdiff_torch.sampling.coarse import make_masks_for_counts, sample_coarse
from hierdiff_torch.sampling.pipeline import (GenerationPipeline, build_fine_sampler,
                                              round_int_features)
from hierdiff_torch.sampling.refine_hook import RefineHook
from hierdiff_torch.utils.device import resolve_device
from hierdiff_torch.utils.weights import init_weights


def build_coarse_from_cfg(cfg: CoarseModelConfig, compute_dtype=None,
                          device=None) -> CoarseDiffusion:
    """The coarse model of ``cfg`` on ``device`` (default CUDA), with
    PyTorch's default initialisation. ``compute_dtype`` overrides the
    config's elementwise type ('bfloat16' or 'float32')."""
    if cfg.pocket:
        raise NotImplementedError("the pocket-conditioned model is not ported")
    device = resolve_device(device)
    model = CoarseDiffusion(
        in_node_nf=cfg.in_node_nf, int_nf=cfg.int_nf, cont_nf=cfg.cont_nf,
        timesteps=cfg.timesteps, loss_type=cfg.loss_type,
        noise_schedule=cfg.noise_schedule, noise_precision=cfg.noise_precision,
        norm_values=cfg.norm_values, norm_biases=cfg.norm_biases,
        hidden_nf=cfg.hidden_nf, n_layers=cfg.n_layers, inv_sublayers=cfg.inv_sublayers,
        attention=cfg.attention, tanh=cfg.tanh, coords_range=cfg.coords_range,
        norm_constant=cfg.norm_constant, normalization_factor=cfg.normalization_factor,
        aggregation_method=cfg.aggregation_method, condition_time=cfg.condition_time,
        context_node_nf=cfg.context_node_nf,
        compute_dtype=cfg.compute_dtype if compute_dtype is None else compute_dtype,
        mode=cfg.mode, sin_embedding=cfg.sin_embedding)
    return model.to(device).eval()


def build_denoise_from_cfg(cfg: EdgeDenoiseConfig, device=None) -> EdgeDenoise:
    """The edge-denoise model of ``cfg`` on ``device`` (default CUDA), with
    PyTorch's default initialisation."""
    return EdgeDenoise(vocab_size=cfg.vocab_size, out_node_nf=cfg.out_node_nf,
                       in_node_nf=cfg.in_node_nf, hidden_nf=cfg.hidden_nf,
                       n_layers_full=cfg.n_layers_full, n_layers_focal=cfg.n_layers_focal,
                       focal_weight=cfg.focal_loss, edge_weight=cfg.edge_loss,
                       node_weight=cfg.node_loss, vocab_conditioning=cfg.vocab_conditioning
                       ).to(resolve_device(device)).eval()


def build_refine_from_cfg(cfg: RefineConfig, device=None) -> NodeRefine:
    """The refine model of ``cfg`` on ``device`` (default CUDA), with
    PyTorch's default initialisation."""
    return NodeRefine(vocab_size=cfg.vocab_size, feature_size=cfg.feature_size,
                      hidden_size=cfg.hidden_size, n_layers=cfg.n_layers
                      ).to(resolve_device(device)).eval()


def load_state(path: str) -> dict:
    """State dict from a ``.pt`` (torch.save) or ``.npz`` file."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            return {k: torch.from_numpy(data[k]) for k in data.files}
    return torch.load(path, map_location="cpu", weights_only=True)


def cmd_coarse(args) -> dict:
    """Sample ``args.num`` point sets and pickle them as ``[[{"x", "h"}, ...]]``.
    Returns the padded batches (x, h, node_mask) on the device and the
    sampling wall time."""
    device = resolve_device(args.device)
    cfg = load_coarse_config(args.config)
    model = build_coarse_from_cfg(cfg, "bfloat16" if args.bf16 else "float32", device)
    if args.weights:
        model.load_state_dict(load_state(args.weights), strict=True)
    elif args.init_seed is not None:
        init_weights(model, torch.Generator().manual_seed(args.init_seed))
    else:
        raise SystemExit("coarse: pass --weights or --init-seed")

    dist = DistributionNodes(load_histogram(cfg.dataset))
    rng_np = np.random.default_rng(args.seed)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    results, batches = [], []
    start = time.perf_counter()
    for first in range(0, args.num, args.batch_size):
        k = min(args.batch_size, args.num - first)
        counts = dist.sample_np(rng_np, k)
        if args.max_nodes:
            counts = np.minimum(counts, args.max_nodes)
        nm, em = make_masks_for_counts(counts)
        node_mask = torch.from_numpy(nm).to(device)
        xh = sample_coarse(model, node_mask, torch.from_numpy(em).to(device), generator,
                           steps=args.steps or None, packed=True)
        batches.append((xh[..., :3], xh[..., 3:], node_mask))
        xh_np = xh.cpu().numpy()
        for i, c in enumerate(counts):
            results.append({"x": xh_np[i, :c, :3], "h": xh_np[i, :c, 3:]})
    seconds = time.perf_counter() - start
    with open(args.out, "wb") as f:
        pickle.dump([results], f)   # list-wrapped like the reference pkl layout
    print(f"{len(results)} point sets -> {args.out} in {seconds:.3f} s "
          f"({len(results) / seconds:.3f} molecules/s, device {device})")
    return {"batches": batches, "seconds": seconds, "molecules": len(results)}


def _weights(model, path: str, seed: Optional[int], flags: str):
    """Load ``path`` into ``model``, or give it random weights from ``seed``."""
    if path:
        model.load_state_dict(load_state(path), strict=True)
    elif seed is not None:
        init_weights(model, torch.Generator().manual_seed(seed))
    else:
        raise SystemExit(f"pass {flags}")
    return model


def _fine_stage_setup(args, device):
    """Shared stage-2 setup of ``assemble`` and ``generate``: the
    configuration, the edge-denoise model with its weights, the pad buckets,
    with RDKit the vocabulary and the assembly gate (memoized per fragment
    and neighbour set; reference ar_sampling_nosize.py:199-200, 396-403),
    and, with refine weights or a seed for them, the refine hook (its
    fleets padded to the same buckets, its swaps and final repair gated)."""
    cfg = load_config(None, args.overrides)
    denoise = _weights(build_denoise_from_cfg(cfg.denoise, device), args.denoise_weights,
                       args.denoise_init_seed, "--denoise-weights or --denoise-init-seed")
    buckets = DEFAULT_BUCKETS if args.default_buckets else SAMPLING_BUCKETS
    vocab, gate = None, None
    if has_rdkit():
        from hierdiff_torch.chem.assemble_gate import make_assembly_gate
        from hierdiff_torch.chem.mol_tree import Vocab
        vocab = Vocab()
        gate = make_assembly_gate(vocab)
    hook = None
    if args.refine_weights or args.refine_init_seed is not None:
        refine = _weights(build_refine_from_cfg(cfg.refine, device), args.refine_weights,
                          args.refine_init_seed, "--refine-weights or --refine-init-seed")
        sizes = vocab.mol_sizes if vocab is not None else vocab_mol_sizes()
        hook = RefineHook(refine, np.asarray(sizes), can_assemble=gate, buckets=buckets)
    return cfg, denoise, buckets, hook, vocab, gate


def _search_line(hook, gate) -> str:
    """The refine hook's and the assembly gate's counters, for the rate
    lines."""
    if hook is None:
        line = "refine off"
    else:
        st = hook.stats
        line = (f"refine: {st['score_calls']} fused checks, dispatch {st['dispatch_s']:.3f} s, "
                f"collect {st['collect_s']:.3f} s, walk {st['walk_s']:.3f} s")
    if gate is None:
        return f"{line}; assembly gate off (no RDKit)"
    info = gate.cache_info()
    return f"{line}; assembly gate: {info.hits} hits, {info.misses} misses"


def _tree_to_dict(t):
    """TreeState -> the portable pickle form of the JAX package's CLI."""
    return None if t is None else {"wids": t.wids, "adj": t.adj, "pos": t.pos,
                                   "feats": t.feats, "logp": t.logp}


def _flatten_blur_pkl(obj) -> list:
    """Coarse pickles are nested containers of {'x', 'h'} dicts: the
    ``coarse`` command's is list-wrapped, the reference pickles
    sample_batches' raw ``(results, test_names)`` tuple (diffusion_qm9.py:437,
    sampler.py:40-41). Flatten any list/tuple nesting down to the dicts;
    other leaves (the pocket test_names strings) are skipped."""
    if isinstance(obj, dict):
        return [obj]
    if not isinstance(obj, (list, tuple)):
        return []
    out = []
    for item in obj:
        out.extend(_flatten_blur_pkl(item))
    return out


def cmd_assemble(args) -> dict:
    """Stage 2 on its own: a coarse pickle's point sets -> junction trees,
    pickled as ``{"trees": [...]}``. Returns the blur sets, the trees, the
    sampler, the lattices and the seconds of the lattices and of the search
    (the refine hook's checks and its ``finalize`` included)."""
    device = resolve_device(args.device)
    cfg, denoise, buckets, hook, _vocab, gate = _fine_stage_setup(args, device)
    with open(args.coarse_pkl, "rb") as f:
        blur = _flatten_blur_pkl(pickle.load(f))
    if args.num:
        blur = blur[: args.num]
    if any("context" in b for b in blur):
        # the reference's global-context variant concatenates jt['context']
        # into h before assembly (ar_sampling_nosize.py:278-279)
        raise SystemExit("coarse pickle carries global-context channels, "
                         "which this assemble path does not support")
    int_nf = 5 if cfg.denoise.in_node_nf == 8 else 3
    blur = [{"x": np.asarray(b["x"], np.float32),
             "h": round_int_features(np.asarray(b["h"], np.float32), int_nf)} for b in blur]
    sampler = build_fine_sampler(denoise, beam_size=args.beam, buckets=buckets,
                                 can_assemble=gate, refine_hook=hook)
    t0 = time.perf_counter()
    lattices = sampler.compute_lattices(blur)
    t1 = time.perf_counter()
    trees = sampler._search(blur, lattices)
    if hook is not None:
        trees = [hook.finalize(t) if t is not None else None for t in trees]
    t2 = time.perf_counter()
    ok = sum(t is not None for t in trees)
    print(f"assembled {ok}/{len(blur)} junction trees in {t2 - t0:.3f} s "
          f"({len(blur) / (t2 - t0):.3f} trees/s, device {device}): lattices {t1 - t0:.3f} s, "
          f"search {t2 - t1:.3f} s; {_search_line(hook, gate)}")
    with open(args.out, "wb") as f:
        pickle.dump({"trees": [_tree_to_dict(t) for t in trees]}, f)
    print(f"-> {args.out}")
    return {"blur": blur, "trees": trees, "sampler": sampler, "lattices": lattices,
            "lattice_s": t1 - t0, "search_s": t2 - t1, "gate": gate}


def cmd_generate(args) -> dict:
    """Histogram -> coarse point sets -> junction trees -> molecules,
    pickled as ``{"trees": [...], "molecules": [...], "stats": {...}}``
    (``"molecules": None`` without RDKit). Returns the pipeline's result,
    the pipeline and the wall seconds."""
    device = resolve_device(args.device)
    cfg, denoise, buckets, hook, vocab, gate = _fine_stage_setup(args, device)
    coarse = _weights(build_coarse_from_cfg(cfg.coarse, "float32", device),
                      args.weights, args.init_seed, "--weights or --init-seed")
    pipe = GenerationPipeline(coarse, denoise, histogram=load_histogram(cfg.coarse.dataset),
                              beam_size=args.beam, int_nf=cfg.coarse.int_nf,
                              max_n_cap=args.max_nodes or None,
                              sample_steps=args.steps or None, sample_buckets=buckets,
                              refine_hook=hook, vocab=vocab, can_assemble=gate)
    t0 = time.perf_counter()
    result = pipe.run(args.seed, args.num, reconstruct=has_rdkit(), n_workers=args.workers)
    seconds = time.perf_counter() - t0
    ok = sum(t is not None for t in result.trees)
    t_rec = result.stats.get("t_reconstruct")
    print(f"assembled {ok}/{args.num} junction trees in {seconds:.3f} s "
          f"({args.num / seconds:.3f} molecules/s, device {device}): t_coarse "
          f"{result.stats['t_coarse']:.3f} s, t_fine {result.stats['t_fine']:.3f} s"
          + ("" if t_rec is None else f", t_reconstruct {t_rec:.3f} s")
          + f"; {_search_line(hook, gate)}")
    if result.molecules is None:
        print("reconstruction skipped: RDKit is not installed (the pickle holds junction trees)")
    else:
        print("reconstruction:", result.stats)
    with open(args.out, "wb") as f:
        pickle.dump({"trees": [_tree_to_dict(t) for t in result.trees],
                     "molecules": result.molecules, "stats": result.stats}, f)
    print(f"-> {args.out}")
    return {"result": result, "pipeline": pipe, "seconds": seconds}


def cmd_reconstruct(args) -> dict:
    """Stage 3 on its own: a trees pickle (``assemble`` or ``generate``)
    -> RDKit molecules, pickled as ``{"molecules": [...], "stats": {...}}``
    with the reference's valid / unique / avg_atoms
    (generation/reconstruct.py:54-106). Returns both."""
    require_rdkit("reconstruction")
    from hierdiff_torch.chem.mol_tree import Vocab
    from hierdiff_torch.chem.reconstruct import reconstruct_batch
    from hierdiff_torch.sampling.pipeline import tree_dict_to_moltree

    with open(args.trees_pkl, "rb") as f:
        payload = pickle.load(f)
    tree_dicts = payload["trees"] if isinstance(payload, dict) else payload
    vocab = Vocab()
    jt = [tree_dict_to_moltree(d, vocab) for d in tree_dicts if d is not None]
    print(f"{len(jt)} trees loaded from {args.trees_pkl}")
    t0 = time.perf_counter()
    molecules, stats = reconstruct_batch(jt, vocab, args.workers)
    seconds = time.perf_counter() - t0
    print(f"reconstruction: {stats} in {seconds:.3f} s ({args.workers} workers)")
    with open(args.out, "wb") as f:
        pickle.dump({"molecules": molecules, "stats": stats}, f)
    print(f"-> {args.out}")
    return {"molecules": molecules, "stats": stats, "seconds": seconds}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="HierDiff sampling (PyTorch port)")
    sub = p.add_subparsers(dest="cmd", required=True)
    pc = sub.add_parser("coarse", help="stage-1 blurred point sets")
    pc.add_argument("--config", default="",
                    help="YAML in the JAX package's format (default: GEOM config)")
    pc.add_argument("--weights", default="", help=".pt or .npz state dict")
    pc.add_argument("--init-seed", type=int, default=None,
                    help="random weights from this seed instead of --weights")
    pc.add_argument("--num", type=int, default=64)
    pc.add_argument("--batch-size", type=int, default=64)
    pc.add_argument("--sample-steps", "--steps", dest="steps", type=int, default=0,
                    help="strided reverse-chain steps (0 = the model's full T); --steps "
                         "is the port's earlier name")
    pc.add_argument("--seed", type=int, default=2022)
    pc.add_argument("--max-nodes", type=int, default=0)
    pc.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=False,
                    help="bf16 elementwise edge pipeline. Default f32, unlike the JAX CLI "
                         "(default bf16): on the H100 the bf16 kernels are the slower "
                         "ones (PERF.md)")
    pc.add_argument("--device", default=None, help="torch device (default cuda)")
    pc.add_argument("--out", default="sample_results.pkl")
    pc.set_defaults(fn=cmd_coarse)

    def fine_args(sp, out: str) -> None:
        sp.add_argument("--denoise-weights", default="", help=".pt or .npz state dict")
        sp.add_argument("--denoise-init-seed", type=int, default=None,
                        help="random edge-denoise weights from this seed")
        sp.add_argument("--refine-weights", default="",
                        help="refine .pt or .npz state dict: check the beam's trees with it")
        sp.add_argument("--refine-init-seed", type=int, default=None,
                        help="random refine weights from this seed")
        sp.add_argument("--beam", type=int, default=5)
        sp.add_argument("--default-buckets", action="store_true",
                        help="pad to the coarser DEFAULT_BUCKETS instead of SAMPLING_BUCKETS")
        sp.add_argument("--device", default=None, help="torch device (default cuda)")
        sp.add_argument("--out", default=out)
        sp.add_argument("overrides", nargs="*",
                        help="dotted overrides, in one run: denoise.hidden_nf=32 "
                             "refine.hidden_size=32 coarse.n_layers=1")

    pa = sub.add_parser("assemble", help="stage 2: blur point sets -> junction trees "
                                         "(reference ar_sampling_nosize.py)")
    pa.add_argument("--coarse-pkl", required=True,
                    help="pickle from `coarse` (or a reference sample_results.pkl)")
    pa.add_argument("--num", type=int, default=0, help="cap (0 = all)")
    fine_args(pa, "assembled_trees.pkl")
    pa.set_defaults(fn=cmd_assemble)

    pg = sub.add_parser("generate", help="histogram -> coarse point sets -> junction trees "
                                         "-> molecules (with RDKit)")
    pg.add_argument("--weights", default="", help="coarse .pt or .npz state dict")
    pg.add_argument("--init-seed", type=int, default=None,
                    help="random coarse weights from this seed")
    pg.add_argument("--num", type=int, default=64)
    pg.add_argument("--sample-steps", "--steps", dest="steps", type=int, default=0,
                    help="strided reverse-chain steps (0 = the model's full T)")
    pg.add_argument("--seed", type=int, default=2022)
    pg.add_argument("--max-nodes", type=int, default=0)
    pg.add_argument("--workers", type=int, default=0,
                    help="reconstruction processes (0 or 1: in this process)")
    fine_args(pg, "generated.pkl")
    pg.set_defaults(fn=cmd_generate)

    pr = sub.add_parser("reconstruct", help="stage 3: trees -> RDKit molecules "
                                            "(reference generation/reconstruct.py)")
    pr.add_argument("--trees-pkl", required=True, help="pickle from `assemble` or `generate`")
    pr.add_argument("--workers", type=int, default=0)
    pr.add_argument("--out", default="reconstructed.pkl")
    pr.set_defaults(fn=cmd_reconstruct)
    return p


def main(argv: Optional[list] = None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
