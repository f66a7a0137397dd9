"""Sampling CLI of the port: coarse point clouds.

    # stage 1 (sampler.py equivalent): pickle blurred point sets
    python -m hierdiff_torch.sampling.cli coarse --weights coarse.pt \\
        --num 64 --out samples.pkl
    # random GEOM-width weights from a seed, 100 strided reverse steps
    python -m hierdiff_torch.sampling.cli coarse --init-seed 0 --steps 100

Weights come from a ``.pt`` or ``.npz`` state dict in the reference layout
(``utils/weights.py``) or from ``--init-seed``. The JAX package's Orbax
workdirs need JAX to read; convert them with ``state_dict_from_flax`` first.
Runs on CUDA unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import pickle
import time
from typing import Optional

import numpy as np
import torch

from hierdiff_torch.config import CoarseModelConfig, load_coarse_config
from hierdiff_torch.data.assets import load_histogram
from hierdiff_torch.models.diffusion import CoarseDiffusion
from hierdiff_torch.ops.distributions import DistributionNodes
from hierdiff_torch.sampling.coarse import make_masks_for_counts, sample_coarse
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
    return p


def main(argv: Optional[list] = None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
