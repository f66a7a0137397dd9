"""The plain reference against the port's plain CPU route at tiny sizes, in
float32: the same weights (made by the benchmark) and the same inputs."""

import copy
import json
from pathlib import Path

import numpy as np
import torch

from hdbench import run, traffic
from hdbench.reference import coarse as ref
from hdbench.weights import make_weights, shapes_of

ROOT = Path(__file__).resolve().parents[2]
TINY = {"hidden_nf": 32, "n_layers": 2, "timesteps": 12, "compute_dtype": None}
CPU = torch.device("cpu")


def tiny_model(config: str):
    from hierdiff_torch.config import CoarseModelConfig
    from hierdiff_torch.sampling.cli import build_coarse_from_cfg

    cfg = dict(json.loads((ROOT / "hdbench" / "configs" / f"{config}.json").read_text())["coarse"],
               **TINY)
    model = build_coarse_from_cfg(CoarseModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                                                       for k, v in cfg.items()}), device=CPU)
    weights = make_weights(shapes_of(model), 5, CPU)
    model.load_state_dict(weights)
    return model, weights, cfg


def inputs(counts, rows, seed=0):
    rng = np.random.default_rng(seed)
    nm, em = traffic.complete_masks(np.array(counts), rows)
    nm, em = torch.from_numpy(nm), torch.from_numpy(em)
    z = ref.project_noise(torch.from_numpy(rng.standard_normal((len(counts), rows, 11))).float(), nm)
    return nm, em, z


def test_gamma_and_dynamics():
    model, w, cfg = tiny_model("hierdiff-geom")
    t = torch.tensor([0.0, 0.3, 1.0])
    torch.testing.assert_close(ref.gamma(w, t), model.gamma(t[:, None])[:, 0], rtol=1e-5, atol=1e-4)
    nm, em, z = inputs([1, 2, 5, 7], 7)
    with torch.no_grad():
        want = model.phi(z, torch.full((4, 1), 0.25), nm, em)
    got = ref.eps_prediction(ref.Params(w), cfg, z, 3, nm, em)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_pocket_dynamics():
    from hierdiff_torch.models.diffusion import pocket_edge_mask

    model, w, cfg = tiny_model("hierdiff-crossdock")
    nm, em, z = inputs([2, 4, 6], 6)
    pk = traffic.pocket(np.random.default_rng(2), 5)
    tok = torch.from_numpy(np.repeat(pk["protein_feat"], 3, 0)).long()
    pos = torch.from_numpy(np.repeat(pk["protein_pos"], 3, 0))
    pm = torch.ones(3, 5, 1)
    with torch.no_grad():
        rows = torch.cat([pos, model.pocket_embed(tok)], -1)
        full = pocket_edge_mask(nm, em, pm, torch.from_numpy(np.repeat(pk["protein_edge_mask"], 3, 0)),
                                True)
        want = model.phi(torch.cat([z, rows], 1), torch.full((3, 1), 0.5), torch.cat([nm, pm], 1),
                         full, mol_shape=6)[:, :6]
    mine = torch.cat([pos, w["pocket_embed.weight"][tok]], -1)
    got = ref.eps_prediction(ref.Params(w), cfg, z, 6, nm, em, pocket=mine, pocket_node_mask=pm,
                             full_edge_mask=ref.pocket_edges(nm, pm, True))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_step_and_final():
    model, w, cfg = tiny_model("hierdiff-geom")
    nm, em, z = inputs([3, 5], 5, seed=1)
    raw = torch.randn(2, 5, 11, generator=torch.Generator().manual_seed(3))
    g_s, g_t = ref.grid_gammas(w, 7, 12, CPU)
    with torch.no_grad():
        mu, sigma = model.sample_zs_stats(z, g_s.expand(2, 1), g_t.expand(2, 1), nm, em,
                                          torch.full((2, 1), 7 / 12))
        from hierdiff_torch.ops.masked import combine_noise, remove_mean_with_mask
        zn = mu + sigma * combine_noise(raw, nm, 3)
        want = torch.cat([remove_mean_with_mask(zn[..., :3], nm), zn[..., 3:]], -1)
        eps = model.phi(z, torch.full((2, 1), 7 / 12), nm, em)
        eps0 = model.phi(z, torch.zeros(2, 1), nm, em)
        mu_x, sigma_x = model.sample_x_given_z0_stats(z, nm, em)
        out = mu_x + sigma_x * combine_noise(raw, nm, 3)
        want_final = torch.cat([out[..., :3], z[..., 3:] * nm], -1)
    torch.testing.assert_close(ref.step_from(z, eps, g_s, g_t, raw, nm), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ref.eps_prediction(ref.Params(w), cfg, z, 0, nm, em), eps0,
                               rtol=1e-4, atol=1e-5)
    g0 = ref.gamma(w, torch.zeros(1))
    torch.testing.assert_close(ref.final_from(z, eps0, g0, raw, nm), want_final, rtol=1e-5,
                               atol=1e-5)


def test_sampling_cells_reference_on_cpu():
    """The driver's whole chain at a tiny size on the CPU: every gap of the
    port's plain route is at rounding level."""
    from hdbench.drivers.coarse_sample import CoarseSampling

    for cell in ("geom-coarse-sample", "crossdock-pocket-sample"):
        loaded = run.load_cell(cell)
        config = copy.deepcopy(loaded["config"])
        config["coarse"].update(TINY)
        mix = dict(loaded["mix"], batch=6, pocket_residues=4 if "pocket_residues" in loaded["mix"] else 0)
        sampler = CoarseSampling(config, mix, 2 ** 31 + 9, CPU)
        sampler.done.append(sampler.run_request(0, keep=True))
        gaps = sampler.gaps()
        assert gaps["eps_gap"] < 1e-3 and gaps["step_gap"] < 1e-5 and gaps["final_gap"] < 1e-5
        assert gaps["sched_gap"] < 5e-3
