"""PyTorch port (hierdiff_torch) against the JAX package: masked ops,
schedules, the gamma network, the node-count prior, the config, the coarse
time ladder, and the port's import and device rules.

Inputs come from numpy seeds and reach both frameworks as numpy arrays. JAX
runs on the CPU at HIGHEST matmul precision; torch runs on the CPU (no TF32).
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hierdiff_torch.ops import masked as tm
from hierdiff_torch.ops import schedules as ts
from hierdiff_tpu.ops import masked as jm
from hierdiff_tpu.ops import schedules as js

REPO = Path(__file__).resolve().parent.parent
# float32 results of the same formula in two frameworks: a few ulp apart
F32_TOL = dict(rtol=1e-5, atol=1e-6)


def _masked_batch(seed=0, b=4, n=9, d=5):
    rng = np.random.default_rng(seed)
    counts = rng.integers(2, n + 1, size=b)
    nm = (np.arange(n)[None, :] < counts[:, None]).astype(np.float32)[..., None]
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    return x, nm


def test_masked_ops_match_jax():
    x, nm = _masked_batch()
    tx, tnm = torch.from_numpy(x), torch.from_numpy(nm)
    np.testing.assert_allclose(tm.sum_except_batch(tx).numpy(),
                               np.asarray(jm.sum_except_batch(x)), **F32_TOL)
    for fix in (None, 5):
        np.testing.assert_allclose(tm.remove_mean_with_mask(tx, tnm, fix).numpy(),
                                   np.asarray(jm.remove_mean_with_mask(x, nm, fix)), **F32_TOL)
    np.testing.assert_allclose(tm.cdf_standard_gaussian(tx).numpy(),
                               np.asarray(jm.cdf_standard_gaussian(x)), **F32_TOL)
    np.testing.assert_array_equal(tm.subspace_dimensionality(tnm, 3).numpy(),
                                  np.asarray(jm.subspace_dimensionality(nm, 3)))
    np.testing.assert_allclose(tm.mean_zero_max_violation(tx, tnm).numpy(),
                               np.asarray(jm.mean_zero_max_violation(x, nm)), **F32_TOL)
    assert tm.masking_violation(tx, tnm).item() == pytest.approx(
        float(jm.masking_violation(x, nm)))


def test_noise_transform_matches_jax_and_is_com_free():
    x, nm = _masked_batch(1, d=11)
    tnm = torch.from_numpy(nm)
    port = tm.combine_noise(torch.from_numpy(x), tnm, 3).numpy()
    ref_x = jm.remove_mean_with_mask(x[..., :3] * nm, nm)     # sample_com_free_gaussian_with_mask
    ref = np.concatenate([np.asarray(ref_x), x[..., 3:] * nm], axis=-1)
    np.testing.assert_allclose(port, ref, **F32_TOL)
    drawn = tm.sample_combined_noise(torch.Generator().manual_seed(0), tnm, 3, 8)
    assert drawn.shape == (4, 9, 11)
    assert tm.masking_violation(drawn, tnm).item() == 0.0
    assert tm.mean_zero_max_violation(drawn[..., :3], tnm).item() < 1e-6


@pytest.mark.parametrize("schedule", ["cosine", "polynomial_2"])
def test_predefined_schedule_matches_jax(schedule):
    np.testing.assert_array_equal(ts.gamma_table(schedule, 50),
                                  js.gamma_table(schedule, 50))
    t = np.linspace(0, 1, 23, dtype=np.float32)[:, None]
    module = js.PredefinedNoiseSchedule(noise_schedule=schedule, timesteps=50)
    variables = module.init(jax.random.PRNGKey(0), jnp.asarray(t))
    ref = np.asarray(module.apply(variables, jnp.asarray(t)))
    port = ts.PredefinedNoiseSchedule(schedule, 50)(torch.from_numpy(t)).numpy()
    np.testing.assert_array_equal(port, ref)


def test_gamma_network_matches_jax_on_same_weights():
    from hierdiff_torch.utils.weights import _linear

    t = np.linspace(0, 1, 17, dtype=np.float32)[:, None]
    net = js.GammaNetwork()
    params = net.init(jax.random.PRNGKey(3), jnp.asarray(t))["params"]
    state = {}
    for name in ("l1", "l2", "l3"):
        _linear(state, name, params[name])
    state["gamma_0"], state["gamma_1"] = params["gamma_0"], params["gamma_1"]
    port = ts.GammaNetwork()
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()},
                         strict=True)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(net.apply({"params": params}, jnp.asarray(t)))
        ref_1d = np.asarray(net.apply({"params": params}, jnp.asarray(t[:, 0])))
    # (gt - g0) / (g1 - g0) cancels: g0 ~ 65 from a 1024-term float32 sum,
    # g1 - g0 ~ 1. Each framework lands ~2e-4 from a float64 evaluation of
    # the same weights, so the bar is 1e-3 absolute on gamma in [-5, 10].
    tol = dict(rtol=0, atol=1e-3)
    with torch.no_grad():
        np.testing.assert_allclose(port(torch.from_numpy(t)).numpy(), ref, **tol)
        np.testing.assert_allclose(port(torch.from_numpy(t[:, 0])).numpy(), ref_1d, **tol)


def test_gamma_algebra_matches_jax():
    rng = np.random.default_rng(2)
    g_t = rng.uniform(-6, 10, (8, 1)).astype(np.float32)
    g_s = (g_t - rng.uniform(0.01, 2, (8, 1))).astype(np.float32)
    tt, tsg = torch.from_numpy(g_t), torch.from_numpy(g_s)
    for port, ref in [(ts.sigma_from_gamma(tt), js.sigma_from_gamma(g_t)),
                      (ts.alpha_from_gamma(tt), js.alpha_from_gamma(g_t)),
                      (ts.snr(tt), js.snr(g_t))]:
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), **F32_TOL)
    for port, ref in zip(ts.sigma_and_alpha_t_given_s(tt, tsg),
                         js.sigma_and_alpha_t_given_s(g_t, g_s)):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), **F32_TOL)
    assert ts.inflate(tt[:, 0], 3).shape == js.inflate(g_t[:, 0], 3).shape


def test_node_prior_and_histograms_match_jax():
    from hierdiff_torch.data.assets import load_histogram as port_hist
    from hierdiff_torch.ops.distributions import DistributionNodes as PortNodes
    from hierdiff_tpu.data.assets import load_histogram as jax_hist
    from hierdiff_tpu.ops.distributions import DistributionNodes as JaxNodes

    for name in ("geom", "qm9", "crossdock"):
        assert port_hist(name) == jax_hist(name)
    hist = port_hist("geom")
    port = PortNodes(hist).sample_np(np.random.default_rng(7), 500)
    ref = JaxNodes(hist).sample_np(np.random.default_rng(7), 500)
    np.testing.assert_array_equal(port, ref)


def test_config_defaults_and_yaml_match_jax():
    from hierdiff_torch.config import CoarseModelConfig, load_coarse_config
    from hierdiff_tpu.config import CoarseModelConfig as JaxConfig, load_config

    path = REPO / "configs" / "coarse_geom.yaml"
    for port, ref in [(CoarseModelConfig(), JaxConfig()),
                      (load_coarse_config(str(path)), load_config(str(path)).coarse)]:
        for field in ("node_coarse_type", "noise_schedule", "timesteps", "hidden_nf",
                      "n_layers", "inv_sublayers", "attention", "tanh", "coords_range",
                      "norm_constant", "normalization_factor", "aggregation_method",
                      "condition_time", "compute_dtype", "dataset", "norm_values",
                      "in_node_nf", "int_nf", "cont_nf"):
            assert getattr(port, field) == getattr(ref, field), field


@pytest.mark.parametrize("steps", [1, 10, 100, 208, 250, 999, 1000])
def test_coarse_ladder_equals_jax_float32_ladder(steps):
    """The port's ladder is the JAX sampler's (coarse.py:77) element for
    element; at 208 a float64 or correctly rounded float32 linspace differs."""
    from hierdiff_torch.sampling.coarse import coarse_ladder

    ref = np.asarray(jnp.round(jnp.linspace(1000, 0, steps + 1)).astype(jnp.int32))
    np.testing.assert_array_equal(coarse_ladder(1000, steps).numpy(), ref)
    if steps == 208:
        float64 = np.round(np.linspace(1000, 0, steps + 1)).astype(np.int32)
        assert not np.array_equal(float64, ref)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import hierdiff_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(hierdiff_torch.__path__, 'hierdiff_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',"
        " 'orbax', 'hierdiff_tpu', 'yaml', 'pandas', 'rdkit')]\n"
        "print(json.dumps({'modules': names, 'bad': bad}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True, timeout=120)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    for name in ("sampling.cli", "ops.egnn_kernels", "ops.losses", "models.diffusion",
                 "data.synthetic", "data.collate", "train.data_iters", "train.trainer",
                 "train.cli", "parallel.train_step", "ops.graph", "ops.gcl",
                 "models.edge_denoise", "sampling.beam", "sampling.lattice",
                 "sampling.pipeline", "tools.lattice_check", "data.refine", "models.refine",
                 "sampling.refine_hook", "tools.refine_check", "runtime", "data.denoise",
                 "data.orders", "chem", "chem.geometry", "chem.chemutils", "chem.mol_tree",
                 "chem.assemble_gate", "chem.reconstruct", "eval.metrics", "eval.cli",
                 "tools.chem_check", "chem.pocket", "models.jtnn", "chem.mff_rmsd",
                 "chem.preprocess", "utils.profiling", "utils.log", "utils.cache"):
        assert f"hierdiff_torch.{name}" in report["modules"], name


def test_entry_points_need_cuda_unless_told_otherwise(monkeypatch, tmp_path):
    from hierdiff_torch.config import CoarseModelConfig
    from hierdiff_torch.sampling import cli
    from hierdiff_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.build_coarse_from_cfg(CoarseModelConfig(hidden_nf=16, n_layers=1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["coarse", "--init-seed", "0", "--out", str(tmp_path / "x.pkl")])
    from hierdiff_torch.train import cli as train_cli
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["coarse", "--init-seed", "0", f"train.workdir={tmp_path / 'run'}"])
    assert not (tmp_path / "run").exists()
    assert resolve_device("cpu") == torch.device("cpu")
