"""PyTorch port of the coarse sampler (hierdiff_torch models, sampling, CLI,
weights) against the JAX package on the same weights and the same noise.

JAX's threefry stream cannot be reproduced in torch, so the chain test
injects the same numpy draws on both sides: the JAX side is the JAX model's
own methods driven through ``model.apply`` along the JAX sampler's ladder.
"""

import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hierdiff_torch.models.diffusion import CoarseDiffusion as PortDiffusion
from hierdiff_torch.models.dynamics import EGNNDynamics as PortDynamics
from hierdiff_torch.sampling import cli as port_cli
from hierdiff_torch.sampling.coarse import make_masks_for_counts, sample_coarse
from hierdiff_torch.utils.weights import flax_to_numpy_state, state_dict_from_flax
from hierdiff_tpu.models.diffusion import CoarseDiffusion
from hierdiff_tpu.models.dynamics import EGNNDynamics
from hierdiff_tpu.ops.masked import remove_mean_with_mask

T, H, LAYERS = 8, 32, 2
# float32 network outputs, summed in another order: ~1e-6 of the largest value
F32_REL = 1e-5


def _rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / (np.abs(ref).max() + 1e-12))


def _masks(counts, n=None):
    nm, em = make_masks_for_counts(np.asarray(counts), n)
    return nm, em


def _models(schedule="learned", seed=0, counts=(7, 4, 5)):
    kw = dict(in_node_nf=8, timesteps=T, hidden_nf=H, n_layers=LAYERS,
              noise_schedule=schedule)
    model = CoarseDiffusion(**kw)
    nm, em = _masks(counts)
    b, n = nm.shape[:2]
    rng = np.random.default_rng(seed)
    batch = {"positions": jnp.asarray(rng.standard_normal((b, n, 3)).astype(np.float32) * nm),
             "node_feature": jnp.asarray(rng.standard_normal((b, n, 8)).astype(np.float32) * nm),
             "atom_mask": jnp.asarray(nm), "edge_mask": jnp.asarray(em)}
    params = jax.jit(lambda k1, k2: model.init(k1, batch, k2, train=True))(
        jax.random.PRNGKey(seed), jax.random.PRNGKey(seed + 1))
    port = PortDiffusion(**kw)
    port.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params)),
                         strict=True)
    return model, params, port.eval(), nm, em


def _apply(model, params, method):
    def fn(*args):
        with jax.default_matmul_precision("highest"):
            return model.apply(params, *args, method=method)
    return jax.jit(fn)


def test_state_dict_from_flax_equals_export_coarse():
    from hierdiff_tpu.utils.torch_import import export_coarse

    _, params, port, _, _ = _models()
    params = jax.tree_util.tree_map(np.asarray, params)
    ours = flax_to_numpy_state(params)
    ref = export_coarse(params["params"])
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), err_msg=k)
    assert sorted(port.state_dict()) == sorted(ref)   # strict load already passed


@pytest.mark.parametrize("mol_shape", [None, 5])
def test_dynamics_matches_jax(mol_shape):
    nm, em = _masks((7, 4, 5))
    b, n = nm.shape[:2]
    rng = np.random.default_rng(3)
    xh = rng.standard_normal((b, n, 11)).astype(np.float32)
    t = rng.uniform(size=(b, 1)).astype(np.float32)
    kw = dict(hidden_nf=H, n_layers=LAYERS)
    jd = EGNNDynamics(in_node_nf=8, **kw)
    params = jax.jit(jd.init)(jax.random.PRNGKey(0), t, xh, nm, em)
    state = flax_to_numpy_state({"dynamics": jax.tree_util.tree_map(np.asarray, params["params"])})
    port = PortDynamics(8, **kw)
    port.load_state_dict({k[len("dynamics."):]: torch.from_numpy(np.array(v))
                          for k, v in state.items()}, strict=True)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(functools.partial(jd.apply, mol_shape=mol_shape))(params, t, xh, nm, em)
    with torch.no_grad():
        out = port(*[torch.from_numpy(a) for a in (t, xh, nm, em)], mol_shape=mol_shape)
    assert _rel(out, ref) < F32_REL


def test_dynamics_nan_guard_is_per_sample():
    nm, em = _masks((5, 5))
    port = PortDynamics(8, hidden_nf=16, n_layers=1).eval()
    xh = torch.randn(2, 5, 11, generator=torch.Generator().manual_seed(0))
    xh[0, 1, 0] = float("nan")
    with torch.no_grad():
        out = port(torch.full((2, 1), 0.5), xh, torch.from_numpy(nm), torch.from_numpy(em))
    assert torch.equal(out[0, :, :3], torch.zeros(5, 3))
    assert torch.isfinite(out[1]).all()


@pytest.mark.parametrize("schedule", ["learned", "polynomial_2"])
def test_sample_stats_match_jax(schedule):
    model, params, port, nm, em = _models(schedule)
    b, n = nm.shape[:2]
    rng = np.random.default_rng(5)
    z = rng.standard_normal((b, n, 11)).astype(np.float32) * nm
    grid = np.asarray(_apply(model, params, CoarseDiffusion.gamma_grid)())
    with torch.no_grad():
        np.testing.assert_allclose(port.gamma_grid().numpy(), grid, rtol=0, atol=1e-3)
    g_s = np.full((b, 1), grid[6], np.float32)
    g_t = np.full((b, 1), grid[7], np.float32)
    t = np.full((b, 1), 7 / T, np.float32)
    mu, sigma = _apply(model, params, CoarseDiffusion.sample_zs_stats)(z, g_s, g_t, nm, em, t)
    mu_x, sigma_x = _apply(model, params, CoarseDiffusion.sample_x_given_z0_stats)(z, nm, em)
    tz, tnm, tem = (torch.from_numpy(a) for a in (z, nm, em))
    with torch.no_grad():
        pmu, psigma = port.sample_zs_stats(tz, torch.from_numpy(g_s), torch.from_numpy(g_t),
                                           tnm, tem, torch.from_numpy(t))
        pmu_x, psigma_x = port.sample_x_given_z0_stats(tz, tnm, tem)
    assert _rel(pmu, mu) < F32_REL and _rel(psigma, sigma) < F32_REL
    # sample_x_given_z0 evaluates the learned gamma network itself (1e-3 bar,
    # tests/test_torch_primitives.py), and mu_x divides by alpha_0 ~ 1
    assert _rel(pmu_x, mu_x) < 1e-3 and _rel(psigma_x, sigma_x) < 1e-3


def _jax_chain(model, params, nm, em, raws, steps):
    """The JAX sampler's loop (sampling/coarse.py:65-109) with injected draws."""
    b = nm.shape[0]

    def combine(raw):
        zx = remove_mean_with_mask(raw[..., :3] * nm, nm)
        return jnp.concatenate([zx, raw[..., 3:] * nm], axis=-1)

    grid = _apply(model, params, CoarseDiffusion.gamma_grid)()
    zs = _apply(model, params, CoarseDiffusion.sample_zs_stats)
    ladder = np.asarray(jnp.round(jnp.linspace(T, 0, steps + 1)).astype(jnp.int32))
    z = combine(raws[0])
    for k in range(steps):
        t_int, s_int = int(ladder[k]), int(ladder[k + 1])
        g_s = jnp.broadcast_to(grid[s_int], (b, 1))
        g_t = jnp.broadcast_to(grid[t_int], (b, 1))
        t_norm = jnp.broadcast_to(jnp.float32(t_int) / T, (b, 1))
        mu, sigma = zs(z, g_s, g_t, nm, em, t_norm)
        z_new = mu + sigma * combine(raws[k + 1])
        z = jnp.concatenate([remove_mean_with_mask(z_new[..., :3], nm), z_new[..., 3:]], -1)
    mu_x, sigma_x = _apply(model, params, CoarseDiffusion.sample_x_given_z0_stats)(z, nm, em)
    xh = mu_x + sigma_x * combine(raws[steps + 1])
    x, h = _apply(model, params, CoarseDiffusion.unnormalize)(xh[..., :3], z[..., 3:], nm)
    return np.asarray(x), np.asarray(h)


@pytest.mark.parametrize("steps", [None, 3])
def test_chain_with_injected_noise_matches_jax(steps):
    model, params, port, nm, em = _models()
    n_steps = T if steps is None else steps
    rng = np.random.default_rng(11)
    raws = rng.standard_normal((n_steps + 2,) + nm.shape[:2] + (11,)).astype(np.float32)
    ref_x, ref_h = _jax_chain(model, params, nm, em, raws, n_steps)
    x, h = sample_coarse(port, torch.from_numpy(nm), torch.from_numpy(em), steps=steps,
                         noise=torch.from_numpy(raws))
    # the learned gamma differs by ~2e-4 between the frameworks (float32
    # cancellation, tests/test_torch_primitives.py) and T reverse steps of an
    # untrained network compound it: measured up to 2.5e-4 of the largest
    # value at T=12, bar 1e-3
    assert _rel(x, ref_x) < 1e-3 and _rel(h, ref_h) < 1e-3
    assert float(np.abs(x.numpy() * (1 - nm)).max()) == 0.0


def test_cli_coarse_on_cpu_writes_reference_pickle(tmp_path):
    """The coarse CLI on the CPU, loading a JAX model's weights from .npz."""
    _, params, _, _, _ = _models()
    weights = tmp_path / "coarse.npz"
    np.savez(weights, **flax_to_numpy_state(jax.tree_util.tree_map(np.asarray, params)))
    config = tmp_path / "coarse.yaml"
    config.write_text(f"coarse:\n  hidden_nf: {H}\n  n_layers: {LAYERS}\n  timesteps: {T}\n")
    out = tmp_path / "samples.pkl"
    run = port_cli.main(["coarse", "--config", str(config), "--weights", str(weights),
                         "--num", "5", "--batch-size", "3", "--steps", "4", "--max-nodes", "9",
                         "--device", "cpu", "--out", str(out)])
    with open(out, "rb") as f:
        payload = pickle.load(f)
    assert len(payload) == 1 and len(payload[0]) == 5 == run["molecules"]
    for mol, (x, h, nm) in zip(payload[0][:3], [(b[0][i], b[1][i], b[2][i])
                                                for b in run["batches"][:1] for i in range(3)]):
        c = int(nm.sum())
        assert mol["x"].shape == (c, 3) and mol["h"].shape == (c, 8)
        np.testing.assert_array_equal(mol["x"], x[:c].numpy())
        assert np.isfinite(mol["x"]).all() and np.isfinite(mol["h"]).all()


def test_cli_coarse_takes_the_jax_flag_forms():
    """The JAX CLI's --sample-steps and --bf16 / --no-bf16, and --steps as an
    alias; f32 elementwise stays the port's default (README, port section)."""
    parse = lambda *a: port_cli.build_parser().parse_args(["coarse", "--init-seed", "0", *a])  # noqa: E731
    assert parse().bf16 is False and parse().steps == 0
    assert parse("--sample-steps", "100").steps == 100
    assert parse("--steps", "50").steps == 50
    assert parse("--bf16").bf16 is True
    assert parse("--bf16", "--no-bf16").bf16 is False
