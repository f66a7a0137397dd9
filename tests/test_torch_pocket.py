"""PyTorch port of the pocket-conditioned (CrossDocked) coarse family and the
coarse model's remaining options against the JAX package: the pocket parser
and collation, the synthetic pockets, the weight maps, the pocket loss and
its gradients, the pocket sampler's chain, ``gnn_dynamics``, mean
aggregation, the ``adam`` and ``sgd`` optimizers, and the CLIs end to end.

A tiny model (hidden 32, 1 block, T = 8) on B = 2 molecules of at most 6
nodes and pockets of K = 4 residues, inputs from a numpy seed. JAX runs on
the CPU at HIGHEST matmul precision, torch without TF32. The noise schedule
is ``polynomial_2``: the learned gamma network differs by ~2e-4 between the
frameworks (float32 cancellation, tests/test_torch_primitives.py), which
would set the bars instead of the code under test. JAX's threefry stream
cannot be reproduced in torch: the loss test runs the JAX model's own
``__call__`` and gives the port the draws that call makes (the same
``jax.random`` splits); the chain test injects the same numpy draws into
both sides.
"""

import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hierdiff_torch.config import load_config
from hierdiff_torch.models.diffusion import CoarseDiffusion as PortDiffusion
from hierdiff_torch.parallel.train_step import TrainState
from hierdiff_torch.sampling import cli as port_cli
from hierdiff_torch.sampling.coarse import make_masks_for_counts, sample_coarse_pocket
from hierdiff_torch.train import cli as train_cli
from hierdiff_torch.train import data_iters as port_iters
from hierdiff_torch.utils.weights import flax_to_numpy_state, state_dict_from_flax
from hierdiff_tpu.models.diffusion import CoarseDiffusion
from hierdiff_tpu.ops.masked import remove_mean_with_mask, sample_combined_noise

T, H, LAYERS, B, N_MOL, K = 8, 32, 1, 2, 6, 4
SCHEDULE = "polynomial_2"
CONFIGS = __import__("pathlib").Path(__file__).resolve().parent.parent / "configs"

# the pocket fixture of tests/test_chem.py:91, a nonstandard residue (token
# 0) and a second chain
PDB = "\n".join([
    "ATOM      1  N   ALA A   1      10.000  10.000  10.000  1.00  0.00           N",
    "ATOM      2  CA  ALA A   1      11.000  10.000  10.000  1.00  0.00           C",
    "ATOM      3  CA  GLY A   2      50.000  50.000  50.000  1.00  0.00           C",
    "ATOM      4  CB  TRP A   3      12.000  10.500  10.000  1.00  0.00           C",
    "ATOM      5  CA  TRP A   3      12.500  11.000  10.000  1.00  0.00           C",
    "HETATM    6  C1  LIG A 900      10.500  10.000  10.000  1.00  0.00           C",
    "ATOM      7  CA  MSE B   1       9.000  12.000  10.500  1.00  0.00           C",
    "ATOM      8  CA  LYS B   2      13.000   9.000   8.000  1.00  0.00           C",
])


@pytest.fixture(autouse=True)
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / (np.abs(ref).max() + 1e-12))


def _batch(seed=0):
    """Two molecules (6 and 4 nodes) with integer-valued h channels, and
    pockets of 4 and 3 residues (the second padded, token 0)."""
    rng = np.random.default_rng(seed)
    nm, em = make_masks_for_counts(np.array([6, 4]), N_MOL)
    feats = rng.standard_normal((B, N_MOL, 8)).astype(np.float32)
    feats[..., :5] = np.round(feats[..., :5] * 2)
    pm = np.ones((B, K, 1), np.float32)
    pm[1, 3] = 0.0
    pem = pm * np.transpose(pm, (0, 2, 1)) * (1 - np.eye(K, dtype=np.float32))
    tokens = rng.integers(1, 21, (B, K)).astype(np.int32)
    tokens[1, 3] = 0
    return {"positions": (rng.standard_normal((B, N_MOL, 3)) * 2).astype(np.float32) * nm,
            "node_feature": feats * nm, "atom_mask": nm, "edge_mask": em,
            "protein_pos": (rng.standard_normal((B, K, 3)) * 3).astype(np.float32) * pm,
            "protein_feat": tokens, "protein_feat_mask": pm, "protein_edge_mask": pem}


@functools.lru_cache(maxsize=None)
def _params(mode):
    """Params (numpy) of the pocket model with the ``mode`` backbone; the
    cross-edge and aggregation flags leave the parameters as they are, so
    one init serves every variant."""
    model = CoarseDiffusion(in_node_nf=8, timesteps=T, hidden_nf=H, n_layers=LAYERS,
                            noise_schedule=SCHEDULE, mode=mode, pocket=True)
    params = jax.jit(lambda k1, k2: model.init(k1, _batch(), k2, train=True))(
        jax.random.PRNGKey(0), jax.random.PRNGKey(1))
    return jax.tree_util.tree_map(np.asarray, params)


def _models(cross=True, mode="egnn_dynamics", aggregation="sum"):
    """The JAX pocket model, its params and the port with the same weights."""
    kw = dict(in_node_nf=8, timesteps=T, hidden_nf=H, n_layers=LAYERS, noise_schedule=SCHEDULE,
              mode=mode, aggregation_method=aggregation, pocket=True, pocket_cross_edges=cross)
    params = _params(mode)
    port = PortDiffusion(**kw)
    port.load_state_dict(state_dict_from_flax(params), strict=True)
    return CoarseDiffusion(**kw), params, port


def test_pocket_parser_and_collation_are_jax_bitwise():
    from hierdiff_torch.chem import pocket as port_pocket
    from hierdiff_tpu.chem import pocket as jax_pocket

    assert port_pocket.RESIDUE_LIST == jax_pocket.RESIDUE_LIST
    for ligand, radius in [([[10.5, 10.0, 10.0]], 6.0), ([[10.5, 10.0, 10.0]], 2.5),
                           ([[50.0, 50, 50]], 6.0), ([[0.0, 0, 0]], 6.0)]:
        p = port_pocket.pocket_from_text(PDB, np.array(ligand), radius, "lig", "site")
        r = jax_pocket.pocket_from_text(PDB, np.array(ligand), radius, "lig", "site")
        assert p.residue_type == r.residue_type
        assert (p.ligand_name, p.pocket_name) == (r.ligand_name, r.pocket_name)
        np.testing.assert_array_equal(p.coord, r.coord)
        np.testing.assert_array_equal(p.residue_tokens(), r.residue_tokens())
    first = port_pocket.pocket_from_text(PDB, np.array([[10.5, 10.0, 10.0]]))
    assert first.residue_type == ["ALA", "TRP", "MSE", "LYS"]
    assert first.residue_tokens().tolist() == [1, 18, 0, 12]
    empty = port_pocket.pocket_from_text(PDB, np.array([[0.0, 0, 0]]))
    for pockets in ([first, empty], [empty], []):
        ours = port_pocket.collate_pockets(pockets)
        ref = jax_pocket.collate_pockets([jax_pocket.PocketCA(p.residue_type, p.coord)
                                          for p in pockets])
        assert sorted(ours) == sorted(ref)
        for k in ref:
            assert ours[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_synthetic_pocket_batches_are_jax_bitwise(tmp_path):
    from hierdiff_tpu.config import load_config as jax_load_config
    from hierdiff_tpu.train import data_iters as jax_iters

    path = str(CONFIGS / "coarse_crossdock.yaml")
    overrides = ["train.num_train_trees=24", "train.batch_size=5"]
    cfg, jcfg = load_config(path, overrides), jax_load_config(path, overrides)
    for name in vars(jcfg.coarse):
        if hasattr(cfg.coarse, name):
            assert getattr(cfg.coarse, name) == getattr(jcfg.coarse, name), name
    assert cfg.coarse.pocket and cfg.coarse.pocket_cross_edges and cfg.coarse.dataset == "crossdock"
    pool, jpool = port_iters.load_tree_pool(cfg, seed=2), jax_iters.load_tree_pool(jcfg, seed=2)
    it, jit_ = port_iters.coarse_iter(cfg, pool, seed=4), jax_iters.coarse_iter(jcfg, jpool, seed=4)
    for _ in range(3):
        a, b = next(it), next(jit_)
        assert sorted(a) == sorted(b) and a["protein_pos"].shape[1] == port_iters.POCKET_RESIDUES
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("mode", ["egnn_dynamics", "gnn_dynamics"])
def test_weight_maps_equal_export_coarse(mode):
    """``pocket_embed`` and the ``dynamics.gnn`` backbone, key for key and
    value for value against the JAX exporter."""
    from hierdiff_tpu.utils.torch_import import export_coarse

    _, params, port = _models(mode=mode)
    ours, ref = flax_to_numpy_state(params), export_coarse(params["params"])
    assert sorted(ours) == sorted(ref) == sorted(port.state_dict())
    assert "pocket_embed.weight" in ref
    assert any(k.startswith("dynamics.gnn.gcl_0.") for k in ref) == (mode == "gnn_dynamics")
    for k in ref:
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), err_msg=k)


@functools.partial(jax.jit, static_argnums=2)
def _jax_draws(rng, nm, train):
    """The draws the JAX model's ``__call__`` makes from ``rng``
    (compute_loss: split in three, t, then the molecule rows' eps, eps0)."""
    rng_t, rng_eps, rng_eps0 = jax.random.split(rng, 3)
    return {"t_int": jax.random.randint(rng_t, (B, 1), 0 if train else 1, T + 1),
            "eps": sample_combined_noise(rng_eps, nm, 3, 8),
            "eps0": sample_combined_noise(rng_eps0, nm, 3, 8)}


@pytest.mark.parametrize("cross,train", [(True, True), (True, False), (False, True)])
def test_pocket_loss_and_gradients_match_jax(cross, train):
    model, params, port = _models(cross=cross)
    batch = _batch(1)
    rng = jax.random.PRNGKey(7 if train else 8)

    def loss(p):
        with jax.default_matmul_precision("highest"):
            return model.apply(p, batch, rng, train=train)["loss"]

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss))(params)
    ref = flax_to_numpy_state(jax.tree_util.tree_map(np.asarray, ref_grads))
    port.zero_grad(set_to_none=True)
    draws = {k: torch.from_numpy(np.array(v))
             for k, v in _jax_draws(rng, batch["atom_mask"], train).items()}
    out = port({k: torch.from_numpy(v) for k, v in batch.items()}, None, train=train, **draws)
    out["loss"].backward()
    assert out["loss"].item() == pytest.approx(float(ref_loss), rel=1e-5)
    grads = {k: p.grad.numpy() for k, p in port.named_parameters()}
    assert sorted(grads) == sorted(ref)
    errs = {k: _rel(grads[k], ref[k]) for k in ref}
    assert max(errs.values()) < 1e-4, errs
    # with cross edges the gradient reaches the embedding of every real
    # residue through the pocket rows; the padding token's row gets none
    # (its node is masked). Without them the pocket is inert: no gradient.
    emb = np.abs(grads["pocket_embed.weight"]).max(axis=1)
    used = np.unique(batch["protein_feat"][batch["protein_feat_mask"][..., 0] > 0])
    assert emb[0] == 0 and (emb[used].min() > 0 if cross else not emb.any())


def test_pocket_chain_with_injected_noise_matches_jax():
    """``sample_coarse_pocket`` against the JAX sampler's loop
    (sampling/coarse.py:268-336) built from the JAX model's methods, with
    the same draws; the last step runs on the molecule rows alone."""
    model, params, port = _models()
    batch = _batch(2)
    nm, em = batch["atom_mask"], batch["edge_mask"]
    pm, pem = batch["protein_feat_mask"], batch["protein_edge_mask"]
    rng = np.random.default_rng(3)
    raws = rng.standard_normal((T + 2, B, N_MOL, 11)).astype(np.float32)

    def apply(method, **kw):
        def fn(p, *args):
            with jax.default_matmul_precision("highest"):
                return model.apply(p, *args, method=method, **kw)
        return functools.partial(jax.jit(fn), params)

    def combine(raw):
        zx = remove_mean_with_mask(raw[..., :3] * nm, nm)
        return jnp.concatenate([zx, raw[..., 3:] * nm], axis=-1)

    pfeat = apply(lambda m, f: m.pocket_embed(f))(jnp.asarray(batch["protein_feat"]))
    pocket_xh = jnp.concatenate([batch["protein_pos"], pfeat], axis=2)
    nm_cat = jnp.concatenate([nm, pm], axis=1)
    em_cat = jnp.zeros((B, N_MOL + K, N_MOL + K))
    em_cat = em_cat.at[:, :N_MOL, :N_MOL].set(em).at[:, N_MOL:, N_MOL:].set(pem)
    cross = nm[:, :, 0, None] * pm[:, None, :, 0]
    em_cat = em_cat.at[:, :N_MOL, N_MOL:].set(cross).at[:, N_MOL:, :N_MOL].set(
        np.transpose(cross, (0, 2, 1)))
    grid = apply(CoarseDiffusion.gamma_grid)()
    zs = apply(CoarseDiffusion.sample_zs_stats, mol_shape=N_MOL)
    ladder = np.asarray(jnp.round(jnp.linspace(T, 0, T + 1)).astype(jnp.int32))
    z = combine(raws[0])
    for k in range(T):
        t_int, s_int = int(ladder[k]), int(ladder[k + 1])
        mu, sigma = zs(jnp.concatenate([z, pocket_xh], axis=1),
                       jnp.broadcast_to(grid[s_int], (B, 1)), jnp.broadcast_to(grid[t_int], (B, 1)),
                       nm_cat, em_cat, jnp.broadcast_to(jnp.float32(t_int) / T, (B, 1)))
        z_new = mu + sigma * combine(raws[k + 1])
        z = jnp.concatenate([remove_mean_with_mask(z_new[..., :3], nm), z_new[..., 3:]], -1)
    mu_x, sigma_x = apply(CoarseDiffusion.sample_x_given_z0_stats)(z, nm, em)
    xh = mu_x + sigma_x * combine(raws[T + 1])
    ref_x, ref_h = apply(CoarseDiffusion.unnormalize)(xh[..., :3], z[..., 3:], nm)

    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    x, h = sample_coarse_pocket(port.eval(), t["atom_mask"], t["edge_mask"], t["protein_feat"],
                                t["protein_pos"], t["protein_feat_mask"],
                                t["protein_edge_mask"], noise=torch.from_numpy(raws))
    assert x.shape == (B, N_MOL, 3) and h.shape == (B, N_MOL, 8)
    assert _rel(x, ref_x) < 1e-4 and _rel(h, ref_h) < 1e-4
    assert float(np.abs(x.numpy() * (1 - nm)).max()) == 0.0


@pytest.mark.parametrize("mode,aggregation", [("gnn_dynamics", "sum"),
                                              ("egnn_dynamics", "mean"),
                                              ("gnn_dynamics", "mean")])
def test_gnn_dynamics_and_mean_aggregation_match_jax(mode, aggregation):
    """The network's output on the same inputs and weights (molecule rows
    only: the options act on the dynamics alone)."""
    model, params, port = _models(mode=mode, aggregation=aggregation)
    batch = _batch(4)
    nm, em = batch["atom_mask"], batch["edge_mask"]
    rng = np.random.default_rng(5)
    xh = rng.standard_normal((B, N_MOL, 11)).astype(np.float32) * nm
    t = np.array([[0.25], [0.75]], np.float32)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda p: model.apply(p, xh, t, nm, em, method=CoarseDiffusion.phi))(params)
    with torch.no_grad():
        out = port.phi(*(torch.from_numpy(a) for a in (xh, t, nm, em)))
    assert _rel(out, ref) < 1e-5
    layer = port.dynamics.gnn.gcl_0 if mode == "gnn_dynamics" else port.dynamics.egnn.e_block_0.gcl_0
    assert layer.aggregation_method == aggregation


def test_gnn_layer_plain_vjp_takes_no_edge_features():
    """The plain version of ``fused_gcl_bwd`` at E = 0 over the all-ones
    mask, as ``gnn_dynamics`` trains: autograd's gradients of the layer,
    and empty edge-feature gradients."""
    from hierdiff_torch.ops import egnn_kernels as ek
    from hierdiff_torch.ops.egnn import DenseGCL

    torch.manual_seed(0)
    layer = DenseGCL(16, 0, normalization_factor=10.0, attention=True)
    h = torch.randn(2, 5, 16, requires_grad=True)
    e, ones, nm = torch.zeros(2, 5, 5, 0), torch.ones(2, 5, 5, 1), torch.ones(2, 5, 1)
    g = torch.randn(2, 5, 16)
    grads = ek.gcl_plain_vjp(layer, h, e, ones, nm, g)
    (layer(h, e, nm, ones) * g).sum().backward()
    torch.testing.assert_close(grads.dh, h.grad)
    assert grads.de.shape == (2, 5, 5, 0) and grads.w_e.shape == (0, 16)
    for got, p in zip(ek.linear_grads(grads), ek.gcl_parameters(layer)):
        torch.testing.assert_close(got, p.grad)


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_adam_and_sgd_steps_match_optax(optimizer):
    """Three updates behind the global-norm clip against the optax chain of
    hierdiff_tpu's build_optimizer, the first one clipped."""
    from hierdiff_tpu.train.trainer import build_optimizer as jax_build_optimizer

    cfg = load_config(None, [f"optim.optimizer={optimizer}", "optim.lr=1e-2",
                             "optim.grad_clip=1.0", "optim.ema_decay=0"])
    rng = np.random.default_rng(1)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2, 2)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in shapes.items()}
             for scale in (3.0, 0.05, 0.1)]
    tx = jax_build_optimizer(cfg.optim)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = tx.init(params)

    @jax.jit
    def step(g, opt_state, params):
        updates, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    for g in grads:
        params, opt_state = step(g, opt_state, params)

    module = torch.nn.Module()
    for k, v in init.items():
        module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    state = TrainState(module, cfg.optim)
    assert type(state.optimizer).__name__ == {"adam": "Adam", "sgd": "SGD"}[optimizer]
    norms = []
    for g in grads:
        for k, p in module.named_parameters():
            p.grad = torch.from_numpy(g[k].copy())
        norms.append(state.apply_gradients().item())
    assert norms[0] > 1.0 > norms[1]
    for k, p in module.named_parameters():
        # torch's Adam rounds mhat / (sqrt(vhat) + eps) in another order than
        # optax: a few float32 ulps of a unit-scale parameter (measured 1.6e-7)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]), rtol=1e-6, atol=1e-6)


def test_pocket_cli_trains_and_samples_on_cpu(tmp_path):
    """``train.cli coarse`` on the crossdock config for 3 tiny steps, then
    ``sampling.cli coarse --pocket-pdb`` with the trained weights on a
    synthetic PDB, and the blur pickle into ``assemble`` (as
    tests/test_families.py:127-170 runs the JAX CLIs)."""
    wd = tmp_path / "pocket_run"
    tiny = [f"coarse.hidden_nf={H}", f"coarse.n_layers={LAYERS}", f"coarse.timesteps={T}"]
    train = train_cli.main(["coarse", "--config", str(CONFIGS / "coarse_crossdock.yaml"),
                            "--device", "cpu", "--init-seed", "0", f"train.workdir={wd}",
                            "train.max_steps=3", "train.checkpoint_every=3",
                            "train.eval_every=1000", "train.log_every=3", "train.batch_size=4",
                            "train.num_train_trees=16", "train.buckets=(8,)", *tiny])
    assert train["steps"] == 3 and train["trainer"].state.model.pocket
    pdb = tmp_path / "site.pdb"
    rng = np.random.default_rng(0)
    res = ["ALA", "GLY", "LYS", "TRP", "SER"]
    pdb.write_text("\n".join(
        f"ATOM  {i + 1:5d}  CA  {res[i]} A{i + 1:4d}    "
        + "".join(f"{v:8.3f}" for v in rng.normal(scale=3.0, size=3))
        + "  1.00  0.00           C" for i in range(5)) + "\n")
    config = tmp_path / "crossdock_tiny.yaml"
    config.write_text((CONFIGS / "coarse_crossdock.yaml").read_text().replace(
        "  hidden_nf: 256\n", f"  hidden_nf: {H}\n").replace(
        "  n_layers: 6\n", f"  n_layers: {LAYERS}\n").replace(
        "  timesteps: 1000\n", f"  timesteps: {T}\n"))
    out = tmp_path / "blur.pkl"
    run = port_cli.main(["coarse", "--config", str(config), "--weights", str(wd / "ema.pt"),
                         "--num", "5", "--batch-size", "3", "--max-nodes", "8",
                         "--pocket-pdb", str(pdb), "--pocket-center", "0,0,0",
                         "--pocket-radius", "12", "--device", "cpu", "--out", str(out)])
    with open(out, "rb") as f:
        results = pickle.load(f)[0]
    assert len(results) == 5 == run["molecules"]
    for r, (x, h, nm) in zip(results, [(b[0][i], b[1][i], b[2][i])
                                       for b in run["batches"] for i in range(len(b[0]))]):
        c = int(nm.sum())
        assert r["x"].shape == (c, 3) and r["h"].shape == (c, 8)
        assert np.isfinite(r["x"]).all() and np.isfinite(r["h"]).all()
        np.testing.assert_array_equal(r["x"], x[:c].numpy())
        assert np.abs(r["x"].sum(0)).max() < 1e-3 * max(1.0, np.abs(r["x"]).max())
    with pytest.raises(SystemExit, match="no pocket residues"):
        port_cli.main(["coarse", "--config", str(config), "--weights", str(wd / "ema.pt"),
                       "--num", "1", "--pocket-pdb", str(pdb), "--pocket-center", "90,90,90",
                       "--device", "cpu", "--out", str(out)])
    trees = tmp_path / "trees.pkl"
    port_cli.main(["assemble", "--coarse-pkl", str(out), "--denoise-init-seed", "0",
                   "--device", "cpu", "--beam", "2", "--out", str(trees),
                   "denoise.hidden_nf=16", "denoise.n_layers_full=1", "denoise.n_layers_focal=1"])
    with open(trees, "rb") as f:
        assert len(pickle.load(f)["trees"]) == 5
