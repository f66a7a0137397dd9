"""PyTorch port of the coarse training slice (hierdiff_torch losses, loss half
of CoarseDiffusion, data path, config, optimizer, trainer and train CLI)
against the JAX package on the same inputs, weights and draws.

JAX's threefry stream cannot be reproduced in torch, so the loss tests inject
the same t and noise on both sides (``compute_loss``'s t_int / eps / eps0).
JAX runs on the CPU at HIGHEST matmul precision, torch on the CPU without
TF32. The learned gamma network differs by ~2e-4 between the frameworks
(float32 cancellation in its normalisation, tests/test_torch_primitives.py),
which sets the bars of the terms that evaluate it at 0 < t < 1.
"""

import csv
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hierdiff_torch.config import load_config
from hierdiff_torch.data.collate import collate_coarse
from hierdiff_torch.models.diffusion import CoarseDiffusion as PortDiffusion
from hierdiff_torch.ops import losses as tl
from hierdiff_torch.ops.masked import combine_noise
from hierdiff_torch.parallel.train_step import TrainState, learning_rate_schedule
from hierdiff_torch.sampling import cli as sample_cli
from hierdiff_torch.train import cli as train_cli
from hierdiff_torch.train import data_iters as port_iters
from hierdiff_torch.utils.weights import flax_to_numpy_state, state_dict_from_flax
from hierdiff_tpu.models.diffusion import CoarseDiffusion
from hierdiff_tpu.ops import losses as jl
from hierdiff_tpu.ops.masked import remove_mean_with_mask

T, H, LAYERS = 8, 32, 2
# float32 results of the same formula summed in another order
F32_REL = 1e-5


@pytest.fixture(autouse=True)
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / (np.abs(ref).max() + 1e-12))


def _batch(seed=0, counts=(7, 4, 5, 9)):
    """A numpy batch in the collate layout; node features with integer
    channels (the discretized t=0 term rounds them)."""
    rng = np.random.default_rng(seed)
    n = max(counts)
    nm = (np.arange(n)[None, :] < np.asarray(counts)[:, None]).astype(np.float32)[..., None]
    em = (nm * np.transpose(nm, (0, 2, 1)) * (1 - np.eye(n, dtype=np.float32)))
    feats = rng.standard_normal((len(counts), n, 8)).astype(np.float32)
    feats[..., :5] = np.round(feats[..., :5] * 2)
    return {"positions": (rng.standard_normal((len(counts), n, 3)) * 2).astype(np.float32) * nm,
            "node_feature": feats * nm, "atom_mask": nm, "edge_mask": em}


def _models(schedule="learned", loss_type="vlb", seed=0, batch=None):
    kw = dict(in_node_nf=8, timesteps=T, hidden_nf=H, n_layers=LAYERS,
              noise_schedule=schedule, loss_type=loss_type)
    model = CoarseDiffusion(**kw)
    batch = batch if batch is not None else _batch(seed)
    params = jax.jit(lambda k1, k2: model.init(k1, batch, k2, train=True))(
        jax.random.PRNGKey(seed), jax.random.PRNGKey(seed + 1))
    params = jax.tree_util.tree_map(np.asarray, params)
    port = PortDiffusion(**kw)
    port.load_state_dict(state_dict_from_flax(params), strict=True)
    return model, params, port, batch


def _draws(batch, seed=1, t0_always=False):
    rng = np.random.default_rng(seed)
    b, n = batch["atom_mask"].shape[:2]
    t_int = rng.integers(1 if t0_always else 0, T + 1, size=(b, 1))
    t_int[0] = 0 if not t0_always else 1     # the t = 0 branch is exercised
    nm = torch.from_numpy(batch["atom_mask"])
    eps = [combine_noise(torch.from_numpy(rng.standard_normal((b, n, 11)).astype(np.float32)),
                         nm, 3).numpy() for _ in range(2)]
    return t_int, eps[0], eps[1]


def _jax_loss_fn(model, t0_always, train, t_int, eps, eps0):
    """The JAX model's __call__ -> nll -> compute_loss chain with injected
    draws, as ``model.apply`` runs it (models/diffusion.py:343-404)."""
    def fn(module, batch):
        nm = batch["atom_mask"]
        x = remove_mean_with_mask(batch["positions"], nm)
        x, h, delta_log_px = module.normalize(x, batch["node_feature"], nm)
        if train and module.loss_type == "l2":
            delta_log_px = jnp.zeros_like(delta_log_px)
        loss, info = module.compute_loss(jax.random.PRNGKey(0), x, h, nm, batch["edge_mask"],
                                         None, t0_always=t0_always, train=train,
                                         t_int=jnp.asarray(t_int), eps=jnp.asarray(eps),
                                         eps0=jnp.asarray(eps0))
        return loss - delta_log_px, info["error"]
    return fn


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    mu, p_mu = rng.standard_normal((2, 4, 6, 5)).astype(np.float32)
    sig, p_sig = rng.uniform(0.2, 2.0, (2, 4, 6, 5)).astype(np.float32)
    nm = (rng.uniform(size=(4, 6, 1)) > 0.3).astype(np.float32)
    d = rng.integers(3, 20, size=4).astype(np.float32)
    t = lambda a: torch.from_numpy(np.asarray(a))   # noqa: E731
    for port, ref in [
        (tl.gaussian_entropy(t(mu), t(sig)), jl.gaussian_entropy(mu, sig)),
        (tl.gaussian_kl(t(mu), t(sig), t(p_mu), t(p_sig), t(nm)),
         jl.gaussian_kl(mu, sig, p_mu, p_sig, nm)),
        (tl.gaussian_kl_for_dimension(t(mu), t(sig[:, 0, 0]), t(p_mu), t(p_sig[:, 0, 0]), t(d)),
         jl.gaussian_kl_for_dimension(mu, sig[:, 0, 0], p_mu, p_sig[:, 0, 0], d)),
    ]:
        assert _rel(port, ref) < F32_REL


def test_loss_terms_match_jax():
    model, params, port, batch = _models()
    nm = batch["atom_mask"]
    rng = np.random.default_rng(4)
    b, n = nm.shape[:2]
    xh = rng.standard_normal((b, n, 11)).astype(np.float32) * nm
    net = rng.standard_normal((b, n, 11)).astype(np.float32) * nm
    gamma_0 = np.full((b, 1), -4.5, np.float32)

    def jax_term(method, *args, **kw):
        with jax.default_matmul_precision("highest"):
            return np.asarray(model.apply(params, *args, method=method, **kw))

    tx, tnet, tnm = (torch.from_numpy(a) for a in (xh, net, nm))
    with torch.no_grad():
        # gamma(1) and gamma(0) are exact ends of the normalised network
        assert _rel(port.kl_prior(tx, tnm), jax_term(CoarseDiffusion.kl_prior, xh, nm)) < 1e-4
        for fn in ("log_constants_p_x_given_z0", "log_constants_p_h_given_z0"):
            assert _rel(getattr(port, fn)(tnm), jax_term(getattr(CoarseDiffusion, fn), nm)) < 1e-4
        for train in (True, False):
            assert _rel(port.compute_error(tnet, tx, train),
                        jax_term(CoarseDiffusion.compute_error, net, xh, train)) < F32_REL
        # z_0 near the integer features, as alpha_0 h + sigma_0 eps is: far
        # from them both CDFs saturate and the difference is erf's last ulp
        h = np.round(xh[..., 3:] * 2)
        xh[..., 3:8] = h[..., :5] + 0.05 * net[..., 3:8]
        tx = torch.from_numpy(xh)
        port_term = port.log_pxh_given_z0_without_constants(
            torch.from_numpy(h), tx, torch.from_numpy(gamma_0), tnet * 0.5, tnet, tnm)
        ref = jax_term(CoarseDiffusion.log_pxh_given_z0_without_constants,
                       h, xh, gamma_0, net * 0.5, net, nm)
    assert _rel(port_term, ref) < F32_REL


@pytest.mark.parametrize("t0_always", [False, True])
@pytest.mark.parametrize("schedule,loss_type", [("learned", "vlb"), ("polynomial_2", "l2")])
def test_compute_loss_matches_jax(t0_always, schedule, loss_type):
    model, params, port, batch = _models(schedule, loss_type)
    t_int, eps, eps0 = _draws(batch, t0_always=t0_always)
    train = not t0_always
    with jax.default_matmul_precision("highest"):
        ref_nll, ref_err = jax.jit(lambda p, b: model.apply(
            p, b, method=_jax_loss_fn(model, t0_always, train, t_int, eps, eps0)))(params, batch)
    with torch.no_grad():
        out = port(_torch_batch(batch), None, train=train, t_int=torch.from_numpy(t_int),
                   eps=torch.from_numpy(eps), eps0=torch.from_numpy(eps0))
    # the learned gamma's ~2e-4 offset enters through snr(gamma_s - gamma_t)
    bar = 2e-3 if schedule == "learned" else 1e-4
    assert _rel(out["nll"], ref_nll) < bar
    assert _rel(out["error"], ref_err) < bar
    assert out["loss"].item() == pytest.approx(float(np.mean(ref_nll)), rel=bar)


@pytest.mark.parametrize("schedule", ["learned", "polynomial_2"])
def test_training_loss_gradient_matches_jax(schedule):
    """The gradient of a whole training loss, name for name, the gamma
    network included (jax.grad of the model's train=True loss, mapped into
    the port's names by flax_to_numpy_state)."""
    model, params, port, batch = _models(schedule)
    t_int, eps, eps0 = _draws(batch)
    fn = _jax_loss_fn(model, False, True, t_int, eps, eps0)

    def loss(p):
        with jax.default_matmul_precision("highest"):
            return jnp.mean(model.apply(p, batch, method=fn)[0])

    ref = flax_to_numpy_state(jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss))(params)))
    out = port(_torch_batch(batch), None, train=True, t_int=torch.from_numpy(t_int),
               eps=torch.from_numpy(eps), eps0=torch.from_numpy(eps0))
    out["loss"].backward()
    grads = {k: p.grad for k, p in port.named_parameters()}
    assert sorted(grads) == sorted(ref)
    if schedule == "learned":
        # l3's bias cancels in gamma's normalisation (gt - g0) / (g1 - g0): its
        # gradient is zero, and JAX's value is rounding (about one float32 ulp
        # of gamma_tilde ~ 8, relative to the gamma_0/gamma_1 gradients ~ 1e2)
        zero = "gamma.l3.bias"
        assert abs(float(ref.pop(zero)[0])) < 2e-3 and abs(grads.pop(zero).item()) < 2e-3
    errs = {k: _rel(grads[k], ref[k]) for k in ref}
    glob = float(np.sqrt(sum(((grads[k].numpy() - ref[k]) ** 2).sum() for k in ref)
                         / sum((ref[k] ** 2).sum() for k in ref)))
    # learned gamma: its ~2e-4 offset moves the loss weights and the noised
    # inputs; the gamma parameters' own gradients (a 1024-term sum through the
    # normalisation's cancellation) take the widest bar
    bar = 2e-2 if schedule == "learned" else 1e-4
    assert glob < bar / 10, glob
    assert max(errs.values()) < bar, errs
    assert all(torch.isfinite(g).all() and g.abs().max() > 0 for g in grads.values())


def test_optimizer_steps_match_optax():
    """Three AdamW + global-norm clip + EMA updates on the same gradients
    against the optax chain of hierdiff_tpu's build_optimizer and its
    TrainState's EMA rule."""
    from hierdiff_tpu.train.trainer import build_optimizer as jax_build_optimizer

    cfg = load_config(None, ["optim.lr=1e-2", "optim.weight_decay=1e-2", "optim.grad_clip=1.0",
                             "optim.ema_decay=0.9", "optim.warmup_steps=2",
                             "optim.decay_steps=10"])
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2, 2)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    # the first update is clipped (norm > 1), the others are not
    grads = [{k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in shapes.items()}
             for scale in (3.0, 0.05, 0.1)]

    tx = jax_build_optimizer(cfg.optim)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state, ema = tx.init(params), dict(params)
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state,
                                       params)
        params = optax.apply_updates(params, updates)
        ema = {k: ema[k] * 0.9 + (1.0 - 0.9) * params[k] for k in params}

    module = torch.nn.Module()
    for k, v in init.items():
        module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    state = TrainState(module, cfg.optim)
    norms = []
    for g in grads:
        for k, p in module.named_parameters():
            p.grad = torch.from_numpy(g[k].copy())
        norms.append(state.apply_gradients().item())
    assert norms[0] > 1.0 > norms[1]
    for k, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(dict(state.ema.named_parameters())[k].numpy(),
                                   np.asarray(ema[k]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("overrides", [
    [], ["optim.schedule=cosine", "optim.decay_steps=7"],
    ["optim.schedule=step", "optim.step_size=3", "optim.step_gamma=0.5"],
    ["optim.warmup_steps=4", "optim.decay_steps=9"]])
def test_learning_rate_schedules_match_optax(overrides):
    from hierdiff_tpu.config import load_config as jax_load_config

    cfg = load_config(None, overrides)
    jcfg = jax_load_config(None, overrides).optim
    if jcfg.warmup_steps > 0:
        ref = optax.schedules.warmup_cosine_decay_schedule(0.0, jcfg.lr, jcfg.warmup_steps,
                                                            jcfg.decay_steps)
    elif jcfg.schedule == "cosine":
        ref = optax.cosine_decay_schedule(jcfg.lr, jcfg.decay_steps)
    elif jcfg.schedule == "step":
        ref = optax.exponential_decay(jcfg.lr, jcfg.step_size, jcfg.step_gamma, staircase=True)
    else:
        ref = lambda count: jcfg.lr   # noqa: E731
    port = learning_rate_schedule(cfg.optim)
    for count in range(12):
        assert port(count) == pytest.approx(float(ref(count)), rel=1e-6, abs=1e-12), count


def test_config_and_overrides_match_jax():
    from pathlib import Path

    from hierdiff_tpu.config import load_config as jax_load_config

    path = str(Path(__file__).resolve().parent.parent / "configs" / "coarse_geom.yaml")
    overrides = ["train.max_steps=20", "coarse.compute_dtype=null", "optim.lr=0.001",
                 "optim.grad_clip=2", "train.buckets=[8,16,24]", "coarse.attention=false",
                 "optim.schedule=cosine", "train.workdir=/x/y"]
    port, ref = load_config(path, overrides), jax_load_config(path, overrides)
    for section in ("optim", "train"):
        assert vars(getattr(port, section)) == vars(getattr(ref, section)), section
    for name in vars(port.coarse):
        assert getattr(port.coarse, name) == getattr(ref.coarse, name), name


def test_synthetic_trees_and_batches_match_jax():
    from hierdiff_tpu.config import load_config as jax_load_config
    from hierdiff_tpu.data.collate import collate_coarse as jax_collate
    from hierdiff_tpu.train import data_iters as jax_iters

    overrides = ["train.num_train_trees=48", "train.batch_size=6"]
    cfg, jcfg = load_config(None, overrides), jax_load_config(None, overrides)
    pool, jpool = port_iters.load_tree_pool(cfg, seed=3), jax_iters.load_tree_pool(jcfg, seed=3)
    for a, b in zip(pool, jpool):
        for field in ("feats", "pos", "adj", "wids", "sizes"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    for k, v in collate_coarse(pool[:5]).items():
        np.testing.assert_array_equal(v, jax_collate(jpool[:5])[k])
    it, jit_ = port_iters.coarse_iter(cfg, pool, seed=5), jax_iters.coarse_iter(jcfg, jpool, seed=5)
    for _ in range(6):
        a, b = next(it), next(jit_)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_prefetch_keeps_order_and_device():
    cfg = load_config(None, ["train.num_train_trees=16", "train.batch_size=3"])
    pool = port_iters.load_tree_pool(cfg, seed=0)
    ref = list(port_iters.finite(port_iters.coarse_iter(cfg, pool, seed=1), 4))
    got = list(port_iters.prefetch_to_device(
        port_iters.finite(port_iters.coarse_iter(cfg, pool, seed=1), 4), torch.device("cpu")))
    assert len(got) == 4
    for a, b in zip(got, ref):
        for k in b:
            assert a[k].device.type == "cpu"
            np.testing.assert_array_equal(a[k].numpy(), b[k])


def _small_config(tmp_path):
    path = tmp_path / "coarse.yaml"
    path.write_text(f"coarse:\n  hidden_nf: {H}\n  n_layers: {LAYERS}\n  timesteps: {T}\n"
                    "  compute_dtype: bfloat16\n")
    return str(path)


def test_train_cli_on_cpu_resumes_and_feeds_the_sampler(tmp_path):
    config, workdir = _small_config(tmp_path), tmp_path / "run"
    common = ["coarse", "--config", config, "--device", "cpu", "--init-seed", "0",
              f"train.workdir={workdir}", "train.batch_size=4", "train.num_train_trees=32",
              "train.log_every=1", "train.eval_every=2", "train.checkpoint_every=1"]
    first = train_cli.main(common + ["train.max_steps=3"])
    assert first["steps"] == 3 and first["trainer"].state.step == 3
    w3 = {k: v.clone() for k, v in first["trainer"].state.model.state_dict().items()}
    second = train_cli.main(common + ["train.max_steps=5"])
    assert second["steps"] == 2 and second["trainer"].state.step == 5
    changed = [k for k, v in second["trainer"].state.model.state_dict().items()
               if not torch.equal(v, w3[k])]
    assert changed, "resumed run did not update the weights"

    with open(workdir / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    train_rows = [r for r in rows if r["split"] == "train"]
    assert [int(r["step"]) for r in train_rows] == [1, 2, 3, 4, 5]
    assert all(np.isfinite(float(r["loss"])) and np.isfinite(float(r["grad_norm"]))
               for r in train_rows)
    assert [int(r["step"]) for r in rows if r["split"] == "val"] == [2, 4]
    assert sorted(p.name for p in (workdir / "checkpoints").glob("*.pt")) == [
        "step_00000003.pt", "step_00000004.pt", "step_00000005.pt"]
    assert len(list((workdir / "checkpoints_best").glob("*.pt"))) == 1

    ema = torch.load(workdir / "ema.pt", weights_only=True)
    assert torch.equal(ema["gamma.gamma_0"], second["trainer"].state.ema.state_dict()["gamma.gamma_0"])
    out = tmp_path / "samples.pkl"
    run = sample_cli.main(["coarse", "--config", config, "--weights", str(workdir / "ema.pt"),
                           "--num", "3", "--batch-size", "3", "--steps", "2", "--max-nodes", "9",
                           "--device", "cpu", "--out", str(out)])
    with open(out, "rb") as f:
        assert len(pickle.load(f)[0]) == 3 == run["molecules"]


def test_find_lr_writes_the_sweep(tmp_path, monkeypatch):
    # the CLI's route with a 40-step sweep, the size of the JAX package's
    # test (tests/test_trainer.py:86); the CLI's own sweep has 100
    from hierdiff_torch.train.trainer import Trainer

    sweep = Trainer.find_lr
    monkeypatch.setattr(Trainer, "find_lr",
                        lambda self, it, **kw: sweep(self, it, **{"n_steps": 40, **kw}))
    workdir = tmp_path / "lr"
    train_cli.main(["coarse", "--config", _small_config(tmp_path), "--device", "cpu",
                    "--find-lr", f"train.workdir={workdir}", "train.batch_size=2",
                    "train.num_train_trees=8"])
    with open(workdir / "lr_find.csv") as f:
        rows = list(csv.DictReader(f))
    assert 1 <= len(rows) <= 100 and float(rows[0]["lr"]) == pytest.approx(1e-6)


@pytest.mark.gpu
def test_training_step_on_the_card_reaches_every_parameter():
    """On the card: loss.backward() through the kernels leaves a finite,
    non-zero gradient on every parameter (every GCL, coordinate MLP,
    embedding and gamma parameter), and the GCL backward ran its kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CUDA kernels have no CPU mode")
    from hierdiff_torch.ops import egnn_kernels as ek

    _, _, port, batch = _models()
    port = port.cuda()
    t_int, eps, eps0 = _draws(batch)
    ek.reset_launch_counts()
    out = port({k: v.cuda() for k, v in _torch_batch(batch).items()}, None, train=True,
               t_int=torch.from_numpy(t_int).cuda(), eps=torch.from_numpy(eps).cuda())
    out["loss"].backward()
    torch.cuda.synchronize()
    assert ek.launch_counts["fused_gcl_bwd"] == 2 * LAYERS
    assert ek.launch_counts["coord_update_autograd"] == LAYERS
    assert ek.launch_counts["fused_coord_update"] == 0
    for name, p in port.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all() and p.grad.abs().max() > 0, name
