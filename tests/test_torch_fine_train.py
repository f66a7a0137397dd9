"""PyTorch port of the fine stage's training (the masked losses, tree orders,
the denoise and refine batches with both packers, the planted generator,
``EdgeDenoise.forward``, ``NodeRefine.forward``, the generic train step and
``train.cli denoise | refine``) against the JAX package on the same numpy
inputs, weights and ``random.Random`` draws.

JAX runs on the CPU at matmul precision "highest", torch without TF32 and
with one intra-op thread. Sizes are small: hidden 32, one layer of each
kind, trees of 5-7 nodes padded to 8; one module fixture compiles each JAX
program once.

Bars. Loss terms: 1e-5 of the largest |term| (float32 sums in another
order). A gradient tensor: 1e-4 of its largest |value| (rounding through
the depth loops), that largest value floored at 1e-3 of the model's
largest gradient: a gradient that is zero by structure (the edge head's
last bias, which the softmax cancels) is rounding noise in both frameworks.
"""

import csv
import pickle
import random
import warnings
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hierdiff_torch import runtime as port_runtime
from hierdiff_torch.config import load_config
from hierdiff_torch.data import denoise as port_denoise
from hierdiff_torch.data import orders as port_orders
from hierdiff_torch.data import refine as port_refine
from hierdiff_torch.data import synthetic as port_synthetic
from hierdiff_torch.models.edge_denoise import EdgeDenoise as PortDenoise
from hierdiff_torch.models.refine import NodeRefine as PortRefine
from hierdiff_torch.ops import masked as port_masked
from hierdiff_torch.parallel.train_step import TrainState, train_step
from hierdiff_torch.sampling import cli as sample_cli
from hierdiff_torch.train import cli as train_cli
from hierdiff_torch.train import data_iters as port_iters
from hierdiff_torch.utils import weights as port_weights
from hierdiff_tpu import runtime as jax_runtime
from hierdiff_tpu.config import load_config as jax_load_config
from hierdiff_tpu.data import denoise as jax_denoise
from hierdiff_tpu.data import orders as jax_orders
from hierdiff_tpu.data import refine as jax_refine
from hierdiff_tpu.data import synthetic as jax_synthetic
from hierdiff_tpu.models.edge_denoise import EdgeDenoise
from hierdiff_tpu.models.refine import NodeRefine
from hierdiff_tpu.ops import masked as jax_masked
from hierdiff_tpu.parallel.train_step import TrainState as JaxState
from hierdiff_tpu.parallel.train_step import make_train_step
from hierdiff_tpu.train import cli as jax_train_cli
from hierdiff_tpu.train import data_iters as jax_iters
from hierdiff_tpu.train.trainer import build_optimizer

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
H, NB = 32, 8
SIZES = (5, 6, 7, 5, 6, 7)
SMALL = [f"denoise.hidden_nf={H}", "denoise.n_layers_full=1", "denoise.n_layers_focal=1",
         f"refine.hidden_size={H}", "refine.n_layers=1"]
TERM_REL = 1e-5
GRAD_REL, GRAD_FLOOR = 1e-4, 1e-3
# after the first update the two frameworks' weights differ by the rounding
# of the updates (~3e-6 of each tensor); the gradient norm at these
# untrained weights amplifies that ~20x (7e-5 measured at step 3; on equal
# weights it agrees to 1.4e-6)
STEP_GRAD_REL = 1e-3
# the weights after three AdamW steps: of each tensor's largest |value|
PARAM_REL = 1e-4

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / (np.abs(ref).max() + 1e-30))


def _assert_batches_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in b:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _grad_errors(port, ref_state):
    """Per parameter: max |port - JAX| over the floored largest |JAX value|.
    A parameter the loss does not reach has no torch gradient; JAX's is 0."""
    ref = {k: np.asarray(v, np.float64) for k, v in ref_state.items()}
    top = max(np.abs(v).max() for v in ref.values())
    errs = {}
    for name, p in port.named_parameters():
        got = p.grad.double().numpy() if p.grad is not None else np.zeros_like(ref[name])
        scale = max(np.abs(ref[name]).max(), GRAD_FLOOR * top)
        errs[name] = float(np.abs(got - ref[name]).max() / scale)
    return errs


# --- shared fixture: trees, batches, the JAX models and their gradients ---------


@pytest.fixture(scope="module")
def fx():
    gen = jax_synthetic.SyntheticTreeGenerator(seed=5)
    trees = [gen.sample_tree(n) for n in SIZES]
    batches = {allowed: jax_denoise.make_denoise_batch(
        trees, random.Random(0), max_n=NB, use_array_dict=allowed, allow_native=False)
        for allowed in (False, True)}
    rbatch = jax_refine.make_refine_batch(trees, random.Random(1), max_n=NB)

    denoise = EdgeDenoise(hidden_nf=H, n_layers_full=1, n_layers_focal=1)
    refine = NodeRefine(hidden_size=H, n_layers=1)
    dparams = jax.jit(denoise.init)(jax.random.PRNGKey(0), batches[False])
    rparams = jax.jit(refine.init)(jax.random.PRNGKey(1), rbatch)

    def value_and_grad(model, key):
        def fn(p, b):
            out = model.apply(p, b)
            return out[key], out
        return jax.jit(jax.value_and_grad(fn, has_aux=True))

    with jax.default_matmul_precision("highest"):
        dvg = value_and_grad(denoise, "total_loss")
        dout = {k: _np(dvg(dparams, b)) for k, b in batches.items()}
        rout = _np(value_and_grad(refine, "loss")(rparams, rbatch))
    return {"trees": trees, "batches": batches, "rbatch": rbatch,
            "denoise": denoise, "dparams": _np(dparams), "dout": dout,
            "refine": refine, "rparams": _np(rparams), "rout": rout}


def _port_denoise(fx):
    port = PortDenoise(hidden_nf=H, n_layers_full=1, n_layers_focal=1)
    port.load_state_dict(port_weights.denoise_state_dict_from_flax(fx["dparams"]), strict=True)
    return port


def _port_refine(fx):
    port = PortRefine(hidden_size=H, n_layers=1)
    port.load_state_dict(port_weights.refine_state_dict_from_flax(fx["rparams"]), strict=True)
    return port


# --- 1. masked losses ---------------------------------------------------------


def test_masked_losses_and_their_gradients_match_jax():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((5, 9)) * 3).astype(np.float32)
    support = (rng.uniform(size=(5, 9)) > 0.4).astype(np.float32)
    support[3] = 0.0                                 # an empty support row stays finite
    target = np.array([0, 4, 8, 2, 11], np.int32)    # 11 is clamped, as onehot_take does
    p = rng.uniform(size=(4, 6)).astype(np.float32)
    p[0, :3] = [0.0, 1.0, np.float32(1 - 1e-7)]      # at and past the clip bounds
    label = (rng.uniform(size=(4, 6)) > 0.5).astype(np.float32)

    ce, ce_grad = jax.value_and_grad(lambda z: jax_masked.masked_cross_entropy(
        z, target, support).sum())(logits)
    bce, bce_grad = jax.value_and_grad(lambda q: jax_masked.binary_cross_entropy(
        q, label).sum())(p)

    z = torch.from_numpy(logits).requires_grad_()
    out = port_masked.masked_cross_entropy(z, torch.from_numpy(target), torch.from_numpy(support))
    assert torch.isfinite(out).all()
    out.sum().backward()
    q = torch.from_numpy(p).requires_grad_()
    out_b = port_masked.binary_cross_entropy(q, torch.from_numpy(label))
    out_b.sum().backward()
    assert _rel(out.sum().item(), ce) < TERM_REL and _rel(out_b.sum().item(), bce) < TERM_REL
    assert _rel(z.grad.numpy(), ce_grad) < TERM_REL
    assert _rel(q.grad.numpy(), bce_grad) < TERM_REL
    # at the upper clip bound both halve the gradient (jnp.clip's tie rule)
    assert q.grad[0, 2].item() == pytest.approx(float(bce_grad[0, 2]), rel=TERM_REL)


# --- 2. data: orders, batches, generator, iterators ----------------------------


def test_orders_match_jax_and_leave_the_stream_alike():
    gen = jax_synthetic.SyntheticTreeGenerator(seed=2)
    for seed, t in enumerate(gen.sample_trees(5, n=7) + [gen.sample_tree(1)]):
        graph = port_orders.adj_to_graph(t.adj)
        assert graph == jax_orders.adj_to_graph(t.adj)
        assert port_orders.get_dfs_order(graph, 0) == jax_orders.get_dfs_order(graph, 0)
        a, b = random.Random(seed), random.Random(seed)
        for _ in range(4):
            step = port_orders.dfs_bidirection(t.adj, a)
            assert step == jax_orders.dfs_bidirection(t.adj, b)
            for x, y in zip(port_orders.make_search_adjacencies(t.adj, *step),
                            jax_orders.make_search_adjacencies(t.adj, *step)):
                np.testing.assert_array_equal(x, y)
        for end in range(t.adj.shape[0]):
            layers = port_orders.bfs_layers_toward(t.adj, end)
            assert layers == jax_orders.bfs_layers_toward(t.adj, end)
            np.testing.assert_array_equal(port_orders.layers_to_dense(layers, NB, 6),
                                          jax_orders.layers_to_dense(layers, NB, 6))
            assert (port_orders.bfs_depth_edges_center(t.adj, end, a, walk_len=4)
                    == jax_orders.bfs_depth_edges_center(t.adj, end, b, walk_len=4))
        assert a.getstate() == b.getstate()


@pytest.mark.parametrize("use_array_dict", [False, True])
def test_python_denoise_batches_match_jax(fx, use_array_dict):
    a, b = random.Random(7), random.Random(7)
    for _ in range(3):
        _assert_batches_equal(
            port_denoise.make_denoise_batch(fx["trees"], a, max_n=NB,
                                            use_array_dict=use_array_dict, allow_native=False),
            jax_denoise.make_denoise_batch(fx["trees"], b, max_n=NB,
                                           use_array_dict=use_array_dict, allow_native=False))
    assert a.getstate() == b.getstate()
    assert port_denoise.UNDISCOVERED_TOKEN == jax_denoise.UNDISCOVERED_TOKEN


def test_native_packer_matches_jax():
    if port_runtime.compiler() is None:
        pytest.skip("no C++ compiler: the native packer cannot be built")
    assert port_runtime.treekit_available() and jax_runtime.treekit_available()
    gen = jax_synthetic.SyntheticTreeGenerator(seed=4)
    trees = [gen.sample_tree(n) for n in (3, 7, 12, 1, 9)]
    for t in trees[:2]:
        for k in range(t.adj.shape[0]):
            got, ref = (port_runtime.dfs_bidirection_native(t.adj, 5, k),
                        jax_runtime.dfs_bidirection_native(t.adj, 5, k))
            np.testing.assert_array_equal(got[0], ref[0])
            assert got[1:] == ref[1:]
            for x, y in zip(port_runtime.make_search_adj_native(t.adj, *got),
                            jax_runtime.make_search_adj_native(t.adj, *ref)):
                np.testing.assert_array_equal(x, y)
    packers = Counter()
    a, b = random.Random(3), random.Random(3)
    for max_n in (16, 24):
        _assert_batches_equal(
            port_denoise.make_denoise_batch(trees, a, max_n=max_n, packers=packers),
            jax_denoise.make_denoise_batch(trees, b, max_n=max_n))
    assert a.getstate() == b.getstate() and packers == {"native": 2}


def test_refine_batches_and_planted_trees_match_jax(fx):
    a, b = random.Random(9), random.Random(9)
    for _ in range(3):
        _assert_batches_equal(port_refine.make_refine_batch(fx["trees"], a, max_n=NB),
                              jax_refine.make_refine_batch(fx["trees"], b, max_n=NB))
    assert a.getstate() == b.getstate()
    for kw in ({"planted": True, "planted_k": 16}, {"planted": True, "mode": "elem"}):
        with warnings.catch_warnings(record=True) as got_w:
            warnings.simplefilter("always")
            port_gen = port_synthetic.SyntheticTreeGenerator(seed=1, **kw)
        with warnings.catch_warnings(record=True) as ref_w:
            warnings.simplefilter("always")
            jax_gen = jax_synthetic.SyntheticTreeGenerator(seed=1, **kw)
        assert [str(w.message) for w in got_w] == [str(w.message) for w in ref_w]
        np.testing.assert_array_equal(port_gen.planted_wids, jax_gen.planted_wids)
        for x, y in zip(port_gen.sample_trees(4), jax_gen.sample_trees(4)):
            assert len(set(x.wids.tolist())) == 1
            for field in ("feats", "pos", "adj", "wids", "sizes"):
                np.testing.assert_array_equal(getattr(x, field), getattr(y, field))


@pytest.mark.parametrize("stage,over", [("denoise", []),
                                        ("denoise", ["denoise.full_softmax=false"]),
                                        ("refine", [])])
def test_iterators_match_jax(stage, over):
    over = ["train.num_train_trees=24", "train.batch_size=5", *over]
    cfg, jcfg = load_config(None, over), jax_load_config(None, over)
    pool, jpool = port_iters.load_tree_pool(cfg, seed=2), jax_iters.load_tree_pool(jcfg, seed=2)
    it = getattr(port_iters, f"{stage}_iter")(cfg, pool, seed=6)
    jit_ = getattr(jax_iters, f"{stage}_iter")(jcfg, jpool, seed=6)
    for _ in range(3):
        _assert_batches_equal(next(it), next(jit_))


# --- 3. the losses and their gradients ------------------------------------------


@pytest.mark.parametrize("allowed", [False, True])
def test_edge_denoise_loss_and_gradients_match_jax(fx, allowed):
    batch = fx["batches"][allowed]
    assert ("allowed_mask" in batch) == allowed
    (_, ref), grads = fx["dout"][allowed]
    port = _port_denoise(fx)
    out = port(_t(batch))
    assert sorted(out) == sorted(ref)
    out["total_loss"].backward()
    for k in ref:
        if k.endswith("accuracy"):
            assert out[k].item() == float(ref[k]), k
        else:
            assert _rel(out[k].item(), ref[k]) < TERM_REL, (k, out[k].item(), ref[k])
    errs = _grad_errors(port, port_weights.denoise_flax_to_numpy_state(grads))
    assert max(errs.values()) < GRAD_REL, sorted(errs.items(), key=lambda kv: -kv[1])[:4]
    with torch.no_grad():   # dynamic depth, an inference option, gives the same loss
        dyn = port.clone(dynamic_depth=True)(_t(batch))
    assert all(torch.equal(dyn[k], out[k].detach()) for k in out)


def test_node_refine_loss_and_gradients_match_jax(fx):
    (_, ref), grads = fx["rout"]
    port = _port_refine(fx)
    out = port(_t(fx["rbatch"]))
    out["loss"].backward()
    assert _rel(out["loss"].item(), ref["loss"]) < TERM_REL
    assert out["accuracy"].item() == float(ref["accuracy"])
    assert _rel(out["logits"].detach().numpy(), ref["logits"]) < TERM_REL
    errs = _grad_errors(port, port_weights.refine_flax_to_numpy_state(grads))
    assert max(errs.values()) < GRAD_REL, sorted(errs.items(), key=lambda kv: -kv[1])[:4]


# --- 4. three optimizer steps -----------------------------------------------------


def test_three_train_steps_match_optax(fx):
    """AdamW with clipping (every step clips here) and the EMA, on three
    batches of one shape. The edge head's last bias has a gradient that is
    zero by structure: Adam normalises each framework's rounding noise to a
    step of ~lr, so that tensor is held to 2 lr per step instead."""
    over = SMALL + ["optim.grad_clip=1.0", "optim.lr=4e-4"]
    cfg, jcfg = load_config(None, over), jax_load_config(None, over)
    batches = [jax_denoise.make_denoise_batch(fx["trees"], random.Random(s), max_n=NB,
                                              allow_native=False) for s in range(3)]
    _, jloss = jax_train_cli.build_denoise(jcfg)
    jstate = JaxState.create(fx["dparams"], build_optimizer(jcfg.optim),
                             ema_decay=jcfg.optim.ema_decay)
    step = make_train_step(jloss, donate_state=False)
    state = TrainState(_port_denoise(fx), cfg.optim)
    losses = []
    with jax.default_matmul_precision("highest"):
        for b in batches:
            jstate, jm = step(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                              jax.random.PRNGKey(0))
            m = train_step(state, train_cli.denoise_loss, _t(b), None)
            losses.append((m["loss"].item(), float(jm["loss"]), m["grad_norm"].item(),
                           float(jm["grad_norm"])))
            assert sorted(m) == sorted(jm)
    assert all(_rel(a, b) < TERM_REL for a, b, _, _ in losses), losses
    assert _rel(losses[0][2], losses[0][3]) < TERM_REL, losses
    assert all(_rel(c, d) < STEP_GRAD_REL for _, _, c, d in losses[1:]), losses
    assert all(g > 1.0 for *_, g in losses)            # the clip was active
    lr = cfg.optim.lr
    for model, ref in ((state.model, jstate.params), (state.ema, jstate.ema_params)):
        ref = port_weights.denoise_flax_to_numpy_state(_np(ref))
        for name, p in model.state_dict().items():
            got = p.double().numpy()
            if name == "edge_predict.2.bias":
                assert np.abs(got - ref[name]).max() <= 2 * lr * 3
            else:
                assert _rel(got, ref[name]) < PARAM_REL, name


# --- 5. the training CLI ----------------------------------------------------------


def test_train_cli_denoise_and_refine_feed_assemble(fx, tmp_path):
    """Two steps, a resumed third, JAX's metric columns (plus the port's
    rate column), and the two ema.pt files strict-loaded by assemble."""
    jax_cols = {
        "denoise": ["step", "split", *(k for k in fx["dout"][False][0][1] if k != "total_loss"),
                    "loss", "grad_norm", "steps_per_sec"],
        "refine": ["step", "split", "accuracy", "loss", "grad_norm", "steps_per_sec"]}
    ema = {}
    for stage in ("denoise", "refine"):
        workdir = tmp_path / stage
        common = [stage, "--device", "cpu", "--init-seed", "0", f"train.workdir={workdir}",
                  "train.batch_size=3", "train.num_train_trees=12", "train.buckets=[8,16,24,32]",
                  "train.log_every=1", "train.eval_every=2", "train.checkpoint_every=1",
                  *SMALL]
        first = train_cli.main(common + ["train.max_steps=2"])
        assert first["steps"] == 2 and first["trainer"].state.step == 2
        second = train_cli.main(common + ["train.max_steps=3"])
        assert second["steps"] == 1 and second["trainer"].state.step == 3
        if stage == "denoise":
            assert set(second["packers"]) == {"native" if port_runtime.treekit_available()
                                              else "python"}
        with open(workdir / "metrics.csv") as f:
            reader = csv.DictReader(f)
            rows = list(reader)
        assert set(reader.fieldnames) == set(jax_cols[stage]) | {"trees_per_sec"}
        train_rows = [r for r in rows if r["split"] == "train"]
        assert [int(r["step"]) for r in train_rows] == [1, 2, 3]
        assert all(np.isfinite(float(r[k])) for r in train_rows for k in jax_cols[stage][2:])
        assert [int(r["step"]) for r in rows if r["split"] == "val"] == [2]
        ema[stage] = workdir / "ema.pt"

    blur = [{"x": t.pos.astype(np.float32), "h": t.feats.astype(np.float32)}
            for t in fx["trees"][:3]]
    src, out = tmp_path / "coarse.pkl", tmp_path / "trees.pkl"
    with open(src, "wb") as f:
        pickle.dump([blur], f)
    sample_cli.main(["assemble", "--coarse-pkl", str(src), "--device", "cpu", "--beam", "2",
                     "--denoise-weights", str(ema["denoise"]),
                     "--refine-weights", str(ema["refine"]), "--out", str(out), *SMALL])
    with open(out, "rb") as f:
        trees = pickle.load(f)["trees"]
    assert [d["adj"].shape[0] for d in trees] == [5, 6, 7]
    for d in trees:
        assert (d["adj"] * (1 - np.eye(len(d["adj"])))).sum() == 2 * (len(d["adj"]) - 1)


@pytest.mark.parametrize("name", sorted(p.name for p in CONFIGS.glob("*.yaml")))
def test_read_yaml_equals_pyyaml_on_the_shipped_configs(name):
    """The card's machine has no PyYAML: the port reads the configs itself."""
    import yaml

    from hierdiff_torch.config import read_yaml

    with open(CONFIGS / name) as f:
        assert read_yaml(str(CONFIGS / name)) == yaml.safe_load(f)


def test_denoise_and_refine_cli_need_cuda_unless_told_otherwise(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for stage in ("denoise", "refine"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_cli.main([stage, "--init-seed", "0", f"train.workdir={tmp_path / stage}"])


# --- 6. repairs: the parent gathers' backward, the CLI's first batch --------------


@pytest.mark.parametrize("case", ["star", "random", "chain"])
def test_parent_gather_backward_is_the_plain_gathers(case):
    """The fixed-order backward of ``parent_gather`` (a one-hot product)
    against autograd of ``torch.gather`` on the same pointers: the forward
    bit for bit, the gradient within 1e-6 of its largest |value|, the f32
    rounding of a sum of up to N = 16 terms taken in another order. The
    "star" case gives 11 children one parent."""
    from hierdiff_torch.ops.gcl import parent_gather

    rng = np.random.default_rng(4)
    b, n, f = 3, 16, 5
    if case == "star":
        parent = np.zeros((b, n), np.int64)
        parent[:, 11:] = np.arange(11, n)            # padded rows point at themselves
    elif case == "random":
        parent = rng.integers(0, n, size=(b, n))
    else:
        parent = np.maximum(np.arange(n) - 1, 0)[None].repeat(b, 0)
    t = torch.from_numpy(rng.standard_normal((b, n, f)).astype(np.float32))
    up = torch.from_numpy(rng.standard_normal((b, n, f)).astype(np.float32))
    p = torch.from_numpy(parent)
    a, ref = t.clone().requires_grad_(True), t.clone().requires_grad_(True)
    out = parent_gather(a, p)
    plain = torch.gather(ref, 1, p[..., None].expand(-1, -1, f))
    assert torch.equal(out, plain)
    (out * up).sum().backward()
    (plain * up).sum().backward()
    g, g_ref = a.grad.numpy(), ref.grad.numpy()
    assert np.abs(g - g_ref).max() <= 1e-6 * np.abs(g_ref).max()
    if case == "star":
        assert np.count_nonzero(parent[0] == 0) >= 8
        np.testing.assert_allclose(g[:, 0], up[:, :11].sum(1).numpy(), rtol=1e-6, atol=1e-6)


class _FirstBatch(Exception):
    pass


@pytest.mark.parametrize("stage", ["coarse", "denoise", "refine"])
def test_train_cli_trains_from_the_streams_second_batch(stage, monkeypatch, tmp_path):
    """The JAX CLI spends the stream's first batch on model.init, so fit
    starts at the second: the port's CLI hands fit the same stream. The
    first batch fit draws equals the iterator's second, bit for bit."""
    seen = {}

    def fit(self, train_it, **kwargs):
        seen["batch"] = next(train_it)
        raise _FirstBatch

    monkeypatch.setattr(train_cli.Trainer, "fit", fit)
    over = [f"train.workdir={tmp_path}", "train.batch_size=3", "train.num_train_trees=12",
            "coarse.hidden_nf=16", "coarse.n_layers=1", *SMALL]
    with pytest.raises(_FirstBatch):
        train_cli.main([stage, "--device", "cpu", "--init-seed", "0", *over])
    cfg = load_config(None, over)
    pool = port_iters.load_tree_pool(cfg, seed=cfg.train.seed)
    it = getattr(port_iters, f"{stage}_iter")(cfg, pool, seed=cfg.train.seed)
    first, second = next(it), next(it)
    assert set(seen["batch"]) == set(second)
    for k, v in second.items():
        np.testing.assert_array_equal(seen["batch"][k].numpy(), v)
    assert any(not np.array_equal(first[k], second[k]) for k in first if k in second)
