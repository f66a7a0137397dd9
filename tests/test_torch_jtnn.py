"""PyTorch port of the JT-VAE stack (``hierdiff_torch/models/jtnn.py``)
against the JAX modules (``hierdiff_tpu/models/jtnn.py``) on the same numpy
inputs and weights, in f32 on the CPU (JAX at HIGHEST matmul precision, TF32
off in torch), on the trees of ``tests/test_jtnn.py``.

Tolerances: the two frameworks sum the GRU's products and the children's
messages in different orders, so values are held to 1e-5 absolute (the
measured gap is ~5e-8 on messages of size ~0.2) and gradients to 1e-5 of
the largest entry of each JAX gradient. The DFS traces and the featurised
graphs are integer or one-hot data: equal exactly.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
import fake_rdkit  # noqa: E402

from hierdiff_torch.models import jtnn as port  # noqa: E402
from hierdiff_torch.utils.weights import (jtnn_flax_to_numpy_state,  # noqa: E402
                                          jtnn_state_dict_from_flax)
from hierdiff_tpu.models import jtnn as ref  # noqa: E402

ATOL = 1e-5
GRAD_REL = 1e-5
# the reference modules' state-dict keys (jtnn_enc.py, jtnn_dec.py, mpn.py)
GRU_KEYS = {"W_z.weight", "W_z.bias", "W_r.weight", "U_r.weight", "U_r.bias",
            "W_h.weight", "W_h.bias"}
REFERENCE_KEYS = {
    "encoder": GRU_KEYS | {"embedding.weight", "W.weight", "W.bias"},
    "decoder": GRU_KEYS | {"embedding.weight", "W.weight", "W.bias", "U.weight", "U.bias",
                           "W_o.weight", "W_o.bias", "U_s.weight", "U_s.bias"},
    "mpn": {"W_i.weight", "W_h.weight", "W_o.weight", "W_o.bias"},
}
REFERENCE_KEYS["jtmpn"] = REFERENCE_KEYS["mpn"]
MPN_SMILES = ["CC(=O)NC1=CC=C(O)C=C1", "C1CCCCC1", "CCO"]


@pytest.fixture(autouse=True)
def highest_precision():
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield
    torch.backends.cuda.matmul.allow_tf32 = tf32


def random_tree_adj(n, rng):
    """tests/test_jtnn.py's random trees."""
    adj = np.zeros((n, n), np.float32)
    for i in range(1, n):
        p = rng.integers(0, i)
        adj[i, p] = adj[p, i] = 1.0
    return adj


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(module, params):
    module.load_state_dict(jtnn_state_dict_from_flax(_np(params)), strict=True)
    return module


@pytest.fixture(scope="module")
def enc():
    """tests/test_jtnn.py's encoder setup: 3 trees of 7 nodes, vocab 50,
    hidden 16."""
    rng = np.random.default_rng(0)
    b, n, v, h = 3, 7, 50, 16
    adjs = np.stack([random_tree_adj(n, rng) for _ in range(b)])
    wids = rng.integers(0, v, size=(b, n))
    nm = np.ones((b, n, 1), np.float32)
    model = ref.JTNNEncoder(vocab_size=v, hidden_size=h)
    with jax.default_matmul_precision("highest"):
        params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(wids),
                                     jnp.asarray(adjs), jnp.asarray(nm))
    mine = _port(port.JTNNEncoder(v, h, device="cpu"), params)
    return {"model": model, "params": params, "port": mine, "adjs": adjs, "wids": wids,
            "nm": nm}


@pytest.fixture(scope="module")
def dec():
    """tests/test_jtnn.py's decoder batch (4 trees of 6 nodes, vocab 30,
    hidden 16, latent 8) with one tree cut to 4 nodes, so the trace carries
    padded steps; the JAX outputs and the gradients of pred_loss and
    stop_loss."""
    rng = np.random.default_rng(1)
    b, n, v, h, latent = 4, 6, 30, 16, 8
    adjs = [random_tree_adj(n, rng) for _ in range(b)]
    adjs[2][4:, :] = 0.0
    adjs[2][:, 4:] = 0.0
    wids = rng.integers(0, v, size=(b, n))
    nm = np.ones((b, n, 1), np.float32)
    nm[2, 4:] = 0.0
    trace = ref.collate_traces(adjs, n)
    mol_vec = rng.standard_normal((b, latent)).astype(np.float32)
    model = ref.JTNNDecoder(vocab_size=v, hidden_size=h, latent_size=latent)
    jin = (jnp.asarray(wids), jnp.asarray(nm), {k: jnp.asarray(t) for k, t in trace.items()},
           jnp.asarray(mol_vec))

    def outputs(p):
        grad = {key: jax.grad(lambda q: model.apply(q, *jin)[key])(p)
                for key in ("pred_loss", "stop_loss")}
        return model.apply(p, *jin), grad

    with jax.default_matmul_precision("highest"):
        params = jax.jit(model.init)(jax.random.PRNGKey(0), *jin)
        want, grads = jax.jit(outputs)(params)
    return {"params": params, "want": want, "grads": grads,
            "port": _port(port.JTNNDecoder(v, h, latent, device="cpu"), params),
            "inputs": (torch.from_numpy(wids), torch.from_numpy(nm),
                       {k: torch.from_numpy(t) for k, t in trace.items()},
                       torch.from_numpy(mol_vec))}


@pytest.fixture(scope="module")
def mpn():
    """``mol2graph_dense`` of tests/test_jtnn.py's harness molecules from both
    packages, and MPN / JTMPN (hidden 16, depth 3) params."""
    fake_rdkit.install()
    try:
        graph = port.mol2graph_dense(MPN_SMILES)
        want_graph = ref.mol2graph_dense(MPN_SMILES)
    finally:
        fake_rdkit.uninstall()
    jg = {k: jnp.asarray(v) for k, v in graph.items()}
    mods = {"mpn": ref.MPN(hidden_size=16, depth=3), "jtmpn": ref.JTMPN(hidden_size=16, depth=3)}
    with jax.default_matmul_precision("highest"):
        params = {k: jax.jit(m.init)(jax.random.PRNGKey(i), jg)
                  for i, (k, m) in enumerate(mods.items())}
    return {"graph": graph, "want_graph": want_graph, "jax_graph": jg, "modules": mods,
            "params": params}


def _padded(adjs, wids, pad):
    b, n = wids.shape
    adj_p = np.zeros((b, n + pad, n + pad), np.float32)
    adj_p[:, :n, :n] = adjs
    wids_p = np.concatenate([wids, np.zeros((b, pad), wids.dtype)], axis=1)
    nm_p = np.zeros((b, n + pad, 1), np.float32)
    nm_p[:, :n] = 1.0
    return adj_p, wids_p, nm_p


@pytest.mark.parametrize("pad", [0, 4])
def test_encoder_equals_jax(enc, pad):
    """up, down and root_vecs equal the JAX encoder's, unpadded and with 4
    padded nodes; padded, the port's messages equal its unpadded ones
    (tests/test_jtnn.py's padding-independence case)."""
    adjs, wids, nm = enc["adjs"], enc["wids"], enc["nm"]
    if pad:
        adjs, wids, nm = _padded(adjs, wids, pad)
    want = jax.jit(enc["model"].apply)(enc["params"], jnp.asarray(wids), jnp.asarray(adjs),
                                       jnp.asarray(nm))
    with torch.no_grad():
        got = enc["port"](torch.from_numpy(wids), torch.from_numpy(adjs), torch.from_numpy(nm))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)
    if pad:
        n = enc["wids"].shape[1]
        with torch.no_grad():
            plain = enc["port"](torch.from_numpy(enc["wids"]), torch.from_numpy(enc["adjs"]),
                                torch.from_numpy(enc["nm"]))
        np.testing.assert_allclose(got[2].numpy(), plain[2].numpy(), rtol=0, atol=ATOL)
        for k in (0, 1):
            np.testing.assert_allclose(got[k][:, :n].numpy(), plain[k].numpy(), rtol=0,
                                       atol=ATOL)
            assert float(got[k][:, n:].abs().max()) == 0.0


def test_build_trace_and_collate_equal_jax():
    rng = np.random.default_rng(2)
    adjs = [random_tree_adj(n, rng) for n in (5, 1, 7, 3)]
    for adj in adjs:
        assert port.build_trace(adj) == ref.build_trace(adj)
    mine, want = port.collate_traces(adjs, 7), ref.collate_traces(adjs, 7)
    assert mine.keys() == want.keys()
    for k in want:
        assert mine[k].dtype == want[k].dtype
        np.testing.assert_array_equal(mine[k], want[k])


def test_decoder_equals_jax(dec):
    """The four outputs and the loss, and the gradients of pred_loss and
    stop_loss for every parameter."""
    mine, want = dec["port"], dec["want"]
    with torch.no_grad():
        got = mine(*dec["inputs"])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=0, atol=ATOL)
    for key in ("pred_loss", "stop_loss"):
        grads = jtnn_flax_to_numpy_state(_np(dec["grads"][key]))
        mine.zero_grad(set_to_none=True)
        mine(*dec["inputs"])[key].backward()
        for name, p in mine.named_parameters():
            g = np.zeros_like(grads[name]) if p.grad is None else p.grad.numpy()
            scale = max(float(np.abs(grads[name]).max()), 1e-30)
            assert float(np.abs(g - grads[name]).max()) <= GRAD_REL * scale + 1e-7, (key, name)


def test_mpn_and_jtmpn_equal_jax(mpn):
    """The featurisation equals the JAX one exactly; MPN, and JTMPN without
    and with a tree seed, equal the JAX modules."""
    graph = mpn["graph"]
    assert graph.keys() == mpn["want_graph"].keys()
    for k in graph:
        np.testing.assert_array_equal(graph[k], mpn["want_graph"][k])
    tg = {k: torch.from_numpy(v) for k, v in graph.items()}
    a = graph["fatoms"].shape[1]
    seed = np.zeros((3, a, a, 16), np.float32)
    seed[:, 0, 1, :] = 1.0
    for which, seeds in (("mpn", (None,)), ("jtmpn", (None, seed))):
        module, params = mpn["modules"][which], mpn["params"][which]
        mine = _port((port.MPN if which == "mpn" else port.JTMPN)(16, 3, device="cpu"), params)
        for s in seeds:
            extra = () if s is None else (s,)
            with jax.default_matmul_precision("highest"):
                want = module.apply(params, mpn["jax_graph"], *map(jnp.asarray, extra))
            with torch.no_grad():
                got = mine(tg, *map(torch.from_numpy, extra))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("which", ["encoder", "decoder", "mpn", "jtmpn"])
def test_weight_mapping_round_trips(which, enc, dec, mpn):
    """Flax params -> the reference's key names -> strict load -> the port's
    state dict gives back every key and value."""
    params = {"encoder": enc["params"], "decoder": dec["params"]}.get(which)
    if params is None:
        params = mpn["params"][which]
    mine = {"encoder": lambda: port.JTNNEncoder(50, 16, device="cpu"),
            "decoder": lambda: port.JTNNDecoder(30, 16, 8, device="cpu"),
            "mpn": lambda: port.MPN(16, 3, device="cpu"),
            "jtmpn": lambda: port.JTMPN(16, 3, device="cpu")}[which]()
    sd = jtnn_flax_to_numpy_state(_np(params))
    assert set(sd) == REFERENCE_KEYS[which]
    mine.load_state_dict(jtnn_state_dict_from_flax(_np(params)), strict=True)
    back = mine.state_dict()
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v)


def test_modules_run_on_cuda_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: port.JTNNEncoder(10, 8), lambda: port.JTNNDecoder(10, 8, 4),
                  lambda: port.MPN(8), lambda: port.JTMPN(8)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()


def test_encoder_gradient_repeats_bitwise(enc):
    """Two backward passes of the encoder give the same gradients bit for
    bit (the fixed-order parent sums)."""
    inputs = (torch.from_numpy(enc["wids"]), torch.from_numpy(enc["adjs"]),
              torch.from_numpy(enc["nm"]))
    runs = []
    for _ in range(2):
        enc["port"].zero_grad(set_to_none=True)
        up, down, root = enc["port"](*inputs)
        (up.square().sum() + down.sum() + root.sum()).backward()
        runs.append({k: p.grad.clone() for k, p in enc["port"].named_parameters()})
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k
