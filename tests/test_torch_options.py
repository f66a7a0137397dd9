"""The port's options of ported models against the JAX package: the fine
stage in bf16 (``compute_dtype='bfloat16'``, ``--fine-bf16``), the per-node
vocab restriction (``allowed_fn``) on every fine sampler, and the coarse
model's memory switches ``remat`` / ``remat_edges``.

JAX runs at matmul precision "highest", the port with TF32 off, both on the
CPU and on the same weights and numpy inputs. bf16 results are held to bars
set by bf16 rounding (8 bits of mantissa: ~4e-3 per rounding); a lattice's
argmax may then differ from JAX's where JAX's own best two candidates are
within ``BF16_MARGIN``, and the molecule is not compared past it.
"""

import pickle
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hierdiff_torch import runtime as port_runtime
from hierdiff_torch.config import load_coarse_config, load_config
from hierdiff_torch.data.denoise import array_dict_allowed_fn
from hierdiff_torch.models.diffusion import CoarseDiffusion as PortDiffusion
from hierdiff_torch.models.edge_denoise import EdgeDenoise as PortDenoise
from hierdiff_torch.ops import egnn_kernels as ek
from hierdiff_torch.ops import gcl as port_gcl
from hierdiff_torch.ops.masked import combine_noise
from hierdiff_torch.sampling import ar as port_ar
from hierdiff_torch.sampling import cli as port_cli
from hierdiff_torch.sampling import lattice as port_lattice
from hierdiff_torch.sampling import pipeline as port_pipeline
from hierdiff_torch.tools.lattice_check import compare_lattices
from hierdiff_torch.utils import weights as port_weights
from hierdiff_tpu.config import load_config as jax_load_config
from hierdiff_tpu.data.denoise import make_denoise_batch
from hierdiff_tpu.data.synthetic import SyntheticTreeGenerator
from hierdiff_tpu.models.diffusion import CoarseDiffusion
from hierdiff_tpu.models.edge_denoise import EdgeDenoise
from hierdiff_tpu.ops import gcl as jax_gcl
from hierdiff_tpu.ops.masked import remove_mean_with_mask
from hierdiff_tpu.sampling import ar as jax_ar
from hierdiff_tpu.sampling import lattice as jax_lattice

H, FULL, FOCAL = 32, 2, 1
NB = 8                                   # one pad bucket: one JAX compile per program
SIZES = (5, 8, 6, 7, 4, 8)
BF16 = "bfloat16"
# bf16 layer outputs: max error over the largest value (~5 bf16 roundings)
BF16_REL = 2e-2
# a bf16 lattice's choice may differ from JAX's where JAX's best two
# candidates (focal probabilities, attach logits) are closer than this
BF16_MARGIN = 5e-2
F32_MARGIN = 1e-4
LOGP_TOL = 1e-5
NEG = -1e8                               # log-probabilities below: outside the support


@pytest.fixture(autouse=True)
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _rel(out, ref) -> float:
    out = np.asarray(out.float() if isinstance(out, torch.Tensor) else out, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / (np.abs(ref).max() + 1e-12))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _margin(scores: np.ndarray, valid: np.ndarray) -> np.ndarray:
    s = np.where(valid, scores, -np.inf)
    top2 = -np.sort(-s, axis=1)[:, :2]
    with np.errstate(invalid="ignore"):
        return np.where(valid.sum(1) >= 2, top2[:, 0] - top2[:, 1], np.inf)


# --- shared fixture: one denoise model in both frameworks ---------------------


@pytest.fixture(scope="module")
def fine():
    gen = SyntheticTreeGenerator(seed=3)
    trees = [gen.sample_tree(n) for n in SIZES]
    blur = [{"x": t.pos.astype(np.float32),
             "h": port_pipeline.round_int_features(t.feats.astype(np.float32), 5)}
            for t in trees]
    model = EdgeDenoise(hidden_nf=H, n_layers_full=FULL, n_layers_focal=FOCAL)
    batch = make_denoise_batch(gen.sample_trees(4, n=6), random.Random(0), max_n=NB)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), {k: jnp.asarray(v)
                                                          for k, v in batch.items()})
    state = port_weights.denoise_state_dict_from_flax(_np_tree(params))
    port = PortDenoise(hidden_nf=H, n_layers_full=FULL, n_layers_focal=FOCAL)
    port.load_state_dict(state, strict=True)
    port16 = PortDenoise(hidden_nf=H, n_layers_full=FULL, n_layers_focal=FOCAL,
                         compute_dtype=BF16)
    port16.load_state_dict(state, strict=True)
    padded = port_lattice.pad_blur(blur, list(range(len(blur))), len(blur), NB)
    return {"model": model, "params": params, "port": port.eval(), "port16": port16.eval(),
            "blur": blur, "batch": batch, "padded": padded}


# --- 1. fine-stage bf16 --------------------------------------------------------


def test_dense_egcl_bf16_matches_jax():
    """One dense DenseEGCL pass in bf16 with attention and the edge update:
    h, x and e within BF16_REL of JAX's bf16 layer; e stays bf16, h and x
    f32 in both."""
    rng = np.random.default_rng(4)
    b, n, e = 3, 7, H
    h = rng.standard_normal((b, n, H)).astype(np.float32)
    x = rng.standard_normal((b, n, 3)).astype(np.float32)
    mask = (rng.random((b, n, n, 1)) < 0.6).astype(np.float32)
    mask[1, :, 3] = 0.0
    ea = rng.standard_normal((b, n, n, e)).astype(np.float32)
    nm = np.ones((b, n, 1), np.float32)
    nm[2, 5:] = 0.0
    model = jax_gcl.DenseEGCL(hidden_nf=H, edges_in_d=e, attention=True, edge_update=True,
                              compute_dtype=BF16)
    args = tuple(map(jnp.asarray, (h, x, mask, ea, nm)))
    with jax.default_matmul_precision("highest"):
        params = jax.jit(model.init)(jax.random.PRNGKey(1), *args)
        ref = jax.jit(model.apply)(params, *args)
    state = {}
    port_weights._fine_egcl(state, "g", _np_tree(params)["params"])
    port = port_gcl.DenseEGCL(H, edges_in_d=e, attention=True, edge_update=True,
                              compute_dtype=BF16)
    port.load_state_dict({k[2:]: _t(np.array(v, np.float32)) for k, v in state.items()},
                         strict=True)
    assert all(p.dtype == torch.float32 for p in port.parameters())
    with torch.no_grad():
        out = port(*(_t(a) for a in (h, x, mask, ea, nm)))
    assert [o.dtype for o in out] == [torch.float32, torch.float32, torch.bfloat16]
    assert [r.dtype for r in ref] == [jnp.float32, jnp.float32, jnp.bfloat16]
    for o, r in zip(out, ref):
        assert _rel(o, r) < BF16_REL
    # without a compute dtype the layer keeps its inputs' type (the card
    # against CPU checks run an f64 copy)
    port.compute_dtype = None
    with torch.no_grad():
        out64 = port.double()(*(_t(a).double() for a in (h, x, mask, ea, nm)))
    assert all(o.dtype == torch.float64 for o in out64)


def test_edge_denoise_bf16_loss_matches_jax(fine):
    """The training loss in bf16: within 1e-2 of JAX's bf16 loss, within
    0.05 of the port's f32 loss (the JAX package's own bar between its bf16
    and f32 losses, tests/test_fine_stage.py:539); only the full and focal
    layers run bf16, and a bf16 clone of the f32 model is the bf16 model."""
    model, params = fine["model"], fine["params"]
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(model.clone(compute_dtype=BF16).apply)(
            params, {k: jnp.asarray(v) for k, v in fine["batch"].items()})
    batch = {k: _t(v) for k, v in fine["batch"].items()}
    port16, port = fine["port16"], fine["port"]
    with torch.no_grad():
        out16, out32 = port16(batch), port(batch)
        cloned = port.clone(compute_dtype=BF16)(batch)
    assert [getattr(port16, f"gcl_full_{i}").compute_dtype for i in range(FULL)] == [BF16] * FULL
    assert port16.gcl_focal_0.compute_dtype == BF16
    assert port16.gcl_edge.compute_dtype is None and port16.gcl_denoise.compute_dtype is None
    assert port.gcl_full_0.compute_dtype is None        # the clone left the original as it was
    for k in out16:
        assert torch.equal(cloned[k], out16[k]), k
    total16 = out16["total_loss"].item()
    assert total16 == pytest.approx(float(ref["total_loss"]), rel=1e-2)
    assert total16 == pytest.approx(out32["total_loss"].item(), rel=0.05)


def _teacher_forced(model, params, lattices, padded):
    """JAX's ``_expand_core`` on every (molecule, step) state of JAX's own
    lattice trajectories, with the margins of its focal and attach argmaxes
    (B, NB) each."""
    feats, pos, nmask = padded
    rows = {"feats": [], "pos": [], "nmask": [], "adj": [], "disc": []}
    where = []
    for i, lat in lattices.items():
        adj, disc = np.zeros((NB, NB), np.float32), np.zeros(NB, np.int32)
        for t in range(len(lat.focal)):
            for k, v in (("feats", feats[i]), ("pos", pos[i]), ("nmask", nmask[i]),
                         ("adj", adj.copy()), ("disc", disc.copy())):
                rows[k].append(v)
            where.append((i, t))
            if lat.attach[t]:
                adj[lat.focal[t], lat.target[t]] = adj[lat.target[t], lat.focal[t]] = 1.0
            disc[lat.target[t]] = 1
    rows = {k: np.stack(v) for k, v in rows.items()}

    def heads(mdl, name):
        return name == "__call__" and mdl.name in ("focal_head", "edge_head")

    with jax.default_matmul_precision("highest"):
        _, inter = jax.jit(lambda p, *a: model.apply(
            p, *a, method=EdgeDenoise._expand_core, capture_intermediates=heads,
            mutable=["intermediates"]))(params, *map(jnp.asarray, (
                rows["feats"], rows["disc"], rows["disc"], rows["pos"], rows["adj"],
                rows["nmask"])))
    inter = _np_tree(inter["intermediates"])
    valid = rows["nmask"][..., 0] > 0
    fm = _margin(inter["focal_head"]["__call__"][0][..., 0], valid & (rows["disc"] > 0))
    tm = _margin(inter["edge_head"]["__call__"][0][..., 0], valid & (rows["disc"] == 0))
    out = {"focal_margin": np.full((len(lattices), NB), np.inf),
           "target_margin": np.full((len(lattices), NB), np.inf)}
    for r, (i, t) in enumerate(where):
        out["focal_margin"][i, t], out["target_margin"][i, t] = fm[r], tm[r]
    return out


def _lattice_arrays(lattices, b: int) -> dict:
    out = {"focal": np.zeros((b, NB), np.int64), "target": np.zeros((b, NB), np.int64),
           "did_attach": np.zeros((b, NB), bool), "top_logp": np.zeros((b, NB, 16), np.float32),
           "top_wid": np.zeros((b, NB, 16), np.int64)}
    for i, lat in lattices.items():
        n = len(lat.focal)
        out["focal"][i, :n], out["target"][i, :n] = lat.focal, lat.target
        out["did_attach"][i, :n], out["top_logp"][i, :n] = lat.attach, lat.top_logp
        out["top_wid"][i, :n] = lat.top_wid
    return out


def test_ar_lattice_bf16_matches_jax(fine):
    """The bf16 lattice against JAX's bf16 lattice: focal and target equal,
    a molecule excused past a step only where JAX's own margin of that
    choice is below BF16_MARGIN, at most half of them; top_logp within 2e-2
    of the step's largest |logp| where the choices agree. The bf16 lattice's
    top-1 types agree with the f32 lattice's at 0.8 of the steps at least
    (the JAX package's bar, tests/test_fine_stage.py:553)."""
    model16 = fine["model"].clone(compute_dtype=BF16)
    with jax.default_matmul_precision("highest"):
        sampler = jax_lattice.LatticeSampler(model16, fine["params"], native_search=False,
                                             buckets=(NB,))
        lattices = sampler.compute_lattices(fine["blur"])
    ref = _lattice_arrays(lattices, len(SIZES))
    ref.update(_teacher_forced(model16, fine["params"], lattices, fine["padded"]))
    arrays = [_t(a) for a in fine["padded"]]
    got16 = {k: v.numpy() for k, v in fine["port16"].ar_lattice(*arrays).items()}
    got32 = {k: v.numpy() for k, v in fine["port"].ar_lattice(*arrays).items()}
    report = compare_lattices(ref, got16, SIZES, margin=BF16_MARGIN, logp_tol=2e-2,
                              relative=True)
    print(f"bf16 lattice against JAX's: {report['steps_compared']} steps, cut {report['cut']}, "
          f"largest top_logp error {report['max_logp_rel_err']:.3g} of the step's largest")
    assert report["ok"], report["failures"]
    assert len({c[0] for c in report["cut"]}) <= len(SIZES) // 2
    steps = [(i, t) for i, n in enumerate(SIZES) for t in range(n)]
    agree = np.mean([got16["top_wid"][i, t, 0] == got32["top_wid"][i, t, 0] for i, t in steps])
    assert agree >= 0.8, agree


def test_fine_bf16_flag_builds_a_bf16_model_on_the_cpu(fine, tmp_path):
    """``assemble --fine-bf16 --device cpu`` runs bf16 in the full and focal
    layers only, on the CPU, with f32 parameters; the default stays f32."""
    src = tmp_path / "coarse.pkl"
    with open(src, "wb") as f:
        pickle.dump([fine["blur"][:2]], f)
    tiny = ["denoise.hidden_nf=16", "denoise.n_layers_full=1", "denoise.n_layers_focal=1"]
    runs = {flag: port_cli.main(["assemble", "--coarse-pkl", str(src), "--denoise-init-seed",
                                 "0", "--device", "cpu", "--beam", "2", "--out",
                                 str(tmp_path / "t.pkl"), *flag, *tiny])
            for flag in ((), ("--fine-bf16",))}
    model = runs[("--fine-bf16",)]["sampler"].model
    assert model.gcl_full_0.compute_dtype == BF16 and model.gcl_focal_0.compute_dtype == BF16
    assert model.gcl_edge.compute_dtype is None and model.gcl_denoise.compute_dtype is None
    assert all(p.dtype == torch.float32 and p.device.type == "cpu" for p in model.parameters())
    assert runs[()]["sampler"].model.gcl_full_0.compute_dtype is None
    for run in runs.values():
        assert all(t is not None and t.n == b["h"].shape[0]
                   for t, b in zip(run["trees"], fine["blur"][:2]))
    args = port_cli.build_parser().parse_args(["generate", "--fine-bf16", "--init-seed", "0"])
    assert args.fine_bf16


# --- 2. the per-node vocab restriction -------------------------------------------


def _supports(seed: int, n_types: int = 12):
    """A deterministic allowed_fn: each node's support from its features,
    with repeats (rows shared) and one empty support."""
    rng = np.random.default_rng(seed)
    pool = [np.sort(rng.choice(780, size=rng.integers(1, n_types), replace=False))
            for _ in range(5)] + [np.array([], np.int64)]

    def allowed_fn(feats):
        return [pool[int(abs(f[0]) * 7 + abs(f[5]) * 3) % len(pool)] for f in feats]

    return allowed_fn


def test_build_allowed_arrays_equals_jax(fine):
    feats = [b["h"] for b in fine["blur"]]
    for fn in (_supports(0), _supports(1, 3), array_dict_allowed_fn()):
        got = port_lattice.build_allowed_arrays(feats, fn, 8, NB, 780)
        want = jax_lattice.build_allowed_arrays(feats, fn, 8, NB, 780)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    bucket, table = port_lattice.build_allowed_arrays(feats, _supports(0), 8, NB, 780)
    assert (table[0] == 1).all() and (bucket[len(feats):] == 0).all()
    assert len({r.tobytes() for r in table[1:]}) == len(table) - 1


def _supported(top_wid, top_logp):
    """{wid: logp} of the supported entries of one step."""
    keep = top_logp > NEG
    return dict(zip(top_wid[keep].tolist(), top_logp[keep].tolist()))


# tests/test_beam.py:232: three allowed types, fewer than beam 5
ALLOWED = [5, 17, 101]


def _three_types(feats):
    return [ALLOWED] * feats.shape[0]


@pytest.fixture(scope="module")
def restricted(fine):
    """JAX's sampler under the three-type restriction: its lattices and its
    trees (Python search, beam 5, the reference's tiebreak seed)."""
    with jax.default_matmul_precision("highest"):
        sampler = jax_lattice.LatticeSampler(fine["model"], fine["params"], beam_size=5,
                                             buckets=(NB,), rng=random.Random(2022),
                                             native_search=False, allowed_fn=_three_types)
        lattices = sampler.compute_lattices(fine["blur"])
        trees = sampler.sample(fine["blur"])
    return {"lattices": lattices, "trees": trees}


def test_ar_lattice_with_support_matches_jax(fine, restricted):
    """``ar_lattice`` with an allowed bucket and table against JAX's
    restricted lattices: focal, target and attach equal (the trajectory does
    not depend on the support; the port's own margins excuse a near-tie),
    and at every step the supported entries of the top k, exactly the three
    allowed types, with log-probabilities within 1e-5."""
    feats, pos, nmask = fine["padded"]
    bucket, table = port_lattice.build_allowed_arrays([b["h"] for b in fine["blur"]],
                                                      _three_types, len(SIZES), NB, 780)
    got = {k: v.numpy() for k, v in fine["port"].ar_lattice(
        *map(_t, (feats, pos, nmask, bucket, table))).items()}
    want = _lattice_arrays(restricted["lattices"], len(SIZES))
    compared = 0
    for i, n in enumerate(SIZES):
        for t in range(n):
            same = all(got[k][i, t] == want[k][i, t] for k in ("focal", "target", "did_attach"))
            if not same:
                assert min(got["focal_margin"][i, t], got["target_margin"][i, t]) < F32_MARGIN
                break
            g = _supported(got["top_wid"][i, t], got["top_logp"][i, t])
            w = _supported(want["top_wid"][i, t], want["top_logp"][i, t])
            assert set(g) == set(w) == set(ALLOWED)
            assert all(abs(g[k] - w[k]) < LOGP_TOL for k in w)
            compared += 1
    assert compared >= sum(SIZES) // 2


def _trees_equal(a, b) -> bool:
    return len(a) == len(b) and all(
        (x is None) == (y is None) and (x is None or (
            np.array_equal(x.wids, y.wids) and np.array_equal(x.adj, y.adj) and x.logp == y.logp))
        for x, y in zip(a, b))


@pytest.mark.parametrize("native", [False, True])
def test_lattice_allowed_fn_restricts_support(fine, restricted, native):
    """Port of tests/test_beam.py:232 for the Python and the native search:
    three allowed types under beam 5 (the top k then holds entries outside
    the support, at ~NEG_INF, which the search must skip): every tree typed
    from them, and the same trees as the JAX sampler's."""
    if native and not port_runtime.treekit_available():
        pytest.skip("no C++ compiler: treekit is not built")
    got = port_lattice.LatticeSampler(fine["port"], beam_size=5, buckets=(NB,),
                                      rng=random.Random(2022), native_search=native,
                                      allowed_fn=_three_types).sample(fine["blur"])
    for g, w, b in zip(got, restricted["trees"], fine["blur"]):
        assert g is not None and g.n == b["h"].shape[0]
        assert set(g.wids.tolist()) <= set(ALLOWED)
        np.testing.assert_array_equal(g.wids, w.wids)
        np.testing.assert_array_equal(g.adj, w.adj)
        assert abs(g.logp - w.logp) < 1e-5 * max(1.0, abs(w.logp))


def test_full_vocab_allowed_fn_gives_the_unrestricted_trees(fine):
    """An allowed_fn that allows every type gives the trees of no
    restriction, bit for bit, in both searches."""
    every = np.arange(780)
    fn = lambda feats: [every] * feats.shape[0]   # noqa: E731
    for native in (False, True):
        if native and not port_runtime.treekit_available():
            continue
        runs = [port_lattice.LatticeSampler(fine["port"], beam_size=3, buckets=(NB,),
                                            rng=random.Random(7), native_search=native,
                                            allowed_fn=f).sample(fine["blur"])
                for f in (None, fn)]
        assert _trees_equal(*runs), native


def test_ar_sampler_allowed_fn_matches_jax():
    """``ARSampler(allowed_fn=)`` under ``vocab_conditioning`` against JAX's,
    with the size variant's restriction (``array_dict_allowed_fn``): the
    same trees, every type inside its node's support; ``build_fine_sampler``
    and ``GenerationPipeline`` hand the restriction on."""
    gen = SyntheticTreeGenerator(seed=5)
    model = EdgeDenoise(hidden_nf=H, n_layers_full=1, n_layers_focal=1, vocab_conditioning=True)
    batch = {k: jnp.asarray(v) for k, v in
             make_denoise_batch(gen.sample_trees(2, n=6), random.Random(0), max_n=NB).items()}
    params = jax.jit(model.init)(jax.random.PRNGKey(0), batch)
    port = PortDenoise(hidden_nf=H, n_layers_full=1, n_layers_focal=1, vocab_conditioning=True)
    port.load_state_dict(port_weights.denoise_state_dict_from_flax(_np_tree(params)),
                         strict=True)
    port.eval()
    blur = [{"x": t.pos.astype(np.float32),
             "h": port_pipeline.round_int_features(t.feats.astype(np.float32), 5)}
            for t in (gen.sample_tree(n) for n in (5, 7, 6))]
    fn = array_dict_allowed_fn()
    sampler = port_pipeline.build_fine_sampler(port, beam_size=2, buckets=(NB,),
                                               allowed_fn=fn)
    assert isinstance(sampler, port_ar.ARSampler) and sampler.expander.allowed_fn is fn
    sampler.rng = random.Random(5)
    got = sampler.sample(blur)
    with jax.default_matmul_precision("highest"):
        want = jax_ar.ARSampler(model, params, beam_size=2, rng=random.Random(5),
                                buckets=(NB,), allowed_fn=fn).sample(blur)
    for g, w, b in zip(got, want, blur):
        assert g is not None
        support = fn(b["h"])
        assert all(int(wid) in support[node] for node, wid in enumerate(g.wids))
        np.testing.assert_array_equal(g.wids, w.wids)
        np.testing.assert_array_equal(g.adj, w.adj)
        assert abs(g.logp - w.logp) < 1e-5 * max(1.0, abs(w.logp))
    lattice_pipe = port_pipeline.GenerationPipeline(
        PortDiffusion(hidden_nf=16, n_layers=1), PortDenoise(hidden_nf=16), {4: 1.0},
        allowed_fn=fn)
    assert lattice_pipe.sampler.allowed_fn is fn


# --- 3. remat / remat_edges ---------------------------------------------------

T, CH = 8, 32
REMAT = {"off": (False, False), "remat_edges": (False, True), "remat": (True, False),
         "both": (True, True)}


def _coarse_batch(seed=0, counts=(7, 4, 5, 9)):
    rng = np.random.default_rng(seed)
    n = max(counts)
    nm = (np.arange(n)[None, :] < np.asarray(counts)[:, None]).astype(np.float32)[..., None]
    em = nm * np.transpose(nm, (0, 2, 1)) * (1 - np.eye(n, dtype=np.float32))
    feats = rng.standard_normal((len(counts), n, 8)).astype(np.float32)
    feats[..., :5] = np.round(feats[..., :5] * 2)
    return {"positions": (rng.standard_normal((len(counts), n, 3)) * 2).astype(np.float32) * nm,
            "node_feature": feats * nm, "atom_mask": nm, "edge_mask": em}


def _coarse_draws(batch, seed=1):
    rng = np.random.default_rng(seed)
    b, n = batch["atom_mask"].shape[:2]
    t_int = rng.integers(0, T + 1, size=(b, 1))
    t_int[0] = 0
    nm = torch.from_numpy(batch["atom_mask"])
    eps = [combine_noise(torch.from_numpy(rng.standard_normal((b, n, 11)).astype(np.float32)),
                         nm, 3).numpy() for _ in range(2)]
    return t_int, eps[0], eps[1]


@pytest.fixture(scope="module")
def coarse():
    """A JAX coarse model with block remat and edge remat on (polynomial_2:
    the learned gamma's 2e-4 cross-framework offset would set the bars), its
    params, and the port's loss and gradients in the four settings."""
    kw = dict(in_node_nf=8, timesteps=T, hidden_nf=CH, n_layers=2,
              noise_schedule="polynomial_2", loss_type="vlb")
    batch = _coarse_batch()
    model = CoarseDiffusion(remat=True, remat_edges=True, **kw)
    params = _np_tree(jax.jit(lambda k1, k2: model.init(k1, batch, k2, train=True))(
        jax.random.PRNGKey(0), jax.random.PRNGKey(1)))
    state = port_weights.state_dict_from_flax(params)
    draws = _coarse_draws(batch)
    runs = {}
    for name, (remat, remat_edges) in REMAT.items():
        port = PortDiffusion(remat=remat, remat_edges=remat_edges, **kw)
        port.load_state_dict(state, strict=True)    # the remat param tree, strictly
        ek.reset_launch_counts()
        out = port({k: _t(v) for k, v in batch.items()}, None, train=True,
                   t_int=_t(draws[0]), eps=_t(draws[1]), eps0=_t(draws[2]))
        forward_counts = dict(ek.launch_counts)
        out["loss"].backward()
        runs[name] = {"port": port, "loss": out["loss"].detach(), "counts": forward_counts,
                      "all_counts": dict(ek.launch_counts),
                      "grads": {k: p.grad for k, p in port.named_parameters()}}
    return {"model": model, "params": params, "batch": batch, "draws": draws, "runs": runs,
            "kw": kw}


def test_remat_is_the_plain_step(coarse):
    """The four settings give the same loss bit for bit and every gradient
    within 1e-6 of its largest value; a recorded forward takes the plain
    coordinate route 2 times (one per block), and block remat runs each
    block a second time in the backward; without a recorded gradient the
    checkpoints are plain calls."""
    runs = coarse["runs"]
    base = runs["off"]
    for name, run in runs.items():
        assert torch.equal(run["loss"], base["loss"]), name
        for k, g in base["grads"].items():
            scale = max(float(g.abs().max()), 1e-30)
            assert float((run["grads"][k] - g).abs().max()) <= 1e-6 * scale, (name, k)
        assert run["counts"]["coord_update_autograd"] == 2
        recomputes = 2 if REMAT[name][0] else 0
        assert run["all_counts"]["coord_update_autograd"] == 2 + recomputes, name
        assert run["all_counts"]["fused_gcl"] == 0     # the CPU runs the plain versions
    assert runs["both"]["port"].dynamics.egnn.remat
    assert runs["both"]["port"].dynamics.egnn.e_block_0.gcl_0.remat_edges
    batch = {k: _t(v) for k, v in coarse["batch"].items()}
    t_int, eps, eps0 = (_t(a) for a in coarse["draws"])
    with torch.no_grad():
        ek.reset_launch_counts()
        plain = runs["off"]["port"](batch, None, train=True, t_int=t_int, eps=eps, eps0=eps0)
        remat = runs["both"]["port"](batch, None, train=True, t_int=t_int, eps=eps, eps0=eps0)
    assert torch.equal(plain["loss"], remat["loss"])
    assert ek.launch_counts["coord_update_autograd"] == 0


def test_remat_gradient_matches_jax_remat(coarse):
    """The port with remat and remat_edges against the JAX model with both:
    the gradient of the training loss name for name, at the bar of the
    coarse parity test (tests/test_torch_train.py, polynomial_2: 1e-4)."""
    model, params, batch = coarse["model"], coarse["params"], coarse["batch"]
    t_int, eps, eps0 = coarse["draws"]

    def fn(module, b):
        nm = b["atom_mask"]
        x = remove_mean_with_mask(b["positions"], nm)
        x, h, delta_log_px = module.normalize(x, b["node_feature"], nm)
        loss, _ = module.compute_loss(jax.random.PRNGKey(0), x, h, nm, b["edge_mask"], None,
                                      t0_always=False, train=True, t_int=jnp.asarray(t_int),
                                      eps=jnp.asarray(eps), eps0=jnp.asarray(eps0))
        return loss - delta_log_px

    def loss(p):
        with jax.default_matmul_precision("highest"):
            return jnp.mean(model.apply(p, batch, method=fn))

    ref = port_weights.flax_to_numpy_state(_np_tree(jax.jit(jax.grad(loss))(params)))
    grads = coarse["runs"]["both"]["grads"]
    assert sorted(grads) == sorted(ref)
    errs = {k: _rel(grads[k], ref[k]) for k in ref}
    glob = float(np.sqrt(sum(((grads[k].numpy() - ref[k]) ** 2).sum() for k in ref)
                         / sum((ref[k] ** 2).sum() for k in ref)))
    assert glob < 1e-5, glob
    assert max(errs.values()) < 1e-4, errs


def test_remat_keys_load_like_jax(tmp_path):
    """``remat`` and ``remat_edges`` load from YAML and overrides as in the
    JAX package, reach the model through ``build_coarse_from_cfg`` (the
    builder of train.cli coarse), ``use_pallas`` / ``pallas_vjp`` are read
    and ignored, and any other unknown key raises."""
    path = tmp_path / "c.yaml"
    path.write_text("stage: coarse\ncoarse:\n  hidden_nf: 16\n  n_layers: 1\n  remat: true\n"
                    "  remat_edges: true\n  use_pallas: true\n  pallas_vjp: true\n")
    ref = jax_load_config(str(path))
    for cfg in (load_coarse_config(str(path)), load_config(str(path)).coarse):
        assert cfg.remat and cfg.remat_edges
        for name in vars(cfg):
            assert getattr(cfg, name) == getattr(ref.coarse, name), name
    over = ["coarse.remat=true", "coarse.remat_edges=false", "coarse.use_pallas=true"]
    port, want = load_config(None, over).coarse, jax_load_config(None, over).coarse
    assert (port.remat, port.remat_edges) == (want.remat, want.remat_edges) == (True, False)
    model = port_cli.build_coarse_from_cfg(load_coarse_config(str(path)), device="cpu")
    egnn = model.dynamics.egnn
    assert egnn.remat and egnn.e_block_0.gcl_0.remat_edges and egnn.e_block_0.gcl_equiv.remat_edges
    bad = tmp_path / "bad.yaml"
    bad.write_text("coarse:\n  rematt: true\n")
    with pytest.raises(KeyError, match="rematt"):
        load_coarse_config(str(bad))
    with pytest.raises(KeyError, match="rematt"):
        load_config(str(bad))
    plain = load_coarse_config(None)
    assert not plain.remat and not plain.remat_edges
