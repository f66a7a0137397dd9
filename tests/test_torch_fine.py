"""PyTorch port of the fine stage (graph ops, DenseEGCL, EdgeDenoise's
lattice, the beam search, the lattice sampler, the pipeline and the
assemble / generate CLIs) against the JAX package on the same weights.

JAX runs at matmul precision "highest", the port with TF32 off. The
lattice's focal and attach choices are argmaxes: where the two frameworks
pick differently, ``tools/lattice_check.compare_lattices`` allows it only at
a near-tie of the JAX scores (margin below 1e-4) and stops comparing that
molecule; the tests print how many were cut.
"""

import pickle
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hierdiff_torch.data.collate import SAMPLING_BUCKETS
from hierdiff_torch.models.edge_denoise import EdgeDenoise as PortDenoise
from hierdiff_torch.ops import gcl as port_gcl
from hierdiff_torch.ops import graph as port_graph
from hierdiff_torch.sampling import beam as port_beam
from hierdiff_torch.sampling import cli as port_cli
from hierdiff_torch.sampling import lattice as port_lattice
from hierdiff_torch.sampling import pipeline as port_pipeline
from hierdiff_torch.tools.lattice_check import compare_lattices
from hierdiff_torch.utils import weights as port_weights
from hierdiff_tpu.data.denoise import make_denoise_batch
from hierdiff_tpu.data.synthetic import SyntheticTreeGenerator
from hierdiff_tpu.models.edge_denoise import EdgeDenoise
from hierdiff_tpu.ops import gcl as jax_gcl
from hierdiff_tpu.ops import graph as jax_graph
from hierdiff_tpu.sampling import beam as jax_beam
from hierdiff_tpu.sampling import lattice as jax_lattice
from hierdiff_tpu.sampling import pipeline as jax_pipeline
from hierdiff_tpu.utils.torch_import import export_denoise

H, FULL, FOCAL = 32, 2, 1
NB = 16                                  # one pad bucket: one JAX compile
SIZES = (5, 9, 12, 16, 7, 14)
# float32 network outputs, summed in another order: ~1e-6 of the largest value
F32_REL = 1e-5
MARGIN = 1e-4
LOGP_TOL = 1e-5

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / (np.abs(ref).max() + 1e-12))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _is_spanning_tree(adj: np.ndarray) -> bool:
    n = adj.shape[0]
    a = adj.copy()
    np.fill_diagonal(a, 0)
    if a.sum() != 2 * (n - 1) or not np.array_equal(a, a.T):
        return False
    seen, frontier = {0}, [0]
    while frontier:
        cur = frontier.pop()
        for j in np.flatnonzero(a[cur]):
            if int(j) not in seen:
                seen.add(int(j))
                frontier.append(int(j))
    return len(seen) == n


# --- shared fixture: one JAX model, its lattices and their trajectories -----


@pytest.fixture(scope="module")
def fine():
    gen = SyntheticTreeGenerator(seed=3)
    trees = [gen.sample_tree(n) for n in SIZES]
    blur = [{"x": t.pos.astype(np.float32),
             "h": port_pipeline.round_int_features(t.feats.astype(np.float32), 5)}
            for t in trees]
    model = EdgeDenoise(hidden_nf=H, n_layers_full=FULL, n_layers_focal=FOCAL)
    batch = {k: jnp.asarray(v) for k, v in
             make_denoise_batch(gen.sample_trees(2, n=6), random.Random(0), max_n=8).items()}
    params = jax.jit(model.init)(jax.random.PRNGKey(0), batch)
    port = PortDenoise(hidden_nf=H, n_layers_full=FULL, n_layers_focal=FOCAL)
    port.load_state_dict(port_weights.denoise_state_dict_from_flax(_np_tree(params)), strict=True)
    port.eval()

    with jax.default_matmul_precision("highest"):
        sampler = jax_lattice.LatticeSampler(model, params, native_search=False, buckets=(NB,))
        lattices = sampler.compute_lattices(blur)

    # the JAX trajectory's states, one row per (molecule, step), teacher-forced
    # through both _expand_cores; the JAX focal scores and edge logits come
    # back as intermediates of the same call
    feats, pos, nmask = port_lattice.pad_blur(blur, list(range(len(blur))), len(blur), NB)
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
    args = (rows["feats"], rows["disc"], rows["disc"], rows["pos"], rows["adj"], rows["nmask"])

    def heads(mdl, name):
        return name == "__call__" and mdl.name in ("focal_head", "edge_head")

    with jax.default_matmul_precision("highest"):
        (j_out, _, _), inter = jax.jit(lambda p, *a: model.apply(
            p, *a, method=EdgeDenoise._expand_core, capture_intermediates=heads,
            mutable=["intermediates"]))(params, *map(jnp.asarray, args))
    j_out = _np_tree(j_out)
    inter = _np_tree(inter["intermediates"])
    scores = inter["focal_head"]["__call__"][0][..., 0]
    e_logits = inter["edge_head"]["__call__"][0][..., 0]
    valid = rows["nmask"][..., 0] > 0
    j_out["focal_margin"] = _margin(scores, valid & (rows["disc"] > 0))
    j_out["target_margin"] = _margin(e_logits, valid & (rows["disc"] == 0))
    with torch.no_grad():
        p_out, _, _ = port._expand_core(*(_t(a) for a in args))
    p_out = {k: v.numpy() for k, v in p_out.items()}
    return {"blur": blur, "jax_sampler": sampler, "params": params, "port": port,
            "lattices": lattices, "where": where, "jax_step": j_out, "port_step": p_out,
            "padded": (feats, pos, nmask)}


def _margin(scores: np.ndarray, valid: np.ndarray) -> np.ndarray:
    s = np.where(valid, scores, -np.inf)
    top2 = -np.sort(-s, axis=1)[:, :2]
    with np.errstate(invalid="ignore"):             # -inf - -inf where nothing is valid
        return np.where(valid.sum(1) >= 2, top2[:, 0] - top2[:, 1], np.inf)


def _jax_lattice_arrays(fine):
    """The JAX lattices as (B, NB, ...) arrays with the teacher-forced
    margins of each step."""
    b = len(fine["blur"])
    out = {"focal": np.zeros((b, NB), np.int64), "target": np.zeros((b, NB), np.int64),
           "did_attach": np.zeros((b, NB), bool), "top_logp": np.zeros((b, NB, 16), np.float32),
           "top_wid": np.zeros((b, NB, 16), np.int64),
           "focal_margin": np.full((b, NB), np.inf), "target_margin": np.full((b, NB), np.inf)}
    for i, lat in fine["lattices"].items():
        n = len(lat.focal)
        out["focal"][i, :n], out["target"][i, :n] = lat.focal, lat.target
        out["did_attach"][i, :n], out["top_logp"][i, :n] = lat.attach, lat.top_logp
        out["top_wid"][i, :n] = lat.top_wid
    for r, (i, t) in enumerate(fine["where"]):
        out["focal_margin"][i, t] = fine["jax_step"]["focal_margin"][r]
        out["target_margin"][i, t] = fine["jax_step"]["target_margin"][r]
    return out


# --- 1. graph ops ------------------------------------------------------------


@pytest.mark.parametrize("start", ["node", "none"])
def test_bfs_parents_and_layers_equal_jax(start):
    gen = SyntheticTreeGenerator(seed=1)
    trees = [gen.sample_tree(n) for n in (3, 7, 12, 16, 1)]
    adj = np.zeros((len(trees), NB, NB), np.float32)
    onehot = np.zeros((len(trees), NB), np.float32)
    rng = np.random.default_rng(0)
    for i, t in enumerate(trees):
        n = t.adj.shape[0]
        adj[i, :n, :n] = t.adj
        if start == "node":
            onehot[i, rng.integers(n)] = 1.0
    j_depth = np.asarray(jax_graph.bfs_depths(jnp.asarray(adj), jnp.asarray(onehot)))
    p_depth = port_graph.bfs_depths(_t(adj), _t(onehot))
    np.testing.assert_array_equal(p_depth.numpy(), j_depth)
    if start == "none":
        assert (j_depth == -1).all()
    np.testing.assert_array_equal(
        port_gcl.compute_parents(_t(adj), p_depth).numpy(),
        np.asarray(jax_gcl.compute_parents(jnp.asarray(adj), jnp.asarray(j_depth))))
    for d in range(1, 5):
        np.testing.assert_array_equal(
            port_graph.depth_layer_mask(_t(adj), p_depth, d).numpy(),
            np.asarray(jax_graph.depth_layer_mask(jnp.asarray(adj), jnp.asarray(j_depth),
                                                  jnp.int32(d))))
    np.testing.assert_array_equal(port_graph.circle_mask(2, 5).numpy(),
                                  np.asarray(jax_graph.circle_mask(2, 5)))


# --- 2. DenseEGCL ------------------------------------------------------------


def _gcl_pair(hd, e, **kw):
    model = jax_gcl.DenseEGCL(hidden_nf=hd, edges_in_d=e, **kw)
    port = port_gcl.DenseEGCL(hd, edges_in_d=e, **kw)
    return model, port


def _load_gcl(port, params):
    state = {}
    port_weights._fine_egcl(state, "g", _np_tree(params)["params"])
    port.load_state_dict({k[2:]: torch.from_numpy(np.array(v, np.float32))
                          for k, v in state.items()}, strict=True)
    return port


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("edge_update", [True, False])
@pytest.mark.parametrize("attention", [True, False])
def test_dense_egcl_matches_jax(attention, edge_update, gated):
    rng = np.random.default_rng(4)
    b, n, hd, e = 3, 7, 16, 8
    h = rng.standard_normal((b, n, hd)).astype(np.float32)
    x = rng.standard_normal((b, n, 3)).astype(np.float32)
    mask = (rng.random((b, n, n, 1)) < 0.5).astype(np.float32)
    mask[1, :, 3] = 0.0                                 # a node with no incoming edge
    ea = rng.standard_normal((b, n, n, e)).astype(np.float32)
    nm = np.ones((b, n, 1), np.float32)
    nm[2, 5:] = 0.0
    model, port = _gcl_pair(hd, e, attention=attention, edge_update=edge_update, gated=gated)
    args = tuple(map(jnp.asarray, (h, x, mask, ea, nm)))
    with jax.default_matmul_precision("highest"):
        params = model.init(jax.random.PRNGKey(1), *args)
        ref = model.apply(params, *args)
    with torch.no_grad():
        out = _load_gcl(port, params)(*(_t(a) for a in (h, x, mask, ea, nm)))
    assert len(out) == len(ref) == (3 if edge_update else 2)
    for o, r in zip(out, ref):
        assert _rel(o.numpy(), r) < F32_REL


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
def test_tree_pass_matches_jax(reverse, gated):
    gen = SyntheticTreeGenerator(seed=2)
    trees = [gen.sample_tree(n) for n in (6, 9, 4)]
    b, n, hd = len(trees), 10, 16
    adj = np.zeros((b, n, n), np.float32)
    start = np.zeros((b, n), np.float32)
    for i, t in enumerate(trees):
        adj[i, :t.adj.shape[0], :t.adj.shape[0]] = t.adj
        start[i, i] = 1.0
    depth = jax_graph.bfs_depths(jnp.asarray(adj), jnp.asarray(start))
    parent = np.asarray(jax_gcl.compute_parents(jnp.asarray(adj), depth))
    active = np.asarray(depth) == 2
    rng = np.random.default_rng(5)
    h = rng.standard_normal((b, n, hd)).astype(np.float32)
    x = rng.standard_normal((b, n, 3)).astype(np.float32)
    nm = (adj.sum(-1) > 0).astype(np.float32)[..., None]
    model, port = _gcl_pair(hd, 1, gated=gated)
    with jax.default_matmul_precision("highest"):
        params = model.init(jax.random.PRNGKey(2), jnp.asarray(h), jnp.asarray(x),
                            jnp.asarray(adj), edge_attr=jnp.zeros((b, n, n, 1)))
        ref = model.apply(params, *map(jnp.asarray, (h, x, parent, active, nm)),
                          reverse=reverse, method=jax_gcl.DenseEGCL.tree_pass)
    with torch.no_grad():
        out = _load_gcl(port, params).tree_pass(
            _t(h), _t(x), _t(parent.astype(np.int64)), _t(active), _t(nm), reverse=reverse)
    assert active.any()
    for o, r in zip(out, ref):
        assert _rel(o.numpy(), r) < F32_REL


# --- 3. weights --------------------------------------------------------------


def test_denoise_mapping_equals_export_denoise(fine):
    params = _np_tree(fine["params"])
    ours = port_weights.denoise_flax_to_numpy_state(params)
    ref = export_denoise(params["params"])
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    port = PortDenoise(hidden_nf=H, n_layers_full=FULL, n_layers_focal=FOCAL)
    port.load_state_dict({k: torch.from_numpy(np.array(v, np.float32)) for k, v in ref.items()},
                         strict=True)
    port_weights.init_weights(port, torch.Generator().manual_seed(0))
    assert all(torch.isfinite(p).all() for p in port.parameters())


def test_denoise_config_loads_like_jax():
    from pathlib import Path

    from hierdiff_torch.config import EdgeDenoiseConfig, load_config
    from hierdiff_tpu.config import load_config as jax_load_config

    path = str(Path(__file__).resolve().parent.parent / "configs" / "denoise_geom.yaml")
    port, ref = load_config(path), jax_load_config(path)
    assert vars(port.denoise) == vars(ref.denoise) == vars(EdgeDenoiseConfig())
    assert port.stage == ref.stage == "denoise" and port.train.batch_size == ref.train.batch_size
    over = ["denoise.hidden_nf=32", "denoise.vocab_conditioning=true"]
    assert vars(load_config(None, over).denoise) == vars(jax_load_config(None, over).denoise)


# --- 4. one expansion step, teacher-forced -----------------------------------


def test_expand_core_teacher_forced_matches_jax(fine):
    ref, out = fine["jax_step"], fine["port_step"]
    for k in ("focal", "target", "did_attach"):
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    assert np.abs(out["top_logp"] - ref["top_logp"]).max() < LOGP_TOL
    r = ref["top_logp"]
    apart = np.ones(r.shape, bool)
    apart[:, 1:] &= -np.diff(r, axis=1) > LOGP_TOL
    apart[:, :-1] &= -np.diff(r, axis=1) > LOGP_TOL
    np.testing.assert_array_equal(out["top_wid"][apart], ref["top_wid"][apart])
    for k in ("focal_margin", "target_margin"):   # the port's margins are JAX's
        finite = np.isfinite(ref[k])
        np.testing.assert_array_equal(np.isfinite(out[k]), finite)
        assert np.abs(out[k][finite] - ref[k][finite]).max() < LOGP_TOL


def test_ar_step_reads_discovery_from_the_root_marker(fine):
    """ar_step takes the beam's adjacency (a (0, 0) self-loop marks the root
    before the first edge) and equals the teacher-forced JAX step."""
    feats, pos, nmask = fine["padded"]
    rows = [r for r, (i, t) in enumerate(fine["where"]) if t <= 2]
    idx = [fine["where"][r][0] for r in rows]
    adj = np.zeros((len(rows), NB, NB), np.float32)
    for k, r in enumerate(rows):
        i, t = fine["where"][r]
        lat = fine["lattices"][i]
        if t >= 1:
            adj[k, 0, 0] = 1.0
        if t == 2 and lat.attach[1]:
            adj[k, 0, 0] = 0.0
            adj[k, lat.focal[1], lat.target[1]] = adj[k, lat.target[1], lat.focal[1]] = 1.0
    out = fine["port"].ar_step(_t(feats[idx]), None, _t(np.zeros((len(rows), NB), np.int32)),
                               _t(pos[idx]), _t(adj), _t(nmask[idx]))
    for k in ("focal", "target", "did_attach", "top_wid"):
        np.testing.assert_array_equal(out[k].numpy(), fine["jax_step"][k][rows], err_msg=k)
    assert np.abs(out["top_logp"].numpy() - fine["jax_step"]["top_logp"][rows]).max() < LOGP_TOL


# --- 5. the whole lattice ----------------------------------------------------


def test_ar_lattice_matches_jax_under_the_margin_rule(fine):
    port = fine["port"].clone(dynamic_depth=True)
    out = port.ar_lattice(*(_t(a) for a in fine["padded"]))
    report = compare_lattices(_jax_lattice_arrays(fine), {k: v.numpy() for k, v in out.items()},
                              SIZES, margin=MARGIN, logp_tol=LOGP_TOL)
    print(f"ar_lattice against JAX: {report['steps_compared']} steps compared, "
          f"{len(report['cut'])} of {len(SIZES)} molecules cut {report['cut']}, "
          f"max |top_logp| error {report['max_logp_err']:.3e}")
    assert report["ok"], report["failures"]
    assert report["steps_compared"] >= sum(SIZES) // 2


# --- 6. dynamic depth and the pad bucket --------------------------------------


def test_dynamic_depth_is_bitwise_static_and_buckets_agree(fine):
    port = fine["port"]
    args = [_t(a) for a in fine["padded"]]
    static = port.ar_lattice(*args)
    dynamic = port.clone(dynamic_depth=True).ar_lattice(*args)
    for k in static:
        assert torch.equal(static[k], dynamic[k]), k

    small = [i for i, n in enumerate(SIZES) if n <= 8]
    b8 = port_lattice.pad_blur(fine["blur"], small, len(small), 8)
    in8 = {k: v.numpy() for k, v in port.ar_lattice(*(_t(a) for a in b8)).items()}
    in16 = {k: v[small].numpy() for k, v in dynamic.items()}
    report = compare_lattices(in16, in8, [SIZES[i] for i in small], margin=MARGIN,
                              logp_tol=LOGP_TOL)
    assert report["ok"] and not report["cut"], report


# --- 7. the search -----------------------------------------------------------


def test_beam_search_over_jax_lattices_is_jax_search(fine):
    blur, lattices = fine["blur"], fine["lattices"]
    ref = jax_beam.PQBeamSearch(jax_lattice.LatticeExpander(lattices), beam_size=3).run(
        jax_lattice.LatticeSampler._init_states(blur, range(len(blur))))
    got = port_beam.PQBeamSearch(port_lattice.LatticeExpander(lattices), beam_size=3).run(
        port_lattice.LatticeSampler._init_states(blur, range(len(blur))))
    for r, g in zip(ref, got):
        assert r is not None and g is not None
        np.testing.assert_array_equal(g.wids, r.wids)
        np.testing.assert_array_equal(g.adj, r.adj)
        assert g.logp == r.logp and g.last_edge == r.last_edge


# --- 8. the sampler ----------------------------------------------------------


def test_lattice_sampler_matches_jax_sampler(fine):
    blur = fine["blur"]
    with jax.default_matmul_precision("highest"):
        ref = fine["jax_sampler"].sample(blur)
    got = port_lattice.LatticeSampler(fine["port"], buckets=(NB,)).sample(blur)
    report = compare_lattices(_jax_lattice_arrays(fine), {
        k: v.numpy() for k, v in fine["port"].clone(dynamic_depth=True).ar_lattice(
            *(_t(a) for a in fine["padded"])).items()}, SIZES, margin=MARGIN,
        logp_tol=LOGP_TOL)
    cut = {b for b, *_ in report["cut"]}
    for i, (r, g) in enumerate(zip(ref, got)):
        n = SIZES[i]
        assert g is not None and _is_spanning_tree(g.adj), i
        assert ((g.wids >= 0) & (g.wids < 780)).all() and np.isfinite(g.logp)
        if i in cut:
            continue
        np.testing.assert_array_equal(g.wids, r.wids)
        np.testing.assert_array_equal(g.adj, r.adj)
        assert abs(g.logp - r.logp) < LOGP_TOL * n
    print(f"sampler against JAX: {len(cut)} of {len(blur)} molecules cut")


# --- 9. the pipeline ---------------------------------------------------------


def _tiny_coarse(device="cpu"):
    from hierdiff_torch.config import CoarseModelConfig

    cfg = CoarseModelConfig(hidden_nf=16, n_layers=1, timesteps=10)
    model = port_cli.build_coarse_from_cfg(cfg, "float32", device)
    return port_weights.init_weights(model, torch.Generator().manual_seed(0))


def test_chunk_plans_and_counts_equal_jax():
    for n, cap, m in ((952, 512, 4), (37, 512, 4), (3, 8, 4), (200, 64, 64), (64, 64, 64)):
        assert list(port_lattice.pow2_chunks(n, cap, m)) == list(jax_lattice.pow2_chunks(n, cap, m))
    from hierdiff_torch.data.assets import load_histogram

    hist = load_histogram("geom")
    ref = jax_pipeline.GenerationPipeline(None, None, EdgeDenoise(hidden_nf=H), None, hist)
    got = port_pipeline.GenerationPipeline(_tiny_coarse(), PortDenoise(hidden_nf=H), hist)
    assert ref.sample_buckets == got.sample_buckets == SAMPLING_BUCKETS
    counts = got._sample_counts(np.random.default_rng(11), 300)
    np.testing.assert_array_equal(counts, ref._sample_counts(np.random.default_rng(11), 300))
    for bs in (None, 32):
        assert got._plan_chunks(counts, bs) == ref._plan_chunks(counts, bs)


def test_pipeline_run_on_cpu_gives_a_tree_per_molecule():
    denoise = port_weights.init_weights(PortDenoise(hidden_nf=16, n_layers_full=1,
                                                    n_layers_focal=1),
                                        torch.Generator().manual_seed(1)).eval()
    from hierdiff_torch.data.assets import load_histogram

    pipe = port_pipeline.GenerationPipeline(_tiny_coarse(), denoise, load_histogram("geom"),
                                            beam_size=3, max_n_cap=9, sample_steps=4)
    result = pipe.run(5, 6)
    assert set(result.stats) == {"t_coarse", "t_fine"}
    for b, t in zip(result.blur, result.trees):
        assert t is not None and t.n == b["h"].shape[0] <= 9
        assert t.n == 1 or _is_spanning_tree(t.adj)
        assert ((t.wids >= 0) & (t.wids < 780)).all()
        np.testing.assert_array_equal(b["h"][:, :5], np.round(b["h"][:, :5]))
    again = pipe.run(5, 6)
    for a, b in zip(result.trees, again.trees):
        np.testing.assert_array_equal(a.wids, b.wids)


# --- 10. the CLIs ------------------------------------------------------------

TINY = ["denoise.hidden_nf=16", "denoise.n_layers_full=1", "denoise.n_layers_focal=1"]


def test_assemble_cli_writes_the_jax_layout(tmp_path):
    gen = SyntheticTreeGenerator(seed=6)
    blur = [{"x": t.pos.astype(np.float32), "h": t.feats.astype(np.float32)}
            for t in gen.sample_trees(4, n=6)] + [{"x": np.zeros((1, 3), np.float32),
                                                   "h": np.ones((1, 8), np.float32)}]
    src, out = tmp_path / "coarse.pkl", tmp_path / "trees.pkl"
    with open(src, "wb") as f:
        pickle.dump(([blur], ["name"]), f)       # the reference's (results, names) tuple
    run = port_cli.main(["assemble", "--coarse-pkl", str(src), "--denoise-init-seed", "0",
                         "--device", "cpu", "--beam", "3", "--out", str(out), *TINY])
    with open(out, "rb") as f:
        payload = pickle.load(f)
    assert set(payload) == {"trees"} and len(payload["trees"]) == len(blur)
    for d, b in zip(payload["trees"], blur):
        assert set(d) == {"wids", "adj", "pos", "feats", "logp"}
        n = b["h"].shape[0]
        assert d["wids"].shape == (n,) and d["adj"].shape == (n, n)
        assert n == 1 and d["adj"][0, 0] == 1 or _is_spanning_tree(d["adj"])
    assert run["lattice_s"] > 0 and run["search_s"] > 0


def test_generate_cli_writes_the_jax_layout(tmp_path):
    out = tmp_path / "gen.pkl"
    port_cli.main(["generate", "--init-seed", "0", "--denoise-init-seed", "0", "--device", "cpu",
                   "--num", "3", "--sample-steps", "3", "--max-nodes", "7", "--beam", "2",
                   "--out", str(out), "coarse.hidden_nf=16", "coarse.n_layers=1", *TINY])
    with open(out, "rb") as f:
        payload = pickle.load(f)
    assert set(payload) == {"trees", "molecules", "stats"} and payload["molecules"] is None
    assert len(payload["trees"]) == 3 and set(payload["stats"]) == {"t_coarse", "t_fine"}
    for d in payload["trees"]:
        assert set(d) == {"wids", "adj", "pos", "feats", "logp"}
        assert ((d["wids"] >= 0) & (d["wids"] < 780)).all()


def test_vocab_conditioning_and_bf16_are_refused():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_pipeline.build_fine_sampler(PortDenoise(hidden_nf=16, vocab_conditioning=True))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PortDenoise(hidden_nf=16, compute_dtype="bfloat16")
