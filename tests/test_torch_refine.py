"""PyTorch port of the refine stage (the size tables, ``NodeRefine``, the
refine mapping, ``RefineHook``'s fused check and walk, ``finalize``, the
refine-on searches of ``LatticeSampler`` and the refine-on assemble /
generate CLIs) against the JAX package on the same numpy inputs and weights.

JAX runs at matmul precision "highest", the port with TF32 off. The fused
check's node and type choices are a sort and an argmax: where the two
frameworks choose differently, ``tools/refine_check.compare_fused`` allows
it only at a near-tie of the JAX log-probabilities (gap below 1e-4); the
tests print how many slots were cut.
"""

import pickle
import random
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hierdiff_torch.config import RefineConfig, load_config
from hierdiff_torch.data import assets as port_assets
from hierdiff_torch.data import refine as port_refine_data
from hierdiff_torch.models.edge_denoise import EdgeDenoise as PortDenoise
from hierdiff_torch.models.refine import NodeRefine as PortRefine
from hierdiff_torch.sampling import beam as port_beam
from hierdiff_torch.sampling import cli as port_cli
from hierdiff_torch.sampling import lattice as port_lattice
from hierdiff_torch.sampling.refine_hook import RefineHook as PortHook
from hierdiff_torch.tools.refine_check import compare_fused, unpack
from hierdiff_torch.utils import weights as port_weights
from hierdiff_tpu.data.assets import load_vocab_fps, load_vocab_smiles
from hierdiff_tpu.data.denoise import make_denoise_batch
from hierdiff_tpu.data.refine import make_refine_batch, size_support_indices
from hierdiff_tpu.data.synthetic import SyntheticTreeGenerator
from hierdiff_tpu.models.edge_denoise import EdgeDenoise
from hierdiff_tpu.models.refine import NodeRefine
from hierdiff_tpu.sampling import beam as jax_beam
from hierdiff_tpu.sampling import lattice as jax_lattice
from hierdiff_tpu.sampling.refine_hook import RefineHook
from hierdiff_tpu.utils.torch_import import export_refine

H, LAYERS = 32, 1
NB = 8                                   # one pad bucket: one JAX compile per program
CHECK_FRAC = 0.5                         # K = 4 slots at bucket 8; checks from 3 typed nodes
K = max(1, int(NB * CHECK_FRAC))
SIZES = (8, 6, 7, 5, 8, 7)               # the fleet of the fused-check tests
SEARCH_SIZES = (8, 6, 7, 5)              # two groups at cap 2
# the port-only searches: two buckets, fused checks of at most 8 rows
SMALL_BUCKETS, SMALL_ROWS = (5, 8), 4
# float32 sums in another order: ~1e-6 of the largest value
F32_REL = 1e-5
MARGIN = 1e-4

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the checks' many small CPU ops gain little from
    more, and the suite runs beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / (np.abs(ref).max() + 1e-12))


def _is_spanning_tree(adj: np.ndarray) -> bool:
    n = adj.shape[0]
    a = adj * (1.0 - np.eye(n))
    if a.sum() != 2 * (n - 1) or not np.array_equal(a, a.T):
        return False
    seen, frontier = {0}, [0]
    while frontier:
        for j in np.flatnonzero(a[frontier.pop()]):
            if int(j) not in seen:
                seen.add(int(j))
                frontier.append(int(j))
    return len(seen) == n


def _gate(reject_frac: float = 0.2):
    """A pure (state, node) assembly gate without RDKit: rejects a share of
    (fragment, typed-neighbour set) pairs by hash, as bench.py's
    ``_synthetic_gate`` does."""
    def gate(state, i: int) -> bool:
        wid = int(state.wids[i])
        if wid < 0:
            return True
        neis = tuple(sorted(int(state.wids[j]) for j in np.nonzero(state.adj[i])[0]
                            if j != i and int(state.wids[j]) >= 0))
        if not neis:
            return True
        return zlib.crc32(repr((wid, neis)).encode()) / 0xFFFFFFFF >= reject_frac
    return gate


# --- shared fixture: the JAX refine model, its hook and a fleet ---------------


@pytest.fixture(scope="module")
def fx():
    gen = SyntheticTreeGenerator(seed=11)
    model = NodeRefine(hidden_size=H, n_layers=LAYERS)
    batch = {k: jnp.asarray(v) for k, v in
             make_refine_batch(gen.sample_trees(2, n=6), random.Random(1), max_n=8).items()}
    params = jax.jit(model.init)(jax.random.PRNGKey(1), batch)
    port = PortRefine(hidden_size=H, n_layers=LAYERS)
    port.load_state_dict(port_weights.refine_state_dict_from_flax(_np_tree(params)), strict=True)
    port.eval()
    vocab_sizes = np.asarray(port_assets.vocab_mol_sizes())

    # the fleet: some nodes not typed yet, one root marker, one small tree
    rng = np.random.default_rng(3)
    states = []
    for i, n in enumerate(SIZES):
        t = gen.sample_tree(n)
        adj = t.adj.astype(np.float32).copy()
        wids = t.wids.astype(np.int64).copy()
        if i in (1, 4):
            wids[rng.permutation(n)[:3]] = -1
        if i == 3:
            adj[0, 0] = 1.0
        states.append(jax_beam.TreeState(t.feats.astype(np.float32), t.pos.astype(np.float32),
                                         adj, wids))
    # one JAX hook for the module: its programs compile once
    jhook = RefineHook(model, params, vocab_sizes, check_frac=CHECK_FRAC, buckets=(NB,))
    return {"gen": gen, "model": model, "params": params, "port": port,
            "vocab_sizes": vocab_sizes, "states": states, "jhook": jhook}


def _hooks(fx, can_assemble=None, **kw):
    """The module's JAX hook (its gate set, its counters zeroed) and a new
    port hook."""
    jhook = fx["jhook"]
    jhook.can_assemble = can_assemble
    jhook.stats = {k: type(v)(0) for k, v in jhook.stats.items()}
    phook = PortHook(fx["port"], fx["vocab_sizes"], check_frac=CHECK_FRAC, buckets=(NB,),
                     can_assemble=can_assemble, **kw)
    return jhook, phook


def _port_states(states):
    return [port_beam.TreeState(s.feats, s.pos, s.adj.copy(), s.wids.copy(), s.logp, s.index)
            for s in states]


# --- 1. tables, config and weights ----------------------------------------------


def test_size_tables_and_vocab_sizes_equal_jax():
    from hierdiff_tpu.chem.mol_tree import Vocab
    from hierdiff_tpu.data.assets import load_size_dict

    assert port_assets.load_size_dict() == load_size_dict()
    assert list(port_assets.vocab_mol_sizes()) == list(Vocab().mol_sizes)
    assert list(port_assets.vocab_mol_sizes()) == [int(round(load_vocab_fps()[s][3]))
                                                   for s in load_vocab_smiles()]
    for size in range(0, 32):        # 19-23 and 25 take the +-1/+-2 fallback
        assert port_refine_data.size_support_indices(size) == size_support_indices(size)
    assert port_refine_data.MASK_TOKEN == 780


def test_refine_config_loads_like_jax():
    from pathlib import Path

    from hierdiff_tpu.config import load_config as jax_load_config

    path = str(Path(__file__).resolve().parent.parent / "configs" / "refine_geom.yaml")
    port, ref = load_config(path), jax_load_config(path)
    assert vars(port.refine) == vars(ref.refine) == vars(RefineConfig())
    assert port.stage == ref.stage == "refine" and port.train.batch_size == ref.train.batch_size
    over = ["refine.hidden_size=32", "refine.n_layers=1"]
    assert vars(load_config(None, over).refine) == vars(jax_load_config(None, over).refine)


def test_refine_mapping_equals_export_refine(fx):
    params = _np_tree(fx["params"])
    ours = port_weights.refine_flax_to_numpy_state(params)
    ref = export_refine(params["params"])
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    port = PortRefine(hidden_size=H, n_layers=LAYERS)
    assert sorted(port.state_dict()) == sorted(ref)
    port_weights.init_weights(port, torch.Generator().manual_seed(0))
    assert all(torch.isfinite(p).all() for p in port.parameters())
    again = port_weights.init_weights(PortRefine(hidden_size=H, n_layers=LAYERS),
                                      torch.Generator().manual_seed(0))
    for k, v in port.state_dict().items():
        assert torch.equal(v, again.state_dict()[k]), k


# --- 2. NodeRefine ------------------------------------------------------------------


def _refine_batch(fx, seed=4):
    b = make_refine_batch(fx["gen"].sample_trees(5, n=7) + [fx["gen"].sample_tree(3)],
                          random.Random(seed), max_n=NB)
    b["vocab"][0, 2] = -1            # a node not typed yet reads MASK_TOKEN's row
    return [b[k] for k in ("feats", "vocab", "size", "pos", "adj", "node_mask", "predict_idx",
                           "val")]


def test_check_logits_and_logp_match_jax(fx):
    args = _refine_batch(fx)
    with jax.default_matmul_precision("highest"):
        ref, ref_lp = jax.jit(lambda p, *a: (
            fx["model"].apply(p, *a, method=NodeRefine.check_logits),
            fx["model"].apply(p, *a, method=NodeRefine.check_logp)))(
                fx["params"], *map(jnp.asarray, args))
    out = fx["port"].check_logits(*map(_t, args))
    out_lp = fx["port"].check_logp(*map(_t, args))
    assert out.shape == (len(args[0]), 780)
    assert _rel(out.numpy(), ref) < 1e-4
    assert _rel(out_lp.numpy(), ref_lp) < 1e-4
    np.testing.assert_allclose(np.exp(out_lp.numpy().astype(np.float64)).sum(1), 1.0, rtol=1e-5)


def test_dynamic_depth_is_bitwise_static(fx):
    args = list(map(_t, _refine_batch(fx, seed=5)))
    port = fx["port"]
    assert not port.dynamic_depth
    static = port.check_logits(*args)
    dynamic = port.clone(dynamic_depth=True).check_logits(*args)
    assert torch.equal(static, dynamic)
    # and inside the fused check, on the fleet
    _, phook = _hooks(fx)
    states = _port_states(fx["states"])
    sp = phook.fleet_pad_rows(NB)
    base = phook._pack_states(states, NB, sp)
    wids = torch.full((sp, NB), -1, dtype=torch.int64)
    for i, s in enumerate(states):
        wids[i, :s.n] = torch.from_numpy(s.wids)
    assert phook.model.dynamic_depth
    a = phook._fused_check(base[0], wids, *base[1:], NB)
    phook.model = port.clone(dynamic_depth=False)
    assert torch.equal(a, phook._fused_check(base[0], wids, *base[1:], NB))


# --- 3. the fused check -------------------------------------------------------------


def _jax_margins(fx, jhook, states):
    """The JAX model's margins on the fleet's first pass, from its own
    logits (``RefineHook._score_nodes``, one masked node per job): each
    slot's gap to its sorted neighbours, the best-minus-runner-up type gap
    at its node, and each row's largest |logp|."""
    s, n = len(states), NB
    lp = np.zeros((s, n, 780))
    wids = np.full((s, n), -1, np.int64)
    with jax.default_matmul_precision("highest"):
        for i, st in enumerate(states):
            wids[i, :st.n] = st.wids
            logits = jhook._score_nodes([(st, st.wids, node) for node in range(st.n)])
            cur = np.clip(st.wids, 0, 779)
            support = np.stack([jhook._support_mask(int(z)) for z in fx["vocab_sizes"][cur]])
            support[np.arange(st.n), cur] = True
            ls = np.where(support, logits.astype(np.float64), -1e9)
            mx = ls.max(-1, keepdims=True)
            lp[i, :st.n] = ls - (mx + np.log(np.exp(ls - mx).sum(-1, keepdims=True)))
    cur = np.clip(wids, 0, 779)
    logp_cur = np.take_along_axis(lp, cur[..., None], -1)[..., 0]
    best2 = -np.sort(-lp, axis=-1)[..., :2]
    assigned = wids >= 0
    keys = np.where(assigned, logp_cur, np.inf)
    order = np.argsort(keys, axis=1, kind="stable")
    sk = np.take_along_axis(keys, order, 1)
    with np.errstate(invalid="ignore"):
        steps = np.nan_to_num(np.diff(sk, axis=1), nan=np.inf, posinf=np.inf)
    inf = np.full((s, 1), np.inf)
    gap = np.minimum(np.concatenate([inf, steps], 1), np.concatenate([steps, inf], 1))
    return {"order_gap": gap[:, :K],
            "top_gap": np.take_along_axis(best2[..., 0] - best2[..., 1], order[:, :K], 1),
            "scale": np.where(assigned, np.abs(logp_cur), 0.0).max(1)}


def test_fused_check_matches_jax_under_the_margin_rule(fx):
    jhook, phook = _hooks(fx)
    states = fx["states"]
    sp = jhook.fleet_pad_rows(NB)
    assert sp == phook.fleet_pad_rows(NB) == 64
    assert jhook.fleet_chunk_rows(NB) == phook.fleet_chunk_rows(NB)
    wids_rows = [s.wids for s in states]
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jhook._dispatch_fused(jhook._pack_states(states, NB, sp), wids_rows,
                                               NB, sp))[:len(states)]
    pstates = _port_states(states)
    token = phook._dispatch_fused(phook._pack_states(pstates, NB, sp), wids_rows, NB, sp,
                                  margins=True)
    got = phook.wait_packed(token, len(states))
    assert got.shape == (len(states), 1 + 6 * K + 1) and ref.shape == (len(states), 1 + 4 * K)
    report = compare_fused(ref, got[:, :1 + 4 * K], K, _jax_margins(fx, jhook, states),
                           margin=MARGIN, tol=F32_REL)
    print(f"fused check against JAX: {report['slots_compared']} slots compared, "
          f"{len(report['cut'])} cut {report['cut']}, total err {report['max_total_rel_err']:.2e}, "
          f"new_total err {report['max_new_total_rel_err']:.2e}")
    assert report["ok"], report["failures"]
    assert report["slots_compared"] >= len(states) * K // 2
    r = unpack(ref, K)
    assert r["valid"].any() and (r["new_total"][r["valid"]] != r["total"].repeat(K).reshape(
        -1, K)[r["valid"]]).any()
    # the port's own margins agree with the JAX ones where they are finite
    mine = unpack(got, K)
    want = _jax_margins(fx, jhook, states)
    finite = np.isfinite(want["order_gap"])
    np.testing.assert_array_equal(np.isfinite(mine["order_gap"]), finite)
    assert np.abs(mine["order_gap"][finite] - want["order_gap"][finite]).max() < 1e-4
    assert np.abs(mine["scale"] - want["scale"]).max() < 1e-4


@pytest.mark.parametrize("gated", [False, True])
def test_collect_batch_decisions_equal_jax(fx, gated):
    gate = (lambda s, node: (int(s.wids[node]) + node) % 2 == 0) if gated else None
    jhook, phook = _hooks(fx, can_assemble=gate)
    with jax.default_matmul_precision("highest"):
        want = jhook.check_batch([s.clone() for s in fx["states"]])
    got = phook.check_batch(_port_states(fx["states"]))
    assert len(got) == len(want) == len(fx["states"])
    assert phook.stats["score_calls"] == jhook.stats["score_calls"] == 1
    # a swap's gain is a difference of two totals: its rounding is the totals'
    sp = jhook.fleet_pad_rows(NB)
    with jax.default_matmul_precision("highest"):
        totals = jhook._run_fused(jhook._pack_states(fx["states"], NB, sp),
                                  [s.wids for s in fx["states"]], NB, sp, K)[0]
    scale = float(np.abs(totals).max())
    for (gs, gd, gc), (ws, wd, wc) in zip(got, want):
        assert gc == wc
        np.testing.assert_array_equal(gs.wids, ws.wids)
        assert abs(gd - wd) < F32_REL * scale
    if not gated:
        assert any(c for _, _, c in want)     # an untrained model at check_frac 0.5 swaps
    # the fleet hook form (one check per state) keeps the list and adds the
    # swaps' gains
    with jax.default_matmul_precision("highest"):
        jout = jhook([s.clone() for s in fx["states"][:2]])
    pout = phook(_port_states(fx["states"][:2]))
    for a, b in zip(pout, jout):
        np.testing.assert_array_equal(a.wids, b.wids)
        assert abs(a.logp - b.logp) < F32_REL * scale


def test_finalize_with_a_gate_equals_jax(fx):
    s = fx["states"][0]
    broken0 = int(s.wids[0])

    def gate(st, node):          # node 0 with its original type does not assemble
        return not (node == 0 and st.wids[0] == broken0)

    jhook, phook = _hooks(fx, can_assemble=gate)
    with jax.default_matmul_precision("highest"):
        want = jhook.finalize(s.clone(), check_num=30)
    got = phook.finalize(_port_states([s])[0], check_num=30)
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(got.wids, want.wids)
        assert got.wids[0] != broken0
    # no gate: unchanged; a gate that rejects everything: given up
    _, plain = _hooks(fx)
    p0 = _port_states([s])[0]
    assert plain.finalize(p0) is p0
    _, none = _hooks(fx, can_assemble=lambda st, node: False)
    assert none.finalize(p0) is None
    # the per-job scorer behind it: logps and top-1 as the JAX one's
    nodes = np.arange(s.n)
    with jax.default_matmul_precision("highest"):
        jl, jt = jhook._node_logps(s, s.wids, nodes)
    pl, pt = phook._node_logps(p0, p0.wids, nodes)
    assert np.abs(pl - jl).max() < F32_REL * np.abs(jl).max()
    np.testing.assert_array_equal(pt, jt)


# --- 4. the searches --------------------------------------------------------------


def _blur(gen, sizes):
    return [{"x": t.pos.astype(np.float32), "h": t.feats.astype(np.float32)}
            for t in (gen.sample_tree(n) for n in sizes)]


@pytest.fixture(scope="module")
def search(fx):
    gen = SyntheticTreeGenerator(seed=12)
    denoise = EdgeDenoise(hidden_nf=H, n_layers_full=1, n_layers_focal=1)
    batch = {k: jnp.asarray(v) for k, v in
             make_denoise_batch(gen.sample_trees(2, n=6), random.Random(0), max_n=8).items()}
    dparams = jax.jit(denoise.init)(jax.random.PRNGKey(0), batch)
    port = PortDenoise(hidden_nf=H, n_layers_full=1, n_layers_focal=1)
    port.load_state_dict(port_weights.denoise_state_dict_from_flax(_np_tree(dparams)),
                         strict=True)
    blur = _blur(gen, SEARCH_SIZES)
    with jax.default_matmul_precision("highest"):
        lattices = jax_lattice.LatticeSampler(denoise, dparams, native_search=False,
                                              buckets=(NB,)).compute_lattices(blur)
    return {"denoise": denoise, "dparams": dparams, "port": port.eval(), "blur": blur,
            "lattices": lattices}


class _Recorder:
    """Wraps a hook's ``collect_batch``: per refine-on group (keyed by its
    first molecule), the sequence of (molecule, swapped, new wids) of every
    checked state, and the reference's (total, new_total of each valid slot)
    beside each, from the packed result."""

    def __init__(self, hook, groups, packed):
        self.log = {}
        self.group_of = {i: g[0] for g, _ in groups for i in g}
        real = hook.collect_batch

        def collect(token, states):
            rows = {}
            for chunk, dev in token[1]:
                u = unpack(packed(dev)[:len(chunk)], token[0])
                for row, si in enumerate(chunk):
                    v = u["valid"][row]
                    rows[si] = (float(u["total"][row]), u["new_total"][row][v].tolist())
            out = real(token, states)
            for si, (st, _, changed) in enumerate(out):
                self.log.setdefault(self.group_of[st.index], []).append(
                    (st.index, changed, tuple(st.wids.tolist()), rows.get(si)))
            return out

        hook.collect_batch = collect


def test_refine_sampler_over_jax_lattices_is_jax_search(fx, search):
    """The port's refine-on search (pipelined groups at cap 2) over the JAX
    lattices is the JAX Python search, tree for tree. A group may part only
    where a swap decision rests on a near-tie: the JAX total and the
    competing new total within 1e-4."""
    blur, lattices, cap = search["blur"], search["lattices"], 2
    jhook, phook = _hooks(fx)
    jsampler = jax_lattice.LatticeSampler(search["denoise"], search["dparams"], beam_size=2,
                                          refine_hook=jhook, rng=random.Random(7),
                                          refine_group_cap=cap, native_search=False,
                                          buckets=(NB,))
    psampler = port_lattice.LatticeSampler(search["port"], beam_size=2, buckets=(NB,),
                                           refine_hook=phook, rng=random.Random(7),
                                           refine_group_cap=cap, native_search=False)
    groups = psampler._refine_groups(blur)
    assert groups == jsampler._refine_groups(blur) and len(groups) == 2
    jrec = _Recorder(jhook, groups, np.asarray)
    prec = _Recorder(phook, groups, lambda dev: dev.wait()[0])
    with jax.default_matmul_precision("highest"):
        want = jsampler._search(blur, lattices)
    got = psampler._search(blur, lattices)

    parted = {}
    for g, jlog in jrec.log.items():
        plog = prec.log.get(g, [])
        for step, (a, b) in enumerate(zip(jlog, plog)):
            if a[:3] != b[:3]:
                total, news = a[3] if a[3] is not None else b[3]
                gap = min((abs(t - total) for t in news), default=np.inf)
                assert gap < MARGIN, (g, step, a[:2], b[:2], gap)
                parted[g] = (step, gap)
                break
        else:
            assert len(jlog) == len(plog), g
    swaps = sum(c for log in jrec.log.values() for _, c, _, _ in log)
    print(f"refine-on search against JAX: {len(parted)} of {len(groups)} groups "
          f"parted on a near-tie {parted}; {swaps} swaps committed")
    assert swaps > 0
    if not parted:
        assert jhook.stats["score_calls"] == phook.stats["score_calls"]
    skip = {i for members, _ in groups if members[0] in parted for i in members}
    for i, (r, g) in enumerate(zip(want, got)):
        assert g is not None and _is_spanning_tree(g.adj), i
        if i in skip:
            continue
        np.testing.assert_array_equal(g.wids, r.wids)
        np.testing.assert_array_equal(g.adj, r.adj)
        assert abs(g.logp - r.logp) < F32_REL * max(1.0, abs(r.logp))


class _SmallHook(PortHook):
    """Fused checks of at most SMALL_ROWS rows, still one shape per bucket,
    so that the CPU keeps up with the searches."""

    def fleet_chunk_rows(self, nb: int) -> int:
        return min(super().fleet_chunk_rows(nb), SMALL_ROWS)


def _small_hook(fx):
    return _SmallHook(fx["port"], fx["vocab_sizes"], check_frac=CHECK_FRAC, buckets=SMALL_BUCKETS)


def _port_sampler(search, hook, **kw):
    """The Python refine-on searches (the native ones are held to them in
    tests/test_torch_native.py)."""
    return port_lattice.LatticeSampler(search["port"], beam_size=2, buckets=SMALL_BUCKETS,
                                       refine_hook=hook, rng=random.Random(7),
                                       native_search=False, **kw)


def test_pipelined_search_is_the_sequential_group_searches(fx, search):
    """Pipelining changes which check is in flight, never the order of work
    inside a group: the pipelined search equals each group's search run on
    its own with the same seed, bit for bit (the port's counterpart of
    tests/test_fine_stage.py:592). At cap 0 the sampler runs one lockstep
    search over all the molecules."""
    gen = SyntheticTreeGenerator(seed=13)
    blur = _blur(gen, (4, 5, 3, 4, 5) + (7, 8, 6, 8))
    lattices = port_lattice.LatticeSampler(search["port"]).compute_lattices(blur)
    hook = _small_hook(fx)
    sampler = _port_sampler(search, hook, refine_group_cap=2)
    got = sampler._search(blur, lattices)
    groups = sampler._refine_groups(blur)
    assert len(groups) == 5 and {nb for _, nb in groups} == set(SMALL_BUCKETS)

    hook2 = _small_hook(fx)
    seed_base = random.Random(7).getrandbits(64)
    want = [None] * len(blur)
    for members, _ in groups:
        res = port_beam.PQBeamSearch(
            port_lattice.LatticeExpander(lattices), beam_size=2, refine_hook=hook2,
            rng=random.Random(port_lattice._group_seed(seed_base, members))).run(
                port_lattice.LatticeSampler._init_states(blur, members))
        for i, r in zip(members, res):
            want[i] = r
    assert hook.stats["score_calls"] == hook2.stats["score_calls"] > 0
    for a, b in zip(got, want):
        assert a is not None and b is not None
        np.testing.assert_array_equal(a.wids, b.wids)
        np.testing.assert_array_equal(a.adj, b.adj)
        assert a.logp == b.logp

    lockstep = _port_sampler(search, _small_hook(fx), refine_group_cap=0)._search(blur, lattices)
    alone = port_beam.PQBeamSearch(
        port_lattice.LatticeExpander(lattices), beam_size=2, refine_hook=_small_hook(fx),
        rng=random.Random(7)).run(port_lattice.LatticeSampler._init_states(blur, range(len(blur))))
    assert all(a is not None for a in lockstep)
    for a, b in zip(lockstep, alone):
        np.testing.assert_array_equal(a.wids, b.wids)
        assert a.logp == b.logp


def test_merged_lanes_equal_unmerged(fx, search):
    """refine_merge=4 bundles four same-bucket groups into one fused check
    per round; the check is row-independent and every fleet pads to one
    shape per bucket, so under an assembly gate (which makes the searches
    backtrack) the trees equal merge 1's bit for bit, in fewer checks (the
    port's counterpart of tests/test_fine_stage.py:663)."""
    gen = SyntheticTreeGenerator(seed=14)
    blur = _blur(gen, (3, 4, 5, 4, 3, 5, 4, 5) + (6, 7, 8, 6, 7, 8, 6, 7))
    lattices = port_lattice.LatticeSampler(search["port"]).compute_lattices(blur)
    out, calls = {}, {}
    for merge in (1, 4):
        hook = _small_hook(fx)
        sampler = _port_sampler(search, hook, refine_group_cap=1, refine_merge=merge,
                                can_assemble=_gate(0.2))
        assert len(sampler._refine_groups(blur)) == len(blur) == 16   # merge 4 in effect
        out[merge] = sampler._search(blur, lattices)
        calls[merge] = hook.stats["score_calls"]
    assert calls[4] < calls[1]
    assert any(r is not None for r in out[1])
    for a, b in zip(out[4], out[1]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.wids, b.wids)
            np.testing.assert_array_equal(a.adj, b.adj)
            assert a.logp == b.logp


# --- 5. the CLIs ----------------------------------------------------------------

TINY = ["denoise.hidden_nf=16", "denoise.n_layers_full=1", "denoise.n_layers_focal=1",
        "refine.hidden_size=16", "refine.n_layers=1"]


def test_refine_on_assemble_cli_writes_the_jax_layout(tmp_path, capsys):
    gen = SyntheticTreeGenerator(seed=15)
    blur = _blur(gen, (12, 7, 4))           # checks start at 11 typed nodes
    src, out = tmp_path / "coarse.pkl", tmp_path / "trees.pkl"
    with open(src, "wb") as f:
        pickle.dump([blur], f)
    run = port_cli.main(["assemble", "--coarse-pkl", str(src), "--denoise-init-seed", "0",
                         "--refine-init-seed", "0", "--device", "cpu", "--beam", "2",
                         "--out", str(out), *TINY])
    with open(out, "rb") as f:
        payload = pickle.load(f)
    assert set(payload) == {"trees"} and len(payload["trees"]) == len(blur)
    for d, b in zip(payload["trees"], blur):
        assert set(d) == {"wids", "adj", "pos", "feats", "logp"}
        assert _is_spanning_tree(d["adj"]) and ((d["wids"] >= 0) & (d["wids"] < 780)).all()
    hook = run["sampler"].refine_hook
    assert hook is not None and hook.buckets == run["sampler"].buckets
    assert hook.stats["score_calls"] > 0 and hook.model.hidden_size == 16
    assert "fused checks" in capsys.readouterr().out
    # the refine weights from a file give the same tree as from the seed
    # (molecule 0 is alone in its bucket, so alone in its group either way)
    weights = tmp_path / "refine.pt"
    torch.save(hook.model.state_dict(), weights)
    again = port_cli.main(["assemble", "--coarse-pkl", str(src), "--denoise-init-seed", "0",
                           "--refine-weights", str(weights), "--device", "cpu", "--beam", "2",
                           "--num", "1", "--out", str(tmp_path / "again.pkl"), *TINY])
    np.testing.assert_array_equal(again["trees"][0].wids, run["trees"][0].wids)
    assert again["trees"][0].logp == run["trees"][0].logp


def test_refine_on_generate_cli_writes_the_jax_layout(tmp_path):
    out = tmp_path / "gen.pkl"
    run = port_cli.main(["generate", "--init-seed", "0", "--denoise-init-seed", "0",
                         "--refine-init-seed", "0", "--device", "cpu", "--num", "3",
                         "--sample-steps", "3", "--max-nodes", "12", "--beam", "2",
                         "--out", str(out), "coarse.hidden_nf=16", "coarse.n_layers=1", *TINY])
    with open(out, "rb") as f:
        payload = pickle.load(f)
    assert set(payload) == {"trees", "molecules", "stats"} and payload["molecules"] is None
    assert len(payload["trees"]) == 3 and set(payload["stats"]) == {"t_coarse", "t_fine"}
    for d in payload["trees"]:
        assert set(d) == {"wids", "adj", "pos", "feats", "logp"}
        assert ((d["wids"] >= 0) & (d["wids"] < 780)).all()
    pipe = run["pipeline"]
    assert pipe.sampler.refine_hook.buckets == pipe.sample_buckets
