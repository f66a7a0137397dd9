"""The port's native searches and round-based sampler against its Python
searches and the JAX package.

- ``runtime.beam_search_lattice_native`` (refine off) is bitwise the port's
  Python ``PQBeamSearch`` over the same lattices, ungated, gated with
  ``retry_final_gate`` on and off, and through dead ends, with the same
  tiebreak stream after; and exactly JAX's native search.
- ``_sample_refine_native`` (``runtime.NativeRefineSearch`` in
  ``_NativeRefineLoop``) is bitwise the pipelined Python search, and
  ``sample_streamed`` is bitwise ``sample`` when its chunks hold whole
  buckets (up to the rounding of another batch shape otherwise).
- The fleet packer is bitwise JAX's and the Python packer; ``ARSampler``
  under ``vocab_conditioning`` is JAX's, tree for tree, except where a
  decision rests on a near-tie.

The refine-on searches run a port-only tiny model (hidden 32, 1 + 1
layers) whose fused checks hold at most 4 rows, so the CPU keeps up.
"""

import copy
import random
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hierdiff_torch import runtime as port_runtime
from hierdiff_torch.data import assets as port_assets
from hierdiff_torch.data.collate import bucket_for
from hierdiff_torch.models.edge_denoise import EdgeDenoise as PortDenoise
from hierdiff_torch.models.refine import NodeRefine as PortRefine
from hierdiff_torch.sampling import ar as port_ar
from hierdiff_torch.sampling import beam as port_beam
from hierdiff_torch.sampling import lattice as port_lattice
from hierdiff_torch.sampling import pipeline as port_pipeline
from hierdiff_torch.sampling.refine_hook import RefineHook as PortHook
from hierdiff_torch.utils import weights as port_weights
from hierdiff_tpu import runtime as jax_runtime
from hierdiff_tpu.data.denoise import make_denoise_batch
from hierdiff_tpu.data.synthetic import SyntheticTreeGenerator
from hierdiff_tpu.models.edge_denoise import EdgeDenoise
from hierdiff_tpu.sampling import ar as jax_ar
from hierdiff_tpu.sampling import beam as jax_beam
from hierdiff_tpu.sampling import lattice as jax_lattice

pytestmark = pytest.mark.skipif(not port_runtime.treekit_available(),
                                reason="no C++ compiler: treekit is not built")

H = 32
BUCKETS = (6, 10)                        # the refine-on searches: two pad buckets
SIZES = (4, 5, 6, 6, 3, 8, 9, 10, 10, 7)
CHECK_FRAC, SMALL_ROWS, CAP = 0.5, 4, 3
MARGIN = 1e-4                            # near-tie of two log-probabilities

torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the searches' many small CPU ops gain little
    from more, and the suite runs beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(got, want, exact: bool = True):
    assert len(got) == len(want)
    for g, r in zip(got, want):
        assert (g is None) == (r is None)
        if r is None:
            continue
        np.testing.assert_array_equal(g.wids, r.wids)
        np.testing.assert_array_equal(g.adj, r.adj)
        if exact:
            assert g.logp == r.logp and g.last_edge == r.last_edge
        else:
            assert g.logp == pytest.approx(r.logp, abs=1e-4)


# --- 1. the refine-off search over random lattices ------------------------------


def _random_lattices(m, k=5, seed=3, max_n=24):
    """Random lattices, as the JAX runtime's tests make them, in both
    packages' MoleculeLattice: sizes 1, 2 and random, restricted-support
    holes (-1e9) in a sorted top-k."""
    rng = np.random.default_rng(seed)
    sizes = np.concatenate([[1, 2], rng.integers(3, max_n, m - 2)]).astype(int)
    arrays = {}
    for i, n in enumerate(sizes):
        lp = -rng.random((n, k)).astype(np.float32)
        lp.sort(axis=1)
        lp = lp[:, ::-1].copy()
        mask = rng.random((n, k)) < 0.15
        mask[:, 0] = False
        lp[mask] = -1e9
        arrays[i] = dict(focal=np.maximum(0, np.arange(n) - 1).astype(np.int32),
                         target=np.arange(n).astype(np.int32), attach=np.arange(n) > 0,
                         top_wid=rng.integers(0, 780, (n, k)).astype(np.int64), top_logp=lp)
    return ({i: port_lattice.MoleculeLattice(**a) for i, a in arrays.items()},
            {i: jax_lattice.MoleculeLattice(**a) for i, a in arrays.items()}, sizes)


def _verdict_gate(reject_frac: float):
    """A verdict-style gate (``chem.assemble_gate``'s shape) without RDKit:
    rejects a share of (fragment, sorted typed neighbours) by hash."""
    def verdict(wid, neis):
        return zlib.crc32(repr((int(wid), tuple(neis))).encode()) / 0xFFFFFFFF >= reject_frac

    def gate(state, i):
        wid = int(state.wids[i])
        if wid < 0:
            return True
        neis = tuple(sorted(int(state.wids[j]) for j in np.nonzero(state.adj[i])[0]
                            if j != i and int(state.wids[j]) >= 0))
        return True if not neis else verdict(wid, neis)

    gate.verdict = verdict
    return gate


def _states(sizes):
    return [port_beam.TreeState(feats=np.zeros((int(n), 8), np.float32),
                                pos=np.zeros((int(n), 3), np.float32),
                                adj=np.zeros((int(n), int(n)), np.float32),
                                wids=np.full(int(n), -1, np.int64), index=i)
            for i, n in enumerate(sizes)]


@pytest.mark.parametrize("case", ["ungated", "gated_retry", "gated_no_retry", "dead_end"])
def test_native_search_is_the_python_search(case):
    """Bitwise: the same accepted and failed molecules, wids, logp to the
    last bit, and both tiebreak streams in the same state after."""
    lattices, _, sizes = _random_lattices(12 if case == "dead_end" else 60,
                                          seed=9 if case == "dead_end" else 5)
    if case == "dead_end":
        lat = lattices[5]                # every candidate of its middle step out of support
        lat.top_logp[lat.top_logp.shape[0] // 2, :] = -1e9
    gate = _verdict_gate(0.25) if case.startswith("gated") else None
    retry = case != "gated_no_retry"
    r_py, r_nat = random.Random(2022), random.Random(2022)
    want = port_beam.PQBeamSearch(port_lattice.LatticeExpander(lattices), beam_size=5,
                                  rng=r_py, can_assemble=gate,
                                  retry_final_gate=retry).run(_states(sizes))
    wids, ok, logp = port_runtime.beam_search_lattice_native(
        lattices, sizes, 5, r_nat, verdict=None if gate is None else gate.verdict,
        retry_final_gate=retry)
    assert any(r is not None for r in want)
    if gate is not None or case == "dead_end":
        assert any(r is None for r in want), "no molecule failed: the gate went unexercised"
    for i, r in enumerate(want):
        assert ok[i] == (r is not None)
        if r is not None:
            np.testing.assert_array_equal(wids[i], r.wids)
            assert logp[i] == r.logp
    assert r_py.getstate() == r_nat.getstate()
    # one stream: a Python search after the native one draws where the
    # native one stopped
    assert r_nat.random() == r_py.random()


@pytest.mark.parametrize("gated", [False, True])
def test_native_search_is_jax_native_search(gated):
    if not jax_runtime.treekit_available():
        pytest.skip("the JAX package's treekit is not built")
    lattices, jlattices, sizes = _random_lattices(40, seed=7)
    gate = _verdict_gate(0.25) if gated else None
    verdict = None if gate is None else gate.verdict
    r_port, r_jax = random.Random(11), random.Random(11)
    got = port_runtime.beam_search_lattice_native(lattices, sizes, 5, r_port, verdict=verdict)
    want = jax_runtime.beam_search_lattice_native(jlattices, sizes, 5, r_jax, verdict=verdict)
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert r_port.getstate() == r_jax.getstate()


def test_lattice_sampler_routes_to_the_native_search(search):
    """``LatticeSampler.sample`` with the native search equals it with
    ``native_search=False``, tree for tree (adjacency and last edge from
    the lattice's trajectory), refine off, ungated and gated."""
    for gate in (None, _verdict_gate(0.25)):
        trees = {}
        for native in (True, False):
            sampler = port_lattice.LatticeSampler(
                search["denoise"], beam_size=3, buckets=BUCKETS, can_assemble=gate,
                rng=random.Random(7), native_search=native)
            trees[native] = sampler._search(search["blur"], search["lattices"])
        _same(trees[True], trees[False])


def test_verdict_exceptions_are_raised_again(search):
    """ctypes swallows an exception raised in a callback; both native
    searches keep the first one and raise it after the call."""
    lattices, _, sizes = _random_lattices(6, seed=2)

    def bad(wid, neis):
        raise RuntimeError("verdict failed")

    with pytest.raises(RuntimeError, match="verdict failed"):
        port_runtime.beam_search_lattice_native(lattices, sizes, 5, random.Random(0),
                                                verdict=bad)

    def gate(state, i):
        return True

    gate.verdict = bad
    sampler = _refine_sampler(search, gate, None, native=True)
    with pytest.raises(RuntimeError, match="verdict failed"):
        sampler._search(search["blur"], search["lattices"])


# --- 2. the refine-on searches ---------------------------------------------------


class _SmallHook(PortHook):
    """Fused checks of at most SMALL_ROWS rows, still one shape per bucket,
    so that the CPU keeps up with the searches."""

    def fleet_chunk_rows(self, nb: int) -> int:
        return min(super().fleet_chunk_rows(nb), SMALL_ROWS)


@pytest.fixture(scope="module")
def search():
    """Tiny port models from seeds, blur sets of two buckets and their
    lattices."""
    gen = SyntheticTreeGenerator(seed=21)
    denoise = port_weights.init_weights(
        PortDenoise(hidden_nf=H, n_layers_full=1, n_layers_focal=1),
        torch.Generator().manual_seed(0)).eval()
    refine = port_weights.init_weights(PortRefine(hidden_size=H, n_layers=1),
                                       torch.Generator().manual_seed(1)).eval()
    blur = [{"x": t.pos.astype(np.float32), "h": t.feats.astype(np.float32)}
            for t in (gen.sample_tree(n) for n in SIZES)]
    lattices = port_lattice.LatticeSampler(denoise, buckets=BUCKETS).compute_lattices(blur)
    return {"denoise": denoise, "refine": refine, "blur": blur, "lattices": lattices,
            "vocab_sizes": np.asarray(port_assets.vocab_mol_sizes())}


def _refine_sampler(search, gate, hook_gate, native: bool, cap: int = CAP):
    hook = _SmallHook(search["refine"], search["vocab_sizes"], check_frac=CHECK_FRAC,
                      can_assemble=hook_gate, buckets=BUCKETS)
    return port_lattice.LatticeSampler(search["denoise"], beam_size=2, buckets=BUCKETS,
                                       refine_hook=hook, can_assemble=gate, rng=random.Random(7),
                                       refine_group_cap=cap, native_search=native)


@pytest.mark.parametrize("reject", [0.0, 0.25])
def test_native_refine_search_is_the_pipelined_search(search, reject):
    """Bitwise: wids (the committed swaps included), adjacency and logp; the
    same number of fused checks; the native counters count."""
    gate = _verdict_gate(reject) if reject else None
    hook_gate = _verdict_gate(reject / 2) if reject else None
    py = _refine_sampler(search, gate, hook_gate, native=False)
    nat = _refine_sampler(search, gate, hook_gate, native=True)
    assert nat._refine_native_eligible() and not py._refine_native_eligible()
    swaps = []
    collect = py.refine_hook.collect_batch

    def counted(token, states):
        out = collect(token, states)
        swaps.append(sum(changed for _, _, changed in out))
        return out

    py.refine_hook.collect_batch = counted
    want = py._search(search["blur"], search["lattices"])
    assert sum(swaps) > 0, "no swap committed: the walk went unexercised"
    got = nat._search(search["blur"], search["lattices"])
    assert any(r is not None for r in want)
    _same(got, want)
    st = nat.refine_hook.stats
    assert st["rounds"] > 0 and st["fleet_rows"] > 0 and st["lanes"] > 0
    assert py.refine_hook.stats["rounds"] == 0
    assert st["score_calls"] > 0
    print(f"native refine search, reject {reject}: {sum(swaps)} swaps, {st['score_calls']} checks in "
          f"{st['lanes']} lanes (Python {py.refine_hook.stats['score_calls']} checks), "
          f"{st['rounds']} group rounds, {st['fleet_rows']} fleet rows")


class _ListFeeder:
    """A ``sample_streamed`` feeder over given blur sets in fixed chunks."""

    def __init__(self, blur, chunks):
        self.total = len(blur)
        self.blur = [None] * len(blur)
        self._src = blur
        self._chunks = [list(c) for c in chunks]

    @property
    def done(self):
        return not self._chunks

    def pump(self):
        return []

    def collect_next(self):
        idxs = self._chunks.pop(0)
        for i in idxs:
            self.blur[i] = self._src[i]
        return [idxs]


@pytest.mark.parametrize("reject,straddle,native", [(0.0, False, True), (0.0, True, True),
                                                    (0.25, False, True), (0.0, False, False)])
def test_sample_streamed_is_sample(search, reject, straddle, native):
    """Chunks of whole buckets give ``sample``'s trees bit for bit;
    chunks that straddle buckets run lattices at other batch shapes, which
    move a log-probability by ~1e-6: the same wids and adjacency, logp
    within 1e-4. Without the native search the streamed driver collects
    everything, then runs the serial search: exact."""
    blur = search["blur"]
    gate = _verdict_gate(reject) if reject else None
    hook_gate = _verdict_gate(reject / 2) if reject else None
    want = _refine_sampler(search, gate, hook_gate, native).sample(blur)
    sampler = _refine_sampler(search, gate, hook_gate, native)
    if straddle:
        chunks = [[0, 1], [2, 3, 4, 5, 6], list(range(7, len(blur)))]
    else:
        by_bucket = {}
        for i, b in enumerate(blur):
            by_bucket.setdefault(bucket_for(b["h"].shape[0], BUCKETS), []).append(i)
        chunks = [idxs for _, idxs in sorted(by_bucket.items())]
    got = sampler.sample_streamed(_ListFeeder(blur, chunks))
    assert any(r is not None for r in want)
    _same(got, want, exact=not straddle)
    assert (sampler.refine_hook.stats["rounds"] > 0) == native


def test_sample_streamed_refine_off_is_sample(search):
    blur = search["blur"]
    want = port_lattice.LatticeSampler(search["denoise"], beam_size=3, buckets=BUCKETS,
                                       rng=random.Random(3)).sample(blur)
    sampler = port_lattice.LatticeSampler(search["denoise"], beam_size=3, buckets=BUCKETS,
                                          rng=random.Random(3))
    by_bucket = {}
    for i, b in enumerate(blur):
        by_bucket.setdefault(bucket_for(b["h"].shape[0], BUCKETS), []).append(i)
    got = sampler.sample_streamed(_ListFeeder(blur, [i for _, i in sorted(by_bucket.items())]))
    _same(got, want)


def test_native_refine_search_asserts_check_frac():
    lattices, _, sizes = _random_lattices(4, seed=1)
    with pytest.raises(AssertionError, match="check_frac <= 1"):
        port_runtime.NativeRefineSearch(lattices, [0, 1], sizes[:2], 2, random.Random(0),
                                        max_n=4, check_frac=1.5)


# --- 3. the fleet packer and the round-based sampler ------------------------------


def _fleet():
    gen = SyntheticTreeGenerator(seed=3)
    states, jstates = [], []
    for i, t in enumerate(gen.sample_trees(3, n=6) + gen.sample_trees(2, n=9)):
        n = t.adj.shape[0]
        wids = np.full(n, -1, np.int64)
        wids[: n // 2] = t.wids[: n // 2]
        adj = np.zeros((n, n), np.float32)
        adj[0, 0] = 1.0                       # the root marker
        if i % 2:
            adj[0, 1] = adj[1, 0] = 1.0
        args = (t.feats.astype(np.float32), t.pos.astype(np.float32), adj, wids)
        states.append(port_beam.TreeState(*args, index=i))
        jstates.append(jax_beam.TreeState(*args, index=i))
    return states, jstates


def test_fleet_packer_is_jax_and_the_python_packer():
    states, jstates = _fleet()
    nb, bp = 12, 8
    native = port_ar.pack_fleet_native(states, nb, bp)
    python = port_ar.pack_fleet_python(states, nb, bp)
    for a, b in zip(native, python):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    raw = port_runtime.pack_ar_fleet_native(states, nb)
    if jax_runtime.treekit_available():
        for a, b in zip(raw, jax_runtime.pack_ar_fleet_native(jstates, nb)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(raw, native):
        np.testing.assert_array_equal(a, b[:len(states)])


@pytest.fixture(scope="module")
def conditioned():
    """A vocab-conditioned EdgeDenoise in both frameworks on the same
    weights, and blur sets of one bucket."""
    gen = SyntheticTreeGenerator(seed=5)
    model = EdgeDenoise(hidden_nf=H, n_layers_full=1, n_layers_focal=1, vocab_conditioning=True)
    batch = {k: jnp.asarray(v) for k, v in
             make_denoise_batch(gen.sample_trees(2, n=6), random.Random(0), max_n=8).items()}
    params = jax.jit(model.init)(jax.random.PRNGKey(0), batch)
    port = PortDenoise(hidden_nf=H, n_layers_full=1, n_layers_focal=1, vocab_conditioning=True)
    port.load_state_dict(port_weights.denoise_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    blur = [{"x": t.pos.astype(np.float32),
             "h": port_pipeline.round_int_features(t.feats.astype(np.float32), 5)}
            for t in (gen.sample_tree(n) for n in (5, 7, 6, 8))]
    return {"model": model, "params": params, "port": port.eval(), "blur": blur}


class _Rounds:
    """Wraps an expander: every round's fleet, as {molecule: {state key:
    (a copy of the state, its expansion)}}, to find where two searches
    part. A state's key is its wids and adjacency."""

    def __init__(self, expander):
        self.log = []
        self.inner = expander

    def __call__(self, states):
        out = self.inner(states)
        fleet = {}
        for s, e in zip(states, out):
            key = (tuple(s.wids.tolist()), s.adj.tobytes())
            fleet.setdefault(s.index, {})[key] = (copy.deepcopy(s), e)
        self.log.append(fleet)
        return out


def _jax_step_margins(model, params):
    """JAX's expansion of one tree state as ``ar_step`` computes it, with
    the margin of each argmax: the best candidate's focal score (or edge
    logit) minus the runner-up's, inf where there is no runner-up."""
    def heads(mdl, name):
        return name == "__call__" and mdl.name in ("focal_head", "edge_head")

    core = jax.jit(lambda p, *a: model.apply(p, *a, method=EdgeDenoise._expand_core,
                                             capture_intermediates=heads,
                                             mutable=["intermediates"]))

    def margin(scores, valid):
        s = np.sort(np.where(valid, scores, -np.inf))[::-1]
        return float(s[0] - s[1]) if valid.sum() >= 2 else np.inf

    def step(state, nb=8):
        feats, pos, adj, vocab, _, nmask = port_ar.pack_fleet_python([state], nb, 1)
        disc = (adj.sum(-1) > 0).astype(np.int32)          # as ar_step reads it
        adj = adj * (1.0 - np.eye(nb, dtype=np.float32))
        with jax.default_matmul_precision("highest"):
            (out, _, _), inter = core(params, feats, disc, vocab, pos, adj, nmask)
        inter = inter["intermediates"]
        valid = nmask[0, :, 0] > 0
        return {"focal": int(out["focal"][0]), "target": int(out["target"][0]),
                "focal_margin": margin(np.asarray(inter["focal_head"]["__call__"][0])[0, :, 0],
                                       valid & (disc[0] > 0)),
                "target_margin": margin(np.asarray(inter["edge_head"]["__call__"][0])[0, :, 0],
                                        valid & (disc[0] == 0))}

    return step


def test_ar_sampler_is_jax_ar_sampler(conditioned):
    """The port's ARSampler against JAX's with ``vocab_conditioning=True``
    on the same weights, round by round: the same states popped and the
    same expansions, except that a molecule may part where JAX's decision
    rests on a near-tie within 1e-4 (MARGIN): its focal or target argmax
    with the runner-up's score that close, or two candidate types whose
    log-probabilities are that close (the top-k order may then differ). A
    parted molecule is not compared further, and at most half of them may
    part. Log-probabilities agree to 1e-5 of their size; the trees of the
    molecules that did not part are equal."""
    c = conditioned
    jsampler = jax_ar.ARSampler(c["model"], c["params"], beam_size=3, rng=random.Random(5),
                                buckets=(8,))
    psampler = port_ar.ARSampler(c["port"], beam_size=3, rng=random.Random(5), buckets=(8,))
    jrec, prec = _Rounds(jsampler.expander), _Rounds(psampler.expander)
    jsampler.expander, psampler.expander = jrec, prec
    with jax.default_matmul_precision("highest"):
        want = jsampler.sample(c["blur"])
    got = psampler.sample(c["blur"])
    assert psampler.expander.inner.stats["native_packs"] > 0
    jax_step = _jax_step_margins(jrec.inner.model, c["params"])

    parted, compared, smallest = {}, 0, np.inf
    for r, (jr, pr) in enumerate(zip(jrec.log, prec.log)):
        for i in sorted(set(jr) | set(pr)):
            if i in parted:
                continue
            assert set(jr.get(i, {})) == set(pr.get(i, {})), f"round {r}: molecule {i} " \
                "popped other states"
            for key, (state, je) in jr[i].items():
                pe = pr[i][key][1]
                step = jax_step(state)            # the JAX decision and how near a tie it was
                assert (step["focal"], step["target"]) == (je.focal, je.target)
                smallest = min(smallest, step["focal_margin"], step["target_margin"])
                assert je.attach == pe.attach, (r, i)
                choice = next((k for k in ("focal", "target")
                               if getattr(je, k) != getattr(pe, k)), None)
                if choice is not None:
                    assert step[f"{choice}_margin"] < MARGIN, (r, i, choice, step, pe)
                    parted[i] = (r, choice, step[f"{choice}_margin"])
                    break
                want_logps = np.asarray(je.cand_logps, np.float64)
                np.testing.assert_allclose(pe.cand_logps, want_logps, rtol=1e-5, atol=1e-5)
                differ = np.asarray(je.cand_wids) != pe.cand_wids
                if differ.any():
                    tie = np.abs(np.diff(want_logps)) < MARGIN
                    near = np.zeros(len(want_logps), bool)
                    near[1:] |= tie
                    near[:-1] |= tie
                    assert near[differ].all(), (r, i, je, pe)
                    parted[i] = (r, "cand_wids", None)
                    break
                compared += 1
    n = min(len(jrec.log), len(prec.log))
    if not parted:
        assert len(jrec.log) == len(prec.log)
    for log in (jrec.log, prec.log):          # past the shorter log, only parted molecules
        assert all(set(fleet) <= set(parted) for fleet in log[n:])
    print(f"ARSampler against JAX: {compared} expansions compared over {n} rounds, "
          f"{len(parted)} of {len(c['blur'])} molecules parted on a near-tie {parted}, "
          f"smallest JAX margin {smallest:.3g}")
    assert len(parted) <= len(c["blur"]) // 2 and compared > 0
    for i, (r, g) in enumerate(zip(want, got)):
        assert g is not None and ((g.wids >= 0) & (g.wids < 780)).all() and np.isfinite(g.logp)
        if i in parted:
            continue
        np.testing.assert_array_equal(g.wids, r.wids)
        np.testing.assert_array_equal(g.adj, r.adj)
        assert abs(g.logp - r.logp) < 1e-5 * max(1.0, abs(r.logp))


def test_ar_sampler_packs_with_either_packer(conditioned, monkeypatch):
    """The trees do not depend on which packer packs the fleets."""
    c = conditioned
    native = port_ar.ARSampler(c["port"], beam_size=3, buckets=(8,)).sample(c["blur"])
    monkeypatch.setattr(port_runtime, "treekit_available", lambda: False)
    sampler = port_ar.ARSampler(c["port"], beam_size=3, buckets=(8,))
    python = sampler.sample(c["blur"])
    assert sampler.expander.stats["native_packs"] == 0 and sampler.expander.stats["steps"] > 0
    _same(python, native)
