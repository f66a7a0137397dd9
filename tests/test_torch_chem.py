"""PyTorch port of the chemistry (``hierdiff_torch/chem``, ``eval``), the
assembly gate in the searches, reconstruction in the pipeline and the
``generate`` / ``reconstruct`` / ``eval`` CLIs, against the JAX package on
the same inputs, under the fake-RDKit harness (``tests/fake_rdkit.py``).

The harness's chemistry is deterministic, so the two packages must agree
exactly: the same cliques, verdicts, trees, SMILES, atom maps and stats,
and the evaluation panel's floats within 1e-12. The searches run over
lattices built here from seeded numpy draws (no model compiles for them),
with fragments of at most three heavy atoms, so the reference's exhaustive
attachment enumeration stays cheap. Trees are small: the six test molecules
(4-9 nodes) and generated trees of at most 2 nodes.
"""

import json
import pickle
import random
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
import fake_rdkit  # noqa: E402

from hierdiff_torch.chem import RDKitUnavailable  # noqa: E402
from hierdiff_torch.models.edge_denoise import EdgeDenoise as PortDenoise  # noqa: E402
from hierdiff_torch.models.refine import NodeRefine as PortRefine  # noqa: E402
from hierdiff_torch.sampling import beam as port_beam  # noqa: E402
from hierdiff_torch.sampling import cli as port_cli  # noqa: E402
from hierdiff_torch.sampling import lattice as port_lattice  # noqa: E402
from hierdiff_torch.sampling import pipeline as port_pipeline  # noqa: E402
from hierdiff_torch.sampling.refine_hook import RefineHook as PortHook  # noqa: E402
from hierdiff_torch.tools import chem_check  # noqa: E402
from hierdiff_torch.utils import weights as port_weights  # noqa: E402
from hierdiff_tpu.data.assets import load_vocab_smiles  # noqa: E402
from hierdiff_tpu.data.refine import make_refine_batch  # noqa: E402
from hierdiff_tpu.data.synthetic import SyntheticTreeGenerator  # noqa: E402
from hierdiff_tpu.models.edge_denoise import EdgeDenoise  # noqa: E402
from hierdiff_tpu.models.refine import NodeRefine  # noqa: E402
from hierdiff_tpu.sampling import beam as jax_beam  # noqa: E402
from hierdiff_tpu.sampling import lattice as jax_lattice  # noqa: E402
from hierdiff_tpu.sampling import pipeline as jax_pipeline  # noqa: E402
from hierdiff_tpu.sampling.refine_hook import RefineHook as JaxHook  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
NB, K_TOP = 8, 16
SEARCH_SIZES = (6, 5, 7, 4, 6)
TINY = ["denoise.hidden_nf=16", "denoise.n_layers_full=1", "denoise.n_layers_focal=1",
        "refine.hidden_size=16", "refine.n_layers=1", "coarse.hidden_nf=16", "coarse.n_layers=1"]


@pytest.fixture(scope="module", autouse=True)
def fake():
    """The harness for the whole module, one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    fake_rdkit.install()
    yield fake_rdkit
    fake_rdkit.uninstall()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(fake):
    """chem_check's six molecules decomposed by each package over its own
    Vocab of their fragments (the mols are the harness's, shared)."""
    from rdkit import Chem

    from hierdiff_tpu.chem.mol_tree import MolTree as JaxMolTree
    from hierdiff_tpu.chem.mol_tree import Vocab as JaxVocab

    port = chem_check.mini_world()
    fps = {s: port["vocab"].get_fp(s) for s in port["frag"]}
    jvocab = JaxVocab(port["frag"], fps, mode="prop")
    return {"port": port, "jax_vocab": jvocab,
            "jax_trees": [JaxMolTree(m, vocab=jvocab) for m in port["mols"]],
            "canon": lambda m: Chem.MolToSmiles(m)}


def _small_wids(max_atoms: int = 3) -> np.ndarray:
    """Indices of the real vocabulary's fragments of at most ``max_atoms``
    heavy atoms."""
    from hierdiff_torch.chem.mol_tree import Vocab

    v = Vocab()
    return np.asarray([i for i, s in enumerate(v.mol_sizes) if s <= max_atoms])


# --- 1. the probe and the copies -----------------------------------------------


def test_the_probe_asks_at_call_time():
    """``has_rdkit`` follows the harness in and out, and a port module
    imported before it sees it (no frozen module-level flag)."""
    code = (
        "import sys\n"
        "sys.path.insert(0, 'tests')\n"
        "from hierdiff_torch.chem import has_rdkit\n"
        "from hierdiff_torch.chem.mol_tree import MolTreeNode\n"
        "from hierdiff_torch.sampling import pipeline\n"
        "import fake_rdkit\n"
        "seen = [has_rdkit(), MolTreeNode('CC', None).mol is None]\n"
        "fake_rdkit.install()\n"
        "seen += [has_rdkit(), MolTreeNode('CC', None).mol is not None, pipeline.has_rdkit()]\n"
        "fake_rdkit.uninstall()\n"
        "seen += [has_rdkit()]\n"
        "print(seen)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip().splitlines()[-1] == "[False, True, True, True, True, False]"


def test_decomposition_equals_jax(world):
    from hierdiff_torch.chem.chemutils import tree_decomp
    from hierdiff_tpu.chem.chemutils import tree_decomp as jax_tree_decomp

    for m, pt, jt in zip(world["port"]["mols"], world["port"]["trees"], world["jax_trees"]):
        assert tree_decomp(m) == jax_tree_decomp(m)
        assert pt.smiles == jt.smiles
        np.testing.assert_array_equal(pt.adj_matrix, jt.adj_matrix)
        assert [(n.smiles, n.clique, n.wid, n.hbd, n.nid, n.is_leaf) for n in pt.nodes] == \
            [(n.smiles, n.clique, n.wid, n.hbd, n.nid, n.is_leaf) for n in jt.nodes]
        for a, b in zip(pt.nodes, jt.nodes):
            np.testing.assert_array_equal(a.pos, b.pos)
            np.testing.assert_array_equal(a.fp, b.fp)
            assert [n.nid for n in a.neighbors] == [n.nid for n in b.neighbors]


def test_vocab_equals_jax():
    from hierdiff_torch.chem.mol_tree import Vocab
    from hierdiff_tpu.chem.mol_tree import Vocab as JaxVocab

    p, j = Vocab(), JaxVocab()
    assert p.vocab == j.vocab and p.mol_sizes == j.mol_sizes and p.size() == 780
    for a, b in zip(p.fps, j.fps):
        np.testing.assert_array_equal(a, b)
    assert p.get_slots(5) == j.get_slots(5)


def test_can_assemble_verdicts_equal_jax():
    """200 seeded (fragment, neighbours) queries over the real vocabulary:
    the centre any fragment, neighbours of at most three heavy atoms: 1-4
    of them at a centre of at most six atoms, 1-2 at one of at most ten,
    one at a larger one (the reference enumerates up to 2000 attachments
    per query); the port's early-exit search gives the reference's verdict
    on each."""
    from hierdiff_torch.chem.chemutils import can_assemble
    from hierdiff_torch.chem.mol_tree import MolTreeNode
    from hierdiff_torch.data.assets import vocab_mol_sizes
    from hierdiff_tpu.chem.chemutils import can_assemble as jax_can_assemble
    from hierdiff_tpu.chem.mol_tree import MolTreeNode as JaxNode

    smiles, sizes = load_vocab_smiles(), vocab_mol_sizes()
    small = _small_wids()
    rng = np.random.default_rng(0)
    verdicts = []
    for _ in range(200):
        wid = int(rng.integers(len(smiles)))
        centre = smiles[wid]
        most = 5 if sizes[wid] <= 6 else 3 if sizes[wid] <= 10 else 2
        neis = [smiles[int(w)] for w in rng.choice(small, size=int(rng.integers(1, most)))]
        node, jnode = MolTreeNode(centre, None), JaxNode(centre, None)
        node.neighbors = [MolTreeNode(s, None) for s in neis]
        jnode.neighbors = [JaxNode(s, None) for s in neis]
        got, want = can_assemble(node), jax_can_assemble(jnode)
        assert got == want, (centre, neis)
        verdicts.append(got)
    assert 0 < sum(verdicts) < len(verdicts)


def _random_states(cls, rng, vocab_wids, n_states: int = 12):
    gen = SyntheticTreeGenerator(seed=5)
    states = []
    for _ in range(n_states):
        t = gen.sample_tree(int(rng.integers(2, 7)))
        wids = rng.choice(vocab_wids, size=t.adj.shape[0]).astype(np.int64)
        wids[rng.random(len(wids)) < 0.2] = -1
        states.append(cls(t.feats.astype(np.float32), t.pos.astype(np.float32),
                          t.adj.astype(np.float32), wids))
    return states


def test_gate_verdicts_equal_jax():
    """The port's gate and ``.verdict`` against JAX's on seeded TreeStates
    (untyped nodes, some of every tree), and its memo."""
    from hierdiff_torch.chem.assemble_gate import make_assembly_gate
    from hierdiff_torch.chem.mol_tree import Vocab
    from hierdiff_tpu.chem.assemble_gate import make_assembly_gate as jax_gate
    from hierdiff_tpu.chem.mol_tree import Vocab as JaxVocab

    gate, jgate = make_assembly_gate(Vocab()), jax_gate(JaxVocab())
    small = _small_wids()
    states = _random_states(port_beam.TreeState, np.random.default_rng(1), small)
    jstates = _random_states(jax_beam.TreeState, np.random.default_rng(1), small)
    verdicts = []
    for s, js in zip(states, jstates):
        for i in range(s.n):
            verdicts.append(gate(s, i))
            assert verdicts[-1] == jgate(js, i)
    assert 0 < sum(verdicts) < len(verdicts)
    for key in [(int(small[3]), (int(small[0]), int(small[0]), int(small[1]))),
                (int(small[7]), (int(small[2]),))]:
        assert gate.verdict(*key) == jgate.verdict(*key)
    misses = gate.cache_info().misses
    for s in states:
        for i in range(s.n):
            gate(s, i)
    assert gate.cache_info().misses == misses


# ring fragments of five and six atoms around a ring centre: the verdict and
# the attachment list against the reference's, positive and negative (a
# negative one exhausts the search on both sides)
RING_QUERIES = [
    ("C1=CSCCO1", ["C1NN=NS1"]),
    ("C1=NCNCC1", ["C1=C[NH+]=CCC1"]),
    ("C1=NCNN=C1", ["C1CSN=N1", "C1=C[N-]C=NC1"]),
    ("C1=CN=C[NH2+]C1", ["C1CC[SH+]C1", "C1=CSC[N-]1"]),
    ("C1=CNCN1", ["C1COCOC1", "C1=NSCC1", "C1=C[N-]CC1"]),
    ("C1=NNNN1", ["C1=CNCC1", "C1=CC[NH+]=C1", "C1=NC[NH2+]CN1", "C1CSCSC1"]),
    ("C1=CNPC=C1", ["C1CN=NC1", "C1=CC[NH2+]C1", "C1=CSSC1"]),
    ("C1=NCNC=[NH+]1", ["C1=CCN=CC1", "C1=NCN=CO1", "C1=CNSCC1", "C1=NC[NH2+]CC1"]),
]


@pytest.mark.parametrize("centre,neis", RING_QUERIES)
def test_ring_neighbour_assembly_equals_jax(centre, neis):
    """``can_assemble`` against the reference's on ring neighbours, and
    ``enum_assemble``: its full list is the reference's, and its bounded
    search (``max_ncand=0``, the verdict's) finds that list's first entry."""
    from hierdiff_torch.chem.chemutils import can_assemble, enum_assemble
    from hierdiff_torch.chem.mol_tree import MolTreeNode
    from hierdiff_tpu.chem.chemutils import can_assemble as jax_can_assemble
    from hierdiff_tpu.chem.chemutils import enum_assemble as jax_enum_assemble
    from hierdiff_tpu.chem.mol_tree import MolTreeNode as JaxNode

    def query(cls):
        node = cls(centre, None)
        node.neighbors = [cls(s, None) for s in neis]
        return node

    verdict = can_assemble(query(MolTreeNode))
    assert verdict == jax_can_assemble(query(JaxNode))
    node, jnode = query(MolTreeNode), query(JaxNode)
    for i, (n, j) in enumerate(zip(node.neighbors, jnode.neighbors)):
        n.nid = j.nid = i
    got = enum_assemble(node, node.neighbors)
    want = jax_enum_assemble(jnode, jnode.neighbors)
    assert [(s, a) for s, _, a in got] == [(s, a) for s, _, a in want]
    assert bool(got) == verdict
    first = enum_assemble(node, node.neighbors, max_ncand=0)
    assert [(s, a) for s, _, a in first] == [(s, a) for s, _, a in got[:1]]


# --- 2. reconstruction ------------------------------------------------------------


def _port_trees(world):
    from hierdiff_torch.chem.mol_tree import MolTree

    return [MolTree(m, vocab=world["port"]["vocab"]) for m in world["port"]["mols"]]


def _jax_trees(world):
    from hierdiff_tpu.chem.mol_tree import MolTree

    return [MolTree(m, vocab=world["jax_vocab"]) for m in world["port"]["mols"]]


@pytest.mark.parametrize("memoize", [False, True])
def test_reconstructor_equals_jax(world, memoize):
    from hierdiff_torch.chem.reconstruct import TreeReconstructor
    from hierdiff_tpu.chem.reconstruct import TreeReconstructor as JaxReconstructor

    rec = TreeReconstructor(world["port"]["vocab"], memoize=memoize)
    jrec = JaxReconstructor(world["jax_vocab"], memoize=memoize)
    canon = []
    for pt, jt in zip(_port_trees(world), _jax_trees(world)):
        got, want = rec.reconstruct(pt), jrec.reconstruct(jt)
        assert isinstance(got, tuple) and isinstance(want, tuple)
        assert world["canon"](got[2]) == world["canon"](want[2])
        assert world["canon"](got[0]) == world["canon"](want[0])
        assert got[1] == want[1]
        canon.append(world["canon"](got[2]))
    assert tuple(canon) == chem_check.RECONSTRUCTED_FAKE
    assert rec.memo_stats == jrec.memo_stats
    if not memoize:
        assert chem_check.reconstructed_smiles() == list(chem_check.RECONSTRUCTED_FAKE)


@pytest.mark.parametrize("workers,memoize,fail_embed", [(0, False, False), (2, False, False),
                                                         (2, True, False), (0, False, True)])
def test_reconstruct_batch_equals_jax(world, fake, workers, memoize, fail_embed):
    from hierdiff_torch.chem.reconstruct import reconstruct_batch
    from hierdiff_tpu.chem.reconstruct import reconstruct_batch as jax_reconstruct_batch

    fake.FAIL_EMBED = fail_embed
    try:
        got, stats = reconstruct_batch(_port_trees(world)[:4], world["port"]["vocab"], workers,
                                       memoize=memoize)
        want, jstats = jax_reconstruct_batch(_jax_trees(world)[:4], world["jax_vocab"], workers,
                                             memoize=memoize)
    finally:
        fake.FAIL_EMBED = False
    assert stats == jstats
    assert [world["canon"](m[2]) for m in got] == [world["canon"](m[2]) for m in want]
    assert [m[1] for m in got] == [m[1] for m in want]
    if fail_embed:     # every tree 'max9': none attempted
        assert got == [] and stats["valid"] == 0.0
    else:
        assert stats["valid"] == 1.0


def test_tree_dict_to_moltree_equals_jax(world):
    from hierdiff_torch.chem.mol_tree import Vocab
    from hierdiff_tpu.chem.mol_tree import Vocab as JaxVocab

    v, jv = Vocab(), JaxVocab()
    rng = np.random.default_rng(2)
    t = SyntheticTreeGenerator(seed=3).sample_tree(6)
    d = {"wids": rng.choice(_small_wids(), size=6), "adj": t.adj + np.eye(6),
         "pos": t.pos, "feats": t.feats, "logp": -3.0}
    got = port_pipeline.tree_dict_to_moltree(d, v)
    want = jax_pipeline.tree_dict_to_moltree(d, jv)
    np.testing.assert_array_equal(got.adj_matrix, want.adj_matrix)
    assert [(n.smiles, n.wid, n.hbd, n.idx) for n in got.nodes] == \
        [(n.smiles, n.wid, n.hbd, n.idx) for n in want.nodes]
    assert [[m.idx for m in n.neighbors] for n in got.nodes] == \
        [[m.idx for m in n.neighbors] for n in want.nodes]


# --- 3. the gated searches ------------------------------------------------------


def _lattices(blur, small, seed: int):
    """Seeded lattices in the shape the expander reads: the BFS order of a
    random tree over each molecule's nodes, K_TOP distinct small fragments
    per step with decreasing log-probabilities."""
    rng = np.random.default_rng(seed)
    arrays = {}
    for i, b in enumerate(blur):
        n = b["h"].shape[0]
        parent = [0] + [int(rng.integers(j)) for j in range(1, n)]
        top_wid = np.stack([rng.choice(small, size=K_TOP, replace=False) for _ in range(n)])
        top_logp = -np.sort(rng.exponential(1.0, size=(n, K_TOP)), axis=1).astype(np.float32)
        arrays[i] = dict(focal=np.asarray(parent, np.int64), target=np.arange(n),
                         attach=np.arange(n) > 0, top_wid=top_wid.astype(np.int64),
                         top_logp=top_logp)
    return ({i: port_lattice.MoleculeLattice(**a) for i, a in arrays.items()},
            {i: jax_lattice.MoleculeLattice(**a) for i, a in arrays.items()})


@pytest.fixture(scope="module")
def searches(fake):
    """Blur sets, seeded lattices, both gates over the real vocabulary, and
    a tiny refine model in both frameworks (one JAX compile per program)."""
    from hierdiff_torch.chem.assemble_gate import make_assembly_gate
    from hierdiff_torch.chem.mol_tree import Vocab
    from hierdiff_tpu.chem.assemble_gate import make_assembly_gate as jax_gate
    from hierdiff_tpu.chem.mol_tree import Vocab as JaxVocab

    gen = SyntheticTreeGenerator(seed=12)
    blur = [{"x": t.pos.astype(np.float32), "h": t.feats.astype(np.float32)}
            for t in (gen.sample_tree(n) for n in SEARCH_SIZES)]
    small = _small_wids()
    lattices, jlattices = _lattices(blur, small, seed=4)
    model = NodeRefine(hidden_size=16, n_layers=1)
    batch = {k: jnp.asarray(v) for k, v in
             make_refine_batch(gen.sample_trees(2, n=6), random.Random(1), max_n=8).items()}
    params = jax.jit(model.init)(jax.random.PRNGKey(1), batch)
    port = PortRefine(hidden_size=16, n_layers=1)
    port.load_state_dict(port_weights.refine_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    vocab, jvocab = Vocab(), JaxVocab()
    return {"blur": blur, "lattices": lattices, "jax_lattices": jlattices,
            "gate": make_assembly_gate(vocab), "jax_gate": jax_gate(jvocab),
            "refine": (model, params, port.eval()),
            "sizes": np.asarray(vocab.mol_sizes)}


def _same_trees(got, want):
    assert len(got) == len(want)
    for g, r in zip(got, want):
        assert (g is None) == (r is None)
        if r is not None:
            np.testing.assert_array_equal(g.wids, r.wids)
            np.testing.assert_array_equal(g.adj, r.adj)
            assert abs(g.logp - r.logp) <= 1e-6 * max(1.0, abs(r.logp))


@pytest.mark.parametrize("refine", [False, True])
def test_gated_search_equals_jax(searches, refine):
    """The port's gated search over the lattices is JAX's Python search
    with JAX's gate, tree for tree; refine on, the gate also sits in both
    hooks (their swaps and their final repair)."""
    s = searches
    jhook = phook = None
    if refine:
        model, params, port = s["refine"]
        jhook = JaxHook(model, params, s["sizes"], check_frac=0.5, buckets=(NB,),
                        can_assemble=s["jax_gate"])
        phook = PortHook(port, s["sizes"], check_frac=0.5, buckets=(NB,),
                         can_assemble=s["gate"])
    jsampler = jax_lattice.LatticeSampler(EdgeDenoise(hidden_nf=16), None, beam_size=3,
                                          can_assemble=s["jax_gate"], refine_hook=jhook,
                                          rng=random.Random(7), native_search=False,
                                          buckets=(NB,), refine_group_cap=0)
    psampler = port_lattice.LatticeSampler(PortDenoise(hidden_nf=16), beam_size=3,
                                           can_assemble=s["gate"], refine_hook=phook,
                                           rng=random.Random(7), buckets=(NB,),
                                           refine_group_cap=0, native_search=False)
    with jax.default_matmul_precision("highest"):
        want = jsampler._search(s["blur"], s["jax_lattices"])
        if refine:
            want = [jhook.finalize(t) if t is not None else None for t in want]
    got = psampler._search(s["blur"], s["lattices"])
    if refine:
        got = [phook.finalize(t) if t is not None else None for t in got]
        assert phook.stats["score_calls"] == jhook.stats["score_calls"] > 0
    _same_trees(got, want)
    assert any(t is not None for t in got)
    assert s["gate"].cache_info().currsize > 0
    for t in got:
        if t is not None:
            assert all(s["gate"](t, i) for i in range(t.n))


def test_native_gated_search_equals_jax(searches):
    """The native gated search (the gate's memoized verdict called back
    from C++) over the same lattices is JAX's Python search with JAX's gate,
    tree for tree, and leaves the tiebreak stream where JAX's leaves it."""
    s = searches
    jrng, prng = random.Random(7), random.Random(7)
    jsampler = jax_lattice.LatticeSampler(EdgeDenoise(hidden_nf=16), None, beam_size=3,
                                          can_assemble=s["jax_gate"], rng=jrng,
                                          native_search=False, buckets=(NB,))
    psampler = port_lattice.LatticeSampler(PortDenoise(hidden_nf=16), beam_size=3,
                                           can_assemble=s["gate"], rng=prng, buckets=(NB,))
    with jax.default_matmul_precision("highest"):
        want = jsampler._search(s["blur"], s["jax_lattices"])
    hits = s["gate"].cache_info().hits + s["gate"].cache_info().misses
    got = psampler._search(s["blur"], s["lattices"])
    assert s["gate"].cache_info().hits + s["gate"].cache_info().misses > hits
    _same_trees(got, want)
    assert any(t is not None for t in got)
    assert prng.getstate() == jrng.getstate()


# --- 4. the pipeline and the CLIs -------------------------------------------------


def test_pipeline_reconstructs_the_trees_it_assembled(fake):
    from hierdiff_torch.chem.assemble_gate import make_assembly_gate
    from hierdiff_torch.chem.mol_tree import Vocab
    from hierdiff_torch.chem.reconstruct import reconstruct_batch
    from hierdiff_torch.config import CoarseModelConfig

    coarse = port_weights.init_weights(
        port_cli.build_coarse_from_cfg(CoarseModelConfig(hidden_nf=16, n_layers=1,
                                                         timesteps=10), "float32", "cpu"),
        torch.Generator().manual_seed(0))
    denoise = port_weights.init_weights(PortDenoise(hidden_nf=16, n_layers_full=1,
                                                    n_layers_focal=1),
                                        torch.Generator().manual_seed(1)).eval()
    vocab = Vocab()
    gate = make_assembly_gate(vocab)
    pipe = port_pipeline.GenerationPipeline(coarse, denoise, {2: 1}, beam_size=2,
                                            sample_steps=3, vocab=vocab, can_assemble=gate)
    result = pipe.run(5, 4, reconstruct=True)
    assert set(result.stats) == {"t_coarse", "t_fine", "t_reconstruct", "valid", "unique",
                                 "avg_atoms"}
    trees = [t for t in result.trees if t is not None]
    assert trees and gate.cache_info().currsize > 0
    want, stats = reconstruct_batch([port_pipeline.tree_state_to_moltree(t, vocab)
                                     for t in trees], vocab)
    assert {k: result.stats[k] for k in stats} == stats
    assert [Chem_smiles(m) for m in result.molecules] == [Chem_smiles(m) for m in want]
    plain = pipe.run(5, 4, reconstruct=False)
    assert plain.molecules is None and set(plain.stats) == {"t_coarse", "t_fine"}


def Chem_smiles(molecule) -> str:
    from rdkit import Chem

    return Chem.MolToSmiles(molecule[2])


def _jax_tree_pickle(world, path):
    """A trees pickle in the JAX CLI's layout (``_tree_to_dict``) over the
    six test molecules' trees, with one tree missing."""
    from hierdiff_tpu.sampling.cli import _tree_to_dict

    states = []
    for t in world["jax_trees"]:
        n = len(t.nodes)
        feats = np.zeros((n, 8), np.float32)
        feats[:, 0] = [nd.hbd for nd in t.nodes]
        states.append(jax_beam.TreeState(feats, np.stack([nd.pos for nd in t.nodes]),
                                         t.adj_matrix.astype(np.float32),
                                         np.asarray([nd.wid for nd in t.nodes]), -1.0))
    with open(path, "wb") as f:
        pickle.dump({"trees": [_tree_to_dict(s) for s in states] + [None]}, f)


def test_reconstruct_cli_equals_the_jax_cli(world, tmp_path, monkeypatch):
    """``sampling.cli reconstruct`` on a trees pickle in the JAX layout gives
    the JAX CLI's molecules and stats; without RDKit it raises. Each CLI
    builds the full vocabulary, so the test molecules' fragment ids are
    mapped into it first."""
    from hierdiff_torch.chem.mol_tree import Vocab
    from hierdiff_tpu.sampling import cli as jax_cli

    from rdkit import Chem

    # the harness writes some fragments otherwise than the vocabulary's
    # strings: map each through its canonical form
    full = Vocab()
    canon = {Chem.MolToSmiles(Chem.MolFromSmiles(s), kekuleSmiles=True): i
             for i, s in enumerate(full.vocab)}
    for t in world["jax_trees"]:
        for nd in t.nodes:
            nd.wid = canon[Chem.MolToSmiles(Chem.MolFromSmiles(nd.smiles), kekuleSmiles=True)]
    trees, out, jout = tmp_path / "trees.pkl", tmp_path / "rec.pkl", tmp_path / "jrec.pkl"
    _jax_tree_pickle(world, trees)
    got = port_cli.main(["reconstruct", "--trees-pkl", str(trees), "--out", str(out)])
    jax_cli.main(["reconstruct", "--trees-pkl", str(trees), "--out", str(jout)])
    with open(out, "rb") as f:
        payload = pickle.load(f)
    with open(jout, "rb") as f:
        want = pickle.load(f)
    assert set(payload) == set(want) == {"molecules", "stats"}
    assert payload["stats"] == want["stats"] == got["stats"]
    assert [Chem_smiles(m) for m in payload["molecules"]] == \
        [Chem_smiles(m) for m in want["molecules"]]
    monkeypatch.setattr("hierdiff_torch.chem.has_rdkit", lambda: False)
    with pytest.raises(RDKitUnavailable):
        port_cli.main(["reconstruct", "--trees-pkl", str(trees), "--out", str(out)])


@pytest.mark.parametrize("workers", [0, 2])
def test_generate_cli_writes_molecules_in_the_jax_layout(tmp_path, capsys, workers):
    out = tmp_path / "gen.pkl"
    run = port_cli.main(["generate", "--init-seed", "0", "--denoise-init-seed", "0",
                         "--refine-init-seed", "0", "--device", "cpu", "--num", "4",
                         "--sample-steps", "3", "--max-nodes", "2", "--beam", "2",
                         "--workers", str(workers), "--out", str(out), *TINY])
    with open(out, "rb") as f:
        payload = pickle.load(f)
    assert set(payload) == {"trees", "molecules", "stats"}
    assert set(payload["stats"]) == {"t_coarse", "t_fine", "t_reconstruct", "valid",
                                     "unique", "avg_atoms"}
    done = [d for d in payload["trees"] if d is not None]
    assert done and len(payload["molecules"]) <= len(done)
    for d in done:
        assert set(d) == {"wids", "adj", "pos", "feats", "logp"}
    pipe = run["pipeline"]
    assert pipe.sampler.can_assemble is pipe.sampler.refine_hook.can_assemble is not None
    text = capsys.readouterr().out
    assert "reconstruction: {" in text and "assembly gate:" in text
    # the same trees through `reconstruct`: the same molecules and stats
    again = port_cli.main(["reconstruct", "--trees-pkl", str(out), "--workers", str(workers),
                           "--out", str(tmp_path / "rec.pkl")])
    assert {k: payload["stats"][k] for k in again["stats"]} == again["stats"]
    assert [Chem_smiles(m) for m in again["molecules"]] == \
        [Chem_smiles(m) for m in payload["molecules"]]


# --- 5. evaluation -------------------------------------------------------------------


def test_eval_panel_and_cli_equal_jax(world, tmp_path):
    """``evaluate`` and ``eval.cli`` on the reconstructed molecules against
    JAX's, every float within 1e-12; ``node_freq`` through the port's
    MolTree."""
    import hierdiff_torch.eval.metrics as M
    import hierdiff_tpu.eval.metrics as JM
    from hierdiff_torch.chem.reconstruct import reconstruct_batch
    from hierdiff_torch.eval.cli import evaluate
    from hierdiff_torch.eval.cli import main as eval_main
    from hierdiff_tpu.eval.cli import evaluate as jax_evaluate
    from hierdiff_tpu.eval.cli import main as jax_eval_main

    molecules, _ = reconstruct_batch(_port_trees(world), world["port"]["vocab"])
    mols = [m for m, _, _ in molecules]
    refs = world["port"]["mols"]
    got, want = evaluate(mols, refs), jax_evaluate(mols, refs)
    assert set(got) == set(want) and "max_fp_similarity_mean" in got
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=0, abs=1e-12), k
    freq, fp = M.node_freq(refs, world["port"]["vocab"])
    jfreq, jfp = JM.node_freq(refs, world["jax_vocab"])
    np.testing.assert_array_equal(freq, jfreq)
    np.testing.assert_array_equal(fp, jfp)
    x = np.random.default_rng(0).standard_normal((30, 3))
    assert M.mmd_rbf(x, x[::-1] + 0.1, step=7) == JM.mmd_rbf(x, x[::-1] + 0.1, step=7)

    gen = tmp_path / "generated.pkl"
    with open(gen, "wb") as f:
        pickle.dump({"molecules": molecules}, f)
    out, jout = tmp_path / "m.json", tmp_path / "j.json"
    eval_main([str(gen), "--ref", str(gen), "--out", str(out)])
    jax_eval_main([str(gen), "--ref", str(gen), "--out", str(jout)])
    got, want = json.loads(out.read_text()), json.loads(jout.read_text())
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=0, abs=1e-12), k
