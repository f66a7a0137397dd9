"""The port's chemistry tools and run utilities against the JAX package:
``chem/mff_rmsd.py`` and ``chem/preprocess.py`` under the fake-RDKit
harness (``tests/fake_rdkit.py``), on chem_check's six molecules over a
vocabulary of their own fragments; ``utils/log.py``, ``utils/profiling.py``
and ``utils/cache.py`` on the CPU.

The harness's chemistry is deterministic and both packages run the same
numpy arithmetic on it, so the RMSDs, the lifted conformer and the written
``.npz`` trees must be equal exactly.
"""

import dataclasses
import json
import pickle
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
import fake_rdkit  # noqa: E402

from hierdiff_torch.chem import mff_rmsd, preprocess  # noqa: E402
from hierdiff_torch.tools import chem_check  # noqa: E402
from hierdiff_tpu.chem import mff_rmsd as jax_mff  # noqa: E402
from hierdiff_tpu.chem import preprocess as jax_pre  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CONFIGS = REPO / "configs"


@pytest.fixture(scope="module")
def world():
    """The harness for the module; chem_check's molecules, the port's Vocab
    and trees of their fragments, and the JAX package's Vocab and trees of
    the same fragments and fingerprints."""
    fake_rdkit.install()
    from hierdiff_tpu.chem.mol_tree import MolTree as JaxMolTree
    from hierdiff_tpu.chem.mol_tree import Vocab as JaxVocab

    port = chem_check.mini_world()
    jvocab = JaxVocab(port["frag"], {s: port["vocab"].get_fp(s) for s in port["frag"]},
                      mode="prop")
    yield {**port, "jax_vocab": jvocab,
           "jax_trees": [JaxMolTree(m, vocab=jvocab) for m in port["mols"]]}
    fake_rdkit.uninstall()


# --- chem/mff_rmsd.py -----------------------------------------------------------


@pytest.mark.parametrize("edges", [[(0, 2), (2, 1), (2, 3), (3, 4)],
                                   [(0, 5), (5, 1), (1, 2), (0, 3), (3, 4), (4, 6)]])
def test_bfs_order_equals_jax(edges):
    """tests/test_chem.py:80's tree, and a deeper one."""
    n = 1 + max(max(e) for e in edges)
    adj = np.zeros((n, n))
    for a, b in edges:
        adj[a, b] = adj[b, a] = 1
    order = mff_rmsd.bfs_order_from_edges(np.nonzero(adj), n)
    assert order == jax_mff.bfs_order_from_edges(np.nonzero(adj), n)
    assert order[0] == 0 and sorted(order) == list(range(n))


def test_rmsds_equal_jax(world):
    """tests/test_fake_chem.py:527-536 on each package: base_rmsd of an
    embedded molecule, and the RMSD of a molecule against itself."""
    from rdkit.Chem import AllChem

    from hierdiff_torch.chem.chemutils import get_mol

    m = get_mol(chem_check.TEST_SMILES[0])
    AllChem.EmbedMolecule(m)
    out = mff_rmsd.base_rmsd(m, world["vocab"])
    assert out == jax_mff.base_rmsd(m, world["jax_vocab"])
    assert out is not None and out["tree"] >= 0 and out["mol"] > 0
    assert mff_rmsd.mol_rmsd(m, m) == pytest.approx(0.0, abs=1e-9)
    assert mff_rmsd.tree_center_rmsd(m, m, world["vocab"]) == pytest.approx(0.0, abs=1e-6)


def test_set_rmsd_lift_equals_jax(world):
    """tests/test_fake_chem.py:511-523: the first tree reconstructed and
    lifted to atoms by each package; the same conformer."""
    from hierdiff_torch.chem.mol_tree import MolTree
    from hierdiff_torch.chem.reconstruct import TreeReconstructor
    from hierdiff_tpu.chem.mol_tree import MolTree as JaxMolTree
    from hierdiff_tpu.chem.reconstruct import TreeReconstructor as JaxReconstructor

    m = world["mols"][0]
    lifted = []
    for tree_cls, rec_cls, lift, vocab in (
            (MolTree, TreeReconstructor, mff_rmsd.set_rmsd, world["vocab"]),
            (JaxMolTree, JaxReconstructor, jax_mff.set_rmsd, world["jax_vocab"])):
        tree = tree_cls(m, vocab=vocab)      # set_rmsd reassigns the tree's cliques
        mol, amap, _ = rec_cls(vocab).reconstruct(tree)
        out = lift(mol, amap[1: len(tree.nodes) + 1], tree)
        assert out is not None and out.GetNumConformers() == 1
        lifted.append(out.GetConformer().GetPositions())
    assert np.isfinite(lifted[0]).all()
    np.testing.assert_array_equal(lifted[0], lifted[1])


# --- chem/preprocess.py ---------------------------------------------------------


def _npz_dir(path: Path) -> dict:
    out = {}
    for p in sorted(path.glob("*.npz")):
        with np.load(p) as z:
            out[p.name] = {k: z[k] for k in z.files}
    return out


def _same_dirs(mine: Path, theirs: Path, count: int) -> None:
    a, b = _npz_dir(mine), _npz_dir(theirs)
    assert sorted(a) == sorted(b) and len(a) == count
    for name in a:
        assert a[name].keys() == b[name].keys() == {"feats", "pos", "adj", "wids", "sizes"}
        for k in a[name]:
            assert a[name][k].dtype == b[name][k].dtype, (name, k)
            np.testing.assert_array_equal(a[name][k], b[name][k])


def test_featurize_tree_equals_jax(world):
    for mode in ("prop", "elem"):
        for tree, jtree in zip(world["trees"], world["jax_trees"]):
            mine = preprocess.featurize_tree(tree, world["vocab"], mode)
            theirs = jax_pre.featurize_tree(jtree, world["jax_vocab"], mode)
            for a, b in zip(mine, theirs):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_written_trees_equal_jax_and_feed_training(world, tmp_path, monkeypatch):
    """process_sdf, main --sdf and process_geom (its conformer shuffle seeded
    the same for both) write the JAX package's .npz trees, array for array;
    ``load_tree_pool`` reads the port's back."""
    from rdkit import Chem

    from hierdiff_torch.config import load_config
    from hierdiff_torch.train.data_iters import load_tree_pool

    monkeypatch.setattr(preprocess, "Vocab", lambda: world["vocab"])
    monkeypatch.setattr(jax_pre, "Vocab", lambda: world["jax_vocab"])
    mols = world["mols"]
    sdf = tmp_path / "mols.sdf"
    sdf.write_text("".join(Chem.MolToMolBlock(m) + "$$$$\n" for m in mols))
    geom = tmp_path / "geom"
    geom.mkdir()
    for i in range(3):
        with open(geom / f"m{i}.pkl", "wb") as f:
            pickle.dump({"conformers": [{"rd_mol": mols[i]}, {"rd_mol": mols[i + 3]}]}, f)

    for name, run in (("sdf", lambda mod, out: mod.process_sdf(str(sdf), str(out))),
                      ("main", lambda mod, out: mod.main(["--sdf", str(sdf), "--out", str(out),
                                                          "--mode", "elem"])),
                      ("geom", lambda mod, out: mod.process_geom(str(geom), str(out),
                                                                 max_confs=1))):
        for mod, who in ((preprocess, "port"), (jax_pre, "jax")):
            random.seed(5)
            run(mod, tmp_path / f"{name}-{who}")
        _same_dirs(tmp_path / f"{name}-port", tmp_path / f"{name}-jax",
                   3 if name == "geom" else len(mols))

    cfg = load_config(None, [f"train.data={tmp_path / 'sdf-port'}"])
    pool = load_tree_pool(cfg)
    written = _npz_dir(tmp_path / "sdf-port")
    assert len(pool) == len(written)
    for tree, arrays in zip(pool, written.values()):
        np.testing.assert_array_equal(tree.feats, arrays["feats"])
        np.testing.assert_array_equal(tree.adj, arrays["adj"])


def test_preprocess_cli_without_rdkit_fails_cleanly(tmp_path):
    """``python -m hierdiff_torch.chem.preprocess`` without RDKit stops with
    the gating error (tests/test_runbook.py:68 for the JAX package)."""
    r = subprocess.run([sys.executable, "-m", "hierdiff_torch.chem.preprocess", "--sdf",
                        str(tmp_path / "x.sdf"), "--out", str(tmp_path / "out")], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "RDKit is required" in r.stdout + r.stderr


# --- utils: log, profiling, cache -----------------------------------------------


@pytest.mark.parametrize("name", ["coarse_geom.yaml", "denoise_geom.yaml", "refine_geom.yaml"])
def test_print_config_body_parses_as_jax(name, capsys):
    """The box's body reads back (PyYAML, here only) to the JAX package's
    body: the same dict, less the TPU-only keys the port does not hold."""
    import yaml

    from hierdiff_torch.config import IGNORED_COARSE_KEYS, load_config
    from hierdiff_torch.utils.log import print_config
    from hierdiff_tpu.config import load_config as jax_load_config
    from hierdiff_tpu.utils.log import print_config as jax_print_config

    def body(text):
        lines = text.splitlines()
        assert lines[0].startswith("+-- Config ") and set(lines[-1]) == {"+", "-"}
        return "\n".join(ln[2:-2] for ln in lines[1:-1])

    cfg = load_config(str(CONFIGS / name))
    text = print_config(cfg)
    assert capsys.readouterr().out == text + "\n"
    mine = body(text)
    theirs = yaml.safe_load(body(jax_print_config(jax_load_config(str(CONFIGS / name)))))
    for k in IGNORED_COARSE_KEYS:
        del theirs["coarse"][k]
    assert yaml.safe_load(mine) == theirs == json.loads(json.dumps(dataclasses.asdict(cfg)))


def test_timed_and_profile_trace_on_cpu(tmp_path, capsys):
    from hierdiff_torch.ops import _build
    from hierdiff_torch.utils import profile_trace, timed
    from hierdiff_torch.utils.cache import enable_compilation_cache
    from hierdiff_torch.utils.log import device_memory_stats, log_device_stats

    with profile_trace(str(tmp_path / "trace")) as prof:
        with timed("matmul", verbose=True) as t:
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert t.seconds is not None and t.seconds >= 0
    assert "[timed] matmul:" in capsys.readouterr().out
    traces = list((tmp_path / "trace").glob("trace-*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert any("mm" in a.key for a in prof.key_averages())
    assert device_memory_stats("cpu") is None
    log_device_stats()
    assert capsys.readouterr().out.startswith("[mem] ")
    assert enable_compilation_cache() == str(_build.BUILD_DIR)
