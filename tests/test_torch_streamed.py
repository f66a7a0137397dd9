"""The port's overlapped pipeline: ``GenerationPipeline.run`` with and
without ``overlap`` (``_BlurFeeder`` into ``LatticeSampler.sample_streamed``)
and ``run_streamed`` (reconstruction in a process pool) on the CPU, at a
tiny size (coarse hidden 16 x 1 layer, 10 timesteps; denoise and refine
hidden 16, 1 + 1 layers)."""

import contextlib
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import fake_rdkit  # noqa: E402

from hierdiff_torch import runtime as port_runtime  # noqa: E402
from hierdiff_torch.config import CoarseModelConfig  # noqa: E402
from hierdiff_torch.data import assets as port_assets  # noqa: E402
from hierdiff_torch.models.edge_denoise import EdgeDenoise as PortDenoise  # noqa: E402
from hierdiff_torch.models.refine import NodeRefine as PortRefine  # noqa: E402
from hierdiff_torch.sampling import cli as port_cli  # noqa: E402
from hierdiff_torch.sampling import pipeline as port_pipeline  # noqa: E402
from hierdiff_torch.sampling.refine_hook import RefineHook  # noqa: E402
from hierdiff_torch.tools.overlap_ab import serial_stages  # noqa: E402
from hierdiff_torch.utils import weights as port_weights  # noqa: E402

SMALL_ROWS = 4
HISTOGRAM = {2: 1, 4: 1, 6: 1, 9: 1, 12: 1}   # node counts over several pad buckets


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _SmallHook(RefineHook):
    """Fused checks of at most SMALL_ROWS rows, so that the CPU keeps up."""

    def fleet_chunk_rows(self, nb: int) -> int:
        return min(super().fleet_chunk_rows(nb), SMALL_ROWS)


def _models():
    coarse = port_weights.init_weights(
        port_cli.build_coarse_from_cfg(CoarseModelConfig(hidden_nf=16, n_layers=1, timesteps=10),
                                       "float32", "cpu"), torch.Generator().manual_seed(0))
    denoise = port_weights.init_weights(
        PortDenoise(hidden_nf=16, n_layers_full=1, n_layers_focal=1),
        torch.Generator().manual_seed(1)).eval()
    refine = port_weights.init_weights(PortRefine(hidden_size=16, n_layers=1),
                                       torch.Generator().manual_seed(2)).eval()
    return coarse, denoise, refine


def _pipe(refine_on: bool, **kw):
    coarse, denoise, refine = _models()
    hook = None
    if refine_on:
        hook = _SmallHook(refine, np.asarray(port_assets.vocab_mol_sizes()), check_frac=0.5)
    return port_pipeline.GenerationPipeline(coarse, denoise, HISTOGRAM, beam_size=2,
                                            sample_steps=4, refine_hook=hook, **kw)


@pytest.mark.parametrize("refine_on", [False, True])
def test_overlapped_run_is_the_serial_run(refine_on):
    """The same point sets bit for bit (the chunk plan and seeds are
    shared) and the same trees: every bucket's molecules arrive in one
    coarse chunk here, so the lattices run at the serial batch shapes."""
    pipe = _pipe(refine_on)
    serial = pipe.run(3, 12, overlap=False)
    hook = pipe.sampler.refine_hook
    serial_stats = None if hook is None else dict(hook.stats)
    overlapped = pipe.run(3, 12)                     # the default: overlapped
    assert set(overlapped.stats) == set(serial.stats) == {"t_coarse", "t_fine"}
    assert len(pipe._plan_chunks(np.array([b["h"].shape[0] for b in serial.blur]))) > 1
    for a, b in zip(overlapped.blur, serial.blur):
        np.testing.assert_array_equal(a["x"], b["x"])
        np.testing.assert_array_equal(a["h"], b["h"])
    assert any(t is not None for t in serial.trees)
    for a, b in zip(overlapped.trees, serial.trees):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.wids, b.wids)
            np.testing.assert_array_equal(a.adj, b.adj)
            assert a.logp == b.logp
    if hook is not None:
        assert serial_stats["rounds"] > 0 and hook.stats["rounds"] == 2 * serial_stats["rounds"]


def test_feeder_keeps_the_serial_chunk_plan():
    pipe = _pipe(False)
    counts = np.array([2, 6, 9, 14, 18] * 8)             # 4 pad buckets: 4 coarse chunks
    feeder = port_pipeline._BlurFeeder(pipe, 3, counts)
    assert feeder.chunks == pipe._plan_chunks(counts) and len(feeder.chunks) > 2
    assert len(feeder.inflight) == feeder.pos == port_pipeline.COARSE_INFLIGHT
    got = []
    while not feeder.done:
        got += feeder.pump() or feeder.collect_next()
    assert [sorted(c) for c in got] == [sorted(c) for _, c in feeder.chunks]
    want = pipe._blur_for_counts(3, counts)
    for a, b in zip(feeder.blur, want):
        np.testing.assert_array_equal(a["x"], b["x"])
    assert feeder.t_last_coarse is not None


def test_generate_cli_overlap_flag(tmp_path, capsys, monkeypatch):
    """``generate`` has no overlap flag: it always overlaps, and writes the
    trees of its stages run one after the other (``serial_stages``)."""
    tiny = ["denoise.hidden_nf=16", "denoise.n_layers_full=1", "denoise.n_layers_focal=1",
            "coarse.hidden_nf=16", "coarse.n_layers=1"]
    argv = ["generate", "--init-seed", "0", "--denoise-init-seed", "0", "--device", "cpu",
            "--num", "5", "--sample-steps", "3", "--max-nodes", "7", "--beam", "2", *tiny]
    with pytest.raises(SystemExit):
        port_cli.main(argv + ["--no-overlap", "--out", str(tmp_path / "refused.pkl")])
    feeders = []
    feeder = port_pipeline._BlurFeeder
    monkeypatch.setattr(port_pipeline, "_BlurFeeder", lambda *a: feeders.append(1) or feeder(*a))
    run, trees = port_pipeline.GenerationPipeline.run, {}
    for mode in ("on", "off"):
        out = tmp_path / f"gen_{mode}.pkl"
        with serial_stages() if mode == "off" else contextlib.nullcontext():
            port_cli.main(argv + ["--out", str(out)])
        assert len(feeders) == 1                     # only the overlapped run fed chunks
        with open(out, "rb") as f:
            trees[mode] = pickle.load(f)["trees"]
    assert port_pipeline.GenerationPipeline.run is run              # restored after the block
    assert len(trees["on"]) == len(trees["off"]) == 5
    assert any(t is not None for t in trees["on"])
    for a, b in zip(trees["on"], trees["off"]):
        assert (a is None) == (b is None)
        if a is None:
            continue
        np.testing.assert_array_equal(a["wids"], b["wids"])
        np.testing.assert_array_equal(a["adj"], b["adj"])
        assert a["logp"] == b["logp"]


@pytest.fixture
def harness():
    fake_rdkit.install()
    yield fake_rdkit
    fake_rdkit.uninstall()


@pytest.mark.skipif(not port_runtime.treekit_available(),
                    reason="no C++ compiler: treekit is not built")
def test_run_streamed_reconstructs_in_a_pool(harness):
    """``run_streamed`` under the fake-RDKit harness on trees of at most 2
    nodes (the harness's chemistry is exponential in a node's degree, and
    random weights pick large ring fragments):
    every macro-chunk's trees, the molecules the pool made of them equal to
    an in-process reconstruction of the same trees, and the panel's keys
    beside ``t_device``."""
    from hierdiff_torch.chem.assemble_gate import make_assembly_gate
    from hierdiff_torch.chem.mol_tree import Vocab
    from hierdiff_torch.chem.reconstruct import reconstruct_batch

    vocab = Vocab()
    pipe = _pipe(False, max_n_cap=2, vocab=vocab, can_assemble=make_assembly_gate(vocab))
    out = pipe.run_streamed(7, 5, chunk_size=2, n_workers=2)
    assert len(out.trees) == len(out.blur) == 5
    assert {"valid", "unique", "avg_atoms", "t_device", "t_total"} <= set(out.stats)
    done = [t for t in out.trees if t is not None]
    assert done and out.molecules is not None and len(out.molecules) <= len(done)
    want, stats = reconstruct_batch([port_pipeline.tree_state_to_moltree(t, vocab)
                                     for t in done], vocab)
    assert {k: out.stats[k] for k in stats} == stats
    # the chunks draw their counts from one stream: chunk k's seed differs
    assert len({b["x"].tobytes() for b in out.blur}) == 5
