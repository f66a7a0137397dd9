"""Data parallelism of the PyTorch port (hierdiff_torch/parallel/mesh.py and
its users) on the CPU: gloo groups of 2 ranks, spawned by ``mesh.spawn``.

A world-2 training step of each stage is held to the single-process step on
the same global batch (the coarse loss with its draws injected, as in
tests/test_torch_train.py); the ratio metrics to the JAX loss's global ratio;
the train CLI to one workdir written once and a resume; ``generate`` and
``assemble`` at world 2 to the world-1 point sets and trees bit for bit,
refine off and on; the dry run's three checks; a failing rank to an error.

The functions that run in the ranks are module-level (they cross to the
spawned processes by pickling) and use no JAX: a rank imports this module
but not JAX, which the one JAX comparison imports where it runs.
"""

import csv
import json
import pickle
import random
import socket
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hierdiff_torch import entry
from hierdiff_torch.config import OptimConfig, load_config
from hierdiff_torch.data.denoise import make_denoise_batch
from hierdiff_torch.data.synthetic import SyntheticTreeGenerator
from hierdiff_torch.ops.masked import combine_noise
from hierdiff_torch.parallel import mesh
from hierdiff_torch.parallel.train_step import TrainState, train_step
from hierdiff_torch.sampling import cli as sample_cli
from hierdiff_torch.sampling.refine_hook import RefineHook
from hierdiff_torch.train import cli as train_cli
from hierdiff_torch.train.data_iters import coarse_iter, load_tree_pool, refine_iter
from hierdiff_torch.utils.weights import init_weights

REPO = Path(__file__).resolve().parent.parent
SIZE = 2
SMALL = ["coarse.hidden_nf=16", "coarse.n_layers=1", "denoise.hidden_nf=16",
         "denoise.n_layers_full=1", "denoise.n_layers_focal=1", "refine.hidden_size=16",
         "refine.n_layers=1", "train.buckets=[8,12]", "train.num_train_trees=24",
         "train.batch_size=4"]
# the update rule of the step comparison: plain SGD without clipping, so the
# parameters after the step differ from the single-process step by the
# rounding of the two-shard gradient sum alone (Adam would turn the rounding
# of near-zero gradients into steps of ~lr)
SGD = OptimConfig(optimizer="sgd", lr=1e-2, grad_clip=None, ema_decay=0.999)
PARAM_REL, PARAM_FLOOR = 1e-6, 1e-3
# the coarse step runs a fixed noise schedule: the learned gamma network's
# gradients cancel in float32 to rounding level (reversing the batch's rows
# moves them as much as splitting it does), which no parameter bar can hold
STAGES = {"coarse": ["coarse.noise_schedule=polynomial_2"], "denoise": [], "refine": []}
SMALL_ROWS = 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # the ranks run one torch thread; so does the single-process side, so
    # that CPU products split their sums the same way
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _params(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


# --- 1. shards and gathers ---------------------------------------------------------


def test_shard_batch_keeps_contiguous_rows_and_refuses_uneven_splits():
    batch = {"a": np.arange(12).reshape(6, 2), "b": np.arange(6)}
    shards = [mesh.shard_batch(batch, r, 3) for r in range(3)]
    for k in batch:
        np.testing.assert_array_equal(np.concatenate([s[k] for s in shards]), batch[k])
    np.testing.assert_array_equal(shards[1]["b"], [2, 3])
    with pytest.raises(ValueError, match="do not split"):
        mesh.shard_batch(batch, 0, 4)
    assert mesh.world() == (0, 1) and not mesh.in_group()
    assert mesh.my_share(list(range(5))) == list(range(5))
    assert mesh.all_gather_dict({3: "c", 1: "a"}) == {3: "c", 1: "a"}
    assert mesh.rank_seed(7, 0) == 7 and mesh.rank_seed(7, 1) != 7


def _share_rank(items):
    return mesh.my_share(items), mesh.all_gather_dict({i: i * i for i in mesh.my_share(items)})


def test_spawned_shares_partition_the_plan_and_gather_in_index_order(tmp_path):
    out = mesh.spawn(_share_rank, SIZE, "gloo", init_file=str(tmp_path / "rdzv"),
                     args=(list(range(7)),))
    assert [share for share, _ in out] == [[0, 2, 4, 6], [1, 3, 5]]
    for _, gathered in out:
        assert list(gathered.items()) == [(i, i * i) for i in range(7)]


def _failing_rank():
    if mesh.world()[0] == 1:
        raise ValueError("planted failure in rank 1")
    torch.distributed.barrier()   # rank 0 waits on the dead rank


def test_a_failing_rank_raises_instead_of_hanging(tmp_path):
    with pytest.raises(RuntimeError, match="planted failure in rank 1"):
        mesh.spawn(_failing_rank, SIZE, "gloo", init_file=str(tmp_path / "rdzv"), timeout=120)


def test_initialize_multihost_joins_at_a_coordinator():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    try:
        device = mesh.initialize_multihost(f"127.0.0.1:{port}", 1, 0, device="cpu")
        assert device == torch.device("cpu") and mesh.world() == (0, 1) and mesh.in_group()
        assert torch.distributed.get_backend() == "gloo"
    finally:
        torch.distributed.destroy_process_group()
    assert not mesh.in_group()


def _in_world_one_group(tmp_path, fn):
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdzv1'}",
                                         rank=0, world_size=1)
    try:
        return fn()
    finally:
        torch.distributed.destroy_process_group()


def test_a_rank_of_a_group_works_on_its_current_card(tmp_path, monkeypatch):
    # a spawned rank's set_device holds for its main thread only: the device
    # a CLI hands to the prefetch thread must carry the card's index
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    device, spawned = _in_world_one_group(
        tmp_path, lambda: mesh.run_cli_ranks(lambda argv: None, [], torch.device("cuda")))
    assert device == torch.device("cuda", 1) and spawned is None
    assert mesh.rank_device(torch.device("cuda", 2)) == torch.device("cuda", 2)
    assert mesh.rank_device(torch.device("cpu")) == torch.device("cpu")


# --- 2. one world-2 step of each stage against the single-process step -------------


def _model(stage, cfg, state):
    build = train_cli.BUILDERS[stage][0]
    model = build(cfg, torch.device("cpu")).train()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return model


def _loss_fn(stage, draws):
    if stage != "coarse":
        return train_cli.BUILDERS[stage][1]

    def coarse(model, batch, generator):
        out = model(batch, None, train=True, **draws)
        return out["loss"], {"error": out["error"].mean()}
    return coarse


def _steps_rank(inputs):
    return {stage: _stage_steps(stage, *args) for stage, args in inputs.items()}


def _stage_steps(stage, state, batch, draws):
    """One SGD step, then three steps of the configured AdamW with clipping
    and EMA, both on this rank's rows; the accuracies of the first forward
    on its rows alone."""
    rank, size = mesh.world()
    cfg = load_config(None, SMALL + STAGES[stage])
    shard = _t(mesh.shard_batch(batch, rank, size))
    draws = _t(mesh.shard_batch(draws, rank, size)) if draws else {}
    loss_fn = _loss_fn(stage, draws)
    local = {}
    if stage == "denoise":
        with torch.no_grad():
            out = _model(stage, cfg, state)(shard)
        local = {k: float(out[k]) for k in ("focal_accuracy", "edge_accuracy")}
    sgd = TrainState(mesh.replicate(_model(stage, cfg, state)), SGD)
    metrics = {k: float(v) for k, v in train_step(sgd, loss_fn, shard, None).items()}
    adamw = TrainState(mesh.replicate(_model(stage, cfg, state)), cfg.optim)
    for _ in range(3):
        train_step(adamw, loss_fn, shard, None)
    return {"metrics": metrics, "params": _params(sgd.model), "params3": _params(adamw.model),
            "ema3": _params(adamw.ema), "local": local}


def _stage_inputs(stage):
    """Initial weights, a global batch of 8 rows and, for the coarse stage,
    its t, eps and eps0 (numpy)."""
    cfg = load_config(None, SMALL + STAGES[stage] + ["train.batch_size=8"])
    draws = {}
    if stage == "denoise":
        import jax
        from hierdiff_tpu.models.edge_denoise import EdgeDenoise as JaxDenoise
        from hierdiff_torch.utils.weights import denoise_state_dict_from_flax

        gen = SyntheticTreeGenerator(seed=3)
        trees = [gen.sample_tree(n) for n in (5, 7, 6, 8, 4, 8, 6, 5)]
        batch = make_denoise_batch(trees, random.Random(4), max_n=8, allow_native=False)
        jmodel = JaxDenoise(hidden_nf=16, n_layers_full=1, n_layers_focal=1)
        params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), batch)
        state = {k: v.numpy() for k, v in denoise_state_dict_from_flax(params).items()}
        with jax.default_matmul_precision("highest"):
            jax_out = jax.jit(jmodel.apply)(params, batch)
        return state, batch, draws, {k: float(jax_out[k])
                                     for k in ("focal_accuracy", "edge_accuracy")}
    pool = load_tree_pool(cfg, seed=0)
    it = coarse_iter(cfg, pool, seed=1) if stage == "coarse" else refine_iter(cfg, pool, seed=1)
    batch = next(it)
    state = _params(init_weights(train_cli.BUILDERS[stage][0](cfg, torch.device("cpu")),
                                 torch.Generator().manual_seed(0)))
    if stage == "coarse":
        rng = np.random.default_rng(2)
        b, n = batch["atom_mask"].shape[:2]
        nm = torch.from_numpy(batch["atom_mask"])
        draws = {"t_int": rng.integers(0, cfg.coarse.timesteps + 1, size=(b, 1)),
                 **{k: combine_noise(torch.from_numpy(rng.standard_normal((b, n, 11)).astype(
                     np.float32)), nm, 3).numpy() for k in ("eps", "eps0")}}
        draws["t_int"][0, 0] = 0   # one row takes the t = 0 term
    return state, batch, draws, None


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    inputs = {stage: _stage_inputs(stage) for stage in STAGES}
    ranks = mesh.spawn(_steps_rank, SIZE, "gloo",
                       init_file=str(tmp_path_factory.mktemp("steps") / "rdzv"),
                       args=({stage: args[:3] for stage, args in inputs.items()},))
    out = {}
    for stage, (state, batch, draws, jax_acc) in inputs.items():
        cfg = load_config(None, SMALL + STAGES[stage])
        single = TrainState(_model(stage, cfg, state), SGD)
        metrics = train_step(single, _loss_fn(stage, _t(draws)), _t(batch), None)
        out[stage] = {"ranks": [r[stage] for r in ranks], "single": _params(single.model),
                      "start": state, "jax_acc": jax_acc,
                      "single_metrics": {k: float(v) for k, v in metrics.items()}}
    return out


@pytest.mark.parametrize("stage", ["coarse", "denoise", "refine"])
def test_world2_step_is_the_single_process_step(steps, stage):
    res = steps[stage]
    rank0, rank1 = res["ranks"]
    start = res["start"]
    moves = []
    top = max(np.abs(v).max() for v in res["single"].values())
    for name, ref in res["single"].items():
        # a tensor near 0 (a zero-initialised bias after one step) is held
        # to a thousandth of the model's largest weight, as the gradient
        # tests of tests/test_torch_fine_train.py floor theirs
        scale = max(np.abs(ref).max(), PARAM_FLOOR * top)
        for r in (rank0, rank1):
            assert np.abs(r["params"][name] - ref).max() / scale <= PARAM_REL, name
        moves.append(np.abs(ref - start[name]).max() / scale)
    # the step moves the weights by far more than the bar: a gradient summed
    # instead of averaged, or one shard's alone, would break it
    assert max(moves) > 1e3 * PARAM_REL
    for k, v in res["single_metrics"].items():
        assert rank0["metrics"][k] == rank1["metrics"][k], k
        if k.endswith("accuracy"):
            assert rank0["metrics"][k] == v, (k, v)
        else:
            assert abs(rank0["metrics"][k] - v) <= 1e-5 * max(abs(v), 1.0), (k, v)


@pytest.mark.parametrize("stage", ["coarse", "denoise", "refine"])
def test_ranks_stay_bitwise_equal_over_three_steps(steps, stage):
    rank0, rank1 = steps[stage]["ranks"]
    for key in ("params3", "ema3"):
        for name, v in rank0[key].items():
            np.testing.assert_array_equal(rank1[key][name], v, err_msg=f"{key} {name}")
    start = steps[stage]["single"]
    assert any(not np.array_equal(rank0["params3"][k], start[k]) for k in start)


def test_ratio_metrics_are_the_jax_loss_global_ratio(steps):
    res = steps["denoise"]
    rank0 = res["ranks"][0]
    for k, ref in res["jax_acc"].items():
        assert rank0["metrics"][k] == ref, (k, rank0["metrics"][k], ref)
    # the mean of the two shards' ratios is another number, for at least one
    # of the two: the test can see a reduction of the ratio itself
    mean_of_ratios = {k: np.mean([r["local"][k] for r in res["ranks"]]) for k in res["jax_acc"]}
    assert any(mean_of_ratios[k] != res["jax_acc"][k] for k in res["jax_acc"]), mean_of_ratios


# --- 3. the train CLI ----------------------------------------------------------------


def _events(tb_dir: Path) -> list:
    """(tag, step, value) of every scalar in the event files under tb_dir."""
    from tensorboard.compat.proto import event_pb2

    out = []
    for path in sorted(tb_dir.glob("events.out.tfevents.*")):
        data = path.read_bytes()
        pos = 0
        while pos < len(data):
            (n,) = struct.unpack("<Q", data[pos:pos + 8])
            event = event_pb2.Event.FromString(data[pos + 12:pos + 12 + n])
            pos += 12 + n + 4
            out += [(v.tag, event.step, v.simple_value) for v in event.summary.value]
    return out


def _train_cli_args(workdir, steps):
    return ["coarse", "--device", "cpu", "--init-seed", "0", f"train.workdir={workdir}",
            "train.log_every=1", "train.eval_every=2", "train.checkpoint_every=1",
            f"train.max_steps={steps}", *SMALL]


def _train_cli_rank(workdir):
    first = train_cli.main(_train_cli_args(workdir, 2))
    second = train_cli.main(_train_cli_args(workdir, 3))
    return {"steps": (first["steps"], second["steps"]), "final": second["trainer"].state.step,
            "params": _params(second["trainer"].state.model)}


def test_train_cli_world2_writes_one_workdir_and_resumes(tmp_path, capsys):
    workdir = tmp_path / "run"
    rank0, rank1 = mesh.spawn(_train_cli_rank, SIZE, "gloo", init_file=str(tmp_path / "rdzv"),
                              args=(str(workdir),))
    assert rank0["steps"] == rank1["steps"] == (2, 1) and rank0["final"] == rank1["final"] == 3
    for name, v in rank0["params"].items():
        np.testing.assert_array_equal(rank1["params"][name], v, err_msg=name)
    with open(workdir / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert [(int(r["step"]), r["split"]) for r in rows] == [(1, "train"), (2, "train"),
                                                           (2, "val"), (3, "train")]
    assert sorted(p.name for p in (workdir / "checkpoints").glob("*.pt")) == [
        f"step_{s:08d}.pt" for s in (1, 2, 3)]
    payload = torch.load(workdir / "checkpoints" / "step_00000003.pt", weights_only=True)
    assert len(payload["generators"]) == SIZE
    assert not torch.equal(payload["generators"][0], payload["generators"][1])
    assert (workdir / "ema.pt").exists() and json.loads((workdir / "config.json").read_text())
    # one event file per run, rank 0's
    assert len(list((workdir / "tb").glob("events.out.tfevents.*"))) == 2
    assert [s for tag, s, _ in _events(workdir / "tb") if tag == "train/loss"] == [1, 2, 3]


def test_world1_group_run_is_the_plain_run_and_logs_to_tensorboard(tmp_path):
    plain = train_cli.main(_train_cli_args(tmp_path / "plain", 3) + ["--no-data-parallel"])

    def in_group():
        with pytest.raises(SystemExit, match="not a rank of a process group"):
            train_cli.main(_train_cli_args(tmp_path / "no", 3) + ["--no-data-parallel"])
        return train_cli.main(_train_cli_args(tmp_path / "group", 3))

    grouped = _in_world_one_group(tmp_path, in_group)
    for name, v in plain["trainer"].state.model.state_dict().items():
        assert torch.equal(grouped["trainer"].state.model.state_dict()[name], v), name
    rows = {}
    for run in ("plain", "group"):
        with open(tmp_path / run / "metrics.csv") as f:
            rows[run] = [{k: v for k, v in r.items() if not k.endswith("per_sec")}
                         for r in csv.DictReader(f)]
    assert rows["plain"] == rows["group"]
    events = [(s, v) for tag, s, v in _events(tmp_path / "plain" / "tb") if tag == "train/loss"]
    csv_loss = [(int(r["step"]), float(r["loss"])) for r in rows["plain"] if r["split"] == "train"]
    assert [s for s, _ in events] == [1, 2, 3]
    assert np.allclose([v for _, v in events], [v for _, v in csv_loss], rtol=1e-6)


# --- 4. generate and assemble ---------------------------------------------------------


class _SmallHook(RefineHook):
    """Fused checks of at most SMALL_ROWS rows, still one shape per bucket,
    so that the CPU keeps up (tests/test_torch_refine.py's)."""

    def fleet_chunk_rows(self, nb: int) -> int:
        return min(super().fleet_chunk_rows(nb), SMALL_ROWS)


FINE = ["--denoise-init-seed", "0", "--device", "cpu", "--beam", "2"]
TINY = ["denoise.hidden_nf=16", "denoise.n_layers_full=1", "denoise.n_layers_focal=1",
        "refine.hidden_size=16", "refine.n_layers=1"]


def _sampling_runs(tmp, refine):
    """generate and assemble, their point sets and trees (rank 0) or None."""
    sample_cli.RefineHook = _SmallHook
    extra = ["--refine-init-seed", "0"] if refine else []
    gen = sample_cli.main(["generate", "--init-seed", "0", "--num", "6", "--sample-steps", "3",
                           "--max-nodes", "12", "--out", str(Path(tmp) / "gen.pkl"), *FINE,
                           *extra, "coarse.hidden_nf=16", "coarse.n_layers=1", *TINY])
    sg = SyntheticTreeGenerator(seed=15)
    blur = [{"x": t.pos.astype(np.float32), "h": t.feats.astype(np.float32)}
            for t in (sg.sample_tree(n) for n in (12, 7, 4, 11, 9, 5))]
    src = Path(tmp) / "coarse.pkl"
    if mesh.world()[0] == 0:
        with open(src, "wb") as f:
            pickle.dump([blur], f)
    mesh.barrier()
    asm = sample_cli.main(["assemble", "--coarse-pkl", str(src), "--out",
                           str(Path(tmp) / "asm.pkl"), *FINE, *extra, *TINY])
    if gen is None:
        assert asm is None
        return None
    return {"blur": gen["result"].blur,
            "trees": [sample_cli._tree_to_dict(t) for t in gen["result"].trees],
            "assembled": (Path(tmp) / "asm.pkl").read_bytes(),
            "checks": asm["sampler"].refine_hook.stats["score_calls"] if refine else 0}


def _sampling_rank(tmp, refine):
    return _sampling_runs(tmp, refine)


@pytest.mark.parametrize("refine", [False, True], ids=["refine_off", "refine_on"])
def test_generate_and_assemble_at_world2_are_the_world1_runs(tmp_path, monkeypatch, refine):
    monkeypatch.setattr(sample_cli, "RefineHook", sample_cli.RefineHook)
    (tmp_path / "w1").mkdir()
    (tmp_path / "w2").mkdir()
    one = _sampling_runs(tmp_path / "w1", refine)
    two, none = mesh.spawn(_sampling_rank, SIZE, "gloo", init_file=str(tmp_path / "rdzv"),
                           args=(str(tmp_path / "w2"), refine))
    assert none is None
    assert len(one["blur"]) == len(two["blur"]) == 6
    for a, b in zip(one["blur"], two["blur"]):
        for k in ("x", "h"):
            np.testing.assert_array_equal(a[k], b[k])
    assert sum(t is not None for t in one["trees"]) >= 4
    for a, b in zip(one["trees"], two["trees"]):
        assert (a is None) == (b is None)
        if a is not None:
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert one["assembled"] == two["assembled"]
    assert (one["checks"] > 0) == refine and one["checks"] == two["checks"]


def _streamed_run():
    """``run_streamed`` of 5 molecules in chunks of 2 under the fake-RDKit
    harness, trees of at most 2 nodes (tests/test_torch_streamed.py's):
    (trees, molecules' SMILES, the panel) on rank 0, None elsewhere."""
    sys.path.insert(0, str(REPO / "tests"))
    import fake_rdkit
    from hierdiff_torch.chem.assemble_gate import make_assembly_gate
    from hierdiff_torch.chem.mol_tree import Vocab
    from hierdiff_torch.config import CoarseModelConfig
    from hierdiff_torch.models.edge_denoise import EdgeDenoise
    from hierdiff_torch.sampling.pipeline import GenerationPipeline

    fake_rdkit.install()
    try:
        coarse = init_weights(sample_cli.build_coarse_from_cfg(
            CoarseModelConfig(hidden_nf=16, n_layers=1, timesteps=10), "float32", "cpu"),
            torch.Generator().manual_seed(0))
        denoise = init_weights(EdgeDenoise(hidden_nf=16, n_layers_full=1, n_layers_focal=1),
                               torch.Generator().manual_seed(1)).eval()
        vocab = Vocab()
        pipe = GenerationPipeline(coarse, denoise, histogram={2: 1, 4: 1, 6: 1, 9: 1, 12: 1},
                                  beam_size=2, max_n_cap=2, vocab=vocab,
                                  can_assemble=make_assembly_gate(vocab))
        out = pipe.run_streamed(7, 5, chunk_size=2, n_workers=2)
        if out is None:
            return None
        from rdkit import Chem
        return ([sample_cli._tree_to_dict(t) for t in out.trees],
                [Chem.MolToSmiles(m[2]) for m in out.molecules],
                {k: out.stats[k] for k in ("valid", "unique", "avg_atoms")})
    finally:
        fake_rdkit.uninstall()


def test_run_streamed_at_world2_reconstructs_on_rank_0(tmp_path):
    one = _streamed_run()
    two, none = mesh.spawn(_streamed_run, SIZE, "gloo", init_file=str(tmp_path / "rdzv"))
    assert none is None and one[1] and one[1:] == two[1:]
    for a, b in zip(one[0], two[0]):
        assert (a is None) == (b is None)
        if a is not None:
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# --- 5. the entry points ------------------------------------------------------------------


def test_entry_gives_a_finite_loss_and_refuses_the_cpu_unless_asked():
    fn, args = entry.entry(device="cpu")
    model, batch, _ = args
    assert batch["positions"].shape == (8, 8, 3) and model.timesteps == 10
    loss = fn(*args)
    assert loss.shape == () and torch.isfinite(loss)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.entry()
    with pytest.raises(ValueError, match="backend='gloo'"):
        entry.dryrun_multichip(2, device="cpu")


def test_dryrun_multichip_two_gloo_ranks_on_the_cpu(capsys):
    report = entry.dryrun_multichip(SIZE, backend="gloo", device="cpu")
    lines = capsys.readouterr().out
    assert len(report["lines"]) == 3 and report["loss"] == report["loss"]
    assert "one DP train step OK" in lines and "4/4 trees assembled" in lines
    assert "refine+gate+reconstruct OK, 16/16" in lines
    assert len(report["launches"]) == SIZE
    # every rank sampled a chunk of each generation check
    assert report["coarse_chunks"] == [2, 2] and lines.count("chunks by rank") == 2
    assert entry.expected_launches(2)["fused_gcl"] == 4 + 2 * 11 * 4


def test_new_modules_load_neither_jax_nor_the_jax_package():
    code = ("import sys, hierdiff_torch.entry, hierdiff_torch.parallel.mesh\n"
            "print([m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'hierdiff_tpu')])")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip().splitlines()[-1] == "[]"
