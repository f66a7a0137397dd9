"""Reference checkpoints through the port's weight flags
(``hierdiff_torch/utils/weights.py``: ``load_torch_checkpoint``,
``detect_stage``, ``load_weights``).

A reference PyTorch-Lightning checkpoint wraps the state dict as
``{"state_dict": {"model." + key: tensor}, "hyper_parameters": <config
object>}`` and carries non-parameter buffers (``SKIPPED_KEYS``). For each
stage, the port's own model saved in that layout (with and without
``hyper_parameters``, with and without the skipped keys) must strict-load
equal to the raw state dict, and the loader must read what the JAX
package's ``load_torch_checkpoint`` reads. The CLIs on ``--device cpu``
give the same samples and trees from either file.
"""

import argparse
import pickle

import numpy as np
import pytest
import torch

from hierdiff_torch.config import load_config
from hierdiff_torch.sampling import cli as sample_cli
from hierdiff_torch.train import cli as train_cli
from hierdiff_torch.utils.weights import (SKIPPED_KEYS, detect_stage, load_torch_checkpoint,
                                          load_weights)
from hierdiff_tpu.utils import torch_import as jax_import

STAGES = ("coarse", "denoise", "refine")
TINY = ["denoise.hidden_nf=16", "denoise.n_layers_full=1", "denoise.n_layers_focal=1",
        "refine.hidden_size=16", "refine.n_layers=1", "coarse.hidden_nf=16", "coarse.n_layers=1"]
# the reference's non-parameter keys, one of each pattern of SKIPPED_KEYS
SKIPPED = {"gamma.gamma": torch.linspace(-5.0, 5.0, 1001), "buffer": torch.zeros(1),
           "dynamics.egnn.sin_embedding.frequencies": torch.arange(6.0)}


def _cfg(stage):
    cfg = load_config(None, TINY)
    cfg.stage = stage
    return cfg


@pytest.fixture(scope="module")
def raw():
    """Each stage's tiny model with seeded random weights: its state dict."""
    cpu = torch.device("cpu")
    return {stage: train_cli.initial_model(_cfg(stage), cpu, init_seed=3).state_dict()
            for stage in STAGES}


def save(path, sd, layout: str, skipped: bool) -> str:
    """``sd`` in one of the layouts a ``--weights`` file comes in."""
    sd = {**sd, **SKIPPED} if skipped else dict(sd)
    if layout == "npz":
        np.savez(path, **{k: v.numpy() for k, v in sd.items()})
        return str(path)
    if layout == "raw":
        obj = sd
    else:
        obj = {"state_dict": {"model." + k: v for k, v in sd.items()}, "epoch": 7,
               "global_step": 700}
        if layout == "lightning+hparams":
            obj["hyper_parameters"] = argparse.Namespace(lr=4e-4, model={"hidden_nf": 16})
    torch.save(obj, path)
    return str(path)


def test_skip_patterns_cover_one_key_each():
    import re

    assert [sum(bool(re.fullmatch(p, k)) for k in SKIPPED) for p in SKIPPED_KEYS] == [1, 1, 1]


@pytest.mark.parametrize("skipped", [False, True], ids=["plain", "skipped-keys"])
@pytest.mark.parametrize("layout", ["raw", "npz", "lightning", "lightning+hparams"])
@pytest.mark.parametrize("stage", STAGES)
def test_weights_flag_loads_every_layout(raw, tmp_path, stage, layout, skipped):
    """``train.cli --weights`` (``initial_model``) strict-loads the file
    bitwise equal to the raw state dict; the torch files read as the JAX
    package's loader reads them, and the stage is detected as JAX's
    ``detect_stage`` detects it."""
    path = save(tmp_path / ("w.npz" if layout == "npz" else "w.pt"), raw[stage], layout, skipped)
    model = train_cli.initial_model(_cfg(stage), torch.device("cpu"), weights=path)
    got = model.state_dict()
    assert got.keys() == raw[stage].keys()
    for k, v in raw[stage].items():
        assert torch.equal(got[k], v), k
    if layout != "npz":
        mine, theirs = load_torch_checkpoint(path), jax_import.load_torch_checkpoint(path)
        assert mine.keys() == theirs.keys()
        for k, v in theirs.items():
            np.testing.assert_array_equal(mine[k].numpy(), v)
        assert detect_stage(mine) == jax_import.detect_stage(theirs)
    assert detect_stage(raw[stage]) == stage


def test_skipped_keys_load_where_the_model_holds_them(tmp_path):
    """A key of ``SKIPPED_KEYS`` that the model does hold is loaded, not
    dropped."""
    class Probe(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.buffer = torch.nn.Parameter(torch.zeros(1))

    path = save(tmp_path / "p.pt", {"buffer": torch.full((1,), 2.5)}, "lightning", False)
    model = load_weights(Probe(), path, "coarse")
    assert float(model.buffer.detach()) == 2.5


@pytest.mark.parametrize("given,asked", [(g, a) for g in STAGES for a in STAGES if g != a])
def test_a_wrong_stage_names_both(raw, tmp_path, given, asked):
    path = save(tmp_path / "w.pt", raw[given], "lightning+hparams", True)
    with pytest.raises(ValueError, match=f"holds {given} weights, but the {asked} model"):
        train_cli.initial_model(_cfg(asked), torch.device("cpu"), weights=path)


def test_sampling_flags_name_the_wrong_stage(raw, tmp_path):
    path = save(tmp_path / "d.pt", raw["denoise"], "lightning", False)
    with pytest.raises(ValueError, match="holds denoise weights, but the refine model"):
        sample_cli.main(["assemble", "--coarse-pkl", str(tmp_path / "unread.pkl"),
                         "--denoise-weights", path, "--refine-weights", path,
                         "--device", "cpu", *TINY])


def _files(raw, tmp_path, layout, skipped):
    return {stage: save(tmp_path / f"{stage}-{layout}.pt", raw[stage], layout, skipped)
            for stage in STAGES}


def test_coarse_cli_samples_equal_from_either_file(raw, tmp_path):
    """``sampling.cli coarse --weights``: the reference checkpoint's point
    sets are bitwise those of the raw state dict."""
    config = tmp_path / "tiny.yaml"
    config.write_text("coarse:\n  hidden_nf: 16\n  n_layers: 1\n")
    runs = {}
    for layout, skipped in (("raw", False), ("lightning+hparams", True)):
        path = save(tmp_path / f"{layout}.pt", raw["coarse"], layout, skipped)
        out = tmp_path / f"{layout}.pkl"
        sample_cli.main(["coarse", "--config", str(config), "--weights", path, "--num", "3",
                         "--batch-size", "3", "--steps", "3", "--max-nodes", "6",
                         "--device", "cpu", "--out", str(out)])
        with open(out, "rb") as f:
            runs[layout] = pickle.load(f)[0]
    assert len(runs["raw"]) == 3
    for a, b in zip(runs["raw"], runs["lightning+hparams"]):
        np.testing.assert_array_equal(a["x"], b["x"])
        np.testing.assert_array_equal(a["h"], b["h"])


def test_generate_cli_trees_equal_from_either_file(raw, tmp_path):
    """``sampling.cli generate --weights --denoise-weights --refine-weights``:
    the trees from the three reference checkpoints are bitwise those from
    the raw state dicts."""
    runs = {}
    for layout, skipped in (("raw", False), ("lightning+hparams", True)):
        files = _files(raw, tmp_path, layout, skipped)
        runs[layout] = sample_cli.main([
            "generate", "--weights", files["coarse"], "--denoise-weights", files["denoise"],
            "--refine-weights", files["refine"], "--num", "2", "--steps", "3", "--max-nodes", "5",
            "--beam", "2", "--device", "cpu", "--out", str(tmp_path / f"{layout}.pkl"), *TINY])
    raw_trees, pl_trees = (runs[k]["result"].trees for k in ("raw", "lightning+hparams"))
    assert len(raw_trees) == 2 and any(t is not None for t in raw_trees)
    for a, b in zip(raw_trees, pl_trees):
        assert (a is None) == (b is None)
        if a is not None:
            for k in ("wids", "adj", "pos", "feats"):
                np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
            assert a.logp == b.logp

