"""Configuration: the coarse model, the fine stage's edge-denoise model,
the optimizer and the training loop (the port's copy of
``hierdiff_tpu/config.py``: ``CoarseModelConfig``, ``EdgeDenoiseConfig``,
``OptimConfig``, ``TrainConfig`` and a ``Config`` holding them).

Defaults are the GEOM-Drugs models (reference
endiffusion/conf/model/ddpmgblur.yaml and conf/model/edge_denoise.yaml, as
``configs/coarse_geom.yaml`` and ``configs/denoise_geom.yaml``). A YAML file
in the JAX package's format can override them; PyYAML is imported only when
a path is given. Dotted ``k=v`` overrides are parsed without it.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Tuple


@dataclass
class CoarseModelConfig:
    """ddpmgblur.yaml equivalents."""

    node_coarse_type: str = "prop"       # 'prop' (8 feats) | 'elem' (3)
    loss_type: str = "vlb"
    noise_schedule: str = "learned"
    timesteps: int = 1000
    noise_precision: float = 1e-4
    norm_values: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    norm_biases: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    hidden_nf: int = 256
    n_layers: int = 6
    inv_sublayers: int = 2
    attention: bool = True
    tanh: bool = True
    coords_range: float = 30.0
    norm_constant: float = 0.0
    normalization_factor: float = 10.0
    aggregation_method: str = "sum"
    condition_time: bool = True
    context_node_nf: int = 0
    mode: str = "egnn_dynamics"          # 'egnn_dynamics' ('gnn_dynamics' not ported)
    sin_embedding: bool = False          # sinusoidal distance embedding
    compute_dtype: Optional[str] = None  # 'bfloat16' = bf16 elementwise edge pipeline
    dataset: str = "geom"                # geom | qm9 | crossdock (node-count histogram)
    pocket: bool = False                 # pocket-conditioned variant (not ported)

    @property
    def in_node_nf(self) -> int:
        return 8 if self.node_coarse_type == "prop" else 3

    @property
    def int_nf(self) -> int:
        return 5 if self.node_coarse_type == "prop" else 3

    @property
    def cont_nf(self) -> int:
        return 3 if self.node_coarse_type == "prop" else 0


def load_coarse_config(path: Optional[str] = None) -> CoarseModelConfig:
    """GEOM defaults, overridden by the ``coarse:`` section of a YAML file.

    Keys of the JAX package's config that this port does not model (its
    TPU-side switches such as ``use_pallas`` or ``remat``) are ignored."""
    cfg = CoarseModelConfig()
    if not path:
        return cfg
    import yaml

    with open(path) as f:
        section = (yaml.safe_load(f) or {}).get("coarse", {})
    names = {f.name: f for f in dataclasses.fields(cfg)}
    for key, value in section.items():
        if key not in names:
            continue
        cur = getattr(cfg, key)
        if isinstance(cur, tuple):
            value = tuple(type(cur[0])(v) for v in value)
        elif isinstance(cur, bool):
            value = bool(value)
        elif isinstance(cur, (int, float)) and value is not None:
            value = type(cur)(value)
        setattr(cfg, key, value)
    return cfg


@dataclass
class EdgeDenoiseConfig:
    """conf/model/edge_denoise.yaml equivalents. The loss weights and
    ``full_softmax`` serve training, which is not ported yet."""

    vocab_size: int = 781
    out_node_nf: int = 780
    in_node_nf: int = 8
    hidden_nf: int = 256
    n_layers_full: int = 3
    n_layers_focal: int = 3
    focal_loss: float = 5.0
    edge_loss: float = 1.0
    node_loss: float = 2.0
    full_softmax: bool = True
    vocab_conditioning: bool = False


@dataclass
class OptimConfig:
    """conf/optim + conf/scheduler equivalents (``build_optimizer``)."""

    optimizer: str = "adamw"             # adamw (adam, sgd: not ported)
    lr: float = 4.0e-4
    weight_decay: float = 4.0e-8
    grad_clip: Optional[float] = 1.0
    schedule: str = "constant"          # constant | cosine | step
    warmup_steps: int = 0
    decay_steps: int = 100_000
    step_size: int = 15                  # StepLR epochs (reference scheduler/step.yaml)
    step_gamma: float = 0.1
    ema_decay: float = 0.999


@dataclass
class TrainConfig:
    batch_size: int = 64
    max_steps: int = 10_000
    eval_every: int = 500
    checkpoint_every: int = 1000
    log_every: int = 50
    seed: int = 2022
    workdir: str = "runs/default"
    data: str = "synthetic"              # 'synthetic' | directory of .npz trees
    data_split: str = ""                 # optional JSON list of file names
    num_train_trees: int = 4096          # synthetic pool size
    buckets: Tuple[int, ...] = (8, 16, 24, 32, 48, 64, 96)


@dataclass
class Config:
    stage: str = "coarse"
    coarse: CoarseModelConfig = field(default_factory=CoarseModelConfig)
    denoise: EdgeDenoiseConfig = field(default_factory=EdgeDenoiseConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


_INT = re.compile(r"[-+]?[0-9]+")
_FLOAT = re.compile(r"[-+]?(\.[0-9]+|[0-9]+(\.[0-9]*)?)([eE][-+]?[0-9]+)?|[-+]?\.?(inf|Inf|INF)")


def parse_value(text: str) -> Any:
    """A scalar or flow list the way ``yaml.safe_load`` reads one on a
    command line: null, booleans, ints, floats, ``[a, b]`` lists, else the
    string itself (quotes stripped)."""
    text = text.strip()
    if text in ("", "~", "null", "Null", "NULL"):
        return None
    if text in ("true", "True", "TRUE", "yes", "Yes", "on", "On"):
        return True
    if text in ("false", "False", "FALSE", "no", "No", "off", "Off"):
        return False
    if text.startswith("[") and text.endswith("]"):
        return [parse_value(v) for v in text[1:-1].split(",") if v.strip()]
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if _INT.fullmatch(text):
        return int(text)
    if _FLOAT.fullmatch(text):
        return float(text)
    return text


def _apply(obj: Any, key: str, value: Any) -> None:
    """Set a dotted field, cast to the type of its current value
    (``hierdiff_tpu/config.py:_apply``)."""
    parts = key.split(".")
    tgt = obj
    for p in parts[:-1]:
        tgt = getattr(tgt, p)
    name = parts[-1]
    if not hasattr(tgt, name):
        raise KeyError(f"unknown config key {key!r}")
    cur = getattr(tgt, name)
    if value is None and not isinstance(cur, bool):
        pass   # null clears an optional field (optim.grad_clip=null)
    elif isinstance(cur, bool):
        value = value in (True, "true", "True", "1", 1)
    elif isinstance(cur, int) and not isinstance(value, bool):
        value = int(value)
    elif isinstance(cur, float):
        value = float(value)
    elif isinstance(cur, tuple):
        if isinstance(value, str):
            value = tuple(type(cur[0])(v) for v in value.strip("()[]").split(",") if v.strip())
        else:
            value = tuple(value)
    setattr(tgt, name, value)


def _update_from_dict(cfg: Any, d: dict, prefix: str = "") -> None:
    for k, v in d.items():
        if isinstance(v, dict):
            _update_from_dict(cfg, v, f"{prefix}{k}.")
        elif prefix.split(".")[0] in ("coarse", "denoise", "optim", "train") or (
                not prefix and k == "stage"):
            _apply(cfg, f"{prefix}{k}", v)


def load_config(path: Optional[str] = None, overrides: Sequence[str] = ()) -> Config:
    """Defaults, then the YAML file's ``coarse`` / ``denoise`` / ``optim`` /
    ``train`` sections (the refine stage's section is not ported and is
    skipped), then ``key=value`` overrides such as ``train.max_steps=20``."""
    cfg = Config()
    if path:
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        names = {f.name for f in dataclasses.fields(CoarseModelConfig)}
        raw["coarse"] = {k: v for k, v in (raw.get("coarse") or {}).items() if k in names}
        _update_from_dict(cfg, raw)
    for ov in overrides:
        key, sep, val = ov.partition("=")
        if not sep:
            raise ValueError(f"override {ov!r} is not key=value")
        _apply(cfg, key.strip(), parse_value(val))
    return cfg

