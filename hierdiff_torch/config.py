"""Coarse-stage model configuration (the port's copy of
``hierdiff_tpu/config.py:CoarseModelConfig``).

Defaults are the GEOM-Drugs coarse model (reference
endiffusion/conf/model/ddpmgblur.yaml). A YAML file in the JAX package's
format (``configs/coarse_geom.yaml``) can override them; PyYAML is imported
only when a path is given.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


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
