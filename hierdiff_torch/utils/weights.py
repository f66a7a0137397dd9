"""Weights for the port's models: JAX/flax params carried across, and a
seeded random initialisation.

``state_dict_from_flax`` is the port's own copy of the coarse mapping of
``hierdiff_tpu/utils/torch_import.py:export_coarse`` (:398-479: the egnn or
gnn backbone, the gamma network, the pocket embedding) and
``denoise_state_dict_from_flax`` that of ``export_denoise`` (:482, with
``_exp_fine_egcl`` :424), ``refine_state_dict_from_flax`` that of
``export_refine`` (:501). The keys are the reference DiffusionQM9,
Edge_denoise and Node2Vec layouts, so a real reference checkpoint and a JAX
workdir's params (as numpy arrays) both load with ``strict=True``.

``load_weights`` reads either into a model: ``load_torch_checkpoint`` (the
port's copy of ``torch_import.py:load_torch_checkpoint`` :51-75) unwraps a
PyTorch-Lightning checkpoint's ``state_dict`` and strips its ``model.``
prefix, and the reference's non-parameter keys (``SKIPPED_KEYS``) are dropped
where the model holds no key of that name. ``detect_stage`` (:518) names the
stage a state dict belongs to.

``jtnn_flax_to_numpy_state`` maps the JT-VAE modules (``models/jtnn.py``);
the JAX package exports no JT-VAE weights, so that mapping is the port's own.
"""

from __future__ import annotations

import math
import pickle
import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from hierdiff_torch.ops.egnn import DenseEquivariantUpdate
from hierdiff_torch.ops.gcl import DenseEGCL
from hierdiff_torch.ops.schedules import PositiveLinear


def _linear(out: Dict[str, np.ndarray], prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = np.asarray(p["kernel"]).T
    if "bias" in p:
        out[f"{prefix}.bias"] = np.asarray(p["bias"])


def _pair(p: Mapping, stem: str) -> np.ndarray:
    return np.concatenate([np.asarray(p[f"{stem}_w_src"]).T, np.asarray(p[f"{stem}_w_dst"]).T,
                           np.asarray(p[f"{stem}_w_e"]).T], axis=1)


def _gcl(out: Dict[str, np.ndarray], prefix: str, p: Mapping) -> None:
    out[f"{prefix}.edge_mlp.0.weight"] = _pair(p, "edge_in")
    out[f"{prefix}.edge_mlp.0.bias"] = np.asarray(p["edge_in_bias"])
    out[f"{prefix}.edge_mlp.2.weight"] = np.asarray(p["edge_out_kernel"]).T
    out[f"{prefix}.edge_mlp.2.bias"] = np.asarray(p["edge_out_bias"])
    out[f"{prefix}.node_mlp.0.weight"] = np.asarray(p["node_in_kernel"]).T
    out[f"{prefix}.node_mlp.0.bias"] = np.asarray(p["node_in_bias"])
    out[f"{prefix}.node_mlp.2.weight"] = np.asarray(p["node_out_kernel"]).T
    out[f"{prefix}.node_mlp.2.bias"] = np.asarray(p["node_out_bias"])
    if "att_kernel" in p:
        out[f"{prefix}.att_mlp.0.weight"] = np.asarray(p["att_kernel"]).T
        out[f"{prefix}.att_mlp.0.bias"] = np.asarray(p["att_bias"])


def _equiv(out: Dict[str, np.ndarray], prefix: str, p: Mapping) -> None:
    out[f"{prefix}.coord_mlp.0.weight"] = _pair(p, "coord_in")
    out[f"{prefix}.coord_mlp.0.bias"] = np.asarray(p["coord_in_bias"])
    out[f"{prefix}.coord_mlp.2.weight"] = np.asarray(p["coord_mid_kernel"]).T
    out[f"{prefix}.coord_mlp.2.bias"] = np.asarray(p["coord_mid_bias"])
    out[f"{prefix}.coord_mlp.4.weight"] = np.asarray(p["coord_head_kernel"]).T


def flax_to_numpy_state(params: Mapping) -> Dict[str, np.ndarray]:
    """CoarseDiffusion flax params (numpy leaves) -> reference state-dict
    layout as numpy arrays. Accepts the params tree with or without its
    top-level ``"params"`` key."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, np.ndarray] = {}
    if "gnn" in params["dynamics"]:
        # mode='gnn_dynamics' backbone (egnn_new.py:208-242)
        gnn = params["dynamics"]["gnn"]
        _linear(out, "dynamics.gnn.embedding", gnn["embedding"])
        _linear(out, "dynamics.gnn.embedding_out", gnn["embedding_out"])
        for gname, gp in gnn.items():
            if gname.startswith("gcl_"):
                _gcl(out, f"dynamics.gnn.{gname}", gp)
    else:
        egnn = params["dynamics"]["egnn"]
        _linear(out, "dynamics.egnn.embedding", egnn["embedding"])
        _linear(out, "dynamics.egnn.embedding_out", egnn["embedding_out"])
        for bname, bp in egnn.items():
            if not bname.startswith("e_block_"):
                continue
            for gname, gp in bp.items():
                prefix = f"dynamics.egnn.{bname}.{gname}"
                (_equiv if gname == "gcl_equiv" else _gcl)(out, prefix, gp)
    if "pocket_embed" in params:
        # crossdock pocket variant (diffusion_qm9.py:56)
        out["pocket_embed.weight"] = np.asarray(params["pocket_embed"]["embedding"])
    if "gamma" in params:
        for name in ("l1", "l2", "l3"):
            _linear(out, f"gamma.{name}", params["gamma"][name])
        out["gamma.gamma_0"] = np.asarray(params["gamma"]["gamma_0"])
        out["gamma.gamma_1"] = np.asarray(params["gamma"]["gamma_1"])
    return out


def state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """CoarseDiffusion flax params (numpy leaves) -> the port's state dict."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in flax_to_numpy_state(params).items()}


def _fine_egcl(out: Dict[str, np.ndarray], prefix: str, p: Mapping) -> None:
    cols = [np.asarray(p["mes_src"]["kernel"]).T, np.asarray(p["mes_dst"]["kernel"]).T,
            np.asarray(p["mes_rad"]["kernel"]).T]
    if "mes_e" in p:
        cols.append(np.asarray(p["mes_e"]["kernel"]).T)
    out[f"{prefix}.mes_mlp.0.weight"] = np.concatenate(cols, axis=1)
    out[f"{prefix}.mes_mlp.0.bias"] = np.asarray(p["mes_src"]["bias"])
    _linear(out, f"{prefix}.mes_mlp.2", p["mes_out"])
    _linear(out, f"{prefix}.node_mlp.0", p["node_in"])
    _linear(out, f"{prefix}.node_mlp.2", p["node_out"])
    _linear(out, f"{prefix}.coord_mlp.0", p["coord_in"])
    out[f"{prefix}.coord_mlp.2.weight"] = np.asarray(p["coord_head"]["kernel"]).T
    if "att" in p:
        _linear(out, f"{prefix}.att_mlp.0", p["att"])
    if "edge_in" in p:
        _linear(out, f"{prefix}.edge_mlp.0", p["edge_in"])
        _linear(out, f"{prefix}.edge_mlp.2", p["edge_out"])


def denoise_flax_to_numpy_state(params: Mapping) -> Dict[str, np.ndarray]:
    """EdgeDenoise flax params (numpy leaves) -> reference Edge_denoise
    state-dict layout as numpy arrays. Accepts the params tree with or
    without its top-level ``"params"`` key."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, np.ndarray] = {}
    for name in ("feature_embedding", "edge_embedding", "node_embedding"):
        _linear(out, name, params[name])
    out["vocab_embedding.weight"] = np.asarray(params["vocab_embedding"]["embedding"])
    for ours, theirs in (("focal_head", "focal_predict"), ("edge_head", "edge_predict"),
                         ("node_head", "node_predict")):
        for layer, p in params[ours].items():     # flax Sequential: layers_{i}
            _linear(out, f"{theirs}.{layer.split('_')[1]}", p)
    for name, p in params.items():
        if name.startswith(("gcl_full_", "gcl_focal_")) or name in ("gcl_edge", "gcl_denoise"):
            _fine_egcl(out, name, p)
    return out


def denoise_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """EdgeDenoise flax params (numpy leaves) -> the port's state dict."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in denoise_flax_to_numpy_state(params).items()}


def refine_flax_to_numpy_state(params: Mapping) -> Dict[str, np.ndarray]:
    """NodeRefine flax params (numpy leaves) -> reference Node2Vec
    state-dict layout as numpy arrays. Accepts the params tree with or
    without its top-level ``"params"`` key."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, np.ndarray] = {}
    out["v_embedding.weight"] = np.asarray(params["v_embedding"]["embedding"])
    out["size_embedding.weight"] = np.asarray(params["size_embedding"]["embedding"])
    for name in ("f_embedding", "projection", "output"):
        for layer, p in params[name].items():     # flax Sequential: layers_{i}
            _linear(out, f"{name}.{layer.split('_')[1]}", p)
    for name, p in params.items():
        if name.startswith("gcl_"):
            _fine_egcl(out, name, p)
    return out


def refine_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """NodeRefine flax params (numpy leaves) -> the port's state dict."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in refine_flax_to_numpy_state(params).items()}


def jtnn_flax_to_numpy_state(params: Mapping) -> Dict[str, np.ndarray]:
    """JTNNEncoder, JTNNDecoder, MPN or JTMPN flax params (numpy leaves) ->
    the reference's jtnn_enc.py / jtnn_dec.py / mpn.py / jtmpn.py state-dict
    layout as numpy arrays: ``embedding.weight``, the tree-GRU's ``W_z``,
    ``W_r``, ``U_r``, ``W_h`` at the module's top level (flax nests them
    under ``gru``), and ``W``, ``U``, ``W_o``, ``U_s``, ``W_i``, ``W_h`` as
    linears. Accepts the params tree with or without its top-level
    ``"params"`` key."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, np.ndarray] = {}
    for name, p in params.items():
        if name == "embedding":
            out["embedding.weight"] = np.asarray(p["embedding"])
        elif name == "gru":
            for sub, q in p.items():
                _linear(out, sub, q)
        else:
            _linear(out, name, p)
    return out


def jtnn_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JT-VAE flax params (numpy leaves) -> the port's state dict."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in jtnn_flax_to_numpy_state(params).items()}


# Keys of the reference's checkpoints that hold no parameter of the port's
# models (``torch_import.py:250, 271-272``): the predefined schedule's table
# buffer, DiffusionQM9's dtype probe (diffusion_qm9.py:106) and the
# sinusoidal distance embedding's constant frequencies.
SKIPPED_KEYS = (r"gamma\.gamma", r"buffer", r".*sin_embedding\.frequencies")


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A ``torch.save`` file -> {key: tensor}: a raw state dict, or a
    PyTorch-Lightning checkpoint's ``state_dict``, with one leading
    ``model.`` stripped from each key (reference sampler.py:28-34)."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        # a reference checkpoint carries its hydra / easydict config in
        # ``hyper_parameters`` (save_hyperparameters(), diffusion_qm9.py:41),
        # which the weights-only unpickler refuses; the file is the user's
        # own training artifact, so load it in full
        obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.get("state_dict", obj)
    return {k[len("model."):] if k.startswith("model.") else k: v for k, v in sd.items()}


def load_state(path: str) -> Dict[str, torch.Tensor]:
    """State dict from a ``.npz`` file or a ``torch.save`` file
    (``load_torch_checkpoint``)."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            return {k: torch.from_numpy(data[k]) for k in data.files}
    return load_torch_checkpoint(path)


def detect_stage(sd: Mapping) -> Optional[str]:
    """'coarse', 'denoise' or 'refine' for a state dict in the reference's
    layout of that stage's model, else None."""
    if any(k.startswith(("dynamics.egnn.", "dynamics.gnn.")) for k in sd):
        return "coarse"
    if any(k.startswith("gcl_full_") for k in sd):
        return "denoise"
    if any(k.startswith("gcl_collect") for k in sd):
        return "refine"
    return None


def load_weights(model: nn.Module, path: str, stage: str) -> nn.Module:
    """Strict-load the ``.pt`` / ``.npz`` weights at ``path`` into ``model``,
    the ``stage`` model ('coarse', 'denoise' or 'refine'). ``SKIPPED_KEYS``
    the model does not hold are dropped; a file of another stage raises
    ValueError naming both."""
    own = model.state_dict()
    sd = {k: v for k, v in load_state(path).items()
          if k in own or not any(re.fullmatch(p, k) for p in SKIPPED_KEYS)}
    found = detect_stage(sd)
    if found is not None and found != stage:
        raise ValueError(f"{path} holds {found} weights, but the {stage} model was asked for")
    model.load_state_dict(sd, strict=True)
    return model


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights with the JAX package's initialisers: linear
    weights U(+-1/sqrt(fan_in)) and zero biases, embeddings N(0, 1/width)
    (flax's default), the coordinate heads xavier-uniform scaled by 0.001,
    PositiveLinear weights shifted by -2."""
    def uniform_(t: torch.Tensor, bound: float) -> None:
        t.copy_((torch.rand(t.shape, generator=generator) * 2 - 1) * bound)

    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, PositiveLinear):
                fan_in = module.weight.shape[1]
                uniform_(module.weight, math.sqrt(3.0 / fan_in))
                module.weight.sub_(2.0)
                uniform_(module.bias, 1.0 / math.sqrt(fan_in))
            elif isinstance(module, nn.Linear):
                uniform_(module.weight, 1.0 / math.sqrt(module.weight.shape[1]))
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, nn.Embedding):
                module.weight.copy_(torch.randn(module.weight.shape, generator=generator)
                                    / math.sqrt(module.weight.shape[1]))
        for module in model.modules():   # after the generic pass over its Linears
            head = None
            if isinstance(module, DenseEquivariantUpdate):
                head = module.coord_mlp[4].weight
            elif isinstance(module, DenseEGCL) and module.coord_update:
                head = module.coord_mlp[2].weight
            if head is not None:
                fan_out, fan_in = head.shape
                uniform_(head, 0.001 * math.sqrt(6.0 / (fan_in + fan_out)))
    return model
