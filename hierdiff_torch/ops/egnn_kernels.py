"""The two fused EGNN layer kernels: wrappers, plain versions, launch counts.

``fused_gcl`` and ``fused_coord_update`` are the port of the Pallas kernels
in ``hierdiff_tpu/ops/egnn_pallas.py`` (``fused_gcl`` :141 and
``fused_coord_update`` :492). Their CUDA sources are ``csrc/fused_gcl.cu``
and ``csrc/fused_coord.cu``, built by ``ops/_build.py`` at first use.

A wrapper launches its kernel on a CUDA tensor and raises if it cannot; it
takes the plain PyTorch version (``gcl_plain`` / ``coord_update_plain``)
only for a tensor on the CPU. The plain versions follow the XLA layers of
``hierdiff_tpu/ops/egnn.py`` (``DenseGCL`` :197, ``DenseEquivariantUpdate``
:293), including their ``compute_dtype`` casts. The kernels use bf16 matmul
operands with f32 accumulation like the Pallas kernels, so they agree with
the plain versions to tolerance, not bitwise.

Each wrapper adds one to ``launch_counts[name]`` per kernel launch and
nowhere else; ``reset_launch_counts`` sets them to zero.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import Tensor

from hierdiff_torch.ops import _build

launch_counts: Dict[str, int] = {"fused_gcl": 0, "fused_coord_update": 0}

# limits of the CUDA kernels (csrc/edge_mlp.cuh kMaxH, kMaxE)
MAX_HIDDEN = 256
MAX_EDGE_FEATURES = 32


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# --------------------------------------------------------------------------
# plain versions (the XLA layers' arithmetic)
# --------------------------------------------------------------------------


def _mm(a: Tensor, w: Tensor, dt: Optional[torch.dtype],
        out_dtype: Optional[torch.dtype] = None) -> Tensor:
    """Matmul with optional reduced-precision operands and f32 accumulation
    (``hierdiff_tpu/ops/egnn.py:_mm``)."""
    if dt is None:
        return a @ w
    out = a.to(dt).float() @ w.to(dt).float()
    return out.to(out_dtype or torch.float32)


def _edge_proj(e: Tensor, w_e: Tensor, dt: Optional[torch.dtype]) -> Tensor:
    """e @ w_e, as a per-channel broadcast sum for E <= 4."""
    n_e = e.shape[-1]
    if n_e == 0:
        return e.new_zeros(e.shape[:-1] + (w_e.shape[1],))
    if n_e <= 4:
        out = e[..., 0, None] * w_e[0]
        for k in range(1, n_e):
            out = out + e[..., k, None] * w_e[k]
        return out
    return _mm(e, w_e, dt)


def _masked_rowsum(m: Tensor, edge_mask: Tensor) -> Tensor:
    """sum_j m[b,i,j,:] * edge_mask[b,i,j] in f32 -> (B, N, C)."""
    mask = edge_mask[..., 0] if edge_mask.ndim == 4 else edge_mask
    return torch.einsum("bij,bijc->bic", mask.to(m.dtype).float(), m.float())


def _pair_weights(linear: torch.nn.Linear):
    """Split a pair linear's (H, 2H + E) weight into (in, out) matrices
    W_src (H, H), W_dst (H, H), W_e (E, H)."""
    w = linear.weight
    h = w.shape[0]
    return w[:, :h].t(), w[:, h:2 * h].t(), w[:, 2 * h:].t()


def _pair_preact(h: Tensor, edge_attr: Tensor, linear: torch.nn.Linear,
                 dt: Optional[torch.dtype]) -> Tensor:
    """h_i W_src + h_j W_dst + e_ij W_e + b without the (B,N,N,2H+E) concat."""
    cast = (lambda v: v.to(dt)) if dt is not None else (lambda v: v)
    w_src, w_dst, w_e = _pair_weights(linear)
    return (_mm(h, w_src, dt, dt)[:, :, None, :]
            + _mm(h, w_dst, dt, dt)[:, None, :, :]
            + cast(_edge_proj(edge_attr, w_e, dt)) + cast(linear.bias))


def gcl_plain(layer, h: Tensor, edge_attr: Tensor, edge_mask: Tensor,
              node_mask: Tensor) -> Tensor:
    """Plain version of ``fused_gcl``: one DenseGCL forward."""
    dt = layer.compute_dtype
    cast = (lambda v: v.to(dt)) if dt is not None else (lambda v: v)
    e_in, e_out = layer.edge_mlp[0], layer.edge_mlp[2]
    m = F.silu(_pair_preact(h, edge_attr, e_in, dt))
    m = F.silu(_mm(m, e_out.weight.t(), dt, dt) + cast(e_out.bias))
    if layer.attention:
        att_lin = layer.att_mlp[0]
        att = torch.sigmoid(_mm(m, att_lin.weight.t(), dt, dt) + cast(att_lin.bias))
        m = m * att
    agg = _masked_rowsum(m, edge_mask) / layer.normalization_factor
    n_in, n_out = layer.node_mlp[0], layer.node_mlp[2]
    out = F.silu(_mm(torch.cat([h, agg], dim=-1), n_in.weight.t(), dt) + n_in.bias)
    out = _mm(out, n_out.weight.t(), dt) + n_out.bias
    return (h + out) * node_mask


def coord_scalar(layer, h: Tensor, edge_attr: Tensor) -> Tensor:
    """The coordinate MLP's per-edge scalar before tanh, (B, N, N, 1)."""
    dt = layer.compute_dtype
    cast = (lambda v: v.to(dt)) if dt is not None else (lambda v: v)
    c_in, c_mid, c_head = layer.coord_mlp[0], layer.coord_mlp[2], layer.coord_mlp[4]
    m = F.silu(_pair_preact(h, edge_attr, c_in, dt))
    m = F.silu(_mm(m, c_mid.weight.t(), dt, dt) + cast(c_mid.bias))
    # the scalar head returns to f32: it multiplies coordinate differences
    return _mm(m, c_head.weight.t(), dt)


def coord_update_plain(layer, h: Tensor, edge_attr: Tensor, coord_diff: Tensor,
                       x: Tensor, edge_mask: Tensor, node_mask: Tensor) -> Tensor:
    """Plain version of ``fused_coord_update``: one DenseEquivariantUpdate."""
    scalar = coord_scalar(layer, h, edge_attr)
    if layer.tanh:
        scalar = torch.tanh(scalar) * layer.coords_range
    agg = _masked_rowsum(coord_diff * scalar, edge_mask) / layer.normalization_factor
    return (x + agg) * node_mask


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_GCL_ARGTYPES = [_P] * 17 + [_I, _I, _I, _I, _F, _I, _I, _I, _P]
_COORD_ARGTYPES = [_P] * 14 + [_I, _I, _I, _I, _F, _F, _I, _I, _I, _P]
_num_sms: Dict[int, int] = {}


_ENTRIES = {"fused_gcl": ("fused_gcl", "hd_fused_gcl", _GCL_ARGTYPES),
            "fused_coord_update": ("fused_coord", "hd_fused_coord", _COORD_ARGTYPES)}


@functools.lru_cache(maxsize=None)
def _entry(kernel: str, phase_clocks: bool):
    """The C entry point of ``kernel`` in its (possibly instrumented) build."""
    lib_name, symbol, argtypes = _ENTRIES[kernel]
    fn = getattr(_build.load_library(lib_name, phase_clocks), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _num_sms:
        _num_sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _num_sms[idx]


def _bf16(t: Tensor) -> Tensor:
    return t.detach().to(torch.bfloat16).contiguous()


def _f32(t: Tensor) -> Tensor:
    return t.detach().to(torch.float32).contiguous()


def _pair_kernel_weights(linear: torch.nn.Linear, mid: torch.nn.Linear) -> dict:
    w_src, w_dst, w_e = _pair_weights(linear)
    return {"wsd": _bf16(torch.cat([w_src, w_dst], dim=1)), "we": _bf16(w_e),
            "b1": _f32(linear.bias), "w2": _bf16(mid.weight.t()),
            "b2": _f32(mid.bias)}


def _gcl_kernel_weights(layer) -> dict:
    w = _pair_kernel_weights(layer.edge_mlp[0], layer.edge_mlp[2])
    hidden = w["w2"].shape[0]
    if layer.attention:
        w["watt"] = _bf16(layer.att_mlp[0].weight.reshape(hidden))
        w["batt"] = _f32(layer.att_mlp[0].bias.reshape(1))
    else:   # never read by the kernel; any valid pointer will do
        w["watt"] = w["b2"].new_zeros(hidden, dtype=torch.bfloat16)
        w["batt"] = w["b2"].new_zeros(1)
    w["nw1"] = _bf16(layer.node_mlp[0].weight.t())
    w["nb1"] = _f32(layer.node_mlp[0].bias)
    w["nw2"] = _bf16(layer.node_mlp[2].weight.t())
    w["nb2"] = _f32(layer.node_mlp[2].bias)
    return w


def _coord_kernel_weights(layer) -> dict:
    w = _pair_kernel_weights(layer.coord_mlp[0], layer.coord_mlp[2])
    w["whead"] = _bf16(layer.coord_mlp[4].weight.reshape(-1))
    return w


def _param_versions(params) -> tuple:
    return tuple((p.data_ptr(), p._version) for p in params)


def _cached_weights(layer, build, device: torch.device) -> dict:
    """Transposed bf16 kernel weights, built once per layer and rebuilt when
    a parameter changes. The cache is keyed on each parameter's storage and
    version counter, which every in-place update advances (``copy_``,
    ``mul_``, an optimizer step); the layer drops the cache itself when
    ``load_state_dict`` or ``.to()`` may replace its parameters. A parameter
    replaced by plain attribute assignment is not seen."""
    cached = layer._kernel_weights
    params = list(layer.parameters()) if cached is None else cached[0]
    if params[0].device != device:
        raise ValueError(f"layer weights are on {params[0].device}, inputs on {device}")
    if cached is not None and _param_versions(params) == cached[1]:
        return cached[2]
    with torch.no_grad():
        weights = build(layer)
    layer._kernel_weights = (params, _param_versions(params), weights)
    return weights


def _check(name: str, t: Tensor, shape, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_layer(h: Tensor, edge_attr: Tensor, hidden: int) -> None:
    if hidden % 16 != 0 or hidden > MAX_HIDDEN or h.shape[-1] != hidden:
        raise ValueError(f"kernel needs hidden width % 16 == 0 and <= {MAX_HIDDEN} "
                         f"matching h; got layer {hidden}, h {h.shape[-1]}")
    if edge_attr.shape[-1] > MAX_EDGE_FEATURES:
        raise ValueError(f"kernel takes at most {MAX_EDGE_FEATURES} edge features, "
                         f"got {edge_attr.shape[-1]}")


def _device_of(h: Tensor) -> Optional[torch.device]:
    """None for CPU tensors (plain version), the device for CUDA tensors."""
    if h.device.type == "cpu":
        return None
    if h.device.type != "cuda":
        raise ValueError(f"no kernel for device {h.device}")
    return h.device


def fused_gcl(layer, h: Tensor, edge_attr: Tensor, edge_mask: Tensor,
              node_mask: Tensor, *, phase_clocks: bool = False) -> Tensor:
    """One DenseGCL forward. h (B,N,H), edge_attr (B,N,N,E), edge_mask
    (B,N,N,1), node_mask (B,N,1), all float32. CUDA: ``csrc/fused_gcl.cu``;
    ``phase_clocks`` launches its ``-DHD_PHASE_CLOCKS`` build."""
    device = _device_of(h)
    if device is None:
        return gcl_plain(layer, h, edge_attr, edge_mask, node_mask)
    b, n, hidden = h.shape
    e_nf = edge_attr.shape[-1]
    _check("h", h, (b, n, hidden), device)
    _check("edge_attr", edge_attr, (b, n, n, e_nf), device)
    _check("edge_mask", edge_mask, (b, n, n, 1), device)
    _check("node_mask", node_mask, (b, n, 1), device)
    _check_layer(h, edge_attr, layer.edge_mlp[2].weight.shape[0])
    out = torch.empty_like(h)
    if b * n == 0:
        return out
    w = _cached_weights(layer, _gcl_kernel_weights, device)
    proj = torch.empty((b * n, 2 * hidden), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _entry("fused_gcl", phase_clocks)(
        h.data_ptr(), edge_attr.data_ptr(), edge_mask.data_ptr(), node_mask.data_ptr(),
        w["wsd"].data_ptr(), w["we"].data_ptr(), w["b1"].data_ptr(),
        w["w2"].data_ptr(), w["b2"].data_ptr(), w["watt"].data_ptr(),
        w["batt"].data_ptr(), w["nw1"].data_ptr(), w["nb1"].data_ptr(),
        w["nw2"].data_ptr(), w["nb2"].data_ptr(), proj.data_ptr(), out.data_ptr(),
        b, n, hidden, e_nf, float(layer.normalization_factor), int(layer.attention),
        int(layer.compute_dtype is torch.bfloat16), _sm_count(device), stream)
    if err != 0:
        raise RuntimeError(f"fused_gcl kernel launch failed: CUDA error {err}")
    launch_counts["fused_gcl"] += 1
    return out


def fused_coord_update(layer, h: Tensor, edge_attr: Tensor, coord_diff: Tensor,
                       x: Tensor, edge_mask: Tensor, node_mask: Tensor, *,
                       phase_clocks: bool = False) -> Tensor:
    """One DenseEquivariantUpdate forward; positions stay float32.
    CUDA: ``csrc/fused_coord.cu``; ``phase_clocks`` as for ``fused_gcl``."""
    device = _device_of(h)
    if device is None:
        return coord_update_plain(layer, h, edge_attr, coord_diff, x, edge_mask, node_mask)
    b, n, hidden = h.shape
    e_nf = edge_attr.shape[-1]
    _check("h", h, (b, n, hidden), device)
    _check("edge_attr", edge_attr, (b, n, n, e_nf), device)
    _check("coord_diff", coord_diff, (b, n, n, 3), device)
    _check("x", x, (b, n, 3), device)
    _check("edge_mask", edge_mask, (b, n, n, 1), device)
    _check("node_mask", node_mask, (b, n, 1), device)
    _check_layer(h, edge_attr, layer.coord_mlp[2].weight.shape[0])
    out = torch.empty_like(x)
    if b * n == 0:
        return out
    w = _cached_weights(layer, _coord_kernel_weights, device)
    proj = torch.empty((b * n, 2 * hidden), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _entry("fused_coord_update", phase_clocks)(
        h.data_ptr(), edge_attr.data_ptr(), coord_diff.data_ptr(), edge_mask.data_ptr(),
        node_mask.data_ptr(), x.data_ptr(), w["wsd"].data_ptr(), w["we"].data_ptr(),
        w["b1"].data_ptr(), w["w2"].data_ptr(), w["b2"].data_ptr(),
        w["whead"].data_ptr(), proj.data_ptr(), out.data_ptr(),
        b, n, hidden, e_nf, float(layer.normalization_factor), float(layer.coords_range),
        int(layer.tanh), int(layer.compute_dtype is torch.bfloat16), _sm_count(device),
        stream)
    if err != 0:
        raise RuntimeError(f"fused_coord_update kernel launch failed: CUDA error {err}")
    launch_counts["fused_coord_update"] += 1
    return out
