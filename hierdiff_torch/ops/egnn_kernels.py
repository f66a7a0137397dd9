"""The fused EGNN layer kernels: wrappers, plain versions, launch counts.

``fused_gcl``, ``fused_coord_update`` and ``fused_gcl_bwd`` are the port of
the Pallas kernels in ``hierdiff_tpu/ops/egnn_pallas.py`` (``fused_gcl``
:141, ``fused_coord_update`` :492, ``fused_gcl_bwd`` :346). Their CUDA
sources are ``csrc/fused_gcl.cu``, ``csrc/fused_coord.cu`` and
``csrc/fused_gcl_bwd.cu``, built by ``ops/_build.py`` at first use.

A wrapper launches its kernel on a CUDA tensor and raises if it cannot; it
takes the plain PyTorch version (``gcl_plain`` / ``coord_update_plain`` /
``gcl_plain_vjp``) only for a tensor on the CPU. The plain versions follow
the XLA layers of ``hierdiff_tpu/ops/egnn.py`` (``DenseGCL`` :197,
``DenseEquivariantUpdate`` :293), including their ``compute_dtype`` casts.
The kernels use bf16 matmul operands with f32 accumulation like the Pallas
kernels, so they agree with the plain versions to tolerance, not bitwise.

Autograd: when a gradient is being recorded, ``fused_gcl`` on CUDA runs as
``FusedGCLFunction`` (forward ``fused_gcl``, backward ``fused_gcl_bwd``, the
counterpart of ``gcl_vjp``); ``fused_coord_update`` has no backward kernel,
as in the JAX package, and raises rather than return a detached result.

``remat_edges`` on a layer puts a non-reentrant ``torch.utils.checkpoint``
around its (B,N,N,H) edge chain in the plain versions, where a gradient is
recorded (``jax.checkpoint`` in ``hierdiff_tpu/ops/egnn.py:239,326``):
``gcl_agg_plain`` in ``gcl_plain``, and the coordinate MLP up to its row sum
in ``coord_update_plain``; autograd then saves the (B,N,·) inputs and
recomputes the chain in the backward. ``FusedGCLFunction`` already saves only
its inputs and agg, and its backward kernel recomputes the edge MLP, so
``remat_edges`` changes nothing there. Block-level ``remat``
(``ops/egnn.DenseEGNN``) recomputes whole blocks, ``fused_gcl`` launches
included; in that recompute (``recompute_context``) the forward reuses the
bf16 weight copies the first forward built, since the parameters have not
changed in between.

Each wrapper adds one to ``launch_counts[name]`` per kernel launch and
nowhere else; ``coord_update_autograd`` counts the coordinate updates that
took the plain, differentiable route (``ops/egnn.py``). ``reset_launch_counts``
sets them all to zero.

Under a profiler (``utils/profiling.py``) ``fused_gcl`` and
``fused_coord_update`` each record a span, ``egnn.fused_gcl`` and
``egnn.fused_coord_update``, from entry to return on either route (attrs
``B``, ``N``, ``H`` of ``h``): the host's time in the wrapper, launch
included.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import Tensor

from hierdiff_torch.ops import _build
from hierdiff_torch.utils.profiling import span

launch_counts: Dict[str, int] = {"fused_gcl": 0, "fused_coord_update": 0, "fused_gcl_bwd": 0,
                                 "coord_update_autograd": 0}

# limits of the CUDA kernels (csrc/edge_mlp.cuh kMaxH, kMaxE)
MAX_HIDDEN = 256
MAX_EDGE_FEATURES = 32
# the real-edge work list of fused_gcl and fused_coord_update: edges per tile
# (csrc/edge_mlp.cuh kTileM) and source rows per block of the list kernels
# (csrc/sm90.cuh kListRows)
GCL_TILE_EDGES = 64
GCL_LIST_ROWS = 32


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# > 0 while a checkpoint recomputes a block (``recompute_context``)
_recomputing = 0


@contextlib.contextmanager
def recompute_context():
    """The context of a checkpoint's recompute: the GCL forward keeps the
    bf16 weight copies of the first forward instead of rebuilding them."""
    global _recomputing
    _recomputing += 1
    try:
        yield
    finally:
        _recomputing -= 1


def checkpoint_context():
    """``torch.utils.checkpoint``'s ``context_fn``: nothing in the first
    forward, ``recompute_context`` in the recompute."""
    return contextlib.nullcontext(), recompute_context()


def checkpointed(on: bool, fn, *args):
    """``fn(*args)``, under a non-reentrant checkpoint when ``on`` and a
    gradient is recorded (no-grad calls run as they always did). No random
    number is drawn inside, so the RNG state is not kept."""
    if not (on and torch.is_grad_enabled()):
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             preserve_rng_state=False,
                                             context_fn=checkpoint_context)


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


def _aggregate(layer, rowsum: Tensor, edge_mask: Tensor) -> Tensor:
    """The layer's aggregation of a masked row sum: ``sum`` divides by its
    normalization factor, ``mean`` by max(sum_j edge_mask_ij, 1)
    (``hierdiff_tpu/ops/egnn.py:244-250``, :329-335)."""
    if layer.aggregation_method == "mean":
        return rowsum / torch.clamp(edge_mask.sum(dim=2), min=1.0)
    return rowsum / layer.normalization_factor


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


def gcl_agg_plain(layer, h: Tensor, edge_attr: Tensor, edge_mask: Tensor) -> Tensor:
    """The GCL's aggregated messages sum_j m_ij * emask_ij / norm (or, with
    mean aggregation, over the row's edge count), (B, N, H) f32: what
    ``fused_gcl`` saves for its backward."""
    dt = layer.compute_dtype
    cast = (lambda v: v.to(dt)) if dt is not None else (lambda v: v)
    e_in, e_out = layer.edge_mlp[0], layer.edge_mlp[2]
    m = F.silu(_pair_preact(h, edge_attr, e_in, dt))
    m = F.silu(_mm(m, e_out.weight.t(), dt, dt) + cast(e_out.bias))
    if layer.attention:
        att_lin = layer.att_mlp[0]
        att = torch.sigmoid(_mm(m, att_lin.weight.t(), dt, dt) + cast(att_lin.bias))
        m = m * att
    return _aggregate(layer, _masked_rowsum(m, edge_mask), edge_mask)


def gcl_plain(layer, h: Tensor, edge_attr: Tensor, edge_mask: Tensor,
              node_mask: Tensor) -> Tensor:
    """Plain version of ``fused_gcl``: one DenseGCL forward."""
    dt = layer.compute_dtype
    agg = checkpointed(layer.remat_edges, gcl_agg_plain, layer, h, edge_attr, edge_mask)
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


def coord_rowsum_plain(layer, h: Tensor, edge_attr: Tensor, coord_diff: Tensor,
                       edge_mask: Tensor) -> Tensor:
    """The coordinate update's edge chain: sum_j coord_diff_ij s_ij emask_ij,
    (B, N, 3), s the (tanh-bounded) scalar of the coordinate MLP."""
    scalar = coord_scalar(layer, h, edge_attr)
    if layer.tanh:
        scalar = torch.tanh(scalar) * layer.coords_range
    return _masked_rowsum(coord_diff * scalar, edge_mask)


def coord_update_plain(layer, h: Tensor, edge_attr: Tensor, coord_diff: Tensor,
                       x: Tensor, edge_mask: Tensor, node_mask: Tensor) -> Tensor:
    """Plain version of ``fused_coord_update``: one DenseEquivariantUpdate."""
    rowsum = checkpointed(layer.remat_edges, coord_rowsum_plain, layer, h, edge_attr,
                          coord_diff, edge_mask)
    return (x + _aggregate(layer, rowsum, edge_mask)) * node_mask


class GclGrads(NamedTuple):
    """Gradients of one DenseGCL, in the JAX package's (in, out) layout
    (``fused_gcl_bwd``'s outputs, egnn_pallas.py:430-441); ``w_att`` (H,)
    and ``b_att`` (1,) are None without attention."""
    dh: Tensor
    de: Tensor
    w_src: Tensor
    w_dst: Tensor
    w_e: Tensor
    b1: Tensor
    w2: Tensor
    b2: Tensor
    w_att: Optional[Tensor]
    b_att: Optional[Tensor]
    w_node_in: Tensor
    b_node_in: Tensor
    w_node_out: Tensor
    b_node_out: Tensor


def gcl_parameters(layer) -> List[torch.nn.Parameter]:
    """The GCL's parameters in the order ``FusedGCLFunction`` takes them."""
    params = [layer.edge_mlp[0].weight, layer.edge_mlp[0].bias, layer.edge_mlp[2].weight,
              layer.edge_mlp[2].bias, layer.node_mlp[0].weight, layer.node_mlp[0].bias,
              layer.node_mlp[2].weight, layer.node_mlp[2].bias]
    if layer.attention:
        params += [layer.att_mlp[0].weight, layer.att_mlp[0].bias]
    return params


def _grads_from_linear(layer, dh: Tensor, de: Tensor, dparams) -> GclGrads:
    """nn.Linear-layout parameter gradients -> GclGrads."""
    hidden = layer.edge_mlp[2].weight.shape[0]
    g_pair, b1, g_w2, b2, g_n1, bn1, g_n2, bn2 = dparams[:8]
    w_att = b_att = None
    if layer.attention:
        w_att, b_att = dparams[8].reshape(hidden), dparams[9].reshape(1)
    return GclGrads(dh, de, g_pair[:, :hidden].t(), g_pair[:, hidden:2 * hidden].t(),
                    g_pair[:, 2 * hidden:].t(), b1, g_w2.t(), b2, w_att, b_att,
                    g_n1.t(), bn1, g_n2.t(), bn2)


def linear_grads(grads: GclGrads) -> List[Tensor]:
    """GclGrads -> gradients of ``gcl_parameters(layer)``, in nn.Linear layout
    (``utils/weights.py:_pair`` for the pair linear's column blocks)."""
    out = [torch.cat([grads.w_src.t(), grads.w_dst.t(), grads.w_e.t()], dim=1), grads.b1,
           grads.w2.t().contiguous(), grads.b2, grads.w_node_in.t().contiguous(),
           grads.b_node_in, grads.w_node_out.t().contiguous(), grads.b_node_out]
    if grads.w_att is not None:
        out += [grads.w_att.reshape(1, -1), grads.b_att.reshape(1)]
    return out


def gcl_plain_vjp(layer, h: Tensor, edge_attr: Tensor, edge_mask: Tensor,
                  node_mask: Tensor, g: Tensor) -> GclGrads:
    """Plain version of ``fused_gcl_bwd``: autograd of ``gcl_plain`` against
    the upstream gradient ``g``. The masks get no gradient."""
    with torch.enable_grad():
        h_ = h.detach().requires_grad_(True)
        e_ = edge_attr.detach().requires_grad_(True)
        params = gcl_parameters(layer)
        inputs = [h_, e_, *params]
        out = gcl_plain(layer, h_, e_, edge_mask, node_mask)
        # with no edge features (E = 0) the edge input is unused: its gradient is empty
        grads = torch.autograd.grad(out, inputs, g, allow_unused=True)
    grads = [torch.zeros_like(x) if d is None else d for x, d in zip(inputs, grads)]
    return _grads_from_linear(layer, grads[0], grads[1], grads[2:])


def records_grad(layer, *tensors: Tensor) -> bool:
    """True when autograd records this call: grad mode is on and an input or
    a parameter of ``layer`` requires a gradient."""
    return torch.is_grad_enabled() and (any(t.requires_grad for t in tensors)
                                        or any(p.requires_grad for p in layer.parameters()))


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_GCL_ARGTYPES = [_P] * 24 + [_I, _I, _I, _I, _F, _I, _I, _I, _P]
_COORD_ARGTYPES = [_P] * 20 + [_I, _I, _I, _I, _F, _F, _I, _I, _I, _P]
_BWD_ARGTYPES = [_P] * 23 + [_I, _I, _I, _I, _F, _I, _I, _I, _P]
_num_sms: Dict[int, int] = {}


# kernel -> (library, symbol, argtypes, restype)
_ENTRIES = {
    "fused_gcl": ("fused_gcl", "hd_fused_gcl", _GCL_ARGTYPES, ctypes.c_int),
    "fused_coord_update": ("fused_coord", "hd_fused_coord", _COORD_ARGTYPES, ctypes.c_int),
    "fused_gcl_bwd": ("fused_gcl_bwd", "hd_fused_gcl_bwd", _BWD_ARGTYPES, ctypes.c_int),
    "fused_gcl_bwd_workspace": ("fused_gcl_bwd", "hd_fused_gcl_bwd_workspace", [_I] * 4,
                                ctypes.c_longlong),
}


@functools.lru_cache(maxsize=None)
def _entry(kernel: str, phase_clocks: bool):
    """The C entry point of ``kernel`` in its (possibly instrumented) build."""
    lib_name, symbol, argtypes, restype = _ENTRIES[kernel]
    fn = getattr(_build.load_library(lib_name, phase_clocks), symbol)
    fn.argtypes = argtypes
    fn.restype = restype
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
    """The edge MLP's operands but W2: W_e (E, H), the biases, and the
    nn.Linear-layout (out, in) halves W_src^T, W_dst^T of the pair linear
    that the wgmma projection reads (csrc/sm90.cuh proj_sm90_kernel)."""
    hidden = mid.weight.shape[0]
    return {"we": _bf16(_pair_weights(linear)[2]), "b1": _f32(linear.bias),
            "b2": _f32(mid.bias), "wsrct": _bf16(linear.weight[:, :hidden]),
            "wdstt": _bf16(linear.weight[:, hidden:2 * hidden])}


def _gcl_kernel_weights(layer) -> dict:
    w = _pair_kernel_weights(layer.edge_mlp[0], layer.edge_mlp[2])
    w["w2"] = _bf16(layer.edge_mlp[2].weight.t())   # (in, out)
    hidden = w["w2"].shape[0]
    if layer.attention:
        w["watt"] = _bf16(layer.att_mlp[0].weight.reshape(hidden))
        w["watt32"] = _f32(layer.att_mlp[0].weight.reshape(hidden))   # backward's dm0 term
        w["batt"] = _f32(layer.att_mlp[0].bias.reshape(1))
    else:   # never read by the kernels; any valid pointer will do
        w["watt"] = w["b2"].new_zeros(hidden, dtype=torch.bfloat16)
        w["watt32"] = w["b2"].new_zeros(hidden)
        w["batt"] = w["b2"].new_zeros(1)
    w["nw1"] = _bf16(layer.node_mlp[0].weight.t())
    w["nb1"] = _f32(layer.node_mlp[0].bias)
    w["nb2"] = _f32(layer.node_mlp[2].bias)
    # nn.Linear layout (out, in): the node kernel's and the backward's operands
    w["nw1t"] = _bf16(layer.node_mlp[0].weight)
    w["nw2t"] = _bf16(layer.node_mlp[2].weight)
    return w


def _coord_kernel_weights(layer) -> dict:
    w = _pair_kernel_weights(layer.coord_mlp[0], layer.coord_mlp[2])
    w["w2t"] = _bf16(layer.coord_mlp[2].weight)   # nn.Linear layout: wgmma's K-major B
    w["whead"] = _bf16(layer.coord_mlp[4].weight.reshape(-1))
    return w


def _param_versions(params) -> tuple:
    return tuple((p.data_ptr(), p._version) for p in params)


def _cached_weights(layer, build, device: torch.device, rebuild: bool = False) -> dict:
    """Transposed bf16 kernel weights, built once per layer and rebuilt when
    a parameter changes (or when ``rebuild`` asks). The cache is keyed on
    each parameter's storage and version counter, which in-place tensor ops
    advance (``copy_``, ``mul_``, the foreach and for-loop optimizer
    steps); the layer drops the cache itself when ``load_state_dict`` or
    ``.to()`` may replace its parameters. Not seen: a parameter replaced by
    plain attribute assignment, and the fused optimizer kernels
    (``torch.optim.AdamW(fused=True)``), which update parameters without
    advancing their version counters (measured on the card). So the
    recorded (training) forward always rebuilds, and ``drop_kernel_caches``
    (``ops/egnn.py``) is for no-grad use after such an update."""
    cached = layer._kernel_weights
    params = list(layer.parameters()) if cached is None else cached[0]
    if params[0].device != device:
        raise ValueError(f"layer weights are on {params[0].device}, inputs on {device}")
    if cached is not None and not rebuild and _param_versions(params) == cached[1]:
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


def _check_layer(layer, h: Tensor, edge_attr: Tensor, hidden: int) -> None:
    if layer.aggregation_method != "sum":
        raise ValueError(f"the kernels aggregate by sum only, as the Pallas kernels do; "
                         f"aggregation_method={layer.aggregation_method!r} takes the plain "
                         f"version (gcl_plain / coord_update_plain)")
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


def _check_gcl_inputs(layer, h: Tensor, edge_attr: Tensor, edge_mask: Tensor,
                      node_mask: Tensor, device: torch.device) -> None:
    b, n, hidden = h.shape
    e_nf = edge_attr.shape[-1]
    _check("h", h, (b, n, hidden), device)
    _check("edge_attr", edge_attr, (b, n, n, e_nf), device)
    _check("edge_mask", edge_mask, (b, n, n, 1), device)
    _check("node_mask", node_mask, (b, n, 1), device)
    _check_layer(layer, h, edge_attr, layer.edge_mlp[2].weight.shape[0])


GCL_FLOAT_SCRATCH = ("proj", "z1h", "heads", "agg")
GCL_INT_SCRATCH = ("rowstart", "totals", "edges")
COORD_FLOAT_SCRATCH = ("proj", "heads", "agg")
COORD_INT_SCRATCH = GCL_INT_SCRATCH


def _edge_list_sizes(kernel: str, b: int, n: int) -> Dict[str, int]:
    """The real-edge work list (csrc/sm90.cuh): ``rowstart`` b*n + 1,
    ``totals`` one per list block, ``edges`` room for every edge, and the
    number of 64-edge tiles a full mask gives. The kernels index edges with
    int32."""
    rows = b * n
    if rows * n >= 2 ** 31:
        raise ValueError(f"{kernel} indexes edges with int32; b*n*n = {rows * n} is too many")
    return {"rowstart": rows + 1, "totals": -(-rows // GCL_LIST_ROWS), "edges": rows * n,
            "tiles": -(-rows * n // GCL_TILE_EDGES)}


def gcl_workspace(b: int, n: int, hidden: int) -> Dict[str, int]:
    """Element counts of ``fused_gcl``'s scratch buffers for h (b, n, hidden).
    int32: the work list (``_edge_list_sizes``). float32: ``proj`` [h W_src |
    h W_dst], ``z1h`` the h half of the node MLP's first layer, ``heads``
    one row of ``hidden`` per possible tile (the part of a source row
    continued from the tile before) and ``agg`` (unless the caller gives
    one). Sized for a full edge mask; what a call uses depends on the mask,
    which stays on the device."""
    ws = _edge_list_sizes("fused_gcl", b, n)
    rows = b * n
    return {**{k: ws[k] for k in GCL_INT_SCRATCH}, "proj": rows * 2 * hidden,
            "z1h": rows * hidden, "heads": ws["tiles"] * hidden, "agg": rows * hidden}


def coord_workspace(b: int, n: int, hidden: int) -> Dict[str, int]:
    """Element counts of ``fused_coord_update``'s scratch buffers for h (b,
    n, hidden): the work list as ``gcl_workspace``'s, ``proj`` [h W_src |
    h W_dst] (float4 reads: first in the allocation), and three floats per
    possible tile (``heads``, the part of a source row continued from the
    tile before) and per node (``agg``, the part that starts in a tile)."""
    ws = _edge_list_sizes("fused_coord_update", b, n)
    rows = b * n
    return {**{k: ws[k] for k in COORD_INT_SCRATCH}, "proj": rows * 2 * hidden,
            "heads": ws["tiles"] * 3, "agg": rows * 3}


def _scratch(ws: Dict[str, int], names, device: torch.device):
    """One allocation of 4-byte elements for the buffers ``names`` (in that
    order) and each one's address, with no views: each view costs host time
    on every call. Returns the tensor, which must outlive the launch, and
    the addresses."""
    scratch = torch.empty(sum(ws[k] for k in names), dtype=torch.float32, device=device)
    ptr, at = {}, scratch.data_ptr()
    for k in names:
        ptr[k], at = at, at + 4 * ws[k]
    return scratch, ptr


def _launch_gcl(layer, h: Tensor, edge_attr: Tensor, edge_mask: Tensor, node_mask: Tensor,
                device: torch.device, agg_out: Optional[Tensor] = None,
                phase_clocks: bool = False) -> Tensor:
    """Launch ``csrc/fused_gcl.cu``; with ``agg_out`` (B,N,H) the aggregated
    messages the kernel computes are left there for the backward, and the
    bf16 weights are rebuilt from the parameters first (``_cached_weights``)."""
    _check_gcl_inputs(layer, h, edge_attr, edge_mask, node_mask, device)
    b, n, hidden = h.shape
    out = torch.empty_like(h)
    if b * n == 0:
        return out
    if agg_out is not None:
        _check("agg_out", agg_out, h.shape, device)
    # a recorded forward rebuilds the weight copies (a fused optimizer step
    # leaves the version counters as they were); its recompute under a
    # checkpoint comes before any step and keeps them
    w = _cached_weights(layer, _gcl_kernel_weights, device,
                        rebuild=agg_out is not None and not _recomputing)
    # the float buffers first, each a multiple of 4 elements so each starts
    # 16-byte aligned for float4 reads, then the int32 work list
    names = [k for k in GCL_FLOAT_SCRATCH + GCL_INT_SCRATCH if k != "agg" or agg_out is None]
    scratch, ptr = _scratch(gcl_workspace(b, n, hidden), names, device)
    if agg_out is not None:
        ptr["agg"] = agg_out.data_ptr()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _entry("fused_gcl", phase_clocks)(
        h.data_ptr(), edge_attr.data_ptr(), edge_mask.data_ptr(), node_mask.data_ptr(),
        w["wsrct"].data_ptr(), w["wdstt"].data_ptr(), w["we"].data_ptr(), w["b1"].data_ptr(),
        w["w2"].data_ptr(), w["b2"].data_ptr(), w["watt"].data_ptr(),
        w["batt"].data_ptr(), w["nw1t"].data_ptr(), w["nb1"].data_ptr(),
        w["nw2t"].data_ptr(), w["nb2"].data_ptr(), ptr["proj"], ptr["z1h"], ptr["rowstart"],
        ptr["totals"], ptr["edges"], ptr["heads"], ptr["agg"], out.data_ptr(),
        b, n, hidden, edge_attr.shape[-1], float(layer.normalization_factor),
        int(layer.attention), int(layer.compute_dtype is torch.bfloat16), _sm_count(device),
        stream)
    if err != 0:
        raise RuntimeError(f"fused_gcl kernel launch failed: CUDA error {err}")
    launch_counts["fused_gcl"] += 1
    return out


def fused_gcl(layer, h: Tensor, edge_attr: Tensor, edge_mask: Tensor,
              node_mask: Tensor, *, phase_clocks: bool = False) -> Tensor:
    """One DenseGCL forward. h (B,N,H), edge_attr (B,N,N,E), edge_mask
    (B,N,N,1), node_mask (B,N,1), all float32. CUDA: ``csrc/fused_gcl.cu``;
    ``phase_clocks`` launches its ``-DHD_PHASE_CLOCKS`` build. When autograd
    records the call, the CUDA path runs as ``FusedGCLFunction``, whose
    backward is ``fused_gcl_bwd``."""
    shape = h.shape
    with span("egnn.fused_gcl", B=shape[0], N=shape[1], H=shape[-1]):
        device = _device_of(h)
        if device is None:
            return gcl_plain(layer, h, edge_attr, edge_mask, node_mask)
        if records_grad(layer, h, edge_attr):
            return FusedGCLFunction.apply(layer, h, edge_attr, edge_mask, node_mask,
                                          *gcl_parameters(layer))
        return _launch_gcl(layer, h, edge_attr, edge_mask, node_mask, device,
                           phase_clocks=phase_clocks)


class FusedGCLFunction(torch.autograd.Function):
    """The GCL on CUDA under autograd, the counterpart of ``gcl_vjp``
    (egnn_pallas.py:444): forward ``fused_gcl`` (which also writes agg),
    backward ``fused_gcl_bwd``. It saves the inputs and agg (B,N,H), no
    (B,N,N,H) tensor. The layer's fp32 parameters are inputs, so autograd
    attributes their gradients to them; the forward rebuilds the layer's
    bf16 copies from them, and the backward reads those same copies."""

    @staticmethod
    def forward(ctx, layer, h, edge_attr, edge_mask, node_mask, *params):
        agg = torch.empty_like(h)
        out = _launch_gcl(layer, h, edge_attr, edge_mask, node_mask, h.device, agg_out=agg)
        ctx.layer = layer
        ctx.save_for_backward(h, edge_attr, edge_mask, node_mask, agg)
        return out

    @staticmethod
    def backward(ctx, g):
        h, edge_attr, edge_mask, node_mask, agg = ctx.saved_tensors
        grads = fused_gcl_bwd(ctx.layer, h, edge_attr, edge_mask, node_mask, g.contiguous(), agg)
        return (None, grads.dh, grads.de, None, None, *linear_grads(grads))


def bwd_edge_grad_floats(hidden: int, e_nf: int) -> int:
    """Floats of the edge-MLP group at the head of the backward's gradient
    buffer, dW2 to db_att padded to 8 floats (layout in csrc/fused_gcl_bwd.cu)."""
    return (hidden * hidden + e_nf * hidden + 3 * hidden + 1 + 7) // 8 * 8


# csrc/fused_gcl_bwd.cu: edges per tile of the edge kernel (kTileM),
# splits of the dW2 GEMM over list positions (kBwdSplits) in whole GEMM
# k-steps (kGemmK), rows per column-sum partial (kColChunk), and the
# alignment of each workspace piece in floats (kWsAlign)
BWD_TILE_EDGES = 64
BWD_SPLITS = 128
BWD_GEMM_K = 32
BWD_COL_CHUNK = 64
BWD_WS_ALIGN = 64


def gcl_bwd_plan(b: int, n: int) -> Dict[str, int]:
    """The fixed order of ``fused_gcl_bwd``'s sums across edges: a pure
    function of (b, n), never of the mask, so two calls on the same inputs
    sum in the same order. The edge kernel writes each real edge's values at
    its list position (the real-edge work list of csrc/sm90.cuh: (b, i, j)
    order); ``positions`` = b*n*n bounds them. ``tiles`` of
    ``BWD_TILE_EDGES`` positions each carry the tile's sums (in edge order)
    of e^T dpre, dpre, dv, m0 dza and dza (dW_e, db1, db2, dw_att, db_att),
    summed over tiles in chunks of ``BWD_COL_CHUNK`` and the chunks in
    order. dW2 = U^T dV is a split-K GEMM: split z sums the real edges among
    positions [z * split_rows, (z + 1) * split_rows), split_rows in whole
    k-steps of ``BWD_GEMM_K``, the splits in order. dhs: each source row's
    list segment in order; dh_dst[b, j]: i = 0 .. n-1 in order, through the
    list position of edge (b, i, j)."""
    _edge_list_sizes("fused_gcl_bwd", b, n)   # the int32 guard
    positions = b * n * n
    tiles = -(-positions // BWD_TILE_EDGES)
    split_rows = -(-positions // BWD_SPLITS)
    return {"positions": positions, "tiles": tiles, "tile_chunks": -(-tiles // BWD_COL_CHUNK),
            "splits": BWD_SPLITS, "split_rows": -(-split_rows // BWD_GEMM_K) * BWD_GEMM_K}


def _wgrad_splits(rows: int) -> int:
    """Splits of the node-level wgrad GEMMs (K = b*n rows): ~256 rows each."""
    return min(32, max(1, -(-rows // 256)))


def gcl_bwd_workspace(b: int, n: int, hidden: int, e_nf: int) -> Dict[str, int]:
    """Floats of each piece of ``fused_gcl_bwd``'s one workspace, in the order
    the C entry carves them (``hd_fused_gcl_bwd_workspace`` gives the same
    total): the node-level buffers (``proj`` .. ``dhdst``), the edge kernel's
    per-position outputs ``u`` and ``dv`` (bf16, two per float) and ``dpre``
    (f32), ``posmap`` (int32, the list position of each dense edge), the work
    list (int32), the per-tile sums (dW_e, db1, db2, dw_att, db_att) and
    their chunk sums, the split-K partials (dW2's and the node-level
    wgrads' share one buffer) and the node column-sum partials. Sized by
    b*n*n, so the host needs no count. List positions are int32
    (``gcl_bwd_plan`` raises past them); element and byte offsets are 64-bit
    in the kernels (dpre alone holds 1.13e8 elements, 451 MB, at b=64,
    n=83, h=256)."""
    plan = gcl_bwd_plan(b, n)
    rows, pos = b * n, plan["positions"]
    tile_floats = (e_nf + 3) * hidden + 1
    return {"proj": rows * 2 * hidden, "cat": rows * 2 * hidden, "dcat": rows * 2 * hidden,
            **{k: rows * hidden for k in ("z1", "o1", "g2", "do1", "dz1", "dagg", "dhs", "dhdst")},
            "u": pos * hidden // 2, "dv": pos * hidden // 2, "dpre": pos * hidden,
            "posmap": pos, "rowstart": rows + 1, "totals": -(-rows // GCL_LIST_ROWS),
            "edges": pos, "tile_part": plan["tiles"] * tile_floats,
            "tile_chunk_part": plan["tile_chunks"] * tile_floats,
            "split_part": max(BWD_SPLITS * hidden * hidden,
                              _wgrad_splits(rows) * 2 * hidden * hidden),
            "col_part": -(-rows // BWD_COL_CHUNK) * 2 * hidden}


def gcl_bwd_workspace_floats(b: int, n: int, hidden: int, e_nf: int) -> int:
    """The workspace's size: each piece rounded up to ``BWD_WS_ALIGN`` floats
    (256 bytes), plus as much again for aligning the start."""
    return BWD_WS_ALIGN + sum(-(-v // BWD_WS_ALIGN) * BWD_WS_ALIGN
                              for v in gcl_bwd_workspace(b, n, hidden, e_nf).values())


def _split_bwd_grads(layer, grads: Tensor, dh: Tensor, de: Tensor) -> GclGrads:
    """Views of the kernel's flat gradient buffer (layout in fused_gcl_bwd.cu)."""
    hidden, e_nf = dh.shape[-1], de.shape[-1]
    offset = 0

    def take(*shape):
        nonlocal offset
        size = math.prod(shape)
        out = grads[offset:offset + size].view(shape)
        offset += size
        return out

    w2, w_e, b1, b2 = take(hidden, hidden), take(e_nf, hidden), take(hidden), take(hidden)
    w_att, b_att = take(hidden), take(1)
    offset = bwd_edge_grad_floats(hidden, e_nf)
    w_src, w_dst = take(hidden, hidden), take(hidden, hidden)
    w_node_in, b_node_in = take(2 * hidden, hidden), take(hidden)
    w_node_out, b_node_out = take(hidden, hidden), take(hidden)
    if not layer.attention:
        w_att = b_att = None
    return GclGrads(dh, de, w_src, w_dst, w_e, b1, w2, b2, w_att, b_att,
                    w_node_in, b_node_in, w_node_out, b_node_out)


def fused_gcl_bwd(layer, h: Tensor, edge_attr: Tensor, edge_mask: Tensor, node_mask: Tensor,
                  g: Tensor, agg: Tensor, *, phase_clocks: bool = False) -> GclGrads:
    """Backward of one DenseGCL forward: the gradients of every input but
    the masks and of every parameter, against the upstream gradient ``g``
    (B,N,H). ``agg`` is the forward's residual (``fused_gcl`` writes it
    under autograd; ``gcl_agg_plain`` computes it). CUDA:
    ``csrc/fused_gcl_bwd.cu``; on CPU tensors ``gcl_plain_vjp`` (``agg``
    unused)."""
    device = _device_of(h)
    if device is None:
        return gcl_plain_vjp(layer, h, edge_attr, edge_mask, node_mask, g)
    return _launch_gcl_bwd(layer, h, edge_attr, edge_mask, node_mask, g, agg, device,
                           phase_clocks)


def _launch_gcl_bwd(layer, h: Tensor, edge_attr: Tensor, edge_mask: Tensor, node_mask: Tensor,
                    g: Tensor, agg: Tensor, device: torch.device,
                    phase_clocks: bool = False) -> GclGrads:
    _check_gcl_inputs(layer, h, edge_attr, edge_mask, node_mask, device)
    _check("g", g, h.shape, device)
    _check("agg", agg, h.shape, device)
    if h.data_ptr() % 16:
        raise ValueError("fused_gcl_bwd reads h in 16-byte vectors: h must be 16-byte aligned")
    b, n, hidden = h.shape
    e_nf = edge_attr.shape[-1]
    ws_floats = gcl_bwd_workspace_floats(b, n, hidden, e_nf)   # raises past int32 list positions
    n_grads = bwd_edge_grad_floats(hidden, e_nf) + 5 * hidden * hidden + 2 * hidden
    if b * n == 0:
        return _split_bwd_grads(layer, h.new_zeros(n_grads), torch.zeros_like(h),
                                torch.zeros_like(edge_attr))
    dh, de = torch.empty_like(h), torch.empty_like(edge_attr)
    grads = torch.empty(n_grads, dtype=torch.float32, device=device)
    w = _cached_weights(layer, _gcl_kernel_weights, device)
    ws = torch.empty(ws_floats, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _entry("fused_gcl_bwd", phase_clocks)(
        g.data_ptr(), h.data_ptr(), edge_attr.data_ptr(), edge_mask.data_ptr(),
        node_mask.data_ptr(), agg.data_ptr(), w["we"].data_ptr(),
        w["b1"].data_ptr(), w["w2"].data_ptr(), w["b2"].data_ptr(), w["watt"].data_ptr(),
        w["watt32"].data_ptr(), w["batt"].data_ptr(), w["nw1"].data_ptr(), w["nb1"].data_ptr(),
        w["nw1t"].data_ptr(), w["nw2t"].data_ptr(), w["wsrct"].data_ptr(),
        w["wdstt"].data_ptr(), ws.data_ptr(), dh.data_ptr(), de.data_ptr(), grads.data_ptr(),
        b, n, hidden, e_nf, float(layer.normalization_factor), int(layer.attention),
        int(layer.compute_dtype is torch.bfloat16), _sm_count(device), stream)
    if err != 0:
        raise RuntimeError(f"fused_gcl_bwd kernel launch failed: CUDA error {err}")
    launch_counts["fused_gcl_bwd"] += 1
    return _split_bwd_grads(layer, grads, dh, de)


def _launch_coord(layer, h: Tensor, edge_attr: Tensor, coord_diff: Tensor, x: Tensor,
                  edge_mask: Tensor, node_mask: Tensor, device: torch.device,
                  phase_clocks: bool = False) -> Tensor:
    """Launch ``csrc/fused_coord.cu``."""
    b, n, hidden = h.shape
    e_nf = edge_attr.shape[-1]
    _check("h", h, (b, n, hidden), device)
    _check("edge_attr", edge_attr, (b, n, n, e_nf), device)
    _check("coord_diff", coord_diff, (b, n, n, 3), device)
    _check("x", x, (b, n, 3), device)
    _check("edge_mask", edge_mask, (b, n, n, 1), device)
    _check("node_mask", node_mask, (b, n, 1), device)
    _check_layer(layer, h, edge_attr, layer.coord_mlp[2].weight.shape[0])
    out = torch.empty_like(x)
    if b * n == 0:
        return out
    w = _cached_weights(layer, _coord_kernel_weights, device)
    scratch, ptr = _scratch(coord_workspace(b, n, hidden),
                            COORD_FLOAT_SCRATCH + COORD_INT_SCRATCH, device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _entry("fused_coord_update", phase_clocks)(
        h.data_ptr(), edge_attr.data_ptr(), coord_diff.data_ptr(), edge_mask.data_ptr(),
        node_mask.data_ptr(), x.data_ptr(), w["wsrct"].data_ptr(), w["wdstt"].data_ptr(),
        w["we"].data_ptr(), w["b1"].data_ptr(), w["w2t"].data_ptr(), w["b2"].data_ptr(),
        w["whead"].data_ptr(), ptr["proj"], ptr["rowstart"], ptr["totals"], ptr["edges"],
        ptr["heads"], ptr["agg"], out.data_ptr(), b, n, hidden, e_nf,
        float(layer.normalization_factor), float(layer.coords_range), int(layer.tanh),
        int(layer.compute_dtype is torch.bfloat16), _sm_count(device), stream)
    if err != 0:
        raise RuntimeError(f"fused_coord_update kernel launch failed: CUDA error {err}")
    launch_counts["fused_coord_update"] += 1
    return out


def fused_coord_update(layer, h: Tensor, edge_attr: Tensor, coord_diff: Tensor,
                       x: Tensor, edge_mask: Tensor, node_mask: Tensor, *,
                       phase_clocks: bool = False) -> Tensor:
    """One DenseEquivariantUpdate forward; positions stay float32.
    CUDA: ``csrc/fused_coord.cu``; ``phase_clocks`` as for ``fused_gcl``.
    On CUDA it raises when autograd would record the call: the kernel has
    no backward, and a detached result would silently drop gradients."""
    shape = h.shape
    with span("egnn.fused_coord_update", B=shape[0], N=shape[1], H=shape[-1]):
        device = _device_of(h)
        if device is None:
            return coord_update_plain(layer, h, edge_attr, coord_diff, x, edge_mask, node_mask)
        if records_grad(layer, h, edge_attr, coord_diff, x):
            raise RuntimeError(
                "fused_coord_update has no backward kernel (nor has the JAX package's Pallas "
                "kernel); call it under torch.no_grad(), or use coord_update_plain when a "
                "gradient is needed (DenseEquivariantUpdate does so)")
        return _launch_coord(layer, h, edge_attr, coord_diff, x, edge_mask, node_mask, device,
                             phase_clocks=phase_clocks)
