"""PyTorch port of the dense EGNN layers (hierdiff_torch/ops/egnn.py) against
the JAX package's XLA layers and its Pallas kernels, on the same weights.

The port's plain path is held to the XLA layers in float32 (JAX at HIGHEST
matmul precision); it is also held to the interpreted Pallas kernels, whose
bf16 matmul operands set the 2e-2 bar (tests/test_pallas_interpret.py). The
CUDA kernels are held to the plain path on the card (``gpu`` marker here,
and chip_smoke.py).
"""

import copy
import functools

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from hierdiff_torch.ops import _build
from hierdiff_torch.ops import egnn as te
from hierdiff_torch.ops import egnn_kernels as ek
from hierdiff_torch.utils import weights as tw
from hierdiff_tpu.ops import egnn as je

# float32 sums of <= 2H + E terms in another order: ~1e-6 of the largest value
F32_REL = 1e-5
PALLAS_REL = 2e-2


@pytest.fixture(autouse=True)
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.fixture()
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(out - ref).max() / (np.abs(ref).max() + 1e-9))


def _inputs(b=3, n=9, h=32, e_nf=2, seed=0):
    rng = np.random.default_rng(seed)
    counts = rng.integers(3, n + 1, size=b)
    counts[0] = n
    nm = (np.arange(n)[None, :] < counts[:, None]).astype(np.float32)[..., None]
    em = (nm * np.transpose(nm, (0, 2, 1)) * (1 - np.eye(n, dtype=np.float32)))[..., None]
    hh = rng.standard_normal((b, n, h)).astype(np.float32) * nm
    x = rng.standard_normal((b, n, 3)).astype(np.float32) * 2 * nm
    e = rng.standard_normal((b, n, n, e_nf)).astype(np.float32)
    return hh, x, e, em, nm


def _holey(hh, nm, seed=0):
    """Masks that prefix masks never give: node masks with random members
    (node 0 absent in every other molecule), ~20% of the real edges masked
    out, and nonzero h in the padded rows (the kernel computes only the
    edges its edge mask holds)."""
    rng = np.random.default_rng(seed + 100)
    b, n = nm.shape[:2]
    nm = (rng.random((b, n, 1)) < 0.7).astype(np.float32)
    nm[::2, 0] = 0.0
    em = nm * np.transpose(nm, (0, 2, 1)) * (1 - np.eye(n, dtype=np.float32))
    em = (em * (rng.random((b, n, n)) >= 0.2)).astype(np.float32)[..., None]
    return rng.standard_normal(hh.shape).astype(np.float32), em, nm


def _holey_coords(hh, nm, seed=0):
    """``_holey``'s masks, with positions inside the new node mask and their
    coordinate differences: h, x, coord_diff, edge_mask, node_mask."""
    hh, em, nm = _holey(hh, nm, seed)
    rng = np.random.default_rng(seed + 200)
    x = rng.standard_normal((*nm.shape[:2], 3)).astype(np.float32) * 2 * nm
    return hh, x, np.asarray(je.coord2diff_dense(x, 0.0)[1]), em, nm


def _port_state(mapper, params, prefix="m"):
    out = {}
    mapper(out, prefix, params)
    return {k[len(prefix) + 1:]: torch.from_numpy(np.array(v)) for k, v in out.items()}


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _gcl_pair(h, e_nf, attention, cd=None, seed=0, **jax_kw):
    hh, x, e, em, nm = _inputs(h=h, e_nf=e_nf, seed=seed)
    jl = je.DenseGCL(hidden_nf=h, normalization_factor=10.0, attention=attention, **jax_kw)
    params = jl.init(jax.random.PRNGKey(seed), hh, e, nm, em)
    port = te.DenseGCL(h, e_nf, normalization_factor=10.0, attention=attention, compute_dtype=cd)
    port.load_state_dict(_port_state(tw._gcl, params["params"]), strict=True)
    return jl, params, port, (hh, x, e, em, nm)


def _equiv_pair(h, e_nf, tanh, cd=None, seed=1, **jax_kw):
    hh, x, e, em, nm = _inputs(h=h, e_nf=e_nf, seed=seed)
    _, cdiff = je.coord2diff_dense(x, 0.0)
    cdiff = np.asarray(cdiff)
    jl = je.DenseEquivariantUpdate(hidden_nf=h, normalization_factor=10.0, tanh=tanh,
                                   coords_range=5.0, **jax_kw)
    params = jl.init(jax.random.PRNGKey(seed), hh, x, cdiff, e, nm, em)
    # a head at full scale (the init is 1e-3), so tanh and the sum are exercised
    params = jax.tree_util.tree_map(lambda v: v, params)
    params["params"]["coord_head_kernel"] = params["params"]["coord_head_kernel"] * 1000.0
    port = te.DenseEquivariantUpdate(h, e_nf, normalization_factor=10.0, tanh=tanh,
                                     coords_range=5.0, compute_dtype=cd)
    port.load_state_dict(_port_state(tw._equiv, params["params"]), strict=True)
    return jl, params, port, (hh, x, cdiff, e, em, nm)


@pytest.mark.parametrize("masks", ["prefix", "holey"])
@pytest.mark.parametrize("attention", [True, False])
@pytest.mark.parametrize("e_nf", [2, 24])
def test_gcl_matches_xla(attention, e_nf, masks):
    jl, params, port, (hh, x, e, em, nm) = _gcl_pair(32, e_nf, attention)
    if masks == "holey":
        hh, em, nm = _holey(hh, nm)
    with jax.default_matmul_precision("highest"):
        ref = jl.apply(params, hh, e, nm, em)
    with torch.no_grad():
        out = port(*_t(hh, e, nm, em))
    assert _rel(out, ref) < F32_REL


@pytest.mark.parametrize("masks", ["prefix", "holey"])
@pytest.mark.parametrize("tanh", [True, False])
@pytest.mark.parametrize("e_nf", [2, 24])
def test_equivariant_update_matches_xla(tanh, e_nf, masks):
    jl, params, port, (hh, x, cdiff, e, em, nm) = _equiv_pair(32, e_nf, tanh)
    if masks == "holey":
        hh, x, cdiff, em, nm = _holey_coords(hh, nm)
    with jax.default_matmul_precision("highest"):
        ref = jl.apply(params, hh, x, cdiff, e, nm, em)
    with torch.no_grad():
        out = port(*_t(hh, x, cdiff, e, nm, em))
    assert _rel(out, ref) < F32_REL


def test_bf16_compute_dtype_matches_xla_bf16():
    """compute_dtype='bfloat16' follows the XLA layers' casts; the two
    frameworks round bf16 elementwise results at different points inside
    silu/sigmoid, so the bar is the bf16 kernels' 2e-2."""
    jl, params, port, (hh, x, e, em, nm) = _gcl_pair(32, 2, True, cd="bfloat16",
                                                    compute_dtype="bfloat16")
    with torch.no_grad():
        assert _rel(port(*_t(hh, e, nm, em)), jl.apply(params, hh, e, nm, em)) < PALLAS_REL
    jl, params, port, (hh, x, cdiff, e, em, nm) = _equiv_pair(32, 2, True, cd="bfloat16",
                                                             compute_dtype="bfloat16")
    with torch.no_grad():
        out = port(*_t(hh, x, cdiff, e, nm, em))
    assert _rel(out, jl.apply(params, hh, x, cdiff, e, nm, em)) < PALLAS_REL


@pytest.mark.parametrize("sin_embedding", [False, True])
def test_block_matches_xla(sin_embedding):
    h, e_nf = 32, (24 if sin_embedding else 2)
    hh, x, _, em, nm = _inputs(h=h)
    d0, _ = je.coord2diff_dense(x, 1.0)
    d0 = np.asarray(je.sinusoids_embedding(d0) if sin_embedding else d0)
    jb = je.DenseEquivariantBlock(hidden_nf=h, n_layers=2, attention=True, tanh=True,
                                  coords_range=5.0, norm_constant=0.0,
                                  normalization_factor=10.0, sin_embedding=sin_embedding)
    params = jb.init(jax.random.PRNGKey(2), hh, x, d0, nm, em)
    state = {}
    for name, sub in params["params"].items():
        (tw._equiv if name == "gcl_equiv" else tw._gcl)(state, name, sub)
    port = te.DenseEquivariantBlock(h, e_nf, n_layers=2, attention=True, tanh=True,
                                    coords_range=5.0, norm_constant=0.0,
                                    normalization_factor=10.0, sin_embedding=sin_embedding)
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()},
                         strict=True)
    with jax.default_matmul_precision("highest"):
        ref_h, ref_x = jb.apply(params, hh, x, d0, nm, em)
    with torch.no_grad():
        out_h, out_x = port(*_t(hh, x, d0, nm, em))
    assert _rel(out_h, ref_h) < F32_REL and _rel(out_x, ref_x) < F32_REL


@pytest.mark.parametrize("attention,sin_embedding", [(True, False), (False, True)])
def test_egnn_matches_xla(attention, sin_embedding):
    h = 32
    hh, x, _, em, nm = _inputs(h=h)
    feats = hh[..., :9]
    kw = dict(hidden_nf=h, n_layers=2, inv_sublayers=2, attention=attention, tanh=True,
              coords_range=30.0, norm_constant=0.0, normalization_factor=10.0,
              sin_embedding=sin_embedding)
    jg = je.DenseEGNN(**kw)
    params = jg.init(jax.random.PRNGKey(4), feats, x, nm, em)
    state = tw.flax_to_numpy_state({"dynamics": {"egnn": params["params"]}})
    port = te.DenseEGNN(9, **kw)
    port.load_state_dict({k[len("dynamics.egnn."):]: torch.from_numpy(np.array(v))
                          for k, v in state.items()}, strict=True)
    with jax.default_matmul_precision("highest"):
        ref_h, ref_x = jg.apply(params, feats, x, nm, em)
    with torch.no_grad():
        out_h, out_x = port(*_t(feats, x, nm, em))
    assert _rel(out_h, ref_h) < F32_REL and _rel(out_x, ref_x) < F32_REL


@pytest.mark.parametrize("masks", ["prefix", "holey"])
@pytest.mark.parametrize("cd", [None, "bfloat16"])
def test_layers_match_pallas_interpret(interpret_pallas, cd, masks):
    """The port's layers against the JAX fused kernels (fused_gcl,
    fused_coord_update) run through the Pallas interpreter, on prefix masks
    and on holey ones (``_holey``)."""
    jl, params, port, (hh, x, e, em, nm) = _gcl_pair(32, 2, True, cd=cd)
    if masks == "holey":
        hh, em, nm = _holey(hh, nm)
    jk = je.DenseGCL(hidden_nf=32, normalization_factor=10.0, attention=True,
                     use_pallas=True, compute_dtype=cd)
    with torch.no_grad():
        out = port(*_t(hh, e, nm, em))
    assert _rel(out, jk.apply(params, hh, e, nm, em)) < PALLAS_REL

    jl, params, port, (hh, x, cdiff, e, em, nm) = _equiv_pair(32, 2, True, cd=cd)
    if masks == "holey":
        hh, x, cdiff, em, nm = _holey_coords(hh, nm)
    jk = je.DenseEquivariantUpdate(hidden_nf=32, normalization_factor=10.0, tanh=True,
                                   coords_range=5.0, use_pallas=True, compute_dtype=cd)
    with torch.no_grad():
        out = port(*_t(hh, x, cdiff, e, nm, em))
    assert _rel(out, jk.apply(params, hh, x, cdiff, e, nm, em)) < PALLAS_REL


def test_cpu_wrappers_take_the_plain_version_and_do_not_count():
    _, _, port, (hh, x, e, em, nm) = _gcl_pair(32, 2, True)
    before = dict(ek.launch_counts)
    with torch.no_grad():
        out = ek.fused_gcl(port, *_t(hh, e, em, nm))
        ref = ek.gcl_plain(port, *_t(hh, e, em, nm))
    assert torch.equal(out, ref)
    assert ek.launch_counts == before


def test_kernel_weight_layout_and_cache_invalidation():
    """The cached kernel operands are the pair linear's W_src and W_dst
    halves (nn.Linear layout, as the projection kernel reads them), and W_e,
    W2 and the node MLP, transposed to (in, out), all cast to bf16. The
    cache is reused while the parameters stand still and rebuilt after an
    in-place update (mul_, an optimizer step, load_state_dict) or .to()."""
    _, _, port, _ = _gcl_pair(32, 2, True)
    cached = lambda: ek._cached_weights(port, ek._gcl_kernel_weights, torch.device("cpu"))  # noqa: E731
    w = cached()
    w0 = port.edge_mlp[0].weight.detach()
    assert torch.equal(w["wsrct"], w0[:, :32].bfloat16())
    assert torch.equal(w["wdstt"], w0[:, 32:64].bfloat16())
    assert torch.equal(w["we"], w0[:, 64:].t().bfloat16())
    assert torch.equal(w["w2"], port.edge_mlp[2].weight.detach().t().bfloat16())
    assert torch.equal(w["nw1"], port.node_mlp[0].weight.detach().t().bfloat16())
    assert w["wsrct"].is_contiguous() and w["wdstt"].is_contiguous() and w["nw1"].is_contiguous()
    assert cached() is w

    with torch.no_grad():
        port.edge_mlp[2].weight.mul_(2.0)
    w = cached()
    assert torch.equal(w["w2"], port.edge_mlp[2].weight.detach().t().bfloat16())

    opt = torch.optim.SGD(port.parameters(), lr=0.1)
    for p in port.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    w = cached()
    assert torch.equal(w["nw1"], port.node_mlp[0].weight.detach().t().bfloat16())

    port.load_state_dict({k: v * 0.5 for k, v in port.state_dict().items()})
    w = cached()
    assert torch.equal(w["w2"], port.edge_mlp[2].weight.detach().t().bfloat16())
    assert cached() is w

    port.to(torch.float32)
    assert port._kernel_weights is None and cached() is not w


@pytest.mark.parametrize("n", [1, 32, 83])
def test_gcl_workspace_sizes(n):
    """fused_gcl's scratch: the work list holds every edge of a full mask,
    one list block per 32 source rows, one heads row per possible tile, and
    the node-level buffers one row (two for proj) per node."""
    ws = ek.gcl_workspace(64, n, 256)
    rows = 64 * n
    assert ws == {"rowstart": rows + 1, "totals": -(-rows // ek.GCL_LIST_ROWS),
                  "edges": rows * n, "proj": rows * 512, "z1h": rows * 256,
                  "heads": -(-rows * n // ek.GCL_TILE_EDGES) * 256, "agg": rows * 256}
    assert set(ws) == set(ek.GCL_INT_SCRATCH + ek.GCL_FLOAT_SCRATCH)
    # the float buffers lead one allocation: each must start 16-byte aligned
    # for the kernels' float4 loads
    assert all(ws[k] % 4 == 0 for k in ek.GCL_FLOAT_SCRATCH)
    assert ws["totals"] * ek.GCL_LIST_ROWS >= rows > (ws["totals"] - 1) * ek.GCL_LIST_ROWS
    assert ws["heads"] // 256 * ek.GCL_TILE_EDGES >= rows * n


def test_gcl_workspace_rejects_int32_overflow():
    with pytest.raises(ValueError, match="int32"):
        ek.gcl_workspace(4096, 1024, 256)


@pytest.mark.parametrize("n", [1, 32, 83])
def test_coord_workspace_sizes(n):
    """fused_coord_update's scratch: fused_gcl's work list, the projections
    (first in the allocation, for float4 reads), and three floats per
    possible tile and per node for the row sums."""
    ws = ek.coord_workspace(64, n, 256)
    rows = 64 * n
    tiles = -(-rows * n // ek.GCL_TILE_EDGES)
    assert ws == {"rowstart": rows + 1, "totals": -(-rows // ek.GCL_LIST_ROWS),
                  "edges": rows * n, "proj": rows * 512, "heads": tiles * 3, "agg": rows * 3}
    assert set(ws) == set(ek.COORD_INT_SCRATCH + ek.COORD_FLOAT_SCRATCH)
    assert ek.COORD_FLOAT_SCRATCH[0] == "proj" and ws["proj"] % 4 == 0
    assert {k: ws[k] for k in ek.GCL_INT_SCRATCH} == {
        k: v for k, v in ek.gcl_workspace(64, n, 256).items() if k in ek.GCL_INT_SCRATCH}


def test_coord_workspace_rejects_int32_overflow():
    with pytest.raises(ValueError, match="fused_coord_update indexes edges with int32"):
        ek.coord_workspace(4096, 1024, 256)


@pytest.mark.parametrize("n", [1, 32, 83])
def test_gcl_bwd_workspace_sizes(n):
    """fused_gcl_bwd's one workspace: the node-level buffers, the edge
    kernel's per-position outputs sized by the dense b*n*n positions (u, dv
    bf16, dpre f32), the position map and work list, the per-tile sums, the
    chunk partials and the split-K partials; each piece rounded to 256 bytes
    in the total, plus the start's alignment."""
    b, hid, e_nf = 64, 256, 2
    rows, pos = b * n, b * n * n
    plan = ek.gcl_bwd_plan(b, n)
    tiles = -(-pos // ek.BWD_TILE_EDGES)
    assert plan == {"positions": pos, "tiles": tiles, "tile_chunks": -(-tiles // 64),
                    "splits": 128, "split_rows": -(-(-(-pos // 128)) // 32) * 32}
    ws = ek.gcl_bwd_workspace(b, n, hid, e_nf)
    assert list(ws)[:3] == ["proj", "cat", "dcat"] and ws["proj"] == rows * 2 * hid
    assert all(ws[k] == rows * hid for k in ("z1", "o1", "g2", "do1", "dz1", "dagg", "dhs", "dhdst"))
    assert ws["u"] * 2 == ws["dv"] * 2 == ws["dpre"] == pos * hid
    assert ws["posmap"] == ws["edges"] == pos and ws["rowstart"] == rows + 1
    assert ws["totals"] == -(-rows // ek.GCL_LIST_ROWS)
    assert ws["tile_part"] == tiles * ((e_nf + 3) * hid + 1)
    assert ws["tile_chunk_part"] == plan["tile_chunks"] * ((e_nf + 3) * hid + 1)
    assert ws["split_part"] == max(128 * hid * hid, min(32, -(-rows // 256)) * 2 * hid * hid)
    assert ws["col_part"] == -(-rows // 64) * 2 * hid
    total = ek.gcl_bwd_workspace_floats(b, n, hid, e_nf)
    assert total == 64 + sum(-(-v // 64) * 64 for v in ws.values())
    # u, dv and dpre alone: 8 bytes per position and channel
    assert total * 4 > 8 * pos * hid
    if n == 83:   # 113 M elements of dpre: below 2^31, so are the list positions
        assert pos < ws["dpre"] < 2 ** 31


def test_gcl_bwd_workspace_rejects_int32_overflow():
    with pytest.raises(ValueError, match="fused_gcl_bwd indexes edges with int32"):
        ek.gcl_bwd_workspace(4096, 1024, 256, 2)


def _in_order(parts):
    """The sum of ``parts`` taken first to last, as the kernels sum partials."""
    total = torch.zeros_like(parts[0])
    for part in parts:
        total = total + part
    return total


def _bwd_model(layer, h, e, em, nm, g):
    """A plain-torch model of fused_gcl_bwd's data flow in f32: the per-edge
    values the edge kernel writes at each real edge's list position, then
    every sum across edges in the order ``gcl_bwd_plan`` fixes."""
    b, n, hid = h.shape
    plan = ek.gcl_bwd_plan(b, n)
    e_in, e_out = layer.edge_mlp[0], layer.edge_mlp[2]
    with torch.enable_grad():
        h_ = h.clone().requires_grad_(True)
        pre = ek._pair_preact(h_, e, e_in, None)
        pre.retain_grad()
        v = torch.nn.functional.silu(pre) @ e_out.weight.t() + e_out.bias
        v.retain_grad()
        m0 = torch.nn.functional.silu(v)
        za = m0[..., :1] * 0.0
        if layer.attention:
            za = m0 @ layer.att_mlp[0].weight.t() + layer.att_mlp[0].bias
            za.retain_grad()
        m1 = m0 * torch.sigmoid(za) if layer.attention else m0
        agg = ek._masked_rowsum(m1, em) / layer.normalization_factor
        n_in, n_out = layer.node_mlp[0], layer.node_mlp[2]
        out = (h_ + n_out(torch.nn.functional.silu(n_in(torch.cat([h_, agg], -1))))) * nm
        out.backward(g)
    # the work list: the real edges in (b, i, j) order, each row's segment,
    # and every real edge's list position
    real = em[..., 0].reshape(-1) != 0
    edges = real.nonzero()[:, 0]
    rowstart = torch.cat([torch.zeros(1, dtype=torch.long),
                          real.reshape(b * n, n).sum(1).cumsum(0)])
    posmap = torch.full((b * n * n,), -1, dtype=torch.long)
    posmap[edges] = torch.arange(len(edges))
    flat = lambda t: t.detach().reshape(b * n * n, -1)[edges]  # noqa: E731
    u, dv, dpre, m0 = (flat(t) for t in (torch.nn.functional.silu(pre), v.grad, pre.grad, m0))
    dza = flat(za.grad) if layer.attention else torch.zeros(len(edges), 1)
    sr, tile = plan["split_rows"], ek.BWD_TILE_EDGES
    w2 = _in_order([u[z * sr:(z + 1) * sr].t() @ dv[z * sr:(z + 1) * sr]
                    for z in range(plan["splits"])])
    e_real = e.reshape(b * n * n, -1)[edges]
    tile_sums = [torch.cat([(e_real[t:t + tile].t() @ dpre[t:t + tile]).reshape(-1),
                            dpre[t:t + tile].sum(0), dv[t:t + tile].sum(0),
                            (m0 * dza)[t:t + tile].sum(0), dza[t:t + tile].sum(0)])
                 for t in range(0, len(edges), tile)]
    sums = _in_order([_in_order(tile_sums[c:c + ek.BWD_COL_CHUNK])
                      for c in range(0, len(tile_sums), ek.BWD_COL_CHUNK)])
    e_nf = e.shape[-1]
    we, b1, b2, w_att, b_att = sums.split([e_nf * hid, hid, hid, hid, 1])
    dhs = torch.stack([dpre[rowstart[r]:rowstart[r + 1]].sum(0) for r in range(b * n)])
    pm = posmap.reshape(b, n, n)
    dh_dst = torch.stack([_in_order([dpre[pm[bb, i, j]] if pm[bb, i, j] >= 0 else torch.zeros(hid)
                                     for i in range(n)])
                          for bb in range(b) for j in range(n)])
    hf = h.reshape(b * n, hid)
    return {"w2": w2, "w_e": we.reshape(e_nf, hid), "b1": b1, "b2": b2, "w_att": w_att,
            "b_att": b_att, "w_src": hf.t() @ dhs, "w_dst": hf.t() @ dh_dst}


@pytest.mark.parametrize("masks", ["prefix", "holey"])
@pytest.mark.parametrize("attention", [True, False])
def test_gcl_bwd_fixed_order_sums_match_plain_vjp(attention, masks):
    """The sums across edges that fused_gcl_bwd takes outside its edge kernel
    (dW2 split-K over list positions, dW_e / db1 / db2 / dw_att / db_att over
    the tiles' own sums, dhs over row segments, dh_dst through the position
    map in source-row order), in the fixed order that
    ``gcl_bwd_plan(b, n)`` gives for any mask, held by a plain-torch model
    against ``gcl_plain_vjp`` (f32, CPU)."""
    _, _, port, _ = _gcl_pair(32, 2, attention)
    hh, _, e, em, nm = _inputs(b=4, n=12, h=32, seed=3)
    if masks == "holey":
        hh, em, nm = _holey(hh, nm, seed=3)
    th, te_, tem, tnm = _t(hh, e, em, nm)
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(hh.shape).astype(np.float32))
    # the real edges span several dW2 splits and several tiles
    assert int((tem != 0).sum()) > 2 * max(ek.gcl_bwd_plan(4, 12)["split_rows"], ek.BWD_TILE_EDGES)
    got = _bwd_model(port, th, te_, tem, tnm, g)
    ref = ek.gcl_plain_vjp(port, th, te_, tem, tnm, g)
    if not attention:
        assert ref.w_att is None and float(got["w_att"].abs().max()) == 0.0
        del got["w_att"], got["b_att"]
    for name, value in got.items():
        assert _rel(value, getattr(ref, name).reshape(value.shape)) < F32_REL, name


def test_coord_kernel_weight_layout():
    """The coordinate kernel's cached operands: the pair linear's W_src and
    W_dst halves and W2 in nn.Linear layout (wgmma's K-major B), W_e, the
    biases and the head, in bf16 (biases f32)."""
    _, _, port, _ = _equiv_pair(32, 2, True)
    w = ek._cached_weights(port, ek._coord_kernel_weights, torch.device("cpu"))
    pair = port.coord_mlp[0].weight.detach()
    assert sorted(w) == ["b1", "b2", "w2t", "wdstt", "we", "whead", "wsrct"]
    assert torch.equal(w["wsrct"], pair[:, :32].bfloat16())
    assert torch.equal(w["wdstt"], pair[:, 32:64].bfloat16())
    assert torch.equal(w["we"], pair[:, 64:].t().bfloat16())
    assert torch.equal(w["w2t"], port.coord_mlp[2].weight.detach().bfloat16())
    assert torch.equal(w["whead"], port.coord_mlp[4].weight.detach().reshape(-1).bfloat16())
    assert torch.equal(w["b1"], port.coord_mlp[0].bias.detach())
    assert all(v.is_contiguous() for v in w.values())


def test_phase_clock_build_is_a_separate_library():
    """``phase_clocks=True`` selects the ``-DHD_PHASE_CLOCKS`` build, kept in
    its own library beside the normal one."""
    assert "-DHD_PHASE_CLOCKS" in _build.nvcc_flags(phase_clocks=True)
    assert "-DHD_PHASE_CLOCKS" not in _build.nvcc_flags()
    for name in _build.SOURCES:
        assert _build.library_path(name, phase_clocks=True) != _build.library_path(name)


def _out_loss(out):
    """A scalar whose gradient w.r.t. the layer output varies per element."""
    return (out * (out * 0.1).cos()).sum()


def _kernel_layout(flat: dict, attention: bool) -> dict:
    """A DenseGCL's flat flax params (or grads) -> the Pallas kernels' tree."""
    kp = {"edge_in": {"w_src": flat["edge_in_w_src"], "w_dst": flat["edge_in_w_dst"],
                      "w_e": flat["edge_in_w_e"], "bias": flat["edge_in_bias"]},
          "edge_out": {"kernel": flat["edge_out_kernel"], "bias": flat["edge_out_bias"]},
          "node_in": {"kernel": flat["node_in_kernel"], "bias": flat["node_in_bias"]},
          "node_out": {"kernel": flat["node_out_kernel"], "bias": flat["node_out_bias"]}}
    if attention:
        kp["att"] = {"kernel": flat["att_kernel"], "bias": flat["att_bias"]}
    return kp


@pytest.mark.parametrize("attention", [True, False])
def test_gcl_gradients_match_xla_ad(attention):
    """Autograd of the port's DenseGCL (the plain path, the reference of the
    backward kernel) against jax.grad of the XLA DenseGCL: dh, de and every
    parameter, f32."""
    jl, params, port, (hh, x, e, em, nm) = _gcl_pair(32, 2, attention)

    def loss(p, hh_, e_):
        with jax.default_matmul_precision("highest"):
            out = jl.apply(p, hh_, e_, nm, em)
        return jax.numpy.sum(out * jax.numpy.cos(out * 0.1))

    g_p, g_h, g_e = jax.grad(loss, argnums=(0, 1, 2))(params, hh, e)
    ref = _port_state(tw._gcl, jax.tree_util.tree_map(np.asarray, g_p["params"]))
    th, tev = (t.requires_grad_(True) for t in _t(hh, e))
    _out_loss(port(th, tev, *_t(nm, em))).backward()
    assert _rel(th.grad, g_h) < F32_REL and _rel(tev.grad, g_e) < F32_REL
    assert sorted(ref) == sorted(n for n, _ in port.named_parameters())
    for name, param in port.named_parameters():
        assert _rel(param.grad, ref[name]) < F32_REL, name


@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("attention", [True, False])
def test_gcl_plain_vjp_matches_pallas_gcl_vjp(interpret_pallas, cd, attention):
    """``gcl_plain_vjp`` (what the backward kernel is held to on the card)
    against the JAX package's ``gcl_vjp`` under the Pallas interpreter, at
    the bars gcl_vjp meets against XLA (tests/test_pallas_interpret.py:151):
    2e-2 in f32, 4e-2 with bf16 elementwise."""
    from hierdiff_tpu.ops import egnn_pallas as ep

    _, params, port, (hh, x, e, em, nm) = _gcl_pair(32, 2, attention, cd=cd)
    kp = _kernel_layout(params["params"], attention)
    f = ep.gcl_vjp(10.0, attention, cd)

    def loss(kp_, hh_, e_):
        out = f(hh_, e_, em, nm, kp_)
        return jax.numpy.sum(out * jax.numpy.cos(out * 0.1))

    g_k, g_h, g_e = jax.grad(loss, argnums=(0, 1, 2))(kp, hh, e)
    th, tev, tem, tnm = _t(hh, e, em, nm)
    out = ek.gcl_plain(port, th, tev, tem, tnm).detach().requires_grad_(True)
    _out_loss(out).backward()
    grads = ek.gcl_plain_vjp(port, th, tev, tem, tnm, out.grad)
    tol = PALLAS_REL if cd is None else 2 * PALLAS_REL
    pairs = {"dh": g_h, "de": g_e, "w_src": g_k["edge_in"]["w_src"],
             "w_dst": g_k["edge_in"]["w_dst"], "w_e": g_k["edge_in"]["w_e"],
             "b1": g_k["edge_in"]["bias"], "w2": g_k["edge_out"]["kernel"],
             "b2": g_k["edge_out"]["bias"], "w_node_in": g_k["node_in"]["kernel"],
             "b_node_in": g_k["node_in"]["bias"], "w_node_out": g_k["node_out"]["kernel"],
             "b_node_out": g_k["node_out"]["bias"]}
    if attention:
        pairs.update(w_att=g_k["att"]["kernel"][:, 0], b_att=g_k["att"]["bias"])
    else:
        assert grads.w_att is None and grads.b_att is None
    for name, ref in pairs.items():
        assert _rel(getattr(grads, name), ref) < tol, name


def test_autograd_takes_the_kernel_function_and_the_plain_coordinate_update(monkeypatch):
    """The repaired fault: a kernel's output has no autograd history, so on
    the card the GCL must run as FusedGCLFunction (whose backward is the
    backward kernel) and the coordinate update, which has no backward
    kernel, must take its plain version when a gradient is recorded. Here
    the device check reports CUDA and the launches are stood in for by the
    plain versions computed without history, as a kernel's are."""
    egnn = te.DenseEGNN(9, hidden_nf=32, n_layers=2, inv_sublayers=2, attention=True,
                        tanh=True, coords_range=30.0, norm_constant=0.0,
                        normalization_factor=10.0)
    tw.init_weights(egnn, torch.Generator().manual_seed(0))
    hh, x, _, em, nm = _inputs(h=9)
    args = _t(hh, x, nm, em)
    ref = copy.deepcopy(egnn)
    out_ref = ref(*args)
    (_out_loss(out_ref[0]) + _out_loss(out_ref[1])).backward()

    calls = {"fwd_agg": [], "bwd": 0, "coord": 0}

    def fake_launch(layer, h, e, em_, nm_, device, agg_out=None, phase_clocks=False):
        calls["fwd_agg"].append(agg_out is not None)
        with torch.no_grad():
            if agg_out is not None:
                agg_out.copy_(ek.gcl_agg_plain(layer, h, e, em_))
            return ek.gcl_plain(layer, h, e, em_, nm_)

    def fake_bwd(layer, h, e, em_, nm_, g, agg, device, phase_clocks=False):
        calls["bwd"] += 1
        return ek.gcl_plain_vjp(layer, h, e, em_, nm_, g)

    def fake_coord(layer, h, e, cdiff, x_, em_, nm_):
        calls["coord"] += 1
        with torch.no_grad():
            return ek.coord_update_plain(layer, h, e, cdiff, x_, em_, nm_)

    monkeypatch.setattr(ek, "_device_of", lambda h: torch.device("cuda"))
    monkeypatch.setattr(ek, "_launch_gcl", fake_launch)
    monkeypatch.setattr(ek, "_launch_gcl_bwd", fake_bwd)
    monkeypatch.setattr(te, "fused_coord_update", fake_coord)
    monkeypatch.setattr(ek, "launch_counts", dict.fromkeys(ek.launch_counts, 0))

    # the fault's mechanism: what a kernel returns carries no history
    layer = egnn.e_block_0.gcl_0
    probe = torch.zeros(3, 9, 32)
    assert not fake_launch(layer, probe, torch.zeros(3, 9, 9, 2), *_t(em, nm), None).requires_grad
    with pytest.raises(RuntimeError, match="no backward kernel"):
        ek.fused_coord_update(egnn.e_block_0.gcl_equiv, probe, torch.zeros(3, 9, 9, 2),
                              torch.zeros(3, 9, 9, 3), torch.zeros(3, 9, 3), *_t(em, nm))
    calls["fwd_agg"].clear()

    with torch.no_grad():   # sampling: both kernels, no residual
        out_ng = egnn(*args)
    assert calls == {"fwd_agg": [False] * 4, "bwd": 0, "coord": 2}
    assert ek.launch_counts["coord_update_autograd"] == 0
    assert _rel(out_ng[0], out_ref[0].detach()) < F32_REL

    calls.update(fwd_agg=[], coord=0)
    out = egnn(*args)   # training: the autograd Function and the plain coordinate update
    assert calls == {"fwd_agg": [True] * 4, "bwd": 0, "coord": 0}
    assert ek.launch_counts["coord_update_autograd"] == 2
    assert out[0].grad_fn is not None
    (_out_loss(out[0]) + _out_loss(out[1])).backward()
    assert calls["bwd"] == 4
    for (name, p), p_ref in zip(egnn.named_parameters(), ref.parameters()):
        assert p.grad is not None and p.grad.abs().max() > 0, name
        assert _rel(p.grad, p_ref.grad) < F32_REL, name


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions():
    """On the card: each kernel against its plain version at the sampler's
    shapes (chip_smoke.py runs the same check without pytest)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    _, _, gcl, (hh, x, e, em, nm) = _gcl_pair(256, 2, True)
    gcl.to(dev)
    h_holey, em_holey, nm_holey = _holey(hh, nm)
    rng = np.random.default_rng(3)
    counts = np.array([83, 1, 0, 40])   # rows longer than a 64-edge tile, 0- and 1-node molecules
    nm83 = (np.arange(83)[None, :] < counts[:, None]).astype(np.float32)[..., None]
    em83 = (nm83 * np.transpose(nm83, (0, 2, 1)) * (1 - np.eye(83, dtype=np.float32)))[..., None]
    h83 = rng.standard_normal((4, 83, 256)).astype(np.float32) * nm83
    e83 = rng.standard_normal((4, 83, 83, 2)).astype(np.float32)
    for h_, e_, em_, nm_ in [(hh, e, em, nm), (h_holey, e, em_holey, nm_holey),
                             (h83, e83, em83, nm83)]:
        args = [t.to(dev) for t in _t(h_, e_, em_, nm_)]
        base = args[0] * args[3]
        with torch.no_grad():
            out, ref = ek.fused_gcl(gcl, *args) - base, ek.gcl_plain(gcl, *args) - base
        assert _rel(out.cpu(), ref.cpu()) < PALLAS_REL
    # the coordinate update, scored on out - x: prefix masks, holey masks,
    # 83-node rows with 0/1-node molecules; tanh on/off x f32/bf16
    _, _, _, (hh, x, cdiff, e, em, nm) = _equiv_pair(256, 2, True)
    x83 = rng.standard_normal((4, 83, 3)).astype(np.float32) * 2 * nm83
    cdiff83 = np.asarray(je.coord2diff_dense(x83, 0.0)[1])
    hh_h, x_h, cdiff_h, em_h, nm_h = _holey_coords(hh, nm)
    inputs = [(hh, e, cdiff, x, em, nm), (hh_h, e, cdiff_h, x_h, em_h, nm_h),
              (h83, e83, cdiff83, x83, em83, nm83)]
    for tanh in (True, False):
        for cd in (None, "bfloat16"):
            _, _, equ, _ = _equiv_pair(256, 2, tanh, cd=cd)
            equ.to(dev)
            for arrays in inputs:
                args = [t.to(dev) for t in _t(*arrays)]
                with torch.no_grad():
                    out = ek.fused_coord_update(equ, *args) - args[3]
                    ref = ek.coord_update_plain(equ, *args) - args[3]
                assert _rel(out.cpu(), ref.cpu()) < PALLAS_REL, (tanh, cd, arrays[0].shape)


@pytest.mark.gpu
def test_cuda_phase_clock_build_runs_beside_the_normal_one():
    """On the card: the -DHD_PHASE_CLOCKS library, loaded into the process
    after the normal one, sets up and launches its own kernels (each library
    keeps its own once-per-device setup), and both agree with the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    _, _, gcl, (hh, _, e, em, nm) = _gcl_pair(256, 2, True)
    gcl.to(dev)
    args = [t.to(dev) for t in _t(hh, e, em, nm)]
    with torch.no_grad():
        ref = ek.gcl_plain(gcl, *args) - args[0]
        for clocks in (False, True):
            out = ek.fused_gcl(gcl, *args, phase_clocks=clocks) - args[0]
            assert _rel(out.cpu(), ref.cpu()) < PALLAS_REL
    _, _, equ, (hh, x, cdiff, e, em, nm) = _equiv_pair(256, 2, True)
    equ.to(dev)
    args = [t.to(dev) for t in _t(hh, e, cdiff, x, em, nm)]
    with torch.no_grad():
        ref = ek.coord_update_plain(equ, *args) - args[3]
        for clocks in (False, True):
            out = ek.fused_coord_update(equ, *args, phase_clocks=clocks) - args[3]
            assert _rel(out.cpu(), ref.cpu()) < PALLAS_REL


@pytest.mark.gpu
def test_cuda_backward_kernel_matches_plain_vjp():
    """On the card: fused_gcl_bwd against gcl_plain_vjp (chip_smoke.py phase
    2b runs the same check at the training shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    _, _, gcl, (hh, x, e, em, nm) = _gcl_pair(256, 2, True)
    gcl.to(dev)
    args = [t.to(dev) for t in _t(hh, e, em, nm)]
    g = torch.randn(hh.shape, generator=torch.Generator().manual_seed(0)).to(dev)
    with torch.no_grad():
        agg = torch.empty_like(args[0])
        ek._launch_gcl(gcl, *args, args[0].device, agg_out=agg)
        got = ek.fused_gcl_bwd(gcl, *args, g, agg)
    ref = ek.gcl_plain_vjp(gcl, *args, g)
    for name, a, r in zip(ek.GclGrads._fields, got, ref):
        assert _rel(a.cpu(), r.cpu()) < PALLAS_REL, name


def _pass_through(layer):
    """Node MLP [h, agg] -> agg -> identity: out - h = silu(agg) per channel,
    so the edge path is not hidden behind the node MLP's h term."""
    hidden = layer.node_mlp[2].weight.shape[0]
    with torch.no_grad():
        layer.node_mlp[0].weight.copy_(torch.cat([torch.zeros(hidden, hidden), torch.eye(hidden)], 1))
        layer.node_mlp[2].weight.copy_(torch.eye(hidden))
        layer.node_mlp[0].bias.zero_()
        layer.node_mlp[2].bias.zero_()
    return layer


def _ring_check(layer, h, e, em, nm):
    """fused_gcl against gcl_plain on what it adds to h and on the
    aggregated messages it leaves for the backward; two calls bitwise equal."""
    with torch.no_grad():
        base = h * nm
        out = ek.fused_gcl(layer, h, e, em, nm)
        ref = ek.gcl_plain(layer, h, e, em, nm)
        assert _rel((out - base).cpu(), (ref - base).cpu()) < PALLAS_REL
        agg = torch.empty_like(h)
        out2 = ek._launch_gcl(layer, h, e, em, nm, h.device, agg_out=agg)
        agg_ref = ek.gcl_agg_plain(layer, h, e, em)
        assert _rel(agg.cpu(), agg_ref.cpu()) < PALLAS_REL
        assert torch.equal(out, out2)
        agg2 = torch.empty_like(h)
        ek._launch_gcl(layer, h, e, em, nm, h.device, agg_out=agg2)
        assert torch.equal(agg, agg2)


@pytest.mark.gpu
@pytest.mark.parametrize("attention", [True, False])
def test_cuda_gcl_ring_at_the_pocket_shape(attention):
    """On the card: fused_gcl at the pocket sampling cell's shape (64
    CrossDocked molecules and a 32-residue pocket with cross edges, 67 rows:
    rows of more than 64 edges, and so many tiles that each consumer
    warpgroup of every block goes round the ring several times) against its
    plain version, and bitwise repeatable."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CUDA kernels have no CPU mode")
    from hierdiff_torch.tools.kernel_phases import cell_inputs

    dev = torch.device("cuda")
    h, _, e, _, em, nm, _ = cell_inputs(np.random.default_rng(5), dev, "pocket")
    per_row = em[..., 0].sum(-1)
    tiles = int(em.sum().item() + 63) // 64
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert per_row.max().item() > 64 and tiles >= 3 * 2 * 2 * sms
    layer = _pass_through(tw.init_weights(
        te.DenseGCL(256, 2, normalization_factor=10.0, attention=attention).to(dev),
        torch.Generator().manual_seed(0)))
    _ring_check(layer, h, e, em, nm)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["no edge", "one edge", "fewer tiles than SMs"])
def test_cuda_gcl_ring_small_work_lists(case):
    """On the card: fused_gcl on work lists that leave stages, consumers or
    whole blocks without a tile: no real edge (molecules of 0 and 1 nodes),
    a single real edge, and a batch of fewer 64-edge tiles than SMs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CUDA kernels have no CPU mode")
    from hierdiff_torch.sampling.coarse import make_masks_for_counts

    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    counts = {"no edge": [1, 0, 1, 0], "one edge": [2, 1, 0], "fewer tiles than SMs": [16] * 8}[case]
    nm, em = make_masks_for_counts(np.array(counts))
    if case == "one edge":
        em[0, 1, 0] = 0.0
    n = nm.shape[1]
    h = rng.standard_normal((len(counts), n, 256)).astype(np.float32) * nm
    e = rng.standard_normal((len(counts), n, n, 2)).astype(np.float32)
    h, e, em, nm = (t.to(dev) for t in _t(h, e, em[..., None], nm))
    real = int(em.sum().item())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert real == {"no edge": 0, "one edge": 1}.get(case, real) and (real + 63) // 64 < sms
    for attention in (True, False):
        layer = _pass_through(tw.init_weights(
            te.DenseGCL(256, 2, normalization_factor=10.0, attention=attention).to(dev),
            torch.Generator().manual_seed(0)))
        _ring_check(layer, h, e, em, nm)


@pytest.mark.parametrize("cell, rows, real_edges", [("geom", 35, 58492), ("pocket", 67, 138888)])
def test_cell_inputs_have_the_sampling_cells_shapes(cell, rows, real_edges):
    """tools/kernel_phases.cell_inputs, the shapes gcl_ab.py and
    kernel_phases.py time the kernels at: the sampling cells' node counts
    (the histogram's stratified quantiles, shuffled), their rows and real
    edges; the pocket's rows all real, with cross edges both ways."""
    from hierdiff_torch.tools.kernel_phases import CELLS, cell_inputs, cell_shape, stratified_counts

    name, b, k = CELLS[cell]
    h, x, e, cdiff, em, nm, counts = cell_inputs(np.random.default_rng(0), "cpu", cell, h=16)
    assert h.shape == (b, rows, 16) and e.shape == (b, rows, rows, 2) and em.shape == (b, rows, rows, 1)
    assert cell_shape(cell) == f"{cell} cell B={b} N={rows}"
    assert int(em.sum().item()) == real_edges
    assert torch.equal(em, em.transpose(1, 2)) and not em[:, range(rows), range(rows)].any()
    assert sorted(counts.tolist()) == stratified_counts(name, b).tolist()
    n_mol = rows - k
    assert torch.equal(nm[:, :n_mol, 0].sum(1).long(), torch.from_numpy(counts).long())
    assert bool((nm[:, n_mol:] == 1).all()) and bool((h * (1 - nm) == 0).all())
    if k:
        assert torch.equal(em[:, :n_mol, n_mol:, 0], nm[:, :n_mol] * nm[:, None, n_mol:, 0])


def test_gcl_ab_bitwise_equal_compares_bit_patterns():
    """tools/gcl_ab.bitwise_equal: float32 by bit pattern, other types by value."""
    from hierdiff_torch.tools.gcl_ab import bitwise_equal

    a = torch.tensor([1.0, 0.0, float("nan")])
    assert bitwise_equal([a, torch.arange(3)], [a.clone(), torch.arange(3)])
    assert not bitwise_equal([a], [torch.tensor([1.0, -0.0, float("nan")])])
    assert not bitwise_equal([a], [a.clone(), a])
    assert not bitwise_equal([a], [a[:2]])
