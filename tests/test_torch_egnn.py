"""PyTorch port of the dense EGNN layers (hierdiff_torch/ops/egnn.py) against
the JAX package's XLA layers and its Pallas kernels, on the same weights.

The port's plain path is held to the XLA layers in float32 (JAX at HIGHEST
matmul precision); it is also held to the interpreted Pallas kernels, whose
bf16 matmul operands set the 2e-2 bar (tests/test_pallas_interpret.py). The
CUDA kernels are held to the plain path on the card (``gpu`` marker here,
and chip_smoke.py).
"""

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


@pytest.mark.parametrize("attention", [True, False])
@pytest.mark.parametrize("e_nf", [2, 24])
def test_gcl_matches_xla(attention, e_nf):
    jl, params, port, (hh, x, e, em, nm) = _gcl_pair(32, e_nf, attention)
    with jax.default_matmul_precision("highest"):
        ref = jl.apply(params, hh, e, nm, em)
    with torch.no_grad():
        out = port(*_t(hh, e, nm, em))
    assert _rel(out, ref) < F32_REL


@pytest.mark.parametrize("tanh", [True, False])
@pytest.mark.parametrize("e_nf", [2, 24])
def test_equivariant_update_matches_xla(tanh, e_nf):
    jl, params, port, (hh, x, cdiff, e, em, nm) = _equiv_pair(32, e_nf, tanh)
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


@pytest.mark.parametrize("cd", [None, "bfloat16"])
def test_layers_match_pallas_interpret(interpret_pallas, cd):
    """The port's layers against the JAX fused kernels (fused_gcl,
    fused_coord_update) run through the Pallas interpreter."""
    jl, params, port, (hh, x, e, em, nm) = _gcl_pair(32, 2, True, cd=cd)
    jk = je.DenseGCL(hidden_nf=32, normalization_factor=10.0, attention=True,
                     use_pallas=True, compute_dtype=cd)
    with torch.no_grad():
        out = port(*_t(hh, e, nm, em))
    assert _rel(out, jk.apply(params, hh, e, nm, em)) < PALLAS_REL

    jl, params, port, (hh, x, cdiff, e, em, nm) = _equiv_pair(32, 2, True, cd=cd)
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
    """The cached kernel operands are the pair linear's W_src | W_dst and
    W_e, W2 and the node MLP, transposed to (in, out) and cast to bf16. The
    cache is reused while the parameters stand still and rebuilt after an
    in-place update (mul_, an optimizer step, load_state_dict) or .to()."""
    _, _, port, _ = _gcl_pair(32, 2, True)
    cached = lambda: ek._cached_weights(port, ek._gcl_kernel_weights, torch.device("cpu"))  # noqa: E731
    w = cached()
    w0 = port.edge_mlp[0].weight.detach()
    assert torch.equal(w["wsd"], torch.cat([w0[:, :32].t(), w0[:, 32:64].t()], 1).bfloat16())
    assert torch.equal(w["we"], w0[:, 64:].t().bfloat16())
    assert torch.equal(w["w2"], port.edge_mlp[2].weight.detach().t().bfloat16())
    assert torch.equal(w["nw1"], port.node_mlp[0].weight.detach().t().bfloat16())
    assert w["wsd"].is_contiguous() and w["nw1"].is_contiguous()
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


def test_phase_clock_build_is_a_separate_library():
    """``phase_clocks=True`` selects the ``-DHD_PHASE_CLOCKS`` build, kept in
    its own library beside the normal one."""
    assert "-DHD_PHASE_CLOCKS" in _build.nvcc_flags(phase_clocks=True)
    assert "-DHD_PHASE_CLOCKS" not in _build.nvcc_flags()
    for name in _build.SOURCES:
        assert _build.library_path(name, phase_clocks=True) != _build.library_path(name)


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions():
    """On the card: each kernel against its plain version at the sampler's
    shapes (chip_smoke.py runs the same check without pytest)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    _, _, gcl, (hh, x, e, em, nm) = _gcl_pair(256, 2, True)
    args = [t.to(dev) for t in _t(hh, e, em, nm)]
    gcl.to(dev)
    with torch.no_grad():
        assert _rel(ek.fused_gcl(gcl, *args).cpu(), ek.gcl_plain(gcl, *args).cpu()) < PALLAS_REL
    _, _, equ, (hh, x, cdiff, e, em, nm) = _equiv_pair(256, 2, True)
    args = [t.to(dev) for t in _t(hh, e, cdiff, x, em, nm)]
    equ.to(dev)
    with torch.no_grad():
        out = ek.fused_coord_update(equ, *args).cpu()
        assert _rel(out, ek.coord_update_plain(equ, *args).cpu()) < PALLAS_REL
