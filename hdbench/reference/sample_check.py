"""The comparison that decides ``correct`` in the coarse sampling cells.

A 1000-step chain cannot be compared end to end: the kernels round their
products to bf16, and the chain carries each step's rounding into the next.
So the reference follows the program step by step from the program's own
state. For each checked reverse step k of a request the benchmark kept the
program's input z_k (molecule rows), the gammas it was given, its noise
prediction, and its next state z_{k+1}; it knows every draw of noise,
since it made them. Then, worst over the request's checked steps:

- ``gcl_mol_gap``: the program's hidden h after the EGNN's first GCL
  (all rows, the pocket's too) against the reference's from the same z_k
  and t, molecule by molecule over its real rows, in units of what the
  bf16 products themselves change there (the norm of the reference's
  first GCL with bf16 products less its first GCL in float32); the median
  molecule of a block of 64: the first ``fused_gcl`` launch on a known
  input, before its rounding is carried any further. Past the first
  layers the products' rounding is chaotic (a float32 ulp in the weights
  redraws most of it), so only here does the program's float32 path read
  far below its bfloat16 path. The median, not the block's norm: in a
  molecule whose coordinates have run out to hundreds of units a single
  bf16 rounding that the order of float32 sums flips moves an input by
  thousands, and that one molecule then carries the whole block's norm
  (the reference against itself with its weights moved by one float32
  ulp reads so too), while the bfloat16 path moves every molecule.
- ``eps_gap``: the program's noise prediction against the reference's at
  the same z_k and t, per block (x, features) over the real rows of a
  block of 64 molecules, relative to the reference's: the two EGNN kernels
  and the dynamics, with the pocket rows and cross edges in the pocket
  cell (the reference builds its own pocket rows). A norm over many rows,
  not the worst molecule: the worst molecule's relative error swings from
  seed to seed with its size, while a fault in a part of the batch moves
  this norm, and one molecule's wrong answer moves ``final_gap``.
- ``sched_gap``: the program's gamma at s and t against the reference's
  learned schedule, absolute (gamma spans -5 to 10).
- ``step_gap``: the program's z_{k+1} against the reference's
  mu + sigma * noise from the program's z_k, noise prediction and gammas,
  the x block re-centred, relative to its largest entry: the update and the
  CoM projection. Step 1's input is held to the projected first draw the
  same way (the start of the chain).
- ``final_gap``: the program's output against the reference's draw from
  p(x | z_0) from the program's z_0 and noise prediction at t = 0,
  relative to the largest entry of its block (positions, features). That
  prediction is held to the reference's as the steps' are, under
  ``eps_gap``.

The reference computes the configuration's float32 as the card runs it:
the EGNN's products take bf16 operands with float32 accumulation, as the
kernels do and as the JAX package did at the TPU's default precision;
everything else is float32 (``coarse.Params``). On the CPU, whose plain
route is float32 throughout, the reference is too.

The control of ``gcl_mol_gap`` and ``eps_gap`` is the program's own
lower-precision path: the same model built with ``compute_dtype='bfloat16'``
(the configuration's training type), run on the same request and weights
and read the same way. That path keeps the schedule, the update and the
final draw in float32, so their control is the reference's in bfloat16
(``update_control_gaps``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
from torch import Tensor

from hdbench.reference import coarse as ref

BLOCK = 64   # molecules per reference call


def _blocks(b: int, block: int = BLOCK):
    for s in range(0, b, block):
        yield slice(s, min(s + block, b))


def worst(*values: float) -> float:
    """The largest, NaN if any is NaN."""
    return math.nan if any(v != v for v in values) else max(values)


def _rel_blocks(diff: Tensor, scale: Tensor, node_mask: Tensor) -> list:
    """|diff| / |scale| over the real rows of the whole block of molecules,
    for the x block and the features."""
    out = []
    for cols in (slice(0, 3), slice(3, None)):
        d = float((diff[..., cols] * node_mask).norm())
        s = float((scale[..., cols] * node_mask).norm())
        out.append(d / max(s, 1e-30))
    return out


def _max_rel(a: Tensor, b: Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


class Request:
    """What the benchmark kept of one request: its masks and pocket inputs,
    the draws (``raw(k)``: (B, N, 3 + F) standard normals of draw k, 0 for
    z_T, n + 1 for the final x) and the program's captures by step: ``z``
    inputs, ``eps`` noise predictions, ``gammas`` (gamma_s, gamma_t); and of
    the final draw: ``z0`` and ``eps0``, the input and noise prediction;
    ``gcl`` the EGNN's hidden h after its first GCL by step, all rows."""

    def __init__(self, node_mask: Tensor, edge_mask: Tensor, raw: Callable[[int], Tensor],
                 n_steps: int, z: Dict[int, Tensor], eps: Dict[int, Tensor],
                 gammas: Dict[int, tuple], gcl: Dict[int, Tensor], z0: Tensor, eps0: Tensor,
                 out: Tensor, checked: List[int],
                 pocket_tokens: Optional[Tensor] = None, pocket_pos: Optional[Tensor] = None,
                 cross_edges: bool = True):
        self.node_mask, self.edge_mask, self.raw = node_mask, edge_mask, raw
        self.n_steps, self.z, self.eps, self.gammas = n_steps, z, eps, gammas
        self.gcl = gcl
        self.z0, self.eps0, self.out, self.checked = z0, eps0, out, checked
        self.pocket_tokens, self.pocket_pos, self.cross_edges = pocket_tokens, pocket_pos, cross_edges

    def next_state(self, k: int) -> Tensor:
        return self.z0 if k == self.n_steps else self.z[k + 1]


def _pocket_rows(sd, req: Request, sl) -> dict:
    if req.pocket_tokens is None:
        return {}
    tok = req.pocket_tokens[sl].long()
    pm = torch.ones(tok.shape + (1,), device=tok.device)
    rows = torch.cat([req.pocket_pos[sl].float(), sd["pocket_embed.weight"].float()[tok]], -1)
    return {"pocket": rows, "pocket_node_mask": pm,
            "full_edge_mask": ref.pocket_edges(req.node_mask[sl], pm, req.cross_edges)}


def _mol_norms(a: Tensor, mask: Tensor) -> Tensor:
    """The norm of ``a`` over each molecule's real rows, (B,)."""
    return (a * mask).flatten(1).norm(dim=1)


def request_gaps(sd: Dict[str, Tensor], cfg: dict, req: Request,
                 bf16_products: bool) -> dict:
    """The five gaps of one request of the program; ``bf16_products``: the
    reference's EGNN products take bf16 operands (``coarse.Params``)."""
    rounded, plain = ref.Params(sd, True), ref.Params(sd, False)
    p = rounded if bf16_products else plain
    T = cfg["timesteps"]
    gcl_mol_gap = eps_gap = sched_gap = 0.0
    by_step = []
    step_gap = _max_rel(req.z[1], ref.project_noise(req.raw(0), req.node_mask))
    for k in req.checked:
        t_int = T - k + 1
        raw = req.raw(k)
        g_ref = torch.stack(ref.grid_gammas(sd, t_int, T, raw.device))
        g_s, g_t = (g.float().reshape(-1) for g in req.gammas[k])
        sched_gap = worst(sched_gap, float((g_s - g_ref[0]).abs().max()),
                          float((g_t - g_ref[1]).abs().max()))
        for sl in _blocks(req.node_mask.shape[0]):
            nm, em, z = req.node_mask[sl], req.edge_mask[sl], req.z[k][sl]
            extra = _pocket_rows(sd, req, sl)
            all_nm = torch.cat([nm, extra["pocket_node_mask"]], 1) if extra else nm
            h_rounded = ref.first_gcl(rounded, cfg, z, t_int, nm, em, **extra)
            h_plain = ref.first_gcl(plain, cfg, z, t_int, nm, em, **extra)
            miss = _mol_norms(req.gcl[k][sl].float() - (h_rounded if bf16_products else h_plain),
                              all_nm)
            effect = _mol_norms(h_rounded - h_plain, all_nm).clamp(min=1e-30)
            gcl_mol_gap = worst(gcl_mol_gap, float((miss / effect).median()))
            eps_r = ref.eps_prediction(p, cfg, z, t_int, nm, em, **extra)
            gs, gt = (g[sl] if g.numel() > 1 else g for g in (g_s, g_t))
            eps_s, got = req.eps[k][sl].float(), req.next_state(k)[sl].float()
            rel = _rel_blocks(eps_s - eps_r, eps_r, nm)
            by_step.append([k, sl.start] + rel)
            eps_gap = worst(eps_gap, *rel)
            step_gap = worst(step_gap, _max_rel(got, ref.step_from(z, eps_s, gs, gt, raw[sl], nm)))
    raw = req.raw(req.n_steps + 1)
    g0 = ref.gamma(sd, torch.zeros(1, device=raw.device))
    outs, refs = [], []
    for sl in _blocks(req.node_mask.shape[0]):
        nm, em, z0 = req.node_mask[sl], req.edge_mask[sl], req.z0[sl]
        eps_r = ref.eps_prediction(p, cfg, z0, 0, nm, em)
        eps_s = req.eps0[sl].float()
        rel = _rel_blocks(eps_s - eps_r, eps_r, nm)
        by_step.append([req.n_steps + 1, sl.start] + rel)
        eps_gap = worst(eps_gap, *rel)
        outs.append(req.out[sl].float())
        refs.append(ref.final_from(z0, eps_s, g0, raw[sl], nm))
    return {"gcl_mol_gap": gcl_mol_gap, "eps_gap": eps_gap, "sched_gap": sched_gap,
            "step_gap": step_gap, "final_gap": _final_gap(torch.cat(outs), torch.cat(refs)),
            "eps_by_step": by_step}


def _final_gap(outs: Tensor, refs: Tensor) -> float:
    return worst(_max_rel(outs[..., :3], refs[..., :3]), _max_rel(outs[..., 3:], refs[..., 3:]))


def update_control_gaps(sd: Dict[str, Tensor], cfg: dict, req: Request) -> dict:
    """The control of the schedule, the reverse step and the final draw,
    where the program's bfloat16 path keeps float32 and so has no path of
    its own below them: the reference's schedule in bfloat16 against its
    float32, and its update and final draw in bfloat16 against the same in
    float32, from the program's own state, noise prediction and gammas."""
    T, low = cfg["timesteps"], torch.bfloat16
    sched_gap = step_gap = 0.0
    for k in req.checked:
        raw = req.raw(k)
        g32 = ref.grid_gammas(sd, T - k + 1, T, raw.device)
        g16 = ref.grid_gammas(sd, T - k + 1, T, raw.device, low)
        sched_gap = worst(sched_gap, *(float((a - b).abs().max()) for a, b in zip(g16, g32)))
        for sl in _blocks(req.node_mask.shape[0]):
            nm, z, eps = req.node_mask[sl], req.z[k][sl], req.eps[k][sl].float()
            step_gap = worst(step_gap, _max_rel(ref.step_from(z, eps, *g32, raw[sl], nm, low),
                                                ref.step_from(z, eps, *g32, raw[sl], nm)))
    raw = req.raw(req.n_steps + 1)
    g0 = ref.gamma(sd, torch.zeros(1, device=raw.device))
    eps0, nm = req.eps0.float(), req.node_mask
    final = _final_gap(ref.final_from(req.z0, eps0, g0, raw, nm, low),
                       ref.final_from(req.z0, eps0, g0, raw, nm))
    return {"sched_gap": sched_gap, "step_gap": step_gap, "final_gap": final}
