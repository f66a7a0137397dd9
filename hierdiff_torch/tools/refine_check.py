"""Compare two fused refine checks of the same fleet under a margin rule.

A fused check (``RefineHook._fused_check``) returns per row the tree's
total log-probability, then K candidate slots: the node (a stable sort of
the per-node log-probabilities), its proposed type (an argmax), whether the
slot is valid, and the total after the swap. The node and the type are
choices, so two correct runs that round differently (two devices, two
frameworks) may choose otherwise where the competing log-probabilities are
near a tie. ``compare_fused``:

- holds ``total`` to the reference within ``tol`` of the fleet's largest
  |total|;
- where a slot's node differs, accepts it only if the reference's gap
  between that slot's log-probability and its neighbours' in the sorted
  order is below ``margin`` (a cut); where the node agrees but the type or
  the valid flag differs, only if the reference's gap between the best and
  the runner-up type at that node is below ``margin``; a larger gap is a
  failure;
- where the slot agrees, holds ``new_total`` within ``tol`` of the fleet's
  largest |total|.

The margins are the reference's own: ``_fused_check(..., margins=True)``
returns them beside the packed result (or the caller passes them). With
``relative`` a margin is scaled by the row's largest |log-probability|,
the scale of f32 rounding there. Used by the port's tests against the JAX
package and by ``chip_smoke.py`` (card against CPU); numpy only.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np


def unpack(packed: np.ndarray, K: int) -> dict:
    """Split a packed fused-check result (rows, 1 + 4K [+ 2K + 1])."""
    packed = np.asarray(packed, np.float64)
    out = {"total": packed[:, 0],
           "node_k": packed[:, 1: 1 + K].astype(np.int64),
           "wid_k": packed[:, 1 + K: 1 + 2 * K].astype(np.int64),
           "valid": packed[:, 1 + 2 * K: 1 + 3 * K] > 0.5,
           "new_total": packed[:, 1 + 3 * K: 1 + 4 * K]}
    if packed.shape[1] >= 1 + 6 * K + 1:
        out["order_gap"] = packed[:, 1 + 4 * K: 1 + 5 * K]
        out["top_gap"] = packed[:, 1 + 5 * K: 1 + 6 * K]
        out["scale"] = packed[:, 1 + 6 * K]
    return out


def compare_fused(ref: np.ndarray, got: np.ndarray, K: int,
                  ref_margins: Optional[Mapping[str, np.ndarray]] = None,
                  margin: float = 1e-4, tol: float = 1e-5, relative: bool = False) -> dict:
    """ref and got: packed fused-check results of the same rows; ref
    carries its margins or ``ref_margins`` gives them (``order_gap``,
    ``top_gap`` (rows, K) and ``scale`` (rows,)). Returns the report:
    ``ok``, ``cut`` [(row, slot, choice, margin)], ``failures``,
    ``slots_compared``, the largest total and new_total errors over the
    fleet's largest |total| (``max_total_rel_err``,
    ``max_new_total_rel_err``) and ``close_calls``, the agreeing valid slots
    whose reference new_total is within ``margin`` (scaled as the margins)
    of the total, where the host's ``new_total > total`` may decide
    otherwise on the two runs."""
    r, g = unpack(ref, K), unpack(got, K)
    m = dict(r) if ref_margins is None else {**r, **ref_margins}
    if "order_gap" not in m:
        raise ValueError("the reference's margins are needed: _fused_check(margins=True)")
    largest = max(float(np.abs(r["total"]).max()), 1e-30)
    total_err = np.abs(g["total"] - r["total"]) / largest
    cut, failures, close = [], [], 0
    failures += [(int(i), None, "total", float(total_err[i]))
                 for i in np.flatnonzero(~(total_err <= tol))]
    worst_new, compared = 0.0, 0
    for row in range(len(r["total"])):
        bar = margin * (max(float(m["scale"][row]), 1e-30) if relative else 1.0)
        for k in range(K):
            if r["node_k"][row, k] != g["node_k"][row, k]:
                gap = float(m["order_gap"][row, k])
                (cut if gap < bar else failures).append((row, k, "node", gap))
                continue
            if (r["wid_k"][row, k] != g["wid_k"][row, k]
                    or r["valid"][row, k] != g["valid"][row, k]):
                gap = float(m["top_gap"][row, k])
                (cut if gap < bar else failures).append((row, k, "type", gap))
                continue
            compared += 1
            err = abs(float(g["new_total"][row, k]) - float(r["new_total"][row, k])) / largest
            worst_new = max(worst_new, err)
            if not err <= tol:
                failures.append((row, k, "new_total", err))
            if r["valid"][row, k] and abs(r["new_total"][row, k] - r["total"][row]) < bar:
                close += 1
    return {"ok": not failures, "cut": cut, "failures": failures, "slots_compared": compared,
            "max_total_rel_err": float(total_err.max(initial=0.0)),
            "max_new_total_rel_err": worst_new, "close_calls": close}
