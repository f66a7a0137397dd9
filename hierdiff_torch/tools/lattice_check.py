"""Compare two expansion lattices of the same molecules under a margin rule.

A lattice's focal and attach choices are argmaxes, so two correct runs that
round differently (two devices, two frameworks) may pick another candidate
where the best two are near a tie; from there on their trajectories part.
``compare_lattices`` walks each molecule's steps and:

- where a choice differs, accepts it only if the reference's margin between
  its best and runner-up candidate (``focal_margin`` / ``target_margin``) is
  below ``margin``, and then stops comparing that molecule (a cut); a larger
  margin is a failure;
- where the choices agree, holds ``top_logp`` to the reference within
  ``logp_tol`` (absolute, or over the largest |top_logp| of that step with
  ``relative``), and ``top_wid`` to the reference at every rank whose logp
  is more than ``logp_tol`` (same scale) from its neighbours' in the list.

Used by the port's tests against the JAX package and by ``chip_smoke.py``
(card against CPU); numpy only.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np


def compare_lattices(ref: Mapping[str, np.ndarray], got: Mapping[str, np.ndarray],
                     sizes: Sequence[int], margin: float = 1e-4, logp_tol: float = 1e-5,
                     relative: bool = False) -> dict:
    """ref and got: (B, S, ...) arrays ``focal``, ``target``, ``did_attach``,
    ``top_logp``, ``top_wid``; ref also ``focal_margin`` and
    ``target_margin`` (B, S). Row b is compared over its first sizes[b]
    steps. Returns the report: ``ok``, ``cut`` [(row, step, choice,
    margin)], ``failures``, ``steps_compared``, and the largest top_logp
    error, absolute (``max_logp_err``) and over the step's largest
    |top_logp| (``max_logp_rel_err``)."""
    cut, failures = [], []
    steps, worst, worst_rel = 0, 0.0, 0.0
    for b, n in enumerate(sizes):
        for t in range(n):
            differs = [c for c in ("focal", "target") if ref[c][b, t] != got[c][b, t]]
            if differs:
                c = differs[0]
                m = float(ref[f"{c}_margin"][b, t])
                (cut if m < margin else failures).append((b, t, c, m))
                break
            if ref["did_attach"][b, t] != got["did_attach"][b, t]:
                failures.append((b, t, "did_attach", None))
                break
            steps += 1
            r = np.asarray(ref["top_logp"][b, t], np.float64)
            g = np.asarray(got["top_logp"][b, t], np.float64)
            err = float(np.abs(g - r).max())
            largest = max(float(np.abs(r).max()), 1e-30)
            worst, worst_rel = max(worst, err), max(worst_rel, err / largest)
            scale = largest if relative else 1.0
            if not err / scale <= logp_tol:
                failures.append((b, t, "top_logp", err / scale))
            gap = np.diff(r) / scale            # r[k + 1] - r[k] <= 0
            apart = np.ones(len(r), bool)
            apart[1:] &= np.abs(gap) > logp_tol
            apart[:-1] &= np.abs(gap) > logp_tol
            bad = apart & (ref["top_wid"][b, t] != got["top_wid"][b, t])
            if bad.any():
                failures.append((b, t, "top_wid", int(np.flatnonzero(bad)[0])))
    return {"ok": not failures, "cut": cut, "failures": failures, "steps_compared": steps,
            "max_logp_err": worst, "max_logp_rel_err": worst_rel}
