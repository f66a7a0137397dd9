"""Rigid-body geometry: Kabsch alignment, RMSD, fragment moves.

Pure-numpy (no RDKit, no external `rmsd` package) equivalents of the
reference's geometry helpers (eval/MFF_RMSD.py:19-46 and the `rmsd` pypi
functions it calls). Used for candidate scoring during reconstruction and
for the MFF-RMSD conformer lift.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def centroid(x: np.ndarray) -> np.ndarray:
    return x.mean(axis=0)


def kabsch_rotation(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Optimal rotation R (3x3) minimizing ||a @ R - b|| for centered a, b
    (the `rmsd.kabsch` convention: rotates A onto B)."""
    h = a.T @ b
    u, s, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(u @ vt))
    dmat = np.diag([1.0, 1.0, d])
    return u @ dmat @ vt


def kabsch_rmsd(a: np.ndarray, b: np.ndarray, translate: bool = True) -> float:
    """RMSD after optimal superposition of a onto b."""
    a = np.asarray(a, float)
    b = np.asarray(b, float)
    if translate:
        a = a - centroid(a)
        b = b - centroid(b)
    r = kabsch_rotation(a, b)
    diff = a @ r - b
    return float(np.sqrt((diff**2).sum() / len(a)))


def rigid_transform_3d(a: np.ndarray, b: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(R, t) with b ~= a @ R.T + t — the reference's SVD fit with the
    reflection fix (eval/MFF_RMSD.py:19-42)."""
    assert len(a) == len(b)
    ca, cb = centroid(a), centroid(b)
    aa, bb = a - ca, b - cb
    h = aa.T @ bb
    u, s, vt = np.linalg.svd(h)
    r = vt.T @ u.T
    if np.linalg.det(r) < 0:
        vt[2, :] *= -1
        r = vt.T @ u.T
    t = -r @ ca + cb
    return r, t


def flexible_transform_3d(a: np.ndarray, b: np.ndarray):
    """Kabsch rotation + the two centroids. (reference: MFF_RMSD.py:44-46)"""
    rot = kabsch_rotation(a - centroid(a), b - centroid(b))
    return rot, (centroid(a), centroid(b))


def apply_rigid(x: np.ndarray, r: np.ndarray, t: np.ndarray) -> np.ndarray:
    return x @ r.T + t.reshape(1, 3)
