"""Trajectory alignment helpers (the counterpart of
``simpleslam_tpu/core/trajectory_utils.py``, plus the Umeyama similarity of
``simpleslam_tpu/viz/trajectory2d.py``, kept here so evaluation needs no
viz module).

``compute_gt_alignment`` returns the rigid transform that expresses
ground-truth poses relative to the first one; ``apply_alignment`` applies
it; ``umeyama_sim3`` is the least-squares similarity between two point
sets.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def compute_gt_alignment(gt_T: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(R, t) such that aligned = R @ (gt - t): expresses GT relative to the
    first pose."""
    T0 = np.asarray(gt_T[0])
    R0 = T0[:3, :3]
    t0 = T0[:3, 3]
    return R0.T, t0


def apply_alignment(positions: np.ndarray, R: np.ndarray,
                    t: np.ndarray) -> np.ndarray:
    return (np.asarray(positions) - t) @ R.T


def umeyama_sim3(src: np.ndarray, dst: np.ndarray):
    """Similarity (s, R, t) minimizing ||dst - (s R src + t)||^2 (Umeyama)."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = dc.T @ sc / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (sc ** 2).sum() / len(src)
    s = np.trace(np.diag(D) @ S) / max(var_s, 1e-12)
    t = mu_d - s * R @ mu_s
    return s, R, t
