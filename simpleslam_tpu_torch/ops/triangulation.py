"""Batched DLT triangulation and the acceptance gates around it (the
counterpart of ``simpleslam_tpu/ops/triangulation.py``; the N-view API
waits for a later slice).

One point is one tiny homogeneous least-squares problem ``A X = 0`` with
two rows per view, solved for all points at once by a batched SVD.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from simpleslam_tpu_torch.ops import se3
from simpleslam_tpu_torch.ops.projection import project_points
from simpleslam_tpu_torch.utils.precision import highest_precision

_EPS = 1e-12


@highest_precision()
def projection_matrix(K: torch.Tensor, T_cw: torch.Tensor) -> torch.Tensor:
    """P = K @ T_cw[:3, :]."""
    return K @ T_cw[..., :3, :4]


def _dlt_rows(P: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Two DLT rows per observation: [u P2 - P0, v P2 - P1] -> (..., 2, 4)."""
    u = uv[..., 0:1]
    v = uv[..., 1:2]
    return torch.stack([u * P[..., 2, :] - P[..., 0, :],
                        v * P[..., 2, :] - P[..., 1, :]], -2)


@highest_precision()
def triangulate_two_view(P0: torch.Tensor, P1: torch.Tensor,
                         uv0: torch.Tensor, uv1: torch.Tensor) -> torch.Tensor:
    """(N,2)+(N,2) pixels -> (N,3) world points (cv2.triangulatePoints plus
    dehomogenisation with a finite-w guard)."""
    A = torch.cat([_dlt_rows(P0, uv0), _dlt_rows(P1, uv1)], -2)
    Xh = torch.linalg.svd(A).Vh[..., 3, :]
    w = Xh[..., 3]
    w = torch.where(w.abs() < _EPS, torch.full_like(w, _EPS), w)
    return Xh[..., :3] / w[..., None]


@highest_precision()
def parallax_deg_world(X_w: torch.Tensor, T0_cw: torch.Tensor,
                       T1_cw: torch.Tensor) -> torch.Tensor:
    """Angle (degrees) between the rays from each camera centre to the
    point, in the world frame (pure rotation gives ~0)."""
    r0 = X_w - se3.camera_center(T0_cw)
    r1 = X_w - se3.camera_center(T1_cw)
    r0 = r0 / torch.clamp(torch.linalg.norm(r0, dim=-1, keepdim=True),
                          min=_EPS)
    r1 = r1 / torch.clamp(torch.linalg.norm(r1, dim=-1, keepdim=True),
                          min=_EPS)
    cos = torch.clamp((r0 * r1).sum(-1), -1.0, 1.0)
    return torch.rad2deg(torch.arccos(cos))


@highest_precision()
def two_view_gates(X_w: torch.Tensor, K: torch.Tensor, T0_cw: torch.Tensor,
                   T1_cw: torch.Tensor, uv0: torch.Tensor, uv1: torch.Tensor,
                   *, min_depth: float, max_depth: float,
                   min_parallax_deg: float, max_reproj_px: float
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Parallax >= min, depth window in both views, cheirality, and
    max(reprojection error) <= threshold. Returns (keep, per-gate masks)."""
    uvp0, z0, front0 = project_points(X_w, T0_cw, K)
    uvp1, z1, front1 = project_points(X_w, T1_cw, K)
    e0 = torch.linalg.norm(uvp0 - uv0, dim=-1)
    e1 = torch.linalg.norm(uvp1 - uv1, dim=-1)
    g_par = parallax_deg_world(X_w, T0_cw, T1_cw) >= min_parallax_deg
    g_depth = ((z0 >= min_depth) & (z0 <= max_depth)
               & (z1 >= min_depth) & (z1 <= max_depth))
    g_cheir = front0 & front1
    g_reproj = torch.maximum(e0, e1) <= max_reproj_px
    keep = g_par & g_depth & g_cheir & g_reproj
    return keep, {"parallax": g_par, "depth": g_depth,
                  "cheirality": g_cheir, "reproj": g_reproj}
