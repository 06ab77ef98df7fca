"""Pinhole projection (the counterpart of ``simpleslam_tpu/ops/projection.py``).

Lens distortion (``undistort_points``, ``undistort_rectify_map``,
``remap_bilinear``) is not ported yet: ``SLAMSystem`` raises for a nonzero
distortion vector.
"""
from __future__ import annotations

from typing import Tuple

import torch

from simpleslam_tpu_torch.utils.precision import highest_precision


@highest_precision()
def project_points(X_w: torch.Tensor, T_cw: torch.Tensor, K: torch.Tensor,
                   eps: float = 1e-9
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """World points (..., N, 3) -> (uv (..., N, 2), depth z (..., N),
    in_front (..., N) = z > eps)."""
    R = T_cw[..., :3, :3]
    t = T_cw[..., :3, 3]
    Xc = X_w @ R.transpose(-1, -2) + t[..., None, :]
    z = Xc[..., 2]
    in_front = z > eps
    zs = torch.where(z.abs() < eps, torch.full_like(z, eps), z)
    xn = Xc[..., 0] / zs
    yn = Xc[..., 1] / zs
    fx = K[..., 0, 0][..., None]
    fy = K[..., 1, 1][..., None]
    cx = K[..., 0, 2][..., None]
    cy = K[..., 1, 2][..., None]
    return torch.stack([fx * xn + cx, fy * yn + cy], -1), z, in_front


def pixels_to_normalized(uv: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixel coords (..., N, 2) -> normalised image coords (K^-1 lift)."""
    fx = K[..., 0, 0][..., None]
    fy = K[..., 1, 1][..., None]
    cx = K[..., 0, 2][..., None]
    cy = K[..., 1, 2][..., None]
    return torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], -1)


def normalized_to_pixels(xy: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    fx = K[..., 0, 0][..., None]
    fy = K[..., 1, 1][..., None]
    cx = K[..., 0, 2][..., None]
    cy = K[..., 1, 2][..., None]
    return torch.stack([xy[..., 0] * fx + cx, xy[..., 1] * fy + cy], -1)
