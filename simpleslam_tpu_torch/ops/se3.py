"""SE(3) / SO(3) primitives on tensors (the counterpart of
``simpleslam_tpu/ops/se3.py``).

Conventions (identical to the reference):
  * poses are 4x4 ``T_cw`` (camera-from-world): ``x_cam = R @ X_world + t``;
  * quaternions are ``xyzw`` ordered and sign-canonicalised to ``w >= 0``;
  * se(3) tangents are ``[rho (translation), phi (rotation)]``.

Every function accepts arbitrary leading batch dimensions.
"""
from __future__ import annotations

from typing import Tuple

import torch

from simpleslam_tpu_torch.utils.precision import highest_precision

_EPS = 1e-12


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


@highest_precision()
def project_to_SO3(R: torch.Tensor) -> torch.Tensor:
    """Project (..., 3, 3) onto SO(3) via SVD (det fixed to +1)."""
    U, _, Vt = torch.linalg.svd(R)
    det = torch.linalg.det(U @ Vt)
    flip = torch.where(det < 0, -1.0, 1.0).to(R.dtype)
    U = torch.cat([U[..., :, :2], U[..., :, 2:] * flip[..., None, None]],
                  dim=-1)
    return U @ Vt


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a (..., 3) vector."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([torch.stack([z, -wz, wy], -1),
                        torch.stack([wz, z, -wx], -1),
                        torch.stack([-wy, wx, z], -1)], -2)


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


def _rodrigues_coeffs(theta2: torch.Tensor):
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-12
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta))
                    / torch.where(small, torch.ones_like(theta2), theta2))
    return a, b


@highest_precision()
def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle (..., 3) -> rotation (..., 3, 3)."""
    a, b = _rodrigues_coeffs((w * w).sum(-1))
    W = hat(w)
    return _eye(3, w) + a[..., None, None] * W + b[..., None, None] * (W @ W)


@highest_precision()
def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) -> axis-angle (..., 3), via the quaternion."""
    q = rotmat_to_quat(R)
    xyz, w = q[..., :3], q[..., 3]
    n = torch.linalg.norm(xyz, dim=-1)
    theta = 2.0 * torch.atan2(n, w)
    scale = torch.where(n < 1e-9, 2.0 / torch.clamp(w, min=_EPS),
                        theta / torch.clamp(n, min=_EPS))
    return xyz * scale[..., None]


def rotation_angle_deg(R: torch.Tensor) -> torch.Tensor:
    """Geodesic rotation angle in degrees of (..., 3, 3) rotations."""
    tr = R.diagonal(dim1=-2, dim2=-1).sum(-1)
    c = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    return torch.rad2deg(torch.arccos(c))


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> xyzw quaternion with w >= 0 (branch-free Shepperd)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def ssqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS))

    sw = ssqrt(qw2) * 2.0
    qa = torch.stack([(m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw,
                      sw / 4.0], -1)
    sx = ssqrt(qx2) * 2.0
    qb = torch.stack([sx / 4.0, (m01 + m10) / sx, (m02 + m20) / sx,
                      (m21 - m12) / sx], -1)
    sy = ssqrt(qy2) * 2.0
    qc = torch.stack([(m01 + m10) / sy, sy / 4.0, (m12 + m21) / sy,
                      (m02 - m20) / sy], -1)
    sz = ssqrt(qz2) * 2.0
    qd = torch.stack([(m02 + m20) / sz, (m12 + m21) / sz, sz / 4.0,
                      (m10 - m01) / sz], -1)
    cands = torch.stack([qa, qb, qc, qd], -2)
    idx = torch.stack([qw2, qx2, qy2, qz2], -1).argmax(-1)
    q = torch.gather(cands, -2,
                     idx[..., None, None].expand(*idx.shape, 1, 4))[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., 3:4] < 0, -1.0, 1.0).to(q.dtype)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """xyzw quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
    ], -2)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of xyzw quaternions."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], -1)


def rt_to_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R (...,3,3), t (...,3)) -> homogeneous (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(*batch, 3, 3)
    t = t.expand(*batch, 3)
    top = torch.cat([R, t[..., :, None]], -1)
    bottom = torch.zeros(*batch, 1, 4, dtype=R.dtype, device=R.device)
    bottom[..., 0, 3].fill_(1.0)      # a fill: assigning 1.0 copies it in
    return torch.cat([top, bottom], -2)


@highest_precision()
def T_inverse(T: torch.Tensor, reproject: bool = True) -> torch.Tensor:
    """Inverse of a (..., 4, 4) rigid transform, optionally re-projecting
    the rotation onto SO(3) first."""
    R = T[..., :3, :3]
    if reproject:
        R = project_to_SO3(R)
    Rt = R.transpose(-1, -2)
    return rt_to_T(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def T_compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


@highest_precision()
def camera_center(T_cw: torch.Tensor) -> torch.Tensor:
    """World-frame camera centre ``C = -R^T t``."""
    R = T_cw[..., :3, :3]
    return -(R.transpose(-1, -2) @ T_cw[..., :3, 3:4])[..., 0]


def pose_to_quat_trans(T: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return rotmat_to_quat(T[..., :3, :3]), T[..., :3, 3]


def quat_trans_to_pose(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return rt_to_T(quat_to_rotmat(q), t)


@highest_precision()
def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist (..., 6) = [rho, phi] -> (..., 4, 4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    theta2 = (phi * phi).sum(-1)
    small = theta2 < 1e-12
    a, b = _rodrigues_coeffs(theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (1.0 - a) / torch.where(small, torch.ones_like(theta2),
                                            theta2))
    W = hat(phi)
    W2 = W @ W
    eye = _eye(3, xi)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    return rt_to_T(R, (V @ rho[..., None])[..., 0])


@highest_precision()
def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> twist (..., 6) = [rho, phi]."""
    phi = so3_log(T[..., :3, :3])
    theta2 = (phi * phi).sum(-1)
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-12
    half = 0.5 * theta
    cot = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half)
         / torch.clamp(torch.sin(half), min=_EPS))
        / torch.clamp(theta2, min=_EPS))
    W = hat(phi)
    Vinv = _eye(3, T) - 0.5 * W + cot[..., None, None] * (W @ W)
    rho = (Vinv @ T[..., :3, 3:4])[..., 0]
    return torch.cat([rho, phi], -1)


@highest_precision()
def apply_left_update(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative retraction ``exp(xi) @ T``."""
    return se3_exp(xi) @ T


@highest_precision()
def transform_points(T: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) transforms to points (..., N, 3)."""
    return X @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]
