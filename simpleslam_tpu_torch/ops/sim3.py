"""Sim(3) similarity transforms and robust 3D-3D alignment (the counterpart
of ``simpleslam_tpu/ops/sim3.py``).

Conventions (identical to the reference):
  * an element ``S = (R, t, s)`` acts on points as ``S . X = s R X + t``;
    camera nodes are camera-from-world similarities (``S_cw``);
  * tangent vectors are 7-dim ``[rho (3), phi (3), sigma (1)]``
    (translation, rotation, log-scale) with the Sophus/Strasdat exp and log
    closed forms, their small-angle and small-sigma cases branch-free.

Every function takes arbitrary leading batch dimensions and runs on the
device of its inputs, in their dtype (float32 in the pipeline). The 3x3
solve of ``log`` is Cramer's rule, so nothing here waits for the device
except the SVD of :func:`umeyama` (PyTorch checks its status on the host).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from simpleslam_tpu_torch.ops import se3
from simpleslam_tpu_torch.ops.maskops import take
from simpleslam_tpu_torch.ops.ransac import sample_minimal_sets
from simpleslam_tpu_torch.utils.precision import highest_precision

_EPS = 1e-7


class Sim3(NamedTuple):
    """Batched Sim(3) element: R (..., 3, 3), t (..., 3), s (...,)."""
    R: torch.Tensor
    t: torch.Tensor
    s: torch.Tensor


def identity(batch: Tuple[int, ...] = (), dtype=torch.float32,
             device=None) -> Sim3:
    return Sim3(R=torch.eye(3, dtype=dtype, device=device).expand(
        *batch, 3, 3).clone(),
        t=torch.zeros(*batch, 3, dtype=dtype, device=device),
        s=torch.ones(batch, dtype=dtype, device=device))


def from_se3(T: torch.Tensor) -> Sim3:
    """Lift a (..., 4, 4) rigid transform to Sim(3) with s = 1."""
    return Sim3(R=T[..., :3, :3], t=T[..., :3, 3],
                s=torch.ones(T.shape[:-2], dtype=T.dtype, device=T.device))


def to_se3(S: Sim3) -> torch.Tensor:
    """Camera-from-world Sim(3) -> SE(3) for the trajectory: ``[R | t/s]``
    (the corrected camera centre is -R^T t / s)."""
    return se3.rt_to_T(S.R, S.t / S.s[..., None])


def to_matrix(S: Sim3) -> torch.Tensor:
    """(..., 4, 4) homogeneous matrix [[sR, t], [0, 1]]."""
    return se3.rt_to_T(S.R * S.s[..., None, None], S.t)


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (A @ x[..., None])[..., 0]


def compose(A: Sim3, B: Sim3) -> Sim3:
    """A o B (apply B first)."""
    return Sim3(R=A.R @ B.R, t=A.s[..., None] * _mv(A.R, B.t) + A.t,
                s=A.s * B.s)


def inverse(S: Sim3) -> Sim3:
    Rt = S.R.transpose(-1, -2)
    si = torch.reciprocal(S.s)
    return Sim3(R=Rt, t=-si[..., None] * _mv(Rt, S.t), s=si)


def act(S: Sim3, X: torch.Tensor) -> torch.Tensor:
    """Apply to points (..., N, 3) -> (..., N, 3)."""
    return (S.s[..., None, None] * (X @ S.R.transpose(-1, -2))
            + S.t[..., None, :])


# ---------------------------------------------------------------------------
# exp / log
# ---------------------------------------------------------------------------

def _calc_W(theta: torch.Tensor, sigma: torch.Tensor, scale: torch.Tensor,
            Phi: torch.Tensor) -> torch.Tensor:
    """The Sim(3) 'V' matrix W with t = W rho (Sophus ``calcW``), its four
    (theta, sigma) small/large cases evaluated branch-free."""
    one = torch.ones_like(theta)
    theta2 = theta * theta
    sigma2 = sigma * sigma
    th_small = theta < 1e-4
    sg_small = sigma.abs() < 1e-4
    th_s = torch.where(th_small, one, theta)
    sg_s = torch.where(sg_small, one, sigma)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)

    C_ss = 1.0 + 0.5 * sigma + sigma2 / 6.0
    A_ss = torch.where(th_small, 0.5 - theta2 / 24.0,
                       (1.0 - cos_t) / torch.where(th_small, one, theta2))
    B_ss = torch.where(th_small, 1.0 / 6.0 - theta2 / 120.0,
                       (theta - sin_t) / torch.where(th_small, one,
                                                     theta2 * th_s))
    C_sl = (scale - 1.0) / sg_s
    A_sl_thsmall = ((sigma - 1.0) * scale + 1.0) / torch.where(
        sg_small, one, sigma2)
    B_sl_thsmall = (scale * (0.5 * sigma2 - sigma + 1.0) - 1.0) / \
        torch.where(sg_small, one, sigma2 * sg_s)
    a = scale * sin_t
    b = scale * cos_t
    c = theta2 + sigma2
    c_s = torch.where(c < 1e-12, one, c)
    A_sl_thlarge = (a * sigma + (1.0 - b) * theta) / (th_s * c_s)
    B_sl_thlarge = (C_sl - ((b - 1.0) * sigma + a * theta) / c_s) / \
        torch.where(th_small, one, theta2)

    C = torch.where(sg_small, C_ss, C_sl)
    A = torch.where(sg_small, A_ss,
                    torch.where(th_small, A_sl_thsmall, A_sl_thlarge))
    B = torch.where(sg_small, B_ss,
                    torch.where(th_small, B_sl_thsmall, B_sl_thlarge))
    eye = torch.eye(3, dtype=Phi.dtype, device=Phi.device)
    return (C[..., None, None] * eye + A[..., None, None] * Phi
            + B[..., None, None] * (Phi @ Phi))


# ``exp`` and ``log`` compute on a trailing singleton batch dimension: under
# ``torch.func.jacfwd`` an op between a 0-d tensor and a Python number gives
# a float64 tangent, and the pose graph differentiates single elements.

@highest_precision()
def exp(xi: torch.Tensor) -> Sim3:
    """Exp map: (..., 7) = [rho, phi, sigma] -> Sim3."""
    xi = xi[..., None, :]
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    theta = torch.sqrt((phi * phi).sum(-1) + 1e-24)
    scale = torch.exp(sigma)
    W = _calc_W(theta, sigma, scale, se3.hat(phi))
    return Sim3(R=se3.so3_exp(phi)[..., 0, :, :], t=_mv(W, rho)[..., 0, :],
                s=scale[..., 0])


def _solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A^-1 b for (..., 3, 3) A by Cramer's rule (no status check)."""
    c0 = torch.cross(A[..., :, 1], A[..., :, 2], dim=-1)
    c1 = torch.cross(A[..., :, 2], A[..., :, 0], dim=-1)
    c2 = torch.cross(A[..., :, 0], A[..., :, 1], dim=-1)
    det = (A[..., :, 0] * c0).sum(-1)
    return torch.stack([(b * c0).sum(-1), (b * c1).sum(-1),
                        (b * c2).sum(-1)], -1) / det[..., None]


@highest_precision()
def log(S: Sim3) -> torch.Tensor:
    """Log map: Sim3 -> (..., 7) = [rho, phi, sigma]."""
    R, t, s = S.R[..., None, :, :], S.t[..., None, :], S.s[..., None]
    phi = se3.so3_log(R)
    sigma = torch.log(torch.clamp(s, min=1e-12))
    theta = torch.sqrt((phi * phi).sum(-1) + 1e-24)
    W = _calc_W(theta, sigma, s, se3.hat(phi))
    eye = torch.eye(3, dtype=W.dtype, device=W.device)
    rho = _solve3(W + _EPS * eye, t)
    return torch.cat([rho, phi, sigma[..., None]], -1)[..., 0, :]


# ---------------------------------------------------------------------------
# Weighted Umeyama similarity alignment (3D-3D)
# ---------------------------------------------------------------------------

@highest_precision()
def umeyama(X: torch.Tensor, Y: torch.Tensor, w: torch.Tensor) -> Sim3:
    """Weighted closed-form similarity argmin_S sum_i w_i |S.X_i - Y_i|^2.

    X, Y: (..., N, 3); w: (..., N) non-negative weights (a boolean mask
    works). Degenerate inputs still give a finite Sim3 (RANSAC scores and
    discards it)."""
    w = w.to(X.dtype)
    wsum = torch.clamp(w.sum(-1), min=_EPS)
    mx = (w[..., None] * X).sum(-2) / wsum[..., None]
    my = (w[..., None] * Y).sum(-2) / wsum[..., None]
    Xc = X - mx[..., None, :]
    Yc = Y - my[..., None, :]
    cov = (Yc * w[..., None]).transpose(-1, -2) @ Xc / wsum[..., None, None]
    U, D, Vt = torch.linalg.svd(cov)
    d = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    Sfix = torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1)
    R = (U * Sfix[..., None, :]) @ Vt
    var_x = torch.clamp((w * (Xc * Xc).sum(-1)).sum(-1) / wsum, min=_EPS)
    s = (D * Sfix).sum(-1) / var_x
    s = torch.where(torch.isfinite(s) & (s > 1e-6), s, torch.ones_like(s))
    return Sim3(R=R, t=my - s[..., None] * _mv(R, mx), s=s)


def _take(S: Sim3, i: torch.Tensor) -> Sim3:
    """Element ``i`` (a 0-d device index) of a batched Sim3."""
    return Sim3(*(take(x, i) for x in S))


def _select(ok: torch.Tensor, a: Sim3, b: Sim3) -> Sim3:
    return Sim3(*(torch.where(ok, x, y) for x, y in zip(a, b)))


@highest_precision()
def sim3_ransac_3d3d(key, X: torch.Tensor, Y: torch.Tensor,
                     valid: torch.Tensor, thresh: float,
                     thresh_src: float | None = None, *, n_hyp: int = 256):
    """Robust Sim(3) from padded 3D-3D correspondences (X_i -> Y_i): all
    ``n_hyp`` minimal (3-point) Umeyama fits and their scores as one batch,
    the best refitted twice on its inliers (weighted Umeyama).

    The inlier gate is symmetric, each side in its own frame's units:
    forward error |S.x - y| < ``thresh`` and backward error
    |S^-1.y - x| < ``thresh_src`` (default ``thresh``), so a degenerate
    hypothesis cannot shrink one cloud onto the other. ``key``: the
    ``utils/rng.py`` key of the draws.

    Returns (Sim3, inliers (N,) bool, n_inliers, ok), all on the device."""
    if thresh_src is None:
        thresh_src = thresh
    idx, ok_h = sample_minimal_sets(key, valid, 3, n_hyp)
    models = umeyama(X[idx], Y[idx], torch.ones(idx.shape, dtype=X.dtype,
                                                device=X.device))
    inl = _inliers(models, X, Y, thresh, thresh_src) & valid[None, :]
    scores = inl.to(torch.int32).sum(1)
    scores = torch.where(ok_h, scores, torch.full_like(scores, -1))
    S_best = _take(models, torch.argmax(scores))
    for _ in range(2):
        w = (_inliers(S_best, X, Y, thresh, thresh_src) & valid).to(X.dtype)
        S_ref = umeyama(X, Y, w)
        S_best = _select(torch.isfinite(log(S_ref)).all(), S_ref, S_best)
    inliers = _inliers(S_best, X, Y, thresh, thresh_src) & valid
    n_inl = inliers.to(torch.int32).sum()
    return S_best, inliers, n_inl, ok_h[0] & (n_inl >= 3)


def _inliers(S: Sim3, X: torch.Tensor, Y: torch.Tensor, thresh: float,
             thresh_src: float) -> torch.Tensor:
    """(..., N) symmetric inlier masks of a (batch of) Sim3; the backward
    error stays in the source frame's units (no rescale by s)."""
    e_f = torch.linalg.norm(act(S, X) - Y, dim=-1)
    e_b = torch.linalg.norm(act(inverse(S), Y) - X, dim=-1)
    ok = (e_f < thresh) & (e_b < thresh_src)
    return ok & torch.isfinite(e_f) & torch.isfinite(e_b)
