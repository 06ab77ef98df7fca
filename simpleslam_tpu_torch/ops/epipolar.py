"""Two-view epipolar geometry: H / F / E estimation by batched RANSAC,
decompositions and pose recovery (the counterpart of
``simpleslam_tpu/ops/epipolar.py``).

Every fit takes a leading batch of point sets, so one call fits all RANSAC
hypotheses; residuals take a leading batch of models and return (S, M).
Eigen- and singular vectors carry an arbitrary sign (and differ in sign
between LAPACK, cuSOLVER and XLA): models agree with the reference up to
sign and scale, residuals and inlier masks agree outright.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.func import jacfwd

from simpleslam_tpu_torch.ops import se3
from simpleslam_tpu_torch.ops.maskops import take
from simpleslam_tpu_torch.ops.projection import pixels_to_normalized
from simpleslam_tpu_torch.ops.ransac import ransac
from simpleslam_tpu_torch.utils.precision import highest_precision

_EPS = 1e-12


# --------------------------------------------------------------------------- #
# Hartley normalisation + weighted DLT fits (minimal sets and refits alike)
# --------------------------------------------------------------------------- #

def _normalizing_transform(pts: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., n, 2), (..., n) -> (..., 3, 3) similarity taking the weighted
    points to centroid 0 and mean distance sqrt(2)."""
    wsum = torch.clamp(w.sum(-1), min=_EPS)
    mean = (pts * w[..., None]).sum(-2) / wsum[..., None]
    d = torch.sqrt(((pts - mean[..., None, :]) ** 2).sum(-1) + _EPS)
    scale = (2.0 ** 0.5) / torch.clamp((d * w).sum(-1) / wsum, min=_EPS)
    T = torch.zeros(*pts.shape[:-2], 3, 3, dtype=pts.dtype, device=pts.device)
    T[..., 0, 0] = scale
    T[..., 1, 1] = scale
    T[..., 2, 2].fill_(1.0)
    T[..., 0, 2] = -scale * mean[..., 0]
    T[..., 1, 2] = -scale * mean[..., 1]
    return T


def _apply_h(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    x = (T[..., 0, 0, None] * pts[..., 0] + T[..., 0, 1, None] * pts[..., 1]
         + T[..., 0, 2, None])
    y = (T[..., 1, 0, None] * pts[..., 0] + T[..., 1, 1, None] * pts[..., 1]
         + T[..., 1, 2, None])
    return torch.stack([x, y], -1)


def _smallest_singular_vector(A: torch.Tensor) -> torch.Tensor:
    """Right-singular vector of the smallest singular value of (..., m, n) A,
    as the smallest eigenvector of the n x n Gram matrix."""
    _, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    return V[..., :, 0]


def _weights(p: torch.Tensor, w: Optional[torch.Tensor]) -> torch.Tensor:
    return torch.ones(p.shape[:-1], dtype=p.dtype, device=p.device) \
        if w is None else w.to(p.dtype)


@highest_precision()
def fit_homography(p0: torch.Tensor, p1: torch.Tensor,
                   w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Weighted) normalised DLT homography p1 ~ H p0, batched."""
    w = _weights(p0, w)
    T0 = _normalizing_transform(p0, w)
    T1 = _normalizing_transform(p1, w)
    a = _apply_h(T0, p0)
    b = _apply_h(T1, p1)
    ones = torch.ones_like(a[..., :1])
    zeros = torch.zeros_like(torch.cat([a, ones], -1))
    ah = torch.cat([a, ones], -1)
    r1 = torch.cat([ah, zeros, -b[..., 0:1] * ah], -1)
    r2 = torch.cat([zeros, ah, -b[..., 1:2] * ah], -1)
    A = torch.cat([r1, r2], -2) * torch.cat([w, w], -1)[..., None]
    Hn = _smallest_singular_vector(A).reshape(*A.shape[:-2], 3, 3)
    H = torch.linalg.inv_ex(T1)[0] @ Hn @ T0
    h22 = H[..., 2, 2]
    h22 = torch.where(h22.abs() < _EPS, torch.full_like(h22, _EPS), h22)
    return H / h22[..., None, None]


@highest_precision()
def fit_fundamental(p0: torch.Tensor, p1: torch.Tensor,
                    w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Weighted) normalised 8-point F with rank-2 projection;
    p1^T F p0 = 0. Batched."""
    w = _weights(p0, w)
    T0 = _normalizing_transform(p0, w)
    T1 = _normalizing_transform(p1, w)
    a = _apply_h(T0, p0)
    b = _apply_h(T1, p1)
    x0, y0 = a[..., 0], a[..., 1]
    x1, y1 = b[..., 0], b[..., 1]
    A = torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0,
                     torch.ones_like(x0)], -1) * w[..., None]
    Fn = _smallest_singular_vector(A).reshape(*A.shape[:-2], 3, 3)
    U, S, Vt = torch.linalg.svd(Fn)
    S = torch.stack([S[..., 0], S[..., 1], torch.zeros_like(S[..., 2])], -1)
    Fn = (U * S[..., None, :]) @ Vt
    F = T1.transpose(-1, -2) @ Fn @ T0
    nrm = torch.linalg.norm(F, dim=(-2, -1))
    nrm = torch.where(nrm < _EPS, torch.full_like(nrm, _EPS), nrm)
    return F / nrm[..., None, None]


@highest_precision()
def fit_essential(p0n: torch.Tensor, p1n: torch.Tensor,
                  w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """8-point essential matrix on normalised coords, projected onto the
    essential manifold (singular values (s, s, 0)). Batched."""
    E = fit_fundamental(p0n, p1n, w)
    U, S, Vt = torch.linalg.svd(E)
    s = 0.5 * (S[..., 0] + S[..., 1])
    S = torch.stack([s, s, torch.zeros_like(s)], -1)
    return (U * S[..., None, :]) @ Vt


# --------------------------------------------------------------------------- #
# Residuals
# --------------------------------------------------------------------------- #

def _transfer(M: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    x = M[..., 0, 0, None] * p[:, 0] + M[..., 0, 1, None] * p[:, 1] \
        + M[..., 0, 2, None]
    y = M[..., 1, 0, None] * p[:, 0] + M[..., 1, 1, None] * p[:, 1] \
        + M[..., 1, 2, None]
    z = M[..., 2, 0, None] * p[:, 0] + M[..., 2, 1, None] * p[:, 1] \
        + M[..., 2, 2, None]
    z = torch.where(z.abs() < _EPS, torch.full_like(z, _EPS), z)
    return torch.stack([x / z, y / z], -1)


@highest_precision()
def symmetric_transfer_error_sq(H: torch.Tensor, p0: torch.Tensor,
                                p1: torch.Tensor) -> torch.Tensor:
    """d(p1, H p0)^2 + d(p0, H^-1 p1)^2; H (..., 3, 3) -> (..., M)."""
    Hinv = torch.linalg.inv_ex(H)[0]
    return (((_transfer(H, p0) - p1) ** 2).sum(-1)
            + ((_transfer(Hinv, p1) - p0) ** 2).sum(-1))


@highest_precision()
def sampson_error_sq(F: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor
                     ) -> torch.Tensor:
    """Sampson squared distance to p1^T F p0 = 0; F (..., 3, 3) -> (..., M)."""
    ones = torch.ones_like(p0[..., :1])
    x0 = torch.cat([p0, ones], -1)
    x1 = torch.cat([p1, ones], -1)
    Fx0 = x0 @ F.transpose(-1, -2)
    Ftx1 = x1 @ F
    num = (x1 * Fx0).sum(-1) ** 2
    den = Fx0[..., 0] ** 2 + Fx0[..., 1] ** 2 + Ftx1[..., 0] ** 2 \
        + Ftx1[..., 1] ** 2
    return num / torch.clamp(den, min=_EPS)


# --------------------------------------------------------------------------- #
# RANSAC front doors
# --------------------------------------------------------------------------- #

def _refit(fit, residual, p0, p1, valid, model, inl, thresh_sq, k, iters):
    for _ in range(iters):
        m2 = fit(p0, p1, inl.to(p0.dtype))
        inl2 = (residual(m2, p0, p1) < thresh_sq) & valid
        good = inl2.sum() >= k
        model = torch.where(good, m2, model)
        inl = torch.where(good, inl2, inl)
    return model, inl


def find_homography(key, p0: torch.Tensor, p1: torch.Tensor,
                    valid: torch.Tensor, thresh_px: float, n_hyp: int = 256,
                    refit_iters: int = 2):
    """cv2.findHomography(RANSAC) equivalent -> (H, inliers, ok).
    Inlier iff the symmetric transfer error < 2 t^2."""
    thresh_sq = 2.0 * thresh_px * thresh_px
    H, inl, _score, ok = ransac(
        key, p0, p1, valid, fit_fn=fit_homography,
        residual_fn=symmetric_transfer_error_sq, k=4, n_hyp=n_hyp,
        thresh_sq=thresh_sq, score="count")
    H, inl = _refit(fit_homography, symmetric_transfer_error_sq, p0, p1,
                    valid, H, inl, thresh_sq, 4, refit_iters)
    return H, inl, ok & (inl.sum() >= 4)


def find_fundamental(key, p0: torch.Tensor, p1: torch.Tensor,
                     valid: torch.Tensor, thresh_px: float, n_hyp: int = 256,
                     refit_iters: int = 2):
    """cv2.findFundamentalMat(RANSAC) equivalent -> (F, inliers, ok)."""
    thresh_sq = thresh_px * thresh_px
    F, inl, _score, ok = ransac(
        key, p0, p1, valid, fit_fn=fit_fundamental,
        residual_fn=sampson_error_sq, k=8, n_hyp=n_hyp, thresh_sq=thresh_sq,
        score="count")
    F, inl = _refit(fit_fundamental, sampson_error_sq, p0, p1, valid, F, inl,
                    thresh_sq, 8, refit_iters)
    return F, inl, ok & (inl.sum() >= 8)


def find_essential(key, p0: torch.Tensor, p1: torch.Tensor,
                   valid: torch.Tensor, K: torch.Tensor, thresh_px: float,
                   n_hyp: int = 256):
    """cv2.findEssentialMat(RANSAC) equivalent -> (E, inliers, ok); the
    pixel threshold becomes normalised units via the mean focal length."""
    p0n, p1n = pixels_to_normalized(p0, K), pixels_to_normalized(p1, K)
    t_norm = thresh_px / (0.5 * (K[0, 0] + K[1, 1]))
    thresh_sq = t_norm * t_norm
    E, inl, _score, ok = ransac(
        key, p0n, p1n, valid, fit_fn=fit_essential,
        residual_fn=sampson_error_sq, k=8, n_hyp=n_hyp, thresh_sq=thresh_sq,
        score="count")
    E2 = fit_essential(p0n, p1n, inl.to(p0.dtype))
    inl2 = (sampson_error_sq(E2, p0n, p1n) < thresh_sq) & valid
    better = inl2.sum() >= inl.sum()
    E = torch.where(better, E2, E)
    inl = torch.where(better, inl2, inl)
    # nonlinear Sampson polish on the (R, t) manifold
    E3 = refine_essential_sampson(E, p0n, p1n, inl.to(p0.dtype))
    inl3 = (sampson_error_sq(E3, p0n, p1n) < thresh_sq) & valid
    better3 = inl3.sum() >= inl.sum()
    E = torch.where(better3, E3, E)
    inl = torch.where(better3, inl3, inl)
    return E, inl, ok & (inl.sum() >= 8)


def essential_from_fundamental(F: torch.Tensor, K: torch.Tensor
                               ) -> torch.Tensor:
    return K.T @ F @ K


def _tangent_basis(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    e = torch.where(t[0].abs() < 0.9, t.new_tensor([1.0, 0.0, 0.0]),
                    t.new_tensor([0.0, 1.0, 0.0]))
    b1 = torch.linalg.cross(t, e)
    b1 = b1 / torch.clamp(torch.linalg.norm(b1), min=_EPS)
    return b1, torch.linalg.cross(t, b1)


@highest_precision()
def refine_essential_sampson(E: torch.Tensor, p0n: torch.Tensor,
                             p1n: torch.Tensor, w: torch.Tensor,
                             iters: int = 4) -> torch.Tensor:
    """Gauss-Newton on the essential manifold (R in SO(3), t on the unit
    sphere) minimising the weighted Sampson error."""
    R1, R2, t0 = decompose_essential(E)
    ones = torch.ones_like(p0n[:, :1])
    x0h = torch.cat([p0n, ones], 1)
    x1h = torch.cat([p1n, ones], 1)
    Rs = torch.stack([R1, R1, R2, R2])
    ts = torch.stack([t0, -t0, t0, -t0])
    z0, z1 = two_view_depths(Rs, ts, x0h, x1h)
    counts = (((z0 > 0) & (z1 > 0)).float() * w).sum(-1)
    best = torch.argmax(counts)
    R, t = take(Rs, best), take(ts, best)

    for _ in range(iters):
        b1, b2 = _tangent_basis(t)

        def res(params, R_cur=R, t_cur=t, b1=b1, b2=b2):
            # params is (1, 5): forward-mode AD in torch 2.13 promotes the
            # tangents of 0-d tensors mixed with Python scalars to float64,
            # so the perturbation keeps a batch axis
            Rc = se3.so3_exp(params[:, :3]) @ R_cur
            tc = t_cur + params[:, 3:4] * b1 + params[:, 4:5] * b2
            tc = tc / torch.clamp(torch.linalg.norm(tc, dim=-1, keepdim=True),
                                  min=_EPS)
            Ec = se3.hat(tc) @ Rc
            return (torch.sqrt(sampson_error_sq(Ec, p0n, p1n) + 1e-12)
                    * w)[0]

        p_zero = torch.zeros((1, 5), dtype=E.dtype, device=E.device)
        J = jacfwd(res)(p_zero)[:, 0, :]
        r = res(p_zero)
        H = J.T @ J + 1e-8 * torch.eye(5, dtype=E.dtype, device=E.device)
        dp = -torch.linalg.solve_ex(H, J.T @ r)[0]
        better = (res(dp[None]) ** 2).sum() < (r ** 2).sum()
        dp = torch.where(better, dp, torch.zeros_like(dp))
        R = se3.so3_exp(dp[:3]) @ R
        t = t + dp[3] * b1 + dp[4] * b2
        t = t / torch.clamp(torch.linalg.norm(t), min=_EPS)
    return se3.hat(t) @ R


# --------------------------------------------------------------------------- #
# Pose recovery
# --------------------------------------------------------------------------- #

@highest_precision()
def two_view_depths(R: torch.Tensor, t: torch.Tensor, x0h: torch.Tensor,
                    x1h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form per-correspondence depths for pose(s) (R (...,3,3),
    t (...,3)); x0h/x1h (N, 3) homogeneous rays -> z0, z1 (..., N)."""
    a = x0h @ R.transpose(-1, -2)
    b = x1h
    aa = (a * a).sum(-1)
    bb = (b * b).sum(-1)
    ab = (a * b).sum(-1)
    at = (a @ t[..., :, None])[..., 0]
    bt = (b @ t[..., :, None])[..., 0]
    det = aa * bb - ab * ab
    det = torch.where(det.abs() < _EPS, torch.full_like(det, _EPS), det)
    return (-at * bb + bt * ab) / det, (bt * aa - at * ab) / det


@highest_precision()
def decompose_essential(E: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """E -> (R1, R2, t_unit); candidates (R1,t),(R1,-t),(R2,t),(R2,-t)."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = E.new_tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    t = U[:, 2]
    return U @ W @ Vt, U @ W.T @ Vt, t / torch.clamp(torch.linalg.norm(t),
                                                     min=_EPS)


@highest_precision()
def recover_pose_essential(E: torch.Tensor, p0: torch.Tensor,
                           p1: torch.Tensor, valid: torch.Tensor,
                           K: torch.Tensor, max_depth: float = 1e6):
    """cv2.recoverPose equivalent: the (R, t) with the best cheirality vote
    -> (R, t, posdepth mask, n_good). x1 = R x0 + t (T_1from0)."""
    R1, R2, t = decompose_essential(E)
    Rs = torch.stack([R1, R1, R2, R2])
    ts = torch.stack([t, -t, t, -t])
    Kinv = torch.linalg.inv_ex(K)[0]
    ones = torch.ones_like(p0[:, :1])
    x0h = torch.cat([p0, ones], 1) @ Kinv.T
    x1h = torch.cat([p1, ones], 1) @ Kinv.T
    z0, z1 = two_view_depths(Rs, ts, x0h, x1h)
    good = ((z0 > 0) & (z1 > 0) & (z0 < max_depth) & (z1 < max_depth)
            & valid[None, :])
    counts = good.sum(-1)
    best = torch.argmax(counts)
    return (take(Rs, best), take(ts, best), take(good, best),
            take(counts, best))


@highest_precision()
def decompose_homography(H: torch.Tensor, K: torch.Tensor):
    """cv2.decomposeHomographyMat equivalent (Faugeras SVD method) ->
    (Rs (4,3,3), ts (4,3), ns (4,3)); a near-rotation H collapses to
    R = Hn (projected), t = 0."""
    Hn = torch.linalg.inv_ex(K)[0] @ H @ K
    U, S, Vt = torch.linalg.svd(Hn)
    d1, d2, d3 = S[0], S[1], S[2]
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    V = Vt.T
    denom = torch.clamp(d1 * d1 - d3 * d3, min=_EPS)
    x1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / denom, min=0.0))
    x3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / denom, min=0.0))
    d2s = torch.clamp(d2, min=_EPS)
    sin_t = (d1 - d3) * x1 * x3 / d2s
    cos_t = (d1 * x3 * x3 + d3 * x1 * x1) / d2s
    zero = torch.zeros_like(x1)

    Rs, ts, ns = [], [], []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            n = V @ torch.stack([e1 * x1, zero, e3 * x3])
            Rp = torch.stack([
                torch.stack([cos_t, zero, -e1 * e3 * sin_t]),
                torch.stack([zero, zero + 1.0, zero]),
                torch.stack([e1 * e3 * sin_t, zero, cos_t])])
            R = s * (U @ Rp @ Vt)
            tt = U @ ((d1 - d3) * torch.stack([e1 * x1, zero, -e3 * x3]))
            tn = torch.linalg.norm(tt)
            tt = torch.where(tn > _EPS, tt / torch.clamp(tn, min=_EPS), tt)
            Rs.append(R)
            ts.append(tt)
            ns.append(n)
    Rs, ts, ns = torch.stack(Rs), torch.stack(ts), torch.stack(ns)
    near_rot = (d1 - d3) / d2s < 1e-4
    R_rot = se3.project_to_SO3(Hn / d2s)
    Rs = torch.where(near_rot, R_rot.expand_as(Rs), Rs)
    ts = torch.where(near_rot, torch.zeros_like(ts), ts)
    return Rs, ts, ns
