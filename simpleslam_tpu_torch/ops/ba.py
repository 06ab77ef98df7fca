"""Schur-complement Levenberg-Marquardt bundle adjustment (the counterpart
of ``simpleslam_tpu/ops/ba.py``; ``ba_solve_batch``, ``ba_solve_sharded``
and the point-major edge layout wait for the fused step).

* residuals: pinhole reprojection ``pi(K, T_cw_j, X_i) - uv_e`` over a
  padded edge list (cam_idx, pt_idx, uv, e_valid);
* robustness: Huber(delta) through IRLS weights;
* parametrisation: left se(3) updates ``T <- exp(dx) T``; gauge-fixed
  cameras and frozen points get zero updates;
* linear algebra: per-point 3x3 blocks inverted in closed form, the
  (6P x 6P) reduced camera system assembled densely and solved by
  Cholesky; a non-SPD system gives a zero step, which LM rejects;
* the per-camera and per-point block sums are segment sums over the edges
  sorted by segment (the reference expressed them as one-hot matmuls for
  the TPU's matrix unit; on the GPU the (E, L) one-hot would cost hundreds
  of MB). ``index_add_`` would do the same sums, but on CUDA its atomic
  adds land in a varying order, and a monocular run amplifies that
  rounding from run to run; ``segment_reduce`` sums each segment in edge
  order, the same order as on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from simpleslam_tpu_torch.ops import se3
from simpleslam_tpu_torch.utils.precision import highest_precision

_EPS = 1e-12


class BAProblem(NamedTuple):
    """Padded BA problem.

    poses (P,4,4) T_cw; points (L,3); cam_idx/pt_idx (E,) int64;
    uv (E,2); e_valid (E,) bool; cam_free (P,) bool (False = gauge-fixed);
    pt_free (L,) bool (False = frozen landmark).
    """
    poses: torch.Tensor
    points: torch.Tensor
    cam_idx: torch.Tensor
    pt_idx: torch.Tensor
    uv: torch.Tensor
    e_valid: torch.Tensor
    cam_free: torch.Tensor
    pt_free: torch.Tensor


def _edge_residuals(poses, points, K, cam_idx, pt_idx, uv, e_valid):
    """(E,2) residuals, (E,) validity (live and in front), camera points."""
    T = poses[cam_idx]
    pc = torch.einsum("eij,ej->ei", T[:, :3, :3], points[pt_idx]) \
        + T[:, :3, 3]
    z = pc[:, 2]
    ok = e_valid & (z > 1e-6)
    zs = torch.where(z > 1e-6, z, torch.ones_like(z))
    r = torch.stack([K[0, 0] * pc[:, 0] / zs + K[0, 2] - uv[:, 0],
                     K[1, 1] * pc[:, 1] / zs + K[1, 2] - uv[:, 1]], 1)
    return torch.where(ok[:, None], r, torch.zeros_like(r)), ok, pc


def _huber_weights(r: torch.Tensor, delta: float) -> torch.Tensor:
    n = torch.linalg.norm(r, dim=1)
    return torch.where(n <= delta, torch.ones_like(n),
                       delta / torch.clamp(n, min=_EPS))


def _robust_cost(r: torch.Tensor, ok: torch.Tensor, delta: float
                 ) -> torch.Tensor:
    s = (r * r).sum(1)
    n = torch.sqrt(torch.clamp(s, min=0.0))
    rho = torch.where(n <= delta, s, 2.0 * delta * n - delta * delta)
    return torch.where(ok, rho, torch.zeros_like(rho)).sum()


def _inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A, B, C = e * i - f * h, c * h - b * i, b * f - c * e
    D, E, F = f * g - d * i, a * i - c * g, c * d - a * f
    G, H, I = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * A + b * D + c * G
    det = torch.where(det.abs() < _EPS, torch.full_like(det, _EPS), det)
    adj = torch.stack([torch.stack([A, B, C], -1), torch.stack([D, E, F], -1),
                       torch.stack([G, H, I], -1)], -2)
    return adj / det[..., None, None]


def _segment_sum(values: torch.Tensor, index: torch.Tensor, n: int
                 ) -> torch.Tensor:
    order = torch.argsort(index, stable=True)
    counts = torch.bincount(index, minlength=n)
    return torch.segment_reduce(values[order], "sum", lengths=counts,
                                axis=0)


def _ba_solve_impl(problem: BAProblem, K: torch.Tensor, *,
                   huber: float = 2.0, max_iters: int = 12,
                   init_lambda: float = 1e-3):
    """LM with Schur-complement steps. Stops at ``max_iters``, after 3
    consecutive rejected steps, or when an accepted step improves the cost
    by < 1e-5 relative (one host read of two scalars per iteration)."""
    P = problem.poses.shape[0]
    L = problem.points.shape[0]
    dev = problem.points.device
    K = K.float()
    cam_idx, pt_idx = problem.cam_idx, problem.pt_idx
    uv, e_valid = problem.uv, problem.e_valid
    cam_free_f = problem.cam_free.float()
    pt_free_f = problem.pt_free.float()
    fx, fy = K[0, 0], K[1, 1]
    eye3 = torch.eye(3, device=dev)
    eye6 = torch.eye(6, device=dev)
    free = problem.cam_free.repeat_interleave(6)
    pin = torch.diag(torch.where(free, 0.0, 1.0))

    def cost_of(poses, points):
        r, ok, _ = _edge_residuals(poses, points, K, cam_idx, pt_idx, uv,
                                   e_valid)
        return _robust_cost(r, ok, huber)

    def lm_step(poses, points, lam):
        r, ok, pc = _edge_residuals(poses, points, K, cam_idx, pt_idx, uv,
                                    e_valid)
        w = _huber_weights(r, huber) * ok.float()
        z = torch.clamp(pc[:, 2], min=1e-6)
        zi = 1.0 / z
        x, y = pc[:, 0], pc[:, 1]
        zero = torch.zeros_like(z)
        Jpc = torch.stack([torch.stack([fx * zi, zero, -fx * x * zi * zi], 1),
                           torch.stack([zero, fy * zi, -fy * y * zi * zi], 1)],
                          1)                                       # (E,2,3)
        Jc = torch.cat([eye3.expand(pc.shape[0], 3, 3), -se3.hat(pc)], 2)
        Jcam = Jpc @ Jc                                            # (E,2,6)
        Jpt = Jpc @ poses[cam_idx][:, :3, :3]                      # (E,2,3)
        Jcam = Jcam * cam_free_f[cam_idx][:, None, None]
        Jpt = Jpt * pt_free_f[pt_idx][:, None, None]
        wJcam = Jcam * w[:, None, None]
        wJpt = Jpt * w[:, None, None]

        U = _segment_sum(torch.einsum("eri,erj->eij", wJcam, Jcam),
                         cam_idx, P)                               # (P,6,6)
        V = _segment_sum(torch.einsum("eri,erj->eij", wJpt, Jpt),
                         pt_idx, L)                                # (L,3,3)
        gc = _segment_sum(-torch.einsum("eri,er->ei", wJcam, r), cam_idx, P)
        gp = _segment_sum(-torch.einsum("eri,er->ei", wJpt, r), pt_idx, L)
        cross = torch.einsum("eri,erj->eij", wJcam, Jpt)           # (E,6,3)
        A = _segment_sum(cross, pt_idx * P + cam_idx, L * P
                         ).reshape(L, P, 6, 3)

        Ud = U + lam * (U * eye6) + 1e-8 * eye6
        Vd = V + lam * (V * eye3) + 1e-8 * eye3
        Vinv = _inv3x3(Vd) * pt_free_f[:, None, None]

        AV = torch.einsum("lpis,lst->lpit", A, Vinv)
        Sd = -torch.einsum("lpit,lqjt->pqij", AV, A)
        diag = torch.arange(P, device=dev)
        Sd[diag, diag] += Ud
        rhs = gc - torch.einsum("lpit,lt->pi", AV, gp)
        Sm = Sd.permute(0, 2, 1, 3).reshape(6 * P, 6 * P)
        Sm = torch.where(free[:, None] & free[None, :], Sm,
                         torch.zeros_like(Sm)) + pin
        rv = torch.where(free, rhs.reshape(-1), torch.zeros_like(free,
                                                                 dtype=Sm.dtype))
        Lc, info = torch.linalg.cholesky_ex(Sm)
        dc = torch.cholesky_solve(rv[:, None], Lc)[:, 0]
        dc = torch.where((info == 0) & torch.isfinite(dc).all(), dc,
                         torch.zeros_like(dc)).reshape(P, 6)
        dp = torch.einsum("lst,lt->ls", Vinv,
                          gp - torch.einsum("lpit,pi->lt", A, dc))
        dc = dc * cam_free_f[:, None]
        dp = dp * pt_free_f[:, None]
        poses_new = se3.se3_exp(dc) @ poses
        points_new = points + dp
        c_old = _robust_cost(r, ok, huber)
        c_new = cost_of(poses_new, points_new)
        accept = (c_new < c_old) & torch.isfinite(c_new)
        poses = torch.where(accept, poses_new, poses)
        points = torch.where(accept, points_new, points)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9),
                          torch.clamp(lam * 4.0, max=1e6))
        return poses, points, lam, accept, c_old, c_new

    poses = problem.poses.float()
    points = problem.points.float()
    c0 = cost_of(poses, points)
    lam = torch.tensor(init_lambda, device=dev)
    n_good, n_rej = 0, 0
    for _ in range(max_iters):
        poses, points, lam, accept, c_before, c_after = lm_step(poses, points,
                                                                lam)
        acc, cb, ca = (v.item() for v in torch.stack(
            [accept.float(), c_before, c_after]).cpu())
        rel = (cb - ca) / max(cb, 1e-12)
        n_good += int(acc)
        n_rej = 0 if acc else n_rej + 1
        if n_rej >= 3 or (acc and rel < 1e-5):
            break
    return poses, points, c0, cost_of(poses, points), n_good


@highest_precision()
def ba_solve(problem: BAProblem, K: torch.Tensor, *, huber: float = 2.0,
             max_iters: int = 12, init_lambda: float = 1e-3):
    """LM with Schur-complement steps -> (poses, points, cost_initial,
    cost_final, n_good_iters)."""
    return _ba_solve_impl(problem, K, huber=huber, max_iters=max_iters,
                          init_lambda=init_lambda)


@highest_precision()
def pose_only_refine(Tcw: torch.Tensor, points: torch.Tensor,
                     uv: torch.Tensor, valid: torch.Tensor, K: torch.Tensor,
                     *, huber: float = 2.0, max_iters: int = 8):
    """Robust single-pose LM with landmarks fixed -> (Tcw, cost0, cost1)."""
    fx, fy = K[0, 0], K[1, 1]
    eye3 = torch.eye(3, dtype=points.dtype, device=points.device)
    eye6 = torch.eye(6, dtype=points.dtype, device=points.device)

    def residuals(T):
        pc = points @ T[:3, :3].T + T[:3, 3]
        z = pc[:, 2]
        ok = valid & (z > 1e-6)
        zs = torch.where(z > 1e-6, z, torch.ones_like(z))
        r = torch.stack([fx * pc[:, 0] / zs + K[0, 2] - uv[:, 0],
                         fy * pc[:, 1] / zs + K[1, 2] - uv[:, 1]], 1)
        return torch.where(ok[:, None], r, torch.zeros_like(r)), ok, pc

    def cost(T):
        r, ok, _ = residuals(T)
        return _robust_cost(r, ok, huber)

    T = Tcw.float()
    lam = torch.tensor(1e-3, device=points.device)
    c0 = cost(T)
    for _ in range(max_iters):
        r, ok, pc = residuals(T)
        w = _huber_weights(r, huber) * ok.float()
        zi = 1.0 / torch.clamp(pc[:, 2], min=1e-6)
        zero = torch.zeros_like(zi)
        Jpc = torch.stack(
            [torch.stack([fx * zi, zero, -fx * pc[:, 0] * zi * zi], 1),
             torch.stack([zero, fy * zi, -fy * pc[:, 1] * zi * zi], 1)], 1)
        J = Jpc @ torch.cat([eye3.expand(pc.shape[0], 3, 3), -se3.hat(pc)], 2)
        Jw = J * w[:, None, None]
        Hm = torch.einsum("eri,erj->ij", Jw, J)
        Hm = Hm + lam * torch.diag(torch.diag(Hm)) + 1e-8 * eye6
        dx = torch.linalg.solve(Hm, -torch.einsum("eri,er->i", Jw, r))
        T_new = se3.se3_exp(dx) @ T
        better = cost(T_new) < cost(T)
        T = torch.where(better, T_new, T)
        lam = torch.where(better, lam * 0.5, lam * 4.0)
    return T, c0, cost(T)
