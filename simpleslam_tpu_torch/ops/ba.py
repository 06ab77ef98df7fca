"""Schur-complement Levenberg-Marquardt bundle adjustment (the counterpart
of ``simpleslam_tpu/ops/ba.py``): ``ba_solve`` for one window,
``ba_solve_batch`` for many padded to one shape, ``ba_solve_sharded`` for
one window whose edges are split over a process group.

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
  order, the same order as on the CPU;
* point-major edges (``point_major_obs=O``, the layout the fused step's
  local BA emits: ``E == L*O``, ``pt_idx == repeat(arange(L), O)``): the
  per-point sums are reshape-sums over the O slots and the camera-point
  coupling is O index writes, one edge per point each, in slot order.
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


def _edge_residuals(poses, points, Ke, cam_idx, pt_idx, uv, e_valid):
    """(E,2) residuals, (E,) validity (live and in front), camera points.
    ``Ke``: (fx, fy, cx, cy), each a number, a 0-d tensor or one per
    edge."""
    fx, fy, cx, cy = Ke
    T = poses[cam_idx]
    pc = torch.einsum("eij,ej->ei", T[:, :3, :3], points[pt_idx]) \
        + T[:, :3, 3]
    z = pc[:, 2]
    ok = e_valid & (z > 1e-6)
    zs = torch.where(z > 1e-6, z, torch.ones_like(z))
    r = torch.stack([fx * pc[:, 0] / zs + cx - uv[:, 0],
                     fy * pc[:, 1] / zs + cy - uv[:, 1]], 1)
    return torch.where(ok[:, None], r, torch.zeros_like(r)), ok, pc


def _huber_weights(r: torch.Tensor, delta: float) -> torch.Tensor:
    n = torch.linalg.norm(r, dim=1)
    return torch.where(n <= delta, torch.ones_like(n),
                       delta / torch.clamp(n, min=_EPS))


def _robust_rho(r: torch.Tensor, ok: torch.Tensor, delta: float
                ) -> torch.Tensor:
    """(E,) Huber costs of the edges, 0 where not ``ok``."""
    s = (r * r).sum(1)
    n = torch.sqrt(torch.clamp(s, min=0.0))
    rho = torch.where(n <= delta, s, 2.0 * delta * n - delta * delta)
    return torch.where(ok, rho, torch.zeros_like(rho))


def _robust_cost(r: torch.Tensor, ok: torch.Tensor, delta: float
                 ) -> torch.Tensor:
    return _robust_rho(r, ok, delta).sum()


def _window_costs(r: torch.Tensor, ok: torch.Tensor, delta: float, B: int
                  ) -> torch.Tensor:
    """(B,) robust costs of B windows' edges laid end to end."""
    return _robust_rho(r, ok, delta).reshape(B, -1).sum(1)


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
    counts = torch.zeros(n, dtype=torch.int64, device=index.device) \
        .scatter_add_(0, index, torch.ones_like(index))
    # unsafe: the counts are right by construction; the checks would read
    # them on the host
    return torch.segment_reduce(values[order], "sum", lengths=counts,
                                axis=0, unsafe=True)


def _ba_solve_impl(problem: BAProblem, K: torch.Tensor, *,
                   huber: float = 2.0, max_iters: int = 12,
                   init_lambda: float = 1e-3, point_major_obs: int = 0,
                   group=None):
    """LM with Schur-complement steps over B windows at once: every field
    of ``problem`` carries a leading window axis (all windows padded to one
    shape), ``K`` is (B, 3, 3). The windows' edges are laid end to end, so
    each block sum is one segment sum over all of them; the reduced camera
    systems are solved as one batch. Each window keeps its own damping and
    stop rule: it stops at ``max_iters``, after 3 consecutive rejected
    steps, or when an accepted step improves its cost by < 1e-5 relative.
    The reference's ``while_loop`` tests that on the device; here all
    ``max_iters`` iterations run and the test freezes a window's iterate
    once it holds, so nothing is read back to the host.

    ``group``: a process group whose ranks each hold a slice of one
    window's edges (poses and points replicated). Every edge sum (the
    blocks U, gc, V, gp, the coupling A and the costs) is all-reduced
    over it, and every rank solves the small reduced camera system
    redundantly. Point-major is off then (a slice loses the layout).
    """
    B, P = problem.poses.shape[:2]
    L = problem.points.shape[1]
    E = problem.cam_idx.shape[1]
    dev = problem.points.device
    O = int(point_major_obs) if group is None else 0
    if O and E != L * O:
        raise ValueError(f"point_major_obs={O} needs E == L*O "
                         f"({E} != {L}*{O})")

    def allreduce(x):
        if group is not None:
            torch.distributed.all_reduce(x, group=group)
        return x

    K = K.float()
    Ke = tuple(K[:, i, j].repeat_interleave(E)
               for i, j in ((0, 0), (1, 1), (0, 2), (1, 2)))
    fx, fy = Ke[0], Ke[1]
    win = torch.arange(B, device=dev)[:, None]
    cam_loc = problem.cam_idx.reshape(-1)              # camera in window
    cam_idx = (problem.cam_idx + win * P).reshape(-1)  # rows of all poses
    pt_idx = (problem.pt_idx + win * L).reshape(-1)    # rows of all points
    uv = problem.uv.reshape(-1, 2)
    e_valid = problem.e_valid.reshape(-1)
    cam_free_f = problem.cam_free.reshape(-1).float()
    pt_free_f = problem.pt_free.reshape(-1).float()
    eye3 = torch.eye(3, device=dev)
    eye6 = torch.eye(6, device=dev)
    free = problem.cam_free.repeat_interleave(6, dim=1)          # (B, 6P)
    pin = torch.diag_embed(torch.where(free, 0.0, 1.0))

    def per_row(x, n):        # (B,) -> one value a row of n rows a window
        return x.repeat_interleave(n)[:, None, None]

    def cost_of(poses, points):
        r, ok, _ = _edge_residuals(poses, points, Ke, cam_idx, pt_idx, uv,
                                   e_valid)
        return allreduce(_window_costs(r, ok, huber, B))

    def lm_step(poses, points, lam):
        r, ok, pc = _edge_residuals(poses, points, Ke, cam_idx, pt_idx, uv,
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

        U = allreduce(_segment_sum(torch.einsum("eri,erj->eij", wJcam, Jcam),
                                   cam_idx, B * P))                # (BP,6,6)
        gc = allreduce(_segment_sum(-torch.einsum("eri,er->ei", wJcam, r),
                                    cam_idx, B * P))
        JJp = torch.einsum("eri,erj->eij", wJpt, Jpt)              # (E,3,3)
        gpe = -torch.einsum("eri,er->ei", wJpt, r)                 # (E,3)
        cross = torch.einsum("eri,erj->eij", wJcam, Jpt)           # (E,6,3)
        if O:
            V = JJp.reshape(B * L, O, 3, 3).sum(1)
            gp = gpe.reshape(B * L, O, 3).sum(1)
            A = torch.zeros((B * L, P, 6, 3), dtype=cross.dtype, device=dev)
            rows = torch.arange(B * L, device=dev)
            cam_lo = cam_loc.reshape(B * L, O)
            cross_lo = cross.reshape(B * L, O, 6, 3)
            for o in range(O):
                A[rows, cam_lo[:, o]] += cross_lo[:, o]
        else:
            V = allreduce(_segment_sum(JJp, pt_idx, B * L))        # (BL,3,3)
            gp = allreduce(_segment_sum(gpe, pt_idx, B * L))
            A = allreduce(_segment_sum(cross, pt_idx * P + cam_loc,
                                       B * L * P).reshape(B * L, P, 6, 3))

        Ud = U + per_row(lam, P) * (U * eye6) + 1e-8 * eye6
        Vd = V + per_row(lam, L) * (V * eye3) + 1e-8 * eye3
        Vinv = _inv3x3(Vd) * pt_free_f[:, None, None]

        AV = torch.einsum("lpis,lst->lpit", A, Vinv)
        # One window keeps the unbatched Schur contractions (here and dA
        # below): the batched ones sum in another order on the card, and
        # with that rounding chip_smoke.py phase 8 (b)'s host-against-fused
        # check of the boxes lap (LAP_PARITY) fails on an H100 (median
        # 3.56 m, max 11.0 m against 2.5 / 7.0)
        if B == 1:
            Sd = -torch.einsum("lpit,lqjt->pqij", AV, A)[None]
            rhs = gc - torch.einsum("lpit,lt->pi", AV, gp)
        else:
            Sd = -torch.einsum("blpit,blqjt->bpqij",
                               AV.reshape(B, L, P, 6, 3),
                               A.reshape(B, L, P, 6, 3))
            rhs = gc - torch.einsum("blpit,blt->bpi",
                                    AV.reshape(B, L, P, 6, 3),
                                    gp.reshape(B, L, 3)).reshape(B * P, 6)
        diag = torch.arange(P, device=dev)
        Sd[:, diag, diag] += Ud.reshape(B, P, 6, 6)
        Sm = Sd.permute(0, 1, 3, 2, 4).reshape(B, 6 * P, 6 * P)
        Sm = torch.where(free[:, :, None] & free[:, None, :], Sm,
                         torch.zeros_like(Sm)) + pin
        rv = torch.where(free, rhs.reshape(B, 6 * P),
                         torch.zeros_like(free, dtype=Sm.dtype))
        Lc, info = torch.linalg.cholesky_ex(Sm)
        dc = torch.cholesky_solve(rv[..., None], Lc)[..., 0]       # (B, 6P)
        good = (info == 0) & torch.isfinite(dc).all(1)
        dc = torch.where(good[:, None], dc,
                         torch.zeros_like(dc)).reshape(B * P, 6)
        if B == 1:
            dA = torch.einsum("lpit,pi->lt", A, dc)
        else:
            dA = torch.einsum("blpit,bpi->blt", A.reshape(B, L, P, 6, 3),
                              dc.reshape(B, P, 6)).reshape(B * L, 3)
        dp = torch.einsum("lst,lt->ls", Vinv, gp - dA)
        dc = dc * cam_free_f[:, None]
        dp = dp * pt_free_f[:, None]
        poses_new = se3.se3_exp(dc) @ poses
        points_new = points + dp
        c_old = allreduce(_window_costs(r, ok, huber, B))
        c_new = cost_of(poses_new, points_new)
        accept = (c_new < c_old) & torch.isfinite(c_new)           # (B,)
        poses = torch.where(per_row(accept, P), poses_new, poses)
        points = torch.where(per_row(accept, L)[..., 0], points_new, points)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9),
                          torch.clamp(lam * 4.0, max=1e6))
        return poses, points, lam, accept, c_old, c_new

    poses = problem.poses.float().reshape(B * P, 4, 4)
    points = problem.points.float().reshape(B * L, 3)
    c0 = cost_of(poses, points)
    lam = torch.full((B,), init_lambda, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    n_good = torch.zeros((B,), dtype=torch.int64, device=dev)
    n_rej = torch.zeros((B,), dtype=torch.int64, device=dev)
    for _ in range(max_iters):
        p1, x1, lam1, accept, c_before, c_after = lm_step(poses, points, lam)
        poses = torch.where(per_row(done, P), poses, p1)
        points = torch.where(per_row(done, L)[..., 0], points, x1)
        lam = torch.where(done, lam, lam1)
        rel = (c_before - c_after) / torch.clamp(c_before, min=1e-12)
        n_good = n_good + (accept & ~done).long()
        n_rej = torch.where(accept, torch.zeros_like(n_rej), n_rej + 1)
        done = done | (n_rej >= 3) | (accept & (rel < 1e-5))
    return (poses.reshape(B, P, 4, 4), points.reshape(B, L, 3), c0,
            cost_of(poses, points), n_good)


def _one(problem: BAProblem) -> BAProblem:
    return BAProblem(*(t[None] for t in problem))


@highest_precision()
def ba_solve(problem: BAProblem, K: torch.Tensor, *, huber: float = 2.0,
             max_iters: int = 12, init_lambda: float = 1e-3,
             point_major_obs: int = 0):
    """LM with Schur-complement steps -> (poses, points, cost_initial,
    cost_final, n_good_iters), ``n_good_iters`` a device scalar.
    ``point_major_obs``: the obs-slot count O when the edges are the
    (L, O) point-major layout (module docstring)."""
    out = _ba_solve_impl(_one(problem), K[None], huber=huber,
                         max_iters=max_iters, init_lambda=init_lambda,
                         point_major_obs=point_major_obs)
    return tuple(t[0] for t in out)


@highest_precision()
def ba_solve_batch(problems: BAProblem, K: torch.Tensor, *,
                   huber: float = 2.0, max_iters: int = 12,
                   init_lambda: float = 1e-3, point_major_obs: int = 0):
    """B independent BA windows in one solve.

    Every ``BAProblem`` field carries a leading batch axis (all windows
    padded to one shape); ``K`` is (3,3) shared or (B,3,3) per window.
    Returns :func:`ba_solve`'s tuple with a leading batch axis. Each window
    keeps its own damping and stop rule; the iterations run until the last
    window stops (a stopped window's iterate is frozen)."""
    B = problems.poses.shape[0]
    if K.dim() == 2:
        K = K.expand(B, 3, 3)
    return _ba_solve_impl(problems, K, huber=huber, max_iters=max_iters,
                          init_lambda=init_lambda,
                          point_major_obs=point_major_obs)


@highest_precision()
def ba_solve_sharded(problem: BAProblem, K: torch.Tensor, mesh, *,
                     axis: str = "dp", huber: float = 2.0,
                     max_iters: int = 12, init_lambda: float = 1e-3):
    """BA over a process group: the edges split over ``mesh`` axis
    ``axis``, every edge sum all-reduced over it, the poses and points
    replicated and the small reduced camera system solved on every rank.

    The edges are padded with invalid ones to a multiple of the axis size;
    each rank takes its contiguous slice. On a (dp, tp) mesh the ranks
    along the other axis compute the same slice. The result equals
    :func:`ba_solve`'s up to float reassociation in the all-reduce; every
    rank returns it."""
    from simpleslam_tpu_torch.parallel.mesh import axis_index, axis_size

    n = axis_size(mesh, axis)
    E = problem.cam_idx.shape[0]
    per = -(-E // n)
    pad = per * n - E

    def padded(a, fill=0):
        if not pad:
            return a
        return torch.cat([a, torch.full((pad,) + a.shape[1:], fill,
                                        dtype=a.dtype, device=a.device)])

    i = axis_index(mesh, axis)
    sl = slice(i * per, (i + 1) * per)
    local = problem._replace(
        cam_idx=padded(problem.cam_idx)[sl], pt_idx=padded(problem.pt_idx)[sl],
        uv=padded(problem.uv)[sl], e_valid=padded(problem.e_valid, False)[sl])
    out = _ba_solve_impl(_one(local), K[None], huber=huber,
                         max_iters=max_iters, init_lambda=init_lambda,
                         group=mesh.get_group(axis))
    return tuple(t[0] for t in out)


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
    lam = torch.full((), 1e-3, device=points.device)
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
        dx = torch.linalg.solve_ex(Hm, -torch.einsum("eri,er->i", Jw, r))[0]
        T_new = se3.se3_exp(dx) @ T
        better = cost(T_new) < cost(T)
        T = torch.where(better, T_new, T)
        lam = torch.where(better, lam * 0.5, lam * 4.0)
    return T, c0, cost(T)
