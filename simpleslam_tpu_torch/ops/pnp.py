"""Frame-to-map tracking ops: constant-velocity prediction, windowed 2D-3D
descriptor association and PnP-RANSAC with Gauss-Newton refinement (the
counterpart of ``simpleslam_tpu/ops/pnp.py``; the host-API helpers and the
binary-descriptor association path wait for the classical front-end).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from simpleslam_tpu_torch.ops import se3
from simpleslam_tpu_torch.ops.p3p import p3p_grunert
from simpleslam_tpu_torch.ops.projection import project_points
from simpleslam_tpu_torch.ops.ransac import sample_minimal_sets
from simpleslam_tpu_torch.utils.precision import highest_precision

_INF = 1e9


@highest_precision()
def predict_pose_const_vel(Tcw_prevprev: torch.Tensor,
                           Tcw_prev: torch.Tensor) -> torch.Tensor:
    """T_pred = T_prev @ inv(T_prevprev) @ T_prev."""
    return Tcw_prev @ se3.T_inverse(Tcw_prevprev) @ Tcw_prev


class Assoc2D3D(NamedTuple):
    """Per-landmark association result (padded to map capacity C)."""
    kp_idx: torch.Tensor     # (C,) int64 matched keypoint (undefined if !valid)
    dist: torch.Tensor       # (C,) float32 descriptor distance
    uv_proj: torch.Tensor    # (C, 2) projected landmark pixels
    valid: torch.Tensor      # (C,) bool


@highest_precision()
def reproject_and_match_2d3d(
    positions: torch.Tensor,   # (C, 3) landmark positions
    alive: torch.Tensor,       # (C,) bool
    desc_ring: torch.Tensor,   # (C, R, D) last-R observation descriptors
    n_desc: torch.Tensor,      # (C,) live ring slots
    kpts: torch.Tensor,        # (N, 2) current keypoints
    desc_cur: torch.Tensor,    # (N, D) current float descriptors
    kp_valid: torch.Tensor,    # (N,) bool
    K: torch.Tensor, Tcw_pred: torch.Tensor, *,
    img_w: int, img_h: int, radius_px: float = 12.0,
    max_hamm: float = 64.0, max_l2: float = 0.8, chunk: int = 2048,
) -> Assoc2D3D:
    """Windowed best-over-ring descriptor association of map landmarks to
    frame keypoints.

    Landmarks projecting into the image window are scored against every
    keypoint within ``radius_px`` (L2 distance, best over the ring of the
    last observation descriptors, gated at ``max_l2``). Each landmark takes
    its best keypoint; a keypoint claimed by several landmarks goes to the
    lowest row (``scatter_reduce`` amin), and the losers retry once on the
    keypoints left unclaimed. Only rows that are candidates are scored, in
    chunks of ``chunk`` rows; the rest score +inf, as in the reference.
    """
    if desc_cur.dtype == torch.uint8:
        raise NotImplementedError(
            "binary-descriptor association waits for the classical "
            "front-end port")
    C = positions.shape[0]
    N = kpts.shape[0]
    dev = positions.device
    thr = float(max_l2)
    r2 = float(radius_px) ** 2
    R = desc_ring.shape[1]

    uv_all, _z, in_front = project_points(positions, Tcw_pred, K)
    cand = (alive & in_front
            & (uv_all[:, 0] >= 0.0) & (uv_all[:, 0] < float(img_w))
            & (uv_all[:, 1] >= 0.0) & (uv_all[:, 1] < float(img_h))
            & (n_desc > 0))
    kp_f = desc_cur.float()
    kp_norm = (kp_f * kp_f).sum(1)
    kp_sq = (kpts * kpts).sum(1)

    rows = torch.nonzero(cand).flatten()
    best_kp = torch.zeros((C, 2), dtype=torch.int64, device=dev)
    best_d = torch.full((C, 2), _INF, device=dev)
    scored_parts = []
    for s in range(0, rows.numel(), chunk):
        rc = rows[s:s + chunk]
        uv_c = uv_all[rc]
        d2 = (uv_c * uv_c).sum(1)[:, None] + kp_sq[None, :] \
            - 2.0 * uv_c @ kpts.T
        window = d2 <= r2
        ring = desc_ring[rc].float()                          # (CH, R, D)
        slot_ok = (torch.arange(R, device=dev)[None, :]
                   < torch.clamp(n_desc[rc], max=R)[:, None])
        self_n = torch.where(slot_ok, (ring * ring).sum(-1),
                             torch.full_like(slot_ok, _INF, dtype=ring.dtype))
        dd = torch.clamp(self_n[..., None] + kp_norm[None, None, :]
                         - 2.0 * ring @ kp_f.T, min=0.0)      # (CH, R, N)
        best = torch.sqrt(dd.amin(1))
        scored_parts.append(torch.where(window & (best <= thr), best,
                                        torch.full_like(best, _INF)))
    scored = (torch.cat(scored_parts) if scored_parts
              else torch.zeros((0, N), device=dev))           # (Cc, N)

    def best_of(kp_mask):
        s = torch.where(kp_mask[None, :], scored,
                        torch.full_like(scored, _INF))
        if s.shape[0] == 0:
            z = torch.zeros((0,), dtype=torch.int64, device=dev)
            return z, z.float()
        bk = torch.argmin(s, 1)
        return bk, s.gather(1, bk[:, None])[:, 0]

    def resolve(bk, bd, eligible):
        """One keypoint per landmark: the lowest landmark row wins."""
        has = (bd < _INF) & eligible
        claim = torch.where(has, bk, torch.full_like(bk, N))
        winner = torch.full((N + 1,), C, dtype=torch.int64, device=dev) \
            .scatter_reduce(0, claim, rows, reduce="amin")
        return has, has & (winner[claim] == rows)

    bk1, bd1 = best_of(kp_valid)
    has1, valid1 = resolve(bk1, bd1, torch.ones_like(bk1, dtype=torch.bool))
    taken = torch.zeros((N + 1,), dtype=torch.bool, device=dev)
    taken[torch.where(valid1, bk1, torch.full_like(bk1, N))] = True
    bk2, bd2 = best_of(kp_valid & ~taken[:N])
    _, valid2 = resolve(bk2, bd2, has1 & ~valid1)

    kp_idx = torch.zeros((C,), dtype=torch.int64, device=dev)
    dist = torch.full((C,), _INF, device=dev)
    valid = torch.zeros((C,), dtype=torch.bool, device=dev)
    kp_idx[rows] = torch.where(valid1, bk1, bk2)
    dist[rows] = torch.where(valid1, bd1, bd2)
    valid[rows] = valid1 | valid2
    return Assoc2D3D(kp_idx=kp_idx, dist=dist, uv_proj=uv_all, valid=valid)


@highest_precision()
def dlt_pose(pts3d: torch.Tensor, uv_n: torch.Tensor,
             w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Direct linear transform pose from >= 6 points in K-normalised
    coords, projected onto SE(3) with a cheirality sign fix -> 4x4 T_cw."""
    k = pts3d.shape[0]
    if w is None:
        w = torch.ones(k, dtype=pts3d.dtype, device=pts3d.device)
    Xh = torch.cat([pts3d, torch.ones_like(pts3d[:, :1])], 1)
    zeros = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, zeros, -uv_n[:, 0:1] * Xh], 1)
    r2 = torch.cat([zeros, Xh, -uv_n[:, 1:2] * Xh], 1)
    A = torch.cat([r1, r2], 0) * torch.cat([w, w])[:, None]
    P = torch.linalg.svd(A, full_matrices=A.shape[0] < A.shape[1]
                         ).Vh[-1, :].reshape(3, 4)
    depth_sign = torch.where(w > 0, torch.sign(Xh @ P[2, :]),
                             torch.zeros_like(w)).sum()
    P = torch.where(depth_sign < 0, -P, P)
    M = P[:, :3]
    scale = torch.clamp(torch.linalg.svdvals(M).mean(), min=1e-12)
    return se3.rt_to_T(se3.project_to_SO3(M), P[:, 3] / scale)


@highest_precision()
def pnp_residual_sq(Tcw: torch.Tensor, pts3d: torch.Tensor, uv: torch.Tensor,
                    K: torch.Tensor) -> torch.Tensor:
    """Squared pixel reprojection error per point (behind camera -> 1e9);
    Tcw may carry a leading batch of poses."""
    uvp, _z, front = project_points(pts3d, Tcw, K)
    e = ((uvp - uv) ** 2).sum(-1)
    return torch.where(front, e, torch.full_like(e, _INF))


@highest_precision()
def gn_refine_pose(Tcw0: torch.Tensor, pts3d: torch.Tensor, uv: torch.Tensor,
                   K: torch.Tensor, weights: torch.Tensor, iters: int = 10,
                   damping: float = 1e-4) -> torch.Tensor:
    """Lightly damped Gauss-Newton on the SE(3) tangent, T <- exp(xi) T."""
    fx, fy = K[0, 0], K[1, 1]
    eye3 = torch.eye(3, dtype=pts3d.dtype, device=pts3d.device)
    T = Tcw0
    for _ in range(iters):
        pc = pts3d @ T[:3, :3].T + T[:3, 3]
        z = torch.clamp(pc[:, 2], min=1e-6)
        x, y = pc[:, 0], pc[:, 1]
        r = torch.stack([fx * x / z + K[0, 2] - uv[:, 0],
                         fy * y / z + K[1, 2] - uv[:, 1]], 1)
        zi = 1.0 / z
        zero = torch.zeros_like(z)
        Ju = torch.stack([fx * zi, zero, -fx * x * zi * zi], 1)
        Jv = torch.stack([zero, fy * zi, -fy * y * zi * zi], 1)
        Jp = torch.cat([eye3.expand(pc.shape[0], 3, 3), -se3.hat(pc)], 2)
        J = torch.stack([torch.einsum("mi,mij->mj", Ju, Jp),
                         torch.einsum("mi,mij->mj", Jv, Jp)], 1)
        wv = weights * (pc[:, 2] > 1e-6)
        Jw = J * wv[:, None, None]
        H = torch.einsum("mri,mrj->ij", Jw, J) \
            + damping * torch.eye(6, dtype=T.dtype, device=T.device)
        g = torch.einsum("mri,mr->i", Jw, r)
        T = se3.se3_exp(-torch.linalg.solve(H, g)) @ T
    return T


@highest_precision()
def solve_pnp_ransac(key, pts3d: torch.Tensor, uv: torch.Tensor,
                     valid: torch.Tensor, K: torch.Tensor, ransac_px: float,
                     Tcw_init: Optional[torch.Tensor] = None,
                     n_hyp: int = 256, refine_iters: int = 6,
                     lo_rounds: int = 2):
    """Batched-hypothesis PnP-RANSAC -> (T_cw, inlier mask, n_inliers, ok).

    P3P hypotheses (all quartic solutions of all samples) plus the
    extrinsic guess are scored at once; the winner is polished by LO
    rounds of Gauss-Newton on its inliers, keeping the best-by-count
    iterate. ``n_inliers`` and ``ok`` are 0-d tensors.

    Only the valid rows are scored (a map snapshot is mostly padding): the
    k-th valid row keeps its rank, so the draws, the hypotheses and the
    counts are the reference's, and the inlier mask is scattered back.
    """
    rows = torch.nonzero(valid).flatten()
    if 0 < rows.numel() < valid.numel():
        T, inl_c, n, ok = solve_pnp_ransac(
            key, pts3d[rows], uv[rows], torch.ones_like(rows, dtype=torch.bool),
            K, ransac_px, Tcw_init=Tcw_init, n_hyp=n_hyp,
            refine_iters=refine_iters, lo_rounds=lo_rounds)
        inl = torch.zeros_like(valid)
        inl[rows] = inl_c
        return T, inl, n, ok
    thresh_sq = float(ransac_px) ** 2
    uv_n = torch.stack([(uv[:, 0] - K[0, 2]) / K[0, 0],
                        (uv[:, 1] - K[1, 2]) / K[1, 1]], 1)
    idx, ok_h = sample_minimal_sets(key, valid, 3, n_hyp)
    rays = torch.cat([uv_n, torch.ones_like(uv_n[:, :1])], 1)
    rays = rays / torch.linalg.norm(rays, dim=1, keepdim=True)
    poses4, pvalid4 = p3p_grunert(pts3d[idx], rays[idx])   # (S,4,4,4),(S,4)
    models = poses4.reshape(-1, 4, 4)
    ok_h = (ok_h[:, None] & pvalid4).reshape(-1)
    if Tcw_init is not None:
        models = torch.cat([Tcw_init[None].to(models.dtype), models], 0)
        ok_h = torch.cat([torch.ones_like(ok_h[:1]), ok_h])
    res = pnp_residual_sq(models, pts3d, uv, K)
    inl = (res < thresh_sq) & valid[None, :]
    counts = torch.where(ok_h, inl.sum(1), torch.full_like(ok_h, -1,
                                                          dtype=torch.int64))
    best = torch.argmax(counts)
    T_cur, inl_cur = models[best], inl[best]
    T_out, inl_out = T_cur, inl_cur
    for _ in range(lo_rounds):
        T_cur = gn_refine_pose(T_cur, pts3d, uv, K, inl_cur.float(),
                               iters=refine_iters)
        inl_cur = (pnp_residual_sq(T_cur, pts3d, uv, K) < thresh_sq) & valid
        better = inl_cur.sum() >= inl_out.sum()
        T_out = torch.where(better, T_cur, T_out)
        inl_out = torch.where(better, inl_cur, inl_out)
    n = inl_out.sum()
    return T_out, inl_out, n, n >= 4
