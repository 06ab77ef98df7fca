"""Frame-to-map tracking ops: constant-velocity prediction, windowed 2D-3D
descriptor association and PnP-RANSAC with Gauss-Newton refinement (the
counterpart of ``simpleslam_tpu/ops/pnp.py``), and the reference's
host-API helpers over numpy inputs (``project_points_wc``,
``associate_landmarks``, ``refine_pose_pnp``,
``reproject_and_match_2d3d_host``, ``draw_reprojection_debug``), which
compute on ``device`` (None: the GPU).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

import torch
import torch.nn.functional as F

from simpleslam_tpu_torch.ops import se3
from simpleslam_tpu_torch.ops.maskops import take
from simpleslam_tpu_torch.ops.matching import unpack_bits
from simpleslam_tpu_torch.ops.p3p import p3p_grunert
from simpleslam_tpu_torch.ops.projection import project_points
from simpleslam_tpu_torch.ops.ransac import sample_minimal_sets
from simpleslam_tpu_torch.utils.device import resolve_device
from simpleslam_tpu_torch.utils.precision import highest_precision
from simpleslam_tpu_torch.utils.rng import TorchKey

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
    desc_cur: torch.Tensor,    # (N, D) current descriptors (u8 | float)
    kp_valid: torch.Tensor,    # (N,) bool
    K: torch.Tensor, Tcw_pred: torch.Tensor, *,
    img_w: int, img_h: int, radius_px: float = 12.0,
    max_hamm: float = 64.0, max_l2: float = 0.8, chunk: int = 2048,
    n_rows: Optional[int] = None,
) -> Assoc2D3D:
    """Windowed best-over-ring descriptor association of map landmarks to
    frame keypoints.

    Landmarks projecting into the image window are scored against every
    keypoint within ``radius_px`` (best over the ring of the last
    observation descriptors: Hamming distance gated at ``max_hamm`` for
    uint8 descriptors, L2 gated at ``max_l2`` for float). Each landmark takes
    its best keypoint; a keypoint claimed by several landmarks goes to the
    lowest row (``scatter_reduce`` amin), and the losers retry once on the
    keypoints left unclaimed. Rows are scored in chunks of ``chunk``; rows
    that are no candidate score +inf, as in the reference. ``n_rows``: a
    bound the caller knows on the host (rows at or past it are padding,
    never candidates), so their chunks are skipped; None scores all rows.
    Nothing is read back to the host.
    """
    C = positions.shape[0]
    N = kpts.shape[0]
    dev = positions.device
    binary = desc_cur.dtype == torch.uint8
    thr = float(max_hamm if binary else max_l2)
    r2 = float(radius_px) ** 2
    R = desc_ring.shape[1]

    uv_all, _z, in_front = project_points(positions, Tcw_pred, K)
    cand = (alive & in_front
            & (uv_all[:, 0] >= 0.0) & (uv_all[:, 0] < float(img_w))
            & (uv_all[:, 1] >= 0.0) & (uv_all[:, 1] < float(img_h))
            & (n_desc > 0))
    kp_f = unpack_bits(desc_cur) if binary else desc_cur.float()
    kp_norm = (kp_f * kp_f).sum(1)                 # the bit count if binary
    kp_sq = (kpts * kpts).sum(1)

    n_live = C if n_rows is None else max(0, min(int(n_rows), C))
    rows = torch.arange(n_live, device=dev)
    scored_parts = []
    for s in range(0, n_live, chunk):
        rc = slice(s, min(s + chunk, n_live))
        uv_c = uv_all[rc]
        d2 = (uv_c * uv_c).sum(1)[:, None] + kp_sq[None, :] \
            - 2.0 * uv_c @ kpts.T
        window = (d2 <= r2) & cand[rc, None]
        ring = desc_ring[rc]                                  # (CH, R, D)
        ring = unpack_bits(ring.reshape(-1, ring.shape[-1])).reshape(
            ring.shape[0], R, -1) if binary else ring.float()
        slot_ok = (torch.arange(R, device=dev)[None, :]
                   < torch.clamp(n_desc[rc], max=R)[:, None])
        self_n = torch.where(slot_ok, (ring * ring).sum(-1),
                             torch.full_like(slot_ok, _INF, dtype=ring.dtype))
        dd = self_n[..., None] + kp_norm[None, None, :] \
            - 2.0 * ring @ kp_f.T                             # (CH, R, N)
        best = dd.amin(1) if binary else \
            torch.sqrt(torch.clamp(dd, min=0.0).amin(1))
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
    taken.index_fill_(0, torch.where(valid1, bk1, torch.full_like(bk1, N)),
                      True)
    bk2, bd2 = best_of(kp_valid & ~taken[:N])
    _, valid2 = resolve(bk2, bd2, has1 & ~valid1)

    pad = C - n_live
    kp_idx = F.pad(torch.where(valid1, bk1, bk2), (0, pad))
    dist = F.pad(torch.where(valid1, bd1, bd2), (0, pad), value=_INF)
    valid = F.pad(valid1 | valid2, (0, pad))
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
        T = se3.se3_exp(-torch.linalg.solve_ex(H, g)[0]) @ T
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

    Every row is scored, the invalid ones masked, so nothing is read back
    to the host. Minimal sets are drawn by rank among the valid rows, so a
    caller that compacts the valid rows first draws the same sets.
    """
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
    T_cur, inl_cur = take(models, best), take(inl, best)
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


# --------------------------------------------------------------------------- #
# Host-API helpers (the reference's signatures, numpy in and out)
# --------------------------------------------------------------------------- #

def project_points_wc(K, pose_w_c, pts_w, device=None) -> np.ndarray:
    """Project world points with a camera-to-world pose, in float32 on
    ``device``; points behind the camera read (-1, -1)."""
    pts_w = np.asarray(pts_w, np.float64)
    if pts_w.size == 0:
        return np.empty((0, 2), np.float32)
    dev = resolve_device(device)
    Tcw = se3.T_inverse(torch.as_tensor(np.asarray(pose_w_c, np.float32),
                                        device=dev))
    uv, _z, front = project_points(
        torch.as_tensor(pts_w.astype(np.float32), device=dev), Tcw,
        torch.as_tensor(np.asarray(K, np.float32), device=dev))
    uv = uv.cpu().numpy().astype(np.float32)
    uv[~front.cpu().numpy()] = -1.0
    return uv


def associate_landmarks(K, pose_w_c, pts_w, kps_cur, search_rad: float = 5.0,
                        device=None):
    """Greedy nearest-keypoint association within ``search_rad`` pixels,
    landmark by landmark: (pts3d (M, 3), pts2d (M, 2), keypoint ids)."""
    pts_w = np.asarray(pts_w, np.float32)
    kp_xy = np.asarray([k.pt if hasattr(k, "pt") else k for k in kps_cur],
                       np.float32).reshape(-1, 2)
    if pts_w.size == 0 or kp_xy.size == 0:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 2), np.float32), [])

    proj = project_points_wc(K, pose_w_c, pts_w, device=device)
    used = np.zeros(len(kp_xy), bool)
    p3, p2, ids = [], [], []
    for i, uv in enumerate(proj):
        if uv[0] < 0 or uv[1] < 0:
            continue
        d = np.linalg.norm(kp_xy - uv, axis=1)
        d[used] = np.inf
        best = int(np.argmin(d))
        if d[best] > search_rad:
            continue
        used[best] = True
        p3.append(pts_w[i])
        p2.append(kp_xy[best])
        ids.append(best)
    if not p3:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 2), np.float32), [])
    return np.asarray(p3, np.float32), np.asarray(p2, np.float32), ids


def refine_pose_pnp(K, pts3d, pts2d, ransac_px: float = 2.0, key=None,
                    device=None):
    """World-to-camera (R, t) from 2D-3D pairs by :func:`solve_pnp_ransac`
    (128 P3P hypotheses) on ``device``, or (None, None) with fewer than 4
    pairs or no pose. ``key`` draws the minimal sets (``utils/rng.py``'s
    interface; default ``TorchKey(0)``, in place of the reference's
    ``PRNGKey(0)``)."""
    pts3d = np.asarray(pts3d, np.float32)
    pts2d = np.asarray(pts2d, np.float32)
    if len(pts3d) < 4 or len(pts2d) < 4:
        return None, None
    dev = resolve_device(device)
    T, _inl, _n, ok = solve_pnp_ransac(
        key if key is not None else TorchKey(0),
        torch.as_tensor(pts3d, device=dev), torch.as_tensor(pts2d, device=dev),
        torch.ones(len(pts3d), dtype=torch.bool, device=dev),
        torch.as_tensor(np.asarray(K, np.float32), device=dev),
        float(ransac_px), n_hyp=128)
    if not bool(ok):
        return None, None
    T = T.cpu().numpy().astype(np.float64)
    return T[:3, :3], T[:3, 3]


class Matches2D3D(NamedTuple):
    """Compact 2D-3D association: world points, matched pixels, keypoint
    indices, landmark ids."""
    pts3d: np.ndarray
    pts2d: np.ndarray
    kp_indices: list
    mp_ids: list


def reproject_and_match_2d3d_host(world_map, K, Tcw_pred, feats,
                                  img_w: int, img_h: int, *,
                                  radius_px: float = 12.0,
                                  max_hamm: float = 64.0,
                                  max_l2: float = 0.8,
                                  capacity: int = 0) -> Matches2D3D:
    """:func:`reproject_and_match_2d3d` over a host ``Map`` and padded
    ``Features`` (on the features' device), returned compact."""
    dev = feats.kpts.device
    desc = feats.desc
    cap = capacity or max(1024, 1 << (len(world_map) - 1).bit_length())
    np_dtype = np.uint8 if desc.dtype == torch.uint8 else np.float32
    snap = world_map.snapshot(cap, desc.shape[1], np_dtype)

    def t(a):
        return torch.as_tensor(a, device=dev)

    out = reproject_and_match_2d3d(
        t(snap["positions"]), t(snap["alive"]), t(snap["desc"]),
        t(snap["n_desc"]), feats.kpts, feats.desc, feats.valid,
        t(np.asarray(K, np.float32)), t(np.asarray(Tcw_pred, np.float32)),
        img_w=int(img_w), img_h=int(img_h), radius_px=radius_px,
        max_hamm=max_hamm, max_l2=max_l2)
    valid = out.valid.cpu().numpy()
    kp_idx = out.kp_idx.cpu().numpy()
    rows = np.flatnonzero(valid)
    kpts = feats.kpts.cpu().numpy()
    return Matches2D3D(
        pts3d=snap["positions"][rows].astype(np.float32),
        pts2d=kpts[kp_idx[rows]].astype(np.float32),
        kp_indices=[int(k) for k in kp_idx[rows]],
        mp_ids=[int(p) for p in snap["pid"][rows]])


def draw_reprojection_debug(img, uv_meas, uv_proj, inlier_mask=None):
    """Measured (green) against projected (red) keypoints joined by lines,
    drawn on a BGR copy of ``img`` with cv2 (imported here); without cv2
    the copy is returned undrawn."""
    try:
        import cv2
    except Exception:
        return np.asarray(img).copy()
    out = np.asarray(img)
    if out.ndim == 2:
        out = np.repeat(out[..., None], 3, axis=2)
    out = out.copy()
    uv_meas = np.asarray(uv_meas)
    uv_proj = np.asarray(uv_proj)
    for i, (m, p) in enumerate(zip(uv_meas, uv_proj)):
        ok = inlier_mask[i] if inlier_mask is not None else True
        pm = tuple(int(v) for v in m)
        pp = tuple(int(v) for v in p)
        cv2.circle(out, pm, 2, (0, 255, 0) if ok else (128, 128, 128), -1)
        cv2.circle(out, pp, 2, (0, 0, 255), -1)
        cv2.line(out, pm, pp, (0, 200, 255), 1)
    return out
