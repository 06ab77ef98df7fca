"""Bundle-adjustment orchestration over the Schur-LM solver (the
counterpart of ``simpleslam_tpu/core/ba.py``): two-view, pose-only, local
(sliding window) and global BA.

The problem is packed into padded edge arrays on the host (pads bucketed
to powers of two), solved on the device by ``ops/ba.py``, and written back
to the keyframes and, through ``world_map.keyframe_indices``, to the
per-frame trajectory.
"""
from __future__ import annotations

import logging
from typing import Optional, Sequence

import numpy as np
import torch

from simpleslam_tpu_torch.ops.ba import BAProblem, ba_solve, pose_only_refine

logger = logging.getLogger("ba")


def _kp_uv(kf, kp_idx: int, cache: dict) -> Optional[np.ndarray]:
    """Measured pixel of keypoint kp_idx in a keyframe."""
    kpts = cache.get(kf.idx)
    if kpts is None:
        kpts = cache[kf.idx] = kf.feats.kpts.cpu().numpy()
    return kpts[kp_idx] if 0 <= kp_idx < len(kpts) else None


def _pad_to_bucket(n: int, minimum: int = 256) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _device_of(kfs) -> torch.device:
    return kfs[0].feats.kpts.device


def _core_ba(world_map, K, kfs, *, opt_kf_idx: Sequence[int],
             fix_kf_idx: Sequence[int], max_points: Optional[int] = None,
             max_iters: int = 15, huber: float = 2.0,
             freeze_points: bool = False, info_tag: str = "[BA]") -> bool:
    """Assemble + solve + write back. Returns True if a solve ran."""
    opt_kf_idx, fix_kf_idx = list(opt_kf_idx), list(fix_kf_idx)
    cams = fix_kf_idx + opt_kf_idx
    cam_of_kf = {k: i for i, k in enumerate(cams)}
    if not opt_kf_idx:
        return False
    poses = np.stack([np.asarray(kfs[k].pose, np.float64) for k in cams])
    opt_set = set(opt_kf_idx)
    cam_free = np.array([k in opt_set for k in cams], bool)

    uv_cache: dict = {}
    sel_pts, edges = [], []
    for pid, mp in world_map.points.items():
        obs = mp.observations
        if not obs or not any(f in opt_set for f, _, _ in obs):
            continue
        li = len(sel_pts)
        sel_pts.append((pid, np.asarray(mp.position, np.float64)))
        for f, kp_idx, _ in obs:
            ci = cam_of_kf.get(f)
            if ci is None:
                continue
            uv = _kp_uv(kfs[f], kp_idx, uv_cache)
            if uv is not None:
                edges.append((ci, li, float(uv[0]), float(uv[1])))
        if max_points is not None and len(sel_pts) >= max_points:
            break
    if len(edges) < 10 or not sel_pts:
        logger.info("%s skipped - %d residuals", info_tag, len(edges))
        return False

    L, E, ne = _pad_to_bucket(len(sel_pts)), _pad_to_bucket(len(edges)), \
        len(edges)
    pts = np.zeros((L, 3), np.float32)
    pts[:len(sel_pts)] = np.stack([p for _, p in sel_pts])
    pt_free = np.zeros((L,), bool)
    pt_free[:len(sel_pts)] = not freeze_points
    earr = np.asarray(edges, np.float64)
    cam_idx = np.zeros((E,), np.int64)
    pt_idx = np.zeros((E,), np.int64)
    uv = np.zeros((E, 2), np.float32)
    e_valid = np.zeros((E,), bool)
    cam_idx[:ne], pt_idx[:ne] = earr[:, 0], earr[:, 1]
    uv[:ne], e_valid[:ne] = earr[:, 2:4], True

    dev = _device_of(kfs)

    def t(a, dt=None):
        return torch.as_tensor(a, dtype=dt, device=dev)

    problem = BAProblem(poses=t(poses, torch.float32), points=t(pts),
                        cam_idx=t(cam_idx), pt_idx=t(pt_idx), uv=t(uv),
                        e_valid=t(e_valid), cam_free=t(cam_free),
                        pt_free=t(pt_free))
    new_poses, new_points, c0, c1, n_good = ba_solve(
        problem, t(np.asarray(K), torch.float32), huber=huber,
        max_iters=max_iters)
    new_poses = new_poses.cpu().numpy().astype(np.float64)
    new_points = new_points.cpu().numpy().astype(np.float64)
    logger.info("%s edges=%d pts=%d cams=%d cost %.1f -> %.1f (%d good)",
                info_tag, ne, len(sel_pts), len(cams), float(c0), float(c1),
                n_good)

    kf_indices = getattr(world_map, "keyframe_indices", None)
    kf_to_frame = dict(enumerate(kf_indices)) if kf_indices else None
    for i, k in enumerate(cams):
        if not cam_free[i]:
            continue
        kfs[k].pose = new_poses[i]
        frame = kf_to_frame.get(k, k) if kf_to_frame else k
        if 0 <= frame < len(world_map.poses):
            world_map.poses[frame][:] = new_poses[i]
    if not freeze_points:
        for li, (pid, _) in enumerate(sel_pts):
            world_map.points[pid].position = new_points[li]
    return True


def two_view_ba(world_map, K, kfs, max_iters: int = 20) -> bool:
    """Refine the two bootstrap poses + all landmarks."""
    if len(world_map.poses) < 2:
        raise ValueError("two_view_ba expects at least 2 poses")
    return _core_ba(world_map, K, kfs, opt_kf_idx=[0, 1], fix_kf_idx=[],
                    max_iters=max_iters, info_tag="[2-view BA]")


def pose_only_ba(world_map, K, kfs, kf_idx: int, max_iters: int = 8,
                 huber_thr: float = 2.0) -> bool:
    """Optimise one keyframe pose with landmarks held constant."""
    pts, uvs, cache = [], [], {}
    for mp in world_map.points.values():
        for f, kp_idx, _ in mp.observations:
            if f != kf_idx:
                continue
            uv = _kp_uv(kfs[kf_idx], kp_idx, cache)
            if uv is not None:
                pts.append(np.asarray(mp.position, np.float64))
                uvs.append(uv)
    if len(pts) < 10:
        logger.warning("[Pose-only BA] skipped - not enough residuals")
        return False
    E = _pad_to_bucket(len(pts))
    P3 = np.zeros((E, 3), np.float32)
    UV = np.zeros((E, 2), np.float32)
    V = np.zeros((E,), bool)
    P3[:len(pts)], UV[:len(uvs)], V[:len(pts)] = np.stack(pts), \
        np.stack(uvs), True
    dev = _device_of(kfs)
    T, _c0, _c1 = pose_only_refine(
        torch.as_tensor(np.asarray(kfs[kf_idx].pose, np.float32), device=dev),
        torch.as_tensor(P3, device=dev), torch.as_tensor(UV, device=dev),
        torch.as_tensor(V, device=dev),
        torch.as_tensor(np.asarray(K), dtype=torch.float32, device=dev),
        huber=huber_thr, max_iters=max_iters)
    T = T.cpu().numpy().astype(np.float64)
    kfs[kf_idx].pose = T
    ki = getattr(world_map, "keyframe_indices", None)
    frame = ki[kf_idx] if ki and kf_idx < len(ki) else kf_idx
    if 0 <= frame < len(world_map.poses):
        world_map.poses[frame][:] = T
    return True


def local_bundle_adjustment(world_map, K, kfs, center_kf_idx: int,
                            window_size: int = 6, max_points: int = 10000,
                            max_iters: int = 15) -> bool:
    """Sliding-window BA: KFs in [center - window + 1, center] optimised,
    all older KFs fixed (gauge)."""
    first_opt = max(1, center_kf_idx - window_size + 1)
    return _core_ba(world_map, K, kfs,
                    opt_kf_idx=list(range(first_opt, center_kf_idx + 1)),
                    fix_kf_idx=list(range(0, first_opt)),
                    max_points=max_points, max_iters=max_iters,
                    info_tag=f"[Local BA @ KF {center_kf_idx}]")


def global_bundle_adjustment(world_map, K, kfs,
                             max_points: Optional[int] = None,
                             max_iters: int = 30,
                             fix_first: bool = True) -> bool:
    """Full-map BA: every keyframe free but the first with ``fix_first``."""
    n = len(kfs)
    if n < 2:
        return False
    return _core_ba(world_map, K, kfs,
                    opt_kf_idx=list(range(1 if fix_first else 0, n)),
                    fix_kf_idx=[0] if fix_first else [],
                    max_points=max_points, max_iters=max_iters,
                    info_tag="[Global BA]")
