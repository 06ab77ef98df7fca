"""Batched DLT triangulation, two-view and N-view, and the acceptance
gates around it (the counterpart of ``simpleslam_tpu/ops/triangulation.py``).

One point is one tiny homogeneous least-squares problem ``A X = 0`` with
two rows per view, solved for all points at once by a batched SVD. The
multi-view API (:func:`multi_view_triangulation`,
:class:`MultiViewTriangulator`) takes camera-to-world poses and numpy
inputs, as the reference's does, and computes on ``device`` (None: the
GPU).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from simpleslam_tpu_torch.ops import se3
from simpleslam_tpu_torch.ops.projection import project_points
from simpleslam_tpu_torch.utils.device import resolve_device
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
def triangulate_n_view(Ps: torch.Tensor, uvs: torch.Tensor,
                       valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """N-view DLT of one track: Ps (..., V, 3, 4), uvs (..., V, 2) ->
    (..., 3), over any leading batch dimensions. ``valid`` (..., V) zeroes
    the rows of the views it masks out."""
    rows = _dlt_rows(Ps, uvs)                            # (..., V, 2, 4)
    if valid is not None:
        rows = rows * valid[..., None, None].to(rows.dtype)
    A = rows.reshape(rows.shape[:-3] + (-1, 4))          # (..., 2V, 4)
    Xh = torch.linalg.svd(
        A, full_matrices=A.shape[-2] < A.shape[-1]).Vh[..., 3, :]
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


# --------------------------------------------------------------------------- #
# Multi-view API
# --------------------------------------------------------------------------- #

@highest_precision()
def _triangulate_tracks(K, poses_w_c: torch.Tensor, uvs: torch.Tensor,
                        valid: torch.Tensor, *, min_depth: float,
                        max_depth: float, max_rep_err: float):
    """Tracks padded to V views: poses_w_c (T, V, 4, 4), uvs (T, V, 2),
    valid (T, V), all float32 but ``valid`` -> (X (T, 3), ok (T,)): the
    N-view DLT over the valid views, then the depth window, cheirality,
    mean reprojection error and finiteness gates over the same views."""
    T_cw = se3.T_inverse(poses_w_c)
    Ps = projection_matrix(K, T_cw)
    X = triangulate_n_view(Ps, uvs, valid)
    uvp, z, front = project_points(X[:, None, None, :], T_cw, K)
    uvp, z, front = uvp[:, :, 0], z[:, :, 0], front[:, :, 0]
    errs = torch.linalg.norm(uvp - uvs, dim=-1)
    n = valid.sum(1).to(errs.dtype)
    mean_err = torch.where(valid, errs, torch.zeros_like(errs)).sum(1) / n
    every = lambda c: (c | ~valid).all(1)                          # noqa: E731
    ok = (every(z > min_depth) & every(z < max_depth) & every(front)
          & (mean_err <= max_rep_err) & torch.isfinite(X).all(1))
    return X, ok


def multi_view_triangulation(K, poses_w_c, pts2d, *,
                             min_depth: float = 0.0,
                             max_depth: float = float("inf"),
                             max_rep_err: float = float("inf"), device=None):
    """N-view DLT of one track with depth and mean-reprojection gates, in
    float32 on ``device`` (None: the GPU). ``poses_w_c``: camera-to-world
    4x4 poses (the opposite of the pipeline's T_cw), ``pts2d`` (V, 2)
    pixels. Returns the world point (3,) float64, or None when fewer than
    two views are given or any gate fails."""
    dev = resolve_device(device)
    uvs = torch.as_tensor(np.asarray(pts2d, np.float32), device=dev)
    if uvs.shape[0] < 2:
        return None
    poses = torch.as_tensor(np.stack([np.asarray(p, np.float32)
                                      for p in poses_w_c]), device=dev)
    Kt = torch.as_tensor(np.asarray(K, np.float32), device=dev)
    X, ok = _triangulate_tracks(
        Kt, poses[None], uvs[None], torch.ones_like(uvs[None, :, 0],
                                                    dtype=torch.bool),
        min_depth=min_depth, max_depth=max_depth, max_rep_err=max_rep_err)
    return X[0].cpu().numpy().astype(np.float64) if bool(ok[0]) else None


class MultiViewTriangulator:
    """Incremental multi-view triangulation over tracked keypoints: feed
    keyframes with per-keypoint track ids (:meth:`add_keyframe`);
    :meth:`triangulate_ready_tracks` triangulates every track seen in at
    least ``min_views`` keyframes, inserts the survivors into a
    ``core/map.py::Map`` (with each view's observation and the colour
    sampled from the keyframe images), fuses landmarks closer than
    ``merge_radius`` and returns the new landmark ids. The ready tracks are
    solved together on ``device`` (None: the GPU), padded to the most
    views, each exactly as :func:`multi_view_triangulation` solves it
    alone."""

    def __init__(self, K, *, min_views: int = 2, merge_radius: float = 0.1,
                 max_rep_err: float = 2.0, min_depth: float = 0.0,
                 max_depth: float = float("inf"), device=None):
        self.K = np.asarray(K, np.float64)
        self.min_views = int(min_views)
        self.merge_radius = float(merge_radius)
        self.max_rep_err = float(max_rep_err)
        self.min_depth = float(min_depth)
        self.max_depth = float(max_depth)
        self.device = resolve_device(device)
        # track id -> [(frame, uv, descriptor, colour, keypoint index)]
        self._tracks: Dict[int, list] = {}
        self._poses_w_c: Dict[int, np.ndarray] = {}
        self._done: set = set()

    def add_keyframe(self, frame_idx: int, pose_w_c: np.ndarray,
                     keypoints: Sequence, track_map: dict, image: np.ndarray,
                     descriptors: Sequence) -> None:
        """Register a keyframe. ``track_map`` maps keypoint index -> track
        id; ``keypoints`` are (N, 2) arrays or objects with ``.pt``."""
        self._poses_w_c[frame_idx] = np.asarray(pose_w_c, np.float64)
        H = image.shape[0] if image is not None else 0
        W = image.shape[1] if image is not None else 0
        for kp_idx, tid in track_map.items():
            kp = keypoints[kp_idx]
            uv = np.asarray(kp.pt if hasattr(kp, "pt") else kp, np.float64)
            colour = np.ones(3, np.float32)
            if image is not None and 0 <= int(uv[1]) < H \
                    and 0 <= int(uv[0]) < W:
                px = image[int(uv[1]), int(uv[0])]
                if np.ndim(px) == 0:
                    colour = np.float32([px, px, px]) / 255.0
                else:
                    colour = px[::-1].astype(np.float32) / 255.0  # BGR->RGB
            desc = descriptors[kp_idx] if descriptors is not None else None
            self._tracks.setdefault(int(tid), []).append(
                (int(frame_idx), uv, desc, colour, int(kp_idx)))

    def triangulate_ready_tracks(self, world_map) -> List[int]:
        """Triangulate all tracks with >= min_views observations, insert
        them into ``world_map``, return the new landmark ids."""
        ready = [tid for tid, obs in self._tracks.items()
                 if tid not in self._done and len(obs) >= self.min_views]
        if not ready:
            return []
        V = max(len(self._tracks[t]) for t in ready)
        poses = np.tile(np.eye(4, dtype=np.float32), (len(ready), V, 1, 1))
        uvs = np.zeros((len(ready), V, 2), np.float32)
        valid = np.zeros((len(ready), V), bool)
        for i, tid in enumerate(ready):
            obs = self._tracks[tid]
            poses[i, :len(obs)] = [self._poses_w_c[f] for f, *_ in obs]
            uvs[i, :len(obs)] = np.stack([o[1] for o in obs])
            valid[i, :len(obs)] = True
        if V >= 2:
            dev = self.device
            X, ok = _triangulate_tracks(
                torch.as_tensor(self.K.astype(np.float32), device=dev),
                torch.as_tensor(poses, device=dev),
                torch.as_tensor(uvs, device=dev),
                torch.as_tensor(valid, device=dev),
                min_depth=self.min_depth, max_depth=self.max_depth,
                max_rep_err=self.max_rep_err)
            X, ok = X.cpu().numpy().astype(np.float64), ok.cpu().numpy()
        else:
            X, ok = None, np.zeros(len(ready), bool)  # one view: no point

        new_ids: List[int] = []
        for i, tid in enumerate(ready):
            if not ok[i]:
                continue
            obs = self._tracks[tid]
            colour = np.mean(np.stack([o[3] for o in obs]), axis=0)
            (pid,) = world_map.add_points(X[i][None, :], colour[None, :],
                                          keyframe_idx=obs[0][0])
            for f, _uv, desc, _c, kp_idx in obs:
                if desc is not None:
                    world_map.points[pid].add_observation(f, kp_idx, desc)
            new_ids.append(pid)
            self._done.add(tid)

        if self.merge_radius > 0 and len(world_map) > 1:
            world_map.fuse_closeby_duplicate_landmarks(self.merge_radius)
        return new_ids
